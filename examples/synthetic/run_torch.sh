#!/bin/bash
# The synthetic wake-word recipe on the PyTorch/CUDA port
# (wekws_tpu_torch), beside run.sh (the JAX package's): lists from the
# committed wavs -> train -> average -> score -> DET (stages 0-2) ->
# graph artifact (stage 4), with no download.
# The committed data/global_cmvn is used as it is.
# Usage: ./run_torch.sh [stage] [stop_stage] [config] [device]
#   device: cuda (default) or cpu
set -eo pipefail

. ./path.sh

stage=${1:-0}
stop_stage=${2:-2}
config=${3:-conf_torch/mdtc_flagship.yaml}
device=${4:-cuda}
data=data
dir=exp/torch_$(basename "$config" .yaml)
num_average=5
score_checkpoint=$dir/avg_${num_average}.pt

if [ ${stage} -le 0 ] && [ ${stop_stage} -ge 0 ]; then
  # key <split>_<i>; label "0" (keyword) for even i, "-1" (filler) for
  # odd i, as local/gen_data.py made them; absolute wav paths
  for x in train dev test; do
    n=$(ls $data/$x | grep -c '\.wav$')
    rm -f $data/$x/wav.scp $data/$x/text $data/$x/wav.dur
    for i in $(seq 0 $((n - 1))); do
      echo "${x}_$i $PWD/$data/$x/${x}_$i.wav" >> $data/$x/wav.scp
      echo "${x}_$i $(( i % 2 == 0 ? 0 : -1 ))" >> $data/$x/text
    done
    python -m wekws_tpu_torch.bin.make_list \
      $data/$x/wav.scp $data/$x/text $data/$x/wav.dur $data/$x.list
  done
fi

if [ ${stage} -le 1 ] && [ ${stop_stage} -ge 1 ]; then
  mkdir -p $dir
  python -m wekws_tpu_torch.bin.train \
    --config $config \
    --train_data $data/train.list \
    --cv_data $data/dev.list \
    --model_dir $dir \
    --num_keywords 1 \
    --min_duration 20 \
    --seed 666 \
    --cmvn_file $data/global_cmvn \
    --norm_var \
    --num_workers 2 \
    --device $device
fi

if [ ${stage} -le 2 ] && [ ${stop_stage} -ge 2 ]; then
  python -m wekws_tpu_torch.bin.average_model \
    --dst_model $score_checkpoint --src_path $dir \
    --num $num_average --val_best --device $device
  python -m wekws_tpu_torch.bin.score \
    --config $dir/config.yaml \
    --test_data $data/test.list \
    --checkpoint $score_checkpoint \
    --score_file $dir/score.txt \
    --device $device
  python -m wekws_tpu_torch.bin.compute_det \
    --keyword 0 \
    --test_data $data/test.list \
    --score_file $dir/score.txt \
    --stats_file $dir/stats.0.txt \
    --device $device
  echo "DET written to $dir/stats.0.txt"
fi

if [ ${stage} -le 4 ] && [ ${stop_stage} -ge 4 ]; then
  # the graph artifact of the averaged model (stage 4, as in run.sh;
  # stage 2 here covers run.sh's 3): model.json, model.txt, weights.bin,
  # held against the model by bin.export_model's parity gates
  python -m wekws_tpu_torch.bin.export_model \
    --config $dir/config.yaml \
    --checkpoint $score_checkpoint \
    --output_dir $dir/export \
    --device $device
fi
