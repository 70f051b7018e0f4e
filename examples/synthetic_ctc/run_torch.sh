#!/bin/bash
# The synthetic CTC recipe on the PyTorch/CUDA port (wekws_tpu_torch),
# beside run.sh (the JAX package's): generate -> CMVN -> CTC train ->
# average -> score_ctc -> DET -> streaming detection sim, no download.
# Usage: ./run_torch.sh [stage] [stop_stage] [config] [device]
#   device: cuda (default) or cpu
set -eo pipefail

. ./path.sh

stage=${1:-0}
stop_stage=${2:-4}
config=${3:-conf/fsmn_ctc.yaml}  # bf16, as run.sh trains; conf_torch/: float32
device=${4:-cuda}
data=data
dir=exp/torch_$(basename "$config" .yaml)
keyword=123
num_average=5
score_checkpoint=$dir/avg_${num_average}.pt

if [ ${stage} -le 0 ] && [ ${stop_stage} -ge 0 ]; then
  # gen_data_torch.py also writes dict/dict.txt into its working
  # directory: run it in a temporary one, and check that its token
  # table is the committed dict/dict.txt
  here=$PWD
  tmp=$(mktemp -d)
  (cd "$tmp" && PYTHONPATH=$here/../..:$PYTHONPATH \
    python "$here/local/gen_data_torch.py" "$here/$data")
  cmp "$tmp/dict/dict.txt" dict/dict.txt
  rm -rf "$tmp"
fi

if [ ${stage} -le 1 ] && [ ${stop_stage} -ge 1 ]; then
  # the committed data/global_cmvn (run.sh's stage 1 wrote it from the
  # same corpus) is used as it is
  test -s $data/global_cmvn
  echo "CMVN: $data/global_cmvn"
fi

if [ ${stage} -le 2 ] && [ ${stop_stage} -ge 2 ]; then
  mkdir -p $dir
  python -m wekws_tpu_torch.bin.train \
    --config $config \
    --train_data $data/train.list \
    --cv_data $data/dev.list \
    --model_dir $dir \
    --dict ./dict \
    --seed 888 \
    --cmvn_file $data/global_cmvn \
    --norm_var \
    --num_workers 2 \
    --device $device
fi

if [ ${stage} -le 3 ] && [ ${stop_stage} -ge 3 ]; then
  python -m wekws_tpu_torch.bin.average_model \
    --dst_model $score_checkpoint --src_path $dir \
    --num $num_average --val_best --device $device
  python -m wekws_tpu_torch.bin.score_ctc \
    --config $dir/config.yaml \
    --test_data $data/test.list \
    --checkpoint $score_checkpoint \
    --score_file $dir/score.txt \
    --dict ./dict \
    --keywords $keyword \
    --device $device
  python -m wekws_tpu_torch.bin.compute_det_ctc \
    --test_data $data/test.list \
    --keywords $keyword \
    --score_file $dir/score.txt \
    --stats_dir $dir \
    --device $device
fi

if [ ${stage} -le 4 ] && [ ${stop_stage} -ge 4 ]; then
  # frame-synchronous streaming detection simulation
  python -m wekws_tpu_torch.bin.stream_score_ctc \
    --config $dir/config.yaml \
    --checkpoint $score_checkpoint \
    --test_data $data/test.list \
    --token_file dict/dict.txt \
    --keywords $keyword \
    --score_file $dir/stream_score.txt \
    --threshold 0.1 \
    --device $device
fi
