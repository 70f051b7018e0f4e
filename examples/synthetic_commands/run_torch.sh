#!/bin/bash
# The synthetic command-classification recipe on the PyTorch/CUDA port
# (wekws_tpu_torch), beside run.sh (the JAX package's): generate ->
# CMVN -> CE train -> average -> accuracy, no download.
# Usage: ./run_torch.sh [stage] [stop_stage] [config] [device]
#   config: conf/mdtc_ce.yaml (default; MDTC with bf16 compute, as
#           run.sh trains), conf_torch/mdtc_ce.yaml (its float32
#           variant) or conf/gru_ce.yaml (GRU)
#   device: cuda (default) or cpu
set -eo pipefail

. ./path.sh

stage=${1:-0}
stop_stage=${2:-3}
config=${3:-conf/mdtc_ce.yaml}
device=${4:-cuda}
data=data
dir=exp/torch_$(basename "$config" .yaml)
num_classes=8
num_average=5
score_checkpoint=$dir/avg_${num_average}.pt

if [ ${stage} -le 0 ] && [ ${stop_stage} -ge 0 ]; then
  python local/gen_data_torch.py $data --classes $num_classes
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
    --num_keywords $num_classes \
    --seed 777 \
    --cmvn_file $data/global_cmvn \
    --norm_var \
    --num_workers 1 \
    --device $device
fi

if [ ${stage} -le 3 ] && [ ${stop_stage} -ge 3 ]; then
  python -m wekws_tpu_torch.bin.average_model \
    --dst_model $score_checkpoint --src_path $dir \
    --num $num_average --val_best --device $device
  python -m wekws_tpu_torch.bin.compute_accuracy \
    --config $dir/config.yaml \
    --test_data $data/test.list \
    --checkpoint $score_checkpoint \
    --device $device
fi
