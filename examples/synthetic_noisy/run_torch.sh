#!/bin/bash
# The noisy synthetic wake-word recipe on the PyTorch/CUDA port
# (wekws_tpu_torch), beside run.sh (the JAX package's): generate the
# corpus and the noise and RIR stores -> CMVN -> train the DS-TCN with
# speed perturbation, noise and reverb from a corpus staged on the
# device (--device_resident: the augmentation runs on the card, in the
# step) -> average -> score test and test_noisy -> DET.  No download.
# Usage: ./run_torch.sh [stage] [stop_stage] [config] [device] [epochs]
#   device: cuda (default) or cpu; epochs: the config's max_epoch
#   unless given
set -eo pipefail

. ./path.sh

stage=${1:-0}
stop_stage=${2:-5}
config=${3:-conf/ds_tcn_aug.yaml}
device=${4:-cuda}
epochs=${5:-}
data=data
dir=exp/torch_$(basename "$config" .yaml)
num_average=5
score_checkpoint=$dir/avg_${num_average}.pt

if [ ${stage} -le 0 ] && [ ${stop_stage} -ge 0 ]; then
  python local/gen_data_torch.py $data
fi

if [ ${stage} -le 1 ] && [ ${stop_stage} -ge 1 ]; then
  python -c "
import itertools, yaml
from wekws_tpu_torch.tools.cmvn_stats import (compute_cmvn_stats,
                                              wav_paths_from_data_list)
conf = yaml.safe_load(open('$config'))['dataset_conf']
paths = itertools.islice(wav_paths_from_data_list('$data/train.list'), 200)
compute_cmvn_stats(paths, conf, '$data/global_cmvn')
"
  echo "CMVN: $data/global_cmvn"
fi

if [ ${stage} -le 2 ] && [ ${stop_stage} -ge 2 ]; then
  # the config's noise_source and reverb_source (data/noise_store,
  # data/rir_store) are read from this directory
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
    --device_resident \
    ${epochs:+--num_epochs $epochs} \
    --device $device
fi

if [ ${stage} -le 3 ] && [ ${stop_stage} -ge 3 ]; then
  python -m wekws_tpu_torch.bin.average_model \
    --dst_model $score_checkpoint --src_path $dir \
    --num $num_average --val_best --device $device
fi

if [ ${stage} -le 4 ] && [ ${stop_stage} -ge 4 ]; then
  for split in test test_noisy; do
    python -m wekws_tpu_torch.bin.score \
      --config $dir/config.yaml \
      --test_data $data/$split.list \
      --checkpoint $score_checkpoint \
      --score_file $dir/score_$split.txt \
      --device $device
  done
fi

if [ ${stage} -le 5 ] && [ ${stop_stage} -ge 5 ]; then
  for split in test test_noisy; do
    python -m wekws_tpu_torch.bin.compute_det \
      --keyword 0 \
      --test_data $data/$split.list \
      --score_file $dir/score_$split.txt \
      --stats_file $dir/stats_$split.txt \
      --device $device
  done
  echo "DET written to $dir/stats_{test,test_noisy}.txt"
fi
