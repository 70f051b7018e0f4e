#!/bin/bash
# Hey Snips wake-word recipe on the PyTorch/CUDA port (wekws_tpu_torch),
# beside run.sh (the JAX package's), stage for stage: data prep ->
# CMVN and data.list -> train -> average, score, DET.  The Snips
# research dataset must be in place under $download_dir ({train,dev,
# test}.json and audio_files/); `python -m
# wekws_tpu_torch.tools.public_layouts snips data/local` writes a
# miniature corpus in its layout.  Checkpoints are .pt under
# exp/torch_<config>/.
# Usage: ./run_torch.sh [--flag value ...] <stage> <stop_stage> [device] [epochs]
#   e.g. ./run_torch.sh --config conf_torch/mdtc_small.yaml 0 3
#   device: cuda (default) or cpu; epochs: the config's max_epoch
#   unless given
set -eo pipefail

. ./path.sh

stage=0
stop_stage=3
config=conf_torch/ds_tcn.yaml
download_dir=./data/local
num_average=30
device=cuda
epochs=

# Kaldi convention: leading --flag value pairs override the defaults
# above; the positional arguments follow the flags.
. ../../tools/parse_options.sh
stage=${1:-$stage}
stop_stage=${2:-$stop_stage}
device=${3:-$device}
epochs=${4:-$epochs}
dir=exp/torch_$(basename $config .yaml)
score_checkpoint=$dir/avg_${num_average}.pt
stage_start=$SECONDS
stage_done() {  # each stage's wall time, for the recipe's record
  echo "stage $1 done in $((SECONDS - stage_start)) s"
  stage_start=$SECONDS
}

if [ ${stage} -le 0 ] && [ ${stop_stage} -ge 0 ]; then
  echo "Stage 0: prepare hey_snips data lists"
  # expects the Snips dataset json layout under $download_dir
  python local/prepare_data.py $download_dir data
  stage_done 0
fi

if [ ${stage} -le 1 ] && [ ${stop_stage} -ge 1 ]; then
  echo "Stage 1: compute CMVN and build data.list"
  python -c "
from wekws_tpu_torch.tools import compute_cmvn_stats
from wekws_tpu_torch.tools.cmvn_stats import wav_paths_from_scp
import yaml
conf = yaml.safe_load(open('$config'))['dataset_conf']
compute_cmvn_stats(wav_paths_from_scp('data/train/wav.scp'), conf,
                   'data/train/global_cmvn')
"
  for x in train dev test; do
    python -c "
from wekws_tpu_torch.tools.durations import wav_durations
from wekws_tpu_torch.tools.make_list import make_list
wav_durations([l.strip().split(maxsplit=1) for l in open('data/$x/wav.scp')],
              'data/$x/wav.dur')
make_list('data/$x/wav.scp', 'data/$x/text', 'data/$x/wav.dur',
          'data/$x/data.list')
"
  done
  stage_done 1
fi

if [ ${stage} -le 2 ] && [ ${stop_stage} -ge 2 ]; then
  echo "Stage 2: train"
  mkdir -p $dir
  python -m wekws_tpu_torch.bin.train \
    --config $config \
    --train_data data/train/data.list \
    --cv_data data/dev/data.list \
    --model_dir $dir \
    --num_keywords 1 \
    --min_duration 50 \
    --seed 666 \
    --cmvn_file data/train/global_cmvn \
    --norm_var \
    ${epochs:+--num_epochs $epochs} \
    --device $device
  stage_done 2
fi

if [ ${stage} -le 3 ] && [ ${stop_stage} -ge 3 ]; then
  echo "Stage 3: average + score + DET"
  python -m wekws_tpu_torch.bin.average_model \
    --dst_model $score_checkpoint --src_path $dir \
    --num $num_average --val_best --device $device
  result_dir=$dir/test_$(basename $score_checkpoint)
  mkdir -p $result_dir
  python -m wekws_tpu_torch.bin.score \
    --config $dir/config.yaml \
    --test_data data/test/data.list \
    --checkpoint $score_checkpoint \
    --score_file $result_dir/score.txt \
    --device $device
  python -m wekws_tpu_torch.bin.compute_det \
    --keyword 0 \
    --test_data data/test/data.list \
    --score_file $result_dir/score.txt \
    --stats_file $result_dir/stats.0.txt \
    --device $device
  stage_done 3
fi
