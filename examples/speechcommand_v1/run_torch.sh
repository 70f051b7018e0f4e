#!/bin/bash
# Google Speech Commands v1 (12-class) recipe on the PyTorch/CUDA port
# (wekws_tpu_torch), beside run.sh (the JAX package's), stage for
# stage: download -> the 12-class lists -> CMVN and data.list -> train
# -> average + accuracy.  The corpus must be in place under
# $download_dir (stage -1 downloads it: one directory a word,
# _background_noise_, validation_list.txt, testing_list.txt); `python -m
# wekws_tpu_torch.tools.public_layouts speech_commands data/local`
# writes a miniature corpus in its layout.  Checkpoints are .pt under
# exp/torch_<config>/.
# Usage: ./run_torch.sh [--flag value ...] <stage> <stop_stage> [device] [epochs]
#   e.g. ./run_torch.sh 0 3
#   device: cuda (default) or cpu; epochs: the config's max_epoch
#   unless given
set -eo pipefail

. ./path.sh

stage=-1
stop_stage=3
config=conf_torch/mdtc.yaml
num_average=10
download_dir=./data/local
device=cuda
epochs=
# Speech Commands v1 archive (the reference recipe's stage -1 source)
data_url=http://download.tensorflow.org/data/speech_commands_v0.01.tar.gz

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

if [ ${stage} -le -1 ] && [ ${stop_stage} -ge -1 ]; then
  echo "Stage -1: download and extract Google Speech Commands v1"
  mkdir -p $download_dir
  archive=$download_dir/$(basename $data_url)
  if [ ! -f $download_dir/.extracted ]; then
    if [ ! -f $archive ]; then
      wget -O $archive $data_url || curl -L -o $archive $data_url
    fi
    tar -xzf $archive -C $download_dir
    touch $download_dir/.extracted
  fi
fi

if [ ${stage} -le 0 ] && [ ${stop_stage} -ge 0 ]; then
  echo "Stage 0: prepare speech commands lists (12-class)"
  python local/prepare_data.py $download_dir data
  stage_done 0
fi

if [ ${stage} -le 1 ] && [ ${stop_stage} -ge 1 ]; then
  echo "Stage 1: CMVN + data.list"
  python -c "
from wekws_tpu_torch.tools import compute_cmvn_stats
from wekws_tpu_torch.tools.cmvn_stats import wav_paths_from_scp
import yaml
conf = yaml.safe_load(open('$config'))['dataset_conf']
compute_cmvn_stats(wav_paths_from_scp('data/train/wav.scp'), conf,
                   'data/train/global_cmvn')
"
  for x in train valid test; do
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
    --cv_data data/valid/data.list \
    --model_dir $dir \
    --num_keywords 12 \
    --seed 777 \
    --cmvn_file data/train/global_cmvn \
    --norm_var \
    ${epochs:+--num_epochs $epochs} \
    --device $device
  stage_done 2
fi

if [ ${stage} -le 3 ] && [ ${stop_stage} -ge 3 ]; then
  echo "Stage 3: average + accuracy"
  python -m wekws_tpu_torch.bin.average_model \
    --dst_model $score_checkpoint --src_path $dir \
    --num $num_average --val_best --device $device
  python -m wekws_tpu_torch.bin.compute_accuracy \
    --config $dir/config.yaml \
    --test_data data/test/data.list \
    --checkpoint $score_checkpoint \
    --device $device
  stage_done 3
fi
