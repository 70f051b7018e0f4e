#!/bin/bash
# Hi Xiaowen / Nihao Wenwen (mobvoi_hotword) max-pooling recipe on the
# PyTorch/CUDA port (wekws_tpu_torch), beside run.sh (the JAX
# package's), stage for stage: download -> dict and data prep -> CMVN
# and data.list -> train -> average, score, DET per keyword -> the DET
# plot (stage 4, apart: it needs matplotlib, the 'plot' extra).  The
# corpus must be in place under $download_dir (stage -1 downloads it:
# mobvoi_hotword_dataset/ and mobvoi_hotword_dataset_resources/);
# `python -m wekws_tpu_torch.tools.public_layouts mobvoi data/local`
# writes a miniature corpus in its layout.  Checkpoints are .pt under
# exp/torch_<config>/.
# Stage 0's dict names each keyword by its label id (-1, 0, 1), where
# run.sh's names them <FILLER>, <HI_XIAOWEN>, <NIHAO_WENWEN>: the data
# pipeline reads a label that is not an integer as the filler (-1), so
# with run.sh's names every training utterance is a filler.  With the
# ids, stage 2 trains on the keywords, and stage 3 scores and runs DET
# for keywords 0 and 1.
# Usage: ./run_torch.sh [--flag value ...] <stage> <stop_stage> [device] [epochs]
#   e.g. ./run_torch.sh --config conf_torch/mdtc.yaml 0 3
#   device: cuda (default) or cpu; epochs: the config's max_epoch
#   unless given
set -eo pipefail

. ./path.sh

stage=-1
stop_stage=3
num_keywords=2
config=conf_torch/ds_tcn.yaml
num_average=30
download_dir=./data/local
window_shift=50
device=cuda
epochs=
# mobvoi_hotword_dataset (openslr-87 mirror, same source as reference
# examples/hi_xiaowen/s0/run.sh stage -1)
data_url=https://www.openslr.org/resources/87

# Kaldi convention: leading --flag value pairs override the defaults
# above; the positional arguments follow the flags.
. ../../tools/parse_options.sh
stage=${1:-$stage}
stop_stage=${2:-$stop_stage}
device=${3:-$device}
epochs=${4:-$epochs}
dir=exp/torch_$(basename $config .yaml)
score_checkpoint=$dir/avg_${num_average}.pt
result_dir=$dir/test_$(basename $score_checkpoint)
stage_start=$SECONDS
stage_done() {  # each stage's wall time, for the recipe's record
  echo "stage $1 done in $((SECONDS - stage_start)) s"
  stage_start=$SECONDS
}

if [ ${stage} -le -1 ] && [ ${stop_stage} -ge -1 ]; then
  echo "Stage -1: download mobvoi_hotword_dataset"
  mkdir -p $download_dir
  if [ ! -f $download_dir/.extracted ]; then
    for f in mobvoi_hotword_dataset.tgz mobvoi_hotword_dataset_resources.tgz; do
      [ -f $download_dir/$f ] || \
        wget -O $download_dir/$f $data_url/$f || \
        curl -L -o $download_dir/$f $data_url/$f
      tar -xzf $download_dir/$f -C $download_dir
    done
    touch $download_dir/.extracted
  fi
fi

if [ ${stage} -le 0 ] && [ ${stop_stage} -ge 0 ]; then
  echo "Stage 0: prepare dict + datasets"
  mkdir -p dict
  printf -- '-1 -1\n0 0\n1 1\n' > dict/dict.txt
  awk '{print $1}' dict/dict.txt > dict/words.txt
  for folder in train dev test; do
    mkdir -p data/$folder
    python local/prepare_data.py \
      $download_dir/mobvoi_hotword_dataset \
      $download_dir/mobvoi_hotword_dataset_resources \
      dict/dict.txt $folder data/$folder
  done
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
    --num_keywords $num_keywords \
    --min_duration 50 \
    --seed 666 \
    --cmvn_file data/train/global_cmvn \
    --norm_var \
    ${epochs:+--num_epochs $epochs} \
    --device $device
  stage_done 2
fi

if [ ${stage} -le 3 ] && [ ${stop_stage} -ge 3 ]; then
  echo "Stage 3: average, score, DET"
  python -m wekws_tpu_torch.bin.average_model \
    --dst_model $score_checkpoint --src_path $dir \
    --num $num_average --val_best --device $device
  mkdir -p $result_dir
  python -m wekws_tpu_torch.bin.score \
    --config $dir/config.yaml \
    --test_data data/test/data.list \
    --checkpoint $score_checkpoint \
    --score_file $result_dir/score.txt \
    --dict ./dict \
    --device $device
  for keyword in $(tail -n +2 dict/words.txt); do
    python -m wekws_tpu_torch.bin.compute_det \
      --keyword $keyword \
      --test_data data/test/data.list \
      --window_shift $window_shift \
      --score_file $result_dir/score.txt \
      --stats_file $result_dir/stats.${keyword}.txt \
      --device $device
  done
  stage_done 3
fi

if [ ${stage} -le 4 ] && [ ${stop_stage} -ge 4 ]; then
  echo "Stage 4: the DET plot"
  python -m wekws_tpu_torch.bin.plot_det_curve \
    --keywords_dict dict/words.txt \
    --stats_dir $result_dir \
    --figure_file $result_dir/det.png
  stage_done 4
fi
