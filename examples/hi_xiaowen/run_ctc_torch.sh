#!/bin/bash
# Hi Xiaowen / Nihao Wenwen, CTC path, on the PyTorch/CUDA port
# (wekws_tpu_torch), beside run_ctc.sh (the JAX package's), stage for
# stage: CTC dict -> CMVN and data.list (1b: base CTC pretraining on
# ASR data, with --trainbase true) -> train (fine-tuned from the base
# model with --trainbase true) -> average, offline score_ctc, DET ->
# streaming score, DET -> the graph artifact and its static int8
# quantization.  Checkpoints are .pt under exp/torch_<config>/.
# Like run_ctc.sh it reads files that no stage of it writes:
#   data/{train,dev,test}/wav.scp and text, each text line an
#   utterance's character transcript (嗨小问, 你好问问 or other
#   characters) -- on the real corpus from its transcription resource;
#   `python -m wekws_tpu_torch.tools.public_layouts mobvoi data/local
#   --ctc_data data` writes them for a miniature corpus;
#   $trainbase_dir/{train,dev}/wav.scp and text (token transcripts),
#   with --trainbase true -- the same tool's --asr_base option writes
#   them (--asr_base data/asr_base);
#   $download_dir/mobvoi_hotword_dataset_resources, which stage 0 names
#   (local/prepare_ctc_dict.py builds the dict from the keywords).
# With --trainbase true, stage 2 resumes from $trainbase_exp/final.pt as
# bin.train resumes: the epoch count continues from the base model's
# last epoch, its lr and best cv loss are restored (the fine-tune
# config's max_epoch must exceed the base config's).
# Usage: ./run_ctc_torch.sh [--flag value ...] <stage> <stop_stage> [device] [epochs]
#   e.g. ./run_ctc_torch.sh --config conf_torch/ds_tcn_ctc.yaml 0 5
#        ./run_ctc_torch.sh --trainbase true 0 5   # ASR-base pretrain first
#   device: cuda (default) or cpu; epochs: each training stage's epoch
#   count (the fine-tune then ends that many epochs past the base's
#   last), the configs' max_epoch unless given
set -eo pipefail

. ./path.sh

stage=0
stop_stage=4
config=conf_torch/fsmn_ctc.yaml
num_average=30
keywords="嗨小问,你好问问"
download_dir=./data/local
trainbase=false
trainbase_dir=data/asr_base
trainbase_config=conf_torch/ds_tcn_ctc_base.yaml
trainbase_exp=exp/torch_ctc_base
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
  echo "Stage 0: prepare CTC dict (token per char + <blank>/<filler>)"
  mkdir -p dict data
  python local/prepare_ctc_dict.py \
    $download_dir/mobvoi_hotword_dataset_resources dict
  stage_done 0
fi

if [ ${stage} -le 1 ] && [ ${stop_stage} -ge 1 ]; then
  echo "Stage 1: CMVN + data.list (text transcripts)"
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

if [ ${stage} -le 1 ] && [ ${stop_stage} -ge 1 ] && [ "$trainbase" = true ]; then
  echo "Stage 1b: base CTC pretraining on ASR data ($trainbase_dir)"
  for x in train dev; do
    if [ ! -f $trainbase_dir/$x/wav.scp ] || [ ! -f $trainbase_dir/$x/text ]; then
      echo "trainbase=true needs KALDI-format wav.scp + text under $trainbase_dir/$x" >&2
      exit 1
    fi
    python -c "
from wekws_tpu_torch.tools.durations import wav_durations
from wekws_tpu_torch.tools.make_list import make_list
wav_durations([l.strip().split(maxsplit=1)
               for l in open('$trainbase_dir/$x/wav.scp')],
              '$trainbase_dir/$x/wav.dur')
make_list('$trainbase_dir/$x/wav.scp', '$trainbase_dir/$x/text',
          '$trainbase_dir/$x/wav.dur', '$trainbase_dir/$x/data.list')
"
  done
  mkdir -p $trainbase_exp
  python -m wekws_tpu_torch.bin.train \
    --config $trainbase_config \
    --train_data $trainbase_dir/train/data.list \
    --cv_data $trainbase_dir/dev/data.list \
    --model_dir $trainbase_exp \
    --seed 666 \
    --dict ./dict \
    --cmvn_file data/train/global_cmvn \
    --norm_var \
    ${epochs:+--num_epochs $epochs} \
    --device $device
  stage_done 1b
fi

if [ ${stage} -le 2 ] && [ ${stop_stage} -ge 2 ]; then
  echo "Stage 2: train (CTC)"
  mkdir -p $dir
  checkpoint_opt=
  num_epochs=$epochs
  if [ "$trainbase" = true ]; then
    echo "fine-tuning from base model $trainbase_exp/final.pt"
    checkpoint_opt="--checkpoint $trainbase_exp/final.pt"
    if [ -n "$epochs" ]; then
      # final.pt links <last epoch>.pt: the fine-tune starts one past it
      last=$(basename $(readlink $trainbase_exp/final.pt) .pt)
      num_epochs=$((last + 1 + epochs))
    fi
  fi
  python -m wekws_tpu_torch.bin.train \
    --config $config \
    --train_data data/train/data.list \
    --cv_data data/dev/data.list \
    --model_dir $dir \
    --seed 666 \
    --dict ./dict \
    --cmvn_file data/train/global_cmvn \
    --norm_var \
    $checkpoint_opt \
    ${num_epochs:+--num_epochs $num_epochs} \
    --device $device
  stage_done 2
fi

if [ ${stage} -le 3 ] && [ ${stop_stage} -ge 3 ]; then
  echo "Stage 3: average + offline CTC score + DET"
  python -m wekws_tpu_torch.bin.average_model \
    --dst_model $score_checkpoint --src_path $dir \
    --num $num_average --val_best --device $device
  result_dir=$dir/test_$(basename $score_checkpoint)
  mkdir -p $result_dir
  python -m wekws_tpu_torch.bin.score_ctc \
    --config $dir/config.yaml \
    --test_data data/test/data.list \
    --checkpoint $score_checkpoint \
    --score_file $result_dir/score.txt \
    --dict ./dict \
    --keywords "$keywords" \
    --device $device
  python -m wekws_tpu_torch.bin.compute_det_ctc \
    --test_data data/test/data.list \
    --keywords "$keywords" \
    --score_file $result_dir/score.txt \
    --device $device
  stage_done 3
fi

if [ ${stage} -le 4 ] && [ ${stop_stage} -ge 4 ]; then
  echo "Stage 4: streaming-simulation CTC score + DET"
  result_dir=$dir/stream_$(basename $score_checkpoint)
  mkdir -p $result_dir
  python -m wekws_tpu_torch.bin.stream_score_ctc \
    --config $dir/config.yaml \
    --test_data data/test/data.list \
    --checkpoint $score_checkpoint \
    --token_file dict/dict.txt \
    --lexicon_file dict/words.txt \
    --keywords "$keywords" \
    --score_file $result_dir/score.txt \
    --device $device
  python -m wekws_tpu_torch.bin.compute_det_ctc \
    --test_data data/test/data.list \
    --keywords "$keywords" \
    --score_file $result_dir/score.txt \
    --device $device
  stage_done 4
fi

if [ ${stage} -le 5 ] && [ ${stop_stage} -ge 5 ]; then
  echo "Stage 5: export graph artifact + calibrated int8 quantization"
  python -m wekws_tpu_torch.bin.export_model \
    --config $dir/config.yaml \
    --checkpoint $score_checkpoint \
    --output_dir $dir/export \
    --device $device
  python -m wekws_tpu_torch.bin.static_quantize \
    --model_dir $dir/export \
    --output_dir $dir/export_int8 \
    --calib_data data/dev/data.list \
    --device $device
  stage_done 5
fi
