#!/bin/bash
# The reference-scale synthetic CTC recipe on the PyTorch/CUDA port
# (wekws_tpu_torch), beside run_ctc.sh (the JAX package's): the
# hi_xiaowen FSMN-CTC dimensions on the synthetic_ctc generator at scale
# (20k train utterances, ~11 test filler hours), trained with the
# device-resident epochs -> average, score_ctc through the fused FSMN
# kernel, DET.  The DET plot is stage 5, apart (it needs matplotlib, the
# 'plot' extra).  run_ctc.sh's stage 4 (tools/bench_serving_slo.py) is
# the serving benchmark (ROADMAP A.14), not ported here: it waits for
# the benchmark of the port.
# Usage: ./run_ctc_torch.sh [stage] [stop_stage] [config] [device] [generator options]
#   device: cuda (default) or cpu; options after the fourth argument go
#   to ../synthetic_ctc/local/gen_data_torch.py after this recipe's own
#   (e.g. --train 256 --dev 64 --test 256 for a cut corpus)
set -eo pipefail

. ./path.sh

stage=${1:-0}
stop_stage=${2:-3}
config=${3:-conf/fsmn_ctc.yaml}
device=${4:-cuda}
shift $(( $# < 4 ? $# : 4 ))
stage_start=$SECONDS
stage_done() {  # each stage's wall time, for the recipe's record
  echo "stage $1 done in $((SECONDS - stage_start)) s"
  stage_start=$SECONDS
}
data=data_ctc
dir=exp/torch_$(basename "$config" .yaml)
keyword=123
num_average=5
score_checkpoint=$dir/avg_${num_average}.pt

if [ ${stage} -le 0 ] && [ ${stop_stage} -ge 0 ]; then
  # (it also writes dict/dict.txt, the committed token table, here)
  python ../synthetic_ctc/local/gen_data_torch.py $data \
    --train 20000 --dev 2000 --test 33000 --seed 20260820 "$@"
  stage_done 0
fi

if [ ${stage} -le 1 ] && [ ${stop_stage} -ge 1 ]; then
  python -c "
from wekws_tpu_torch.tools import compute_cmvn_stats
from wekws_tpu_torch.tools.cmvn_stats import wav_paths_from_data_list
import yaml, itertools
conf = yaml.safe_load(open('$config'))['dataset_conf']
paths = itertools.islice(wav_paths_from_data_list('$data/train.list'), 400)
compute_cmvn_stats(paths, conf, '$data/global_cmvn')
"
  stage_done 1
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
    --device_resident \
    --device $device
  stage_done 2
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
    --batch_size 256 \
    --device $device
  python -m wekws_tpu_torch.bin.compute_det_ctc \
    --test_data $data/test.list \
    --keywords $keyword \
    --score_file $dir/score.txt \
    --stats_dir $dir \
    --device $device
  stage_done 3
fi

if [ ${stage} -le 5 ] && [ ${stop_stage} -ge 5 ]; then
  python -m wekws_tpu_torch.bin.compute_det_ctc \
    --test_data $data/test.list \
    --keywords $keyword \
    --score_file $dir/score.txt \
    --stats_dir $dir \
    --figure_file $dir/det.png \
    --device $device
  echo "DET plot written to $dir/det.png"
  stage_done 5
fi
