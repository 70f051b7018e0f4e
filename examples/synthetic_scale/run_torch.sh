#!/bin/bash
# The reference-scale synthetic wake-word recipe on the PyTorch/CUDA port
# (wekws_tpu_torch), beside run.sh (the JAX package's): generate 20k
# train utterances x 6 s (5.4 GB of wavs) -> CMVN -> train the flagship
# MDTC with the device-resident epochs (33 h of audio, 3.6 GB int16 on
# the card) -> average, score through the fused MDTC kernel, DET ->
# export (the graph artifact, and the cached step as model.pt2) -> the
# DET plot (stage 5, apart: it needs matplotlib, the 'plot' extra).
# Usage: ./run_torch.sh [stage] [stop_stage] [config] [device] [generator options]
#   device: cuda (default) or cpu; options after the fourth argument go
#   to local/gen_data_torch.py (e.g. --train_kw 64 --train_filler 192
#   for a cut corpus).  TRAIN_SEED=N in the environment trains with seed N
#   (default 666) into exp/torch_<config>_seedN.
set -eo pipefail

. ./path.sh

stage=${1:-0}
stop_stage=${2:-4}
config=${3:-conf_torch/mdtc.yaml}
device=${4:-cuda}
shift $(( $# < 4 ? $# : 4 ))
stage_start=$SECONDS
stage_done() {  # each stage's wall time, for the recipe's record
  echo "stage $1 done in $((SECONDS - stage_start)) s"
  stage_start=$SECONDS
}
data=data
seed=${TRAIN_SEED:-666}
dir=exp/torch_$(basename "$config" .yaml)${TRAIN_SEED:+_seed$TRAIN_SEED}
num_average=5
score_checkpoint=$dir/avg_${num_average}.pt

if [ ${stage} -le 0 ] && [ ${stop_stage} -ge 0 ]; then
  python local/gen_data_torch.py $data "$@"
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
    --num_keywords 1 \
    --min_duration 20 \
    --seed $seed \
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
  python -m wekws_tpu_torch.bin.score \
    --config $dir/config.yaml \
    --test_data $data/test.list \
    --checkpoint $score_checkpoint \
    --score_file $dir/score.txt \
    --batch_size 256 \
    --device $device
  python -m wekws_tpu_torch.bin.compute_det \
    --keyword 0 \
    --test_data $data/test.list \
    --score_file $dir/score.txt \
    --stats_file $dir/stats.0.txt \
    --device $device
  python -c "
from wekws_tpu_torch.eval import frr_at_fa_per_hour
rows = [tuple(map(float, line.split())) for line in open('$dir/stats.0.txt')]
print('FRR at FA 1.0/h %.4f, at FA 0.1/h %.4f' % (
    frr_at_fa_per_hour(rows, 1.0), frr_at_fa_per_hour(rows, 0.1)))
"
  echo "DET written to $dir/stats.0.txt"
  stage_done 3
fi

if [ ${stage} -le 4 ] && [ ${stop_stage} -ge 4 ]; then
  # the graph artifact (model.json, model.txt, weights.bin) and the
  # cached step of the module route as a torch.export program
  # (model.pt2; ROADMAP C.28), each checked by bin.export_model
  python -m wekws_tpu_torch.bin.export_model \
    --config $dir/config.yaml \
    --checkpoint $score_checkpoint \
    --output_dir $dir/export \
    --device $device
  python -m wekws_tpu_torch.bin.export_model \
    --config $dir/config.yaml \
    --checkpoint $score_checkpoint \
    --output_dir $dir/export \
    --format stablehlo \
    --chunk_frames 32 \
    --device $device
  stage_done 4
fi

if [ ${stage} -le 5 ] && [ ${stop_stage} -ge 5 ]; then
  printf '<filler> -1\n0 0\n' > $dir/words.txt
  python -m wekws_tpu_torch.bin.plot_det_curve \
    --keywords_dict $dir/words.txt \
    --stats_dir $dir \
    --figure_file $dir/det.png
  echo "DET plot written to $dir/det.png"
  stage_done 5
fi
