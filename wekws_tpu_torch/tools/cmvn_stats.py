"""Global CMVN statistics.

Port of wekws_tpu/tools/cmvn_stats.py (the reference's
tools/compute_cmvn_stats.py): per-dimension sums and squared sums of
the training features, in the JSON format that ``frontend/cmvn.py``
reads ({mean_stat, var_stat, frame_num}).  The features come from the
numpy Kaldi frontend (``frontend/kaldi.py``) with dither 0 and are
summed in float64.
"""

import dataclasses
import json
from typing import Iterable, Optional

import numpy as np

from wekws_tpu_torch.data.audio import read_wav, resample as resample_wave
from wekws_tpu_torch.frontend.features import (
    frontend_config_from_dataset_conf,
)
from wekws_tpu_torch.frontend.kaldi import compute_fbank_np, compute_mfcc_np


def compute_cmvn_stats(
    wav_paths: Iterable[str],
    dataset_conf: dict,
    out_path: Optional[str] = None,
) -> dict:
    cfg = dataclasses.replace(
        frontend_config_from_dataset_conf(dataset_conf), dither=0.0)
    fn = compute_mfcc_np if cfg.feature_type == "mfcc" else compute_fbank_np

    mean_stat = np.zeros(cfg.feat_dim, np.float64)
    var_stat = np.zeros(cfg.feat_dim, np.float64)
    frame_num = 0
    for path in wav_paths:
        wave, sr = read_wav(path)
        if sr != cfg.sample_rate:
            wave = resample_wave(wave, sr, cfg.sample_rate)
        feats = fn(wave * cfg.wave_scale, cfg).astype(np.float64)
        mean_stat += feats.sum(axis=0)
        var_stat += (feats ** 2).sum(axis=0)
        frame_num += feats.shape[0]
    stats = {
        "mean_stat": mean_stat.tolist(),
        "var_stat": var_stat.tolist(),
        "frame_num": frame_num,
    }
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(stats, f)
    return stats


def wav_paths_from_scp(scp_path: str):
    with open(scp_path, encoding="utf8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2:
                yield parts[1]


def wav_paths_from_data_list(list_path: str):
    with open(list_path, encoding="utf8") as f:
        for line in f:
            if line.strip():
                yield json.loads(line)["wav"]
