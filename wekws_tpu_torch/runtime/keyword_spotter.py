"""Online streaming keyword spotting engine (CTC path) and loaders.

Port of wekws_tpu/runtime/keyword_spotter.py: PCM chunks -> stateful
host frontend -> cached model forward on the device -> frame-synchronous
prefix beam decode -> detection FSM with threshold / duration /
refractory gating, beam reset on activation or stale keyword.

* the per-stream beam + FSM state lives in ``StreamDetector``;
* ``KeyWordSpotter`` runs the model on ``device`` (CUDA unless the
  caller asks for the CPU), one chunk per call, eagerly.  The JAX
  engine cuts each chunk into fixed-size pieces (its
  ``_bucketed_apply``) only to bound the number of programs ``jit``
  compiles; PyTorch runs eagerly, so the port has no counterpart and
  feeds the chunk as it comes;
* ``use_fused=True`` steps the whole-backbone kernel
  (ops/serving.py ``build_fused_stream``) with its packed cache, and
  raises where the model is not supported (the JAX engine quietly keeps
  the module path there); without it the model's modules step with the
  model's own cache (a GRU's hidden state too); ``use_fused=None`` takes
  the route ``ops.serving.forward_route`` gives the loaded model;
* the checkpoint is a port ``.pt`` (``torch.save`` of the model's
  state_dict, with the reference wekws parameter names), a JAX-package
  ``.ckpt`` (read by train/checkpoint.load_model_state), or an exported
  artifact directory (``model.json`` + ``weights[_int8].bin``, float or
  static int8, from either package's exporter), which serves through
  export/torch_runtime.ArtifactModelAdapter: there is no fused kernel
  behind an artifact, so ``use_fused=None`` takes the artifact's own
  ops and ``use_fused=True`` raises.  The model is float32 whatever
  ``model.dtype`` says.
"""

import dataclasses
import logging
import math
from typing import Dict, Optional

import numpy as np
import torch
import yaml

from wekws_tpu_torch.decode.ctc_prefix_beam_search import (
    PrefixBeam,
    is_sublist,
)
from wekws_tpu_torch.device import resolve_device
from wekws_tpu_torch.export.graph import is_artifact_dir
from wekws_tpu_torch.export.torch_runtime import (
    ArtifactModelAdapter,
    load_artifact_model,
)
from wekws_tpu_torch.frontend.features import frontend_from_dataset_conf
from wekws_tpu_torch.models.kws_model import (
    inference_model_conf,
    init_model,
)
from wekws_tpu_torch.ops.serving import build_fused_stream, forward_route
from wekws_tpu_torch.runtime.streaming_frontend import StreamingFrontend
from wekws_tpu_torch.text.tokenizer import (
    query_token_set,
    read_lexicon,
    read_token,
)
from wekws_tpu_torch.train.checkpoint import load_model_state


class StreamDetector:
    """Beam + detection FSM for ONE audio stream.

    Semantics match the reference wekws streaming demo: frame-sync beam
    update, sublist keyword match with geometric-mean token score,
    threshold / min-max duration / refractory-interval gates, beam
    reset on activation, stale-keyword beam reset.
    """

    def __init__(
        self,
        threshold: float,
        min_frames: int,
        max_frames: int,
        interval_frames: int,
        score_beam: int,
        path_beam: int,
        resolution: float,
        downsampling: int,
    ):
        self.threshold = threshold
        self.min_frames = min_frames
        self.max_frames = max_frames
        self.interval_frames = interval_frames
        self.score_beam = score_beam
        self.path_beam = path_beam
        self.resolution = resolution
        self.downsampling = downsampling
        self.keywords_token: Dict[str, dict] = {}
        self.keywords_idxset = {0}
        self.reset_all()

    # ------------- keyword tables -------------

    def set_tables(self, keywords_token: Dict, keywords_idxset: set) -> None:
        self.keywords_token = keywords_token
        self.keywords_idxset = keywords_idxset
        self.beam.tokenset = keywords_idxset

    # ------------- per-frame FSM -------------

    def decode_keywords(self, t: int, probs: np.ndarray) -> None:
        self.beam.abs_frame = t
        self.beam.step(probs)

    def execute_detection(self, t: int) -> None:
        hit_keyword = None
        start = end = 0
        hyps = self.beam.hypotheses()
        for prefix_ids, _score, nodes in hyps:
            for word, info in self.keywords_token.items():
                lab = list(info["token_id"])
                offset = is_sublist(list(prefix_ids), lab)
                if offset != -1 and lab:
                    hit_keyword = word
                    start = nodes[offset]["frame"]
                    end = nodes[offset + len(lab) - 1]["frame"]
                    for i in range(offset, offset + len(lab)):
                        self.hit_score *= nodes[i]["prob"]
                    break
            if hit_keyword is not None:
                self.hit_score = math.sqrt(self.hit_score)
                break

        duration = end - start
        if hit_keyword is not None:
            if (
                self.hit_score >= self.threshold
                and self.min_frames <= duration <= self.max_frames
                and (
                    self.last_active_pos == -1
                    or end - self.last_active_pos >= self.interval_frames
                )
            ):
                self.activated = True
                self.last_active_pos = end
                # absolute frame at which the FSM fired: the audio the
                # engine had to see past the keyword before the event
                self.activation_frame = t
                logging.info(
                    "Frame %d detect %s from %d to %d (dur %d, score %.3f) "
                    "Activated.",
                    t, hit_keyword, start, end, duration, self.hit_score,
                )
        self.result = {
            "state": 1 if self.activated else 0,
            "keyword": hit_keyword if self.activated else None,
            "start": start * self.resolution if self.activated else None,
            "end": end * self.resolution if self.activated else None,
            "score": self.hit_score if self.activated else None,
        }

    def process(self, frame_indices: np.ndarray, probs: np.ndarray) -> Dict:
        """Run the FSM over one chunk of posteriors.

        frame_indices: absolute frame index per row; probs: (N, V).
        On activation the beam resets and the rest of the chunk is
        skipped.  Returns the rolling result dict (state 1 exactly on
        the activating chunk).
        """
        if probs.shape[0] < 1:
            return {}
        for i in range(probs.shape[0]):
            t = int(frame_indices[i])
            self.decode_keywords(t, probs[i])
            self.execute_detection(t)
            if self.activated:
                self.reset()
                break
        self.total_frames = int(frame_indices[-1]) + self.downsampling

        # stale-keyword beam reset
        if self.beam.cur_hyps and len(self.beam.cur_hyps[0][0]) > 0:
            nodes = self.beam.cur_hyps[0][1][2]
            if nodes:
                keyword_may_start = int(nodes[0]["frame"])
                if (self.total_frames - keyword_may_start) > self.max_frames:
                    self.reset()
        return self.result

    # ------------- state -------------

    def reset(self) -> None:
        self.beam = PrefixBeam(
            self.keywords_idxset, self.score_beam, self.path_beam
        )
        self.activated = False
        self.hit_score = 1.0

    def reset_all(self) -> None:
        self.reset()
        self.total_frames = 0
        self.activation_frame = -1
        self.last_active_pos = -1
        self.result: Dict = {}


def load_spotter_config(config):
    """Resolved train config (dict or YAML path) -> (configs, frontend
    cfg without dither, left, right, frame_skip)."""
    if isinstance(config, dict):
        configs = config
    else:
        with open(config, "r") as fin:
            configs = yaml.safe_load(fin)
    dataset_conf = configs["dataset_conf"]
    cfg = dataclasses.replace(frontend_from_dataset_conf(dataset_conf).cfg,
                              dither=0.0)
    downsampling = int(dataset_conf.get("frame_skip", 1))
    left = right = 0
    if dataset_conf.get("context_expansion", False):
        ce = dataset_conf["context_expansion_conf"]
        left, right = ce.get("left", 0), ce.get("right", 0)
    return configs, cfg, left, right, downsampling


def load_serving_model(configs: dict, ckpt_path: str, feat_dim: int,
                       device="cuda"):
    """Build the float32 model of ``configs['model']``, load a port
    ``.pt`` or a JAX-package ``.ckpt``, and return it in eval mode on
    ``device``; or, for an exported artifact directory, its
    ``ArtifactModelAdapter`` on ``device`` (the artifact carries its
    weights and CMVN, so ``configs['model']`` is not read)."""
    device = resolve_device(device)
    if is_artifact_dir(ckpt_path):
        model = load_artifact_model(ckpt_path, device)
        input_dim = model.rt.meta["model_conf"].get("input_dim", feat_dim)
        if input_dim != feat_dim:
            raise ValueError(f"artifact input_dim {input_dim} != frontend "
                             f"feature dim {feat_dim}")
        logging.info("serving graph artifact %s", ckpt_path)
        return model
    model_conf = inference_model_conf(configs["model"])
    if model_conf["input_dim"] != feat_dim:
        raise ValueError(
            f"model input_dim {model_conf['input_dim']} != frontend "
            f"feature dim {feat_dim}"
        )
    model = init_model(model_conf)
    model.load_state_dict(load_model_state(ckpt_path, model_conf, model))
    logging.info("model %s loaded.", ckpt_path)
    return model.to(device).eval()


def use_fused_stream(model, device, use_fused: Optional[bool],
                     route=None) -> bool:
    """Whether a serving engine steps the fused stream kernel for
    ``model``: ``use_fused`` as given, or, when None, the route that
    ``route`` (``forward_route`` by default) gives the model on
    ``device``.  An artifact has no fused kernel: None means its own
    ops, and True raises."""
    if isinstance(model, ArtifactModelAdapter):
        if use_fused:
            raise ValueError(
                "use_fused=True: a graph artifact has no fused serving "
                "kernel; serve it with use_fused=None or False")
        return False
    if use_fused is None:
        return (route or forward_route)(model, device) == "fused"
    return use_fused


class KeyWordSpotter:
    """Single-stream CTC keyword spotter.  ``config`` is a resolved
    train config, as a dict or a YAML path; ``ckpt_path`` a port
    ``.pt``, a JAX-package ``.ckpt`` or an exported artifact directory.
    Runs on ``device``, CUDA unless the caller asks for the CPU."""

    def __init__(
        self,
        ckpt_path: str,
        config,
        token_path: str,
        lexicon_path: Optional[str],
        threshold: float,
        min_frames: int = 5,
        max_frames: int = 250,
        interval_frames: int = 50,
        score_beam: int = 3,
        path_beam: int = 20,
        use_fused: Optional[bool] = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        configs, cfg, left, right, downsampling = load_spotter_config(config)
        self.sample_rate = cfg.sample_rate
        self.resolution = cfg.frame_shift_ms / 1000.0
        self.downsampling = downsampling
        self.frontend = StreamingFrontend(cfg, left, right, downsampling)
        self.model = load_serving_model(
            configs, ckpt_path, cfg.feat_dim * (left + 1 + right),
            self.device)

        self._fused_init_cache = None
        if use_fused_stream(self.model, self.device, use_fused):
            fused = build_fused_stream(self.model, softmax=True,
                                       device=self.device)
            if fused is None:
                raise ValueError(
                    "use_fused=True: this model is not supported by the "
                    "fused stream (needs a DS-TCN or MDTC with linear "
                    "preprocessing or an FSMN, and a linear, element or "
                    "identity head)")
            self._apply_step, self._fused_init_cache = fused
        else:
            self._apply_step = self._module_step
        self._apply = self._device_apply

        self.token_table = read_token(token_path)
        self.lexicon_table = (
            read_lexicon(lexicon_path) if lexicon_path else {}
        )
        self.detector = StreamDetector(
            threshold, min_frames, max_frames, interval_frames,
            score_beam, path_beam, self.resolution, self.downsampling,
        )
        self.reset_all()

    def _module_step(self, feats, cache):
        with torch.inference_mode():
            return self.model(feats, cache, softmax=True)

    def _device_apply(self, feats: np.ndarray, cache):
        """(1, T, D) host features -> ((1, T, V) host posteriors,
        cache'); the whole chunk in one step."""
        x = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        probs, cache = self._apply_step(x, cache)
        return probs.cpu().numpy(), cache

    # ------------- compat delegation to the detector -------------

    @property
    def threshold(self):
        return self.detector.threshold

    @property
    def min_frames(self):
        return self.detector.min_frames

    @property
    def max_frames(self):
        return self.detector.max_frames

    @property
    def interval_frames(self):
        return self.detector.interval_frames

    @property
    def keywords_token(self):
        return self.detector.keywords_token

    @property
    def keywords_idxset(self):
        return self.detector.keywords_idxset

    @property
    def beam(self):
        return self.detector.beam

    @property
    def activated(self):
        return self.detector.activated

    @property
    def hit_score(self):
        return self.detector.hit_score

    @property
    def total_frames(self):
        return self.detector.total_frames

    @property
    def last_active_pos(self):
        return self.detector.last_active_pos

    @property
    def result(self):
        return self.detector.result

    def decode_keywords(self, t: int, probs: np.ndarray) -> None:
        self.detector.decode_keywords(t, probs)

    def execute_detection(self, t: int) -> None:
        self.detector.execute_detection(t)

    # ------------- keywords -------------

    def set_keywords(self, keywords: str) -> None:
        keywords_token, keywords_idxset = build_keyword_tables(
            keywords, self.token_table, self.lexicon_table
        )
        self.detector.set_tables(keywords_token, keywords_idxset)
        logging.info("keywords: %s", keywords_token)

    # ------------- streaming -------------

    def accept_wave(self, wave: bytes) -> np.ndarray:
        data = np.frombuffer(wave, dtype="<i2").astype(np.float32)
        # kaldi fbank consumes int16-scale input directly
        feats, idx = self.frontend.accept_waveform(data)
        self._frame_indices = idx
        return feats

    def forward(self, wave_chunk: bytes) -> Dict:
        feats = self.accept_wave(wave_chunk)
        if feats.shape[0] < 1:
            return {}
        probs, self.in_cache = self._apply(feats[None, :, :], self.in_cache)
        return self.detector.process(self._frame_indices,
                                     np.asarray(probs)[0])

    # ------------- state -------------

    def reset(self) -> None:
        self.detector.reset()

    def reset_all(self) -> None:
        self.detector.reset_all()
        self.frontend.reset()
        self.in_cache = (
            self._fused_init_cache(1)
            if self._fused_init_cache is not None
            else self.model.init_cache(1, self.device)
        )
        self._frame_indices = np.zeros((0,), np.int64)


def build_keyword_tables(keywords: str, token_table, lexicon_table):
    """Keyword string -> ({word: {token_id, token_str}}, token idxset),
    as the reference's ``set_keywords`` builds them."""
    keywords_list = keywords.strip().replace(" ", "").split(",")
    keywords_token: Dict[str, dict] = {}
    keywords_idxset = {0}
    for keyword in keywords_list:
        strs, indexes = query_token_set(keyword, token_table, lexicon_table)
        keywords_token[keyword] = {
            "token_id": tuple(indexes),
            "token_str": " ".join(str(i) for i in indexes),
        }
        keywords_idxset.update(indexes)
    return keywords_token, keywords_idxset
