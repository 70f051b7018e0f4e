"""Port on-device streaming decode (decode/device_stream.py) against the
JAX package's ``stream_detect_step`` on the same posteriors, chunk by
chunk, and against the host ``StreamDetector``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wekws_tpu.decode import device_stream as jds
from wekws_tpu_torch.decode.device_stream import (
    init_stream_state,
    make_keyword_arrays,
    stream_detect_step,
)
from wekws_tpu_torch.runtime.keyword_spotter import StreamDetector

V = 8
KEYWORDS = {
    "kw_a": {"token_id": (1, 2, 3), "token_str": "1 2 3"},
    "kw_b": {"token_id": (4, 5), "token_str": "4 5"},
}
IDXSET = {0, 1, 2, 3, 4, 5}
FSM = dict(threshold=0.3, min_frames=2, max_frames=60, interval_frames=10)
CHUNK = 8
# JAX's function jitted as its engine runs it (eager lax.scan compiles
# on every call)
JAX_STEP = jax.jit(jds.stream_detect_step, static_argnames=(
    "threshold", "min_frames", "max_frames", "interval_frames",
    "downsampling", "score_beam", "prob_threshold", "unroll"))


def planted_stream(rng, t_total, spans):
    """Dirichlet noise with keyword spellings planted at spans (start
    frame, tokens): each token 2 frames at 0.9, then 2 blank frames
    (tests/test_device_stream.py's generator)."""
    probs = rng.dirichlet(np.ones(V) * 0.25, size=t_total).astype(
        np.float32) * 0.2
    probs[:, 0] += 0.8  # mostly blank background
    probs /= probs.sum(1, keepdims=True)
    for start, seq in spans:
        t = start
        for tok in seq:
            for _ in range(2):
                if t < t_total:
                    probs[t] = (1 - 0.9) / (V - 1)
                    probs[t, tok] = 0.9
                t += 1
            for _ in range(2):
                if t < t_total:
                    probs[t] = (1 - 0.92) / (V - 1)
                    probs[t, 0] = 0.92
                t += 1
    return probs


ROWS = 4  # every scenario at one batch: JAX's step compiles per shape


def _scenario(name):
    """-> (probs (ROWS, T, V), downsampling, resets {chunk start: rows},
    inactive {chunk start: rows}, lengths {chunk start: (ROWS,)}): the
    scenario's rows, then rows of blank-background noise."""
    probs, ds, resets, inactive, lengths = _scenario_rows(name)
    b, t_total, _ = probs.shape
    rng = np.random.default_rng(11)
    filler = [planted_stream(rng, t_total, []) for _ in range(ROWS - b)]
    probs = np.concatenate([probs] + [f[None] for f in filler])
    lengths = {c0: np.concatenate([v, np.full(ROWS - b, CHUNK)])
               for c0, v in lengths.items()}
    return probs, ds, resets, inactive, lengths


def _scenario_rows(name):
    rng = np.random.default_rng({"planted0": 0, "planted1": 1}.get(name, 7))
    none = ({}, {}, {})
    if name in ("planted0", "planted1"):
        spans = [[(8, (1, 2, 3)), (60, (4, 5))], [(20, (4, 5))], [],
                 [(4, (1, 2)), (40, (1, 2, 3))]]
        return (np.stack([planted_stream(rng, 96, s) for s in spans]), 1,
                *none)
    if name == "refractory":
        return (planted_stream(rng, 64, [(4, (4, 5)), (16, (4, 5)),
                                         (40, (4, 5))])[None], 1, *none)
    if name == "reset":
        p = planted_stream(rng, 64, [(8, (1, 2, 3)), (36, (1, 2, 3))])
        return np.stack([p, p]), 1, {32: [0]}, {}, {}
    if name == "inactive":
        p = planted_stream(rng, 48, [(20, (1, 2, 3))])
        return np.stack([p, p]), 1, {}, {8: [1], 16: [1]}, {}
    if name == "downsampling":
        return (planted_stream(rng, 48, [(10, (4, 5))])[None], 3, *none)
    if name == "stale":
        p = planted_stream(rng, 112, [(4, (1, 2))])
        p[80:92] = planted_stream(rng, 112, [(80, (3,))])[80:92]
        return p[None], 1, *none
    if name == "tail":  # a flushed tail: rows carry 3 and 5 valid frames
        spans = [[(2, (4, 5)), (30, (1, 2, 3))], [(10, (1, 2, 3))]]
        p = np.stack([planted_stream(rng, 48, s) for s in spans])
        return p, 1, {}, {}, {40: np.array([3, 5])}
    raise KeyError(name)


SCENARIOS = ["planted0", "planted1", "refractory", "reset", "inactive",
             "downsampling", "stale", "tail"]


def _run(name, impl):
    """Chunks of 8 frames through ``impl``'s stream_detect_step: the
    events of each chunk (numpy) and the final state."""
    probs, ds, resets, inactive, lengths = _scenario(name)
    b, t_total, _ = probs.shape
    if impl == "port":
        kw_tok, kw_len, mask, names = make_keyword_arrays(KEYWORDS, V)
        state = init_stream_state(b)
        conv = torch.as_tensor
        kw = (conv(kw_tok).long(), conv(kw_len).long(), conv(mask))
        step = stream_detect_step
    else:
        kw_tok, kw_len, mask, names = jds.make_keyword_arrays(KEYWORDS, V)
        state = jds.init_stream_state(b)
        conv = jnp.asarray
        kw = (conv(kw_tok), conv(kw_len), conv(mask))
        step = JAX_STEP
    out = []
    for c0 in range(0, t_total, CHUNK):
        reset = np.zeros((b,), bool)
        reset[resets.get(c0, [])] = True
        active = np.ones((b,), bool)
        active[inactive.get(c0, [])] = False
        t0 = np.full((b,), c0 * ds, np.int64)
        lens = lengths.get(c0)
        if impl == "jax":
            t0 = t0.astype(np.int32)
        state, ev = step(
            state, conv(probs[:, c0:c0 + CHUNK]), conv(active), conv(reset),
            conv(t0), *kw,
            lengths=None if lens is None else conv(
                lens.astype(np.int64 if impl == "port" else np.int32)),
            downsampling=ds, **FSM)
        out.append({k: np.asarray(v) for k, v in ev.items()})
        if lens is not None:
            break
    return out, names, state


@pytest.mark.parametrize("name", SCENARIOS)
def test_stream_detect_step_matches_jax(name):
    """Decisions, keyword, start and end exactly, scores within 1e-5 rel
    (the same float32 products in the same order; JAX's pins of its own
    function against the host are 0.35 rel, 1e-5 above a score of 0.8),
    and the final beams: prefixes, node frames and validity exactly,
    probabilities within 1e-5 rel + 1e-6 abs."""
    got, names, got_state = _run(name, "port")
    want, want_names, want_state = _run(name, "jax")
    assert names == want_names
    fired = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["fired"], w["fired"])
        on = w["fired"]
        fired += int(on.sum())
        for key in ("kw", "start", "end"):
            np.testing.assert_array_equal(g[key][on], w[key][on])
        np.testing.assert_allclose(g["score"][on], w["score"][on], rtol=1e-5)
    if name != "stale":
        assert fired, "nothing fired: the scenario is vacuous"
    gb, wb = got_state.beam, want_state.beam
    for key in ("prefixes", "plen", "node_frame", "valid"):
        np.testing.assert_array_equal(getattr(gb, key).numpy(),
                                      np.asarray(getattr(wb, key)))
    for key in ("pb", "pnb", "node_prob"):
        np.testing.assert_allclose(getattr(gb, key).numpy(),
                                   np.asarray(getattr(wb, key)), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(got_state.hit_score.numpy(),
                               np.asarray(want_state.hit_score), rtol=1e-5)
    np.testing.assert_array_equal(got_state.last_active_pos.numpy(),
                                  np.asarray(want_state.last_active_pos))


@pytest.mark.parametrize("name", ["planted0", "planted1", "refractory",
                                  "downsampling"])
def test_stream_detect_step_matches_host_detector(name):
    """Against the host ``StreamDetector`` with JAX's own pins
    (tests/test_device_stream.py): the same decisions, keyword, start
    and end; scores within 0.35 rel, 1e-5 where the host's exceeds 0.8
    (the batched beam keeps the max-pnb node track on merges)."""
    probs, ds, _, _, _ = _scenario(name)
    got, names, _ = _run(name, "port")
    dets = []
    for _ in range(probs.shape[0]):
        d = StreamDetector(FSM["threshold"], FSM["min_frames"],
                           FSM["max_frames"], FSM["interval_frames"], 3, 20,
                           0.01, ds)
        d.set_tables(KEYWORDS, IDXSET)
        dets.append(d)
    for ci, ev in enumerate(got):
        c0 = ci * CHUNK
        idx = (np.arange(c0, c0 + CHUNK) * ds).astype(np.int64)
        for i, det in enumerate(dets):
            h = det.process(idx, probs[i, c0:c0 + CHUNK])
            fired = bool(h) and h.get("state") == 1
            assert bool(ev["fired"][i]) == fired, (ci, i, h)
            if fired:
                assert names[int(ev["kw"][i])] == h["keyword"]
                assert int(ev["start"][i]) == round(h["start"] / 0.01)
                assert int(ev["end"][i]) == round(h["end"] / 0.01)
                tol = 1e-5 if h["score"] > 0.8 else 0.35
                assert float(ev["score"][i]) == pytest.approx(h["score"],
                                                              rel=tol)


def test_make_keyword_arrays_equal_jax():
    got = make_keyword_arrays(KEYWORDS, V)
    want = jds.make_keyword_arrays(KEYWORDS, V)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[3] == want[3] == ["kw_a", "kw_b"]


def test_inactive_rows_keep_their_state_bitwise():
    """A row that sits out a chunk keeps every state tensor bit for bit,
    and a reset row equals a fresh state."""
    probs, _, _, _, _ = _scenario("planted0")
    kw_tok, kw_len, mask, _ = make_keyword_arrays(KEYWORDS, V)
    kw = (torch.as_tensor(kw_tok).long(), torch.as_tensor(kw_len).long(),
          torch.as_tensor(mask))
    state = init_stream_state(4)
    t0 = torch.zeros(4, dtype=torch.int64)
    state, _ = stream_detect_step(state, torch.as_tensor(probs[:, :16]),
                                  torch.ones(4, dtype=torch.bool),
                                  torch.zeros(4, dtype=torch.bool), t0, *kw,
                                  **FSM)
    active = torch.tensor([True, False, True, False])
    reset = torch.tensor([False, False, False, True])
    new, _ = stream_detect_step(state, torch.as_tensor(probs[:, 16:24]),
                                active, reset, t0 + 16, *kw, **FSM)
    fresh = init_stream_state(4)
    for n, o, f in zip(new.beam, state.beam, fresh.beam):
        assert torch.equal(n[1], o[1])
        assert torch.equal(n[3], f[3])
    assert torch.equal(new.hit_score[1], state.hit_score[1])
    assert new.hit_score[3] == 1.0 and new.last_active_pos[3] == -1
