"""The cached forward step as a ``torch.export`` program.

The port's counterpart of the JAX package's ``bin/export_model --format
stablehlo`` (``jax.export`` of the jitted ``model.apply(variables,
feats, cache, softmax=False)``): the module route's ``model(feats,
cache, softmax=False)`` traced at a static ``(1, chunk_frames,
input_dim)`` chunk with ``model.init_cache(1)`` as the example cache.
``bin/export_model`` saves it with ``torch.export.save`` as
``model.pt2``, a PyTorch ``ExportedProgram`` (StableHLO is XLA's format;
ROADMAP C.28).

The program takes ``(feats, cache)`` and returns ``(output, new
cache)``, the new cache in the input cache's structure (MDTC, TCN and
FSMN: a tuple of ``(1, pad, C)`` tensors; GRU: one ``(1, L, H)``
tensor), so chunk k+1 takes chunk k's cache as it came back.  A chunk of
another length is refused by the program's shape guards.

Only the module route is traced: the fused serving builders call the
CUDA kernels through ctypes, which ``torch.export`` cannot trace.  The
model is put in eval mode and traced under ``no_grad``, so no training
branch (``fused_train``, ``remat``, batch statistics) is taken, and
``aten_op_counts`` refuses a program that holds anything but aten
operators.  Tensors that the forward makes are baked to the device of
the export, so export on the device the program runs on;
``load_cached_step`` moves a program to the device it is asked for with
``torch.export.passes.move_to_device_pass``.  A ``.pt2`` is read back
only by the torch version that wrote it.
"""

import operator
from typing import Dict

import numpy as np
import torch
from torch import nn

GATE_TOL = 1e-5  # abs and rel: the same operations, traced
GATE_CHUNKS = 3


class CachedStep(nn.Module):
    """``model(feats, cache, softmax=False)`` as a two-input module."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, feats: torch.Tensor, cache):
        return self.model(feats, cache, softmax=False)


def export_cached_step(model: nn.Module, chunk_frames: int, device):
    """The ``ExportedProgram`` of ``model``'s cached step at a static
    ``(1, chunk_frames, model.idim)`` chunk, traced on ``device`` in
    eval mode under ``no_grad``.  Moves ``model`` to ``device`` and puts
    it in eval mode."""
    device = torch.device(device)
    model.eval().to(device)
    feats = torch.zeros((1, chunk_frames, model.idim), dtype=torch.float32,
                        device=device)
    cache = model.init_cache(1, device)
    with torch.no_grad():
        program = torch.export.export(CachedStep(model), (feats, cache))
    aten_op_counts(program)
    return program


def aten_op_counts(program) -> Dict[str, int]:
    """{aten operator: calls} of an exported program's graph; raises if a
    node calls anything else (a ctypes kernel, a ``*_plain`` function,
    a Python op), tuple indexing apart."""
    counts, other = {}, []
    for node in program.graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        target = node.target
        if (isinstance(target, torch._ops.OpOverload)
                and target.namespace == "aten"):
            name = str(target)
            counts[name] = counts.get(name, 0) + 1
        else:
            other.append(str(target))
    if other:
        raise RuntimeError(f"the exported step calls non-aten targets: "
                           f"{sorted(set(other))}")
    return counts


def load_cached_step(path: str, device) -> nn.Module:
    """The program saved at ``path`` as a callable module on ``device``
    (moved there by ``move_to_device_pass``), its parameters frozen."""
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(torch.export.load(path),
                                  torch.device(device))
    return program.module().requires_grad_(False)


def check_cached_step(step, model: nn.Module, chunk_frames: int,
                      device) -> float:
    """``step`` (a loaded program) against the eager cached step of
    ``model`` over GATE_CHUNKS chunks carried from the initial cache, on
    ``default_rng(0)`` features: outputs and every cache tensor within
    GATE_TOL abs + GATE_TOL rel, else raises.  Returns the max abs
    error."""
    device = torch.device(device)
    x = np.random.default_rng(0).standard_normal(
        (1, GATE_CHUNKS * chunk_frames, model.idim)).astype(np.float32)
    x = torch.from_numpy(x).to(device)
    cache = want_cache = model.init_cache(1, device)
    err = 0.0
    with torch.no_grad():
        for s in range(0, x.shape[1], chunk_frames):
            chunk = x[:, s:s + chunk_frames]
            got, cache = step(chunk, cache)
            want, want_cache = model(chunk, want_cache, softmax=False)
            if type(cache) is not type(want_cache) or len(flat_tensors(
                    cache)) != len(flat_tensors(want_cache)):
                raise RuntimeError("the exported step's cache does not have "
                                   "the input cache's structure")
            for g, w in zip(flat_tensors((got, cache)),
                            flat_tensors((want, want_cache))):
                diff = (g - w).abs()
                err = max(err, float(diff.max()) if diff.numel() else 0.0)
                if not bool((diff <= GATE_TOL + GATE_TOL * w.abs()).all()):
                    raise RuntimeError(
                        f"cached-step export parity failed: max err "
                        f"{float(diff.max())} in chunk {s // chunk_frames} "
                        f"(program vs the eager step on {device})")
    return err


def flat_tensors(tree):
    """The tensors of a nest of tuples and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in flat_tensors(sub)]
