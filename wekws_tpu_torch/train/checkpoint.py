"""Checkpoints with sidecar metadata.

Port of wekws_tpu/train/checkpoint.py.  A port checkpoint is
``torch.save`` of the model's state_dict (reference wekws parameter
names) at ``<epoch>.pt``, plus a sidecar ``<epoch>.yaml``
{epoch, lr, cv_loss}; ``final.pt`` links the last one.

The JAX package's checkpoints (``<epoch>.ckpt``: flax msgpack of
{params, batch_stats}) are read by ``load_jax_checkpoint``, a
hand-written decoder of the msgpack subset flax writes (no msgpack or
flax import); ``tools/from_jax.state_dict_from_jax`` then maps the tree
to the port's names.  Its output equals
``flax.serialization.msgpack_restore``: nested dicts of numpy arrays,
ndarrays as msgpack ext type 1 (payload: a msgpack array of shape,
dtype name and the C-order bytes), numpy scalars as ext type 3.
"""

import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import yaml


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    info: Optional[Dict] = None) -> None:
    """Write ``state_dict`` (copied to the CPU) and, with ``info``,
    the ``.yaml`` sidecar beside it."""
    cpu = {k: v.detach().to("cpu") for k, v in state_dict.items()}
    torch.save(cpu, path)
    if info is not None:
        with open(os.path.splitext(path)[0] + ".yaml", "w") as f:
            yaml.dump({k: float(v) for k, v in info.items()}, f)


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a port checkpoint, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint_info(path: str) -> Dict:
    side = os.path.splitext(path)[0] + ".yaml"
    if os.path.exists(side):
        with open(side) as f:
            return yaml.safe_load(f) or {}
    return {}


def link_final(model_dir: str, epoch: int, name: str = "final.pt") -> None:
    final = os.path.join(model_dir, name)
    if os.path.lexists(final):
        os.remove(final)
    os.symlink(f"{epoch}.pt", final)


# ---------------------------------------------------------------------------
# flax msgpack checkpoints of the JAX package
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_FIXED = {  # first byte -> (struct format, size) of a fixed-width number
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTH = {  # first byte -> (kind, struct format of its length)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """One msgpack value at a time from ``data``; ``raw`` keeps strings
    as bytes (flax decodes an ndarray's payload that way)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self) -> Any:
        b = self.unpack(">B", 1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if b in _FIXEXT:
            code = self.unpack(">b", 1)
            return _ext(code, bytes(self.take(_FIXEXT[b])))
        if b in _LENGTH:
            kind, fmt = _LENGTH[b]
            n = self.unpack(fmt, struct.calcsize(fmt))
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.string(n)
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            code = self.unpack(">b", 1)
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def string(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(payload, raw=True).value()
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 arrays in a JAX checkpoint are not "
                         "supported (numpy has no bfloat16)")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1, offset=0).reshape(shape, order="C")


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == _EXT_COMPLEX:
        real, imag = _Reader(payload).value()
        return complex(real, imag)
    raise ValueError(f"unsupported msgpack ext type {code}")


def _check_unchunked(tree) -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError("chunked arrays (above 2**30 bytes) in a JAX "
                             "checkpoint are not supported")
        for v in tree.values():
            _check_unchunked(v)


def msgpack_restore(data: bytes):
    """The tree that ``flax.serialization.msgpack_restore`` returns for
    ``data``: dicts, lists, Python scalars and numpy array leaves."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes "
                         f"after the msgpack value")
    _check_unchunked(tree)
    return tree


def load_jax_checkpoint(path: str) -> Tuple[dict, dict]:
    """(params, batch_stats) of a JAX-package ``.ckpt`` as nested dicts
    of numpy arrays (its ``load_checkpoint(path)`` without a template)."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    return payload["params"], payload.get("batch_stats", {})


def load_model_state(path: str, model_conf: dict,
                     model=None) -> Dict[str, torch.Tensor]:
    """The port state_dict of a port ``.pt`` or a JAX-package ``.ckpt``
    (mapped by ``tools/from_jax``; the CMVN statistics are ``model``'s,
    as the JAX package keeps them in the config, not the checkpoint)."""
    if not path.endswith(".ckpt"):
        return load_checkpoint(path)
    from wekws_tpu_torch.tools.from_jax import state_dict_from_jax

    params, stats = load_jax_checkpoint(path)
    cmvn = None
    if model is not None and model.global_cmvn is not None:
        cmvn = (model.global_cmvn.mean.cpu().numpy(),
                model.global_cmvn.istd.cpu().numpy())
    return state_dict_from_jax(params, stats, model_conf, cmvn)
