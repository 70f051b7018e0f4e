"""Dependency-free TensorBoard scalar event writer.

Copy of wekws_tpu/train/tensorboard.py.  The reference wekws logs
epoch scalars through tensorboardX (wekws/bin/train.py).  This port's
primary metrics channel is ``metrics.jsonl`` (greppable, diffable),
but TB users expect drop-in event files — so this module writes real
``events.out.tfevents.*`` files by encoding the two tiny protos
(Event, Summary) and the TFRecord framing (length + masked CRC32C)
by hand: zero dependencies, byte-compatible with TensorBoard.

Wire format references (public, stable):
* TFRecord: [uint64 len][masked crc32c(len)][bytes][masked crc32c(bytes)]
* Event proto: 1=wall_time(double) 2=step(int64)
  3=file_version(string) 5=summary(Summary)
* Summary.Value: 1=tag(string) 2=simple_value(float)
"""

import os
import socket
import struct
import time
from typing import Optional

_CRC_TABLE = []


def _crc32c_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reversed
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # protobuf int64 two's-complement
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag_bytes(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag_bytes(field, 2) + _varint(len(payload)) + payload


def _encode_event(
    wall_time: float,
    step: Optional[int] = None,
    file_version: Optional[str] = None,
    scalars: Optional[dict] = None,
) -> bytes:
    out = bytearray()
    out += _tag_bytes(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        out += _tag_bytes(2, 0) + _varint(step)
    if file_version is not None:
        out += _len_delim(3, file_version.encode("utf-8"))
    if scalars:
        summary = bytearray()
        for tag, value in scalars.items():
            val = (
                _len_delim(1, tag.encode("utf-8"))
                + _tag_bytes(2, 5) + struct.pack("<f", float(value))
            )
            summary += _len_delim(1, val)
        out += _len_delim(5, bytes(summary))
    return bytes(out)


class SummaryWriter:
    """Minimal tensorboardX.SummaryWriter analog (scalars only)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%d.%s" % (
            int(time.time()), socket.gethostname(),
        )
        self._f = open(os.path.join(logdir, fname), "ab")
        self._write(_encode_event(time.time(),
                                  file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._write(_encode_event(time.time(), step=step,
                                  scalars={tag: value}))

    def add_scalars(self, scalars: dict, step: int) -> None:
        self._write(_encode_event(time.time(), step=step,
                                  scalars=dict(scalars)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.flush()
            self._f.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
