"""Wire protocol for the KWS serving daemon.

A copy of wekws_tpu/serving/protocol.py, kept so that the port imports
nothing of the JAX package.  Framed messages over a byte stream (TCP or
Unix socket):

    +------+----------------+---------------------+
    | type | length (u32LE) | payload bytes       |
    +------+----------------+---------------------+

Client -> server:
    AUDIO (0x02): 16 kHz s16le PCM chunk (any size).
    EOS   (0x03): end of stream: the server flushes the remainder,
                  emits any final events, replies BYE and frees the
                  slot.

Server -> client:
    READY (0x10): JSON {"stream": slot} on accept.
    EVENT (0x11): JSON detection result (the dict the engines return:
                  keyword/score plus start/end for CTC or frame/time
                  for max-pooling).
    BYE   (0x12): JSON {"reason": ...}: flush finished, or the server
                  is full / shutting down.

The framing needs no dependency (no protobuf or grpc).
"""

import json
import struct

MSG_AUDIO = 0x02
MSG_EOS = 0x03
MSG_READY = 0x10
MSG_EVENT = 0x11
MSG_BYE = 0x12

MAX_PAYLOAD = 1 << 22  # 4 MiB ~= 130 s of 16 kHz PCM per frame

_HDR = struct.Struct("<BI")


def pack(msg_type: int, payload: bytes) -> bytes:
    if len(payload) > MAX_PAYLOAD:
        raise ValueError(f"payload too large: {len(payload)}")
    return _HDR.pack(msg_type, len(payload)) + payload


def pack_json(msg_type: int, obj) -> bytes:
    return pack(msg_type, json.dumps(obj).encode("utf-8"))


def unpack_header(buf: bytes):
    """(msg_type, payload_len) from the 5 header bytes."""
    msg_type, length = _HDR.unpack(buf)
    if length > MAX_PAYLOAD:
        raise ValueError(f"payload too large: {length}")
    return msg_type, length


HEADER_SIZE = _HDR.size
