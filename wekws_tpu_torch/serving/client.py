"""Blocking client for the KWS serving daemon (protocol.py framing).

A copy of wekws_tpu/serving/client.py.

Usage:

    with KwsClient(host, port) as c:
        for chunk in pcm_chunks:
            c.send_audio(chunk)
            for event in c.poll_events():
                ...
        events = c.finish()   # EOS + drain remaining events
"""

import json
import socket
from typing import Dict, List

from wekws_tpu_torch.serving import protocol as P


class KwsClient:
    def __init__(self, host: str, port: int, timeout: float = 30.0):
        """timeout bounds every blocking operation (connect, blocking
        reads, sends); a stalled server raises socket.timeout instead
        of hanging the caller forever."""
        self.timeout = timeout
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""
        self.closed = False
        ready = self._read_msg(blocking=True)
        if ready is None or ready[0] != P.MSG_READY:
            got = ready[1] if ready else None
            raise ConnectionError(f"server refused: {got}")
        self.stream = ready[1]["stream"]

    # ------------- sending -------------

    def send_audio(self, pcm: bytes) -> None:
        self.sock.sendall(P.pack(P.MSG_AUDIO, pcm))

    def finish(self) -> List[Dict]:
        """Send EOS, then drain until BYE. Returns every event not
        yet consumed by poll_events (pre-EOS stragglers included)."""
        self.sock.sendall(P.pack(P.MSG_EOS, b""))
        events: List[Dict] = []
        while True:
            msg = self._read_msg(blocking=True)
            if msg is None or msg[0] == P.MSG_BYE:
                break
            if msg[0] == P.MSG_EVENT:
                events.append(msg[1])
        self.close()
        return events

    def close(self) -> None:
        if not self.closed:
            self.sock.close()
            self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------- receiving -------------

    def poll_events(self) -> List[Dict]:
        """Non-blocking: all detection events received so far."""
        events: List[Dict] = []
        while True:
            msg = self._read_msg(blocking=False)
            if msg is None:
                return events
            if msg[0] == P.MSG_EVENT:
                events.append(msg[1])

    def wait_events(self, timeout: float) -> List[Dict]:
        """Block up to ``timeout`` seconds, returning as soon as at
        least one event arrives (possibly empty on timeout or when
        only a partial frame is buffered). Lets a paced caller receive
        events the moment the server emits them instead of at its next
        send."""
        import select

        events = self.poll_events()
        if events:
            return events
        r, _, _ = select.select([self.sock], [], [], max(timeout, 0.0))
        if not r:
            return []
        return self.poll_events()

    def _read_msg(self, blocking: bool):
        """One framed message, or None (non-blocking, nothing there /
        connection closed). Blocking reads honor self.timeout —
        setblocking(True) would erase it (it is settimeout(None)) and
        a stalled server would hang the caller forever; on expiry
        socket.timeout propagates."""
        if blocking:
            self.sock.settimeout(self.timeout)
        else:
            self.sock.setblocking(False)
        try:
            while True:
                if len(self._buf) >= P.HEADER_SIZE:
                    mtype, length = P.unpack_header(
                        self._buf[: P.HEADER_SIZE]
                    )
                    end = P.HEADER_SIZE + length
                    if len(self._buf) >= end:
                        payload = self._buf[P.HEADER_SIZE:end]
                        self._buf = self._buf[end:]
                        obj = json.loads(payload) if payload else None
                        return mtype, obj
                chunk = self.sock.recv(65536)
                if not chunk:
                    return None
                self._buf += chunk
        except BlockingIOError:
            return None
        finally:
            self.sock.settimeout(self.timeout)
