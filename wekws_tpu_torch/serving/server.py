"""Asyncio KWS serving daemon over the batched multi-stream engines.

Port of wekws_tpu/serving/server.py.  One process, one batched engine,
many network clients: each accepted connection takes a stream slot of a
``BatchKeywordSpotter``/``BatchMaxPoolSpotter`` and feeds PCM; a single
stepper task runs the lockstep device step whenever any slot has
enough queued frames and pushes detection events back to the owning
connection.  Wire protocol: serving/protocol.py.

Design notes:

* Every engine call (accept_wave, step, flush_stream, reset_stream)
  runs on ONE dedicated executor thread: the engine needs no locks,
  per-slot order holds because each handler awaits its own calls in
  order, and the event loop keeps reading sockets while a step is in
  flight.  That thread's current CUDA device is the engine's; the
  kernel wrappers launch on that thread's current stream of the
  engine's device, the default stream unless a caller set another.
* Slot lifecycle: taken on connect (BYE + close when full), reset on
  release so the next client starts from zero cache and decode state.
* EOS drains that slot cooperatively: its full steps ride the shared
  step with every other ready stream, then one padded step flushes
  its remainder (engine.flush_stream); other clients' cadence is
  unaffected.
"""

import asyncio
import concurrent.futures
import logging
import time as _time
from typing import Dict, Optional

from wekws_tpu_torch.serving import protocol as P


class KwsServer:
    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8990,
                 batch_window: float = 0.002):
        """engine: a constructed BatchKeywordSpotter or
        BatchMaxPoolSpotter (keywords already set for CTC).

        batch_window: max seconds the stepper waits for more slots to
        become step-ready before dispatching a partial batch. Stepping
        the instant ANY slot has frames degrades the lockstep batch
        into near-solo dispatches when many clients feed concurrently;
        the window lets in-flight reads land so dispatches stay
        batched, and bounds the latency it can add."""
        self.engine = engine
        self.host = host
        self.port = port
        self.batch_window = batch_window
        # the engine thread's CUDA device: the engine's, or for a bare
        # "cuda" the device current where the engine was built
        device = getattr(engine, "device", None)
        self._cuda_index = None
        if device is not None and device.type == "cuda":
            import torch

            self._cuda_index = (device.index if device.index is not None
                                else torch.cuda.current_device())
        self._free = list(range(engine.num_streams))
        self._writers: Dict[int, asyncio.StreamWriter] = {}
        self._work = asyncio.Event()
        self._server: Optional[asyncio.base_events.Server] = None
        self._stepper: Optional[asyncio.Task] = None
        # the engine's single thread (see module docstring)
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="kws-engine",
            initializer=self._bind_engine_thread,
        )
        # observability: dispatch batching efficiency + where wall
        # time goes (read via .stats; logged by bench tooling)
        self.stats = {
            "steps": 0, "participants": 0, "step_s": 0.0,
            "accept_s": 0.0, "coalesce_s": 0.0, "events": 0,
        }

    def _bind_engine_thread(self) -> None:
        """Make the engine's CUDA device current on the engine thread
        (a new thread starts on device 0)."""
        if self._cuda_index is not None:
            import torch

            torch.cuda.set_device(self._cuda_index)

    # ------------- lifecycle -------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._stepper = asyncio.create_task(self._step_loop())
        logging.info(
            "kws server on %s:%d (%d slots)",
            self.host, self.port, self.engine.num_streams,
        )

    async def stop(self) -> None:
        if self._stepper:
            self._stepper.cancel()
            try:
                await self._stepper
            except asyncio.CancelledError:
                pass
        if self._server:
            self._server.close()
            # close established connections too: since Python 3.12.1
            # wait_closed() waits for connection handlers, and a
            # handler parked in readexactly() on an idle client would
            # otherwise never finish — stop() would hang
            for w in list(self._writers.values()):
                if not w.is_closing():
                    w.close()
            await self._server.wait_closed()
        self._exec.shutdown(wait=True)

    async def _engine_call(self, fn, *args):
        """Run one engine operation on the engine thread."""
        return await asyncio.get_running_loop().run_in_executor(
            self._exec, fn, *args
        )

    async def serve_forever(self) -> None:
        await self.start()
        async with self._server:
            await self._server.serve_forever()

    # ------------- stepping -------------

    def _ready_count(self) -> int:
        need = self.engine.step_frames
        return sum(
            1 for s in self._writers
            if self.engine.pending_frames(s) >= need
        )

    async def _coalesce(self) -> None:
        """Let in-flight reads land before dispatching, so the device
        step runs with as many participating slots as possible.

        A step has a fixed cost (host work and launches) whatever the
        number of participating rows, so trading a few ms of wait for a
        fuller batch wins whenever clients feed concurrently. Adaptive
        policy: while not every connected
        slot is ready, keep waiting in batch_window increments as long
        as the ready count keeps GROWING; stop as soon as it stalls.
        Paced (realtime) clients stall the count immediately, so the
        added latency is one batch_window; blasting clients keep it
        growing until the batch is full."""
        if self.batch_window <= 0:
            return
        prev = self._ready_count()
        while prev < len(self._writers):
            await asyncio.sleep(self.batch_window)
            cur = self._ready_count()
            if cur <= prev:
                break
            prev = cur

    async def _step_loop(self) -> None:
        while True:
            await self._work.wait()
            # clear BEFORE stepping: audio arriving while we step
            # re-sets the event, so no wakeup is ever lost
            self._work.clear()
            while True:
                t0 = _time.perf_counter()
                await self._coalesce()
                t1 = _time.perf_counter()
                try:
                    results = await self._engine_call(self.engine.step)
                except Exception:
                    # a dead stepper silently freezes every client;
                    # log and keep serving (transient errors recover;
                    # persistent ones keep logging at a bounded rate
                    # instead of spinning)
                    logging.exception("engine step failed")
                    await asyncio.sleep(0.5)
                    continue
                t2 = _time.perf_counter()
                self.stats["coalesce_s"] += t1 - t0
                if not results:
                    break
                self.stats["steps"] += 1
                self.stats["participants"] += len(results)
                self.stats["step_s"] += t2 - t1
                self._emit(results)

    # a client that feeds audio but never reads events would grow its
    # write buffer without bound; past this cap it is disconnected
    MAX_WRITE_BUFFER = 1 << 20

    def _emit(self, results: Dict[int, Dict]) -> None:
        for slot, r in results.items():
            if r and r.get("state") == 1:
                self.stats["events"] += 1
                w = self._writers.get(slot)
                if w is not None and not w.is_closing():
                    if (
                        w.transport.get_write_buffer_size()
                        > self.MAX_WRITE_BUFFER
                    ):
                        logging.warning(
                            "slot %d: client not reading events "
                            "(write buffer over %d bytes) — closing",
                            slot, self.MAX_WRITE_BUFFER,
                        )
                        w.close()
                        continue
                    w.write(P.pack_json(P.MSG_EVENT, r))

    # ------------- connections -------------

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        if not self._free:
            writer.write(P.pack_json(P.MSG_BYE, {"reason": "server full"}))
            await writer.drain()
            writer.close()
            return
        slot = self._free.pop()
        self._writers[slot] = writer
        writer.write(P.pack_json(P.MSG_READY, {"stream": slot}))
        try:
            await writer.drain()
            while True:
                hdr = await reader.readexactly(P.HEADER_SIZE)
                msg_type, length = P.unpack_header(hdr)
                payload = (
                    await reader.readexactly(length) if length else b""
                )
                if msg_type == P.MSG_AUDIO:
                    t0 = _time.perf_counter()
                    await self._engine_call(
                        self.engine.accept_wave, slot, payload
                    )
                    self.stats["accept_s"] += _time.perf_counter() - t0
                    self._work.set()
                elif msg_type == P.MSG_EOS:
                    # Cooperative drain: run full-size portions through
                    # the SHARED step so every ready stream rides the
                    # same steps (a solo flush_stream here would run one
                    # stream per device step when many clients EOS
                    # together).
                    while (
                        self.engine.pending_frames(slot)
                        >= self.engine.step_frames
                    ):
                        results = await self._engine_call(
                            self.engine.step
                        )
                        self._emit(results)
                    # the sub-step remainder: one padded dispatch
                    for r in await self._engine_call(
                        self.engine.flush_stream, slot
                    ):
                        if r and r.get("state") == 1:
                            writer.write(P.pack_json(P.MSG_EVENT, r))
                    writer.write(
                        P.pack_json(P.MSG_BYE, {"reason": "eos"})
                    )
                    await writer.drain()
                    break
                else:
                    writer.write(P.pack_json(
                        P.MSG_BYE,
                        {"reason": f"bad message type {msg_type}"},
                    ))
                    await writer.drain()
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            # client went away (reset, or broke the pipe by closing
            # without reading our BYE); just release the slot
            pass
        except ValueError as e:  # oversized frame
            logging.warning("slot %d: %s", slot, e)
        finally:
            self._writers.pop(slot, None)
            try:
                await self._engine_call(self.engine.reset_stream, slot)
            except RuntimeError:  # executor already shut down
                self.engine.reset_stream(slot)
            self._free.append(slot)
            if not writer.is_closing():
                writer.close()
