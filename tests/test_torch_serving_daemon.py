"""Port serving daemon (serving/{protocol,server,client}.py, bin/serve.py)
on 127.0.0.1 with CPU engines: the wire format equals the JAX
package's, and every client's events equal what the same engine gives
in process for the same audio."""

import argparse
import asyncio
import threading

import jax
import numpy as np
import pytest
import torch
import yaml

from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.serving import protocol as JP
from wekws_tpu_torch.bin.serve import build_engine, warmup_engine
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.serving import KwsClient, KwsServer
from wekws_tpu_torch.serving import protocol as P
from wekws_tpu_torch.tools.from_jax import model_from_jax

CHUNK_BYTES = 9600  # 300 ms of int16 PCM


@pytest.mark.parametrize("msg_type,payload", [
    (P.MSG_AUDIO, b"\x01\x02\x03"), (P.MSG_EOS, b""),
    (P.MSG_READY, b'{"stream": 3}'), (P.MSG_BYE, b"x" * P.MAX_PAYLOAD),
])
def test_protocol_bytes_equal_jax(msg_type, payload):
    assert (P.MSG_AUDIO, P.MSG_EOS, P.MSG_READY, P.MSG_EVENT, P.MSG_BYE,
            P.HEADER_SIZE, P.MAX_PAYLOAD) == (
        JP.MSG_AUDIO, JP.MSG_EOS, JP.MSG_READY, JP.MSG_EVENT, JP.MSG_BYE,
        JP.HEADER_SIZE, JP.MAX_PAYLOAD)
    msg = P.pack(msg_type, payload)
    assert msg == JP.pack(msg_type, payload)
    assert P.unpack_header(msg[:P.HEADER_SIZE]) == (msg_type, len(payload))
    event = {"keyword": "ok", "score": 0.9, "frame": 7}
    assert P.pack_json(P.MSG_EVENT, event) == JP.pack_json(JP.MSG_EVENT,
                                                          event)


def test_protocol_rejects_oversize():
    with pytest.raises(ValueError):
        P.pack(P.MSG_AUDIO, b"x" * (P.MAX_PAYLOAD + 1))
    with pytest.raises(ValueError):
        P.unpack_header(b"\xff" * P.HEADER_SIZE)


# tests/test_serving.py's tiny DS-TCN: a max-pooling head, and a CTC one
DATASET_CONF = {"feats_type": "fbank",
                "fbank_conf": {"num_mel_bins": 23, "frame_shift": 10,
                               "frame_length": 25, "dither": 0.0}}
BACKBONE = {"input_dim": 23, "hidden_dim": 16,
            "preprocessing": {"type": "linear"},
            "backbone": {"type": "tcn", "ds": True, "num_layers": 2,
                         "kernel_size": 4, "dropout": 0.0}}
MODELS = {
    "maxpool": dict(BACKBONE, output_dim=2),
    "ctc": dict(BACKBONE, output_dim=4,
                classifier={"type": "element", "dropout": 0.0},
                activation={"type": "identity"}),
}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Port checkpoints of both models, weights from JAX ones (seeds 7
    and 0) through tools/from_jax, and a token table."""
    tmp = tmp_path_factory.mktemp("daemon")
    out = {}
    for (name, conf), seed in zip(sorted(MODELS.items()), (0, 7)):
        model = jax_init_model(conf)
        variables = model.init(jax.random.PRNGKey(seed),
                               np.zeros((1, 10, 23), np.float32))
        params = jax.tree_util.tree_map(np.asarray, variables["params"])
        stats = jax.tree_util.tree_map(np.asarray,
                                       dict(variables["batch_stats"]))
        ckpt = tmp / f"{name}.pt"
        torch.save(model_from_jax(params, stats, conf).state_dict(), ckpt)
        config = tmp / f"{name}.yaml"
        config.write_text(yaml.dump({"dataset_conf": DATASET_CONF,
                                     "model": conf}))
        out[name] = (str(ckpt), str(config))
    tokens = tmp / "tokens.txt"
    tokens.write_text("<blk> 0\nh 1\ni 2\nx 3\n")
    out["tokens"] = str(tokens)
    # the CTC model exported by the port and statically quantized on
    # features of noise through its frontend: an int8 artifact directory
    from wekws_tpu_torch.export import export_model, quantize_artifact
    from wekws_tpu_torch.export.calibrate import feats_from_waves

    ckpt, config = out["ctc"]
    model = init_model(MODELS["ctc"])
    model.load_state_dict(torch.load(ckpt))
    art, qart = str(tmp / "ctc_artifact"), str(tmp / "ctc_int8")
    export_model(model, {"model": MODELS["ctc"],
                         "dataset_conf": DATASET_CONF}, art)
    waves = [np.frombuffer(_pcm(10 + i), "<i2").astype(np.float32)
             for i in range(4)]
    quantize_artifact(art, qart, calib_feats=feats_from_waves(art, waves))
    out["ctc_int8_artifact"] = (qart, config)
    return out


def _args(models, kind, streams=4, **kw):
    """A ``bin.serve`` Namespace for a CPU engine."""
    ckpt, config = models[kind if kind in models else "ctc"]
    ns = dict(maxpool=kind == "maxpool", keywords="hey,ok", config=config,
              checkpoint=ckpt, threshold=0.05, streams=streams,
              step_frames=8, interval_frames=30, mesh_devices=0,
              token_file=None, lexicon_file=None, min_frames=1,
              max_frames=250, score_beam=3, path_beam=20,
              device_decode=kind == "ctc_device_decode",
              device_frontend=False, device="cpu")
    if kind != "maxpool":
        ns.update(keywords="hi,hx", token_file=models["tokens"])
    ns.update(kw)
    return argparse.Namespace(**ns)


class _ServerThread:
    """KwsServer on its own event-loop thread; port picked by the OS."""

    def __init__(self, engine):
        self.server = KwsServer(engine, "127.0.0.1", 0)
        self._started = threading.Event()
        self._loop = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        assert self._started.wait(10), "server failed to start"

    def _run(self):
        async def main():
            self._loop = asyncio.get_running_loop()
            await self.server.start()
            self._started.set()
            try:
                await self.server._server.serve_forever()
            except asyncio.CancelledError:
                pass

        asyncio.run(main())

    @property
    def port(self):
        return self.server.port

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.server.stop(),
                                         self._loop).result(10)
        self.thread.join(10)
        assert not self.thread.is_alive()


def _pcm(seed, seconds=1.5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 3000).astype(
        "<i2").tobytes()


def _in_process(engine, pcm, slot=0):
    """What the daemon does for one client, in process: each chunk
    accepted and every full step run, then EOS's drain."""
    events = []
    for off in range(0, len(pcm), CHUNK_BYTES):
        engine.accept_wave(slot, pcm[off:off + CHUNK_BYTES])
        while True:
            results = engine.step()
            if not results:
                break
            events += [r for r in results.values() if r.get("state") == 1]
    events += [r for r in engine.flush_stream(slot) if r.get("state") == 1]
    engine.reset_stream(slot)
    return events


def _client(port, pcm):
    with KwsClient("127.0.0.1", port) as c:
        for off in range(0, len(pcm), CHUNK_BYTES):
            c.send_audio(pcm[off:off + CHUNK_BYTES])
        return c.stream, c.finish()


@pytest.mark.parametrize("kind", ["maxpool", "ctc", "ctc_device_decode",
                                  "ctc_int8_artifact"])
def test_daemon_events_equal_in_process(models, kind):
    """Two clients at once on their own slots, then a third on a freed
    slot: each client's events (EOS drained) equal the in-process
    engine's for its audio; every engine call ran on the engine
    thread.  ``ctc_int8_artifact`` serves a static-int8 artifact
    directory as ``--checkpoint`` (the artifact runtime's own ops)."""
    engine = build_engine(_args(models, kind))
    reference = build_engine(_args(models, kind))
    pcms = [_pcm(1), _pcm(2, 2.0), _pcm(3, 1.0)]
    want = [_in_process(reference, p) for p in pcms]
    assert all(want), "threshold too high: the test is vacuous"
    threads = set()
    step = engine.step

    def recorded_step():
        threads.add(threading.current_thread().name)
        return step()

    engine.step = recorded_step
    st = _ServerThread(engine)
    try:
        got = [None, None]

        def run(i):
            got[i] = _client(st.port, pcms[i])

        workers = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
            assert not w.is_alive()
        assert got[0][0] != got[1][0]
        got.append(_client(st.port, pcms[2]))
        assert got[2][0] in (got[0][0], got[1][0])  # a reused slot
        assert st.server.stats["steps"] > 0
    finally:
        st.stop()
    assert [g[1] for g in got] == want
    assert threads and all(t.startswith("kws-engine") for t in threads)


def test_daemon_server_full(models):
    engine = build_engine(_args(models, "maxpool", streams=1))
    st = _ServerThread(engine)
    try:
        first = KwsClient("127.0.0.1", st.port)
        with pytest.raises(ConnectionError, match="refused"):
            KwsClient("127.0.0.1", st.port)
        first.send_audio(_pcm(4, 0.5))
        want = _in_process(build_engine(_args(models, "maxpool", streams=1)),
                           _pcm(4, 0.5))
        assert first.finish() == want and want
    finally:
        st.stop()


def test_serve_mesh_devices_raises(models):
    """``--mesh_devices`` (ported since, A.13) splits the streams over
    that many cards; asking for more devices than the machine has (the
    CPU is one) raises, where the JAX CLI quietly takes fewer."""
    with pytest.raises(ValueError, match="--mesh_devices 2: this machine "
                                         "has 1 cpu device"):
        build_engine(_args(models, "maxpool", mesh_devices=2))
    engine = build_engine(_args(models, "maxpool", mesh_devices=1))
    assert engine.devices == [torch.device("cpu")]


def test_warmup_engine_leaves_clean_slots(models):
    """``warmup_engine`` runs a step and a flush on slot 0, then resets
    every slot and the stats: a client afterwards sees the events of a
    fresh engine."""
    engine = build_engine(_args(models, "ctc_device_decode"))
    warmup_engine(engine)
    assert engine.pending_frames(0) == 0 and engine.step() == {}
    assert engine.stats["dispatches"] == 0
    assert engine.stats["dispatch_s"] == 0.0
    pcm = _pcm(5)
    want = _in_process(build_engine(_args(models, "ctc_device_decode")),
                       pcm)
    assert want, "threshold too high: the test is vacuous"
    st = _ServerThread(engine)
    try:
        assert _client(st.port, pcm)[1] == want
    finally:
        st.stop()


@pytest.mark.parametrize("device,current,want", [
    ("cuda", 3, 3), ("cuda:1", 0, 1), ("cpu", 0, None)])
def test_engine_thread_takes_a_cuda_index(monkeypatch, device, current,
                                          want):
    """The engine thread is bound to the engine's CUDA device by index:
    for a bare "cuda" the device current when the server was built
    (``torch.cuda.set_device`` raises for a device without an index,
    which would break the executor and reset every client)."""
    import types

    calls = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    engine = types.SimpleNamespace(num_streams=1,
                                   device=torch.device(device))
    server = KwsServer(engine)
    try:
        server._exec.submit(lambda: None).result(10)
    finally:
        server._exec.shutdown(wait=True)
    assert calls == ([] if want is None else [want])


def test_serve_main_stops_on_sigterm_and_logs_served(models):
    """``python -m wekws_tpu_torch.bin.serve`` in its own process: a
    client's events equal the in-process engine's, and on SIGTERM the
    daemon stops, exits 0 and logs its ``served:`` line: the engine's
    dispatches, the server's steps and each serving kernel's launches
    after the warm-up (none on the CPU)."""
    import json
    import os
    import re
    import signal
    import subprocess
    import sys
    import time

    ckpt, config = models["maxpool"]
    argv = ["--maxpool", "--config", config, "--checkpoint", ckpt,
            "--keywords", "hey,ok", "--threshold", "0.05", "--streams", "2",
            "--interval_frames", "30", "--port", "0", "--warmup",
            "--device", "cpu"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "wekws_tpu_torch.bin.serve", *argv],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log = []
    try:
        t0 = time.time()
        port = None
        while port is None and time.time() - t0 < 60:
            line = proc.stdout.readline()
            assert line, "bin.serve exited before opening its port"
            log.append(line)
            m = re.search(r"kws server on 127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        pcm = _pcm(6)
        want = _in_process(build_engine(_args(models, "maxpool",
                                              streams=2)), pcm)
        assert want, "threshold too high: the test is vacuous"
        assert _client(port, pcm)[1] == want
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0
    served = json.loads(re.findall(r"served: (\{.*\})", out)[-1])
    assert served["engine"]["dispatches"] > 0
    assert served["server"]["steps"] > 0
    assert served["launches"] == {
        "fused_fbank": 0, "fused_mdtc_forward": 0, "fused_mdtc_stream": 0,
        "fused_ds_tcn": 0, "fused_fsmn_layers": 0}
