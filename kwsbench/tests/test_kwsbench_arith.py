"""The reductions on made-up timings, and the frozen counts against
hand-worked shapes and the kernel readings of PERF.md's kernel table."""

import pytest

from kwsbench import counts, layers
from kwsbench.trace import Reduced, short_name


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev("kwsbench.window", "user_annotation", 100.0, 1000.0),
    ev("kwsbench.train_step", "user_annotation", 100.0, 400.0),
    ev("kwsbench.metrics_read", "user_annotation", 600.0, 500.0),
    ev("void (anonymous namespace)::fused_fbank_kernel<9>(float const*)",
       "kernel", 150.0, 100.0),
    ev("void (anonymous namespace)::fused_fbank_dense_kernel(float const*)",
       "kernel", 200.0, 100.0),  # overlaps the first: union 150-300
    ev("void at::native::reduce_kernel<512, 1>(int)", "kernel", 700.0, 50.0),
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 800.0, 100.0),
    ev("void (anonymous namespace)::fused_fbank_kernel<9>(float)", "kernel",
       1050.0, 100.0),  # runs past the window's end at 1100
    ev("void late_kernel()", "kernel", 1200.0, 10.0),  # outside
]


def test_busy_idle_and_gaps():
    red = Reduced(EVENTS)
    assert red.window_s == pytest.approx(1e-3)
    # busy: 150-300, 700-750, 800-900, 1050-1100 -> 350 us
    assert red.busy_s == pytest.approx(350e-6)
    assert red.kernel_count() == 4
    gaps = red.idle_gaps()
    # gaps: 100-150 (train_step), 300-700 (train_step until 500, then
    # outside: named at its start), 750-800, 900-1050 (metrics_read)
    assert gaps[0] == ["train_step", pytest.approx(400e-6)]
    assert gaps[1] == ["metrics_read", pytest.approx(150e-6)]
    assert sum(g[1] for g in gaps) == pytest.approx(1e-3 - 350e-6)
    top = dict((k, v) for k, v in red.top_ops())
    assert top["(anonymous namespace)::fused_fbank_kernel<9>"] == \
        pytest.approx(200e-6)
    copies = [v for k, v in top.items() if k.startswith("Memcpy HtoD")]
    assert copies == [pytest.approx(100e-6)]


class FakeCell:
    def __init__(self, red, units, thread_s=None):
        self.layer = {"trace": red, "units": units, "thread_s": thread_s}


def test_port_kernels_and_shares():
    red = Reduced(EVENTS)
    cell = FakeCell(red, 2, thread_s=0.004)
    # fbank 100 + dense 100 + fbank 100 (starts inside); not at::
    assert layers.port_seconds(cell, layers.FBANK_KERNELS) == \
        pytest.approx(300e-6)
    assert layers.port_seconds(cell, ["b4_kernel"]) is None
    assert layers.idle_pct(cell) == pytest.approx(65.0)
    assert layers.host_ms(cell) == pytest.approx(2.0)
    assert layers.is_port_kernel("_ZN12_GLOBAL__N_19b4_kernelILi64EEEvPKf",
                                 ["b4_kernel"])
    assert not layers.is_port_kernel("void at::native::reduce_kernel<512>()",
                                     ["reduce_kernel"])


def test_rate_arithmetic():
    from kwsbench.drivers.common import audio_rate

    # 250 steps of 512 x 6 s in 40 s: 768,000 audio-s over 40 s
    assert audio_rate(250, 512, 96000, 16000, 40.0) == pytest.approx(19200.0)
    assert audio_rate(0, 256, 96000, 16000, 1.0) == 0.0


def test_short_name():
    assert short_name("void (anonymous namespace)::k<1>(int)") == \
        "(anonymous namespace)::k<1>"


def test_least_ms_takes_the_largest_bound():
    assert counts.least_ms(989e9, 0, 0, "bfloat16") == pytest.approx(1.0)
    assert counts.least_ms(0, 67e9, 0, "bfloat16") == pytest.approx(1.0)
    assert counts.least_ms(0, 0, 3.35e9, "float32") == pytest.approx(1.0)
    assert counts.least_ms(495e9, 1, 1, "float32") == pytest.approx(1.0)


def test_hand_worked_counts():
    p, e, n = counts.fbank(1, 560, 400, 160, 512, 100, 40, 80, True)
    rows = 2
    assert p == rows * 2 * 40 * 80
    assert e == pytest.approx(rows * (1600 + 2.5 * 512 * 9 + 3 * 257
                                      + 200 + 40))
    assert n == 4 * (560 + rows * 80)


def test_model_flops():
    tcn = {"hidden_dim": 256, "output_dim": 2,
           "backbone": {"type": "tcn", "num_layers": 4, "kernel_size": 8}}
    assert counts.model_forward_flops(tcn, 80) == \
        2 * 80 * 256 + 2 * 256 * 2 + 4 * (2 * 8 * 256 + 2 * 256 * 256)


# PERF.md's kernel table: fused_fbank's device time a call on the H100,
# 0.3701 ms at (512, 32000) M=40; a bound above it would read over 100%
def test_fbank_bound_at_or_below_the_reading():
    from kwsbench.reference.frontend import mel_bank

    band = int((mel_bank(40, 512, 16000) > 0).sum())
    assert counts.least_ms(*counts.fbank(512, 32000, 400, 160, 512, band,
                                         40, 40, False), "float32") <= 0.3701
