"""The port's kernel build module (wekws_tpu_torch.ops.cuda_build) as far as
it runs without ``nvcc``: library names and the ``-Xptxas -v`` parser."""

import os

import pytest

from wekws_tpu_torch.ops import cuda_build
from wekws_tpu_torch.tools import time_train_passes

PTXAS_LOG = """\
fused_mdtc_train.cu(293): warning #128-D: loop is not reachable
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__c166e678_19_fused_mdtc_train_cu_b544531b9b4_kernelILi64EEEvNS_4ArgsEi' for 'sm_90a'
ptxas info    : Function properties for _ZN52_GLOBAL__N__c166e678_19_fused_mdtc_train_cu_b544531b9b4_kernelILi64EEEvNS_4ArgsEi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__c166e678_19_fused_mdtc_train_cu_b544531b9b3_kernelILi64EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN52_GLOBAL__N__c166e678_19_fused_mdtc_train_cu_b544531b9b3_kernelILi64EEEvNS_4ArgsE
    40 bytes stack frame, 24 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 40 bytes cumulative stack size
"""


def test_parse_ptxas_log_names_each_kernel():
    got = cuda_build.parse_ptxas_log(PTXAS_LOG)
    assert [(e.partition("_kernelILi")[0][-2:], r, st, ld)
            for e, r, st, ld in got] == [("b4", 128, 0, 0),
                                         ("b3", 128, 24, 28)]
    assert cuda_build.parse_ptxas_log("") == []


@pytest.mark.parametrize("name", cuda_build.KERNEL_SOURCES)
def test_library_path_follows_the_source(name):
    """One library per source, named by a hash of the source and the
    compiler flags, inside the build directory."""
    path = cuda_build.library_path(name)
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert os.path.basename(path).startswith(f"lib{name}-")
    assert path == cuda_build.library_path(name)
    assert os.path.exists(os.path.join(cuda_build.CSRC_DIR, f"{name}.cu"))


@pytest.mark.parametrize("name", ["f1", "f2", "f3", "f4", "b1", "b2", "b3",
                                  "b4"])
def test_kernel_name_is_in_the_source(name):
    """The kernel name that ``chip_smoke.py`` looks for in a profile is
    a kernel of ``csrc/fused_mdtc_train.cu``."""
    from wekws_tpu_torch.ops.fused_mdtc_train import kernel_name

    with open(os.path.join(cuda_build.CSRC_DIR, "fused_mdtc_train.cu")) as f:
        source = f.read()
    kern = kernel_name(name, 64).partition("<")[0]
    assert f"{kern}(Args a" in source


@pytest.mark.parametrize("name", ["f1", "f2", "f3", "f4", "b1", "b2", "b3",
                                  "b4"])
def test_bf16_kernel_name_is_in_the_source(name):
    """At bf16 F2, F3, B2 and B3 name their own kernel
    (``<pass>_bf16_kernel``), which ``csrc/fused_mdtc_train.cu`` defines,
    so that a profile and the launch counts keep the variants apart;
    F1, F4, B1 and B4 have no variant and keep their kernel's name."""
    from wekws_tpu_torch.ops.fused_mdtc_train import (
        BF16_PASSES,
        kernel_name,
    )

    with open(os.path.join(cuda_build.CSRC_DIR, "fused_mdtc_train.cu")) as f:
        source = f.read()
    kern = kernel_name(name, 64, "bfloat16").partition("<")[0]
    assert f"{kern}(Args a" in source
    if name in BF16_PASSES:
        assert kern == f"{name}_bf16_kernel"
    else:
        assert kernel_name(name, 64, "bfloat16") == kernel_name(name, 64)


def test_one_channel_f2_and_b1_are_gone():
    """F2 and B1 run only their flattened, four-channels-a-thread
    kernels: the one-channel ``fwd_kernel<C, 2>`` and ``b1_kernel`` are
    not in the source, so a profile cannot show them."""
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_mdtc_train.cu")) as f:
        source = f.read()
    assert "fwd_kernel" not in source
    assert " b1_kernel(" not in source


def test_one_channel_f1_is_gone():
    """F1 runs only its flattened, four-channels-a-thread kernel
    (``tile_forward<C, kF1>``): the one-channel ``f1_kernel`` and its
    scalar ``dwconv`` are not in the source."""
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_mdtc_train.cu")) as f:
        source = f.read()
    assert " f1_kernel(" not in source
    assert "dwconv(" not in source
    assert "tile_forward<C, kF1>(a, staged)" in source


def test_ds_tcn_runs_on_the_mdtc_kernel_body():
    """The DS-TCN serving kernel is the MDTC kernel's body with another
    layer: both entries in csrc/fused_mdtc.cu call one ``run_layers``;
    the one-block-a-row ``csrc/fused_tcn.cu`` and its library are gone."""
    assert "fused_tcn" not in cuda_build.KERNEL_SOURCES
    assert not os.path.exists(os.path.join(cuda_build.CSRC_DIR,
                                           "fused_tcn.cu"))
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_mdtc.cu")) as f:
        source = f.read()
    for arch, kern in (("kMdtc", "fused_mdtc_kernel"),
                       ("kDsTcn", "fused_ds_tcn_kernel")):
        assert f"{kern}(Ptrs a, Plan p, LayerDilations dil) {{\n" \
               f"  run_layers<{arch}, C, RJ, S>(a, p, dil);" in source
    assert source.count("__global__") == 2


@pytest.mark.parametrize("module", ["fused_mdtc", "fused_tcn"])
def test_wrappers_call_entries_of_the_source(module):
    """Every C entry a wrapper calls through ctypes is exported by
    csrc/fused_mdtc.cu."""
    import re

    with open(os.path.join(cuda_build.CSRC_DIR, "fused_mdtc.cu")) as f:
        source = f.read()
    path = os.path.join(cuda_build.PACKAGE_DIR, "ops", f"{module}.py")
    with open(path) as f:
        called = set(re.findall(r"lib\.(fused_\w+)", f.read()))
    if module == "fused_mdtc":  # the per-layer entries by f-string
        called |= {f"fused_{a}_{e}" for a in ("mdtc", "ds_tcn")
                   for e in ("launch", "max_clusters")}
    assert called
    for name in called:
        assert re.search(rf"^(int|const char\*) {name}\(", source, re.M), name


@pytest.mark.parametrize("name", sorted(time_train_passes.VARIANTS))
def test_time_train_passes_variant_applies_to_the_source(name):
    """Each variant of ``tools/time_train_passes.py`` edits
    csrc/fused_mdtc_train.cu as ``build_variants`` will on the card:
    every old text occurs exactly once, and the edited source differs.
    A kernel rewrite that breaks a variant fails here."""
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_mdtc_train.cu")) as f:
        source = f.read()
    tool = time_train_passes
    for old, _ in tool.VARIANTS[name]:
        assert source.count(old) == 1, old
    assert tool.variant_text(source, name) != source
    assert set(tool.TIMING_ONLY) | set(tool.KNOBS) <= set(tool.VARIANTS)


def test_bf16_forward_and_b3_bodies():
    """F2's and F3's bf16 kernels share one body (``bf16_forward``, a
    template over the pass); B3's bf16 kernel runs its products by
    ``mma.sync`` with ``ldmatrix`` operands: no ``wmma`` at bf16, and
    the float32 forward body has no bf16 switch."""
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_mdtc_train.cu")) as f:
        source = f.read()
    for p in ("kF2", "kF3"):
        kern = "f2" if p == "kF2" else "f3"
        assert (f"{kern}_bf16_kernel(Args a, bool staged) {{\n"
                f"  bf16_forward<C, {p}>(a, staged);") in source
    body = source.partition("b3_bf16_kernel(Args a, bool staged) {")[2]
    body = body.partition("\n}\n")[0]
    assert "wm::" not in body and "ldsm_x4" in body and "mma_bf16" in body
    assert "__nv_bfloat16, Layout" not in source
    assert "bool BF" not in source and "bf16r" not in source


def _c_int_expr(text):
    """A C integer expression over ``tt[h]``, ``H``, ``a.K``, ``a.d`` and
    ``tap`` as a Python function of (t, tap, K, d, H): ``?:`` chains and
    ``/`` truncating toward zero, as C's ``int`` division does."""
    import re

    text = (text.replace("tt[h]", "t").replace("a.K", "K")
            .replace("a.d", "d"))
    text = re.sub(r"(\w+) / (\w+)", r"_cdiv(\1, \2)", text)

    def ternary(expr):
        if "?" not in expr:
            return expr
        cond, _, rest = expr.partition("?")
        then, _, other = rest.partition(":")
        return f"(({then}) if ({cond}) else ({ternary(other)}))"

    code = ternary(text)
    scope = {"_cdiv": lambda p, q: abs(p) // abs(q) * (1 if p * q >= 0
                                                        else -1)}
    return eval(f"lambda t, tap, K, d, H: {code}", scope)


def _conv_reads(kernel, source):
    """{kernel: reads(t, tap, K, d, H)}: whether the conv of F2b and F3b
    (``bf16_forward``: taps from ``first[h]`` on) or of B3b (a tap while
    ``back <= tt[h]``) reads tap ``tap`` of a row at frame t (-1 past the
    end), by the rule as the source states it."""
    import re

    if kernel == "bf16_forward":
        body = source.partition("__device__ __forceinline__ void "
                                "bf16_forward(")[2]
        found = re.findall(r"first\[h\] = (.*);", body.partition("\n}\n")[0])
        assert len(found) == 1
        first = _c_int_expr(found[0])
        return lambda t, tap, K, d, H: tap >= first(t, tap, K, d, H)
    body = source.partition("b3_bf16_kernel(Args a, bool staged) {")[2]
    body = body.partition("\n}\n")[0]
    assert body.count("const int back = (a.K - 1 - tap) * a.d;") == 1
    found = re.findall(r"if \((back <= tt\[h\])\)", body)
    assert len(found) == 1
    return lambda t, tap, K, d, H: (K - 1 - tap) * d <= t


@pytest.mark.parametrize("kernel", ["bf16_forward", "b3_bf16_kernel"])
def test_bf16_conv_reads_no_row_past_the_end(kernel):
    """The conv of the bf16 F2, F3 and B3 kernels, where it reads its taps
    from device memory (a window too long for shared memory), reads row
    (row - H + tap d) of x for tap ``tap`` of a row: a model of each
    kernel's tap rule, evaluated as C evaluates the source's expression,
    over the rows of every tile (a ragged last one past the end), reads
    no row before the utterance or past the end of x, and every tap
    within the utterance."""
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_mdtc_train.cu")) as f:
        reads = _conv_reads(kernel, f.read())
    for b, t_len, k, d, rows in [(3, 200, 5, 40, 128), (2, 700, 5, 169, 128),
                                 (5, 77, 5, 4, 128), (3, 70, 3, 8, 32),
                                 (2, 150, 8, 2, 64), (1, 9, 1, 3, 32)]:
        h_len = (k - 1) * d
        n_rows = b * t_len
        for row in range(-(-n_rows // rows) * rows):
            t = row % t_len if row < n_rows else -1
            for tap in range(k):
                read = row - h_len + tap * d
                wanted = t >= 0 and read >= row - t
                assert reads(t, tap, k, d, h_len) == wanted, (
                    b, t_len, k, d, row, tap)
