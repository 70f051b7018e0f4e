"""The port's kernel build module (wekws_tpu_torch.ops.cuda_build) as far as
it runs without ``nvcc``: library names and the ``-Xptxas -v`` parser."""

import os

import pytest

from wekws_tpu_torch.ops import cuda_build

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
