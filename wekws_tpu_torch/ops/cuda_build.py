"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``wekws_tpu_torch/build/`` at
first use, then loaded with ``ctypes``.  The library's file name
carries a hash of its source, so an edited kernel is rebuilt and a
stale one is never loaded.  Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, Iterable, List, Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
KERNEL_SOURCES = ("fused_mdtc", "fused_mdtc_train", "fused_fsmn",
                  "fused_frontend")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels are built only on a machine with the CUDA toolkit"
        )
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str] = KERNEL_SOURCES) -> List[str]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together.  Raises with the compiler's output on failure;
    ``build_logs[name]`` keeps what ``-Xptxas -v`` printed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    paths = []
    for name in names:
        path = library_path(name)
        paths.append(path)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def parse_ptxas_log(log: str) -> List[Tuple[str, int, int, int]]:
    """What ``-Xptxas -v`` said of each kernel: (mangled entry function,
    registers a thread, spill-store bytes, spill-load bytes), in the
    log's order."""
    out = []
    entry, spills = None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.append((entry, int(m.group(1))) + spills)
            entry = None
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        (path,) = build([name])
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib
