"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C function and compiles, on
first use, into ``build/kernels/lib<name>-<hash>.so`` under the
repository root (a directory ``.gitignore`` lists; the hash is of the
source and the flags, so an edited source never loads a stale
library). The command is the one the sources are written for::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>.so <name>.cu

Nothing here runs at import: the CPU tests import this module on
hosts that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..base import MXNetError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("flash_attention", "flash_attention_bwd", "paged_attention",
           "int8_epilogue", "fused_opt")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs = {}


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found (PATH or $CUDA_HOME/bin): the port's "
                     "CUDA kernels are built from source on first use")


def _target(name):
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name, nvcc):
    """Start compiling ``name`` unless its library exists; returns
    (target, tmp, process) or None."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def build_all(names=KERNELS):
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns the wall seconds taken. Each
    library compiled counts as one build in the telemetry, charged to the
    op in scope (``telemetry.compile_scope``)."""
    from .. import telemetry
    t0 = time.perf_counter()
    with _lock:
        nvcc = _nvcc()
        jobs = [j for j in (_start(n, nvcc) for n in names) if j]
        failures = []
        for target, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{target.name}: nvcc exit "
                                f"{proc.returncode}\n{log}")
                continue
            os.replace(tmp, target)   # atomic: readers never see a partial .so
        if failures:
            raise MXNetError("kernel build failed:\n" + "\n".join(failures))
    seconds = time.perf_counter() - t0
    for _ in jobs:
        # the jobs ran together: their wall time is split evenly
        telemetry.note_compile(seconds / len(jobs))
    return seconds


def load(name):
    """The loaded ctypes library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
