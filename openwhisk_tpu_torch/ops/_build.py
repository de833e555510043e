"""Build the port's CUDA kernels with nvcc at first use, load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/openwhisk_tpu_torch/<name>-<hash>.so
         openwhisk_tpu_torch/csrc/<name>.cu

The build directory sits beside the package, at the root of the checkout
(`build/` is git-ignored). The file name carries a hash of the sources and
flags, so an edited kernel rebuilds and a stale library is never loaded.
Nothing is compiled or loaded at import time. Every nvcc build and every
load of a built library is reported, with its seconds, to the kernel
profiler's census of builds (`ops/profiler.record_kernel_build`).
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
from typing import Dict, Iterable

from .profiler import record_kernel_build

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "openwhisk_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's report (ptxas registers / shared memory / spills) per built source
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    """The nvcc to build with: $CUDA_HOME/bin, then PATH, then the
    toolkit's default prefix. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from csrc/*.cu")


def library_path(name: str) -> Path:
    """Where the library built from `csrc/<name>.cu` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile the named sources that are not built yet, one nvcc each,
    all started together. Raises with nvcc's output if one fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.monotonic()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        record_kernel_build(name, "nvcc", time.monotonic() - t0)
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, building it first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            t0 = time.monotonic()
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            record_kernel_build(name, "load", time.monotonic() - t0)
        return lib
