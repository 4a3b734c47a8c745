"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first use
with ``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>.so`` beside the
package, then loaded with ``ctypes``. The shared headers ``csrc/*.cuh`` count
as sources of every library. Nothing is compiled or loaded at
import time, so the CPU tests can import every module without a toolkit.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded = {}
build_seconds = {}
build_log = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def build(name: str, extra_flags=(), force: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` if ``force`` or its library is missing or
    older than the source; returns the library path. The output is written
    to a temporary file and renamed, so a cut build leaves no half library.
    The compiler's messages land in ``build_log[name]``."""
    src = os.path.join(CSRC, f"{name}.cu")
    out = library_path(name)
    newest = max(os.path.getmtime(f) for f in
                 [src] + glob.glob(os.path.join(CSRC, "*.cuh")))
    if (not force and os.path.exists(out)
            and os.path.getmtime(out) >= newest):
        return out
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
                               src], capture_output=True, text=True)
        build_log[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds[name] = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib
