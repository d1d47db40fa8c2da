"""Build the package's CUDA kernels from ``csrc/*.cu`` on first use.

Every ``.cu`` file under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into ONE shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``ominix_mlx_tpu_torch/_build/`` (git-ignored) under a
name keyed by a hash of the sources and flags, so an edited kernel always
rebuilds and an unchanged one is reused. Nothing is downloaded; a build
failure raises with nvcc's stderr. Nothing here runs at import time.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_lib = None
build_seconds = 0.0     # wall time of the build this process ran (0 if reused)

# Kernel launch counts, by kernel: incremented by each wrapper where it
# launches its kernel and nowhere else ("k1_m1": K1 at M=1, "k1_mn": K1 at
# 2 <= M <= 16, "k2": flash prefill). Plain-version calls do not count.
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches():
    LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _declare(lib):
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ominix_qmm_w4.restype = i
    lib.ominix_qmm_w4.argtypes = [vp, vp, f, vp, vp, vp, vp, vp, vp, vp, vp,
                                  i, i, i, i, i, vp]
    lib.ominix_flash_fwd.restype = i
    lib.ominix_flash_fwd.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, f,
                                     vp]
    lib.ominix_cuda_error_string.restype = ctypes.c_char_p
    lib.ominix_cuda_error_string.argtypes = [i]
    return lib


def library():
    """The loaded kernel library, building it first if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs:
            h.update(s.name.encode())
            h.update(s.read_bytes())
        out = BUILD_DIR / f"libominix_kernels_{h.hexdigest()[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                    f"{r.stderr}")
            os.replace(tmp, out)    # atomic: a concurrent build never sees
            build_seconds = time.perf_counter() - t0  # a half-written file
        _lib = _declare(ctypes.CDLL(str(out)))
        return _lib


def check(rc: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().ominix_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
