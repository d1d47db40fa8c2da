"""The host-side audio runtime in C++ (counterpart of
ominix_mlx_tpu/native/__init__.py), loaded with ctypes: ``resample_sinc``
(Hann-windowed sinc), ``pcm16_to_float`` and ``float_to_pcm16``.

``resample.cc`` here is a copy of the JAX package's source. It is compiled
on first use, never at import, with the JAX package's command (``g++ -O3
-march=native -shared -fPIC``) into ``ominix_mlx_tpu_torch/_build/``
(git-ignored), under a name keyed by a hash of the source and the flags.
The library is written to a temporary name and moved into place, so a
process never loads a half-written file. A failed build raises: there is
no numpy fallback (the JAX package's fallback resamples linearly, another
function).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "resample.cc"
BUILD_DIR = SOURCE.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library():
    """The loaded library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        h.update(SOURCE.read_bytes())
        out = BUILD_DIR / f"libominix_native_{h.hexdigest()[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}"
                                  ".tmp")
            cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError("the audio resampler needs g++ to build "
                                   f"{SOURCE}") from e
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed ({r.returncode}): "
                                   f"{' '.join(cmd)}\n{r.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int16)
        lib.resample_sinc.restype = ctypes.c_int64
        lib.resample_sinc.argtypes = [fp, ctypes.c_int64, ctypes.c_double,
                                      ctypes.c_double, fp, ctypes.c_int64,
                                      ctypes.c_int]
        lib.pcm16_to_float.restype = None
        lib.pcm16_to_float.argtypes = [ip, ctypes.c_int64, fp]
        lib.float_to_pcm16.restype = None
        lib.float_to_pcm16.argtypes = [fp, ctypes.c_int64, ip]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(ctypes.POINTER(kind))


def resample_sinc(samples, src_rate: int, dst_rate: int,
                  taps: int = 16) -> np.ndarray:
    """Band-limited (windowed-sinc) resample of float32 samples to
    round(n * dst_rate / src_rate) samples; the input itself (as float32)
    when the rates are equal."""
    if src_rate == dst_rate:
        return np.asarray(samples, np.float32)
    x = np.ascontiguousarray(samples, np.float32)
    n_out = int(round(len(x) * dst_rate / src_rate))
    out = np.empty(n_out, np.float32)
    library().resample_sinc(_ptr(x, ctypes.c_float), len(x),
                            float(src_rate), float(dst_rate),
                            _ptr(out, ctypes.c_float), n_out, taps)
    return out


def pcm16_to_float(pcm) -> np.ndarray:
    """int16 PCM -> float32 in [-1, 1)."""
    pcm = np.ascontiguousarray(pcm, np.int16)
    out = np.empty(len(pcm), np.float32)
    library().pcm16_to_float(_ptr(pcm, ctypes.c_int16), len(pcm),
                             _ptr(out, ctypes.c_float))
    return out


def float_to_pcm16(x) -> np.ndarray:
    """float32 -> int16 PCM, clamped to [-1, 1] and rounded."""
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(len(x), np.int16)
    library().float_to_pcm16(_ptr(x, ctypes.c_float), len(x),
                             _ptr(out, ctypes.c_int16))
    return out
