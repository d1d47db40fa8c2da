"""Build the package's CUDA kernels from ``csrc/*.cu`` on first use.

Every ``.cu`` file under ``csrc/`` is compiled by its own ``nvcc`` for
``sm_90a`` (all started together), and the objects are linked into ONE
shared library with a plain C interface, loaded with ``ctypes``; the
``.cuh`` headers there hold device code that several kernels share.
The library lands in ``ominix_mlx_tpu_torch/_build/`` (git-ignored) under a
name keyed by a hash of the sources, headers and flags, so an edited
kernel always rebuilds and an unchanged one is reused. Nothing is
downloaded; a build failure raises with nvcc's stderr. Nothing here runs
at import time.
"""

from __future__ import annotations

import collections
import contextlib
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
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo")
# The SM count of the H100 (SXM) that the kernels are built for; the host
# plans (dq_plan, qmm_p_rows_per_warp, k3_plan) size their grids to it.
SMS = 132

_lock = threading.Lock()
_lib = None
build_seconds = 0.0     # wall time of the build this process ran (0 if reused)

# Kernel launch counts, by kernel: incremented by each wrapper where it
# launches its kernel and nowhere else ("k1_m1": K1 at M=1 on a 4-bit
# weight, "k1_mn": K1 at 2 <= M <= 16 on a 4-bit weight (the dq kernel),
# "k1_m1_w8" and "k1_mn_w8": the same on an 8-bit weight, "k6": the
# row-major P formula over up to 16 rows, "k7": the dq kernel on row-major
# 4-bit weights up to 64 rows,
# "k2": flash prefill, "k2c": flash continuation chunk ("k2_window",
# "k2c_window": the part of each with a sliding window),
# "k3": paged decode attention, "k3_int8": the part of "k3" on int8
# pages, "k4": MoE expert gather-qmm on 4-bit experts, "k4_w8": the same
# on 8-bit experts, "k5": grouped matmul on bf16 experts, "k5_w4" and
# "k5_w8": the same on 4- and 8-bit experts read packed, "k8": channelwise
# w8a8 expert gather, "k9": the gated delta rule of a DeltaNet layer in its
# recurrent form, "k9_chunk" and "k9_chunk_scan": the two phases of its
# chunked form, "k9_prep": the layer's prologue before the rule,
# "k9_decode": a DeltaNet layer's whole decode mixer (the prologue, one
# step of the rule, the gated norm and gate); "k10":
# MiniCPM-SALA's lightning attention in its recurrent form, "k10_chunk":
# its chunked form (one launch), "k10_decode": a lightning layer's whole
# decode mixer (norms, RoPE, the state step, the gate); "k11_score",
# "k11_select" and "k11_attend": InfLLMv2's block scorer, the scorer with
# its top-k (the decode path's), and sparse decode attention; "k12":
# Paraformer's CIF).
# Plain-version calls do not count. A launch made while the calling thread
# records a CUDA graph's capture (``recording``) is counted each time the
# graph replays (``replayed``), not at the capture, where nothing runs.
class _Record:
    """What ran during one capture: ``launches`` (increments of counters
    that defer to the record, LAUNCHES among them) and ``actions``
    (callables passed to ``on_run``)."""

    def __init__(self):
        self.launches: dict = {}        # id(counter) -> (counter, Counter)
        self.actions: list = []


_RECORDING = threading.local()


def _open_record():
    return getattr(_RECORDING, "record", None)


class ReplayedCounter(collections.Counter):
    """A Counter whose increments, made while the calling thread records a
    capture, go to that record instead (added on each ``replayed``)."""

    def __setitem__(self, key, value):
        record = _open_record()
        if record is None:
            super().__setitem__(key, value)
            return
        _, counts = record.launches.setdefault(
            id(self), (self, collections.Counter()))
        counts[key] += value - self[key]


LAUNCHES: ReplayedCounter = ReplayedCounter()


def reset_launches():
    LAUNCHES.clear()


@contextlib.contextmanager
def recording():
    """Within: the calling thread's increments of a ``ReplayedCounter`` (the
    wrappers' LAUNCHES) and its ``on_run`` actions go to the yielded record,
    for a CUDA graph's capture; other threads count as usual."""
    record, prev = _Record(), _open_record()
    _RECORDING.record = record
    try:
        yield record
    finally:
        _RECORDING.record = prev


def replayed(record: _Record, n: int = 1):
    """Count ``n`` replays of the graph whose capture made ``record``: what
    n eager runs of the captured work would have counted."""
    for counter, counts in record.launches.values():
        for key, c in counts.items():
            counter[key] += n * c
    for _ in range(n):
        for action in record.actions:
            action()


def on_run(action):
    """Call ``action()`` now, or, while the calling thread records a
    capture, at each replay of that graph: for counts of what ran."""
    record = _open_record()
    if record is None:
        action()
    else:
        record.actions.append(action)


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
    lib.ominix_qmm_p.restype = i
    lib.ominix_qmm_p.argtypes = [vp, vp, f, vp, vp, vp, vp, vp, vp, vp, vp,
                                 i, i, i, i, i, i, i, vp]
    lib.ominix_qmm_dq_tc.restype = i
    lib.ominix_qmm_dq_tc.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                                     i, i, i, i, i, vp]
    lib.ominix_flash_fwd.restype = i
    lib.ominix_flash_fwd.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i,
                                     f, vp]
    ll = ctypes.c_longlong
    lib.ominix_flash_chunk_fwd.restype = i
    lib.ominix_flash_chunk_fwd.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i,
                                           i, ll, ll, ll, ll, ll, ll, i, f,
                                           vp]
    lib.ominix_paged_decode.restype = i
    lib.ominix_paged_decode.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                        vp, i, i, i, i, i, i, i, i, i, f, i,
                                        i, vp]
    lib.ominix_gather_qmm.restype = i
    lib.ominix_gather_qmm.argtypes = [vp] * 13 + [i] * 9 + [vp]
    lib.ominix_channel_gather_qmm.restype = i
    lib.ominix_channel_gather_qmm.argtypes = [vp, i] + [vp] * 9 + [i] * 7 \
        + [vp]
    lib.ominix_launch_probe.restype = i
    lib.ominix_launch_probe.argtypes = [i, i, vp]
    lib.ominix_grouped_mm.restype = i
    lib.ominix_grouped_mm.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i,
                                      i, i, i, i, vp]
    lib.ominix_gated_delta.restype = i
    lib.ominix_gated_delta.argtypes = [vp] * 7 + [i] * 6 + [vp]
    lib.ominix_gated_delta_chunked.restype = i
    lib.ominix_gated_delta_chunked.argtypes = [vp] * 11 + [i] * 6 + [vp]
    lib.ominix_k9_prep.restype = i
    lib.ominix_k9_prep.argtypes = [vp] * 11 + [i] * 8 + [f, vp]
    lib.ominix_k9_decode.restype = i
    lib.ominix_k9_decode.argtypes = [vp] * 9 + [i] * 7 + [f, f, i, vp]
    lib.ominix_k9_decode_clusters.restype = i
    lib.ominix_k9_decode_clusters.argtypes = [i, i]
    lib.ominix_lightning.restype = i
    lib.ominix_lightning.argtypes = [vp] * 6 + [i] * 5 + [ll] * 9 + [vp]
    lib.ominix_lightning_chunked.restype = i
    lib.ominix_lightning_chunked.argtypes = [vp] * 6 + [i] * 5 + [ll] * 9 \
        + [vp]
    lib.ominix_lightning_decode.restype = i
    lib.ominix_lightning_decode.argtypes = [vp] * 3 + [ll] * 6 + [vp, ll] \
        + [vp] * 3 + [f, i, f, f, f, ll] + [vp] * 7 + [i] * 5 + [vp]
    lib.ominix_sparse_score.restype = i
    lib.ominix_sparse_score.argtypes = [vp] * 4 + [i] * 8 + [vp]
    lib.ominix_sparse_select.restype = i
    lib.ominix_sparse_select.argtypes = [vp] * 7 + [i] * 11 + [vp]
    lib.ominix_sparse_attend.restype = i
    lib.ominix_sparse_attend.argtypes = [vp] * 10 + [i] * 12 + [f, vp]
    lib.ominix_cif.restype = i
    lib.ominix_cif.argtypes = [vp] * 4 + [i] * 6 + [f, f, vp]
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
        for s in srcs + sorted(CSRC.glob("*.cuh")):
            h.update(s.name.encode())
            h.update(s.read_bytes())
        out = BUILD_DIR / f"libominix_kernels_{h.hexdigest()[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
            objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
            procs = [(subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), s)
                for s, o in zip(srcs, objs)]
            errs = []
            for p, s in procs:
                _, err = p.communicate()
                if p.returncode != 0:
                    errs.append(f"nvcc failed ({p.returncode}) on {s.name}:"
                                f"\n{err}")
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            if not errs:
                cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                       *map(str, objs)]
                r = subprocess.run(cmd, capture_output=True, text=True)
                if r.returncode != 0:
                    errs.append(f"link failed ({r.returncode}): "
                                f"{' '.join(cmd)}\n{r.stderr}")
            for o in objs:
                o.unlink(missing_ok=True)
            if errs:
                raise RuntimeError("\n".join(errs))
            os.replace(tmp, out)    # atomic: a concurrent build never sees
            build_seconds = time.perf_counter() - t0  # a half-written file
        _lib = _declare(ctypes.CDLL(str(out)))
        return _lib


def check(rc: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().ominix_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
