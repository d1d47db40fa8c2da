"""Smoke run of the PyTorch port on one CUDA card: builds the kernels from
``ominix_mlx_tpu_torch/csrc``, checks each against its plain PyTorch version
at the main path's shapes, serves chat requests over HTTP on a full-width
Qwen3-4B w4a8 model with random weights (seeded), and reads the decode rate.

    python3 chip_smoke.py              # build, check, serve, decode rate
    python3 chip_smoke.py --profile    # the same, then a decode profile

Each phase prints one JSON line; any failure raises and the script exits
non-zero without a result line. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero at once where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import dataclasses
import json
import os
import pstats
import re
import socket
import statistics
import subprocess
import sys
import time
import urllib.request

import torch

EPS = 1e-6
GS = 64
SEED = 0
MAX_TOKENS = 32
# (name, N, K, RMSNorm fused at decode) for every K1 shape of one decode
# token of Qwen3-4B: 36 x (qkv, o, gate_up, down) + the tied lm_head
K1_SHAPES = (("qkv_proj", 6144, 2560, True), ("o_proj", 2560, 4096, False),
             ("gate_up_proj", 19456, 2560, True),
             ("down_proj", 2560, 9728, False),
             ("lm_head", 151936, 2560, True))
K2_T = (16, 128, 777, 2048)
K1_TOL = 1e-2     # max error / max |plain|: bf16 output, another sum order
K2_TOL = 1e-2     # the same for K2's bf16 output
K2_LSE_TOL = 1e-2  # max abs error of K2's float32 row LSE (wrong scores)
LOGITS_TOL = 2e-2  # rel max error of kernel vs plain logits, 2 layers


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, flush) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` launches, each
    after an L2 flush (the decode path finds every weight cold in L2)."""
    fn()
    times = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------ kernels -------

def check_k1(dev, flush):
    from ominix_mlx_tpu_torch.core.quant import QuantizedTensor
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, N, K, norm in K1_SHAPES:
        G = K // GS
        qt = QuantizedTensor(
            q=torch.randint(-8, 8, (N, K), generator=g, device=dev,
                            dtype=torch.int8),
            scales=((torch.rand(N, G, generator=g, device=dev) + 0.5)
                    * (K ** -0.5 / 8)).bfloat16(),
            biases=(torch.randn(N, G, generator=g, device=dev)
                    * (K ** -0.5 / 4)).bfloat16(),
            group_size=GS, bits=4)
        pq8 = qm.prepare(qt, act_bits=8)
        pq16 = dataclasses.replace(pq8, act_bits=None)
        del qt
        nw = (1 + 0.1 * torch.randn(K, generator=g, device=dev)).bfloat16()
        for mode, M in (("a8", 1), ("a16", 1), ("a16", 2), ("a16", 16)):
            a8 = mode == "a8"
            pq = pq8 if a8 else pq16
            x = torch.randn(M, K, generator=g, device=dev).bfloat16()
            w_norm = nw if norm and M == 1 else None
            got = qm._k1(x, pq, w_norm, EPS, a8)
            want = qm.quantized_matmul_reference(
                x, pq, w_norm, EPS, act_bits=8 if a8 else None)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"K1 {name} {mode} M={M}: non-finite")
            d = (got.float() - want.float()).abs().max().item()
            rel = d / max(want.float().abs().max().item(), 1e-12)
            ms = time_ms(lambda: qm._k1(x, pq, w_norm, EPS, a8), 20, flush)
            plain = time_ms(lambda: qm.quantized_matmul_reference(
                x, pq, w_norm, EPS, act_bits=8 if a8 else None), 3, flush)
            row = {"shape": name, "N": N, "K": K, "M": M, "mode": mode,
                   "norm": w_norm is not None, "max_abs_err": d,
                   "rel_err": rel, "ms": ms, "plain_ms": plain,
                   "GBps": (N * K // 2 + 4 * N * G) / ms / 1e6}
            emit({"phase": "k1", **row})
            if not rel < K1_TOL:
                raise RuntimeError(f"K1 {name} {mode} M={M}: rel error "
                                   f"{rel} >= {K1_TOL}")
            rows.append(row)
        del pq8, pq16
        torch.cuda.empty_cache()
    return rows


def check_k2(dev, flush):
    from ominix_mlx_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = []
    H, Hkv, D = 32, 8, 128
    scale = D ** -0.5
    for T in K2_T:
        q = torch.randn(1, H, T, D, generator=g, device=dev).bfloat16()
        k = torch.randn(1, Hkv, T, D, generator=g, device=dev).bfloat16()
        v = torch.randn(1, Hkv, T, D, generator=g, device=dev).bfloat16()
        out, lse = fa._k2(q, k, v, scale)
        want, want_lse = fa.flash_prefill_reference(q, k, v, scale)
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
            raise RuntimeError(f"K2 T={T}: non-finite")
        d = (out.float() - want.float()).abs().max().item()
        rel = d / max(want.float().abs().max().item(), 1e-12)
        dl = (lse - want_lse).abs().max().item()
        ms = time_ms(lambda: fa._k2(q, k, v, scale), 10, flush)
        plain = time_ms(lambda: fa.flash_prefill_reference(q, k, v, scale),
                        3, flush)
        row = {"T": T, "H": H, "Hkv": Hkv, "D": D, "max_abs_err": d,
               "rel_err": rel, "lse_max_abs_err": dl, "ms": ms,
               "plain_ms": plain, "TFLOPs": 4 * H * D * T * (T + 1) / 2 / ms / 1e9}
        emit({"phase": "k2", **row})
        if not (rel < K2_TOL and dl < K2_LSE_TOL):
            raise RuntimeError(f"K2 T={T}: rel error {rel}, lse {dl}")
        rows.append(row)
    return rows


# ----------------------------------------------------------- main path ------

class ByteTokenizer:
    """Byte-level tokenizer: UTF-8 bytes are ids 0..255, the ChatML role
    words are one id each (as in Qwen's vocabulary), and Qwen3's special
    ids mark the turns. Any other id decodes as ``<id>``."""

    SPECIAL = {"<|endoftext|>": 151643, "<|im_start|>": 151644,
               "<|im_end|>": 151645, "user": 256, "assistant": 257,
               "system": 258}
    eos_token_id = 151645
    _split = re.compile("(" + "|".join(re.escape(s) for s in SPECIAL) + ")")

    def __init__(self):
        self._names = {v: k for k, v in self.SPECIAL.items()}

    def encode(self, text):
        ids = []
        for part in self._split.split(text):
            if part in self.SPECIAL:
                ids.append(self.SPECIAL[part])
            else:
                ids.extend(part.encode("utf-8"))
        return ids

    def decode(self, ids):
        out, buf = [], bytearray()
        for i in ids:
            if i < 256:
                buf.append(i)
                continue
            out.append(buf.decode("utf-8", "replace"))
            buf = bytearray()
            out.append(self._names.get(i, f"<{i}>"))
        out.append(buf.decode("utf-8", "replace"))
        return "".join(out)


def qwen3_4b():
    """Qwen3-4B (HF Qwen/Qwen3-4B config.json), the same numbers as the
    repository's bench.py."""
    from ominix_mlx_tpu_torch.models.base import TransformerConfig
    return TransformerConfig(
        vocab_size=151936, hidden_size=2560, num_layers=36, num_heads=32,
        num_kv_heads=8, head_dim=128, intermediate_size=9728,
        rope_theta=1000000.0, use_qk_norm=True, tie_word_embeddings=True,
        rms_norm_eps=1e-6)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def post(port, body) -> bytes:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise RuntimeError(f"HTTP {r.status}")
        return r.read()


def chat(port, content, stream=False):
    body = {"model": "qwen3-4b", "max_tokens": MAX_TOKENS,
            "temperature": 0.0, "stream": stream,
            "messages": [{"role": "user", "content": content}]}
    raw = post(port, body)
    if not stream:
        out = json.loads(raw)
        return (out["choices"][0]["message"]["content"],
                out["usage"]["prompt_tokens"],
                out["usage"]["completion_tokens"])
    events = [ln[6:] for ln in raw.decode().split("\n")
              if ln.startswith("data: ")]
    if not events or events[-1] != "[DONE]":
        raise RuntimeError("stream did not end with [DONE]")
    chunks = [json.loads(e) for e in events[:-1]]
    if any("error" in c for c in chunks):
        raise RuntimeError(f"stream error: {chunks}")
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    usage = chunks[-1]["usage"]
    return text, usage["prompt_tokens"], usage["completion_tokens"]


@contextlib.contextmanager
def plain_kernels():
    """Route the kernel wrappers to their plain versions (for the
    kernel-vs-plain logits check only)."""
    from ominix_mlx_tpu_torch.ops import flash_attention as fa
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    k1, k2 = qm._k1, fa._k2
    qm._k1 = lambda x, w, nw, eps, a8: qm.quantized_matmul_reference(
        x, w, nw, eps, act_bits=8 if a8 else None)
    fa._k2 = fa.flash_prefill_reference
    try:
        yield
    finally:
        qm._k1, fa._k2 = k1, k2


def serve_main_path(dev, cfg, params):
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.serving.server import ChatModel, Server

    tok = ByteTokenizer()
    model = ChatModel("qwen3-4b", params, cfg, tok, dev)
    port = free_port()
    srv = Server(port=port)
    srv.add_model("qwen3-4b", model)
    srv.start_background()
    layers = cfg.num_layers
    per_token = 4 * layers + 1
    long_prompt = ("Summarise the following notes in one line. "
                   + "The kernels stream packed weights once per token. "
                   * 4)
    requests = [("short", "Hi!", False), ("long", long_prompt, False),
                ("stream", "Tell me a story.", True),
                ("short_again", "Hi!", False)]
    results = {}
    try:
        _build.reset_launches()
        for name, content, stream in requests:
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            text, n_prompt, n_out = chat(port, content, stream)
            dt = time.perf_counter() - t0
            delta = {k: _build.LAUNCHES[k] - before.get(k, 0)
                     for k in ("k1_m1", "k1_mn", "k2")}
            row = {"phase": "request", "name": name, "stream": stream,
                   "prompt_tokens": n_prompt, "completion_tokens": n_out,
                   "seconds": dt, "launches": delta, "text": text[:80]}
            emit(row)
            if n_out <= 0 or not text:
                raise RuntimeError(f"request {name}: empty completion")
            if delta["k1_m1"] < per_token * (n_out - 1):
                raise RuntimeError(f"request {name}: K1 M=1 ran "
                                   f"{delta['k1_m1']} times for {n_out} "
                                   f"tokens")
            if delta["k2"] < 1:
                raise RuntimeError(f"request {name}: K2 never ran")
            results[name] = row
        counts = dict(_build.LAUNCHES)
    finally:
        srv.shutdown()
    if results["short"]["prompt_tokens"] > 16:
        raise RuntimeError("the short prompt does not bucket to 16")
    if results["short"]["launches"]["k1_mn"] < per_token:
        raise RuntimeError("prefill at bucket 16 did not run K1 at M=16")
    if not 128 < results["long"]["prompt_tokens"] <= 256:
        raise RuntimeError("the long prompt does not bucket to 256")
    if results["short"]["text"] != results["short_again"]["text"]:
        raise RuntimeError("greedy decode is not deterministic")
    for k in ("k1_m1", "k1_mn", "k2"):
        if counts.get(k, 0) < 1:
            raise RuntimeError(f"{k} never launched on the main path")
    emit({"phase": "serve", "launches": counts, "ok": True})
    return counts


def check_logits(dev, cfg, params):
    """Kernel path vs plain path on a 2-layer cut of the full-width model:
    a 10-token prefill (bucket 16: K1 at M=16, K2) then 3 w4a8 decode
    steps. Logits finite, of shape [1, T, 151936], rel error < 2e-2."""
    from ominix_mlx_tpu_torch.core.generate import Engine
    from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
    from ominix_mlx_tpu_torch.models import base

    c2 = dataclasses.replace(cfg, num_layers=2)
    p2 = {**params, "layers": params["layers"][:2]}
    prompt = torch.tensor(ByteTokenizer().encode("Hello there"),
                          device=dev)

    def run():
        eng = Engine(lambda p, t, c: base.forward(p, c2, t, c), p2,
                     SamplerConfig(),
                     prefill_forward_fn=lambda p, t, c: base.forward(
                         p, c2, t, c, fresh_prefill=True))
        cache = base.init_cache(c2, 1, 64, device=dev)
        with torch.inference_mode():
            logits, cache = eng.prefill(prompt[None], cache)
            out = [logits]
            for t in (1, 2, 3):
                lg, cache = base.forward(
                    p2, c2, torch.tensor([[t]], device=dev), cache)
                out.append(lg[:, -1])
        return torch.stack([o.float() for o in out])

    got = run()
    with plain_kernels():
        want = run()
    if got.shape != (4, 1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise RuntimeError(f"bad logits: {tuple(got.shape)}")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    emit({"phase": "logits", "layers": 2, "rel_err": rel})
    if not rel < LOGITS_TOL:
        raise RuntimeError(f"kernel vs plain logits rel {rel}")


def decode_rate(dev, cfg, params):
    """Decode tok/s by the difference quotient of bench.py: prompt 128,
    generate_scan of 512 vs 128 tokens, best of 2 each."""
    from ominix_mlx_tpu_torch.core.generate import Engine
    from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
    from ominix_mlx_tpu_torch.models import base

    eng = Engine(lambda p, t, c: base.forward(p, cfg, t, c), params,
                 SamplerConfig(),
                 prefill_forward_fn=lambda p, t, c: base.forward(
                     p, cfg, t, c, fresh_prefill=True))
    prompt = torch.ones(1, 128, dtype=torch.long, device=dev)

    def run(n):
        cache = base.init_cache(cfg, 1, 1024, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _ = eng.generate_scan(prompt, cache, max_tokens=n)
        toks.cpu()
        return time.perf_counter() - t0

    run(128)
    run(512)
    t_short = min(run(128) for _ in range(2))
    t_long = min(run(512) for _ in range(2))
    tps = (512 - 128) / (t_long - t_short)
    return {"phase": "decode_rate", "decode_tok_s": tps,
            "t128_s": t_short, "t512_s": t_long,
            "ms_per_token": 1e3 / tps}


def profile_decode(dev, cfg, params, steps: int = 32):
    """Where a decode token's time goes: greedy decode steps after a
    128-token prompt, first under torch.profiler (device side), then under
    cProfile (host side). The device's busy time is the union of the
    intervals of every kernel, copy and fill it ran; the idle share is one
    minus busy over the window's wall time on the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ominix_mlx_tpu_torch.models import base

    def decode(n):
        cache = base.init_cache(cfg, 1, 1024, device=dev)
        prompt = torch.ones(1, 128, dtype=torch.long, device=dev)
        with torch.inference_mode():
            _, cache = base.forward(params, cfg, prompt, cache,
                                    fresh_prefill=True)
            tok = torch.ones(1, 1, dtype=torch.long, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                logits, cache = base.forward(params, cfg, tok, cache)
                tok = logits[:, -1].argmax(-1, keepdim=True)
            tok.cpu()
            return time.perf_counter() - t0

    decode(4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = decode(steps)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler saw no device activity")
    busy_us, end = 0.0, float("-inf")
    by_name: dict = {}
    for t0, t1, name in spans:
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + t1 - t0)
    device_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]

    cprof = cProfile.Profile()
    cprof.enable()
    host_wall = decode(2 * steps)
    cprof.disable()
    st = pstats.Stats(cprof).stats
    host = sorted(st.items(), key=lambda kv: -kv[1][2])[:12]
    return {"phase": "profile", "decode_tokens": steps,
            "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_sum_ms": device_us / 1e3,
            "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
            "device_ms_per_token": busy_us / 1e3 / steps,
            "top_device": [{"name": name[:90], "calls": n, "ms": us / 1e3,
                            "share_of_busy": us / busy_us}
                           for name, (n, us) in top],
            "host_cprofile_tokens": 2 * steps,
            "host_cprofile_s": host_wall,
            "top_host_self": [{"fn": f"{os.path.basename(f)}:{ln}({fn})",
                               "calls": v[1], "self_s": v[2],
                               "cum_s": v[3]}
                              for (f, ln, fn), v in host]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the decode rate, profile decode steps on "
                         "the device (torch.profiler) and the host "
                         "(cProfile)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.strip().splitlines()[-1],
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds})

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    k1_rows = check_k1(dev, flush_buf.zero_)
    k2_rows = check_k2(dev, flush_buf.zero_)
    del flush_buf

    cfg = qwen3_4b()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = base.fuse_layer_projections(base.init_quantized_params(
        cfg, gen, GS, 4, act_bits=8, device=dev))
    torch.cuda.synchronize()
    emit({"phase": "model", "config": "Qwen3-4B", "weights": "w4a8 g64",
          "init_seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    counts = serve_main_path(dev, cfg, params)
    check_logits(dev, cfg, params)
    emit({**decode_rate(dev, cfg, params), "card": smi})
    if args.profile:
        emit({**profile_decode(dev, cfg, params), "card": smi})

    def entry(name, replaces, source, rows, pick, launches):
        rep = pick(rows)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                "timed_at": {k: rep[k] for k in rep
                             if k in ("shape", "N", "K", "M", "mode", "T")}}

    m1 = [r for r in k1_rows if r["M"] == 1]
    mn = [r for r in k1_rows if r["M"] > 1]
    kernels = [
        entry("k1_qmm_w4_m1", "ominix_mlx_tpu/ops/quant_matmul.py:719",
              "ominix_mlx_tpu_torch/csrc/qmm.cu", m1,
              lambda rs: next(r for r in rs if r["shape"] == "lm_head"
                              and r["mode"] == "a8"), counts["k1_m1"]),
        entry("k1_qmm_w4_m2_16", "ominix_mlx_tpu/ops/quant_matmul.py:1062",
              "ominix_mlx_tpu_torch/csrc/qmm.cu", mn,
              lambda rs: next(r for r in rs if r["shape"] == "gate_up_proj"
                              and r["M"] == 16), counts["k1_mn"]),
        entry("k2_flash_prefill", "ominix_mlx_tpu/ops/flash_attention.py:59",
              "ominix_mlx_tpu_torch/csrc/flash_attn.cu", k2_rows,
              lambda rs: rs[-1], counts["k2"]),
    ]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
