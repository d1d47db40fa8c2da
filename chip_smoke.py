"""Smoke run of the PyTorch port on one CUDA card: builds the kernels from
``ominix_mlx_tpu_torch/csrc``, checks each against its plain PyTorch version
at the main paths' shapes, and drives the port's main paths on full-width
Qwen3-4B with random weights (seeded):

  - serve: HTTP chat requests on w4a8 weights, one at a time (K1, K2),
    the kernel-vs-plain logits check and the batch-1 decode rate;
  - prefill_chunked: an 8192-token bf16 prefill in 2048-token chunks (K2
    then K2c), against a single-shot prefill;
  - batch_decode: w8a8 decode at batch 8 over a dense and a paged cache
    (K3), aggregate tok/s;
  - serve_batched: concurrent HTTP chat requests on a batched server (w8a8,
    paged int8 KV pool, prefix cache): chunked adoption (K2, K2c), a prefix
    hit (K2c), int8 paged decode (K3), streaming and sampling.

    python3 chip_smoke.py              # build, check, drive every path
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
# (pos, Tq) of K2c: the 8k prefill's chunks at 2048 and 6144, and ragged
K2C_SHAPES = ((2048, 2048), (6144, 2048), (128, 100), (300, 17))
K3_LENGTHS = (1, 127, 128, 129, 700, 1500, 2047, 2048)
K1_TOL = 1e-2     # max error / max |plain|: bf16 output, another sum order
K2_TOL = 1e-2     # the same for K2's and K2c's bf16 output
K2_LSE_TOL = 1e-2  # max abs error of K2's float32 row LSE (wrong scores)
# K3 vs the gathered view + masked sdpa, held per (row, head): max error
# over max |plain| of that row and head, so a long row's small output is
# not measured against a length-1 row's raw V. The plain version rounds its
# softmax weights (and int8 pages' dequantized view) to bf16: an exact
# kernel reads at most 8.0e-3 at every shape of the card tests, while one
# page or one token left out of a row reads 0.11 or more (float64 model of
# the kernel on the CPU, the same inputs)
K3_TOL = 3e-2
LOGITS_TOL = 2e-2  # rel max error of kernel vs plain logits, 2 layers
# chunked vs single-shot 8k prefill, last-token logits, bf16 through 36
# layers: read 0.0 on the H100 (K2c walks a query's key tiles in K2's
# order and cuBLAS gave the same rows at M=2048 and M=8192); the limit
# leaves room for a GEMM that sums the two M's in another order
PREFILL_TOL = 1e-2
# paged (K3) vs dense (sdpa) first decode step, bf16 through 36 layers
PAGED_TOL = 5e-2
PREFILL_LEN, PREFILL_CHUNK = 8192, 2048
BATCH = 8


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def row_rel_err(got, want) -> float:
    """max over rows (every index but the last) of max |got - want| over
    max |want| in that row."""
    g, w = got.float(), want.float()
    return ((g - w).abs().amax(-1)
            / w.abs().amax(-1).clamp_min(1e-12)).max().item()


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


def check_k2c(dev, flush):
    """K2c against flash_chunk_reference: chunk queries at pos..pos+Tq-1
    over the [:pos+Tq] prefix of a capacity-sized cache, read in place."""
    from ominix_mlx_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = []
    H, Hkv, D = 32, 8, 128
    scale = D ** -0.5
    cap = PREFILL_LEN + 64
    kc = torch.randn(1, Hkv, cap, D, generator=g, device=dev).bfloat16()
    vc = torch.randn(1, Hkv, cap, D, generator=g, device=dev).bfloat16()
    for pos, T in K2C_SHAPES:
        q = torch.randn(1, H, T, D, generator=g, device=dev).bfloat16()
        k, v = kc[:, :, :pos + T], vc[:, :, :pos + T]
        out, lse = fa._k2c(q, k, v, pos, scale)
        want, want_lse = fa.flash_chunk_reference(q, k, v, pos, scale)
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
            raise RuntimeError(f"K2c pos={pos} T={T}: non-finite")
        d = (out.float() - want.float()).abs().max().item()
        rel = d / max(want.float().abs().max().item(), 1e-12)
        dl = (lse - want_lse).abs().max().item()
        del want, want_lse
        ms = time_ms(lambda: fa._k2c(q, k, v, pos, scale), 10, flush)
        plain = time_ms(lambda: fa.flash_chunk_reference(q, k, v, pos, scale),
                        3, flush)
        flop = 4 * H * D * T * (pos + (T + 1) / 2)   # unmasked (q, k) pairs
        row = {"pos": pos, "T": T, "H": H, "Hkv": Hkv, "D": D,
               "max_abs_err": d, "rel_err": rel, "lse_max_abs_err": dl,
               "ms": ms, "plain_ms": plain, "us": ms * 1e3,
               "plain_us": plain * 1e3, "TFLOPs": flop / ms / 1e9}
        emit({"phase": "k2c", **row})
        if not (rel < K2_TOL and dl < K2_LSE_TOL):
            raise RuntimeError(f"K2c pos={pos} T={T}: rel error {rel}, "
                               f"lse {dl}")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def check_k3(dev, flush):
    """K3 against paged_decode_reference at B=8, H=32, Hkv=8, D=128, page
    128, 16 pages per row, shuffled tables, ragged lengths: bf16 pages,
    int8 pages, and a 512-token window."""
    from ominix_mlx_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    B, H, Hkv, D, ps, MP = BATCH, 32, 8, 128, 128, 16
    P = B * MP + 1
    lens = torch.tensor(K3_LENGTHS, dtype=torch.int32, device=dev)
    table = (torch.randperm(P - 1, generator=g, device=dev) + 1).reshape(
        B, MP).to(torch.int32)
    q = torch.randn(B, H, D, generator=g, device=dev).bfloat16()
    kb = torch.randn(P, Hkv, ps, D, generator=g, device=dev).bfloat16()
    vb = torch.randn(P, Hkv, ps, D, generator=g, device=dev).bfloat16()
    kq = torch.randint(-127, 128, (P, Hkv, ps, D), generator=g, device=dev,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (P, Hkv, ps, D), generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(P, Hkv, ps, generator=g, device=dev) / 64 + 1e-3
    vs = torch.rand(P, Hkv, ps, generator=g, device=dev) / 64 + 1e-3
    rows = []
    for mode, window, pools in (("bf16", 0, (kb, vb, None, None)),
                                ("int8", 0, (kq, vq, ks, vs)),
                                ("bf16", 512, (kb, vb, None, None))):
        kp, vp, kscale, vscale = pools
        args = (q, kp, vp, table, lens, D ** -0.5, window, kscale, vscale)
        got = pa._k3(*args)
        want = pa.paged_decode_reference(
            q, kp, vp, table, lens, D ** -0.5, window=window,
            k_scale=kscale, v_scale=vscale)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"K3 {mode} window={window}: non-finite")
        d = (got.float() - want.float()).abs().max().item()
        rel = d / max(want.float().abs().max().item(), 1e-12)
        row_rel = row_rel_err(got, want)
        ms = time_ms(lambda: pa._k3(*args), 20, flush)
        plain = time_ms(lambda: pa.paged_decode_reference(
            q, kp, vp, table, lens, D ** -0.5, window=window, k_scale=kscale,
            v_scale=vscale), 5, flush)
        toks = sum(min(n, window) if window else n for n in K3_LENGTHS)
        per_tok = 2 * Hkv * D * kp.element_size() + (
            2 * Hkv * 4 if kscale is not None else 0)
        row = {"mode": mode, "window": window, "B": B, "H": H, "Hkv": Hkv,
               "D": D, "page": ps, "max_abs_err": d, "rel_err": rel,
               "row_rel_err": row_rel, "ms": ms, "plain_ms": plain, "us": ms * 1e3,
               "plain_us": plain * 1e3,
               "kv_GBps": toks * per_tok / ms / 1e6}
        emit({"phase": "k3", **row})
        if not row_rel < K3_TOL:
            raise RuntimeError(f"K3 {mode} window={window}: error {row_rel} "
                               f"of a (row, head)'s max |plain|")
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


def chat(port, content, stream=False, model="qwen3-4b", system=None,
         **kw):
    messages = [{"role": "user", "content": content}]
    if system is not None:
        messages.insert(0, {"role": "system", "content": system})
    body = {"model": model, "max_tokens": MAX_TOKENS, "temperature": 0.0,
            "stream": stream, "messages": messages, **kw}
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


def engine_for(cfg, params):
    """The Engine a user drives: fresh prefill (K2), continuation chunks
    (K2c) and their logits-free form for non-final chunks."""
    from ominix_mlx_tpu_torch.core.generate import Engine
    from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
    from ominix_mlx_tpu_torch.models import base

    return Engine(
        lambda p, t, c: base.forward(p, cfg, t, c), params, SamplerConfig(),
        prefill_forward_fn=lambda p, t, c: base.forward(
            p, cfg, t, c, fresh_prefill=True),
        chunk_forward_fn=lambda p, t, c, kl: base.forward(
            p, cfg, t, c, kv_limit=kl),
        chunk_hidden_forward_fn=lambda p, t, c, kl: base.forward(
            p, cfg, t, c, kv_limit=kl, skip_logits=True))


def prefill_chunked_path(dev, cfg, params):
    """bf16 Qwen3-4B, an 8192-token prompt prefilled in 2048-token chunks
    as bench.py's prefill cell does (chunk 0 through K2, chunks 1-3
    through K2c): launch counts, tok/s (best of 2 after a first run), and
    the last-token logits against a single-shot K2 prefill."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.ops import _build

    eng = engine_for(cfg, params)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    prompt = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), generator=g,
                           device=dev)

    def run(chunked=True):
        cache = base.init_cache(cfg, 1, PREFILL_LEN + 64, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if chunked:
            last, cache = eng.prefill_chunked(prompt, cache,
                                              chunk_size=PREFILL_CHUNK)
        else:
            last, cache = eng.prefill(prompt, cache)
        torch.cuda.synchronize()
        return last.float(), time.perf_counter() - t0, cache.offset

    _build.reset_launches()
    got, t_first, offset = run()
    launches = dict(_build.LAUNCHES)
    n_chunks = PREFILL_LEN // PREFILL_CHUNK
    want_k2 = cfg.num_layers
    want_k2c = cfg.num_layers * (n_chunks - 1)
    if launches.get("k2") != want_k2 or launches.get("k2c") != want_k2c:
        raise RuntimeError(f"chunked prefill launched {launches}, want K2 "
                           f"{want_k2} and K2c {want_k2c}")
    seconds = min(run()[1] for _ in range(2))
    want, t_single, _ = run(chunked=False)
    if got.shape != (1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise RuntimeError(f"bad chunked logits {tuple(got.shape)}")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    row = {"phase": "prefill_chunked", "prompt": PREFILL_LEN,
           "chunk": PREFILL_CHUNK, "offset": offset, "launches": launches,
           "tok_s": PREFILL_LEN / seconds, "seconds": seconds,
           "first_run_seconds": t_first, "single_shot_seconds": t_single,
           "rel_err_vs_single_shot": rel,
           "argmax_equal": int(got.argmax()) == int(want.argmax())}
    emit(row)
    if offset != PREFILL_LEN or not rel < PREFILL_TOL \
            or not row["argmax_equal"]:
        raise RuntimeError(f"chunked vs single-shot prefill: {row}")
    return launches


def batch_decode(dev, cfg, params, short=64, long=256):
    """w8a8 Qwen3-4B decode at batch 8 after a 128-token prompt, aggregate
    tok/s by bench.py's difference quotient (generate_scan of `long` vs
    `short` tokens, best of 2), over a dense cache and over
    init_paged_cache (K3); then the first decode step's logits, paged vs
    dense, and how many greedy tokens the two runs share."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.ops import _build

    eng = engine_for(cfg, params)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, 128), generator=g,
                           device=dev)

    def cache_for(paged):
        if paged:
            return base.init_paged_cache(cfg, BATCH, 1024, device=dev)
        return base.init_cache(cfg, BATCH, 1024, device=dev)

    def run(n, paged):
        cache = cache_for(paged)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _ = eng.generate_scan(prompt, cache, max_tokens=n)
        toks = toks.cpu()
        return time.perf_counter() - t0, toks

    out, launches, toks = {}, {}, {}
    for paged in (False, True):
        name = "paged" if paged else "dense"
        _build.reset_launches()
        run(short, paged)
        launches[name] = dict(_build.LAUNCHES)
        t_short = min(run(short, paged)[0] for _ in range(2))
        longs = [run(long, paged) for _ in range(2)]
        t_long = min(t for t, _ in longs)
        toks[name] = longs[0][1]
        out[name] = {"tok_s": BATCH * (long - short) / (t_long - t_short),
                     f"t{short}_s": t_short, f"t{long}_s": t_long}
    if launches["paged"].get("k3", 0) < cfg.num_layers * short:
        raise RuntimeError(f"paged decode launched {launches['paged']}")
    if launches["dense"].get("k3", 0):
        raise RuntimeError("dense decode launched K3")

    def first_step(paged):
        cache = cache_for(paged)
        with torch.inference_mode():
            logits, cache = eng.prefill(prompt, cache)
            tok = logits.argmax(-1, keepdim=True)
            step, _ = base.forward(params, cfg, tok, cache)
        return step[:, -1].float()

    dense, paged = first_step(False), first_step(True)
    if dense.shape != (BATCH, cfg.vocab_size) \
            or not torch.isfinite(paged).all():
        raise RuntimeError(f"bad decode logits {tuple(paged.shape)}")
    rel = ((paged - dense).abs().max() / dense.abs().max()).item()
    same = int((toks["paged"] == toks["dense"]).sum())
    emit({"phase": "batch_decode", "weights": "w8a8 channel8", "batch": BATCH,
          "prompt": 128, **{f"{k}_{m}": v for k, d in out.items()
                            for m, v in d.items()},
          "launches": launches, "first_step_rel_err_paged_vs_dense": rel,
          "greedy_tokens_equal": same, "greedy_tokens": toks["dense"].numel()})
    if not rel < PAGED_TOL:
        raise RuntimeError(f"paged vs dense decode logits rel {rel}")
    return launches["paged"]


def serve_batched(dev, cfg, params):
    """A batched server (8 slots, paged int8 KV pool, prefix cache, w8a8
    weights quantized from the bf16 ones by enable_batching) answering 8
    concurrent HTTP chat requests: one longer than 2048 tokens (chunked
    adoption: K2 then K2c), two sharing a 300-token system prompt (a
    prefix hit: the suffix through K2c), one streaming, one sampled.

    Pass 1 sends them together and counts launches. Pass 2 sends each
    greedy request alone. Pass 3 sends all together again. Every prompt
    was adopted once in pass 1, so passes 2 and 3 take the same prefix-hit
    path for each request, and each greedy text of pass 3 must equal its
    text alone (rows are independent: the int8 products are exact and K3
    works per row); the sampled text must repeat pass 1's. Pass 1's first
    sight of a prompt attends its unquantized K/V while later passes read
    its prefix from int8 pages, so pass 1 vs pass 2 is reported, not held,
    with one exception: after the prefix cache is emptied, the long
    request alone adopts by chunks (K2, K2c) again, as in pass 1, and its
    pass-1 text must equal that solo text."""
    import threading

    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.serving.server import ChatModel, Server

    name = "qwen3-4b-batched"
    srv = Server(port=free_port())
    srv.add_model(name, ChatModel(name, params, cfg, ByteTokenizer(), dev))
    srv.enable_batching(name, slots=BATCH, max_len=4096, paged=True,
                        quantize_bits=8, kv_bits=8, prefix_cache=True)
    srv.start_background()
    port = srv.port
    system = "You are a careful assistant who answers briefly. " * 6
    notes = ("Notes: the kernels stream packed weights once per token, "
             "and the pool holds int8 pages. ") * 30 + "Summarise."
    reqs = {"sys_a": ("Name three colours.", {"system": system}),
            "sys_b": ("Count to five.", {"system": system}),
            "long": (notes, {}),
            "stream": ("Tell me a story.", {"stream": True}),
            "sampled": ("Pick a number.", {"temperature": 0.7, "seed": 1234}),
            "short1": ("Hi!", {}),
            "short2": ("What is 2+2?", {}),
            "short3": ("Say hello in French.", {})}
    greedy = [k for k in reqs if k != "sampled"]

    def send(keys):
        res, errs = {}, []

        def one(k):
            try:
                t0 = time.perf_counter()
                content, kw = reqs[k]
                text, n_prompt, n_out = chat(port, content, model=name, **kw)
                res[k] = (text, n_prompt, n_out, time.perf_counter() - t0)
            except Exception as e:       # raised below
                errs.append((k, e))

        threads = [threading.Thread(target=one, args=(k,)) for k in keys]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if errs or len(res) != len(keys):
            raise RuntimeError(f"batched requests failed: {errs}")
        return res

    try:
        runner = srv.batchers[name]
        _build.reset_launches()
        t0 = time.perf_counter()
        first = send(list(reqs))
        wall1 = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        hits = runner.batcher.prefix.hits
        alone = {}
        for k in greedy:
            alone.update(send([k]))
        t0 = time.perf_counter()
        third = send(list(reqs))
        wall3 = time.perf_counter() - t0
        pfx = runner.batcher.prefix
        with runner.lock:
            pfx.evict(runner.batcher.alloc, max_evict=len(pfx.entries))
            left = len(pfx.entries)
        misses = pfx.misses
        long_fresh = send(["long"])["long"]
        if left or pfx.misses != misses + 1:
            raise RuntimeError(f"the prefix cache kept {left} pages, or the "
                               f"long request hit it")
    finally:
        srv.shutdown()
    for k, (text, n_prompt, n_out, sec) in first.items():
        emit({"phase": "request_batched", "name": k, "prompt_tokens": n_prompt,
              "completion_tokens": n_out, "seconds": sec, "text": text[:60]})
        if n_out <= 0 or not text:
            raise RuntimeError(f"batched request {k}: empty completion")
    same_alone = {k: third[k][0] == alone[k][0] for k in greedy}
    first_vs_alone = {k: first[k][0] == alone[k][0] for k in greedy}
    row = {"phase": "serve_batched", "launches": launches,
           "prefix_hits_pass1": hits,
           "long_prompt_tokens": first["long"][1],
           "pass1_seconds": wall1, "pass3_seconds": wall3,
           "pass1_completion_tokens": sum(r[2] for r in first.values()),
           "greedy_equal_alone": same_alone,
           "pass1_equal_alone": first_vs_alone,
           "long_pass1_equal_fresh_alone": first["long"][0] == long_fresh[0],
           "sampled_repeats": third["sampled"][0] == first["sampled"][0]}
    emit(row)
    if first["long"][1] <= PREFILL_CHUNK or hits < 1:
        raise RuntimeError(f"no chunked adoption or prefix hit: {row}")
    for k in ("k2", "k2c", "k3", "k3_int8"):
        if launches.get(k, 0) < 1:
            raise RuntimeError(f"{k} never launched on the batched path")
    if not all(same_alone.values()) or not row["sampled_repeats"] \
            or not row["long_pass1_equal_fresh_alone"]:
        raise RuntimeError(f"batched answers differ from solo: {row}")
    return launches


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


def profile_decode(dev, cfg, params, steps: int = 32, batch: int = 1,
                   paged: bool = False):
    """Where a decode step's time goes: greedy decode steps of ``batch``
    rows (over a dense or a paged cache) after a 128-token prompt, first
    under torch.profiler (device side), then under cProfile (host side).
    The device's busy time is the union of the intervals of every kernel,
    copy and fill it ran; the idle share is one minus busy over the
    window's wall time on the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ominix_mlx_tpu_torch.models import base

    def decode(n):
        cache = (base.init_paged_cache if paged else base.init_cache)(
            cfg, batch, 1024, device=dev)
        prompt = torch.ones(batch, 128, dtype=torch.long, device=dev)
        with torch.inference_mode():
            _, cache = base.forward(params, cfg, prompt, cache,
                                    fresh_prefill=True)
            tok = torch.ones(batch, 1, dtype=torch.long, device=dev)
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
    return {"phase": "profile", "batch": batch, "paged": paged,
            "decode_steps": steps,
            "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_sum_ms": device_us / 1e3,
            "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
            "device_ms_per_step": busy_us / 1e3 / steps,
            "top_device": [{"name": name[:90], "calls": n, "ms": us / 1e3,
                            "share_of_busy": us / busy_us}
                           for name, (n, us) in top],
            "host_cprofile_steps": 2 * steps,
            "host_cprofile_s": host_wall,
            "top_host_self": [{"fn": f"{os.path.basename(f)}:{ln}({fn})",
                               "calls": v[1], "self_s": v[2],
                               "cum_s": v[3]}
                              for (f, ln, fn), v in host]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile decode steps on the device "
                         "(torch.profiler) and the host (cProfile): batch 1 "
                         "w4a8, and batch 8 w8a8 over a paged cache")
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
    k2c_rows = check_k2c(dev, flush_buf.zero_)
    k3_rows = check_k3(dev, flush_buf.zero_)
    del flush_buf
    torch.cuda.empty_cache()

    cfg = qwen3_4b()
    phases = {}        # main-path phase -> kernel launches in that run
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = base.fuse_layer_projections(base.init_quantized_params(
        cfg, gen, GS, 4, act_bits=8, device=dev))
    torch.cuda.synchronize()
    emit({"phase": "model", "config": "Qwen3-4B", "weights": "w4a8 g64",
          "init_seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    phases["serve"] = serve_main_path(dev, cfg, params)
    check_logits(dev, cfg, params)
    emit({**decode_rate(dev, cfg, params), "card": smi})
    if args.profile:
        emit({**profile_decode(dev, cfg, params), "card": smi})
    del params
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    params = base.fuse_layer_projections(base.init_quantized_params(
        cfg, gen, device=dev, scheme="channel8"))
    phases["batch_decode"] = batch_decode(dev, cfg, params)
    if args.profile:
        emit({**profile_decode(dev, cfg, params, batch=BATCH, paged=True),
              "weights": "w8a8 channel8", "card": smi})
    del params
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    params = base.fuse_layer_projections(base.init_params(
        cfg, gen, torch.bfloat16, device=dev))
    emit({"phase": "model", "config": "Qwen3-4B", "weights": "bf16",
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    phases["prefill_chunked"] = prefill_chunked_path(dev, cfg, params)
    torch.cuda.empty_cache()
    phases["serve_batched"] = serve_batched(dev, cfg, params)
    del params
    torch.cuda.empty_cache()

    def launches(key):
        return sum(c.get(key, 0) for c in phases.values())

    def entry(name, replaces, source, rows, pick, key):
        rep = pick(rows)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches(key),
                "launches_by_phase": {p: c.get(key, 0)
                                      for p, c in phases.items()},
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                "timed_at": {k: rep[k] for k in rep
                             if k in ("shape", "N", "K", "M", "mode", "T",
                                      "pos", "window")}}

    m1 = [r for r in k1_rows if r["M"] == 1]
    mn = [r for r in k1_rows if r["M"] > 1]
    kernels = [
        entry("k1_qmm_w4_m1", "ominix_mlx_tpu/ops/quant_matmul.py:719",
              "ominix_mlx_tpu_torch/csrc/qmm.cu", m1,
              lambda rs: next(r for r in rs if r["shape"] == "lm_head"
                              and r["mode"] == "a8"), "k1_m1"),
        entry("k1_qmm_w4_m2_16", "ominix_mlx_tpu/ops/quant_matmul.py:1062",
              "ominix_mlx_tpu_torch/csrc/qmm.cu", mn,
              lambda rs: next(r for r in rs if r["shape"] == "gate_up_proj"
                              and r["M"] == 16), "k1_mn"),
        entry("k2_flash_prefill", "ominix_mlx_tpu/ops/flash_attention.py:59",
              "ominix_mlx_tpu_torch/csrc/flash_attn.cu", k2_rows,
              lambda rs: rs[-1], "k2"),
        entry("k2c_flash_chunk", "ominix_mlx_tpu/ops/flash_attention.py:116",
              "ominix_mlx_tpu_torch/csrc/flash_attn.cu", k2c_rows,
              lambda rs: next(r for r in rs if r["pos"] == 6144), "k2c"),
        entry("k3_paged_decode", "ominix_mlx_tpu/ops/paged_attention.py:73",
              "ominix_mlx_tpu_torch/csrc/paged_attn.cu", k3_rows,
              lambda rs: rs[0], "k3"),
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise RuntimeError(f"{k['name']} never launched on a main path")
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
