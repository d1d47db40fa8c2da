"""OpenAI-compatible HTTP server (counterpart of
ominix_mlx_tpu/serving/server.py):

  POST /v1/chat/completions      (stream=true -> SSE; content arrays with
                                  an image go to a VLM; tools)
  POST /v1/describe              (image description by a VLM)
  POST /v1/ocr                   (an image or a PDF through the OCR model)
  POST /v1/audio/transcriptions  (raw WAV bytes -> {"text"}: the first
                                  model that can transcribe)
  POST /v1/audio/translations    (raw WAV bytes -> English {"text"}: the
                                  first model that can translate)
  POST /v1/audio/speech          ({"input", "voice"?, "ref_audio"?} ->
                                  WAV bytes: the first model that can
                                  synthesize)
  GET  /v1/models
  GET  /v1/models/local          (the local model directory)
  DELETE /v1/models/<name>       (delete one from it)
  GET  /health
  GET  /metrics                  (Prometheus text, counters)

``Server.load_model(name, dir)`` loads a checkpoint directory through
``models.registry``: a chat family with the directory's
``utils.tokenizer.Tokenizer``, a Moxin VLM, a DeepSeek-OCR-2 pipeline, an
ASR pipeline (Paraformer, Qwen3-ASR, Fun-ASR-Nano) or a TTS pipeline
(Qwen3-TTS) as its module builds it; ``add_model`` registers a model
built in memory.
``main()`` is the command line:

    python -m ominix_mlx_tpu_torch.serving.server --model name=DIR

HTTP threads hand each request to ONE inference thread
(``InferenceWorker``); an Engine is cached per sampler configuration.
``Server.enable_batching`` turns on continuous batching for a model: its
chat requests (greedy and sampled) then go to a ``BatchedChatRunner``,
whose own thread steps a shared slot decode over a dense or paged KV
cache, with its own caches (the two threads never share a cache).
``Server.enable_speculative`` sends a model's greedy chat through a
``core.speculative.SpeculativeEngine`` (a draft checkpoint, or the model's
own first layers), and ``enable_batching`` with a draft makes its batcher
speculative (greedy requests; sampled ones take the engine path). A
request's ``tools`` are folded into its system turn and the completion's
``<tool_call>`` spans come back as OpenAI ``tool_calls``
(``utils.tools``). Every image and audio request (VLM chat,
/v1/describe, /v1/ocr, /v1/audio/*) runs its card work on the inference
thread, as unbatched chat does, so no encoder launches from an HTTP
thread, and a TTS model's captured frame step replays on that thread.
The image-generation route is not ported yet and answers 404;
/v1/models/download needs the network and answers 501.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import inspect
import io
import json
import queue
import sys
import threading
import time
import traceback
import urllib.parse
import uuid
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from ominix_mlx_tpu_torch import __version__
from ominix_mlx_tpu_torch.core.generate import Engine
from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
from ominix_mlx_tpu_torch.core.speculative import SpeculativeEngine
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.ops.quant_matmul import (DECODE_M_MAX,
                                                   PackedQuantizedTensor,
                                                   route)
from ominix_mlx_tpu_torch.serving.batching import (ContinuousBatcher,
                                                   PagedContinuousBatcher)
from ominix_mlx_tpu_torch.utils import hub
from ominix_mlx_tpu_torch.utils.tokenizer import chatml
from ominix_mlx_tpu_torch.utils.tools import (finalize_tool_response,
                                              inject_tools)

DEFAULT_MAX_TOKENS = 512


class _StopStrings:
    """OpenAI ``stop`` strings (copied from ominix_mlx_tpu/serving/
    server.py:38): generation halts when any appears and the stop text
    never reaches the client. Streaming holds back any tail that is a
    proper prefix of a stop string until it completes or diverges."""

    def __init__(self, stops):
        if isinstance(stops, str):
            stops = [stops]
        self.stops = [s for s in (stops or []) if s]

    def __bool__(self):
        return bool(self.stops)

    def cut(self, text: str):
        """(safe_len, matched): text[:safe_len] is safe to emit now."""
        for s in self.stops:
            i = text.find(s)
            if i >= 0:
                return i, True
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(text)), 0, -1):
                if text.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        return len(text) - hold, False


class ChatModel:
    """A chat model held in memory: params, config and tokenizer on one
    device. ``tokenizer`` needs ``encode``, ``decode`` and
    ``eos_token_id``; ``apply_chat_template`` is used when present, ChatML
    otherwise."""

    MAX_ENGINES = 8

    def __init__(self, name: str, params, cfg, tokenizer, device,
                 module=base, kv_dtype=torch.bfloat16):
        self.name = name
        self.dir = None
        self.params, self.cfg, self.tokenizer = params, cfg, tokenizer
        self.device = torch.device(device)
        self.module = module
        self.kv_dtype = kv_dtype
        self._engines: dict = {}

    def engine(self, sampler: SamplerConfig) -> Engine:
        """The Engine of ``sampler``, with the module's fresh prefill (K2)
        and, where its ``forward`` takes ``kv_limit``, its continuation
        chunks (K2c) and their logits-free form, as the JAX package's
        ``LoadedModel.engine`` wires them."""
        eng = self._engines.get(sampler)
        if eng is None:
            if len(self._engines) >= self.MAX_ENGINES:
                self._engines.pop(next(iter(self._engines)))
            mod, cfg = self.module, self.cfg
            takes = inspect.signature(mod.forward).parameters
            kw = {}
            if "fresh_prefill" in takes:
                kw["prefill_forward_fn"] = lambda p, t, c: mod.forward(
                    p, cfg, t, c, fresh_prefill=True)
            if "kv_limit" in takes:
                kw["chunk_forward_fn"] = lambda p, t, c, kl: mod.forward(
                    p, cfg, t, c, kv_limit=kl)
                if "skip_logits" in takes:
                    kw["chunk_hidden_forward_fn"] = \
                        lambda p, t, c, kl: mod.forward(
                            p, cfg, t, c, kv_limit=kl, skip_logits=True)
            eng = Engine(lambda p, t, c: mod.forward(p, cfg, t, c),
                         self.params, sampler, **kw)
            self._engines[sampler] = eng
        return eng

    def init_cache(self, max_len: int):
        return self.module.init_cache(self.cfg, 1, max_len, self.kv_dtype,
                                      self.device)


def draft_for(model: ChatModel, draft_dir=None, draft_layers=None,
              dtype=torch.bfloat16):
    """A speculative draft for ``model`` (the JAX package's
    ``enable_speculative`` / ``BatchedChatRunner`` rule): the checkpoint at
    ``draft_dir`` on the model's device, or a self-draft of the model's
    first ``draft_layers`` layers (default num_layers // 4, at least 1) on
    the same weights: a family whose ``forward`` takes ``num_layers``
    (MiniCPM-SALA) runs its own prefix, any other runs a config with
    ``num_layers=n`` over the first n layers' params. Returns (forward,
    params, init_cache(batch, max_len) -> ModelCache)."""
    dev = model.device
    if draft_dir is not None:
        from ominix_mlx_tpu_torch.models import registry
        dmod, dparams, dcfg = registry.load_model(draft_dir, device=dev)
        return (lambda p, t, c: dmod.forward(p, dcfg, t, c), dparams,
                lambda b, ml: dmod.init_cache(dcfg, b, ml, dtype, dev))
    mod, cfg = model.module, model.cfg
    n = draft_layers or max(1, cfg.num_layers // 4)
    if "num_layers" in inspect.signature(mod.forward).parameters:
        return (lambda p, t, c: mod.forward(p, cfg, t, c, num_layers=n),
                model.params,
                lambda b, ml: mod.init_cache(cfg, b, ml, dtype, dev))
    dcfg = dataclasses.replace(cfg, num_layers=n)
    dparams = dict(model.params)
    dparams["layers"] = model.params["layers"][:n]
    return (lambda p, t, c: mod.forward(p, dcfg, t, c), dparams,
            lambda b, ml: mod.init_cache(dcfg, b, ml, dtype, dev))


def dense_route_weights(params, rows: int) -> int:
    """How many of ``params``' packed quantized weights take the dense
    route (dequantized whole, then cuBLAS) at ``rows`` rows a call and a
    kernel at DECODE_M_MAX rows: those that ``rows`` pushes past the
    quantized-matmul kernels."""
    if isinstance(params, PackedQuantizedTensor):
        return int(rows > DECODE_M_MAX and route(params, rows) == "dense"
                   and route(params, DECODE_M_MAX) != "dense")
    if isinstance(params, dict):
        params = params.values()
    elif not isinstance(params, (list, tuple)):
        return 0
    return sum(dense_route_weights(v, rows) for v in params)


class BatchedChatRunner:
    """Cross-request continuous batching for chat (serving/batching.py):
    HTTP threads submit token lists, ONE dedicated thread steps the shared
    slot decode, and tokens stream back through per-request queues. Greedy
    and sampled requests share the one step (per-slot sampler settings are
    tensors).

    quantize_bits=8 serves channelwise w8a8 (``scheme="channel8"``),
    a MoE model's experts as ``ChannelQuantizedExperts`` (K8 at decode,
    the exact all-expert pass at adoption);
    quantize_bits=4 serves group w4 marked ``batched`` with act_bits=8, as
    the JAX package does: the batch decode takes the dq formula (K1 at
    2 <= M <= 16), adoption prefills up to 64 tokens K7, a lone row K6's
    w4a8, and a MoE model's experts K4's w4a8. Both quantize a copy of the
    model's weights, as the JAX package's ``consume=False`` does.
    kv_bits=8 stores the paged pool as int8 pages. ``draft_dir`` or
    ``draft_layers`` makes the batcher speculative (``draft_for``), with
    ``num_draft_tokens`` a round. Its verify runs slots x (drafts + 1)
    rows in one target forward: past DECODE_M_MAX (16) rows a packed
    (group-quantized) weight takes the dense route, dequantized whole in
    every round, which the round's graph pool holds (5634 MiB for
    Qwen3-4B w4a8 at 8 slots and 4 drafts, on an H100), and whose bf16
    products differ from a one-row step's, so answers can leave plain
    greedy decoding's; the runner warns then. Channel w8a8
    (``quantize_bits=8``) stays exact at any row count."""

    def __init__(self, model, slots: int = 4, max_len: int = 2048,
                 dtype=torch.bfloat16, paged: bool = False,
                 num_pages=None, page_size: int = 128,
                 quantize_bits=None, kv_bits=None,
                 prefix_cache: bool = False, draft_dir=None,
                 draft_layers=None, num_draft_tokens: int = 4):
        if quantize_bits not in (None, 4, 8) or kv_bits not in (None, 8):
            raise ValueError(f"quantize_bits {quantize_bits!r} (None, 4 or "
                             f"8), kv_bits {kv_bits!r} (None or 8)")
        self.lock = threading.Lock()
        self.wake = threading.Event()
        self._stop = threading.Event()
        params = model.params
        if quantize_bits:
            params = base.quantize_params(
                dict(model.params), bits=quantize_bits, batched=True,
                scheme="channel8" if quantize_bits == 8 else "group")
        mod, cfg = model.module, model.cfg
        fwd = lambda p, t, c: mod.forward(p, cfg, t, c)
        # adoption prefills are always fresh (K2); long prompts adopt by
        # chunks and prefix hits prefill their suffix through kv_limit (K2c)
        pfwd = lambda p, t, c: mod.forward(p, cfg, t, c, fresh_prefill=True)
        cfwd = lambda p, t, c, kl: mod.forward(p, cfg, t, c, kv_limit=kl)
        hfwd = lambda p, t, c, kl: mod.forward(p, cfg, t, c, kv_limit=kl,
                                               skip_logits=True)
        spec_kw = {}
        if draft_dir is not None or draft_layers is not None:
            # drafts verify across all slots in one [slots, nd + 1] target
            # forward (greedy requests only)
            dfwd, dparams, dinit = draft_for(model, draft_dir, draft_layers,
                                             dtype)
            spec_kw = dict(draft_forward_fn=dfwd, draft_params=dparams,
                           draft_init_cache_fn=dinit,
                           num_draft_tokens=num_draft_tokens)
            rows = slots * (num_draft_tokens + 1)
            n_dense = dense_route_weights(params, rows)
            if n_dense:
                warnings.warn(
                    f"speculative batching verifies {rows} rows ({slots} "
                    f"slots x {num_draft_tokens + 1}), past the "
                    f"{DECODE_M_MAX} rows of the quantized-matmul kernels: "
                    f"{n_dense} packed weights take the dense route, "
                    "dequantized whole every round (the round's graph "
                    "pool holds them), and answers can leave plain greedy "
                    "decoding's. Keep slots x (drafts + 1) <= "
                    f"{DECODE_M_MAX}, or serve channel w8a8 "
                    "(quantize_bits=8).", stacklevel=2)
        if paged or kv_bits or prefix_cache:
            self.batcher = PagedContinuousBatcher(
                fwd, params, cfg, slots=slots, max_len=max_len,
                num_pages=num_pages, page_size=page_size, dtype=dtype,
                prefill_forward_fn=pfwd, quantize_kv=kv_bits == 8,
                prefix_cache=prefix_cache, chunk_forward_fn=cfwd,
                chunk_hidden_forward_fn=hfwd, device=model.device,
                **spec_kw)
        else:
            self.batcher = ContinuousBatcher(
                fwd, params, cfg,
                lambda c, b, ml: mod.init_cache(c, b, ml, dtype,
                                                model.device),
                slots=slots, max_len=max_len, prefill_forward_fn=pfwd,
                chunk_forward_fn=cfwd, chunk_hidden_forward_fn=hfwd,
                **spec_kw)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit(self, tokens, max_tokens: int, stop_tokens=(),
               sampler=None, seed: int = 0):
        rid = uuid.uuid4().hex
        q: "queue.Queue" = queue.Queue()
        with self.lock:
            self.batcher.submit(rid, tokens, max_tokens,
                                stop_tokens=stop_tokens, emit=q.put,
                                sampler=sampler, seed=seed)
        self.wake.set()
        return rid, q

    def cancel(self, rid):
        with self.lock:
            self.batcher.cancel(rid)

    def _run(self):
        while not self._stop.is_set():
            with self.lock:
                busy = self.batcher.pending()
            if not busy:
                self.wake.wait(timeout=0.1)
                self.wake.clear()
                continue
            try:
                with self.lock:
                    self.batcher.step()
            except Exception as e:
                # a step error must not kill the stepping thread (every
                # in-flight and future request would hang): fail the
                # affected requests, so their HTTP threads answer 500
                traceback.print_exc(file=sys.stderr)
                with self.lock:
                    try:
                        self.batcher.abort_all(
                            f"batch step failed: {type(e).__name__}: {e}")
                    except Exception:
                        traceback.print_exc(file=sys.stderr)

    def stop(self, timeout: float = 10.0):
        """End the stepping thread; queued and in-flight requests end, and
        the batcher's captured graphs and their pool are freed."""
        self._stop.set()
        self.wake.set()
        self.thread.join(timeout)
        with self.lock:
            self.batcher.abort_all("the server is shutting down")
            self.batcher.close()


class InferenceWorker:
    """The one thread that runs inference for unbatched models."""

    def __init__(self):
        self.q: "queue.Queue" = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while True:
            job = self.q.get()
            if job is None:
                return
            fn, done = job
            try:
                fn()
            except Exception as e:  # surfaced through the job's channel
                done(e)

    def submit(self, fn, done):
        self.q.put((fn, done))

    def stop(self, timeout: float = 10.0):
        self.q.put(None)
        self.thread.join(timeout)


def _decode_image(raw: bytes):
    """PNG / JPEG bytes -> an [H, W, 3] float32 array in [0, 1]."""
    import numpy as np
    from PIL import Image

    img = Image.open(io.BytesIO(raw)).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


class Server:
    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 request_timeout_s: float = 600.0, models_root=None):
        """``models_root``: the local model directory of /v1/models/local
        and DELETE /v1/models/<name> (default: ``utils.hub.models_dir``'s,
        ``$OMINIX_MODELS_DIR`` or ``~/.ominix/models``)."""
        self.host, self.port = host, port
        self.models_root = models_root
        self.models: dict = {}
        self.batchers: dict = {}
        self.spec: dict = {}        # name -> (SpeculativeEngine, draft
        #                             init_cache, num_draft_tokens)
        self.worker = InferenceWorker()
        self.request_timeout_s = request_timeout_s
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.metrics = {"requests_total": 0, "requests_failed": 0,
                        "prompt_tokens_total": 0,
                        "completion_tokens_total": 0,
                        "request_seconds_total": 0.0}
        self._metrics_lock = threading.Lock()

    def _count(self, prompt_tokens=0, completion_tokens=0, seconds=0.0,
               failed=False):
        with self._metrics_lock:
            self.metrics["requests_total"] += 1
            if failed:
                self.metrics["requests_failed"] += 1
            self.metrics["prompt_tokens_total"] += prompt_tokens
            self.metrics["completion_tokens_total"] += completion_tokens
            self.metrics["request_seconds_total"] += seconds

    def metrics_text(self) -> str:
        lines = []
        with self._metrics_lock:
            for k, v in self.metrics.items():
                lines.append(f"# TYPE ominix_{k} counter")
                lines.append(f"ominix_{k} {v}")
        lines.append("# TYPE ominix_models_loaded gauge")
        lines.append(f"ominix_models_loaded {len(self.models)}")
        for name, runner in self.batchers.items():
            pfx = getattr(runner.batcher, "prefix", None)
            if pfx is None:
                continue
            for key, kind, val in (
                    ("prefix_cache_hits", "counter", pfx.hits),
                    ("prefix_cache_misses", "counter", pfx.misses),
                    ("prefix_cache_hit_tokens", "counter", pfx.hit_tokens),
                    ("prefix_cache_pages", "gauge", len(pfx.entries))):
                lines.append(f"# TYPE ominix_{key} {kind}")
                lines.append(f'ominix_{key}{{model="{name}"}} {val}')
        return "\n".join(lines) + "\n"

    def load_model(self, name: str, model_dir: str, device=None):
        """Load a checkpoint directory through ``models.registry.
        load_pipeline``: a chat family becomes a ``ChatModel`` with the
        directory's ``Tokenizer``; a "vlm" (``moxin_vlm.MoxinVLM``), "ocr"
        (``deepseek_ocr2.DeepSeekOCR2``), "transcribe" pipeline
        (``paraformer.Transcriber``, ``qwen3_asr.Qwen3ASR``,
        ``funasr_nano.FunASRNano``) or "speak" pipeline (``qwen3_tts.
        TTSModel``) is served as its module builds it; the other
        pipelines raise NotImplementedError."""
        from ominix_mlx_tpu_torch.core.device import resolve_device
        from ominix_mlx_tpu_torch.models import registry
        from ominix_mlx_tpu_torch.utils.tokenizer import Tokenizer

        device = resolve_device(device)
        cap, obj = registry.load_pipeline(model_dir, device)
        if cap in ("vlm", "ocr", "transcribe", "speak"):
            obj.dir = model_dir
            self.models[name] = obj
            return obj
        if cap != "chat":
            raise NotImplementedError(f"{cap} pipelines are not ported")
        module, params, cfg = obj
        m = ChatModel(name, params, cfg, Tokenizer(model_dir), device,
                      module)
        m.dir = model_dir
        self.models[name] = m
        return m

    def add_model(self, name: str, model):
        """Register a model built in memory (random or bridged weights): a
        ``ChatModel``, a ``MoxinVLM``, a ``DeepSeekOCR2``, an ASR facade
        (anything with ``transcribe(samples, rate)``) or a TTS one (anything
        with ``synthesize``)."""
        self.models[name] = model

    def remove_model(self, name: str):
        """Stop serving ``name``: its batcher stops and frees its graphs;
        a model with ``close`` (a TTS model's captured frame steps) is
        closed on the inference thread."""
        m = self.models.pop(name, None)
        if hasattr(m, "close"):
            if self.worker.thread.is_alive():
                self.on_worker(m.close)
            else:
                m.close()
        self.spec.pop(name, None)
        runner = self.batchers.pop(name, None)
        if runner is not None:
            runner.stop()

    def enable_batching(self, name: str, slots: int = 4, max_len: int = 2048,
                        dtype=torch.bfloat16, paged: bool = False,
                        num_pages=None, page_size: int = 128,
                        quantize_bits=None, kv_bits=None,
                        prefix_cache: bool = False,
                        draft_dir=None, draft_layers=None,
                        num_draft_tokens: int = 4):
        """Turn on continuous batching for a loaded chat model: concurrent
        requests share one slot decode step instead of queueing on the
        inference thread. ``paged=True`` backs the slots with a shared
        paged KV pool of ``num_pages`` pages (decode attention: K3 on
        CUDA); ``kv_bits=8`` stores it as int8 pages; ``prefix_cache=True``
        reuses pool pages across requests sharing a prompt prefix (both
        imply ``paged``). ``quantize_bits``: 8 = channelwise w8a8, 4 =
        group w4, batched (see ``BatchedChatRunner``). ``draft_dir`` or
        ``draft_layers`` makes the batcher speculative: each step one
        draft-and-verify round of ``num_draft_tokens`` for every slot
        (greedy requests; sampled ones take the engine path). A batcher
        enabled again replaces the old one, which stops and frees its
        graphs."""
        runner = BatchedChatRunner(
            self.models[name], slots=slots, max_len=max_len, dtype=dtype,
            paged=paged, num_pages=num_pages, page_size=page_size,
            quantize_bits=quantize_bits, kv_bits=kv_bits,
            prefix_cache=prefix_cache, draft_dir=draft_dir,
            draft_layers=draft_layers, num_draft_tokens=num_draft_tokens)
        old, self.batchers[name] = self.batchers.get(name), runner
        if old is not None:
            old.stop()

    def enable_speculative(self, name: str, draft_dir: str = None,
                           draft_layers: int = None,
                           num_draft_tokens: int = 4):
        """Speculative decoding for greedy chat on ``name``: a separate
        draft checkpoint (``draft_dir``) or self-speculation on the first
        ``draft_layers`` layers of the same weights (``draft_for``). Output
        is token for token plain greedy decoding's where the target's
        products do not depend on the rows a call takes (bf16, channel
        w8a8). Group-quantized w4a8 verifies nd + 1 rows by the dq
        formula (bf16 activations) where a one-row step takes the P
        formula (int8 activations), as the JAX package's A3 and A1 do, so
        its tokens can leave greedy's (on random Qwen3-4B w4a8 weights at
        token 37 of 64); a hybrid model's recurrent layers roll back
        approximately, as in the JAX package."""
        m = self.models[name]
        dfwd, dparams, dinit = draft_for(m, draft_dir, draft_layers,
                                         m.kv_dtype)
        mod, cfg = m.module, m.cfg
        kw = {}
        if "fresh_prefill" in inspect.signature(mod.forward).parameters:
            kw["target_prefill_forward"] = lambda p, t, c: mod.forward(
                p, cfg, t, c, fresh_prefill=True)
        eng = SpeculativeEngine(
            lambda p, t, c: mod.forward(p, cfg, t, c), m.params, dfwd,
            dparams, num_draft_tokens=num_draft_tokens, **kw)
        self.spec[name] = (eng, dinit, num_draft_tokens)

    # ---------------------------------------------------------- handlers ----

    def on_worker(self, fn, timeout_s: Optional[float] = None):
        """Run ``fn()`` on the inference thread and return its result (or
        raise its error; TimeoutError past ``timeout_s``, the request
        timeout by default, while the job runs on to its end). Image
        requests take this path, so their towers never launch from an
        HTTP thread, where they could land inside another request's
        CUDA-graph capture."""
        done = threading.Event()
        box: dict = {}

        def run():
            try:
                box["out"] = fn()
            except Exception as e:
                box["err"] = e
            finally:
                done.set()

        self.worker.submit(run, lambda e: (box.setdefault("err", e),
                                           done.set()))
        timeout_s = self.request_timeout_s if timeout_s is None \
            else timeout_s
        if not done.wait(timeout=timeout_s):
            raise TimeoutError(f"request exceeded {timeout_s:.0f}s")
        if "err" in box:
            raise box["err"]
        return box["out"]

    @staticmethod
    def _parse_content_arrays(messages):
        """(text parts, the last image as [H, W, 3] float32 in [0, 1]) of
        OpenAI content-array messages (a data-URI ``image_url``); (None,
        None) where every content is a plain string."""
        texts, image = [], None
        seen_array = False
        for msg in messages:
            c = msg.get("content")
            if not isinstance(c, list):
                continue
            seen_array = True
            for part in c:
                if part.get("type") == "text":
                    texts.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    url = part.get("image_url", {}).get("url", "")
                    if url.startswith("data:") and "base64," in url:
                        image = _decode_image(base64.b64decode(
                            url.split("base64,", 1)[1]))
        return (texts if seen_array else None), image

    def _image_chat(self, name: str, m, body: dict, texts, image,
                    send_chunk=None) -> dict:
        """A content-array chat on a VLM: its ``chat`` on the inference
        thread (a stream gets the answer as one chunk)."""
        if not hasattr(m, "chat"):
            raise KeyError(f"model {name!r} takes no image input")
        max_tokens = int(body.get("max_tokens", DEFAULT_MAX_TOKENS))
        text = self.on_worker(lambda: m.chat(" ".join(texts or [""]), image,
                                             max_tokens=max_tokens),
                              float(body.get("timeout_s",
                                             self.request_timeout_s)))
        out = {"id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
               "object": "chat.completion", "created": int(time.time()),
               "model": name,
               "choices": [{"index": 0, "message": {
                   "role": "assistant", "content": text},
                   "finish_reason": "stop"}]}
        if send_chunk is not None:
            send_chunk({"id": out["id"], "object": "chat.completion.chunk",
                        "created": out["created"], "model": name,
                        "choices": [{"index": 0, "delta": {"content": text},
                                     "finish_reason": None}]})
        return out

    def chat_completion(self, body: dict, send_chunk=None) -> dict:
        name = body.get("model") or next(iter(self.models))
        if name not in self.models:
            raise KeyError(f"model {name!r} not loaded")
        m = self.models[name]
        # OpenAI content arrays (image chat) go to a VLM's chat(prompt,
        # image01): a text-only array too, where the model is one
        texts, image = self._parse_content_arrays(body.get("messages", []))
        if image is not None or (texts is not None and hasattr(m, "chat")
                                 and hasattr(m, "encode_image")):
            return self._image_chat(name, m, body, texts, image, send_chunk)
        if not isinstance(m, ChatModel):
            raise KeyError(f"model {name!r} is not a chat model")
        # tools: folded into the system turn; the completion's
        # <tool_call> spans come back as tool_calls (not when streaming)
        messages = body.get("messages", [])
        tools = body.get("tools") or None
        if body.get("tool_choice") == "none":
            tools = None
        if tools:
            messages = inject_tools(messages, tools)
        tmpl = getattr(m.tokenizer, "apply_chat_template", None)
        prompt_text = tmpl(messages) if tmpl else chatml(messages)
        tokens = list(m.tokenizer.encode(prompt_text))
        if not tokens:
            raise ValueError("empty prompt")
        sampler = SamplerConfig(
            temperature=float(body.get("temperature", 0.0)),
            top_p=float(body.get("top_p", 1.0)),
            top_k=int(body.get("top_k", 0)),
            min_p=float(body.get("min_p", 0.0)),
            repetition_penalty=float(body.get("repetition_penalty", 1.0)))
        max_tokens = int(body.get("max_tokens", DEFAULT_MAX_TOKENS))
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        eos = getattr(m.tokenizer, "eos_token_id", None)
        stops = {eos} if eos is not None else set()
        stop_strs = _StopStrings(body.get("stop"))
        rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
        created = int(time.time())
        timeout_s = float(body.get("timeout_s", self.request_timeout_s))
        seed = int(body.get("seed", 0))
        runner = self.batchers.get(name)
        if runner is not None and runner.batcher.spec \
                and sampler.temperature > 0:
            # a speculative batcher verifies greedily: sampled requests
            # take the per-request engine path
            runner = None
        if runner is not None:
            resp = self._chat_batched(runner, m, name, tokens, max_tokens,
                                      stops, send_chunk, timeout_s, rid,
                                      created, sampler, seed, stop_strs)
            return (resp if send_chunk is not None
                    else finalize_tool_response(resp, tools))
        cancel = threading.Event()
        result = {"text": "", "n": 0}
        done = threading.Event()
        err: list = []

        def chunk(delta):
            send_chunk({"id": rid, "object": "chat.completion.chunk",
                        "created": created, "model": name,
                        "choices": [{"index": 0,
                                     "delta": {"content": delta},
                                     "finish_reason": None}]})

        # greedy requests on a speculative model decode draft-then-verify,
        # token for token plain greedy decoding's
        spec = self.spec.get(name) if sampler.temperature == 0 else None

        def tokens_out():
            prompt = torch.tensor(tokens, dtype=torch.long, device=m.device)
            if spec is not None:
                eng, dinit, nd = spec
                cap = len(tokens) + max_tokens + 2 * nd + 8
                return eng.generate(prompt, m.init_cache(cap),
                                    dinit(1, cap), max_tokens=max_tokens,
                                    stop_tokens=tuple(stops))
            gen = None
            if sampler.temperature > 0:
                gen = torch.Generator(device=m.device)
                gen.manual_seed(seed)
            return m.engine(sampler).generate(
                prompt, m.init_cache(len(tokens) + max_tokens + 8),
                max_tokens=max_tokens, stop_tokens=tuple(stops),
                generator=gen)

        def run():
            try:
                out_ids = []
                matched = None
                for tok in tokens_out():
                    if cancel.is_set():
                        break
                    out_ids.append(tok)
                    if send_chunk is None and not stop_strs:
                        continue
                    piece = m.tokenizer.decode(out_ids)
                    if stop_strs:
                        safe, hit = stop_strs.cut(piece)
                        if hit:
                            matched = piece[:safe]
                        piece = piece[:safe]
                    delta = piece[len(result["text"]):]
                    if delta:
                        result["text"] = piece
                        if send_chunk is not None:
                            chunk(delta)
                    if matched is not None:
                        break
                final = matched if matched is not None else \
                    m.tokenizer.decode(out_ids)
                if send_chunk is not None and \
                        len(final) > len(result["text"]):
                    chunk(final[len(result["text"]):])
                result["text"] = final
                result["n"] = len(out_ids)
            except Exception as e:
                err.append(e)
            finally:
                done.set()

        self.worker.submit(run, lambda e: (err.append(e), done.set()))
        if not done.wait(timeout=timeout_s):
            cancel.set()            # generation stops at the next token
            done.wait()
            raise TimeoutError(f"request exceeded {timeout_s:.0f}s")
        if err:
            raise err[0]
        resp = {
            "id": rid, "object": "chat.completion", "created": created,
            "model": name,
            "choices": [{"index": 0,
                         "message": {"role": "assistant",
                                     "content": result["text"]},
                         "finish_reason": "stop"}],
            "usage": {"prompt_tokens": len(tokens),
                      "completion_tokens": result["n"],
                      "total_tokens": len(tokens) + result["n"]},
        }
        return (resp if send_chunk is not None
                else finalize_tool_response(resp, tools))

    @staticmethod
    def _chat_batched(runner, m, name, tokens, max_tokens, stops,
                      send_chunk, timeout_s, rid, created, sampler, seed,
                      stop_strs) -> dict:
        """Drain one request's token queue from the batcher's thread;
        streams deltas as tokens land, cancels the slot on timeout or on a
        stop string, and raises the error the batcher failed the request
        with (a prompt the pool can never hold: 400; a failed step: 500)."""
        brid, q = runner.submit(tokens, max_tokens, stop_tokens=stops,
                                sampler=sampler, seed=seed)
        deadline = time.time() + timeout_s
        out_ids, text = [], ""
        matched = None

        def chunk(delta):
            send_chunk({"id": rid, "object": "chat.completion.chunk",
                        "created": created, "model": name,
                        "choices": [{"index": 0,
                                     "delta": {"content": delta},
                                     "finish_reason": None}]})

        while True:
            try:
                tok = q.get(timeout=max(0.0, deadline - time.time()))
            except queue.Empty:
                runner.cancel(brid)
                raise TimeoutError(f"request exceeded {timeout_s:.0f}s")
            if tok is None:
                break
            if isinstance(tok, Exception):    # the batcher failed the request
                raise tok
            out_ids.append(tok)
            if send_chunk is None and not stop_strs:
                continue
            piece = m.tokenizer.decode(out_ids)
            if stop_strs:
                safe, hit = stop_strs.cut(piece)
                if hit:
                    matched = piece[:safe]
                piece = piece[:safe]
            delta = piece[len(text):]
            if delta:
                text = piece
                if send_chunk is not None:
                    chunk(delta)
            if matched is not None:
                runner.cancel(brid)       # frees the slot immediately
                break
        final = matched if matched is not None else m.tokenizer.decode(
            out_ids)
        if send_chunk is not None and len(final) > len(text):
            chunk(final[len(text):])
        return {
            "id": rid, "object": "chat.completion", "created": created,
            "model": name,
            "choices": [{"index": 0,
                         "message": {"role": "assistant", "content": final},
                         "finish_reason": "stop"}],
            "usage": {"prompt_tokens": len(tokens),
                      "completion_tokens": len(out_ids),
                      "total_tokens": len(tokens) + len(out_ids)},
        }

    def ocr(self, body: dict) -> dict:
        """POST /v1/ocr {"image": base64 PNG / JPEG | "pdf": base64,
        "prompt"?, "max_tokens"?} -> {"text"} / {"pages", "text"}, from a
        model with ``ocr`` / ``ocr_pdf`` (DeepSeek-OCR-2), on the
        inference thread."""
        name = body.get("model") or next(
            (n for n, m in self.models.items() if hasattr(m, "ocr")), "")
        if name not in self.models or not hasattr(self.models[name], "ocr"):
            raise KeyError(f"model {name!r} has no OCR capability")
        m = self.models[name]
        prompt = body.get("prompt", "Free OCR.")
        max_tokens = int(body.get("max_tokens", 512))
        timeout_s = float(body.get("timeout_s", self.request_timeout_s))
        if "pdf" in body:
            raw = base64.b64decode(body["pdf"])
            pages = self.on_worker(lambda: m.ocr_pdf(
                raw, prompt, max_tokens=max_tokens), timeout_s)
            return {"pages": pages, "text": "\n\n".join(pages)}
        arr = _decode_image(base64.b64decode(body["image"]))
        return {"text": self.on_worker(lambda: m.ocr(
            arr, prompt, max_tokens=max_tokens), timeout_s)}

    def describe(self, body: dict) -> dict:
        """POST /v1/describe {"image": base64, "prompt"?, "max_tokens"?}
        -> {"description", "tokens", "tokens_per_second"}: a VLM's
        ``chat`` on the inference thread. ``tokens`` counts the answer's
        tokens (by the model's tokenizer; without one, the ids the answer
        lists)."""
        name = body.get("model") or next(
            (n for n, m in self.models.items()
             if hasattr(m, "chat") and hasattr(m, "encode_image")), "")
        m = self.models.get(name)
        if m is None or not hasattr(m, "chat"):
            raise KeyError(f"model {name!r} has no image-chat capability")
        arr = _decode_image(base64.b64decode(body["image"]))
        prompt = body.get("prompt", "Describe this image in detail.")
        max_tokens = int(body.get("max_tokens", 256))
        t0 = time.time()
        text = self.on_worker(
            lambda: m.chat(prompt, arr, max_tokens=max_tokens),
            float(body.get("timeout_s", self.request_timeout_s)))
        dt = time.time() - t0
        tok = getattr(m, "tokenizer", None)
        n_tok = len(tok.encode(text)) if tok else len(text.split())
        return {"description": text, "tokens": n_tok,
                "tokens_per_second": (round(n_tok / dt, 2)
                                      if n_tok and dt > 0 else None)}

    def audio_transcription(self, wav_bytes: bytes, model_name=None,
                            task: str = "transcribe") -> dict:
        """POST /v1/audio/transcriptions (task "transcribe") and
        /v1/audio/translations (task "translate": speech to English in one
        pass) -> {"text"}: raw WAV bytes (not multipart), the named model
        or else the first one with ``transcribe`` / ``translate``
        (KeyError, 404, where none can), on the inference thread. Past 30
        s of audio the model's ``transcribe_long`` / ``translate_long``
        takes it where it has one. As in the JAX package, the frames are
        read as 16-bit PCM whatever the file's sample width, and the
        channels averaged."""
        import wave

        import numpy as np

        from ominix_mlx_tpu_torch import native

        want = "translate" if task == "translate" else "transcribe"
        if model_name is None:
            model_name = next((n for n, m in self.models.items()
                               if hasattr(m, want)), None)
        if model_name is None or model_name not in self.models:
            raise KeyError(f"no {want}-capable model loaded")
        m = self.models[model_name]
        if not hasattr(m, want):
            raise KeyError(f"model {model_name!r} cannot {want}")
        with wave.open(io.BytesIO(wav_bytes), "rb") as w:
            rate = w.getframerate()
            raw = w.readframes(w.getnframes())
            ch = w.getnchannels()
        samples = native.pcm16_to_float(np.frombuffer(raw, np.int16))
        if ch > 1:
            samples = samples.reshape(-1, ch).mean(-1)
        fn = want + "_long"
        if not (len(samples) > 30 * rate and hasattr(m, fn)):
            fn = want
        return {"text": self.on_worker(
            lambda: getattr(m, fn)(samples, rate))}

    def audio_speech(self, body: dict) -> bytes:
        """POST /v1/audio/speech {"input", "voice"?, "model"?, "ref_audio"?
        (a base64 WAV)} -> mono 16-bit WAV bytes: the named model or else
        the first one with ``synthesize`` (KeyError, 404, where none can),
        on the inference thread. A model with ``set_reference_audio`` takes
        ``ref_audio`` first (its frames read as 16-bit PCM, the channels
        averaged); ``synthesize(text, voice=)`` where it takes a voice, else
        ``synthesize(text)``. A bare waveform (no rate) is at the model's
        ``vits_cfg.sampling_rate``, else its ``sample_rate``, else 24 kHz.
        The samples go to PCM through ``native.float_to_pcm16``."""
        import wave

        import numpy as np

        from ominix_mlx_tpu_torch import native

        name = body.get("model") or next(
            (n for n, m in self.models.items() if hasattr(m, "synthesize")),
            "")
        if name not in self.models or not hasattr(self.models[name],
                                                  "synthesize"):
            raise KeyError(f"model {name!r} has no TTS capability")
        m = self.models[name]
        ref = None
        if body.get("ref_audio") and hasattr(m, "set_reference_audio"):
            with wave.open(io.BytesIO(base64.b64decode(body["ref_audio"])),
                           "rb") as w:
                ref_rate = w.getframerate()
                raw = w.readframes(w.getnframes())
                ch = w.getnchannels()
            ref = native.pcm16_to_float(np.frombuffer(raw, np.int16))
            if ch > 1:
                ref = ref.reshape(-1, ch).mean(-1)
        text = body["input"]
        takes_voice = "voice" in inspect.signature(m.synthesize).parameters

        def run():
            if ref is not None:
                m.set_reference_audio(ref, ref_rate)
            if takes_voice:
                return m.synthesize(text, voice=body.get("voice"))
            return m.synthesize(text)

        out = self.on_worker(run, float(body.get("timeout_s",
                                                 self.request_timeout_s)))
        if isinstance(out, tuple):
            samples, rate = out
        else:   # a clone model's bare waveform, at the decoder's rate
            samples = out
            rate = int(getattr(getattr(m, "vits_cfg", None),
                               "sampling_rate", 0)
                       or getattr(m, "sample_rate", 0) or 24000)
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(native.float_to_pcm16(
                np.asarray(samples, np.float32).reshape(-1)).tobytes())
        return buf.getvalue()

    def list_models(self) -> dict:
        return {"object": "list", "data": [
            {"id": name, "object": "model", "owned_by": "ominix",
             "path": getattr(m, "dir", None), "loaded": True,
             "device": str(getattr(m, "device", ""))}
            for name, m in self.models.items()]}

    def health(self) -> dict:
        return {"status": "ok", "version": __version__,
                "models_loaded": len(self.models)}

    # ------------------------------------------------------------- serve ----

    def serve_forever(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code: int, obj: dict):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/metrics":
                    data = server.metrics_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/health":
                    self._json(200, server.health())
                elif self.path in ("/v1/models", "/models"):
                    self._json(200, server.list_models())
                elif self.path == "/v1/models/local":
                    self._json(200, {"data": hub.list_models(
                        server.models_root)})
                else:
                    self._json(404, {"error": "not found"})

            def do_DELETE(self):
                if not self.path.startswith("/v1/models/"):
                    return self._json(404, {"error": "not found"})
                name = urllib.parse.unquote(self.path[len("/v1/models/"):])
                server.remove_model(name)
                ok = hub.delete_model(name, server.models_root)
                self._json(200, {"deleted": bool(ok), "id": name})

            def _error(self, e: Exception):
                if isinstance(e, KeyError):
                    return 404, str(e)
                if isinstance(e, NotImplementedError):
                    return 501, str(e)
                if isinstance(e, ValueError):
                    return 400, str(e)
                if isinstance(e, TimeoutError):
                    return 504, str(e)
                return 500, f"{type(e).__name__}: {e}"

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                routes = {"/v1/describe": server.describe,
                          "/v1/ocr": server.ocr}
                if self.path in ("/v1/audio/transcriptions",
                                 "/v1/audio/translations"):
                    task = ("translate" if self.path.endswith(
                        "translations") else "transcribe")
                    try:
                        return self._json(200, server.audio_transcription(
                            raw, task=task))
                    except Exception as e:
                        code, msg = self._error(e)
                        return self._json(code, {"error": msg})
                if self.path == "/v1/audio/speech":
                    try:
                        wav = server.audio_speech(json.loads(raw or b"{}"))
                    except json.JSONDecodeError:
                        return self._json(400, {"error": "invalid JSON"})
                    except Exception as e:
                        code, msg = self._error(e)
                        return self._json(code, {"error": msg})
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(len(wav)))
                    self.end_headers()
                    self.wfile.write(wav)
                    return
                if self.path == "/v1/models/download":
                    return self._json(501, {
                        "error": "model download needs the network and is "
                                 "not ported"})
                if self.path not in routes \
                        and self.path != "/v1/chat/completions":
                    return self._json(404, {"error": "not found"})
                try:
                    body = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    return self._json(400, {"error": "invalid JSON"})
                if self.path in routes:
                    try:
                        return self._json(200, routes[self.path](body))
                    except Exception as e:
                        code, msg = self._error(e)
                        return self._json(code, {"error": msg})
                t_req = time.time()
                streaming = bool(body.get("stream"))
                try:
                    if streaming:
                        self.send_response(200)
                        self.send_header("Content-Type", "text/event-stream")
                        self.send_header("Cache-Control", "no-cache")
                        self.end_headers()

                        def send_chunk(obj):
                            self.wfile.write(
                                b"data: " + json.dumps(obj).encode() + b"\n\n")
                            self.wfile.flush()

                        out = server.chat_completion(body, send_chunk)
                        send_chunk({
                            "id": out["id"],
                            "object": "chat.completion.chunk",
                            "created": out["created"],
                            "model": out["model"],
                            "choices": [{"index": 0, "delta": {},
                                         "finish_reason": "stop"}],
                            "usage": out.get("usage")})
                        self.wfile.write(b"data: [DONE]\n\n")
                    else:
                        out = server.chat_completion(body)
                        self._json(200, out)
                    u = out.get("usage", {})
                    server._count(u.get("prompt_tokens", 0),
                                  u.get("completion_tokens", 0),
                                  time.time() - t_req)
                    return
                except Exception as e:
                    code, msg = self._error(e)
                server._count(failed=True, seconds=time.time() - t_req)
                if streaming:   # headers are out: report in the stream
                    self.wfile.write(b"data: " + json.dumps(
                        {"error": msg, "code": code}).encode() + b"\n\n")
                else:
                    self._json(code, {"error": msg})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.serve_forever()

    def start_background(self, timeout_s: float = 5.0):
        """Serve on a daemon thread; returns once the socket is bound."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        deadline = time.monotonic() + timeout_s
        while self._httpd is None:
            if time.monotonic() > deadline or not self._thread.is_alive():
                raise RuntimeError("server failed to start")
            time.sleep(0.01)
        return self._thread

    def shutdown(self):
        """Stop serving and end the inference and batching threads."""
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(10)
        self.worker.stop()
        for runner in self.batchers.values():
            runner.stop()


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX package's server flags (ominix_mlx_tpu/serving/server.py
    ``main``)."""
    ap = argparse.ArgumentParser(
        description="ominix inference server on one CUDA card")
    ap.add_argument("--model", action="append", required=True,
                    help="name=path or path (repeatable)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--batch-slots", type=int, default=0,
                    help="continuous-batching slots for chat models "
                         "(0 = per-request decode)")
    ap.add_argument("--batch-max-len", type=int, default=4096)
    ap.add_argument("--batch-quantize-bits", type=int, default=None,
                    help="serve the continuous batcher quantized: 8 = "
                         "channelwise w8a8, 4 = group w4")
    ap.add_argument("--batch-paged", action="store_true",
                    help="back batching slots with a shared paged KV pool")
    ap.add_argument("--batch-num-pages", type=int, default=None,
                    help="physical pages in the shared pool (default: "
                         "fully backed)")
    ap.add_argument("--kv-bits", type=int, default=None, choices=(8,),
                    help="int8 KV pages in the paged pool")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="reuse KV pages across requests that share a "
                         "prompt prefix; implies --batch-paged")
    ap.add_argument("--draft-model", default=None,
                    help="draft checkpoint for speculative greedy decode "
                         "(applies to the first chat model, or to every "
                         "batched one)")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="self-speculation on the first N layers instead "
                         "of a separate draft checkpoint")
    ap.add_argument("--draft-tokens", type=int, default=4)
    return ap.parse_args(argv)


def build_server(args: argparse.Namespace, device=None) -> Server:
    """A Server with every ``--model`` loaded (on ``device``, default the
    current CUDA device) and, with ``--batch-slots``, batching enabled on
    each (speculative with ``--draft-model`` or ``--draft-layers``);
    without it, ``--draft-*`` turns on speculative decoding for the first
    model (the JAX package's ``main``)."""
    drafted = bool(args.draft_model or args.draft_layers)
    spec_kw = dict(draft_dir=args.draft_model,
                   draft_layers=args.draft_layers,
                   num_draft_tokens=args.draft_tokens) if drafted else {}
    srv = Server(args.host, args.port)
    for spec in args.model:
        name, _, path = spec.rpartition("=")
        name = name or path.rstrip("/").rsplit("/", 1)[-1]
        srv.load_model(name, path, device)
        if args.batch_slots:
            srv.enable_batching(
                name, slots=args.batch_slots, max_len=args.batch_max_len,
                quantize_bits=args.batch_quantize_bits,
                paged=(args.batch_paged or bool(args.kv_bits)
                       or args.prefix_cache),
                num_pages=args.batch_num_pages, kv_bits=args.kv_bits,
                prefix_cache=args.prefix_cache, **spec_kw)
        elif drafted and not srv.spec:
            srv.enable_speculative(name, **spec_kw)
    return srv


def main(argv=None):
    srv = build_server(parse_args(argv))
    print(f"serving on http://{srv.host}:{srv.port}", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.shutdown()


if __name__ == "__main__":
    main()
