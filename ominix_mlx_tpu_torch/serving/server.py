"""OpenAI-compatible HTTP server (counterpart of
ominix_mlx_tpu/serving/server.py, chat surface):

  POST /v1/chat/completions      (stream=true -> SSE)
  GET  /v1/models
  GET  /health
  GET  /metrics                  (Prometheus text, counters)

HTTP threads hand each request to ONE inference thread
(``InferenceWorker``); an Engine is cached per sampler configuration.
``Server.enable_batching`` turns on continuous batching for a model: its
chat requests (greedy and sampled) then go to a ``BatchedChatRunner``,
whose own thread steps a shared slot decode over a dense or paged KV
cache, with its own caches (the two threads never share a cache).
Speculative decoding, tool calls and the audio / image / OCR endpoints are
not ported yet: their routes answer 404 and a request that needs them
answers 501.
"""

from __future__ import annotations

import json
import queue
import sys
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from ominix_mlx_tpu_torch import __version__
from ominix_mlx_tpu_torch.core.generate import Engine
from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.serving.batching import (ContinuousBatcher,
                                                   PagedContinuousBatcher)
from ominix_mlx_tpu_torch.utils.tokenizer import chatml

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
        eng = self._engines.get(sampler)
        if eng is None:
            if len(self._engines) >= self.MAX_ENGINES:
                self._engines.pop(next(iter(self._engines)))
            mod, cfg = self.module, self.cfg
            eng = Engine(
                lambda p, t, c: mod.forward(p, cfg, t, c), self.params,
                sampler,
                prefill_forward_fn=lambda p, t, c: mod.forward(
                    p, cfg, t, c, fresh_prefill=True))
            self._engines[sampler] = eng
        return eng

    def init_cache(self, max_len: int):
        return self.module.init_cache(self.cfg, 1, max_len, self.kv_dtype,
                                      self.device)


class BatchedChatRunner:
    """Cross-request continuous batching for chat (serving/batching.py):
    HTTP threads submit token lists, ONE dedicated thread steps the shared
    slot decode, and tokens stream back through per-request queues. Greedy
    and sampled requests share the one step (per-slot sampler settings are
    tensors).

    quantize_bits=8 serves channelwise w8a8 (``scheme="channel8"``);
    quantize_bits=4 serves group w4 through K1 in its exact a16 mode.
    kv_bits=8 stores the paged pool as int8 pages."""

    def __init__(self, model, slots: int = 4, max_len: int = 2048,
                 dtype=torch.bfloat16, paged: bool = False,
                 num_pages=None, page_size: int = 128,
                 quantize_bits=None, kv_bits=None,
                 prefix_cache: bool = False):
        if quantize_bits not in (None, 4, 8) or kv_bits not in (None, 8):
            raise ValueError(f"quantize_bits {quantize_bits!r} (None, 4 or "
                             f"8), kv_bits {kv_bits!r} (None or 8)")
        self.lock = threading.Lock()
        self.wake = threading.Event()
        self._stop = threading.Event()
        params = model.params
        if quantize_bits:
            params = base.quantize_params(
                dict(model.params), bits=quantize_bits, act_bits=None,
                scheme="channel8" if quantize_bits == 8 else "group")
        mod, cfg = model.module, model.cfg
        fwd = lambda p, t, c: mod.forward(p, cfg, t, c)
        # adoption prefills are always fresh (K2); long prompts adopt by
        # chunks and prefix hits prefill their suffix through kv_limit (K2c)
        pfwd = lambda p, t, c: mod.forward(p, cfg, t, c, fresh_prefill=True)
        cfwd = lambda p, t, c, kl: mod.forward(p, cfg, t, c, kv_limit=kl)
        hfwd = lambda p, t, c, kl: mod.forward(p, cfg, t, c, kv_limit=kl,
                                               skip_logits=True)
        if paged or kv_bits or prefix_cache:
            self.batcher = PagedContinuousBatcher(
                fwd, params, cfg, slots=slots, max_len=max_len,
                num_pages=num_pages, page_size=page_size, dtype=dtype,
                prefill_forward_fn=pfwd, quantize_kv=kv_bits == 8,
                prefix_cache=prefix_cache, chunk_forward_fn=cfwd,
                chunk_hidden_forward_fn=hfwd, device=model.device)
        else:
            self.batcher = ContinuousBatcher(
                fwd, params, cfg,
                lambda c, b, ml: mod.init_cache(c, b, ml, dtype,
                                                model.device),
                slots=slots, max_len=max_len, prefill_forward_fn=pfwd,
                chunk_forward_fn=cfwd, chunk_hidden_forward_fn=hfwd)
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
        """End the stepping thread; queued and in-flight requests end."""
        self._stop.set()
        self.wake.set()
        self.thread.join(timeout)
        with self.lock:
            self.batcher.abort_all("the server is shutting down")


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


class Server:
    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 request_timeout_s: float = 600.0):
        self.host, self.port = host, port
        self.models: dict = {}
        self.batchers: dict = {}
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

    def add_model(self, name: str, model: ChatModel):
        """Register a model built in memory (random or bridged weights)."""
        self.models[name] = model

    def enable_batching(self, name: str, slots: int = 4, max_len: int = 2048,
                        dtype=torch.bfloat16, paged: bool = False,
                        num_pages=None, page_size: int = 128,
                        quantize_bits=None, kv_bits=None,
                        prefix_cache: bool = False,
                        draft_dir=None, draft_layers=None):
        """Turn on continuous batching for a loaded chat model: concurrent
        requests share one slot decode step instead of queueing on the
        inference thread. ``paged=True`` backs the slots with a shared
        paged KV pool of ``num_pages`` pages (decode attention: K3 on
        CUDA); ``kv_bits=8`` stores it as int8 pages; ``prefix_cache=True``
        reuses pool pages across requests sharing a prompt prefix (both
        imply ``paged``). ``quantize_bits``: 8 = channelwise w8a8, 4 =
        group w4 (K1). Speculative batching (``draft_dir`` or
        ``draft_layers``) is not ported and raises NotImplementedError."""
        if draft_dir is not None or draft_layers is not None:
            raise NotImplementedError(
                "speculative batching is not ported to the torch package "
                "yet")
        self.batchers[name] = BatchedChatRunner(
            self.models[name], slots=slots, max_len=max_len, dtype=dtype,
            paged=paged, num_pages=num_pages, page_size=page_size,
            quantize_bits=quantize_bits, kv_bits=kv_bits,
            prefix_cache=prefix_cache)

    # ---------------------------------------------------------- handlers ----

    def chat_completion(self, body: dict, send_chunk=None) -> dict:
        name = body.get("model") or next(iter(self.models))
        if name not in self.models:
            raise KeyError(f"model {name!r} not loaded")
        m = self.models[name]
        messages = body.get("messages", [])
        if any(not isinstance(msg.get("content", ""), (str, type(None)))
               for msg in messages):
            raise NotImplementedError("content arrays (image chat) are not "
                                      "ported yet")
        if body.get("tools") and body.get("tool_choice") != "none":
            raise NotImplementedError("tool calling is not ported yet")
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
        if runner is not None:
            return self._chat_batched(runner, m, name, tokens, max_tokens,
                                      stops, send_chunk, timeout_s, rid,
                                      created, sampler, seed, stop_strs)
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

        def run():
            try:
                engine = m.engine(sampler)
                cache = m.init_cache(len(tokens) + max_tokens + 8)
                gen = None
                if sampler.temperature > 0:
                    gen = torch.Generator(device=m.device)
                    gen.manual_seed(seed)
                prompt = torch.tensor(tokens, dtype=torch.long,
                                      device=m.device)
                out_ids = []
                matched = None
                for tok in engine.generate(prompt, cache,
                                           max_tokens=max_tokens,
                                           stop_tokens=tuple(stops),
                                           generator=gen):
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
        return {
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
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                if self.path != "/v1/chat/completions":
                    return self._json(404, {"error": "not found"})
                try:
                    body = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    return self._json(400, {"error": "invalid JSON"})
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
                            "usage": out["usage"]})
                        self.wfile.write(b"data: [DONE]\n\n")
                    else:
                        out = server.chat_completion(body)
                        self._json(200, out)
                    u = out.get("usage", {})
                    server._count(u.get("prompt_tokens", 0),
                                  u.get("completion_tokens", 0),
                                  time.time() - t_req)
                    return
                except KeyError as e:
                    code, msg = 404, str(e)
                except NotImplementedError as e:
                    code, msg = 501, str(e)
                except ValueError as e:
                    code, msg = 400, str(e)
                except TimeoutError as e:
                    code, msg = 504, str(e)
                except Exception as e:
                    code, msg = 500, f"{type(e).__name__}: {e}"
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
