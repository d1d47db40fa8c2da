"""Fun-ASR-Nano and FunASR-Qwen4B: the SAN-M encoder, a transformer
adaptor and a Qwen3 decoder (counterpart of
ominix_mlx_tpu/models/funasr_nano.py).

The encoder is Paraformer's (``models.paraformer.encode``); the adaptor
concatenates pairs of encoder frames, projects them and runs a small
pre-norm transformer into the decoder's embedding space; decoding splices
those embeddings into the chat prompt as Qwen3-ASR does: the prompt at
once with ``fresh_prefill=True`` (kernel K2 on CUDA; the JAX package
reads the whole cache under a mask there: the same function, other
rounding), then greedy steps through the engine's captured step. Long
audio is transcribed in chunks (``chunk_ranges``, copied), and
``translate`` is the same model with the translation instruction.
The features are cast to the encoder's type (the JAX package's type
promotion would run bf16 weights on float32 features in float32).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.core.generate import Engine
from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
from ominix_mlx_tpu_torch.models import base, paraformer
from ominix_mlx_tpu_torch.models.base import TransformerConfig
from ominix_mlx_tpu_torch.nn.layers import embedding, layer_norm, linear


@dataclasses.dataclass(frozen=True)
class AdaptorConfig:
    """The 2-layer transformer adaptor."""
    in_dim: int = 512
    hidden: int = 1024
    out_dim: int = 1024          # the decoder's hidden size
    layers: int = 2
    heads: int = 8
    downsample: int = 2          # frame-rate reduction by concatenation


def _mha(lp: dict, x: torch.Tensor, heads: int) -> torch.Tensor:
    B, T, D = x.shape
    hd = D // heads
    q = linear(lp["q"], x).reshape(B, T, heads, hd)
    k = linear(lp["k"], x).reshape(B, T, heads, hd)
    v = linear(lp["v"], x).reshape(B, T, heads, hd)
    a = torch.softmax(torch.einsum("bthd,bshd->bhts", q.float(), k.float())
                      / math.sqrt(hd), -1)
    o = torch.einsum("bhts,bshd->bthd", a.to(v.dtype), v).reshape(B, T, D)
    return linear(lp["o"], o)


def adaptor_forward(p: dict, acfg: AdaptorConfig,
                    x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, in_dim] encoder frames -> [B, T // ds, out_dim] decoder
    embeddings (a layer with SAN-M names takes Paraformer's attention)."""
    B, T, D = x.shape
    ds = acfg.downsample
    T2 = T // ds
    x = x[:, :T2 * ds].reshape(B, T2, ds * D)
    x = linear(p["proj_in"], x)
    for lp in p["layers"]:
        h = layer_norm(lp["norm1"], x)
        h = paraformer.sanm_attention(lp["self_attn"], h, acfg.heads) \
            if "linear_q_k_v" in lp.get("self_attn", {}) \
            else _mha(lp, h, acfg.heads)
        x = x + h
        h = layer_norm(lp["norm2"], x)
        x = x + linear(lp["fc2"], F.relu(linear(lp["fc1"], h)))
    return linear(p["proj_out"], x)


# the default chat wrapping: system, instruction, then the audio between
# <|startofspeech|> and <|endofspeech|>
DEFAULT_SYSTEM = "You are a helpful assistant."
DEFAULT_INSTRUCTION = "语音转写成中文："
# speech-to-English translation: the same model with another instruction
TRANSLATE_INSTRUCTION = "Translate the speech to English:"


@dataclasses.dataclass
class FunASRNano:
    """transcribe / translate facade."""
    enc_params: dict
    enc_cfg: paraformer.ParaformerConfig
    adaptor_params: dict
    adaptor_cfg: AdaptorConfig
    lm_params: dict
    lm_cfg: TransformerConfig
    tokenizer: Optional[object] = None
    device: torch.device = dataclasses.field(
        default_factory=lambda: resolve_device(None))

    def __post_init__(self):
        self.device = torch.device(self.device)
        self._engine = None

    def engine(self) -> Engine:
        """The decoder's greedy Engine (its captured step per call)."""
        if self._engine is None:
            cfg = self.lm_cfg
            self._engine = Engine(lambda p, t, c: base.forward(p, cfg, t, c),
                                  self.lm_params, SamplerConfig())
        return self._engine

    @torch.inference_mode()
    def encode(self, feats: torch.Tensor) -> torch.Tensor:
        """LFR features [B, T, n_mels * lfr_m] -> decoder embeddings [B,
        T // 2, D_lm]."""
        feats = feats.to(paraformer.weight_dtype(self.enc_params))
        enc = paraformer.encode(self.enc_params, self.enc_cfg, feats)
        return adaptor_forward(self.adaptor_params, self.adaptor_cfg, enc)

    @torch.inference_mode()
    def prefill(self, feats: torch.Tensor, prompt_prefix: List[int],
                prompt_suffix: List[int], max_tokens: int):
        """The encoded audio spliced between the prompt's embeddings, run
        through the decoder at once (K2 on CUDA): (last logits [1, V],
        cache)."""
        audio = self.encode(feats)

        def embed(ids):
            return embedding(self.lm_params["embed"], torch.tensor(
                [list(ids)], dtype=torch.long, device=self.device))

        pre, suf = embed(prompt_prefix), embed(prompt_suffix)
        embeds = torch.cat([pre, audio.to(pre.dtype), suf], 1)
        T = embeds.shape[1]
        cache = base.init_cache(self.lm_cfg, 1, T + max_tokens + 8,
                                pre.dtype, self.device)
        logits, cache = base.forward_embeds(self.lm_params, self.lm_cfg,
                                            embeds, cache, fresh_prefill=True)
        return logits[:, -1], cache

    def transcribe_tokens(self, feats: torch.Tensor, prompt_prefix: List[int],
                          prompt_suffix: List[int], max_tokens: int = 128,
                          stop_tokens=()) -> List[int]:
        """Greedy token ids after the spliced prompt; a stop token ends the
        list before it is appended."""
        logits, cache = self.prefill(feats, prompt_prefix, prompt_suffix,
                                     max_tokens)
        return list(self.engine().decode(logits, cache, max_tokens,
                                         tuple(stop_tokens)))

    # ------------------------------------------------- server/CLI facade ----

    def _prompt_ids(self, instruction=None, system=None):
        """The chat wrapping's token ids around the audio embeddings, and
        the stop tokens; without a tokenizer [1], [2] and none."""
        tok = self.tokenizer
        if tok is None:
            return [1], [2], ()
        pre = tok.encode(
            f"<|im_start|>system\n{system or DEFAULT_SYSTEM}<|im_end|>\n"
            f"<|im_start|>user\n{instruction or DEFAULT_INSTRUCTION}"
            f"<|startofspeech|>")
        suf = tok.encode("<|endofspeech|><|im_end|>\n<|im_start|>assistant\n")
        return pre, suf, tuple({tok.eos_token_id} - {None})

    def features(self, samples, rate: int) -> torch.Tensor:
        """Samples -> LFR features [T', n_mels * lfr_m] (no CMVN), float32."""
        from ominix_mlx_tpu_torch.audio.dsp import (apply_lfr, as_samples,
                                                    log_mel_spectrogram)

        mel = log_mel_spectrogram(as_samples(samples, self.device), 400, 160,
                                  self.enc_cfg.n_mels, rate)
        return apply_lfr(mel, self.enc_cfg.lfr_m, self.enc_cfg.lfr_n)

    def _detok(self, ids: List[int]) -> str:
        return (self.tokenizer.decode(ids) if self.tokenizer
                else " ".join(map(str, ids)))

    def transcribe(self, samples, rate: int = 16000, max_tokens: int = 256,
                   instruction=None) -> str:
        """Text of one clip."""
        pre, suf, stops = self._prompt_ids(instruction)
        ids = self.transcribe_tokens(self.features(samples, rate)[None],
                                     pre, suf, max_tokens=max_tokens,
                                     stop_tokens=stops)
        return self._detok(ids)

    def transcribe_long(self, samples, rate: int = 16000,
                        chunk_secs: float = 30.0, overlap_secs: float = 0.0,
                        max_tokens: int = 256, instruction=None,
                        sep: str = "") -> str:
        """Long audio in chunks (``chunk_ranges``), each transcribed alone,
        the texts joined by ``sep``."""
        pre, suf, stops = self._prompt_ids(instruction)
        outs = transcribe_long_tokens(
            self, samples, rate, pre, suf, chunk_secs=chunk_secs,
            overlap_secs=overlap_secs, max_tokens=max_tokens,
            stop_tokens=stops)
        return sep.join(self._detok(ids) for ids in outs)

    def transcribe_batch(self, samples_list, max_tokens: int = 256,
                         instruction=None) -> List[str]:
        """[(samples, rate), ...] one after another."""
        return [self.transcribe(s, r, max_tokens=max_tokens,
                                instruction=instruction)
                for s, r in samples_list]

    def translate(self, samples, rate: int = 16000,
                  max_tokens: int = 256) -> str:
        """Speech to English text in one pass."""
        return self.transcribe(samples, rate, max_tokens=max_tokens,
                               instruction=TRANSLATE_INSTRUCTION)

    def translate_long(self, samples, rate: int = 16000,
                       chunk_secs: float = 30.0, max_tokens: int = 256,
                       sep: str = " ") -> str:
        """Long audio translated in chunks, joined by ``sep``."""
        return self.transcribe_long(samples, rate, chunk_secs=chunk_secs,
                                    max_tokens=max_tokens,
                                    instruction=TRANSLATE_INSTRUCTION,
                                    sep=sep)


def init_adaptor(acfg: AdaptorConfig, generator: torch.Generator,
                 dtype=torch.float32, device=None) -> dict:
    """Random adaptor (tests and the smoke): uniform +-1/sqrt(in) linears,
    zero biases, unit norms."""
    device = resolve_device(device)
    h = acfg.hidden

    def lin(n_in, n_out):
        w = torch.rand((n_out, n_in), generator=generator,
                       device=device) * 2 - 1
        return {"w": (w * n_in ** -0.5).to(dtype),
                "b": torch.zeros(n_out, dtype=dtype, device=device)}

    def norm():
        return {"w": torch.ones(h, dtype=dtype, device=device),
                "b": torch.zeros(h, dtype=dtype, device=device)}

    return {
        "proj_in": lin(acfg.in_dim * acfg.downsample, h),
        "layers": [{"norm1": norm(), "norm2": norm(), "q": lin(h, h),
                    "k": lin(h, h), "v": lin(h, h), "o": lin(h, h),
                    "fc1": lin(h, 2 * h), "fc2": lin(2 * h, h)}
                   for _ in range(acfg.layers)],
        "proj_out": lin(h, acfg.out_dim),
    }


# ------------------------------------------------ checkpoint name mapping ---

def map_checkpoint_key(key: str) -> str:
    """On-disk tensor names -> the names this module loads: encoder
    attention and FFN aliases onto the SAN-M names, decoder aliases onto
    HF Qwen names (copied from the JAX package)."""
    k = key
    k = k.replace(".attn.qkv.", ".self_attn.linear_q_k_v.")
    k = k.replace(".attn.out.", ".self_attn.linear_out.")
    k = k.replace(".attn.fsmn.", ".self_attn.fsmn.")
    k = k.replace(".ffn.w1.", ".feed_forward.w_1.")
    k = k.replace(".ffn.w2.", ".feed_forward.w_2.")
    k = k.replace(".attn.q_proj.", ".self_attn.q_proj.")
    k = k.replace(".attn.k_proj.", ".self_attn.k_proj.")
    k = k.replace(".attn.v_proj.", ".self_attn.v_proj.")
    k = k.replace(".attn.o_proj.", ".self_attn.o_proj.")
    k = k.replace(".attn.q_norm.", ".self_attn.q_norm.")
    k = k.replace(".attn.k_norm.", ".self_attn.k_norm.")
    return k


def _lin(flat: dict, name: str) -> dict:
    p = {"w": flat[f"{name}.weight"]}
    if f"{name}.bias" in flat:
        p["b"] = flat[f"{name}.bias"]
    return p


def _norm(flat: dict, name: str) -> dict:
    return {"w": flat[f"{name}.weight"], "b": flat[f"{name}.bias"]}


def encoder_params_from_flat(flat: dict,
                             cfg: paraformer.ParaformerConfig) -> dict:
    """SenseVoice / SAN-M encoder tensors in FunASR's names
    (``encoder.encoders0.0`` the input-width layer, ``encoder.encoders.N``
    the rest, ``encoder.after_norm``) -> ``paraformer.encode``'s tree (the
    FSMN taps as [C, K, 1]; torch's [C, 1, K] is turned)."""
    def layer(prefix):
        fsmn_w = flat[f"{prefix}.self_attn.fsmn_block.weight"]
        if fsmn_w.dim() == 3 and fsmn_w.shape[-1] != 1:   # torch [C, 1, K]
            fsmn_w = fsmn_w.permute(0, 2, 1)
        return {
            "norm1": _norm(flat, f"{prefix}.norm1"),
            "norm2": _norm(flat, f"{prefix}.norm2"),
            "self_attn": {
                "linear_q_k_v": _lin(flat, f"{prefix}.self_attn.linear_q_k_v"),
                "out_proj": _lin(flat, f"{prefix}.self_attn.linear_out"),
                "fsmn_block": {"w": fsmn_w},
            },
            "ffn_up": _lin(flat, f"{prefix}.feed_forward.w_1"),
            "ffn_down": _lin(flat, f"{prefix}.feed_forward.w_2"),
        }

    return {
        "first_layer": layer("encoder.encoders0.0"),
        "layers": [layer(f"encoder.encoders.{i}")
                   for i in range(cfg.encoder_layers - 1)],
        "after_norm": _norm(flat, "encoder.after_norm"),
    }


def adaptor_params_from_flat(flat: dict, acfg: AdaptorConfig) -> dict:
    """Adaptor tensors (``adaptor.linear1``, ``adaptor.blocks.N``,
    ``adaptor.linear2``) -> ``adaptor_forward``'s tree."""
    return {
        "proj_in": _lin(flat, "adaptor.linear1"),
        "layers": [{
            "norm1": _norm(flat, f"adaptor.blocks.{i}.norm1"),
            "norm2": _norm(flat, f"adaptor.blocks.{i}.norm2"),
            "q": _lin(flat, f"adaptor.blocks.{i}.self_attn.q_proj"),
            "k": _lin(flat, f"adaptor.blocks.{i}.self_attn.k_proj"),
            "v": _lin(flat, f"adaptor.blocks.{i}.self_attn.v_proj"),
            "o": _lin(flat, f"adaptor.blocks.{i}.self_attn.o_proj"),
            "fc1": _lin(flat, f"adaptor.blocks.{i}.fc1"),
            "fc2": _lin(flat, f"adaptor.blocks.{i}.fc2"),
        } for i in range(acfg.layers)],
        "proj_out": _lin(flat, "adaptor.linear2"),
    }


def load_model(model_dir: str, device=None) -> FunASRNano:
    """A converted checkpoint directory: ``encoder.*`` and ``adaptor.*``
    in FunASR's names and the Qwen3 decoder under ``llm.*`` in HF names
    (``base.params_from_flat``), with the directory's tokenizer where it
    has a tokenizer.json, on ``device`` (default: the current CUDA
    device). The encoder is Paraformer-large's shape with
    ``audio_encoder_conf.num_blocks`` layers (default 50), the adaptor
    ``AdaptorConfig`` with ``adaptor_conf.llm_dim`` out (default 1024), as
    in the JAX package."""
    from ominix_mlx_tpu_torch.utils.loading import (load_config,
                                                    load_safetensors)

    device = resolve_device(device)
    raw = load_config(model_dir)
    flat = {map_checkpoint_key(k): v for k, v in
            load_safetensors(model_dir, device=device).items()}
    enc_cfg = paraformer.ParaformerConfig(
        encoder_layers=raw.get("audio_encoder_conf", {}).get("num_blocks", 50))
    acfg = AdaptorConfig(
        in_dim=enc_cfg.encoder_dim,
        out_dim=raw.get("adaptor_conf", {}).get("llm_dim", 1024))
    lm_raw = raw.get("llm_conf", raw)
    lm_cfg = TransformerConfig.from_hf(lm_raw)
    llm_flat = {k[len("llm."):]: v for k, v in flat.items()
                if k.startswith("llm.")}
    lm_params = base.params_from_flat(llm_flat, lm_cfg,
                                      lm_raw.get("quantization"), device)
    tok = None
    if os.path.exists(os.path.join(model_dir, "tokenizer.json")):
        from ominix_mlx_tpu_torch.utils.tokenizer import Tokenizer
        tok = Tokenizer(model_dir)
    return FunASRNano(
        enc_params=encoder_params_from_flat(flat, enc_cfg), enc_cfg=enc_cfg,
        adaptor_params=adaptor_params_from_flat(flat, acfg), adaptor_cfg=acfg,
        lm_params=lm_params, lm_cfg=lm_cfg, tokenizer=tok, device=device)


# ------------------------------------------------------------ long audio ----

def chunk_ranges(n_samples: int, sample_rate: int, chunk_secs: float,
                 overlap_secs: float = 0.0):
    """Chunk boundaries for long audio (copied): chunks of ``chunk_secs``
    with optional overlap; a trailing chunk under 100 ms is dropped."""
    chunk = int(chunk_secs * sample_rate)
    overlap = int(overlap_secs * sample_rate)
    step = chunk if overlap >= chunk else chunk - overlap
    out = []
    start = 0
    while start < n_samples:
        end = min(start + chunk, n_samples)
        if end - start < sample_rate // 10:
            break
        out.append((start, end))
        start += step
    return out


def transcribe_long_tokens(model: FunASRNano, samples, sample_rate: int,
                           prompt_prefix: List[int], prompt_suffix: List[int],
                           chunk_secs: float = 30.0,
                           overlap_secs: float = 0.0,
                           max_tokens: int = 256,
                           stop_tokens=()) -> List[List[int]]:
    """Each chunk's greedy token ids; the caller detokenizes and joins."""
    samples = np.asarray(samples, np.float32)
    return [model.transcribe_tokens(
                model.features(samples[s:e], sample_rate)[None],
                prompt_prefix, prompt_suffix, max_tokens=max_tokens,
                stop_tokens=stop_tokens)
            for s, e in chunk_ranges(len(samples), sample_rate, chunk_secs,
                                     overlap_secs)]
