"""Paraformer-large: non-autoregressive ASR, a SAN-M encoder, the CIF
predictor and a bidirectional decoder (counterpart of
ominix_mlx_tpu/models/paraformer.py).

  - front end: 80 mels, LFR (7 frames every 6), CMVN (``audio.dsp``);
  - SAN-M encoder: self-attention with an FSMN memory (a depthwise conv
    over the values, added back to them) on the value path; the first of
    the 50 layers takes the 560-wide LFR features and has no attention
    residual;
  - CIF (``ops.cif``: kernel K12 on CUDA, its plain loop on the CPU):
    the alphas (conv, ReLU, linear, sigmoid) integrate to one fired frame
    per token;
  - bidirectional decoder: an FSMN memory, cross-attention to the encoder
    and an FFN with an inner norm, every token in one pass.

The encoder's and decoder's attention and the convolutions are plain
PyTorch, as the JAX package leaves them to XLA. The JAX package's quirks
are kept: ``encode`` scales by sqrt(512) whatever ``encoder_dim`` is, the
positional table is sized by the input width and starts at position 1,
and the CIF frames are cast to the encoder's type before the decoder.
The features are cast to the weights' type (the JAX package's type
promotion would run bf16 weights on float32 features in float32).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.nn.layers import conv1d, layer_norm, linear
from ominix_mlx_tpu_torch.ops.cif import cif


@dataclasses.dataclass(frozen=True)
class ParaformerConfig:
    """Defaults: Paraformer-large (FunASR's paraformer-large; the JAX
    package's ``ParaformerConfig``)."""
    n_mels: int = 80
    lfr_m: int = 7
    lfr_n: int = 6
    encoder_dim: int = 512
    encoder_layers: int = 50
    encoder_heads: int = 4
    encoder_ffn_dim: int = 2048
    sanm_kernel_size: int = 11
    cif_threshold: float = 1.0
    cif_tail_threshold: float = 0.45
    decoder_dim: int = 512
    decoder_layers: int = 16
    decoder_heads: int = 4
    decoder_ffn_dim: int = 2048
    vocab_size: int = 8404

    @property
    def input_dim(self):
        return self.n_mels * self.lfr_m


def sinusoid_pe(T: int, dim: int) -> np.ndarray:
    """[T, dim] float32: sin on even, cos on odd channels, positions 1..T."""
    pos = np.arange(1, T + 1)[:, None]
    div = np.exp(-np.arange(0, dim, 2) * (math.log(10000.0) / dim))
    pe = np.zeros((T, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over [B, H, T, d] heads: float32 scores
    and softmax, the weights cast to v's type."""
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    attn = torch.softmax(scores, -1).to(v.dtype)
    return torch.einsum("bhts,bhsd->bhtd", attn, v)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, heads, D // heads).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    B, H, T, d = x.shape
    return x.transpose(1, 2).reshape(B, T, H * d)


# ------------------------------------------------------------- SAN-M --------

def sanm_attention(p: dict, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Self-attention plus the FSMN memory on the value path."""
    qkv = linear(p["linear_q_k_v"], x)
    dim = qkv.shape[-1] // 3
    q, k, v = torch.split(qkv, dim, -1)
    out = _merge(_attend(_heads(q, heads), _heads(k, heads),
                         _heads(v, heads)))
    K = p["fsmn_block"]["w"].shape[1]
    fsmn = conv1d(p["fsmn_block"], v, padding=K // 2, groups=dim) + v
    return linear(p["out_proj"], out) + fsmn


def encoder_layer(p: dict, x: torch.Tensor, heads: int,
                  residual_attn: bool) -> torch.Tensor:
    h = sanm_attention(p["self_attn"], layer_norm(p["norm1"], x), heads)
    x = x + h if residual_attn else h
    h = layer_norm(p["norm2"], x)
    h = linear(p["ffn_down"], F.relu(linear(p["ffn_up"], h)))
    return x + h


def encode(params: dict, cfg: ParaformerConfig,
           feats: torch.Tensor) -> torch.Tensor:
    """feats: [B, T, n_mels * lfr_m] (LFR + CMVN output) -> [B, T, D]."""
    T = feats.shape[1]
    x = feats * math.sqrt(512.0)
    x = x + torch.from_numpy(sinusoid_pe(T, feats.shape[-1])).to(
        device=feats.device, dtype=feats.dtype)[None]
    x = encoder_layer(params["first_layer"], x, cfg.encoder_heads,
                      residual_attn=False)
    for lp in params["layers"]:
        x = encoder_layer(lp, x, cfg.encoder_heads, residual_attn=True)
    return layer_norm(params["after_norm"], x)


# --------------------------------------------------------------- CIF --------

def predict_alphas(p: dict, x: torch.Tensor) -> torch.Tensor:
    """conv -> ReLU -> linear -> sigmoid: [B, T, D] -> [B, T]."""
    K = p["conv"]["w"].shape[1]
    h = F.relu(conv1d(p["conv"], x, padding=K // 2))
    return torch.sigmoid(linear(p["output_proj"], h))[..., 0]


# ----------------------------------------------------------- decoder --------

def decoder_layer(p: dict, x: torch.Tensor, enc: torch.Tensor,
                  heads: int) -> torch.Tensor:
    D = x.shape[-1]
    # FSMN "self-attention" (a non-causal depthwise conv memory)
    h = layer_norm(p["norm1"], x)
    K = p["self_attn_fsmn"]["w"].shape[1]
    x = x + conv1d(p["self_attn_fsmn"], h, padding=K // 2, groups=D)
    # cross-attention to the encoder's output
    h = layer_norm(p["norm2"], x)
    q = _heads(linear(p["src_attn_q"], h), heads)
    k, v = torch.split(linear(p["src_attn_kv"], enc), D, -1)
    o = _attend(q, _heads(k, heads), _heads(v, heads))
    x = x + linear(p["src_attn_out"], _merge(o))
    # FFN with an inner norm (FunASR's decoder)
    h = layer_norm(p["norm3"], x)
    h = F.relu(linear(p["ffn_up"], h))
    h = layer_norm(p["ffn_norm"], h)
    return x + linear(p["ffn_down"], h)


def decode(params: dict, cfg: ParaformerConfig, frames: torch.Tensor,
           enc: torch.Tensor) -> torch.Tensor:
    """frames: [B, N, D] CIF embeddings -> logits [B, N, vocab]."""
    x = frames
    for lp in params["dec_layers"]:
        x = decoder_layer(lp, x, enc, cfg.decoder_heads)
    x = layer_norm(params["dec_after_norm"], x)
    return linear(params["output_layer"], x)


def transcribe_logits(params: dict, cfg: ParaformerConfig,
                      feats: torch.Tensor):
    """LFR features -> (logits [B, T, V], token counts int32 [B]): the
    encoder, the alphas, CIF (K12 on CUDA) into T frames, and the decoder
    over all of them, in one non-autoregressive pass."""
    enc = encode(params, cfg, feats)
    alphas = predict_alphas(params["predictor"], enc)
    frames, counts = cif(enc, alphas, cfg.cif_threshold,
                         cfg.cif_tail_threshold)
    return decode(params, cfg, frames.to(enc.dtype), enc), counts


# ---------------------------------------------------------------- init ------

def init_params(cfg: ParaformerConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Random tree in the JAX package's layout (tests and the smoke):
    uniform +-1/sqrt(in) linears with zero biases, unit norms, N(0, 0.05)
    FSMN and predictor convolutions ([C_out, K, C_in / groups]).
    ``device`` defaults to the current CUDA device; the generator must
    live on the same device."""
    device = resolve_device(device)

    def lin(n_in, n_out):
        w = torch.rand((n_out, n_in), generator=generator,
                       device=device) * 2 - 1
        return {"w": (w * n_in ** -0.5).to(dtype),
                "b": torch.zeros(n_out, dtype=dtype, device=device)}

    def normal(shape, scale=0.05):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)

    def norm_p(d):
        return {"w": torch.ones(d, dtype=dtype, device=device),
                "b": torch.zeros(d, dtype=dtype, device=device)}

    def enc_layer(in_dim):
        d = cfg.encoder_dim
        return {
            "norm1": norm_p(in_dim), "norm2": norm_p(d),
            "self_attn": {
                "linear_q_k_v": lin(in_dim, 3 * d),
                "out_proj": lin(d, d),
                "fsmn_block": {"w": normal((d, cfg.sanm_kernel_size, 1))},
            },
            "ffn_up": lin(d, cfg.encoder_ffn_dim),
            "ffn_down": lin(cfg.encoder_ffn_dim, d),
        }

    d = cfg.decoder_dim
    return {
        "first_layer": enc_layer(cfg.input_dim),
        "layers": [enc_layer(cfg.encoder_dim)
                   for _ in range(cfg.encoder_layers - 1)],
        "after_norm": norm_p(cfg.encoder_dim),
        "predictor": {
            "conv": {"w": normal((cfg.encoder_dim, 3, cfg.encoder_dim)),
                     "b": torch.zeros(cfg.encoder_dim, dtype=dtype,
                                      device=device)},
            "output_proj": lin(cfg.encoder_dim, 1),
        },
        "dec_layers": [{
            "norm1": norm_p(d), "norm2": norm_p(d), "norm3": norm_p(d),
            "ffn_norm": norm_p(cfg.decoder_ffn_dim),
            "self_attn_fsmn": {"w": normal((d, cfg.sanm_kernel_size, 1))},
            "src_attn_q": lin(d, d),
            "src_attn_kv": lin(cfg.encoder_dim, 2 * d),
            "src_attn_out": lin(d, d),
            "ffn_up": lin(d, cfg.decoder_ffn_dim),
            "ffn_down": lin(cfg.decoder_ffn_dim, d),
        } for _ in range(cfg.decoder_layers)],
        "dec_after_norm": norm_p(d),
        "output_layer": lin(d, cfg.vocab_size),
    }


def weight_dtype(params: dict) -> torch.dtype:
    """The type the model computes in: its first layer's weights'."""
    return params["first_layer"]["self_attn"]["linear_q_k_v"]["w"].dtype


# ------------------------------------------------------ facade + loading ----

@dataclasses.dataclass
class Transcriber:
    """transcribe(samples, rate) facade."""
    params: dict
    cfg: ParaformerConfig
    cmvn_means: Optional[torch.Tensor] = None
    cmvn_vars: Optional[torch.Tensor] = None
    tokens: Optional[list] = None          # id -> string table
    # optional CT-Transformer punctuation restoration (models.punctuation)
    punc: object = None
    device: torch.device = dataclasses.field(
        default_factory=lambda: resolve_device(None))

    def __post_init__(self):
        self.device = torch.device(self.device)

    def features(self, samples: torch.Tensor, rate: int = 16000):
        """[T] float32 samples -> LFR (+ CMVN) features [1, T', n_mels *
        lfr_m], float32."""
        from ominix_mlx_tpu_torch.audio.dsp import (apply_cmvn, apply_lfr,
                                                    log_mel_spectrogram)

        mel = log_mel_spectrogram(samples, 400, 160, self.cfg.n_mels, rate)
        feats = apply_lfr(mel, self.cfg.lfr_m, self.cfg.lfr_n)
        if self.cmvn_means is not None:
            feats = apply_cmvn(feats, self.cmvn_means, self.cmvn_vars)
        return feats[None]

    @torch.inference_mode()
    def transcribe_ids(self, samples, rate: int = 16000):
        """The greedy token ids of one clip: the first ``count`` of the
        decoder's argmaxes."""
        from ominix_mlx_tpu_torch.audio.dsp import as_samples

        feats = self.features(as_samples(samples, self.device), rate)
        logits, counts = transcribe_logits(
            self.params, self.cfg, feats.to(weight_dtype(self.params)))
        n = int(counts[0])
        return [int(i) for i in logits[0].argmax(-1)[:n].tolist()]

    def transcribe(self, samples, rate: int = 16000) -> str:
        """Text of one clip: the tokens joined (BPE "@@" removed) and
        punctuated where a punctuation model is attached; without a token
        table, the ids joined by spaces."""
        ids = self.transcribe_ids(samples, rate)
        if self.tokens is None:
            return " ".join(str(i) for i in ids)
        text = "".join(self.tokens[i] if i < len(self.tokens) else ""
                       for i in ids).replace("@@", "")
        if self.punc is not None:
            text = self.punc.punctuate(text)
        return text


def load_model(model_dir: str, device=None) -> Transcriber:
    """A directory in the canonical save format (``utils.loading.
    save_model``) or a converted FunASR checkpoint (``utils.convert.
    paraformer_rename`` names), with ``tokens.txt`` where present and the
    CMVN vectors under ``cmvn.means`` / ``cmvn.vars`` where present, on
    ``device`` (default: the current CUDA device)."""
    from ominix_mlx_tpu_torch.utils.convert import paraformer_rename
    from ominix_mlx_tpu_torch.utils.loading import (load_config,
                                                    load_safetensors,
                                                    unflatten_params)

    device = resolve_device(device)
    raw = load_config(model_dir)
    cfg = ParaformerConfig(**{k: v for k, v in raw.items()
                              if k in ParaformerConfig.__dataclass_fields__})
    flat = {paraformer_rename(k): v
            for k, v in load_safetensors(model_dir, device=device).items()}
    params = unflatten_params(flat)
    tokens = None
    tok_path = os.path.join(model_dir, "tokens.txt")
    if os.path.exists(tok_path):
        with open(tok_path, encoding="utf-8") as f:
            tokens = [ln.rstrip("\n") for ln in f]
    cm = params.pop("cmvn", {})
    return Transcriber(params=params, cfg=cfg, tokens=tokens,
                       cmvn_means=cm.get("means"), cmvn_vars=cm.get("vars"),
                       device=device)
