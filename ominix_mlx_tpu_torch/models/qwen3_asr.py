"""Qwen3-ASR: the AuT audio encoder and a Qwen3 decoder (counterpart of
ominix_mlx_tpu/models/qwen3_asr.py).

  - front end: the Whisper-style log-mel (128 mels, n_fft 400, hop 160;
    ``audio.dsp``), always at 16 kHz;
  - AuT encoder: the mel cut into chunks of 100 frames, three stride-2
    3x3 convolutions (GELU) on each chunk, a linear to the model width,
    sinusoidal positions, the valid tokens of the last (partial) chunk
    gathered, transformer layers under a block-window mask (windows of
    ``n_window_infer`` frames), ln_post, proj1 (GELU), proj2;
  - the decoder: ``models.base`` over the prompt's embeddings with the
    audio features spliced in, run at once with ``fresh_prefill=True``
    (kernel K2 on CUDA; the JAX package reads the whole cache under a
    mask there: the same function, other rounding), then greedy decoding
    through the engine's captured step (``core.generate.Engine.decode``).

The encoder is plain PyTorch, as the JAX package leaves it to XLA; its
GELU is the tanh form (``jax.nn.gelu``'s default). The JAX package's
quirks are kept: ``transcribe`` ignores ``rate`` and builds a 16 kHz mel
(``serving.adapters.ASRAdapter`` resamples, the HTTP route does not), and
the features are cut to the decoder's width (``[:, :hidden_size]``). The
mel is cast to the encoder's type (the JAX package's type promotion would
run bf16 weights on the float32 mel in float32). The encoder's conv
weights are PyTorch's [C_out, C_in, KH, KW] (``from_numpy`` and
``load_model`` turn the JAX tree's OHWI into it).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from ominix_mlx_tpu_torch.audio.dsp import as_samples, log_mel_spectrogram
from ominix_mlx_tpu_torch.core.attention import NEG_INF, sdpa
from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.core.generate import Engine
from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.nn.layers import (conv2d, conv_weight, embedding,
                                            gelu_tanh, layer_norm, linear)
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

CONVS = ("conv2d1", "conv2d2", "conv2d3")


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig:
    """Defaults: the AuT encoder of Qwen3-ASR (the JAX package's)."""
    num_mel_bins: int = 128
    encoder_layers: int = 24
    encoder_attention_heads: int = 16
    encoder_ffn_dim: int = 4096
    d_model: int = 1024
    max_source_positions: int = 1500
    n_window: int = 50
    output_dim: int = 2048
    n_window_infer: int = 800
    downsample_hidden_size: int = 480

    @property
    def chunk_frames(self) -> int:
        return self.n_window * 2          # 100 mel frames per chunk

    @property
    def tokens_per_chunk(self) -> int:
        return out_length(self.chunk_frames)  # 13

    @staticmethod
    def from_hf(d: dict) -> "AudioEncoderConfig":
        keys = AudioEncoderConfig.__dataclass_fields__
        return AudioEncoderConfig(**{k: v for k, v in d.items() if k in keys})


def out_length(input_length: int) -> int:
    """Tokens out of the conv stack for ``input_length`` mel frames, with
    100-frame chunking (13 a full chunk)."""
    leave = input_length % 100
    feat = (leave - 1) // 2 + 1
    return ((feat - 1) // 2 + 1 - 1) // 2 + 1 + (input_length // 100) * 13


def sinusoid_positions(length: int, channels: int) -> np.ndarray:
    """[length, channels]: sin in the first half, cos in the second."""
    half = channels // 2
    log_ts = math.log(10000.0) / (half - 1)
    pos = np.arange(length)[:, None]
    scaled = pos * np.exp(-log_ts * np.arange(half))[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)


def init_encoder_params(cfg: AudioEncoderConfig, generator: torch.Generator,
                        dtype=torch.float32, device=None) -> dict:
    """Random encoder (tests and the smoke): convolutions uniform
    +-1/sqrt(9 C_in) with zero biases, linears uniform +-1/sqrt(in) with
    zero biases (conv_out without one), unit norms. ``device`` defaults to
    the current CUDA device; the generator must live on the same
    device."""
    device = resolve_device(device)
    ds, d = cfg.downsample_hidden_size, cfg.d_model

    def uniform(shape, lim):
        w = torch.rand(shape, generator=generator, device=device) * 2 - 1
        return (w * lim).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def lin(n_in, n_out, bias=True):
        p = {"w": uniform((n_out, n_in), n_in ** -0.5)}
        if bias:
            p["b"] = zeros(n_out)
        return p

    def norm():
        return {"w": torch.ones(d, dtype=dtype, device=device), "b": zeros(d)}

    def conv_p(cin, cout):
        return {"w": uniform((cout, cin, 3, 3), 1.0 / math.sqrt(cin * 9)),
                "b": zeros(cout)}

    freq_after = (((cfg.num_mel_bins + 1) // 2 + 1) // 2 + 1) // 2
    return {
        "conv2d1": conv_p(1, ds),
        "conv2d2": conv_p(ds, ds),
        "conv2d3": conv_p(ds, ds),
        "conv_out": lin(ds * freq_after, d, bias=False),
        "layers": [{
            "self_attn_layer_norm": norm(),
            "q_proj": lin(d, d), "k_proj": lin(d, d), "v_proj": lin(d, d),
            "out_proj": lin(d, d),
            "final_layer_norm": norm(),
            "fc1": lin(d, cfg.encoder_ffn_dim),
            "fc2": lin(cfg.encoder_ffn_dim, d),
        } for _ in range(cfg.encoder_layers)],
        "ln_post": norm(),
        "proj1": lin(d, d),
        "proj2": lin(d, cfg.output_dim),
    }


def encoder_from_jax(tree: dict) -> dict:
    """A JAX encoder tree (conv weights OHWI, as loaded or converted) ->
    the port's (OIHW)."""
    out = dict(tree)
    for name in CONVS:
        out[name] = {**tree[name], "w": conv_weight(tree[name]["w"])}
    return out


def _encoder_layer(lp: dict, cfg: AudioEncoderConfig, x: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Pre-norm multi-head attention and a GELU MLP."""
    B, T, D = x.shape
    H = cfg.encoder_attention_heads
    hd = D // H

    def heads(t):
        return t.reshape(B, T, H, hd).transpose(1, 2)

    h = layer_norm(lp["self_attn_layer_norm"], x)
    o = sdpa(heads(linear(lp["q_proj"], h)), heads(linear(lp["k_proj"], h)),
             heads(linear(lp["v_proj"], h)), scale=hd ** -0.5, mask=mask)
    x = x + linear(lp["out_proj"], o.transpose(1, 2).reshape(B, T, D))
    h = layer_norm(lp["final_layer_norm"], x)
    return x + linear(lp["fc2"], gelu_tanh(linear(lp["fc1"], h)))


def valid_index(cfg: AudioEncoderConfig, n_frames: int,
                num_chunks: int) -> np.ndarray:
    """The flat [chunk, token] rows that hold real audio: 13 of each full
    chunk, ``out_length`` of the last partial one's frames."""
    C, t = cfg.chunk_frames, cfg.tokens_per_chunk
    idx = []
    for ch in range(num_chunks):
        n_valid = max(0, min(n_frames - ch * C, C))
        idx.extend(ch * t + j
                   for j in range(out_length(n_valid) if n_valid else 0))
    if len(idx) != out_length(n_frames):
        raise ValueError(f"{n_frames} frames in {num_chunks} chunks")
    return np.asarray(idx, np.int64)


def block_mask(cfg: AudioEncoderConfig, total: int, device) -> torch.Tensor:
    """Additive float32 [total, total]: a token sees the tokens of its own
    window of 13 * (n_window_infer // 100) tokens (the last window takes
    the remainder)."""
    window = cfg.tokens_per_chunk * (cfg.n_window_infer // cfg.chunk_frames)
    blocks = np.minimum(np.arange(total) // window, (total - 1) // window)
    mask = np.where(blocks[:, None] == blocks[None, :], 0.0, NEG_INF)
    return torch.from_numpy(mask.astype(np.float32)).to(device)


def encode(params: dict, cfg: AudioEncoderConfig, mel: torch.Tensor,
           n_frames: int) -> torch.Tensor:
    """mel: [n_mels, T_padded] (T_padded a multiple of 100, at least
    n_frames) -> audio features [valid tokens, output_dim]."""
    n_mels, Tp = mel.shape
    C = cfg.chunk_frames
    if Tp % C:
        raise ValueError(f"mel of {Tp} frames is not whole chunks of {C}")
    num_chunks = Tp // C
    # [chunks, n_mels, 100, 1], channels last
    x = mel.reshape(n_mels, num_chunks, C).transpose(0, 1)[..., None]
    for name in CONVS:
        x = gelu_tanh(conv2d(params[name], x, stride=2, padding=1))
    b, f, t, c = x.shape                    # [chunks, freq, t, ch]
    x = x.permute(0, 2, 3, 1).reshape(b, t, c * f)
    x = linear(params["conv_out"], x)       # [chunks, 13, d]
    pos = torch.from_numpy(sinusoid_positions(
        cfg.max_source_positions, cfg.d_model)[:t]).to(x.device, x.dtype)
    x = x + pos[None]
    idx = torch.from_numpy(valid_index(cfg, n_frames, num_chunks)).to(
        x.device)
    h = x.reshape(num_chunks * t, cfg.d_model)[idx][None]   # [1, valid, d]
    mask = block_mask(cfg, h.shape[1], h.device)
    for lp in params["layers"]:
        h = _encoder_layer(lp, cfg, h, mask)
    h = layer_norm(params["ln_post"], h[0])
    h = gelu_tanh(linear(params["proj1"], h))
    return linear(params["proj2"], h)       # [valid, output_dim]


def _ids(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.long, device=device).reshape(
        1, -1)


# --------------------------------------------------------------- pipeline ---

@dataclasses.dataclass
class Qwen3ASR:
    """transcribe(samples, rate) facade."""
    enc_params: dict
    enc_cfg: AudioEncoderConfig
    lm_params: dict
    lm_cfg: base.TransformerConfig
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

    def mel(self, samples: torch.Tensor) -> torch.Tensor:
        """[T] float32 samples at 16 kHz -> the float32 log-mel [n_mels,
        frames]."""
        return log_mel_spectrogram(samples, 400, 160,
                                   self.enc_cfg.num_mel_bins, 16000).T

    @torch.inference_mode()
    def encode_audio(self, samples) -> torch.Tensor:
        """Samples (16 kHz) -> audio features [tokens, output_dim]."""
        mel = self.mel(as_samples(samples, self.device))
        n = mel.shape[1]
        mel = torch.nn.functional.pad(mel, (0, (-n) % self.enc_cfg.chunk_frames))
        dtype = self.enc_params["conv_out"]["w"].dtype
        return encode(self.enc_params, self.enc_cfg, mel.to(dtype), n)

    @torch.inference_mode()
    def prefill(self, audio_feats: torch.Tensor, prompt_prefix,
                prompt_suffix, max_tokens: int):
        """The audio features spliced between the prompt's embeddings, run
        through the decoder at once (K2 on CUDA) into a cache of the
        prompt, ``max_tokens`` and 8 slots: (last logits [1, V], cache)."""
        emb_pre = embedding(self.lm_params["embed"],
                            _ids(prompt_prefix, self.device))
        emb_suf = embedding(self.lm_params["embed"],
                            _ids(prompt_suffix, self.device))
        feats = audio_feats[None].to(emb_pre.dtype)
        embeds = torch.cat([emb_pre, feats, emb_suf], 1)
        T = embeds.shape[1]
        cache = base.init_cache(self.lm_cfg, 1, T + max_tokens + 8,
                                emb_pre.dtype, self.device)
        logits, cache = base.forward_embeds(self.lm_params, self.lm_cfg,
                                            embeds, cache, fresh_prefill=True)
        return logits[:, -1], cache

    def transcribe_embeds(self, audio_feats: torch.Tensor, prompt_prefix,
                          prompt_suffix, max_tokens: int = 128,
                          stop_tokens=()):
        """Greedy token ids after the spliced prompt; a stop token ends the
        list before it is appended."""
        logits, cache = self.prefill(audio_feats, prompt_prefix,
                                     prompt_suffix, max_tokens)
        return list(self.engine().decode(logits, cache, max_tokens,
                                         tuple(stop_tokens)))

    def prompt_ids(self, language=None):
        """(prefix, suffix, stop tokens) around the audio: the chat format
        with "transcribe" (and the forced language) after it; without a
        tokenizer [1], [2] and no stop."""
        if self.tokenizer is None:
            return [1], [2], ()
        pre = self.tokenizer.encode("<|im_start|>user\n")
        lang = f" {language}:" if language else ":"
        suf = self.tokenizer.encode(
            f"transcribe{lang}<|im_end|>\n<|im_start|>assistant\n")
        return pre, suf, tuple({self.tokenizer.eos_token_id} - {None})

    def transcribe(self, samples, rate: int = 16000, language=None,
                   max_tokens: int = 256) -> str:
        """Text of one clip (``rate`` is not read: the mel is built at 16
        kHz, as in the JAX package); without a tokenizer the ids joined by
        spaces."""
        feats = self.encode_audio(samples)[:, :self.lm_cfg.hidden_size]
        pre, suf, stops = self.prompt_ids(language)
        ids = self.transcribe_embeds(feats, pre, suf, max_tokens=max_tokens,
                                     stop_tokens=stops)
        if self.tokenizer is not None:
            return self.tokenizer.decode(ids)
        return " ".join(map(str, ids))


def from_numpy(enc: dict, lm: dict, enc_cfg: AudioEncoderConfig,
               lm_cfg: base.TransformerConfig, device,
               tokenizer=None) -> Qwen3ASR:
    """A JAX Qwen3ASR's trees as numpy -> the port's assembly on
    ``device``."""
    return Qwen3ASR(enc_params=encoder_from_jax(params_from_numpy(enc, device)),
                    enc_cfg=enc_cfg, lm_params=params_from_numpy(lm, device),
                    lm_cfg=lm_cfg, tokenizer=tokenizer, device=device)


def load_model(model_dir: str, device=None) -> Qwen3ASR:
    """The canonical save format: config.json with ``audio_encoder_conf``
    and ``text_config`` (an HF Qwen3 config), tensors under ``encoder.*``
    and ``llm.*`` (the JAX trees flattened), with the directory's
    tokenizer where it has a tokenizer.json, on ``device`` (default: the
    current CUDA device)."""
    from ominix_mlx_tpu_torch.utils.loading import (load_config,
                                                    load_safetensors,
                                                    unflatten_params)

    device = resolve_device(device)
    raw = load_config(model_dir)
    ecfg = AudioEncoderConfig.from_hf(raw.get("audio_encoder_conf", {}))
    lcfg = base.TransformerConfig.from_hf(raw.get("text_config", raw))
    tree = unflatten_params(load_safetensors(model_dir, device=device))
    tok = None
    if os.path.exists(os.path.join(model_dir, "tokenizer.json")):
        from ominix_mlx_tpu_torch.utils.tokenizer import Tokenizer
        tok = Tokenizer(model_dir)
    return Qwen3ASR(enc_params=encoder_from_jax(tree["encoder"]),
                    enc_cfg=ecfg, lm_params=tree["llm"], lm_cfg=lcfg,
                    tokenizer=tok, device=device)
