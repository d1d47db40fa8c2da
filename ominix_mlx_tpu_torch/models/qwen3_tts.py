"""Qwen3-TTS: a dual-track autoregressive talker, a 16-codebook code
predictor and a SnakeBeta (BigVGAN-style) codec decoder, with streaming
synthesis and voice cloning (counterpart of
ominix_mlx_tpu/models/qwen3_tts.py).

  - the talker (``models.base`` layers) takes the projected text embedding
    plus the codec embeddings of the last frame and gives the codebook-0
    logits and its hidden state;
  - the code predictor (4 small layers) gives codebooks 1-15 of the frame
    greedily: a 2-token prefill then 14 one-token steps over a scratch
    cache [B, heads, 18, hd];
  - the codec decoder: RVQ dequantization, a causal pre-conv, a
    sliding-window transformer, ConvNeXt upsampling, SnakeBeta decoder
    blocks, tanh;
  - the speech encoder (reference audio to frame codes) and the ECAPA
    speaker encoder (``models.speaker_encoder``) feed the voice-clone
    modes.

One frame (the talker's step, then the predictor) is the step the JAX
package compiles once per ``Synthesizer`` (``jax.jit(self._frame_step)``).
Here it is one plain body over static buffers (the talker's cache in bf16,
the last frame's 16 codes, the text token, a [1] offset tensor, the
predictor's scratch cache, zeroed inside the body every frame), captured
as a CUDA graph once per ``Synthesizer`` and capacity bucket
(``core.generate.CapturedBodies`` keyed by ``bucket_length`` of the
capacity the JAX loop allocates) and replayed for every later frame and
request; plain and clone requests whose capacities fall in one bucket
share it, and ``close()`` frees the graphs. The host writes the text
token, replays, and reads the 16 codes (one sync a frame) to test for
EOS. Frame 0 comes from the prefill, outside the step, as in the JAX
loop. On the CPU the body runs eagerly; on the card a failed capture
raises, and nothing falls back to an eager loop. ``Synthesizer.frame_body``
called directly runs the plain step on either device: tests and the smoke
hold the replays to it.

Kernels on CUDA: the talker's prefill, the predictor's 2-token prefill
(inside the graph), the codec's pre-transformer (with its sliding window)
and the speech encoder's transformer run ``fresh_prefill=True`` (K2;
the JAX package computes the masked ``sdpa`` there: the same function,
other rounding); a talker quantized by ``base.quantize_params`` runs K1
at one row in the step and the dq kernel at the prefill. SnakeBeta, the
convolutions and the codebook lookups are plain PyTorch, as the JAX
package leaves them to XLA.

The JAX package's quirks are kept: the talker takes plain RoPE
(``cfg.rope()``; ``apply_mrope_tts`` is defined and never called); the
predictor's attention config has ``num_kv_heads = cp_heads`` and the
talker's ``rms_norm_eps``; ``load_model`` passes no speaker config to the
``Synthesizer``; without a tokenizer ``TTSModel`` maps characters to
``ord(c) % 1000``. The speaker x-vector is cast to the prefill's type
before it joins it (the JAX package's type promotion would run a bf16
talker on float32 activations there).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from ominix_mlx_tpu_torch.core.attention import causal_mask
from ominix_mlx_tpu_torch.core.cache import KVCache, ModelCache
from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.core.generate import CapturedBodies, bucket_length
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.models.base import TransformerConfig
from ominix_mlx_tpu_torch.nn.layers import (conv1d, conv_transpose1d, elu,
                                            embedding, gelu_tanh,
                                            layer_norm, linear, rms_norm,
                                            silu, snake_beta)
from ominix_mlx_tpu_torch.utils.params import params_from_numpy


@dataclasses.dataclass(frozen=True)
class TalkerConfig:
    transformer: TransformerConfig          # the talker's decoder body
    codec_vocab_size: int = 2048            # per codebook (+ specials on 0)
    codec_head_size: int = 2048 + 8         # codebook-0 logits with controls
    num_code_groups: int = 16
    text_vocab_size: int = 151936
    text_embed_dim: int = 1024              # the text embedding's width
    cp_hidden: int = 1024                   # the code predictor's width
    cp_layers: int = 4
    cp_heads: int = 8
    codec_eos_id: int = 2050
    codec_pad_id: int = 2051
    codec_bos_id: int = 2052
    tts_pad_token_id: int = 151671


# ------------------------------------------------------------ talker --------

def text_projection(p: dict, x: torch.Tensor) -> torch.Tensor:
    """fc1 -> SiLU -> fc2."""
    return linear(p["fc2"], silu(linear(p["fc1"], x)))


def talker_step(params: dict, tcfg: TalkerConfig, embeds: torch.Tensor,
                cache: ModelCache, fresh_prefill: bool = False):
    """embeds [B, T, H] -> (codebook-0 logits [B, T, V0], the final-normed
    hidden [B, T, H], cache advanced by T); the KV buffers are written in
    place. ``fresh_prefill``: the cache is empty (K2 on CUDA)."""
    normed, cache = base.forward_embeds(params, tcfg.transformer, embeds,
                                        cache, fresh_prefill,
                                        skip_logits=True)
    return linear(params["codec_head"], normed), normed, cache


# ---------------------------------------------------- code predictor --------

def predictor_config(tcfg: TalkerConfig, cp: dict) -> TransformerConfig:
    """The code predictor's attention config, as ``predict_codes`` of the
    JAX package builds it: cp_heads query and KV heads of cp_hidden /
    cp_heads, the talker's rms_norm_eps, the FFN width its weights hold."""
    return _predictor_config(tcfg, cp["layers"][0]["gate_proj"]["w"].shape[0])


def _predictor_config(tcfg: TalkerConfig, ffn: int) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=1, hidden_size=tcfg.cp_hidden, num_layers=tcfg.cp_layers,
        num_heads=tcfg.cp_heads, num_kv_heads=tcfg.cp_heads,
        head_dim=tcfg.cp_hidden // tcfg.cp_heads, intermediate_size=ffn,
        rms_norm_eps=tcfg.transformer.rms_norm_eps)


def predictor_cache(tcfg: TalkerConfig, cp: dict, batch: int, dtype,
                    device) -> ModelCache:
    """The predictor's scratch cache: 2 prefill positions and one per
    codebook, [B, cp_heads, 2 + num_code_groups, hd] a layer, zeroed."""
    return base.init_cache(predictor_config(tcfg, cp), batch,
                           2 + tcfg.num_code_groups, dtype, device)


def linear_head(cp: dict, g: int, h: torch.Tensor) -> torch.Tensor:
    """Codebook g + 1's logits of predictor states h [B, T, cp_hidden]."""
    return torch.matmul(h, cp["lm_heads"][g].to(h.dtype).T)


def _cp_forward(cp: dict, cfg: TransformerConfig, x: torch.Tensor,
                cache: ModelCache, fresh_prefill: bool = False):
    """The predictor's layers and final norm: (h [B, T, cp_hidden],
    cache advanced by T)."""
    return base.forward_embeds(cp, cfg, x, cache, fresh_prefill,
                               skip_logits=True)


def predict_codes(cp: dict, tcfg: TalkerConfig, talker_hidden: torch.Tensor,
                  code0_embed: torch.Tensor,
                  cache: Optional[ModelCache] = None) -> torch.Tensor:
    """Greedy codebooks 1..15 of one frame: [B, 15] int64.

    talker_hidden, code0_embed: [B, 1, H_talker]. The scratch ``cache``
    (``predictor_cache``) is zeroed first, as the JAX package's fresh
    cache is zeros: a masked score gives a weight of 0, but 0 times a NaN
    left in the buffers would be NaN; without one a fresh one is made.
    The 2-token prefill runs ``fresh_prefill`` (K2 on CUDA), the 14 steps
    the masked sdpa over the scratch cache."""
    cfg = predictor_config(tcfg, cp)
    if cache is None:
        cache = predictor_cache(tcfg, cp, talker_hidden.shape[0],
                                talker_hidden.dtype, talker_hidden.device)
    else:
        for lc in cache.layers:
            lc.k.zero_()
            lc.v.zero_()
        cache = ModelCache(layers=cache.layers, offset=0)

    def proj(x):
        return linear(cp["small_to_mtp_projection"], x)

    prefill = torch.cat([proj(talker_hidden), proj(code0_embed)], 1)
    h, cache = _cp_forward(cp, cfg, prefill, cache, fresh_prefill=True)
    codes = [linear_head(cp, 0, h[:, -1:]).argmax(-1)[:, 0]]
    for g in range(1, tcfg.num_code_groups - 1):
        # the codec embeddings live in the talker's width: projected down
        emb = cp["codec_embeddings"][g - 1][codes[-1]][:, None]
        h, cache = _cp_forward(cp, cfg, proj(emb.to(prefill.dtype)), cache)
        codes.append(linear_head(cp, g, h)[:, -1].argmax(-1))
    return torch.stack(codes, 1)


# ----------------------------------------------------- codec decoder --------

def causal_conv1d(p: dict, x: torch.Tensor, dilation: int = 1):
    K = p["w"].shape[1]
    return conv1d(p, x, padding=(((K - 1) * dilation, 0),),
                  dilation=dilation)


def causal_conv_transpose1d(p: dict, x: torch.Tensor, stride: int):
    y = conv_transpose1d(p, x, stride=stride)
    trim = p["w"].shape[1] - stride
    return y[:, :y.shape[1] - trim] if trim > 0 else y


def residual_unit(p: dict, x: torch.Tensor, dilation: int) -> torch.Tensor:
    h = causal_conv1d(p["conv1"], snake_beta(p["act1"], x), dilation)
    h = causal_conv1d(p["conv2"], snake_beta(p["act2"], h))
    return x + h


def decoder_block(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = causal_conv_transpose1d(p["conv_t"], snake_beta(p["snake"], x),
                                stride)
    for i, ru in enumerate(p["res_units"]):
        h = residual_unit(ru, h, dilation=3 ** i)
    return h


def convnext_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal conv, LayerNorm, a tanh-GELU MLP (``jax.nn.gelu``'s default
    form), scaled by gamma, residual."""
    h = causal_conv1d(p["dwconv"], x)
    h = layer_norm({"w": p["norm_w"], "b": p["norm_b"]}, h)
    h = torch.matmul(h, p["pw1_w"].T) + p["pw1_b"]
    h = gelu_tanh(h)
    h = torch.matmul(h, p["pw2_w"].T) + p["pw2_b"]
    return x + p["gamma"] * h


def _transformer_stack(layers: list, tcfg: TransformerConfig,
                       h: torch.Tensor, window=None) -> torch.Tensor:
    """Each layer over h [B, T, D] as a fresh prefill (K2 on CUDA, with
    ``window``), one KV buffer of T positions written and read by every
    layer in turn (the JAX package's codec and speech encoder)."""
    B, T, _ = h.shape
    cache = KVCache.init(B, tcfg.num_kv_heads, T, tcfg.hd, h.dtype,
                         h.device)
    mask = functools.cache(lambda: causal_mask(T, T, 0, window,
                                               device=h.device))
    rope = tcfg.rope()
    for lp in layers:
        h, _ = base.decoder_layer(lp, tcfg, h, cache, 0, mask, rope,
                                  fresh_prefill=True)
    return h


def codec_decode(dec: dict, codes: torch.Tensor, cfg: dict) -> torch.Tensor:
    """codes: [T, 16] (or [B, T, 16]) int -> waveform [B T upsample] float
    in [-1, 1], in the decoder's type."""
    codes = codes[None] if codes.dim() == 2 else codes
    codes = codes.long()

    def lookup(book, ids):
        # an id past the codebook (codebook 0's control ids) takes its
        # last row, as the JAX package's clamped gather
        return book[ids.clamp(0, book.shape[0] - 1)]

    sem = lookup(dec["semantic_codebook"], codes[..., 0])       # [B, T, d]
    if dec["rvq_first_output_proj"]["w"].dim() == 3:
        sem = causal_conv1d(dec["rvq_first_output_proj"], sem)
    ac = sum(lookup(dec["acoustic_codebooks"][g], codes[..., g + 1])
             for g in range(15))
    if dec["rvq_rest_output_proj"]["w"].dim() == 3:
        ac = causal_conv1d(dec["rvq_rest_output_proj"], ac)
    h = sem + ac
    h = causal_conv1d(dec["pre_conv"], h)
    h = linear(dec["pre_transformer_input_proj"], h)
    heads = cfg.get("num_heads", 8)
    layers = dec["pre_transformer_layers"]
    tcfg = TransformerConfig(
        vocab_size=1, hidden_size=h.shape[-1], num_layers=len(layers),
        num_heads=heads, num_kv_heads=heads, head_dim=h.shape[-1] // heads,
        intermediate_size=layers[0]["gate_proj"]["w"].shape[0],
        sliding_window=cfg.get("sliding_window"))
    h = _transformer_stack(layers, tcfg, h, tcfg.sliding_window)
    h = rms_norm(dec["pre_transformer_norm"], h)
    h = linear(dec["pre_transformer_output_proj"], h)
    for up, cn, stride in zip(dec["upsample_convs"], dec["upsample_convnext"],
                              cfg.get("up_strides", (2, 2))):
        h = causal_conv_transpose1d(up, h, stride)
        h = convnext_block(cn, h)
    h = causal_conv1d(dec["initial_conv"], h)
    for blk, stride in zip(dec["decoder_blocks"],
                           cfg.get("dec_strides", (8, 5, 4, 3))):
        h = decoder_block(blk, h, stride)
    h = snake_beta(dec["final_snake"], h)
    h = causal_conv1d(dec["final_conv"], h)
    return torch.tanh(h).reshape(-1)


def samples_per_frame(cfg: dict) -> int:
    """The codec's upsampling: the product of its strides."""
    return int(np.prod(cfg.get("up_strides", (2, 2)))
               * np.prod(cfg.get("dec_strides", (8, 5, 4, 3))))


# -------------------------------------------------------------- init --------

def _initializers(generator, dtype, device):
    def uniform(shape):
        w = torch.rand(shape, generator=generator, device=device) * 2 - 1
        return (w * shape[1] ** -0.5).to(dtype)

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device)
                * std).to(dtype)

    def lin(n_in, n_out, bias):
        p = {"w": uniform((n_out, n_in))}
        if bias:
            p["b"] = torch.zeros(n_out, dtype=dtype, device=device)
        return p

    return uniform, normal, lin


def init_params(tcfg: TalkerConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Random talker and code predictor (tests and the smoke), the JAX
    package's tree and initial ranges (``base.init_params`` layers,
    uniform +-1/sqrt(in) linears, N(0, 0.02) embeddings). ``device``
    defaults to the current CUDA device; the generator must live there."""
    device = resolve_device(device)
    _, normal, lin = _initializers(generator, dtype, device)
    cfg = tcfg.transformer
    H = cfg.hidden_size
    params = base.init_params(cfg, generator, dtype, device)
    params.pop("lm_head", None)
    params.pop("embed")
    params["codec_head"] = lin(H, tcfg.codec_head_size, False)
    params["text_embedding"] = normal(
        (tcfg.text_vocab_size, tcfg.text_embed_dim), 0.02)
    params["text_projection"] = {"fc1": lin(tcfg.text_embed_dim, H, True),
                                 "fc2": lin(H, H, True)}
    params["codec_embedding"] = normal((tcfg.codec_head_size, H), 0.02)
    cp = base.init_params(_predictor_config(tcfg, tcfg.cp_hidden * 3),
                          generator, dtype, device)
    cp.pop("embed")
    cp.pop("lm_head", None)
    G = tcfg.num_code_groups
    cp["codec_embeddings"] = [normal((tcfg.codec_vocab_size, H), 0.02)
                              for _ in range(G - 1)]
    cp["lm_heads"] = [normal((tcfg.codec_vocab_size, tcfg.cp_hidden), 0.02)
                      for _ in range(G - 1)]
    cp["small_to_mtp_projection"] = lin(H, tcfg.cp_hidden, True)
    params["code_predictor"] = cp
    return params


def _cconv(normal, dtype, device):
    def cconv(cin, cout, k):
        return {"w": normal((cout, k, cin), 0.05),
                "b": torch.zeros(cout, dtype=dtype, device=device)}
    return cconv


def init_codec(generator: torch.Generator, frame_dim: int = 32,
               n_transformer: int = 1, num_heads: int = 4, up_strides=(2,),
               dec_strides=(2, 2), codec_vocab: int = 64,
               dtype=torch.float32, device=None):
    """Random codec decoder and its static config, the JAX package's
    ``init_codec`` tree (every stage ``frame_dim`` wide; SnakeBeta's
    alpha and beta float32 ones) -> (tree, config)."""
    device = resolve_device(device)
    _, normal, lin = _initializers(generator, dtype, device)
    cconv = _cconv(normal, dtype, device)

    def ones(n, dt=dtype):
        return torch.ones(n, dtype=dt, device=device)

    def snake(c):
        return {"alpha_exp": ones((1, 1, c), torch.float32),
                "beta_exp": ones((1, 1, c), torch.float32)}

    def ru(c):
        return {"act1": snake(c), "conv1": cconv(c, c, 3),
                "act2": snake(c), "conv2": cconv(c, c, 1)}

    d = frame_dim
    tl_cfg = TransformerConfig(
        vocab_size=1, hidden_size=d, num_layers=1, num_heads=num_heads,
        num_kv_heads=num_heads, head_dim=d // num_heads,
        intermediate_size=2 * d)
    dec = {
        "semantic_codebook": normal((codec_vocab, d), 0.1),
        "acoustic_codebooks": [normal((codec_vocab, d), 0.1)
                               for _ in range(15)],
        "rvq_first_output_proj": cconv(d, d, 1),
        "rvq_rest_output_proj": cconv(d, d, 1),
        "pre_conv": cconv(d, d, 3),
        "pre_transformer_input_proj": lin(d, d, True),
        "pre_transformer_output_proj": lin(d, d, True),
        "pre_transformer_norm": ones(d),
        "pre_transformer_layers": [
            base.init_params(tl_cfg, generator, dtype, device)["layers"][0]
            for _ in range(n_transformer)],
        "upsample_convs": [cconv(d, d, 2 * s) for s in up_strides],
        "upsample_convnext": [{
            "dwconv": cconv(d, d, 3), "norm_w": ones(d),
            "norm_b": torch.zeros(d, dtype=dtype, device=device),
            "pw1_w": normal((2 * d, d), 0.05),
            "pw1_b": torch.zeros(2 * d, dtype=dtype, device=device),
            "pw2_w": normal((d, 2 * d), 0.05),
            "pw2_b": torch.zeros(d, dtype=dtype, device=device),
            "gamma": ones(d) * 0.1,
        } for _ in up_strides],
        "initial_conv": cconv(d, d, 3),
        "decoder_blocks": [{"snake": snake(d), "conv_t": cconv(d, d, 2 * s),
                            "res_units": [ru(d) for _ in range(2)]}
                           for s in dec_strides],
        "final_snake": snake(d),
        "final_conv": cconv(d, 1, 3),
    }
    cfg = {"num_heads": num_heads, "sliding_window": None,
           "up_strides": tuple(up_strides), "dec_strides": tuple(dec_strides)}
    return dec, cfg


def _port_config(c) -> TransformerConfig:
    """A JAX ``TransformerConfig`` (or any object with its fields) as the
    port's."""
    if isinstance(c, TransformerConfig):
        return c
    names = {f.name for f in dataclasses.fields(TransformerConfig)}
    return TransformerConfig(**{n: getattr(c, n) for n in names
                                if hasattr(c, n)})


def from_numpy(tree: dict, device, dtype: Optional[torch.dtype] = None):
    """A JAX tree of this module as numpy (the talker with its code
    predictor, a codec decoder or a speech encoder; quantized weights as
    ``utils.params.params_from_numpy`` takes them) -> the port's on
    ``device``. The speech encoder's ``_tcfg`` (a config, not a tensor)
    becomes the port's ``TransformerConfig``. Conv weights keep the MLX
    layout [C_out, K, C_in], which ``nn.layers.conv1d`` takes."""
    rest = {k: v for k, v in tree.items() if k != "_tcfg"}
    out = params_from_numpy(rest, device, dtype)
    if "_tcfg" in tree:
        out["_tcfg"] = _port_config(tree["_tcfg"])
    return out


# --------------------------------------------------------- synthesizer ------

@dataclasses.dataclass
class GenerationResult:
    codes: np.ndarray            # [frames, 16] int32
    frames: int


@dataclasses.dataclass
class FrameState:
    """The static buffers of one capacity's captured frame step: the
    talker's KV buffers (bf16), the offset ([1] int64), the last frame's
    codes ([1, G] int64), the text token ([1] int64) and the predictor's
    scratch cache."""
    layers: list
    offset: torch.Tensor
    prev_codes: torch.Tensor
    text_tok: torch.Tensor
    scratch: ModelCache


def _frames_result(frames) -> GenerationResult:
    codes = np.stack(frames) if frames else np.zeros((0, 16), np.int32)
    return GenerationResult(codes=codes, frames=len(frames))


class Synthesizer:
    """The dual-track generation loop and its voice-clone modes, over the
    talker tree ``talker_params`` (its ``code_predictor`` inside), on the
    device of its weights.

    On CUDA every frame after the first runs through the captured step
    (``captured``: ``CapturedBodies`` keyed by the capacity bucket);
    ``frame_body`` is its plain body. ``captures`` counts the graphs
    captured over the synthesizer's life; ``close()`` frees them and the
    frame buffers (a later request captures again)."""

    def __init__(self, talker_params: dict, tcfg: TalkerConfig,
                 codec_params: Optional[dict] = None,
                 codec_cfg: Optional[dict] = None,
                 spk_params: Optional[dict] = None, spk_cfg=None,
                 speech_enc: Optional[dict] = None, speech_enc_cfg=None):
        self.tp = talker_params
        self.tcfg = tcfg
        self.codec = codec_params
        self.codec_cfg = codec_cfg or {}
        self.spk_params = spk_params            # ECAPA speaker encoder
        self.spk_cfg = spk_cfg
        self.speech_enc = speech_enc            # reference-audio tokenizer
        self.speech_enc_cfg = speech_enc_cfg
        emb = talker_params["text_embedding"]
        self.device = emb.device
        self.dtype = emb.dtype                  # the activations' type
        self.captures = 0
        self.captured = CapturedBodies(self.device)
        self._states: dict = {}                 # capacity -> FrameState

    # ------------------------------------------------------ the step ----

    def state(self, capacity: int) -> FrameState:
        """The frame buffers of ``capacity`` (a bucket), made once."""
        st = self._states.get(capacity)
        if st is None:
            cfg, dev = self.tcfg.transformer, self.device
            G = self.tcfg.num_code_groups
            st = FrameState(
                layers=base.init_cache(cfg, 1, capacity, torch.bfloat16,
                                       dev).layers,
                offset=torch.zeros(1, dtype=torch.long, device=dev),
                prev_codes=torch.zeros(1, G, dtype=torch.long, device=dev),
                text_tok=torch.zeros(1, dtype=torch.long, device=dev),
                scratch=predictor_cache(self.tcfg, self.tp["code_predictor"],
                                        1, self.dtype, dev))
            self._states[capacity] = st
        return st

    def frame_body(self, st: FrameState):
        """One frame over ``st``'s buffers: the embedding of the last
        frame's 16 codes and the text token, the talker's step at the
        offset, greedy codebook 0, the predictor's codebooks 1..15; the
        codes are written to ``st.prev_codes`` and the offset advanced, in
        place. Returns (codes [1, G], codebook-0 logits [1, V0])."""
        emb = self.frame_embedding(st.prev_codes, st.text_tok)
        logits, hidden, _ = talker_step(
            self.tp, self.tcfg, emb,
            ModelCache(layers=st.layers, offset=st.offset))
        codes = self._codes(logits, hidden, st)
        st.prev_codes.copy_(codes)
        st.offset.add_(1)
        return codes, logits[:, -1]

    def frame_embedding(self, prev_codes: torch.Tensor,
                        text_tok: torch.Tensor) -> torch.Tensor:
        """The talker's input for one frame, [B, 1, H]: the projected text
        token's embedding plus the codec embeddings of the last frame's
        codes (codebook 0's table, then the predictor's 15)."""
        tp = self.tp
        cp = tp["code_predictor"]
        te = text_projection(tp["text_projection"],
                             embedding(tp["text_embedding"],
                                       text_tok[:, None]))
        c0 = embedding(tp["codec_embedding"], prev_codes[:, :1])
        rest = sum(cp["codec_embeddings"][g][prev_codes[:, g + 1]][:, None]
                   for g in range(self.tcfg.num_code_groups - 1))
        return te + c0 + rest.to(te.dtype)

    def _codes(self, logits, hidden, st: FrameState) -> torch.Tensor:
        """Greedy codebook 0 from the last position's logits, then the
        predictor's codebooks: [1, G]."""
        code0 = logits[:, -1].argmax(-1)
        c0e = embedding(self.tp["codec_embedding"], code0[:, None])
        rest = predict_codes(self.tp["code_predictor"], self.tcfg,
                             hidden[:, -1:], c0e, st.scratch)
        return torch.cat([code0[:, None], rest], 1)

    def step(self, st: FrameState, capacity: int):
        """One frame: the captured graph of ``capacity`` replayed (captured
        at its first call); on the CPU the body run eagerly."""
        if self.device.type == "cuda" and capacity not in \
                self.captured.graphs:
            self.captures += 1
        return self.captured.run(capacity, lambda: self.frame_body(st))

    def _prefill(self, st: FrameState, emb: torch.Tensor):
        """The prompt into ``st``'s talker cache (zeroed first) at once,
        K2 on CUDA: (logits, hidden); the offset set past it."""
        for lc in st.layers:
            lc.k.zero_()
            lc.v.zero_()
        logits, hidden, _ = talker_step(
            self.tp, self.tcfg, emb, ModelCache(layers=st.layers, offset=0),
            fresh_prefill=True)
        st.offset.fill_(emb.shape[1])
        return logits, hidden

    def _host_codes(self, codes: torch.Tensor) -> np.ndarray:
        return codes[0].to(torch.int32).cpu().numpy()

    def _text(self, text: List[int], pos: int) -> int:
        return text[pos] if pos < len(text) else self.tcfg.tts_pad_token_id

    # ----------------------------------------------------- prompting ----

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(list(ids), dtype=torch.long,
                               device=self.device)[None]

    def build_prefill(self, text_tokens: List[int], codec_prefix: List[int],
                      spk_embed: Optional[torch.Tensor] = None):
        """The batched prefill embedding: the text projection of pads and
        the first text token plus the codec prefix and BOS; a speaker
        x-vector in front where one is given."""
        tcfg, tp = self.tcfg, self.tp
        text_ids = [tcfg.tts_pad_token_id] * len(codec_prefix) \
            + [text_tokens[0]]
        te = text_projection(tp["text_projection"],
                             embedding(tp["text_embedding"],
                                       self._ids(text_ids)))
        ce = embedding(tp["codec_embedding"],
                       self._ids(list(codec_prefix) + [tcfg.codec_bos_id]))
        emb = te + ce
        if spk_embed is not None:
            spk = torch.as_tensor(spk_embed, device=self.device)
            emb = torch.cat([spk[None, None].to(emb.dtype), emb], 1)
        return emb

    # ---------------------------------------------------- generation ----

    @torch.inference_mode()
    def _frames(self, text_tokens: List[int], codec_prefix: List[int],
                max_frames: int, step: Callable):
        """The device side of a request: (codes [1, G], codebook-0 logits
        [1, V0]) of its first ``max_frames`` frames, in the frame
        buffers of its capacity bucket (read before the next is asked
        for): frame 0 from the prefill, then ``step(state, capacity)`` for
        each later one (``self.step``, or ``frame_body`` run eagerly); no
        EOS test."""
        if max_frames < 1:
            return
        cap = bucket_length(len(codec_prefix) + 2 + max_frames + 8)
        st = self.state(cap)
        logits, hidden = self._prefill(
            st, self.build_prefill(text_tokens, codec_prefix))
        codes = self._codes(logits, hidden, st)
        st.prev_codes.copy_(codes)
        yield codes, logits[:, -1]
        for f in range(1, max_frames):
            st.text_tok.fill_(self._text(text_tokens, f))
            yield step(st, cap)

    @torch.inference_mode()
    def generate_frames(self, text_tokens: List[int],
                        codec_prefix: List[int], max_frames: int = 600
                        ) -> Iterator[np.ndarray]:
        """Yield [16] int32 code frames until EOS or ``max_frames``."""
        for codes, _ in self._frames(text_tokens, codec_prefix,
                                     max_frames, self.step):
            c = self._host_codes(codes)         # the one sync of a frame
            if int(c[0]) == self.tcfg.codec_eos_id:
                break
            yield c

    def synthesize_codes(self, text_tokens: List[int],
                         codec_prefix: List[int],
                         max_frames: int = 600) -> GenerationResult:
        return _frames_result(list(self.generate_frames(
            text_tokens, codec_prefix, max_frames)))

    @torch.inference_mode()
    def decode_audio(self, codes: np.ndarray) -> np.ndarray:
        """[frames, 16] codes -> the float32 waveform."""
        if self.codec is None:
            raise RuntimeError("codec decoder weights not loaded")
        c = torch.as_tensor(np.asarray(codes), dtype=torch.long,
                            device=self.device)
        return codec_decode(self.codec, c, self.codec_cfg).float().cpu() \
            .numpy()

    def stream(self, text_tokens: List[int], codec_prefix: List[int],
               chunk_frames: int = 10, max_frames: int = 600):
        """Yield waveform chunks of ``chunk_frames`` frames as generation
        proceeds (the frames themselves where no codec is loaded)."""
        buf = []
        for frame in self.generate_frames(text_tokens, codec_prefix,
                                          max_frames):
            buf.append(frame)
            if len(buf) >= chunk_frames:
                yield self.decode_audio(np.stack(buf)) \
                    if self.codec is not None else np.stack(buf)
                buf = []
        if buf:
            yield self.decode_audio(np.stack(buf)) \
                if self.codec is not None else np.stack(buf)

    # ------------------------------------------------ voice cloning ----

    @torch.inference_mode()
    def encode_speaker(self, mel) -> torch.Tensor:
        """Reference mel [T, mel_dim] -> the x-vector [hidden] for the
        prefill's speaker slot."""
        from ominix_mlx_tpu_torch.models import speaker_encoder as se

        if self.spk_params is None:
            raise RuntimeError("speaker encoder not loaded")
        mel = torch.as_tensor(np.asarray(mel) if not isinstance(
            mel, torch.Tensor) else mel, device=self.device)
        return se.speaker_encoder(self.spk_params, self.spk_cfg,
                                  mel[None])[0]

    @torch.inference_mode()
    def encode_reference(self, samples) -> np.ndarray:
        """A reference waveform -> its [frames, 16] codec codes for
        in-context cloning."""
        if self.speech_enc is None:
            raise RuntimeError("speech encoder not loaded")
        x = torch.as_tensor(np.asarray(samples, np.float32) if not
                            isinstance(samples, torch.Tensor) else samples,
                            device=self.device)
        codes = speech_encode(self.speech_enc, self.speech_enc_cfg, x[None])
        return codes[0].to(torch.int32).cpu().numpy()

    @torch.inference_mode()
    def generate_frames_clone(self, ref_text_tokens: List[int],
                              text_tokens: List[int], ref_codes: np.ndarray,
                              spk_embed=None,
                              codec_prefix: Optional[List[int]] = None,
                              max_frames: int = 600
                              ) -> Iterator[np.ndarray]:
        """In-context cloning: text = reference text + target text; the
        reference's codec frames are teacher-forced through the same
        captured step (each written into its code buffer before a replay),
        then generation runs free."""
        tcfg = self.tcfg
        full_text = list(ref_text_tokens) + list(text_tokens)
        codec_prefix = codec_prefix or [tcfg.codec_pad_id] * 4
        n_ref = int(ref_codes.shape[0])
        cap = bucket_length(len(codec_prefix) + 2 + n_ref + max_frames + 8)
        st = self.state(cap)
        self._prefill(st, self.build_prefill(full_text, codec_prefix,
                                             spk_embed))
        ref = torch.as_tensor(np.asarray(ref_codes), dtype=torch.long,
                              device=self.device)
        st.prev_codes.copy_(ref[:1])
        text_pos = 1
        for f in range(1, n_ref):
            st.text_tok.fill_(self._text(full_text, text_pos))
            text_pos += 1
            self.step(st, cap)
            st.prev_codes.copy_(ref[f:f + 1])
        for f in range(max_frames):
            st.text_tok.fill_(self._text(full_text, text_pos))
            text_pos += 1
            codes, _ = self.step(st, cap)
            c = self._host_codes(codes)
            if int(c[0]) == tcfg.codec_eos_id:
                break
            yield c

    def synthesize_voice_clone(self, ref_text_tokens: List[int],
                               text_tokens: List[int], ref_mel=None,
                               ref_samples=None,
                               ref_codes: Optional[np.ndarray] = None,
                               spk_embed=None,
                               max_frames: int = 600) -> GenerationResult:
        """Speaker x-vector (from ``ref_mel``), the reference's codec
        frames (``ref_codes``, or encoded from ``ref_samples``) replayed,
        then the target text."""
        if spk_embed is None and ref_mel is not None:
            spk_embed = self.encode_speaker(ref_mel)
        if ref_codes is None:
            if ref_samples is None:
                raise ValueError("need ref_codes or ref_samples")
            ref_codes = self.encode_reference(ref_samples)
        return _frames_result(list(self.generate_frames_clone(
            ref_text_tokens, text_tokens, ref_codes, spk_embed,
            max_frames=max_frames)))

    def synthesize_voice_clone_instruct(self, ref_text_tokens, text_tokens,
                                        instruct_tokens: List[int],
                                        **kw) -> GenerationResult:
        """Clone plus an instruction: the instruction's tokens go before
        the target text."""
        return self.synthesize_voice_clone(
            ref_text_tokens, list(instruct_tokens) + list(text_tokens), **kw)

    def close(self):
        """Free the captured graphs, their pool and the frame buffers."""
        self.captured.close()
        self._states = {}


# ------------------------------------------------------------------ MRoPE ---

def apply_mrope_tts(x: torch.Tensor, offset, temporal_section: int,
                    base: float = 1e6) -> torch.Tensor:
    """Temporal-only MRoPE with interleaved rotation: the first
    ``temporal_section`` frequency pairs rotate with the position, the
    rest are identity. x: [B, H, L, head_dim]. (Defined, as in the JAX
    package, and not called by the talker.)"""
    B, H, L, hd = x.shape
    half = hd // 2
    inv_freq = 1.0 / (base ** (torch.arange(
        temporal_section, dtype=torch.float32, device=x.device) * 2.0 / hd))
    pos = offset + torch.arange(L, dtype=torch.float32, device=x.device)
    ang = pos[:, None] * inv_freq[None, :]                # [L, ts]
    rest = half - temporal_section
    cos = torch.cat([torch.cos(ang), torch.ones(L, rest, device=x.device)],
                    -1)
    sin = torch.cat([torch.sin(ang), torch.zeros(L, rest, device=x.device)],
                    -1)
    xf = x.float().reshape(B, H, L, half, 2)
    x0, x1 = xf[..., 0], xf[..., 1]                       # interleaved pairs
    r0 = x0 * cos - x1 * sin
    r1 = x0 * sin + x1 * cos
    return torch.stack([r0, r1], -1).reshape(B, H, L, hd).to(x.dtype)


# ------------------------------------------------- speech encoder (clone) ---
#
# A Mimi-style encoder (a SEANet conv encoder, a transformer, a
# downsample, RVQ) that turns reference audio into the 16-codebook frame
# codes the talker takes.

def _enc_res_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = causal_conv1d(p["conv1"], elu(x))                 # C -> C/2, k=3
    h = causal_conv1d(p["conv2"], elu(h))                 # C/2 -> C, k=1
    if "shortcut" in p:
        x = causal_conv1d(p["shortcut"], x)
    return x + h


def _strided_conv(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Causal strided downsampling conv."""
    k = p["w"].shape[1]
    return conv1d(p, x, stride=stride, padding=((k - stride, 0),))


def rvq_encode(codebook: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour codes: x [B, T, D] -> [B, T] int64 (the first
    index of a tie, as ``jnp.argmin``)."""
    d = ((x * x).sum(-1, keepdim=True)
         - 2.0 * torch.matmul(x, codebook.T)
         + (codebook * codebook).sum(-1)[None, None])
    return d.argmin(-1)


def speech_encode(enc: dict, cfg: dict, samples: torch.Tensor):
    """samples [B, T] -> frame codes [B, frames, 16] int64 (split RVQ: a
    semantic codebook and 15 residual acoustic ones). The transformer over
    frames runs each layer as a fresh prefill (K2 on CUDA)."""
    x = samples[..., None].to(enc["init_conv"]["w"].dtype)  # [B, T, 1]
    x = causal_conv1d(enc["init_conv"], x)
    for blk, s in zip(enc["blocks"], cfg["enc_strides"]):
        x = _enc_res_block(blk["res"], x)
        x = _strided_conv(blk["down"], elu(x), s)
    x = causal_conv1d(enc["final_conv"], x)
    x = _transformer_stack(enc["transformer_layers"], enc["_tcfg"], x)
    x = _strided_conv(enc["downsample"], x, 2)            # frame rate / 2
    c0 = rvq_encode(enc["semantic_codebook"],
                    causal_conv1d(enc["semantic_input_proj"], x))
    resid = causal_conv1d(enc["acoustic_input_proj"], x)
    codes = [c0]
    for cb in enc["acoustic_codebooks"]:
        ci = rvq_encode(cb, resid)
        resid = resid - cb[ci]
        codes.append(ci)
    return torch.stack(codes, -1)                         # [B, frames, 16]


def init_speech_encoder(generator: torch.Generator, dim: int = 32,
                        enc_strides=(2, 2), n_transformer: int = 1,
                        num_heads: int = 4, codec_vocab: int = 64,
                        dtype=torch.float32, device=None):
    """Random speech encoder and its static config, the JAX package's
    ``init_speech_encoder`` tree (``_tcfg``: its transformer's config)."""
    device = resolve_device(device)
    _, normal, _ = _initializers(generator, dtype, device)
    cconv = _cconv(normal, dtype, device)
    tcfg = TransformerConfig(
        vocab_size=1, hidden_size=dim, num_layers=1, num_heads=num_heads,
        num_kv_heads=num_heads, head_dim=dim // num_heads,
        intermediate_size=2 * dim)
    enc = {
        "init_conv": cconv(1, dim, 7),
        "blocks": [{"res": {"conv1": cconv(dim, dim // 2, 3),
                            "conv2": cconv(dim // 2, dim, 1)},
                    "down": cconv(dim, dim, 2 * s)} for s in enc_strides],
        "final_conv": cconv(dim, dim, 3),
        "transformer_layers": [
            base.init_params(tcfg, generator, dtype, device)["layers"][0]
            for _ in range(n_transformer)],
        "downsample": cconv(dim, dim, 4),
        "semantic_input_proj": cconv(dim, dim, 1),
        "acoustic_input_proj": cconv(dim, dim, 1),
        "semantic_codebook": normal((codec_vocab, dim), 0.1),
        "acoustic_codebooks": [normal((codec_vocab, dim), 0.1)
                               for _ in range(15)],
        "_tcfg": tcfg,
    }
    return enc, {"enc_strides": tuple(enc_strides)}


# --------------------------------------------------------- server adapter ---

@dataclasses.dataclass
class TTSModel:
    """The server's speech contract: ``synthesize(text, voice)`` ->
    (float32 samples, rate). ``voices``: name -> codec prefix (default
    four pads). ``max_frames`` bounds a request (the JAX package's
    ``synthesize_codes`` default, 600)."""
    synthesizer: Synthesizer
    tokenizer: object = None
    sample_rate: int = 24000
    voices: dict = dataclasses.field(default_factory=dict)
    max_frames: int = 600

    @property
    def device(self):
        return self.synthesizer.device

    def synthesize(self, text: str, voice: Optional[str] = None):
        toks = (self.tokenizer.encode(text) if self.tokenizer
                else [ord(c) % 1000 for c in text])
        tcfg = self.synthesizer.tcfg
        prefix = self.voices.get(voice or "", [tcfg.codec_pad_id] * 4)
        res = self.synthesizer.synthesize_codes(toks, prefix,
                                                self.max_frames)
        if self.synthesizer.codec is None:
            raise RuntimeError("codec decoder weights not loaded")
        wav = self.synthesizer.decode_audio(res.codes)
        return wav.reshape(-1), self.sample_rate

    def close(self):
        self.synthesizer.close()


def load_model(model_dir: str, device=None) -> TTSModel:
    """The canonical save format: tensors under ``talker.*`` (the code
    predictor nested in it) and ``codec.*`` (and ``speaker_encoder.*``,
    ``speech_encoder.*`` where present); config.json with
    ``talker_config`` (its ``transformer`` an HF config, else the top
    level), ``codec_config``, ``sample_rate`` and ``voices``; the
    directory's tokenizer where it has a tokenizer.json. On ``device``
    (default: the current CUDA device)."""
    from ominix_mlx_tpu_torch.utils.loading import (load_config,
                                                    load_safetensors,
                                                    unflatten_params)

    device = resolve_device(device)
    raw = load_config(model_dir)
    tc = raw.get("talker_config", {})
    tcfg = TalkerConfig(
        transformer=TransformerConfig.from_hf(tc.get("transformer", raw)),
        **{k: v for k, v in tc.items()
           if k in TalkerConfig.__dataclass_fields__ and k != "transformer"})
    tree = unflatten_params(load_safetensors(model_dir, device=device))
    tok = None
    if os.path.exists(os.path.join(model_dir, "tokenizer.json")):
        from ominix_mlx_tpu_torch.utils.tokenizer import Tokenizer
        tok = Tokenizer(model_dir)
    syn = Synthesizer(tree["talker"], tcfg, codec_params=tree.get("codec"),
                      codec_cfg=raw.get("codec_config"),
                      spk_params=tree.get("speaker_encoder"),
                      speech_enc=tree.get("speech_encoder"))
    return TTSModel(synthesizer=syn, tokenizer=tok,
                    sample_rate=raw.get("sample_rate", 24000),
                    voices=raw.get("voices", {}))
