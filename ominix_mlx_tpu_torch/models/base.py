"""Generic dense decoder-only transformer (counterpart of
ominix_mlx_tpu/models/base.py): GQA attention with optional QK-RMSNorm,
SwiGLU MLP, tied or separate lm_head. Params are nested dicts mirroring HF
tensor names; ``forward`` is a function of (params, cfg, tokens, cache).

This port covers the dense / GQA / QK-norm / tied-embedding decoder. The
JAX package's MoE, MLA, DeltaNet, paged-cache and ring-attention branches
raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ominix_mlx_tpu_torch.core.attention import causal_mask, sdpa
from ominix_mlx_tpu_torch.core.cache import KVCache, ModelCache
from ominix_mlx_tpu_torch.core.quant import QuantizedTensor
from ominix_mlx_tpu_torch.core.rope import RopeConfig, apply_rope, make_rope
from ominix_mlx_tpu_torch.nn.layers import (ACTIVATIONS, embedding,
                                            embedding_as_linear, linear,
                                            rms_norm)
from ominix_mlx_tpu_torch.ops import flash_attention as fa
from ominix_mlx_tpu_torch.ops.quant_matmul import (PackedQuantizedTensor,
                                                   prepare)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    intermediate_size: int
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    partial_rotary_factor: float = 1.0
    use_qk_norm: bool = False
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"
    sliding_window: Optional[int] = None
    moe: Optional[object] = None
    mla: Optional[object] = None
    deltanet: Optional[object] = None
    layer_types: Optional[tuple] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def rope(self) -> RopeConfig:
        return make_rope(self.hd, self.rope_theta, self.rope_scaling,
                         self.partial_rotary_factor)

    @staticmethod
    def from_hf(d: dict) -> "TransformerConfig":
        """Build from an HF config.json dict."""
        return TransformerConfig(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads",
                               d["num_attention_heads"]),
            intermediate_size=d["intermediate_size"],
            head_dim=d.get("head_dim"),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            rope_theta=d.get("rope_theta", 10000.0),
            rope_scaling=d.get("rope_scaling"),
            partial_rotary_factor=d.get("partial_rotary_factor", 1.0),
            use_qk_norm=d.get("model_type") in ("qwen3", "qwen3_moe"),
            attention_bias=d.get("attention_bias",
                                 d.get("model_type") == "qwen2"),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            hidden_act=d.get("hidden_act", "silu"),
            sliding_window=(d.get("sliding_window")
                            if d.get("use_sliding_window", False) else None),
        )


def _check_supported(cfg: TransformerConfig):
    for name in ("moe", "mla", "deltanet", "layer_types"):
        if getattr(cfg, name) is not None:
            raise NotImplementedError(
                f"{name} layers are not ported to the torch package yet")
    if cfg.hidden_act not in ACTIVATIONS:
        raise NotImplementedError(f"activation {cfg.hidden_act!r}")


# ------------------------------------------------------------ init ----------

def _layer_shapes(cfg: TransformerConfig):
    hd, D = cfg.hd, cfg.hidden_size
    return {"q_proj": (cfg.num_heads * hd, D),
            "k_proj": (cfg.num_kv_heads * hd, D),
            "v_proj": (cfg.num_kv_heads * hd, D),
            "o_proj": (D, cfg.num_heads * hd),
            "gate_proj": (cfg.intermediate_size, D),
            "up_proj": (cfg.intermediate_size, D),
            "down_proj": (D, cfg.intermediate_size)}


def _norms(cfg: TransformerConfig, dtype, device) -> dict:
    lp = {"input_layernorm": torch.ones(cfg.hidden_size, dtype=dtype,
                                        device=device),
          "post_attention_layernorm": torch.ones(cfg.hidden_size,
                                                 dtype=dtype, device=device)}
    if cfg.use_qk_norm:
        lp["q_norm"] = torch.ones(cfg.hd, dtype=dtype, device=device)
        lp["k_norm"] = torch.ones(cfg.hd, dtype=dtype, device=device)
    return lp


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> dict:
    """Random dense parameter tree (tests and benchmarks): uniform
    +-1/sqrt(in) projections, N(0, 0.02) embedding, unit norms."""
    _check_supported(cfg)

    def uniform(shape):
        lim = 1.0 / shape[1] ** 0.5
        w = torch.rand(shape, generator=generator, device=device) * 2 - 1
        return (w * lim).to(dtype)

    layers = []
    for _ in range(cfg.num_layers):
        lp = _norms(cfg, dtype, device)
        for name, shape in _layer_shapes(cfg).items():
            lp[name] = {"w": uniform(shape)}
            if cfg.attention_bias and name in ("q_proj", "k_proj",
                                               "v_proj"):
                lp[name]["b"] = torch.zeros(shape[0], dtype=dtype,
                                            device=device)
        layers.append(lp)
    embed = torch.randn((cfg.vocab_size, cfg.hidden_size),
                        generator=generator, device=device) * 0.02
    params = {"embed": embed.to(dtype), "layers": layers,
              "norm": torch.ones(cfg.hidden_size, dtype=dtype,
                                 device=device)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": uniform((cfg.vocab_size,
                                           cfg.hidden_size))}
    return params


def init_quantized_params(cfg: TransformerConfig, generator: torch.Generator,
                          group_size: int = 64, bits: int = 4,
                          act_bits: Optional[int] = 8,
                          device=None) -> dict:
    """Random quantized tree made directly (never materialises dense
    weights), as ``base.init_quantized_params`` does: uniform codes in
    [-2^(bits-1), 2^(bits-1)), scales 1/(sqrt(in) * 2^(bits-1)), zero
    biases, unit norms (bf16)."""
    _check_supported(cfg)
    lim = 1 << (bits - 1)

    def qrand(out_f, in_f):
        q = torch.randint(-lim, lim, (out_f, in_f), generator=generator,
                          device=device, dtype=torch.int8)
        G = in_f // group_size
        qt = QuantizedTensor(
            q=q,
            scales=torch.full((out_f, G), (in_f ** -0.5) / lim,
                              dtype=torch.bfloat16, device=device),
            biases=torch.zeros((out_f, G), dtype=torch.bfloat16,
                               device=device),
            group_size=group_size, bits=bits)
        return prepare(qt, act_bits=act_bits)

    layers = []
    for _ in range(cfg.num_layers):
        lp = _norms(cfg, torch.bfloat16, device)
        for name, shape in _layer_shapes(cfg).items():
            lp[name] = {"w": qrand(*shape)}
        layers.append(lp)
    params = {"embed": qrand(cfg.vocab_size, cfg.hidden_size),
              "layers": layers,
              "norm": torch.ones(cfg.hidden_size, dtype=torch.bfloat16,
                                 device=device)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": qrand(cfg.vocab_size, cfg.hidden_size)}
    return params


PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
              "gate_proj", "up_proj", "down_proj",
              "qkv_proj", "gate_up_proj")


def quantize_params(params: dict, group_size: int = 64, bits: int = 4,
                    act_bits: Optional[int] = 8,
                    quantize_embed: bool = True) -> dict:
    """Group-quantize every projection weight (and the embedding) of a
    dense tree into the kernel layout. Weights whose in-features are not a
    multiple of the group size stay dense."""
    from ominix_mlx_tpu_torch.core.quant import quantize_tensor

    def q(w):
        if w.shape[-1] % group_size:
            return w
        return prepare(quantize_tensor(w.float(), group_size, bits),
                       act_bits=act_bits)

    out = dict(params)
    out["layers"] = []
    for lp in params["layers"]:
        nlp = dict(lp)
        for name in PROJ_NAMES:
            if name in nlp and isinstance(nlp[name]["w"], torch.Tensor):
                nlp[name] = {**lp[name], "w": q(lp[name]["w"])}
        out["layers"].append(nlp)
    if quantize_embed and isinstance(params.get("embed"), torch.Tensor):
        out["embed"] = q(params["embed"])
    if "lm_head" in params:
        out["lm_head"] = {**params["lm_head"],
                          "w": q(params["lm_head"]["w"])}
    return out


def _stack_weights(ws: list):
    """Row-concatenate linear weights (dense or packed) for fused
    projections."""
    w0 = ws[0]
    if isinstance(w0, PackedQuantizedTensor):
        return PackedQuantizedTensor(
            data=torch.cat([w.data for w in ws], 0),
            scales=torch.cat([w.scales for w in ws], 0),
            biases=torch.cat([w.biases for w in ws], 0),
            group_size=w0.group_size, bits=w0.bits,
            in_features=w0.in_features, act_bits=w0.act_bits)
    return torch.cat(ws, 0)


def fuse_layer_projections(params: dict) -> dict:
    """Fuse q/k/v -> qkv_proj and gate/up -> gate_up_proj per layer: one
    weight stream and one kernel launch instead of three / two."""
    out = dict(params)
    out["layers"] = []
    for lp in params["layers"]:
        nlp = dict(lp)
        for fused, names in (("qkv_proj", ("q_proj", "k_proj", "v_proj")),
                             ("gate_up_proj", ("gate_proj", "up_proj"))):
            if all(k in nlp for k in names):
                parts = [nlp.pop(k) for k in names]
                f = {"w": _stack_weights([p["w"] for p in parts])}
                if all("b" in p for p in parts):
                    f["b"] = torch.cat([p["b"] for p in parts], 0)
                nlp[fused] = f
        out["layers"].append(nlp)
    return out


# ------------------------------------------------------- forward ------------

def attention_block(lp: dict, cfg: TransformerConfig, x: torch.Tensor,
                    cache: KVCache, offset: int, mask, rope: RopeConfig,
                    fresh_prefill: bool = False,
                    in_norm: Optional[tuple] = None):
    """GQA attention with optional QK-RMSNorm. x: [B, T, D_model].
    Writes this step's K/V into ``cache`` in place; returns
    ([B, T, D_model], cache)."""
    B, T, _ = x.shape
    hd = cfg.hd
    if "qkv_proj" in lp:
        qkv = linear(lp["qkv_proj"], x, norm=in_norm)
        qd = cfg.num_heads * hd
        kvd = cfg.num_kv_heads * hd
        q, k, v = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
    else:
        q = linear(lp["q_proj"], x, norm=in_norm)
        k = linear(lp["k_proj"], x, norm=in_norm)
        v = linear(lp["v_proj"], x, norm=in_norm)
    q = q.reshape(B, T, cfg.num_heads, hd)
    k = k.reshape(B, T, cfg.num_kv_heads, hd)
    v = v.reshape(B, T, cfg.num_kv_heads, hd)
    if cfg.use_qk_norm:
        q = rms_norm(lp["q_norm"], q, cfg.rms_norm_eps)
        k = rms_norm(lp["k_norm"], k, cfg.rms_norm_eps)
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    positions = offset + torch.arange(T, device=x.device)
    q = apply_rope(q, positions, rope)
    k = apply_rope(k, positions, rope)
    cache = cache.update(k, v, offset)
    if fresh_prefill and fa.use_flash(T, hd, x.device) \
            and cfg.sliding_window is None:
        out = fa.flash_prefill(q, k.to(q.dtype), v.to(q.dtype),
                               scale=hd ** -0.5)
    else:
        out = sdpa(q, cache.k, cache.v, scale=hd ** -0.5, mask=mask)
    out = out.transpose(1, 2).reshape(B, T, cfg.num_heads * hd)
    return linear(lp["o_proj"], out), cache


def mlp_block(lp: dict, cfg: TransformerConfig, x: torch.Tensor,
              norm: Optional[tuple] = None) -> torch.Tensor:
    act = ACTIVATIONS[cfg.hidden_act]
    if "gate_up_proj" in lp:
        gu = linear(lp["gate_up_proj"], x, norm=norm)
        gate, up = gu.chunk(2, -1)
        return linear(lp["down_proj"], act(gate) * up)
    return linear(lp["down_proj"],
                  act(linear(lp["gate_proj"], x, norm=norm))
                  * linear(lp["up_proj"], x, norm=norm))


def decoder_layer(lp: dict, cfg: TransformerConfig, x, cache, offset, mask,
                  rope, fresh_prefill: bool = False):
    for key in ("linear_attn", "kv_a_proj_with_mqa", "moe",
                "post_self_attn_layernorm", "post_mlp_layernorm"):
        if key in lp:
            raise NotImplementedError(
                f"{key!r} layers are not ported to the torch package yet")
    in_norm = (lp["input_layernorm"], cfg.rms_norm_eps)
    h, cache = attention_block(lp, cfg, x, cache, offset, mask, rope,
                               fresh_prefill, in_norm=in_norm)
    x = x + h
    return x + mlp_block(lp, cfg, x, norm=(lp["post_attention_layernorm"],
                                           cfg.rms_norm_eps)), cache


def forward(params: dict, cfg: TransformerConfig, tokens: torch.Tensor,
            cache: ModelCache, fresh_prefill: bool = False):
    """tokens: [B, T] -> (logits [B, T, V], cache advanced by T).

    fresh_prefill=True asserts the cache is empty, so attention may run
    over the fresh tokens alone (kernel K2 on CUDA). The KV buffers are
    written in place."""
    return forward_embeds(params, cfg, embedding(params["embed"], tokens),
                          cache, fresh_prefill)


def forward_embeds(params: dict, cfg: TransformerConfig, x: torch.Tensor,
                   cache: ModelCache, fresh_prefill: bool = False):
    """Like ``forward`` but takes input embeddings [B, T, D]."""
    _check_supported(cfg)
    if fresh_prefill and cache.offset != 0:
        raise ValueError("fresh_prefill on a cache at offset "
                         f"{cache.offset}")
    T = x.shape[1]
    rope = cfg.rope()
    cap = cache.layers[0].max_len
    mask = causal_mask(T, cap, cache.offset, cfg.sliding_window,
                       device=x.device)
    new_layers = []
    for lp, lc in zip(params["layers"], cache.layers):
        if not isinstance(lc, KVCache):
            raise NotImplementedError(
                f"{type(lc).__name__} is not ported to the torch package")
        x, lc = decoder_layer(lp, cfg, x, lc, cache.offset, mask, rope,
                              fresh_prefill)
        new_layers.append(lc)
    f_norm = (params["norm"], cfg.rms_norm_eps)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        logits = embedding_as_linear(params["embed"], x, norm=f_norm)
    else:
        logits = linear(params["lm_head"], x, norm=f_norm)
    return logits, cache.with_layers(new_layers).advance(T)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> ModelCache:
    return ModelCache.init_dense(cfg.num_layers, batch, cfg.num_kv_heads,
                                 max_len, cfg.hd, dtype, device)
