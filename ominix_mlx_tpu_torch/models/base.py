"""Generic dense decoder-only transformer (counterpart of
ominix_mlx_tpu/models/base.py): GQA attention with optional QK-RMSNorm,
q/k/v biases, partial and interleaved RoPE, a sliding window, GLM-4's
sandwich norms, SwiGLU MLP, tied or separate lm_head.
Params are nested dicts mirroring HF tensor names; ``forward`` is a
function of (params, cfg, tokens, cache); ``params_from_flat`` builds the
tree from a checkpoint's flat {HF name: tensor} dict.

This port covers the dense / GQA / QK-norm / tied-embedding decoder of
Qwen2, Qwen3, Mistral and GLM-4, its mixture-of-experts form (a layer
holding "moe" runs ``models.moe.moe_block`` in place of the MLP; Mixtral,
GLM-4-MoE and DeepSeek mix leading dense layers with MoE ones),
DeepSeek's latent attention (a layer holding "kv_a_proj_with_mqa" runs
``models.mla.attention_block`` over a latent cache) and Qwen3-Next's
hybrid (a layer holding "linear_attn" runs ``models.deltanet.block`` over
a recurrent cache, ``cfg.layer_types`` names each layer's kind, and an
attention layer holding "g_proj" gates its output), over a dense or
paged KV cache (paged: GQA layers only), with per-row offsets
(continuous batching) and chunked prefill (``kv_limit``). The JAX
package's ring-attention branch is not ported.

The ``init_*`` functions allocate on the current CUDA device unless the
caller names a device (``device="cpu"`` for the CPU).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from ominix_mlx_tpu_torch.core.attention import causal_mask, sdpa
from ominix_mlx_tpu_torch.core.cache import (KVCache, ModelCache,
                                            ingests_padding)
from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.core.paged_cache import PagedKVCache
from ominix_mlx_tpu_torch.core.quant import QuantizedTensor, from_mlx_arrays
from ominix_mlx_tpu_torch.core.rope import (RopeConfig, apply_rope,
                                            make_rope, positions_of)
from ominix_mlx_tpu_torch.nn.layers import (ACTIVATIONS, embedding,
                                            embedding_as_linear, linear,
                                            rms_norm)
from ominix_mlx_tpu_torch.models import deltanet as dn_mod
from ominix_mlx_tpu_torch.models import mla as mla_mod
from ominix_mlx_tpu_torch.models import moe as moe_mod
from ominix_mlx_tpu_torch.ops import flash_attention as fa
from ominix_mlx_tpu_torch.ops import paged_attention as pa
from ominix_mlx_tpu_torch.ops.quant_matmul import (ChannelQuantizedTensor,
                                                   PackedQuantizedTensor,
                                                   channel_quantize, prepare,
                                                   to_panels)


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
    rope_traditional: bool = False     # interleaved-pair rotary (GLM)
    partial_rotary_factor: float = 1.0
    use_qk_norm: bool = False          # Qwen3
    attention_bias: bool = False       # Qwen2 / GLM-4 q/k/v bias
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"
    sliding_window: Optional[int] = None
    moe: Optional[object] = None
    mla: Optional[object] = None
    deltanet: Optional[object] = None  # DeltaNetConfig of "linear_attn"
    # the hybrid layer plan ("linear_attention" / "full_attention" per
    # layer); None: every layer full attention
    layer_types: Optional[tuple] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def rope(self) -> RopeConfig:
        return make_rope(self.hd, self.rope_theta, self.rope_scaling,
                         self.partial_rotary_factor,
                         traditional=self.rope_traditional)

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
    if cfg.deltanet is not None \
            and not isinstance(cfg.deltanet, dn_mod.DeltaNetConfig):
        raise NotImplementedError(
            f"deltanet config {type(cfg.deltanet).__name__}: want "
            f"models.deltanet.DeltaNetConfig")
    if any(lt == "linear_attention" for lt in cfg.layer_types or ()) \
            and cfg.deltanet is None:
        raise ValueError("linear_attention layers need cfg.deltanet")
    if cfg.mla is not None and not isinstance(cfg.mla, mla_mod.MLAConfig):
        raise NotImplementedError(
            f"mla config {type(cfg.mla).__name__}: want models.mla.MLAConfig")
    if cfg.moe is not None and not isinstance(cfg.moe, moe_mod.MoEConfig):
        raise NotImplementedError(
            f"moe config {type(cfg.moe).__name__}: want models.moe.MoEConfig")
    if cfg.hidden_act not in ACTIVATIONS:
        raise NotImplementedError(f"activation {cfg.hidden_act!r}")


# ------------------------------------------------------------ init ----------

def _layer_shapes(cfg: TransformerConfig, moe: bool,
                  linear_attn: bool = False):
    """Projection shapes [out, in] of one layer, by the names that
    ``quantize_params`` quantizes (``PROJ_NAMES``) or leaves dense (MLA's
    "kv_a_proj_with_mqa", "q_a_proj" and "q_b_proj", the hybrid's
    "g_proj"); a MoE layer has no dense MLP, a DeltaNet layer no
    attention (its projections live under "linear_attn"). A hybrid
    config's attention layers carry Qwen3-Next's output gate "g_proj"."""
    hd, D = cfg.hd, cfg.hidden_size
    m = cfg.mla
    if linear_attn:
        shapes = {}
    elif m is None:
        shapes = {"q_proj": (cfg.num_heads * hd, D),
                  "k_proj": (cfg.num_kv_heads * hd, D),
                  "v_proj": (cfg.num_kv_heads * hd, D),
                  "o_proj": (D, cfg.num_heads * hd)}
        if cfg.deltanet is not None:
            shapes["g_proj"] = (cfg.num_heads * hd, D)
    else:
        shapes = {"kv_a_proj_with_mqa": (m.kv_lora_rank
                                         + m.qk_rope_head_dim, D),
                  "o_proj": (D, m.num_heads * m.v_head_dim)}
        if m.q_lora_rank is None:
            shapes["q_proj"] = (m.num_heads * m.qk_head_dim, D)
        else:
            shapes["q_a_proj"] = (m.q_lora_rank, D)
            shapes["q_b_proj"] = (m.num_heads * m.qk_head_dim,
                                  m.q_lora_rank)
    if not moe:
        shapes.update({"gate_proj": (cfg.intermediate_size, D),
                       "up_proj": (cfg.intermediate_size, D),
                       "down_proj": (D, cfg.intermediate_size)})
    return shapes


def _norms(cfg: TransformerConfig, dtype, device,
           linear_attn: bool = False) -> dict:
    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    lp = {"input_layernorm": ones(cfg.hidden_size),
          "post_attention_layernorm": ones(cfg.hidden_size)}
    if linear_attn:
        return lp
    if cfg.use_qk_norm:
        lp["q_norm"] = ones(cfg.hd)
        lp["k_norm"] = ones(cfg.hd)
    if cfg.mla is not None:
        lp["kv_a_layernorm"] = ones(cfg.mla.kv_lora_rank)
        if cfg.mla.q_lora_rank is not None:
            lp["q_a_layernorm"] = ones(cfg.mla.q_lora_rank)
    return lp


def _mla_absorbed(cfg: TransformerConfig, uniform, dtype) -> dict:
    """W_UK and W_UV of a random kv_b_proj [H (nope + v), Ckv]
    (``mla.absorb_kv_b``), in ``dtype``."""
    m = cfg.mla
    kv_b = uniform((m.num_heads * (m.qk_nope_head_dim + m.v_head_dim),
                    m.kv_lora_rank))
    w_uk, w_uv = mla_mod.absorb_kv_b(kv_b, m)
    return {"w_uk": w_uk.to(dtype), "w_uv": w_uv.to(dtype)}


def _is_moe_layer(cfg: TransformerConfig, i: int, dense_layers: int):
    return cfg.moe is not None and i >= dense_layers


def is_linear_layer(cfg: TransformerConfig, i: int) -> bool:
    """Whether layer i is a DeltaNet ("linear_attention") layer."""
    return cfg.layer_types is not None \
        and cfg.layer_types[i] == "linear_attention"


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None,
                dense_layers: int = 0, gated_shared: int = 0) -> dict:
    """Random dense parameter tree (tests and benchmarks): uniform
    +-1/sqrt(in) projections, zero q/k/v biases where ``cfg`` asks for
    them, N(0, 0.02) embedding, unit norms. With ``cfg.moe`` every layer
    from ``dense_layers`` on is a MoE layer (``moe.init_moe_params``), the
    ones before it dense (DeepSeek's and GLM-4-MoE's
    ``first_k_dense_replace``); with ``cfg.mla`` the attention is MLA's
    (W_UK and W_UV folded from a random kv_b_proj); with
    ``cfg.layer_types`` each "linear_attention" layer holds a random
    "linear_attn" tree (``deltanet.init_layer_params``) and each attention
    layer an output gate "g_proj"; ``gated_shared`` > 0 gives each MoE
    layer a shared expert of that width behind a sigmoid gate
    (``moe.init_moe_params``).
    ``device`` defaults to the current CUDA device; the generator must
    live on the same device."""
    _check_supported(cfg)
    device = resolve_device(device)

    def uniform(shape):
        lim = 1.0 / shape[1] ** 0.5
        w = torch.rand(shape, generator=generator, device=device) * 2 - 1
        return (w * lim).to(dtype)

    layers = []
    for i in range(cfg.num_layers):
        moe = _is_moe_layer(cfg, i, dense_layers)
        lin = is_linear_layer(cfg, i)
        lp = _norms(cfg, dtype, device, lin)
        for name, shape in _layer_shapes(cfg, moe, lin).items():
            lp[name] = {"w": uniform(shape)}
            if cfg.attention_bias and name in ("q_proj", "k_proj",
                                               "v_proj") and cfg.mla is None:
                lp[name]["b"] = torch.zeros(shape[0], dtype=dtype,
                                            device=device)
        if lin:
            lp["linear_attn"] = dn_mod.init_layer_params(
                cfg.deltanet, cfg.hidden_size, generator,
                lambda o, n: uniform((o, n)), dtype, device)
        if cfg.mla is not None and not lin:
            lp.update(_mla_absorbed(cfg, uniform, dtype))
        if moe:
            lp["moe"] = moe_mod.init_moe_params(generator, cfg.hidden_size,
                                                cfg.moe, dtype, device,
                                                gated_shared)
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
                          device=None, scheme: str = "group",
                          batched: bool = False,
                          dense_layers: int = 0,
                          gated_shared: int = 0) -> dict:
    """Random quantized tree made directly (never materialises dense
    weights), as ``base.init_quantized_params`` does. scheme="group":
    4- or 8-bit codes uniform in [-2^(bits-1), 2^(bits-1)), scales
    1/(sqrt(in) * 2^(bits-1)), zero biases, row-major (``batched`` marks
    them for the batched-decode formula; ``fuse_layer_projections`` moves
    the eligible ones to panels). scheme="channel8" (w8a8): codes uniform
    in [-127, 127], scale in_f**-0.5 / 127 per output row. Unit norms
    (bf16). With ``cfg.moe`` every layer from ``dense_layers`` on is a
    MoE layer whose experts are made directly in their packed form by the
    same scheme and ranges (``moe.init_quantized_moe_params``: 4- or 8-bit
    group experts or channel-int8 experts, and a shared expert where the
    config has one). With ``cfg.mla``, the projections that
    ``quantize_params`` leaves dense (kv_a_proj_with_mqa, q_a_proj,
    q_b_proj, W_UK, W_UV) are bf16, uniform +-1/sqrt(in). With
    ``cfg.layer_types``, every projection of a "linear_attn" tree and
    each attention layer's "g_proj" are quantized by the same scheme (as
    a quantized checkpoint holds them; ``quantize_params``, as the JAX
    package's, leaves them dense). ``gated_shared``: as in
    ``init_params``. ``device`` defaults to the current CUDA device."""
    _check_supported(cfg)
    device = resolve_device(device)
    if scheme not in ("group", "channel8"):
        raise ValueError(f"scheme {scheme!r}")

    def qrand(out_f, in_f):
        return moe_mod.random_quantized_linear(
            generator, out_f, in_f, group_size, bits, act_bits, device,
            scheme, batched)

    def uniform(shape):
        w = torch.rand(shape, generator=generator, device=device) * 2 - 1
        return (w * shape[1] ** -0.5).to(torch.bfloat16)

    layers = []
    for i in range(cfg.num_layers):
        moe = _is_moe_layer(cfg, i, dense_layers)
        lin = is_linear_layer(cfg, i)
        lp = _norms(cfg, torch.bfloat16, device, lin)
        for name, shape in _layer_shapes(cfg, moe, lin).items():
            lp[name] = {"w": qrand(*shape)
                        if name in PROJ_NAMES or name == "g_proj"
                        else uniform(shape)}
        if lin:
            lp["linear_attn"] = dn_mod.init_layer_params(
                cfg.deltanet, cfg.hidden_size, generator, qrand,
                torch.bfloat16, device)
        if cfg.mla is not None and not lin:
            lp.update(_mla_absorbed(cfg, uniform, torch.bfloat16))
        if moe:
            lp["moe"] = moe_mod.init_quantized_moe_params(
                generator, cfg.hidden_size, cfg.moe, group_size, act_bits,
                device, bits, scheme, gated_shared)
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
                    quantize_embed: bool = True,
                    scheme: str = "group", batched: bool = False) -> dict:
    """Quantize every dense projection weight (and the embedding) of a
    tree; weights already quantized pass through. scheme="group": 4- or
    8-bit group quantization into the packed row-major layout (weights
    whose in-features are not a multiple of the group size stay dense;
    ``batched`` marks them for the batched-decode formula, as the JAX
    package's ``prepare(batched=True)``). scheme="channel8":
    per-output-channel symmetric int8 (w8a8), the batched-serving scheme.
    A MoE layer's stacked experts quantize by the same scheme, into
    ``PackedQuantizedExperts`` (4 or 8 bits) or ``ChannelQuantizedExperts``
    (channel8); its router gate stays dense and its shared expert
    quantizes as plain linears."""
    from ominix_mlx_tpu_torch.core.quant import quantize_tensor

    if scheme not in ("group", "channel8"):
        raise ValueError(f"scheme {scheme!r}")

    def q(w):
        if scheme == "channel8":
            return channel_quantize(w)
        if w.shape[-1] % group_size:
            return w
        return prepare(quantize_tensor(w.float(), group_size, bits),
                       act_bits=act_bits, batched=batched)

    out = dict(params)
    out["layers"] = []
    for lp in params["layers"]:
        nlp = dict(lp)
        for name in PROJ_NAMES:
            if name in nlp and isinstance(nlp[name]["w"], torch.Tensor):
                nlp[name] = {**lp[name], "w": q(lp[name]["w"])}
        if isinstance(nlp.get("moe"), dict):
            m = moe_mod.quantize_experts_params(nlp["moe"], group_size, bits,
                                                scheme, act_bits)
            if isinstance(m.get("shared_expert"), dict):
                m["shared_expert"] = {
                    pn: ({**pv, "w": q(pv["w"])}
                         if isinstance(pv, dict)
                         and isinstance(pv.get("w"), torch.Tensor) else pv)
                    for pn, pv in m["shared_expert"].items()}
            nlp["moe"] = m
        out["layers"].append(nlp)
    if quantize_embed and isinstance(params.get("embed"), torch.Tensor):
        out["embed"] = q(params["embed"])
    if "lm_head" in params and isinstance(params["lm_head"]["w"],
                                          torch.Tensor):
        out["lm_head"] = {**params["lm_head"],
                          "w": q(params["lm_head"]["w"])}
    return out


def _stack_weights(ws: list):
    """Row-concatenate linear weights (dense, packed, channel-quantized or
    plain ``QuantizedTensor``) for fused projections."""
    w0 = ws[0]
    if isinstance(w0, QuantizedTensor):
        return QuantizedTensor(
            q=torch.cat([w.q for w in ws], 0),
            scales=torch.cat([w.scales for w in ws], 0),
            biases=torch.cat([w.biases for w in ws], 0),
            group_size=w0.group_size, bits=w0.bits)
    if isinstance(w0, PackedQuantizedTensor):
        return PackedQuantizedTensor(
            data=torch.cat([w.data for w in ws], 0),
            scales=torch.cat([w.scales for w in ws], 0),
            biases=torch.cat([w.biases for w in ws], 0),
            group_size=w0.group_size, bits=w0.bits,
            in_features=w0.in_features, act_bits=w0.act_bits,
            batched=all(w.batched for w in ws))
    if isinstance(w0, ChannelQuantizedTensor):
        return ChannelQuantizedTensor(
            data=torch.cat([w.data for w in ws], 0),
            scale=torch.cat([w.scale for w in ws], 0))
    return torch.cat(ws, 0)


def _to_panels_tree(node):
    """Mark every packed weight of a tree that the JAX package's
    ``transpose_packed_params`` would re-tile (``ops.quant_matmul.
    to_panels``); batched and ineligible weights stay row-major."""
    if isinstance(node, dict):
        return {k: _to_panels_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_panels_tree(v) for v in node)
    return to_panels(node)


def fuse_layer_projections(params: dict) -> dict:
    """Fuse q/k/v -> qkv_proj and gate/up -> gate_up_proj per layer: one
    weight stream and one kernel launch instead of three / two. Then, as
    the JAX package re-tiles group-quantized weights into its panel layout
    (``transpose_packed_params``), every eligible packed weight of the
    tree, the embedding and the lm_head included, is marked ``panels``:
    a dispatch flag (route "k1" at M=1, "k1_mn" up to 16 rows), the data
    stays as it is. A MoE layer's experts (under "moe") are left as they
    are."""
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
    return _to_panels_tree(out)


# ------------------------------------------------------- forward ------------

def attention_block(lp: dict, cfg: TransformerConfig, x: torch.Tensor,
                    cache, offset, mask: Callable[[], torch.Tensor],
                    rope: RopeConfig, fresh_prefill: bool = False,
                    kv_limit: Optional[int] = None,
                    in_norm: Optional[tuple] = None):
    """GQA attention with optional QK-RMSNorm. x: [B, T, D_model].
    Writes this step's K/V into ``cache`` (dense or paged) in place;
    returns ([B, T, D_model], cache). ``mask()`` builds the additive mask
    for the branches that need one.

    Branches: a fresh prefill runs K2 on CUDA; a continuation chunk
    (``kv_limit``) attends only the first kv_limit cache slots, through K2c
    on CUDA; a one-token step on a paged cache runs K3 on CUDA. On CUDA
    these go to the kernel whatever the shape, and its wrapper raises for
    one it does not take; each takes the model's sliding window (where the
    JAX package computes the masked ``sdpa`` of ``causal_mask(...,
    window)`` instead of its flash kernels). Everything else, and every
    branch off CUDA, is the masked ``sdpa`` (the JAX package's paths off
    the TPU)."""
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
    positions = positions_of(offset, T, x.device)
    q = apply_rope(q, positions, rope)
    k = apply_rope(k, positions, rope)
    cache = cache.update(k, v, offset)
    scale = hd ** -0.5
    window = cfg.sliding_window or 0
    if fresh_prefill and fa.use_flash(T, x.device):
        out = fa.flash_prefill(q, k.to(q.dtype), v.to(q.dtype), scale=scale,
                               window=window)
    elif kv_limit is not None:
        # continuation chunk of a long prefill: attend only the prefix of
        # the cache that can hold written keys, O(kv_limit) per chunk
        pos = kv_limit - T
        if isinstance(offset, int) and offset != pos:
            raise ValueError(f"kv_limit {kv_limit} - T {T} != offset "
                             f"{offset}: a chunk must end at kv_limit")
        ck, cv = cache.k[:, :, :kv_limit], cache.v[:, :, :kv_limit]
        if x.is_cuda:
            out = fa.flash_chunk_prefill(q, ck, cv, pos, scale, window)
        else:
            out = sdpa(q, ck, cv, scale=scale, mask=mask())
    elif T == 1 and isinstance(cache, PagedKVCache) and x.is_cuda:
        # one fused pass over the pages each row's table maps (K3)
        lengths = (offset.to(x.device) if isinstance(offset, torch.Tensor)
                   else torch.full((B,), offset, device=x.device)) + 1
        o = pa.paged_decode_attention(
            q[:, :, 0, :], cache.k_pool, cache.v_pool, cache.page_table,
            lengths, scale, window=window,
            k_scale=cache.k_scale, v_scale=cache.v_scale)
        out = o[:, :, None, :]
    else:
        out = sdpa(q, cache.k, cache.v, scale=scale, mask=mask())
    # attention runs in the cache's type (an int8 page view is bf16): the
    # o_proj input takes the wider of that and the activations' type, as
    # the JAX package's type promotion does
    out = out.transpose(1, 2).reshape(B, T, cfg.num_heads * hd).to(
        torch.promote_types(out.dtype, x.dtype))
    if "g_proj" in lp:      # Qwen3-Next's gated attention output
        out = out * torch.sigmoid(linear(lp["g_proj"], x, norm=in_norm))
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
                  rope, fresh_prefill: bool = False,
                  kv_limit: Optional[int] = None):
    if "linear_attn" in lp:                  # Gated DeltaNet (Qwen3-Next)
        if not isinstance(cfg.deltanet, dn_mod.DeltaNetConfig):
            raise NotImplementedError(
                "a 'linear_attn' layer needs cfg.deltanet, a "
                "models.deltanet.DeltaNetConfig")
        h_in = rms_norm(lp["input_layernorm"], x, cfg.rms_norm_eps)
        h, cache = dn_mod.block(lp["linear_attn"], cfg.deltanet, h_in, cache)
    elif "kv_a_proj_with_mqa" in lp:         # MLA (DeepSeek, GLM-4.7)
        if isinstance(cache, PagedKVCache):
            raise ValueError("MLA layers need a dense latent cache "
                             "(mla.init_cache_layer), not a paged one")
        h_in = rms_norm(lp["input_layernorm"], x, cfg.rms_norm_eps)
        h, cache = mla_mod.attention_block(lp, cfg.mla, h_in, cache, offset,
                                           mask, kv_limit)
    else:
        in_norm = (lp["input_layernorm"], cfg.rms_norm_eps)
        h, cache = attention_block(lp, cfg, x, cache, offset, mask, rope,
                                   fresh_prefill, kv_limit, in_norm=in_norm)
    if "post_self_attn_layernorm" in lp:     # GLM-4 sandwich norm
        h = rms_norm(lp["post_self_attn_layernorm"], h, cfg.rms_norm_eps)
    x = x + h
    if "moe" in lp:
        h2 = rms_norm(lp["post_attention_layernorm"], x, cfg.rms_norm_eps)
        h2 = moe_mod.moe_block(lp["moe"], cfg.moe, h2)
    else:
        h2 = mlp_block(lp, cfg, x, norm=(lp["post_attention_layernorm"],
                                         cfg.rms_norm_eps))
    if "post_mlp_layernorm" in lp:           # GLM-4 sandwich norm
        h2 = rms_norm(lp["post_mlp_layernorm"], h2, cfg.rms_norm_eps)
    return x + h2, cache


def forward(params: dict, cfg: TransformerConfig, tokens: torch.Tensor,
            cache: ModelCache, fresh_prefill: bool = False,
            kv_limit: Optional[int] = None, skip_logits: bool = False):
    """tokens: [B, T] -> (logits [B, T, V], cache advanced by T).

    fresh_prefill=True asserts the cache is empty, so attention may run
    over the fresh tokens alone (kernel K2 on CUDA). kv_limit bounds the
    attended cache prefix of a continuation chunk during chunked prefill
    (kernel K2c on CUDA). skip_logits=True returns the final normed hidden
    states instead of logits (non-final chunks need only the KV writes).
    The KV buffers, and a DeltaNet layer's state and conv window, are
    written in place."""
    return forward_embeds(params, cfg, embedding(params["embed"], tokens),
                          cache, fresh_prefill, kv_limit, skip_logits)


def forward_embeds(params: dict, cfg: TransformerConfig, x: torch.Tensor,
                   cache: ModelCache, fresh_prefill: bool = False,
                   kv_limit: Optional[int] = None,
                   skip_logits: bool = False):
    """Like ``forward`` but takes input embeddings [B, T, D]."""
    _check_supported(cfg)
    if fresh_prefill and (isinstance(cache.offset, torch.Tensor)
                          or cache.offset != 0):
        raise ValueError("fresh_prefill on a cache at offset "
                         f"{cache.offset}")
    T = x.shape[1]
    rope = cfg.rope()
    for lc in cache.layers:
        if not isinstance(lc, (KVCache, PagedKVCache, dn_mod.RecurrentCache)):
            raise NotImplementedError(
                f"{type(lc).__name__} is not ported to the torch package")
    # only positional (KV) layers take a mask; a hybrid's recurrent layers
    # see every position they are given
    caps = [lc.max_len for lc in cache.layers if not ingests_padding(lc)]
    mask = None
    if caps:
        if kv_limit is not None:
            kv_limit = min(kv_limit, caps[0])
        cols = kv_limit if kv_limit is not None else caps[0]
        # built on first use: the kernel branches need no mask
        mask = functools.cache(lambda: causal_mask(
            T, cols, cache.offset, cfg.sliding_window, device=x.device))
    new_layers = []
    for lp, lc in zip(params["layers"], cache.layers):
        x, lc = decoder_layer(lp, cfg, x, lc, cache.offset, mask, rope,
                              fresh_prefill, kv_limit)
        new_layers.append(lc)
    if skip_logits:
        x = rms_norm(params["norm"], x, cfg.rms_norm_eps)
        return x, cache.with_layers(new_layers).advance(T)
    f_norm = (params["norm"], cfg.rms_norm_eps)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        logits = embedding_as_linear(params["embed"], x, norm=f_norm)
    else:
        logits = linear(params["lm_head"], x, norm=f_norm)
    return logits, cache.with_layers(new_layers).advance(T)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> ModelCache:
    """Dense KV cache on ``device`` (default: the current CUDA device):
    with ``cfg.mla``, each layer's latent cache
    (``mla.init_cache_layer``; the JAX package builds that one in
    ``deepseek_v3.init_cache`` only); with ``cfg.layer_types``, the hybrid
    cache, a ``deltanet.RecurrentCache`` for each "linear_attention"
    layer and a ``KVCache`` for the others (the JAX package's
    ``qwen3_next.init_cache``)."""
    if cfg.layer_types is not None:
        return ModelCache(layers=[
            dn_mod.RecurrentCache.init(batch, cfg.deltanet, dtype, device)
            if is_linear_layer(cfg, i) else
            KVCache.init(batch, cfg.num_kv_heads, max_len, cfg.hd, dtype,
                         device)
            for i in range(cfg.num_layers)], offset=0)
    if cfg.mla is not None:
        return ModelCache(layers=[
            mla_mod.init_cache_layer(batch, cfg.mla, max_len, dtype, device)
            for _ in range(cfg.num_layers)], offset=0)
    return ModelCache.init_dense(cfg.num_layers, batch, cfg.num_kv_heads,
                                 max_len, cfg.hd, dtype, device)


def init_paged_cache(cfg: TransformerConfig, batch: int, max_len: int,
                     page_size: int = 128, dtype=torch.bfloat16,
                     quantized: bool = False, device=None) -> ModelCache:
    """Fully backed paged cache with per-row contiguous page tables (page 0
    is the null page): the capacity semantics of ``init_cache``. Decode
    attention runs K3 on CUDA and streams only the pages written so far.
    quantized=True stores int8 pages with per-(head, token) scales. The
    layers share one page-table tensor (updated in place by its owner).
    ``device`` defaults to the current CUDA device. An MLA model raises:
    its latent cache has one shared head whose k and v differ in width,
    and the pool (like the JAX package's) backs GQA layers only; so does
    a hybrid model, whose DeltaNet layers keep a recurrent state."""
    if cfg.mla is not None or cfg.layer_types is not None:
        raise ValueError("a paged cache backs GQA layers; MLA and hybrid "
                         "models use the dense cache (init_cache)")
    device = resolve_device(device)
    if max_len % page_size:
        raise ValueError(f"max_len {max_len} is not a multiple of the page "
                         f"size {page_size}")
    mp = max_len // page_size
    table = (torch.arange(batch * mp, dtype=torch.int32, device=device)
             .reshape(batch, mp) + 1)
    layers = [PagedKVCache.init(batch, cfg.num_kv_heads, batch * mp + 1,
                                page_size, cfg.hd, mp, dtype,
                                page_table=table, quantized=quantized,
                                device=device)
              for _ in range(cfg.num_layers)]
    return ModelCache(layers=layers, offset=0)


# ------------------------------------------------- HF weight loading --------

def _maybe_quantized(flat: dict, prefix: str, qcfg: Optional[dict],
                     device=None):
    """The weight of ``prefix`` on ``device``: dense [out, in], or a
    ``QuantizedTensor`` where the checkpoint carries MLX's {weight (packed
    uint32), scales, biases} (``core.quant.from_mlx_arrays``; group size
    and bits from the config's "quantization", 64 and 4 by default)."""
    if f"{prefix}.scales" in flat:
        gs = qcfg.get("group_size", 64) if qcfg else 64
        bits = qcfg.get("bits", 4) if qcfg else 4
        return from_mlx_arrays(_on(flat[f"{prefix}.weight"], device),
                               _on(flat[f"{prefix}.scales"], device),
                               _on(flat[f"{prefix}.biases"], device), gs,
                               bits)
    return _on(flat[f"{prefix}.weight"], device)


def _on(t: torch.Tensor, device) -> torch.Tensor:
    return t if device is None else t.to(device)


def _linear_params(flat: dict, prefix: str, qcfg, device=None) -> dict:
    p = {"w": _maybe_quantized(flat, prefix, qcfg, device)}
    if f"{prefix}.bias" in flat:
        p["b"] = _on(flat[f"{prefix}.bias"], device)
    return p


def params_from_flat(flat: dict, cfg: TransformerConfig,
                     qcfg: Optional[dict] = None, device=None) -> dict:
    """The parameter tree from a flat {HF name: tensor} dict (HF float
    checkpoints and MLX-quantized ones alike), each tensor moved to
    ``device`` where one is named (else left where it is). GLM-4's
    sandwich norms and its fused ``mlp.gate_up_proj`` are taken where the
    checkpoint carries them."""
    def t(name):
        return _on(flat[name], device)

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        lp = {"input_layernorm": t(f"{p}.input_layernorm.weight"),
              "post_attention_layernorm":
                  t(f"{p}.post_attention_layernorm.weight")}
        for n in ("post_self_attn_layernorm", "post_mlp_layernorm"):
            if f"{p}.{n}.weight" in flat:
                lp[n] = t(f"{p}.{n}.weight")
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            lp[n] = _linear_params(flat, f"{p}.self_attn.{n}", qcfg, device)
        if f"{p}.mlp.gate_up_proj.weight" in flat:
            mlp = ("gate_up_proj", "down_proj")
        elif f"{p}.mlp.down_proj.weight" in flat:
            mlp = ("gate_proj", "up_proj", "down_proj")
        else:
            mlp = ()    # a MoE layer: models.qwen3_moe adds its experts
        for n in mlp:
            lp[n] = _linear_params(flat, f"{p}.mlp.{n}", qcfg, device)
        if cfg.use_qk_norm:
            lp["q_norm"] = t(f"{p}.self_attn.q_norm.weight")
            lp["k_norm"] = t(f"{p}.self_attn.k_norm.weight")
        layers.append(lp)
    params = {"embed": _maybe_quantized(flat, "model.embed_tokens", qcfg,
                                        device),
              "layers": layers, "norm": t("model.norm.weight")}
    if not cfg.tie_word_embeddings and "lm_head.weight" in flat:
        params["lm_head"] = _linear_params(flat, "lm_head", qcfg, device)
    return params
