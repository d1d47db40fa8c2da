"""MiniCPM-SALA: a long-context hybrid of InfLLMv2 sparse attention
("minicpm4" layers, ``models.sparse_attention``) and lightning linear
attention ("lightning-attn" layers, ``models.lightning``), with muP
scaling (counterpart of ominix_mlx_tpu/models/minicpm_sala.py):
embeddings times ``scale_emb``, each residual branch times scale_depth /
sqrt(L), the final hidden states over hidden_size / dim_model_base before
the lm_head.

Kernels on CUDA: a sparse layer's fresh prefill runs K2, a continuation
chunk (``kv_limit``) or a prefill at an offset K2c, a decode step K11
(``k11_select``, the block scores and their top-k, then ``k11_attend``); a
lightning layer's decode step runs its whole mixer in ``k10_decode``, a
prompt K10 in the form ``k10_plan`` picks; the projections the
quantized-matmul routes. Every
cache is written in place. The JAX signature of ``forward`` is kept
(``num_layers``, the self-speculative draft's prefix; ``fresh_prefill``,
``kv_limit``, ``skip_logits``), so ``Server`` and the engines wire K2 and
K2c as they do for ``models.base``.

Checkpoints: HF names, float or MLX-quantized (``params_from_flat``).
Neither package reads the published ``attn_use_output_gate``,
``lightning_nkv`` or ``mup_denominator``. The random trees
(``init_params``, ``init_quantized_params``) carry unit ``q_norm`` and
``k_norm`` where ``qk_norm`` is set, as a checkpoint holds them; the JAX
``init_params`` makes none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ominix_mlx_tpu_torch.core.attention import causal_mask, sdpa
from ominix_mlx_tpu_torch.core.cache import ModelCache
from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.models import lightning as gla
from ominix_mlx_tpu_torch.models.moe import random_quantized_linear
from ominix_mlx_tpu_torch.models.sparse_attention import (
    SparseConfig, SparseKVCache, sparse_decode_attention)
from ominix_mlx_tpu_torch.nn.layers import (embedding, embedding_as_linear,
                                            linear, rms_norm)
from ominix_mlx_tpu_torch.ops import flash_attention as fa
from ominix_mlx_tpu_torch.ops import lightning_attention as la
from ominix_mlx_tpu_torch.utils.loading import load_config, load_safetensors

__all__ = ["MiniCPMConfig", "forward", "init_cache", "init_params",
           "init_quantized_params", "load_model", "params_from_flat"]

LIGHTNING = "lightning-attn"


@dataclasses.dataclass(frozen=True)
class MiniCPMConfig:
    """Copied from ominix_mlx_tpu/models/minicpm_sala.py:36-106."""
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    mixer_types: tuple
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    scale_emb: float = 12.0
    scale_depth: float = 1.4
    dim_model_base: int = 256
    attn_use_rope: bool = False
    lightning_use_rope: bool = True
    qk_norm: bool = False
    use_output_gate: bool = True
    use_output_norm: bool = True
    lightning_nh: Optional[int] = None
    lightning_head_dim: Optional[int] = None
    sparse: SparseConfig = SparseConfig()
    hidden_act: str = "silu"

    @property
    def res_scale(self) -> float:
        """scale_depth / sqrt(num_layers)."""
        return self.scale_depth / self.num_layers ** 0.5

    @property
    def logits_scale(self) -> float:
        return self.hidden_size / self.dim_model_base

    @property
    def gla_heads(self) -> int:
        return self.lightning_nh or self.num_heads

    @property
    def gla_head_dim(self) -> int:
        return self.lightning_head_dim or self.head_dim

    @staticmethod
    def from_hf(d: dict) -> "MiniCPMConfig":
        sp = d.get("sparse_config") or {}
        return MiniCPMConfig(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            num_kv_heads=d["num_key_value_heads"],
            head_dim=d.get("head_dim",
                           d["hidden_size"] // d["num_attention_heads"]),
            intermediate_size=d["intermediate_size"],
            mixer_types=tuple(d["mixer_types"]),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            rope_theta=d.get("rope_theta", 10000.0),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            scale_emb=d.get("scale_emb", 12.0),
            scale_depth=d.get("scale_depth", 1.4),
            dim_model_base=d.get("dim_model_base", 256),
            attn_use_rope=d.get("attn_use_rope", False),
            lightning_use_rope=d.get("lightning_use_rope", True),
            qk_norm=d.get("qk_norm", False),
            use_output_gate=d.get("use_output_gate", True),
            use_output_norm=d.get("use_output_norm", True),
            lightning_nh=d.get("lightning_nh"),
            lightning_head_dim=d.get("lightning_head_dim"),
            sparse=SparseConfig(**{k: v for k, v in sp.items()
                                   if k in SparseConfig.__dataclass_fields__}),
        )


def init_cache(cfg: MiniCPMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> ModelCache:
    """A ``GLACache`` a lightning layer, a ``SparseKVCache`` of
    ``max_len`` positions a sparse layer, on ``device`` (default: the
    current CUDA device)."""
    device = resolve_device(device)
    return ModelCache(layers=[
        gla.GLACache.init(batch, cfg.gla_heads, cfg.gla_head_dim, device)
        if mt == LIGHTNING else
        SparseKVCache.init(batch, cfg.num_kv_heads, max_len, cfg.head_dim,
                           dtype, cfg.sparse.kernel_size, device)
        for mt in cfg.mixer_types], offset=0)


def _qkv(lp: dict, x: torch.Tensor, nq: int, nkv: int, hd: int):
    """q [B, nq, T, hd], k and v [B, nkv, T, hd] (views of the projections;
    one fused "qkv_proj" or three)."""
    B, T, _ = x.shape
    if "qkv_proj" in lp:
        qkv = linear(lp["qkv_proj"], x)
        q, k, v = qkv.split([nq * hd, nkv * hd, nkv * hd], -1)
    else:
        q, k, v = (linear(lp[n], x) for n in ("q_proj", "k_proj", "v_proj"))
    return (q.reshape(B, T, nq, hd).transpose(1, 2),
            k.reshape(B, T, nkv, hd).transpose(1, 2),
            v.reshape(B, T, nkv, hd).transpose(1, 2))


def _qk_norms(lp, cfg: MiniCPMConfig):
    """(q_norm, k_norm) where the layer normalizes q and k, else (None,
    None)."""
    if cfg.qk_norm and "q_norm" in lp:
        return lp["q_norm"], lp["k_norm"]
    return None, None


def _norm_rope(lp, cfg: MiniCPMConfig, q, k, offset, rope: bool):
    return la.norm_rope(q, k, *_qk_norms(lp, cfg), cfg.rms_norm_eps,
                        cfg.rope_theta if rope else None, offset)


def _sparse_attn(lp, cfg: MiniCPMConfig, x, cache: SparseKVCache, offset,
                 fresh_prefill: bool = False, kv_limit: Optional[int] = None):
    """ominix_mlx_tpu/models/minicpm_sala.py:123-155: QK-norm, no RoPE
    (``attn_use_rope`` false), the cache written in place. A continuation
    chunk (``kv_limit``) attends the written prefix densely even at T = 1
    (InfLLMv2 is a decode policy): K2c on CUDA. A decode step is
    ``sparse_decode_attention`` (K11 on CUDA); a prompt K2 when fresh, K2c
    at an offset, on CUDA; the masked ``sdpa`` elsewhere."""
    B, T, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _qkv(lp, x, H, cfg.num_kv_heads, hd)
    q, k = _norm_rope(lp, cfg, q, k, offset, cfg.attn_use_rope)
    cache = cache.update(k, v, offset)
    scale = hd ** -0.5
    if kv_limit is not None:
        pos = kv_limit - T
        if isinstance(offset, int) and offset != pos:
            raise ValueError(f"kv_limit {kv_limit} - T {T} != offset "
                             f"{offset}: a chunk must end at kv_limit")
        ck, cv = cache.k[:, :, :kv_limit], cache.v[:, :, :kv_limit]
        if x.is_cuda:
            out = fa.flash_chunk_prefill(q, ck, cv, pos, scale)
        else:
            out = sdpa(q, ck, cv, scale,
                       causal_mask(T, kv_limit, offset, device=x.device))
    elif T == 1:
        out = sparse_decode_attention(q, cache, offset, cfg.sparse, scale)
    elif x.is_cuda and isinstance(offset, int):
        if fresh_prefill:
            out = fa.flash_prefill(q, k.to(q.dtype), v.to(q.dtype), scale)
        else:
            end = offset + T
            out = fa.flash_chunk_prefill(q, cache.k[:, :, :end],
                                         cache.v[:, :, :end], offset, scale)
    else:
        out = sdpa(q, cache.k, cache.v, scale,
                   causal_mask(T, cache.max_len, offset, device=x.device))
    out = out.transpose(1, 2).reshape(B, T, H * hd).to(
        torch.promote_types(out.dtype, x.dtype))
    return linear(lp["o_proj"], out), cache


def _lightning_attn(lp, cfg: MiniCPMConfig, x, cache: gla.GLACache, offset):
    """ominix_mlx_tpu/models/minicpm_sala.py:158-184: QK-norm, RoPE, q
    times hd^-0.5 in the activations' type, K10 (the state advanced in
    place), the float32 output cast to x's type, ``o_norm`` over the whole
    width and the gate sigmoid(z_proj(x)). A decode step (T = 1) runs all
    of it between the projections and o_proj as ``lightning_decode``
    (``k10_decode`` on CUDA)."""
    B, T, _ = x.shape
    H, hd = cfg.gla_heads, cfg.gla_head_dim
    q, k, v = _qkv(lp, x, H, H, hd)
    slopes = gla.slopes_on(H, x.device)
    z = (linear(lp["z_proj"], x)
         if cfg.use_output_gate and "z_proj" in lp else None)
    o_norm = lp["o_norm"] if cfg.use_output_norm and "o_norm" in lp \
        else None
    rope_theta = cfg.rope_theta if cfg.lightning_use_rope else None
    if T == 1:
        q_norm, k_norm = _qk_norms(lp, cfg)
        out = la.lightning_decode(q, k, v, slopes, cache.state, z, q_norm,
                                  k_norm, o_norm, cfg.rms_norm_eps,
                                  rope_theta, offset, overlap=True)
        return linear(lp["o_proj"], out), cache
    q, k = _norm_rope(lp, cfg, q, k, offset, cfg.lightning_use_rope)
    q = q * hd ** -0.5
    out = la.lightning_attention(q, k, v, slopes, cache.state)
    out = out.transpose(1, 2).reshape(B, T, H * hd).to(x.dtype)
    if o_norm is not None:
        out = rms_norm(o_norm, out, cfg.rms_norm_eps)
    if z is not None:
        out = out * torch.sigmoid(z)
    return linear(lp["o_proj"], out), cache


def forward(params: dict, cfg: MiniCPMConfig, tokens: torch.Tensor,
            cache: ModelCache, num_layers: Optional[int] = None,
            fresh_prefill: bool = False, kv_limit: Optional[int] = None,
            skip_logits: bool = False):
    """tokens [B, T] -> (logits [B, T, V], cache advanced by T), as the
    JAX package's (ominix_mlx_tpu/models/minicpm_sala.py:187-229).
    num_layers: run only the first N layers (the self-speculative
    draft). fresh_prefill: the cache is empty (K2 in the sparse layers on
    CUDA). kv_limit: a continuation chunk of a long prefill attends the
    first kv_limit cache slots (K2c). skip_logits: return the final
    scaled hidden states instead of logits (non-final chunks)."""
    if fresh_prefill and (isinstance(cache.offset, torch.Tensor)
                          or cache.offset != 0):
        raise ValueError(f"fresh_prefill on a cache at offset "
                         f"{cache.offset}")
    x = embedding(params["embed"], tokens) * cfg.scale_emb
    T = tokens.shape[1]
    rs = cfg.res_scale
    eps = cfg.rms_norm_eps
    n = num_layers if num_layers is not None else cfg.num_layers
    layers = list(cache.layers)
    for i in range(n):
        lp = params["layers"][i]
        h = rms_norm(lp["input_layernorm"], x, eps)
        if cfg.mixer_types[i] == LIGHTNING:
            h, layers[i] = _lightning_attn(lp, cfg, h, layers[i],
                                           cache.offset)
        else:
            h, layers[i] = _sparse_attn(lp, cfg, h, layers[i], cache.offset,
                                        fresh_prefill, kv_limit)
        x = x + h * rs
        h = base.mlp_block(lp, cfg, x,
                           norm=(lp["post_attention_layernorm"], eps))
        x = x + h * rs
    x = rms_norm(params["norm"], x, eps) / cfg.logits_scale
    out = cache.with_layers(layers).advance(T)
    if skip_logits:
        return x, out
    if cfg.tie_word_embeddings or "lm_head" not in params:
        return embedding_as_linear(params["embed"], x), out
    return linear(params["lm_head"], x), out


# ------------------------------------------------------------ init ----------

def _layer_shapes(cfg: MiniCPMConfig, mixer: str) -> dict:
    """[out, in] of each projection of a layer of kind ``mixer``."""
    D = cfg.hidden_size
    if mixer == LIGHTNING:
        w = cfg.gla_heads * cfg.gla_head_dim
        shapes = {"q_proj": (w, D), "k_proj": (w, D), "v_proj": (w, D),
                  "o_proj": (D, w), "z_proj": (w, D)}
    else:
        q, kv = (cfg.num_heads * cfg.head_dim,
                 cfg.num_kv_heads * cfg.head_dim)
        shapes = {"q_proj": (q, D), "k_proj": (kv, D), "v_proj": (kv, D),
                  "o_proj": (D, q)}
    I = cfg.intermediate_size
    shapes.update({"gate_proj": (I, D), "up_proj": (I, D),
                   "down_proj": (D, I)})
    return shapes


def _norms(cfg: MiniCPMConfig, mixer: str, dtype, device) -> dict:
    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    D = cfg.hidden_size
    lp = {"input_layernorm": ones(D), "post_attention_layernorm": ones(D)}
    hd = cfg.gla_head_dim if mixer == LIGHTNING else cfg.head_dim
    if cfg.qk_norm:
        lp["q_norm"], lp["k_norm"] = ones(hd), ones(hd)
    if mixer == LIGHTNING:
        lp["o_norm"] = ones(cfg.gla_heads * cfg.gla_head_dim)
    return lp


def _tree(cfg: MiniCPMConfig, make, dtype, device, embed) -> dict:
    layers = []
    for mt in cfg.mixer_types:
        lp = _norms(cfg, mt, dtype, device)
        for name, (o, i) in _layer_shapes(cfg, mt).items():
            lp[name] = {"w": make(o, i)}
        layers.append(lp)
    params = {"embed": embed, "layers": layers,
              "norm": torch.ones(cfg.hidden_size, dtype=dtype,
                                 device=device)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": make(cfg.vocab_size, cfg.hidden_size)}
    return params


def init_params(cfg: MiniCPMConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> dict:
    """Random dense tree (tests and benchmarks), the JAX ``init_params``'
    layout (ominix_mlx_tpu/models/minicpm_sala.py:232-271): projections
    uniform +-1/sqrt(in), N(0, 0.02) embedding, unit norms, with unit
    q_norm / k_norm where ``qk_norm`` is set and an lm_head where the
    embeddings are not tied. ``device`` defaults to the current CUDA
    device; the generator must live there."""
    device = resolve_device(device)

    def uniform(out_f, in_f):
        w = torch.rand((out_f, in_f), generator=generator, device=device)
        return ((w * 2 - 1) * in_f ** -0.5).to(dtype)

    embed = torch.randn((cfg.vocab_size, cfg.hidden_size),
                        generator=generator, device=device) * 0.02
    return _tree(cfg, uniform, dtype, device, embed.to(dtype))


def init_quantized_params(cfg: MiniCPMConfig, generator: torch.Generator,
                          group_size: int = 64, bits: int = 8,
                          act_bits: Optional[int] = 8, device=None) -> dict:
    """Random quantized tree made packed at full width, never dense (w8a8
    g64 by default): every projection, the embedding and the lm_head
    group-quantized (``moe.random_quantized_linear``), the norms bf16 ones.
    ``base.fuse_layer_projections`` fuses q/k/v and gate/up and moves the
    eligible weights to panels."""
    device = resolve_device(device)

    def qrand(out_f, in_f):
        return random_quantized_linear(generator, out_f, in_f, group_size,
                                       bits, act_bits, device)

    return _tree(cfg, qrand, torch.bfloat16, device,
                 qrand(cfg.vocab_size, cfg.hidden_size))


# ------------------------------------------------- HF weight loading --------

def params_from_flat(flat: dict, cfg: MiniCPMConfig, qcfg=None,
                     device=None) -> dict:
    """The tree from a flat {HF name: tensor} dict (float or
    MLX-quantized), each tensor moved to ``device`` where one is named
    (ominix_mlx_tpu/models/minicpm_sala.py:274-310): q/k/v/o under
    ``self_attn`` with its optional q_norm / k_norm, a lightning layer's
    o_norm and z_proj, the MLP, the final norm and the untied lm_head."""
    def t(name):
        return base._on(flat[name], device)

    def lin(name):
        return base._linear_params(flat, name, qcfg, device)

    layers = []
    for i, mt in enumerate(cfg.mixer_types):
        p = f"model.layers.{i}"
        a = f"{p}.self_attn"
        lp = {"input_layernorm": t(f"{p}.input_layernorm.weight"),
              "post_attention_layernorm":
                  t(f"{p}.post_attention_layernorm.weight")}
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            lp[n] = lin(f"{a}.{n}")
        for n in ("q_norm", "k_norm"):
            if f"{a}.{n}.weight" in flat:
                lp[n] = t(f"{a}.{n}.weight")
        if mt == LIGHTNING:
            if f"{a}.o_norm.weight" in flat:
                lp["o_norm"] = t(f"{a}.o_norm.weight")
            if f"{a}.z_proj.weight" in flat:
                lp["z_proj"] = lin(f"{a}.z_proj")
        for n in ("gate_proj", "up_proj", "down_proj"):
            lp[n] = lin(f"{p}.mlp.{n}")
        layers.append(lp)
    params = {"embed": base._maybe_quantized(flat, "model.embed_tokens",
                                             qcfg, device),
              "layers": layers, "norm": t("model.norm.weight")}
    if not cfg.tie_word_embeddings and "lm_head.weight" in flat:
        params["lm_head"] = lin("lm_head")
    return params


def load_model(model_dir: str, device=None):
    """A MiniCPM-SALA checkpoint directory -> (params, config), on
    ``device`` (default: the current CUDA device)."""
    device = resolve_device(device)
    raw = load_config(model_dir)
    cfg = MiniCPMConfig.from_hf(raw)
    return params_from_flat(load_safetensors(model_dir), cfg,
                            raw.get("quantization"), device), cfg
