"""DeepSeek-V3 / V2 and GLM-4.7-Flash (counterpart of
ominix_mlx_tpu/models/deepseek_v3.py): absorbed MLA attention
(``models.mla``) over a latent cache, ``first_k_dense_replace`` dense
layers first, then MoE layers with a shared expert, routed by sigmoid
scores plus ``e_score_correction_bias`` with group-limited top-k
(``glm4_moe.moe_from_flat``). q is a plain ``q_proj`` or a q-LoRA
(``q_a_proj``, ``q_a_layernorm``, ``q_b_proj``); ``kv_b_proj`` is folded
into W_UK and W_UV at load (``mla.absorb_kv_b``).

The JAX package's quirks are kept as they are: every checkpoint routes by
sigmoid with the correction bias (a DeepSeek-V2 checkpoint, which routes
by softmax and has no correction bias, raises KeyError in
``params_from_flat``), and ``routed_scaling_factor`` defaults to 2.5."""

from __future__ import annotations

import dataclasses

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.models.base import TransformerConfig
from ominix_mlx_tpu_torch.models.glm4_moe import moe_from_flat
from ominix_mlx_tpu_torch.models.mla import MLAConfig, absorb_kv_b
from ominix_mlx_tpu_torch.models.moe import EXPERT_NAMES, MoEConfig
from ominix_mlx_tpu_torch.utils.loading import load_config, load_safetensors

__all__ = ["config_from_hf", "forward", "init_cache", "load_model",
           "params_from_flat"]


def config_from_hf(d: dict) -> TransformerConfig:
    cfg = TransformerConfig.from_hf(d)
    mcfg = MLAConfig(
        num_heads=d["num_attention_heads"],
        q_lora_rank=d.get("q_lora_rank"),
        kv_lora_rank=d.get("kv_lora_rank", 512),
        qk_nope_head_dim=d.get("qk_nope_head_dim", 128),
        qk_rope_head_dim=d.get("qk_rope_head_dim", 64),
        v_head_dim=d.get("v_head_dim", 128),
        rope_theta=d.get("rope_theta", 10000.0),
        rope_interleave=d.get("rope_interleave", True),
        rope_scaling=d.get("rope_scaling"),
        rms_norm_eps=d.get("rms_norm_eps", 1e-6),
    )
    moe = MoEConfig(
        num_experts=d.get("n_routed_experts", 256),
        top_k=d.get("num_experts_per_tok", 8),
        norm_topk_prob=d.get("norm_topk_prob", True),
        routing="sigmoid",
        routed_scaling_factor=d.get("routed_scaling_factor", 2.5),
        n_shared_experts=d.get("n_shared_experts", 1),
        moe_intermediate_size=d.get("moe_intermediate_size", 2048),
        hidden_act=d.get("hidden_act", "silu"),
        n_group=d.get("n_group", 1),
        topk_group=d.get("topk_group", 1),
    )
    return dataclasses.replace(cfg, mla=mcfg, moe=moe)


def params_from_flat(flat: dict, cfg: TransformerConfig, d: dict,
                     qcfg=None, device=None) -> dict:
    """The tree from a flat {HF name: tensor} dict, each tensor moved to
    ``device`` where one is named."""
    def t(name):
        return base._on(flat[name], device)

    def lin(name):
        return base._linear_params(flat, name, qcfg, device)

    mcfg: MLAConfig = cfg.mla
    first_dense = d.get("first_k_dense_replace", 0)
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        a = f"{p}.self_attn"
        lp = {"input_layernorm": t(f"{p}.input_layernorm.weight"),
              "post_attention_layernorm":
                  t(f"{p}.post_attention_layernorm.weight"),
              "kv_a_proj_with_mqa": lin(f"{a}.kv_a_proj_with_mqa"),
              "kv_a_layernorm": t(f"{a}.kv_a_layernorm.weight"),
              "o_proj": lin(f"{a}.o_proj")}
        if mcfg.q_lora_rank is None:
            lp["q_proj"] = lin(f"{a}.q_proj")
        else:
            lp["q_a_proj"] = lin(f"{a}.q_a_proj")
            lp["q_a_layernorm"] = t(f"{a}.q_a_layernorm.weight")
            lp["q_b_proj"] = lin(f"{a}.q_b_proj")
        lp["w_uk"], lp["w_uv"] = absorb_kv_b(t(f"{a}.kv_b_proj.weight"),
                                             mcfg)
        if i < first_dense or f"{p}.mlp.gate_proj.weight" in flat:
            for n in EXPERT_NAMES:
                lp[n] = lin(f"{p}.mlp.{n}")
        else:
            lp["moe"] = moe_from_flat(flat, f"{p}.mlp", cfg.moe.num_experts,
                                      device)
        layers.append(lp)
    params = {"embed": base._maybe_quantized(flat, "model.embed_tokens", qcfg,
                                             device),
              "norm": t("model.norm.weight"), "layers": layers}
    if not cfg.tie_word_embeddings and "lm_head.weight" in flat:
        params["lm_head"] = lin("lm_head")
    return params


def load_model(model_dir: str, device=None):
    """A checkpoint directory -> (params, config), on ``device`` (default:
    the current CUDA device)."""
    device = resolve_device(device)
    raw = load_config(model_dir)
    cfg = config_from_hf(raw)
    return params_from_flat(load_safetensors(model_dir), cfg, raw,
                            raw.get("quantization"), device), cfg


forward = base.forward
# the latent caches (mla.init_cache_layer): kv_lora_rank + qk_rope_head_dim
# numbers a token a layer, 576 at DeepSeek's widths
init_cache = base.init_cache
