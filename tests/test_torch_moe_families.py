"""The MoE families the port loads beside Qwen3-MoE: Mixtral, GLM-4-MoE and
DeepSeek-V3 (MLA attention, shared experts, dense first layers). Each is
built as a randomly initialised HF ``transformers`` model (no download);
its state dict goes as one flat float32 dict to both packages'
``params_from_flat``. The port's logits are held against the JAX
package's (1e-4, float32 on the CPU) and both against HF's (3e-3, the
JAX package's own limit, tests/test_model_parity.py); greedy tokens
match the JAX package's. A DeepSeek-style model quantized by the JAX
package (w4a8 group and channel w8a8) and carried across by the bridge
stays within the bounds of
tests/test_torch_model.py::test_quantized_layouts_logits_close_to_jax,
and decodes the same greedy tokens."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import deepseek_v3 as jds
from ominix_mlx_tpu.models import glm4_moe as jglm4_moe
from ominix_mlx_tpu.models import mixtral as jmixtral
from ominix_mlx_tpu.ops import quant_matmul as jqm
from ominix_mlx_tpu_torch.models import base as tbase
from ominix_mlx_tpu_torch.models import deepseek_v3 as tds
from ominix_mlx_tpu_torch.models import glm4_moe as tglm4_moe
from ominix_mlx_tpu_torch.models import mixtral as tmixtral
from ominix_mlx_tpu_torch.ops.quant_matmul import (ChannelQuantizedExperts,
                                                   PackedQuantizedExperts)
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(2)

PORT_TOL = 1e-4
HF_TOL = 3e-3
TOKENS = np.array([[5, 17, 99, 3, 42, 7, 18, 1, 9, 11, 23, 4]])

MIXTRAL = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=96, num_local_experts=4,
               num_experts_per_tok=2)
GLM4_MOE = dict(vocab_size=128, hidden_size=64, num_hidden_layers=3,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                intermediate_size=96, moe_intermediate_size=32,
                n_routed_experts=8, num_experts_per_tok=2,
                n_shared_experts=1, first_k_dense_replace=1,
                norm_topk_prob=True, routed_scaling_factor=1.5, n_group=2,
                topk_group=1, partial_rotary_factor=0.5,
                attention_bias=True, pad_token_id=0)
DEEPSEEK = dict(vocab_size=128, hidden_size=64, num_hidden_layers=3,
                num_attention_heads=4, num_key_value_heads=4,
                intermediate_size=96, moe_intermediate_size=32,
                n_routed_experts=8, num_experts_per_tok=2,
                n_shared_experts=2, first_k_dense_replace=1,
                norm_topk_prob=True, routed_scaling_factor=2.0, n_group=2,
                topk_group=1, q_lora_rank=32, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                head_dim=8, rope_interleave=True, pad_token_id=0)


def _mixtral():
    from transformers import MixtralConfig
    from transformers.models.mixtral import MixtralForCausalLM
    torch.manual_seed(0)
    return MixtralForCausalLM(MixtralConfig(**MIXTRAL)).eval(), "mixtral"


def _glm4_moe():
    from transformers import Glm4MoeConfig
    from transformers.models.glm4_moe import Glm4MoeForCausalLM
    torch.manual_seed(0)
    hf = Glm4MoeForCausalLM(Glm4MoeConfig(**GLM4_MOE)).eval()
    with torch.no_grad():        # make the biases and routing bias bite
        for lyr in hf.model.layers:
            for proj in (lyr.self_attn.q_proj, lyr.self_attn.k_proj,
                         lyr.self_attn.v_proj):
                proj.bias.normal_(0, 0.5)
            gate = getattr(lyr.mlp, "gate", None)
            if gate is not None:
                gate.e_score_correction_bias.normal_(0, 0.1)
    return hf, "glm4_moe"


def _deepseek(q_lora_rank=32):
    from transformers import DeepseekV3Config
    from transformers.models.deepseek_v3 import DeepseekV3ForCausalLM
    torch.manual_seed(0)
    hf = DeepseekV3ForCausalLM(DeepseekV3Config(
        **dict(DEEPSEEK, q_lora_rank=q_lora_rank))).eval()
    with torch.no_grad():
        for lyr in hf.model.layers:
            gate = getattr(lyr.mlp, "gate", None)
            if gate is not None:
                gate.e_score_correction_bias.normal_(0, 0.1)
    return hf, "deepseek_v3"


# family -> (HF model maker, JAX module, port module, params_from_flat takes
# the raw config)
FAMILIES = {
    "mixtral": (_mixtral, jmixtral, tmixtral, False),
    "glm4_moe": (_glm4_moe, jglm4_moe, tglm4_moe, True),
    "deepseek_v3": (_deepseek, jds, tds, True),
    "deepseek_v3_no_q_lora": (lambda: _deepseek(None), jds, tds, True),
}


def _build(name):
    make, jmod, tmod, takes_raw = FAMILIES[name]
    hf, mt = make()
    raw = hf.config.to_dict() | {"model_type": mt}
    sd = {k: v.detach().float() for k, v in hf.state_dict().items()}
    jf = {k: jnp.asarray(v.numpy()) for k, v in sd.items()}
    jcfg, tcfg = jmod.config_from_hf(raw), tmod.config_from_hf(raw)
    jargs, targs = ((raw,), (raw,)) if takes_raw else ((), ())
    jp = jmod.params_from_flat(jf, jcfg, *jargs)
    tp = tmod.params_from_flat(sd, tcfg, *targs, device="cpu")
    return hf, raw, jmod, tmod, jcfg, tcfg, jp, tp


def _caches(jmod, tmod, jcfg, tcfg, dtype_j=jnp.float32,
            dtype_t=torch.float32, max_len=32):
    return (jmod.init_cache(jcfg, 1, max_len, dtype_j),
            tmod.init_cache(tcfg, 1, max_len, dtype_t, device="cpu"))


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_config_from_hf_matches_jax(name):
    """Every field the port's config has equals the JAX package's; the MoE
    and MLA configs field by field."""
    _, _, _, _, jcfg, tcfg, _, _ = _build(name)
    for k, v in _fields(tcfg).items():
        jv = getattr(jcfg, k)
        if k in ("moe", "mla") and v is not None:
            assert _fields(v) == _fields(jv), k
        else:
            assert v == jv, k
    assert (tcfg.mla is None) == (name == "mixtral" or name == "glm4_moe")
    if tcfg.mla is not None:
        assert tcfg.mla.scale == jcfg.mla.scale


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_logits_match_jax_and_hf(name):
    hf, _, jmod, tmod, jcfg, tcfg, jp, tp = _build(name)
    with torch.no_grad():
        want = hf(torch.from_numpy(TOKENS)).logits.numpy()
    jc, tc = _caches(jmod, tmod, jcfg, tcfg)
    jl, _ = jbase.forward(jp, jcfg, jnp.asarray(TOKENS), jc)
    with torch.inference_mode():
        tl, _ = tbase.forward(tp, tcfg, torch.from_numpy(TOKENS), tc)
    jl, tl = np.asarray(jl), tl.numpy()
    np.testing.assert_allclose(tl, jl, rtol=PORT_TOL, atol=PORT_TOL)
    np.testing.assert_allclose(jl, want, rtol=HF_TOL, atol=HF_TOL)
    np.testing.assert_allclose(tl, want, rtol=HF_TOL, atol=HF_TOL)
    if name != "mixtral":          # dense first, then MoE with a shared one
        assert "moe" not in tp["layers"][0] and "down_proj" in tp["layers"][0]
        assert "shared_expert" in tp["layers"][1]["moe"]


def _greedy(jmod, tmod, jcfg, tcfg, jp, tp, steps=8, dtype_j=jnp.float32,
            dtype_t=torch.float32):
    """Greedy tokens and per-call logits of both packages: a prefill of
    TOKENS then ``steps`` one-token steps, each feeding its own argmax."""
    jc, tc = _caches(jmod, tmod, jcfg, tcfg, dtype_j, dtype_t)
    jt, tt = jnp.asarray(TOKENS), torch.from_numpy(TOKENS)
    jout, tout, logits = [], [], []
    for i in range(steps):
        jl, jc = jbase.forward(jp, jcfg, jt, jc, fresh_prefill=i == 0)
        with torch.inference_mode():
            tl, tc = tbase.forward(tp, tcfg, tt, tc, fresh_prefill=i == 0)
        jl = np.asarray(jl, np.float32)
        tl = tl.float().numpy()
        logits.append((jl, tl))
        jn, tn = int(jl[0, -1].argmax()), int(tl[0, -1].argmax())
        jout.append(jn)
        tout.append(tn)
        jt, tt = jnp.asarray([[jn]]), torch.tensor([[tn]])
    return jout, tout, logits


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_greedy_decode_matches_jax(name):
    _, _, jmod, tmod, jcfg, tcfg, jp, tp = _build(name)
    jout, tout, _ = _greedy(jmod, tmod, jcfg, tcfg, jp, tp)
    assert jout == tout


def _to_numpy(tree):
    """JAX param tree -> numpy tree with quantized weights in canonical form
    (stacked 4- or 8-bit experts as a dict with a 3-D ``q``, channel
    weights as {"data", "scale"})."""
    if isinstance(tree, jqm.PackedQuantizedExperts):
        G = tree.in_features // tree.group_size
        if tree.bits == 8:
            q = np.asarray(tree.data)
        else:
            b = np.asarray(tree.data).view(np.uint8).astype(np.int16)
            q = np.concatenate([(b & 15) - 8, (b >> 4) - 8], -1).astype(
                np.int8)
        return {"q": q, "scales": np.asarray(tree.scales)[..., :G],
                "biases": np.asarray(tree.biases)[..., :G],
                "group_size": tree.group_size, "bits": tree.bits}
    if isinstance(tree, jqm.PackedQuantizedTensor):
        u = jqm.unpack(tree)
        return {"q": np.array(u.q), "scales": np.asarray(u.scales),
                "biases": np.asarray(u.biases),
                "group_size": u.group_size, "bits": u.bits}
    if isinstance(tree, (jqm.ChannelQuantizedTensor,
                         jqm.ChannelQuantizedExperts)):
        return {"data": np.asarray(tree.data), "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return np.asarray(tree)


@pytest.mark.parametrize("scheme", ["group", "channel8"])
def test_quantized_deepseek_close_to_jax(scheme):
    """The DeepSeek-style model (a dense first layer, shared experts, MLA
    with q-LoRA) quantized by the JAX package's ``quantize_params``
    (w4a8 group 32, or channel w8a8) and bridged: the same leaves
    quantized (MLA's kv_a_proj_with_mqa, q_a_proj, q_b_proj, W_UK and W_UV
    dense), logits of a 12-token prefill and 5 decode steps within
    rel 0.05 of the JAX package's on bf16 activations (the bound of
    test_quantized_layouts_logits_close_to_jax where activations are
    quantized to int8), and the same greedy tokens."""
    _, _, jmod, tmod, jcfg, _, jp, _ = _build("deepseek_v3")
    jq = jbase.quantize_params(jp, 32, 4, consume=False, scheme=scheme)
    tq = params_from_numpy(_to_numpy(jq), "cpu", dtype=torch.bfloat16)
    tcfg = tds.config_from_hf(dict(DEEPSEEK, model_type="deepseek_v3"))
    lp0, lp1 = tq["layers"][0], tq["layers"][1]
    dense = ("kv_a_proj_with_mqa", "q_a_proj", "q_b_proj")
    assert all(isinstance(lp1[n]["w"], torch.Tensor) for n in dense)
    assert isinstance(lp1["w_uk"], torch.Tensor)
    kind = (PackedQuantizedExperts if scheme == "group"
            else ChannelQuantizedExperts)
    assert isinstance(lp1["moe"]["experts"]["down_proj"], kind)
    assert not isinstance(lp1["moe"]["shared_expert"]["down_proj"]["w"],
                          torch.Tensor)
    assert not isinstance(lp0["down_proj"]["w"], torch.Tensor)
    jout, tout, logits = _greedy(jmod, tmod, jcfg, tcfg, jq, tq, steps=6,
                                 dtype_j=jnp.bfloat16,
                                 dtype_t=torch.bfloat16)
    for jl, tl in logits:
        rel = np.max(np.abs(jl - tl)) / np.max(np.abs(jl))
        assert rel < 0.05, rel
    assert jout == tout


def test_paged_cache_refuses_mla():
    """The paged pool backs GQA layers only, as in the JAX package: an MLA
    config raises in init_paged_cache and in the paged batcher."""
    from ominix_mlx_tpu_torch.serving.batching import PagedContinuousBatcher

    tcfg = tds.config_from_hf(dict(DEEPSEEK, model_type="deepseek_v3"))
    with pytest.raises(ValueError, match="MLA"):
        tbase.init_paged_cache(tcfg, 1, 128, device="cpu")
    with pytest.raises(ValueError, match="MLA"):
        PagedContinuousBatcher(lambda p, t, c: None, {}, tcfg, slots=2,
                               max_len=128, device="cpu")
