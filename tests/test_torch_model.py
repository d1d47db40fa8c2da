"""Slice parity: the whole Qwen3-style decoder (fused projections, QK-norm,
tied embedding) in ominix_mlx_tpu_torch against ominix_mlx_tpu on the same
weights, carried across as numpy by ``utils.params.params_from_numpy``.

Tiny config: vocab 512, hidden 256 (the smallest width the JAX package
re-tiles into its main-path tn layout), 2 layers, 4 query / 2 KV heads of
dim 64, FFN 512."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core.generate import Engine as JEngine
from ominix_mlx_tpu.core.sampling import SamplerConfig as JSampler
from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.ops import quant_matmul as jqm
from ominix_mlx_tpu_torch.core.generate import Engine as TEngine
from ominix_mlx_tpu_torch.core.sampling import SamplerConfig as TSampler
from ominix_mlx_tpu_torch.models import base as tbase
from ominix_mlx_tpu_torch.models import qwen3 as tqwen3
from ominix_mlx_tpu_torch.ops import quant_matmul as tqm
from ominix_mlx_tpu_torch.ops.quant_matmul import PackedQuantizedTensor
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(2)

HF = {"model_type": "qwen3", "vocab_size": 512, "hidden_size": 256,
      "num_hidden_layers": 2, "num_attention_heads": 4,
      "num_key_value_heads": 2, "head_dim": 64, "intermediate_size": 512,
      "rope_theta": 1e6, "rms_norm_eps": 1e-6, "tie_word_embeddings": True}
JCFG = jbase.TransformerConfig.from_hf(HF)
TCFG = tqwen3.config_from_hf(HF)


def _to_numpy(tree):
    """JAX param tree -> numpy tree; packed weights in canonical form with
    their dispatch flags (batched, tn)."""
    if isinstance(tree, jqm.PackedQuantizedTensor):
        u = jqm.unpack(tree)
        return {"q": np.array(u.q), "scales": np.asarray(u.scales),
                "biases": np.asarray(u.biases),
                "group_size": u.group_size, "bits": u.bits,
                "batched": tree.batched, "tn": tree.tn}
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return np.asarray(tree)


def _quantized_pair(act_bits):
    dense = jbase.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    jp = jbase.fuse_layer_projections(
        jbase.quantize_params(dense, 64, 4, consume=False))
    assert jp["layers"][0]["qkv_proj"]["w"].tn    # the JAX main-path layout
    tp = params_from_numpy(_to_numpy(jp), "cpu", act_bits=act_bits)
    assert isinstance(tp["layers"][0]["qkv_proj"]["w"], PackedQuantizedTensor)
    assert tp["layers"][0]["qkv_proj"]["w"].panels and tp["embed"].panels
    return jp, tp


def _run_logits(jp, tp, prompt, steps, dtype_j, dtype_t):
    """Prefill then ``steps`` decode steps through both packages' forward;
    returns the list of (jax, torch) logits per call, float32 numpy."""
    jc = jbase.init_cache(JCFG, 1, 64, dtype_j)
    tc = tbase.init_cache(TCFG, 1, 64, dtype_t, device="cpu")
    out = []
    toks = np.asarray(prompt)[None]
    for i in range(steps + 1):
        jl, jc = jbase.forward(jp, JCFG, jnp.asarray(toks), jc,
                               fresh_prefill=i == 0)
        with torch.inference_mode():
            tl, tc = tbase.forward(tp, TCFG, torch.from_numpy(toks), tc,
                                   fresh_prefill=i == 0)
        jl = np.asarray(jl, np.float32)
        out.append((jl, tl.float().numpy()))
        toks = np.argmax(jl[:, -1:], -1)
    return out


def test_forward_float32_dense_matches_jax():
    """float32 dense weights: logits of a 20-token prefill and 4 decode
    steps within max abs 1e-4."""
    dense = jbase.fuse_layer_projections(
        jbase.init_params(JCFG, jax.random.PRNGKey(1), jnp.float32))
    tp = params_from_numpy(_to_numpy(dense), "cpu")
    assert tp["embed"].dtype == torch.float32
    prompt = np.random.default_rng(0).integers(0, 512, 20)
    for jl, tl in _run_logits(dense, tp, prompt, 4, jnp.float32,
                              torch.float32):
        assert jl.shape == tl.shape
        assert np.max(np.abs(jl - tl)) < 1e-4


def test_w4a16_greedy_generate_equals_jax():
    """4-bit weights, exact activations: greedy Engine.generate gives the
    same 16 tokens as the JAX package's, token for token. The 12-token
    prompt buckets to 16, so the port's prefill runs K1 at M=16."""
    jp, tp = _quantized_pair(act_bits=None)
    prompt = np.random.default_rng(1).integers(0, 512, 12)
    je = JEngine(lambda p, t, c: jbase.forward(p, JCFG, t, c), jp,
                 JSampler(),
                 prefill_forward_fn=lambda p, t, c: jbase.forward(
                     p, JCFG, t, c, fresh_prefill=True))
    te = TEngine(lambda p, t, c: tbase.forward(p, TCFG, t, c), tp,
                 TSampler(),
                 prefill_forward_fn=lambda p, t, c: tbase.forward(
                     p, TCFG, t, c, fresh_prefill=True))
    want = list(je.generate(jnp.asarray(prompt, jnp.int32),
                            jbase.init_cache(JCFG, 1, 64), max_tokens=16))
    got = list(te.generate(torch.from_numpy(prompt),
                           tbase.init_cache(TCFG, 1, 64, device="cpu"),
                           max_tokens=16))
    assert len(want) == 16 and got == want
    toks, _ = te.generate_scan(torch.from_numpy(prompt),
                               tbase.init_cache(TCFG, 1, 64, device="cpu"),
                               max_tokens=16)
    assert toks[0].tolist() == want


def test_w4a8_logits_close_to_jax():
    """4-bit weights with per-row int8 activations at decode (the TPU main
    path's w4a8) against the JAX package's exact CPU path: rel < 0.05 per
    call (the a8 tolerance of tests/test_quant_ops.py)."""
    jp, tp = _quantized_pair(act_bits=8)
    prompt = np.random.default_rng(2).integers(0, 512, 20)
    for jl, tl in _run_logits(jp, tp, prompt, 4, jnp.bfloat16,
                              torch.bfloat16):
        rel = np.max(np.abs(jl - tl)) / np.max(np.abs(jl))
        assert rel < 0.05, rel


def test_quantize_params_matches_jax():
    """The port's post-hoc quantizer on the same dense float32 weights
    gives the JAX package's codes and bf16 scales exactly; biases agree
    within the bf16 rounding of the stored fold b - 8s (the same one-ulp
    loss as the JAX tn layout, tests/test_quant_ops.py)."""
    dense = jbase.init_params(JCFG, jax.random.PRNGKey(2), jnp.float32)
    jq = jbase.quantize_params(dense, 64, 4, consume=False)
    tq = tbase.quantize_params(params_from_numpy(_to_numpy(dense), "cpu"))
    for name in ("q_proj", "down_proj"):
        ju = jqm.unpack(jq["layers"][1][name]["w"])
        tu = tqm.unpack(tq["layers"][1][name]["w"])
        np.testing.assert_array_equal(tu.q.numpy(), np.asarray(ju.q))
        s = np.asarray(ju.scales, np.float32)
        np.testing.assert_array_equal(tu.scales.float().numpy(), s)
        b = np.asarray(ju.biases, np.float32)
        ulp = 2.0 ** -8 * (np.abs(b) + 8 * s)
        assert np.all(np.abs(tu.biases.float().numpy() - b) <= ulp)
    assert isinstance(tq["embed"], PackedQuantizedTensor)


def test_unported_branches_raise():
    """The DeltaNet branch is ported since the Qwen3-Next slice (the test
    keeps its name from when it raised): a one-layer tree holding a
    "linear_attn" layer runs and its logits equal the JAX package's
    (float32, 1e-4); a deltanet config that is not the port's
    DeltaNetConfig still raises NotImplementedError."""
    import dataclasses

    from ominix_mlx_tpu.models import qwen3_next as jqn
    from ominix_mlx_tpu_torch.models import deltanet as tdn

    with pytest.raises(NotImplementedError):
        tbase.init_params(dataclasses.replace(TCFG, deltanet=object()),
                          torch.Generator().manual_seed(0), device="cpu")
    dcfg = tdn.DeltaNetConfig(num_v_heads=4, num_k_heads=2, head_k_dim=16,
                              head_v_dim=16)
    cfg = dataclasses.replace(TCFG, num_layers=1, deltanet=dcfg,
                              layer_types=("linear_attention",))
    tp = tbase.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu")
    assert set(tp["layers"][0]) == {"input_layernorm",
                                    "post_attention_layernorm",
                                    "linear_attn", "gate_proj", "up_proj",
                                    "down_proj"}
    toks = np.array([[3, 1, 4, 1, 5]])
    with torch.inference_mode():
        tl, tc = tbase.forward(tp, cfg, torch.from_numpy(toks),
                               tbase.init_cache(cfg, 1, 8, torch.float32,
                                                device="cpu"))
    jcfg = dataclasses.replace(JCFG, num_layers=1, layer_types=(
        "linear_attention",), deltanet=jqn.DeltaNetConfig(
        num_v_heads=4, num_k_heads=2, head_k_dim=16, head_v_dim=16))
    jp = jax.tree_util.tree_map(
        jnp.asarray, jax.tree_util.tree_map(lambda t: t.numpy(), tp))
    jl, _ = jbase.forward(jp, jcfg, jnp.asarray(toks),
                          jqn.init_cache(jcfg, 1, 8, jnp.float32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert tc.offset == 5 and float(tc.layers[0].state.abs().sum()) > 0


@pytest.mark.parametrize("key", ["post_self_attn_layernorm",
                                 "post_mlp_layernorm"])
def test_post_norm_layers_raise(key):
    """GLM-4's sandwich norms (a norm on the attention output, one on the
    MLP output) are applied where the JAX package applies them: a tree
    holding one, with a weight that is not all ones, gives the JAX
    package's logits (float32, 1e-4), and so does not skip it. The layer
    kind still not ported (a DeltaNet layer) raises."""
    jp = jbase.init_params(JCFG, jax.random.PRNGKey(2), jnp.float32)
    w = np.random.default_rng(0).uniform(0.5, 1.5, JCFG.hidden_size)
    jp["layers"][0][key] = jnp.asarray(w, jnp.float32)
    tp = params_from_numpy(_to_numpy(jp), "cpu")
    prompt = np.random.default_rng(1).integers(0, 512, 6)
    for jl, tl in _run_logits(jp, tp, prompt, 2, jnp.float32,
                              torch.float32):
        assert np.max(np.abs(jl - tl)) < 1e-4
    tp["layers"][0]["linear_attn"] = {}
    with pytest.raises(NotImplementedError):
        tbase.forward(tp, TCFG, torch.zeros(1, 1, dtype=torch.long),
                      tbase.init_cache(TCFG, 1, 8, device="cpu"))


@pytest.mark.parametrize("variant,act_bits", [
    ("fused_w8", 8), ("fused_w8", None), ("rows_w4", 8), ("rows_w8", 8),
    ("rows_w8", None), ("batched_w4", 8), ("batched_w4", None)])
def test_quantized_layouts_logits_close_to_jax(variant, act_bits):
    """The 2-layer model quantized by the JAX package fused at 8 bits
    (panels: K1's 8-bit modes), unfused at 4 and 8 bits (row-major: K6 up
    to 16 rows, K7 for 4-bit up to 64) and batched at 4 bits (the dq
    formula at 2..16 rows), carried across by the bridge with its flags:
    logits of a 20-token prefill and 4 decode steps against the JAX
    package's CPU path, rel < 0.05 where the decode quantizes activations
    to int8 (act_bits=8, bf16 activations), < 1e-2 for the exact formulas
    (float32 embedding and activations, as in the MoE test: bf16
    activations through 2 layers flip a logit by a bf16 ulp, 5.7e-3 of
    the largest, whatever the formula)."""
    bits = 8 if variant.endswith("w8") else 4
    exact = act_bits is None
    dense = jbase.init_params(JCFG, jax.random.PRNGKey(4), jnp.float32)
    jp = jbase.quantize_params(dense, 64, bits, consume=False,
                               quantize_embed=not exact,
                               batched=variant.startswith("batched"))
    if variant.startswith("fused"):
        jp = jbase.fuse_layer_projections(jp)
    tp = params_from_numpy(_to_numpy(jp), "cpu", act_bits=act_bits)
    w = tp["layers"][0]["qkv_proj" if variant.startswith("fused")
                        else "q_proj"]["w"]
    assert w.bits == bits and w.panels == variant.startswith("fused")
    assert w.batched == variant.startswith("batched")
    prompt = np.random.default_rng(3).integers(0, 512, 20)
    tol = 1e-2 if exact else 0.05
    for jl, tl in _run_logits(jp, tp, prompt, 4,
                              jnp.float32 if exact else jnp.bfloat16,
                              torch.float32 if exact else torch.bfloat16):
        rel = np.max(np.abs(jl - tl)) / np.max(np.abs(jl))
        assert rel < tol, rel
