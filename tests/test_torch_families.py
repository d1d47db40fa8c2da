"""The families the port loads from a checkpoint (Qwen3, Qwen2, Qwen3-MoE,
Mistral, GLM-4): each built as a randomly initialised HF ``transformers``
model (no download), its state dict handed as one flat float32 dict to
both packages' ``params_from_flat``, and the logits of the port held
against the JAX package's (rtol / atol 1e-4, float32 on the CPU) and both
against HF's (3e-3, the JAX package's own parity limit,
tests/test_model_parity.py). Greedy tokens over 8 steps match the JAX
package's for Mistral and GLM-4. The plain versions of K2 and K2c with a
sliding window are held to the JAX package's masked ``sdpa`` of
``causal_mask(..., window)`` (1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core.attention import causal_mask as jcausal_mask
from ominix_mlx_tpu.core.attention import sdpa as jsdpa
from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import glm4 as jglm4
from ominix_mlx_tpu.models import mistral as jmistral
from ominix_mlx_tpu.models import qwen3_moe as jqwen3_moe
from ominix_mlx_tpu_torch.models import base as tbase
from ominix_mlx_tpu_torch.models import glm4 as tglm4
from ominix_mlx_tpu_torch.models import mistral as tmistral
from ominix_mlx_tpu_torch.models import qwen3_moe as tqwen3_moe
from ominix_mlx_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

PORT_TOL = 1e-4       # port vs JAX package, float32, same flat dict
HF_TOL = 3e-3         # either vs HF transformers (test_model_parity.py)
TOKENS = np.array([[5, 17, 99, 3, 42, 7, 18, 1, 9, 11, 23, 4]])
SMALL = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=96)


def _flat(hf):
    """HF state dict -> (numpy float32 dict for JAX, torch float32 dict)."""
    sd = {k: v.detach().float() for k, v in hf.state_dict().items()}
    return ({k: jnp.asarray(v.numpy()) for k, v in sd.items()}, sd)


def _logits(jp, jcfg, tp, tcfg, tokens=TOKENS):
    jc = jbase.init_cache(jcfg, 1, 32, jnp.float32)
    jl, _ = jbase.forward(jp, jcfg, jnp.asarray(tokens), jc)
    tc = tbase.init_cache(tcfg, 1, 32, torch.float32, device="cpu")
    with torch.inference_mode():
        tl, _ = tbase.forward(tp, tcfg, torch.from_numpy(tokens), tc)
    return np.asarray(jl), tl.numpy()


def _check(hf, jp, jcfg, tp, tcfg, tokens=TOKENS):
    with torch.no_grad():
        want = hf(torch.from_numpy(tokens)).logits.numpy()
    jl, tl = _logits(jp, jcfg, tp, tcfg, tokens)
    np.testing.assert_allclose(tl, jl, rtol=PORT_TOL, atol=PORT_TOL)
    np.testing.assert_allclose(jl, want, rtol=HF_TOL, atol=HF_TOL)
    np.testing.assert_allclose(tl, want, rtol=HF_TOL, atol=HF_TOL)


def _greedy(jp, jcfg, tp, tcfg, steps=8):
    """Greedy tokens of both packages: a fresh prefill of TOKENS then
    ``steps`` one-token steps, each package feeding its own argmax."""
    jc = jbase.init_cache(jcfg, 1, 32, jnp.float32)
    tc = tbase.init_cache(tcfg, 1, 32, torch.float32, device="cpu")
    jt, tt = jnp.asarray(TOKENS), torch.from_numpy(TOKENS)
    jout, tout = [], []
    for i in range(steps):
        jl, jc = jbase.forward(jp, jcfg, jt, jc, fresh_prefill=i == 0)
        with torch.inference_mode():
            tl, tc = tbase.forward(tp, tcfg, tt, tc, fresh_prefill=i == 0)
        jn, tn = int(jnp.argmax(jl[0, -1])), int(tl[0, -1].argmax())
        jout.append(jn)
        tout.append(tn)
        jt, tt = jnp.asarray([[jn]]), torch.tensor([[tn]])
    return jout, tout


def test_qwen3_parity():
    from transformers import Qwen3Config
    from transformers.models.qwen3 import Qwen3ForCausalLM

    torch.manual_seed(0)
    hf = Qwen3ForCausalLM(Qwen3Config(**SMALL, head_dim=16,
                                      tie_word_embeddings=True)).eval()
    raw = hf.config.to_dict() | {"model_type": "qwen3"}
    jf, tf = _flat(hf)
    jcfg = jbase.TransformerConfig.from_hf(raw)
    tcfg = tbase.TransformerConfig.from_hf(raw)
    assert tcfg.use_qk_norm and tcfg.tie_word_embeddings
    _check(hf, jbase.params_from_flat(jf, jcfg), jcfg,
           tbase.params_from_flat(tf, tcfg, device="cpu"), tcfg)


def test_qwen2_parity_with_biases():
    from transformers import Qwen2Config
    from transformers.models.qwen2 import Qwen2ForCausalLM

    torch.manual_seed(0)
    hf = Qwen2ForCausalLM(Qwen2Config(**SMALL)).eval()
    with torch.no_grad():      # HF starts biases at zero: make them bite
        for lyr in hf.model.layers:
            for proj in (lyr.self_attn.q_proj, lyr.self_attn.k_proj,
                         lyr.self_attn.v_proj):
                proj.bias.normal_(0, 0.5)
    raw = hf.config.to_dict() | {"model_type": "qwen2"}
    jf, tf = _flat(hf)
    jcfg = jbase.TransformerConfig.from_hf(raw)
    tcfg = tbase.TransformerConfig.from_hf(raw)
    tp = tbase.params_from_flat(tf, tcfg, device="cpu")
    assert tcfg.attention_bias and "b" in tp["layers"][0]["q_proj"]
    _check(hf, jbase.params_from_flat(jf, jcfg), jcfg, tp, tcfg)


def test_qwen3_moe_parity_mixed_layers():
    from transformers import Qwen3MoeConfig
    from transformers.models.qwen3_moe import Qwen3MoeForCausalLM

    d = dict(SMALL, num_hidden_layers=3, head_dim=16,
             moe_intermediate_size=48, num_experts=4, num_experts_per_tok=2,
             norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[1],
             tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = Qwen3MoeForCausalLM(Qwen3MoeConfig(**d)).eval()
    raw = hf.config.to_dict() | {"model_type": "qwen3_moe"}
    jf, tf = _flat(hf)
    jcfg = jqwen3_moe.config_from_hf(raw)
    tcfg = tqwen3_moe.config_from_hf(raw)
    tp = tqwen3_moe.params_from_flat(tf, tcfg, raw, device="cpu")
    assert [("moe" in lp) for lp in tp["layers"]] == [True, False, True]
    assert tp["layers"][0]["moe"]["experts"]["gate_proj"].shape == (4, 48,
                                                                    64)
    _check(hf, jqwen3_moe.params_from_flat(jf, jcfg, raw), jcfg, tp, tcfg)


@pytest.mark.parametrize("window", [None, 4])
def test_mistral_parity(window):
    """Window 4 on a 12-token prompt: every query past the fourth loses
    keys, and HF's logits move by far more than the limit."""
    from transformers import MistralConfig
    from transformers.models.mistral import MistralForCausalLM

    torch.manual_seed(0)
    hf = MistralForCausalLM(MistralConfig(**SMALL,
                                          sliding_window=window)).eval()
    raw = hf.config.to_dict() | {"model_type": "mistral"}
    jf, tf = _flat(hf)
    jcfg = jmistral.config_from_hf(raw)
    tcfg = tmistral.config_from_hf(raw)
    assert tcfg.sliding_window == window == jcfg.sliding_window
    jp = jbase.params_from_flat(jf, jcfg)
    tp = tbase.params_from_flat(tf, tcfg, device="cpu")
    _check(hf, jp, jcfg, tp, tcfg)
    if window:
        import dataclasses
        open_cfg = dataclasses.replace(tcfg, sliding_window=None)
        _, tl = _logits(jp, jcfg, tp, open_cfg)
        with torch.no_grad():
            want = hf(torch.from_numpy(TOKENS)).logits.numpy()
        assert np.abs(tl - want).max() > 100 * HF_TOL
    jout, tout = _greedy(jp, jcfg, tp, tcfg)
    assert jout == tout


def _glm4_hf():
    from transformers import Glm4Config
    from transformers.models.glm4 import Glm4ForCausalLM

    torch.manual_seed(0)
    hf = Glm4ForCausalLM(Glm4Config(**SMALL, partial_rotary_factor=0.5,
                                    attention_bias=True, head_dim=16,
                                    pad_token_id=0)).eval()
    with torch.no_grad():     # make the biases and sandwich norms bite
        for lyr in hf.model.layers:
            for proj in (lyr.self_attn.q_proj, lyr.self_attn.k_proj,
                         lyr.self_attn.v_proj):
                proj.bias.normal_(0, 0.5)
            lyr.post_self_attn_layernorm.weight.uniform_(0.5, 1.5)
            lyr.post_mlp_layernorm.weight.uniform_(0.5, 1.5)
    return hf, hf.config.to_dict() | {"model_type": "glm4"}


def test_glm4_parity():
    """Partial interleaved RoPE (half of each head's dims), q/k/v biases,
    the sandwich norms and the checkpoint's fused gate_up_proj."""
    hf, raw = _glm4_hf()
    jf, tf = _flat(hf)
    assert "model.layers.0.mlp.gate_up_proj.weight" in tf
    jcfg = jglm4.config_from_hf(raw)
    tcfg = tglm4.config_from_hf(raw)
    assert tcfg.rope_traditional and tcfg.rope().dims == 8
    tp = tglm4.params_from_flat(tf, tcfg, device="cpu")
    lp = tp["layers"][0]
    assert "gate_up_proj" in lp and "post_mlp_layernorm" in lp
    jp = jglm4.params_from_flat(jf, jcfg)
    _check(hf, jp, jcfg, tp, tcfg)
    jout, tout = _greedy(jp, jcfg, tp, tcfg)
    assert jout == tout


def test_glm4_fused_and_quantized_paths_agree():
    """The fused gate_up_proj as the checkpoint brings it, after
    ``fuse_layer_projections`` (q/k/v with their biases into qkv_proj),
    against the same tree unfused; and the tree quantized at 4 bits into
    plain ``QuantizedTensor`` weights (the fused gate_up_proj as one
    weight: the form an MLX checkpoint loads in), against the JAX
    package's ``quantize_params(pack=False)`` tree: float32 activations,
    the dequantize-then-product path of both, 1e-4."""
    from ominix_mlx_tpu.core.quant import QuantizedTensor as JQT
    from ominix_mlx_tpu_torch.core.quant import QuantizedTensor

    hf, raw = _glm4_hf()
    jf, tf = _flat(hf)
    tcfg, jcfg = tglm4.config_from_hf(raw), jglm4.config_from_hf(raw)
    tp = tglm4.params_from_flat(tf, tcfg, device="cpu")
    fused = tbase.fuse_layer_projections(tp)
    assert "b" in fused["layers"][0]["qkv_proj"]
    toks = torch.from_numpy(TOKENS)
    with torch.inference_mode():
        a, _ = tbase.forward(tp, tcfg, toks, tbase.init_cache(
            tcfg, 1, 32, torch.float32, device="cpu"))
        b, _ = tbase.forward(fused, tcfg, toks, tbase.init_cache(
            tcfg, 1, 32, torch.float32, device="cpu"))
    torch.testing.assert_close(b, a, rtol=PORT_TOL, atol=PORT_TOL)

    jq = jbase.quantize_params(jglm4.params_from_flat(jf, jcfg), 32, 4,
                               pack=False, quantize_embed=False,
                               consume=False)

    def to_torch(t):
        if isinstance(t, JQT):
            return QuantizedTensor(*(torch.from_numpy(np.array(a)) for a in
                                     (t.q, t.scales, t.biases)),
                                   group_size=t.group_size, bits=t.bits)
        if isinstance(t, dict):
            return {k: to_torch(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_torch(v) for v in t]
        return torch.from_numpy(np.array(t))

    tq = to_torch(jq)
    assert isinstance(tq["layers"][0]["gate_up_proj"]["w"], QuantizedTensor)
    jl, tl = _logits(jq, jcfg, tbase.fuse_layer_projections(tq), tcfg)
    np.testing.assert_allclose(tl, jl, rtol=PORT_TOL, atol=PORT_TOL)


@pytest.mark.parametrize("T,window", [(20, 4), (300, 128), (300, 100),
                                      (300, 1000)])
def test_window_prefill_plain_version_is_masked_sdpa(T, window):
    """flash_prefill_reference with a window against the JAX package's
    sdpa under causal_mask(T, T, 0, window): a window below, at and not at
    a multiple of the 128-key tile, and one longer than the prompt."""
    g = np.random.default_rng(T + window)
    q, k, v = (g.standard_normal((1, h, T, 16)).astype(np.float32)
               for h in (4, 2, 2))
    scale = 0.25
    want = jsdpa(jnp.asarray(q * scale), jnp.asarray(k), jnp.asarray(v),
                 scale=1.0, mask=jcausal_mask(T, T, jnp.int32(0), window))
    got, lse = fa.flash_prefill_reference(*map(torch.from_numpy, (q, k, v)),
                                          scale, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.isfinite(lse).all()


@pytest.mark.parametrize("pos,T,window", [
    (0, 40, 64),       # the chunk starts before the window's edge
    (100, 60, 64),     # the edge falls inside the chunk's keys
    (300, 30, 64),     # the whole window lies in the prefix
    (300, 100, 200),   # not a multiple of 128, edge inside the prefix
    (260, 50, 128),    # a multiple of 128
    (20, 30, 1000)])   # longer than every query's position
def test_window_chunk_plain_version_is_masked_sdpa(pos, T, window):
    """flash_chunk_reference at pos with a window against the JAX
    package's sdpa under causal_mask(T, pos + T, pos, window)."""
    g = np.random.default_rng(pos + T + window)
    q = g.standard_normal((1, 4, T, 16)).astype(np.float32)
    k, v = (g.standard_normal((1, 2, pos + T, 16)).astype(np.float32)
            for _ in range(2))
    scale = 0.25
    want = jsdpa(jnp.asarray(q * scale), jnp.asarray(k), jnp.asarray(v),
                 scale=1.0,
                 mask=jcausal_mask(T, pos + T, jnp.int32(pos), window))
    got, _ = fa.flash_chunk_reference(*map(torch.from_numpy, (q, k, v)),
                                      pos, scale, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_window_rejects_negative():
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="window"):
        fa.flash_prefill(q, q, q, 1.0, window=-1)
    with pytest.raises(ValueError, match="window"):
        fa.flash_chunk_prefill(q, q, q, 0, 1.0, window=-1)
