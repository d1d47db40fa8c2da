"""Port parity for absorbed multi-head latent attention (models/mla.py)
against the JAX package's on the same seeded numpy weights: the attention
block with and without q-LoRA, a prefill then a decode step over the
latent cache, at one offset for every row and at per-row [B] offsets
(float32, 1e-5); the softmax scale and RoPE under a yarn config; and the
dense continuous batcher over a 2-layer MLA model, whose greedy outputs
equal the port's single-sequence engine and the JAX package's batcher
(tests/test_batching.py::test_batcher_mla_matches_single_sequence); and a
chunked prefill (kv_limit) against the one-shot one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core.attention import causal_mask as jmask
from ominix_mlx_tpu.core.cache import ModelCache as JModelCache
from ominix_mlx_tpu.core.generate import Engine as JEngine
from ominix_mlx_tpu.core.rope import make_rope as jmake_rope
from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import mla as jmla
from ominix_mlx_tpu.serving.batching import ContinuousBatcher as JBatcher
from ominix_mlx_tpu_torch.core.attention import causal_mask as tmask
from ominix_mlx_tpu_torch.core.generate import Engine as TEngine
from ominix_mlx_tpu_torch.core.rope import make_rope as tmake_rope
from ominix_mlx_tpu_torch.models import base as tbase
from ominix_mlx_tpu_torch.models import mla as tmla
from ominix_mlx_tpu_torch.serving.batching import ContinuousBatcher as TBatcher
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(2)

D = 32
YARN = {"type": "yarn", "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096}


def _mcfgs(q_lora_rank):
    kw = dict(num_heads=2, q_lora_rank=q_lora_rank, kv_lora_rank=16,
              qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
              rope_scaling=YARN)
    return jmla.MLAConfig(**kw), tmla.MLAConfig(**kw)


def _layer(rng, m):
    """One MLA layer's leaves as numpy float32, kv_b_proj absorbed."""
    def lin(o, i):
        return {"w": (0.2 * rng.standard_normal((o, i))).astype(np.float32)}

    lp = {"kv_a_proj_with_mqa": lin(m.kv_lora_rank + m.qk_rope_head_dim, D),
          "kv_a_layernorm": (1 + 0.1 * rng.standard_normal(
              m.kv_lora_rank)).astype(np.float32),
          "o_proj": lin(D, m.num_heads * m.v_head_dim)}
    if m.q_lora_rank is None:
        lp["q_proj"] = lin(m.num_heads * m.qk_head_dim, D)
    else:
        lp["q_a_proj"] = lin(m.q_lora_rank, D)
        lp["q_a_layernorm"] = np.ones(m.q_lora_rank, np.float32)
        lp["q_b_proj"] = lin(m.num_heads * m.qk_head_dim, m.q_lora_rank)
    kv_b = (0.2 * rng.standard_normal(
        (m.num_heads * (m.qk_nope_head_dim + m.v_head_dim),
         m.kv_lora_rank))).astype(np.float32)
    w_uk, w_uv = jmla.absorb_kv_b(jnp.asarray(kv_b), m)
    t_uk, t_uv = tmla.absorb_kv_b(torch.from_numpy(kv_b), m)
    np.testing.assert_array_equal(t_uk.numpy(), np.asarray(w_uk))
    np.testing.assert_array_equal(t_uv.numpy(), np.asarray(w_uv))
    lp["w_uk"], lp["w_uv"] = np.asarray(w_uk), np.asarray(w_uv)
    return lp


@pytest.mark.parametrize("q_lora_rank", [None, 12])
@pytest.mark.parametrize("per_row", [False, True])
def test_attention_block_matches_jax(q_lora_rank, per_row):
    """A 5-token prefill then a one-token step, both written into the
    latent cache at the same offsets as the JAX package (rows at offsets
    0 and 3 where ``per_row``): outputs and cache buffers within 1e-5."""
    jm, tm = _mcfgs(q_lora_rank)
    rng = np.random.default_rng(7 + (q_lora_rank or 0))
    lp = _layer(rng, jm)
    jlp = jax.tree_util.tree_map(jnp.asarray, lp)
    tlp = params_from_numpy(lp, "cpu")
    B, S = 2, 16
    jc = jmla.init_cache_layer(B, jm, S, jnp.float32)
    tc = tmla.init_cache_layer(B, tm, S, torch.float32, device="cpu")
    assert tuple(tc.k.shape) == (B, 1, S, 24) and tuple(tc.v.shape) == (
        B, 1, S, 16)
    off = np.array([0, 3]) if per_row else np.array(0)
    for T in (5, 1):
        x = rng.standard_normal((B, T, D)).astype(np.float32)
        joff = jnp.asarray(off, jnp.int32)
        toff = torch.from_numpy(off) if per_row else int(off)
        jo, jc = jmla.attention_block(jlp, jm, jnp.asarray(x), jc, joff,
                                      jmask(T, S, joff))
        to, tc = tmla.attention_block(
            tlp, tm, torch.from_numpy(x), tc, toff,
            lambda: tmask(T, S, toff))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v),
                                   rtol=1e-5, atol=1e-5)
        off = off + T


def test_yarn_scale_and_rope_match_jax():
    """Yarn scaling: MLA's softmax scale carries mscale^2 as in the JAX
    package, and make_rope resolves the yarn type to the default
    frequencies there, as it does there."""
    jm, tm = _mcfgs(None)
    assert tm.scale == jm.scale != tm.qk_head_dim ** -0.5
    assert dataclasses.asdict(tm.rope()) == dataclasses.asdict(jm.rope())
    jr, tr = jmake_rope(128, 1e4, YARN), tmake_rope(128, 1e4, YARN)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert tr.scale == 1.0


KW = dict(vocab_size=96, hidden_size=D, num_layers=2, num_heads=2,
          num_kv_heads=1, head_dim=16, intermediate_size=48,
          tie_word_embeddings=True)


def _mla_model():
    """The JAX test's tiny 2-layer MLA model (tests/test_batching.py
    _mla_setup), and the same weights bridged to the port."""
    jm, tm = _mcfgs(None)
    jm, tm = (dataclasses.replace(m, rope_scaling=None) for m in (jm, tm))
    jcfg = jbase.TransformerConfig(**KW, mla=jm)
    tcfg = tbase.TransformerConfig(**KW, mla=tm)
    jp = jbase.init_params(jcfg, jax.random.PRNGKey(4), jnp.float32)
    rng = np.random.default_rng(5)
    for lp in jp["layers"]:
        for k in ("q_proj", "k_proj", "v_proj", "o_proj", "q_norm",
                  "k_norm"):
            lp.pop(k, None)
        lp.update(jax.tree_util.tree_map(jnp.asarray, _layer(rng, jm)))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def test_batcher_mla_matches_single_sequence():
    """Continuous batching over an MLA model: per-row offsets drive the
    latent attention's RoPE, mask and cache writes. Every greedy output
    equals the port's single-sequence engine (up to the last token, as in
    the JAX test) and the JAX package's batcher token for token."""
    jcfg, tcfg, jp, tp = _mla_model()

    def jinit(cfg, b, ml):
        return JModelCache(layers=[jmla.init_cache_layer(b, cfg.mla, ml,
                                                         jnp.float32)
                                   for _ in range(cfg.num_layers)],
                           offset=jnp.zeros((), jnp.int32))

    def tinit(cfg, b, ml):
        return tbase.init_cache(cfg, b, ml, torch.float32, device="cpu")

    def tfwd(p, t, c):
        return tbase.forward(p, tcfg, t, c)

    reqs = [("a", [3, 7, 11], 6), ("b", [5, 2], 8), ("c", [9, 1, 4, 8], 5)]
    got = TBatcher(tfwd, tp, tcfg, tinit, slots=2, max_len=64).run_all(reqs)
    want = JBatcher(lambda p, t, c: jbase.forward(p, jcfg, t, c), jp, jcfg,
                    jinit, slots=2, max_len=64).run_all(reqs)
    assert got == want
    for rid, prompt, mt in reqs:
        ref = list(TEngine(tfwd, tp).generate(
            torch.tensor(prompt), tinit(tcfg, 1, 64), max_tokens=mt))
        assert got[rid] == ref[:len(got[rid])] and \
            len(got[rid]) >= len(ref) - 1, (rid, got[rid], ref)
        jref = list(JEngine(lambda p, t, c: jbase.forward(p, jcfg, t, c),
                            jp).generate(jnp.asarray(prompt),
                                         jinit(jcfg, 1, 64), max_tokens=mt))
        assert ref == jref


def test_mla_chunked_prefill_equals_one_shot():
    """A 40-token prompt prefilled in chunks of 16 (each attending the first
    kv_limit slots of the latent cache) gives the one-shot prefill's last
    logits (1e-5) and latent cache. The JAX package's MLA branch cannot
    take kv_limit (its mask then has kv_limit columns against the whole
    cache: ROADMAP Queue C), so the port is held to its own one-shot
    prefill, which test_batcher_mla_matches_single_sequence holds to the
    JAX package."""
    _, tcfg, _, tp = _mla_model()
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, 96, (1, 40)))
    with torch.inference_mode():
        whole, wc = tbase.forward(tp, tcfg, toks, tbase.init_cache(
            tcfg, 1, 64, torch.float32, device="cpu"))
        cache = tbase.init_cache(tcfg, 1, 64, torch.float32, device="cpu")
        for pos in range(0, 40, 16):
            chunk = toks[:, pos:pos + 16]
            last, cache = tbase.forward(tp, tcfg, chunk, cache,
                                        kv_limit=pos + chunk.shape[1])
    np.testing.assert_allclose(last[0, -1].numpy(), whole[0, -1].numpy(),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(cache.layers, wc.layers):
        np.testing.assert_allclose(a.k.numpy(), b.k.numpy(), rtol=1e-5,
                                   atol=1e-5)
