"""Port parity for chunked prefill: the plain version of kernel K2c
(``flash_chunk_reference``) against the JAX package's CPU branch for a
continuation chunk (masked ``sdpa`` over the ``[:kv_limit]`` prefix with
``causal_mask``), and ``Engine.prefill_chunked`` against the JAX engine's
and against a single-shot prefill. K2c itself is checked on a CUDA card by
tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core.attention import causal_mask as jax_causal_mask
from ominix_mlx_tpu.core.attention import sdpa as jax_sdpa
from ominix_mlx_tpu.core.generate import Engine as JEngine
from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu_torch.core.generate import Engine as TEngine
from ominix_mlx_tpu_torch.models import base as tbase
from ominix_mlx_tpu_torch.ops import _build
from ominix_mlx_tpu_torch.ops import flash_attention as tfa
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(2)

JCFG = jbase.TransformerConfig(
    vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
    num_kv_heads=2, intermediate_size=96, head_dim=16, use_qk_norm=True,
    tie_word_embeddings=True, rope_theta=10000.0)
TCFG = tbase.TransformerConfig(
    vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
    num_kv_heads=2, intermediate_size=96, head_dim=16, use_qk_norm=True,
    tie_word_embeddings=True, rope_theta=10000.0)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def params():
    jp = jbase.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    return jp, params_from_numpy(_np_tree(jp), "cpu")


def _engines(jp, tp):
    def jfwd(**kw):
        return lambda p, t, c, *a: jbase.forward(
            p, JCFG, t, c, **kw, **({"kv_limit": a[0]} if a else {}))

    def tfwd(**kw):
        return lambda p, t, c, *a: tbase.forward(
            p, TCFG, t, c, **kw, **({"kv_limit": a[0]} if a else {}))

    je = JEngine(jfwd(), jp, prefill_forward_fn=jfwd(fresh_prefill=True),
                 chunk_forward_fn=jfwd(),
                 chunk_hidden_forward_fn=jfwd(skip_logits=True))
    te = TEngine(tfwd(), tp, prefill_forward_fn=tfwd(fresh_prefill=True),
                 chunk_forward_fn=tfwd(),
                 chunk_hidden_forward_fn=tfwd(skip_logits=True))
    return je, te


@pytest.mark.parametrize("pos,T", [(16, 16), (5, 33), (100, 7), (130, 128)])
def test_flash_chunk_reference_matches_jax_masked_sdpa(pos, T):
    """float32, H/Hkv = 2, ragged pos and T: max abs < 1e-5 against the
    JAX package's CPU branch (base.py:217-219); K/V are a strided view of
    a larger cache, as a chunk reads them."""
    rng = np.random.default_rng(pos + T)
    S = pos + T
    q = rng.standard_normal((1, 4, T, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, S + 9, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, S + 9, 32)).astype(np.float32)
    scale = 32 ** -0.5
    want = jax_sdpa(jnp.asarray(q), jnp.asarray(k[:, :, :S]),
                    jnp.asarray(v[:, :, :S]), scale=scale,
                    mask=jax_causal_mask(T, S, jnp.int32(pos)))
    _build.reset_launches()
    got, lse = tfa.flash_chunk_prefill_lse(
        torch.from_numpy(q), torch.from_numpy(k)[:, :, :S],
        torch.from_numpy(v)[:, :, :S], pos, scale)
    assert _build.LAUNCHES["k2c"] == 0      # CPU tensors: the plain version
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < 1e-5
    kk = np.repeat(k[:, :, :S], 2, axis=1).astype(np.float64)
    s = np.einsum("bhtd,bhsd->bhts", q.astype(np.float64), kk) * scale
    s = np.where(np.arange(S)[None, :] <= pos + np.arange(T)[:, None], s,
                 -np.inf)
    m = s.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert np.max(np.abs(lse.numpy() - want_lse)) < 1e-4


def test_prefill_chunked_matches_jax(params):
    """22-token prompt in chunks of 8 (a fresh chunk, a hidden-only
    continuation at kv_limit 16, a final one at 24): last logits within
    rel 1e-4 of the JAX engine's (float32), offsets 22 on both."""
    jp, tp = params
    je, te = _engines(jp, tp)
    prompt = (np.arange(1, 23) % 100)[None]
    want, jc = je.prefill_chunked(jnp.asarray(prompt),
                                  jbase.init_cache(JCFG, 1, 64, jnp.float32),
                                  chunk_size=8)
    got, tc = te.prefill_chunked(torch.from_numpy(prompt),
                                 tbase.init_cache(TCFG, 1, 64, torch.float32),
                                 chunk_size=8)
    assert int(jc.offset) == tc.offset == 22
    want = np.asarray(want)
    assert np.max(np.abs(got.numpy() - want)) / np.abs(want).max() < 1e-4


def test_prefill_chunked_capped_at_capacity_matches_jax(params):
    """A final chunk whose padded width would pass capacity is cut to fit
    (cap 40, chunks of 16 over a 37-token prompt: kv_limits 32 and 40)."""
    jp, tp = params
    je, te = _engines(jp, tp)
    prompt = ((np.arange(37) * 5 + 2) % 120)[None]
    want, _ = je.prefill_chunked(jnp.asarray(prompt),
                                 jbase.init_cache(JCFG, 1, 40, jnp.float32),
                                 chunk_size=16)
    got, tc = te.prefill_chunked(torch.from_numpy(prompt),
                                 tbase.init_cache(TCFG, 1, 40, torch.float32),
                                 chunk_size=16)
    assert tc.offset == 37
    want = np.asarray(want)
    assert np.max(np.abs(got.numpy() - want)) / np.abs(want).max() < 1e-4


def test_prefill_chunked_matches_single_shot_in_port(params):
    """In the port: chunked prefill equals one-shot prefill (rel 1e-4),
    and decoding continues identically from both caches."""
    _, tp = params
    _, te = _engines(*params)
    prompt = torch.from_numpy((np.arange(1, 23) % 100)[None])
    want, c1 = te.prefill(prompt, tbase.init_cache(TCFG, 1, 64,
                                                   torch.float32))
    got, c2 = te.prefill_chunked(prompt, tbase.init_cache(
        TCFG, 1, 64, torch.float32), chunk_size=8)
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-4
    tok = torch.tensor([[5]])
    with torch.inference_mode():
        l1, _ = tbase.forward(tp, TCFG, tok, c1)
        l2, _ = tbase.forward(tp, TCFG, tok, c2)
    assert int(l1[0, -1].argmax()) == int(l2[0, -1].argmax())


def test_kv_limit_must_end_the_chunk(params):
    """A continuation chunk attends keys 0..kv_limit-1 and ends at
    kv_limit: a kv_limit that disagrees with the offset raises."""
    _, tp = params
    cache = tbase.init_cache(TCFG, 1, 32, torch.float32)
    cache.offset = 4
    with pytest.raises(ValueError):
        tbase.forward(tp, TCFG, torch.zeros(1, 4, dtype=torch.long), cache,
                      kv_limit=12)
