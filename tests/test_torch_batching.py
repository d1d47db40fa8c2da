"""Port parity for batched serving: the channelwise w8a8 scheme, the
engine's ``generate_batch`` and ``generate_scan`` at B > 1, and the dense
and paged continuous batchers, whose greedy outputs must equal the JAX
package's batchers token for token on the same numpy weights (float32
dense weights; bf16 or int8 KV pages; prefix caching; more requests than
slots; chunked adoption; preemption)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core.generate import Engine as JEngine
from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.ops import quant_matmul as jqm
from ominix_mlx_tpu.serving import batching as jb
from ominix_mlx_tpu_torch.core.generate import Engine as TEngine
from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
from ominix_mlx_tpu_torch.models import base as tbase
from ominix_mlx_tpu_torch.ops import quant_matmul as tqm
from ominix_mlx_tpu_torch.serving import batching as tb
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(2)

KW = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
          num_kv_heads=1, head_dim=16, intermediate_size=48,
          tie_word_embeddings=True)
JCFG = jbase.TransformerConfig(**KW)
TCFG = tbase.TransformerConfig(**KW)


def _np_tree(tree):
    if isinstance(tree, jqm.ChannelQuantizedTensor):
        return {"data": np.asarray(tree.data), "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def params():
    jp = jbase.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    return jp, params_from_numpy(_np_tree(jp), "cpu")


def _jfwd(**kw):
    return lambda p, t, c, *a: jbase.forward(
        p, JCFG, t, c, **kw, **({"kv_limit": a[0]} if a else {}))


def _tfwd(**kw):
    return lambda p, t, c, *a: tbase.forward(
        p, TCFG, t, c, **kw, **({"kv_limit": a[0]} if a else {}))


def _fns(fwd):
    return dict(prefill_forward_fn=fwd(fresh_prefill=True),
                chunk_forward_fn=fwd(),
                chunk_hidden_forward_fn=fwd(skip_logits=True))


def test_channel_w8a8_matches_jax():
    """Same int8 codes for weights and activations; matmul outputs within
    rel 1e-6 (the same exact int32 sums, one float32 rescale); the
    channel8 quantizer of a whole tree gives the JAX package's codes."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((40, 64)).astype(np.float32)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 2
    jw, tw = jqm.channel_quantize(jnp.asarray(w)), tqm.channel_quantize(
        torch.from_numpy(w))
    np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
    np.testing.assert_allclose(tw.scale.numpy(), np.asarray(jw.scale),
                               rtol=1e-6)
    jxq, jsx = jqm.quantize_act_channel(jnp.asarray(x))
    txq, tsx = tqm.quantize_act_channel(torch.from_numpy(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_allclose(tsx.numpy(), np.asarray(jsx), rtol=1e-6)
    want = np.asarray(jqm.channel_matmul(jnp.asarray(x), jw))
    got = tqm.channel_matmul(torch.from_numpy(x), tw).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6
    np.testing.assert_array_equal(
        tqm.channel_gather_rows(tw, torch.tensor([3, 0, 39])).float().numpy(),
        np.asarray(jqm.channel_gather_rows(jw, jnp.asarray([3, 0, 39])),
                   np.float32))
    dense = jbase.init_params(JCFG, jax.random.PRNGKey(3), jnp.float32)
    jq = jbase.quantize_params(dense, scheme="channel8", consume=False)
    tq = tbase.quantize_params(params_from_numpy(_np_tree(dense), "cpu"),
                               scheme="channel8")
    for name in ("q_proj", "down_proj"):
        np.testing.assert_array_equal(
            tq["layers"][1][name]["w"].data.numpy(),
            np.asarray(jq["layers"][1][name]["w"].data))
    assert isinstance(tq["embed"], tqm.ChannelQuantizedTensor)


def test_w8a8_forward_and_bridge_match_jax():
    """A channel8 tree carried across as numpy ({"data", "scale"}) gives
    logits within rel 1e-4 of the JAX package's (a 5-token prefill and one
    decode step), through fused projections."""
    jp = jbase.fuse_layer_projections(jbase.init_quantized_params(
        JCFG, jax.random.PRNGKey(1), scheme="channel8"))
    tp = params_from_numpy(_np_tree(jp), "cpu")
    assert isinstance(tp["layers"][0]["qkv_proj"]["w"],
                      tqm.ChannelQuantizedTensor)
    jc = jbase.init_cache(JCFG, 1, 16, jnp.float32)
    tc = tbase.init_cache(TCFG, 1, 16, torch.float32)
    toks = np.array([[3, 9, 27, 81, 5]])
    for _ in range(2):
        jl, jc = jbase.forward(jp, JCFG, jnp.asarray(toks), jc)
        with torch.no_grad():
            tl, tc = tbase.forward(tp, TCFG, torch.from_numpy(toks), tc)
        jl = np.asarray(jl, np.float32)
        assert np.abs(tl.float().numpy() - jl).max() / np.abs(jl).max() < 1e-4
        toks = np.argmax(jl[:, -1:], -1)


def test_generate_batch_matches_jax(params):
    """Right-padded prompts of lengths 4 and 6, greedy, one stop token:
    the same tokens (pad after the stop) and lengths as the JAX engine."""
    jp, tp = params
    je = JEngine(_jfwd(), jp, prefill_forward_fn=_jfwd(fresh_prefill=True))
    te = TEngine(_tfwd(), tp, prefill_forward_fn=_tfwd(fresh_prefill=True))
    prompts = np.array([[3, 7, 11, 2, 0, 0], [5, 9, 1, 4, 8, 6]])
    lens = np.array([4, 6])
    free, _ = je.generate_batch(jnp.asarray(prompts),
                                jbase.init_cache(JCFG, 2, 32, jnp.float32),
                                max_tokens=8, prompt_lengths=lens)
    stop = int(np.asarray(free)[0, 2])
    want, wlen = je.generate_batch(
        jnp.asarray(prompts), jbase.init_cache(JCFG, 2, 32, jnp.float32),
        max_tokens=8, stop_tokens=(stop,), pad_id=-1, prompt_lengths=lens)
    got, glen = te.generate_batch(
        torch.from_numpy(prompts),
        tbase.init_cache(TCFG, 2, 32, torch.float32), max_tokens=8,
        stop_tokens=(stop,), pad_id=-1, prompt_lengths=lens)
    assert got.tolist() == np.asarray(want).tolist()
    assert glen.tolist() == np.asarray(wlen).tolist()
    assert -1 in got[0].tolist()


def test_generate_scan_batch_dense_paged_match_jax(params):
    """generate_scan at B=2 over a dense and a paged cache (bf16 and int8
    pages) gives the JAX engine's dense tokens."""
    jp, tp = params
    je = JEngine(_jfwd(), jp, prefill_forward_fn=_jfwd(fresh_prefill=True))
    te = TEngine(_tfwd(), tp, prefill_forward_fn=_tfwd(fresh_prefill=True))
    prompt = np.array([[3, 7, 11, 2], [5, 9, 1, 4]])
    want, _ = je.generate_scan(jnp.asarray(prompt),
                               jbase.init_cache(JCFG, 2, 64, jnp.float32),
                               max_tokens=8)
    want = np.asarray(want).tolist()
    for cache in (tbase.init_cache(TCFG, 2, 64, torch.float32),
                  tbase.init_paged_cache(TCFG, 2, 64, page_size=16,
                                         dtype=torch.float32)):
        got, _ = te.generate_scan(torch.from_numpy(prompt), cache,
                                  max_tokens=8)
        assert got.tolist() == want
    jq, _ = je.generate_scan(jnp.asarray(prompt), jbase.init_paged_cache(
        JCFG, 2, 64, page_size=16, dtype=jnp.float32, quantized=True),
        max_tokens=8)
    tq, _ = te.generate_scan(torch.from_numpy(prompt), tbase.init_paged_cache(
        TCFG, 2, 64, page_size=16, dtype=torch.float32, quantized=True),
        max_tokens=8)
    assert tq.tolist() == np.asarray(jq).tolist()


REQS = [("a", [3, 7, 11], 6), ("b", [5, 2], 9), ("c", [9, 1, 4, 8], 4),
        ("d", [13], 7), ("long", [(i * 5 + 2) % 96 for i in range(41)], 6)]


def test_dense_batcher_matches_jax(params):
    """More requests than slots, one prompt adopted in three chunks
    (prefill_chunk 16): every greedy output equals the JAX batcher's."""
    jp, tp = params
    jcb = jb.ContinuousBatcher(
        _jfwd(), jp, JCFG,
        lambda cfg, b, ml: jbase.init_cache(cfg, b, ml, jnp.float32),
        slots=2, max_len=128, prefill_chunk=16, **_fns(_jfwd))
    tcb = tb.ContinuousBatcher(
        _tfwd(), tp, TCFG,
        lambda cfg, b, ml: tbase.init_cache(cfg, b, ml, torch.float32),
        slots=2, max_len=128, prefill_chunk=16, **_fns(_tfwd))
    want = jcb.run_all(REQS)
    got = tcb.run_all(REQS)
    assert got == want
    assert all(len(v) >= 3 for v in got.values())


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_batcher_prefix_cache_matches_jax(params, kv):
    """Paged pool with prefix caching (bf16 or int8 pages): a warm-up
    request, then requests sharing its 32-token system prefix (suffix-only
    prefill at pos 32 through kv_limit) and one chunked adoption, more
    requests than slots: greedy outputs equal the JAX batcher's, and the
    prefix cache counts the same hits."""
    jp, tp = params
    sys_prefix = [(i * 5 + 11) % 96 for i in range(32)]
    warm = [("w", sys_prefix + [7, 9], 5)]
    reqs = [("a", sys_prefix + [13], 5), ("b", sys_prefix + [21, 2, 8], 6),
            ("c", [4, 4, 5], 5), REQS[-1]]
    quant = kv == "int8"
    outs = []
    for mod, fwd, cfg, dt in ((jb, _jfwd, JCFG, jnp.bfloat16),
                              (tb, _tfwd, TCFG, torch.bfloat16)):
        cb = mod.PagedContinuousBatcher(
            fwd(), jp if mod is jb else tp, cfg, slots=2, max_len=128,
            page_size=16, dtype=dt, quantize_kv=quant, prefix_cache=True,
            **_fns(fwd))
        cb.prefill_chunk = 16
        got = cb.run_all(warm)
        got.update(cb.run_all(reqs))
        outs.append((got, cb.prefix.hits, cb.prefix.hit_tokens,
                     sorted(cb.alloc.free)))
    assert outs[1] == outs[0]
    assert outs[1][1] >= 2


def test_paged_batcher_preemption_matches_jax(params):
    """A pool too small for every in-flight sequence (5 usable pages of
    4 tokens): the port preempts and replays as the JAX batcher does, with
    the same greedy outputs, and frees every page."""
    jp, tp = params
    reqs = [("a", [3, 7, 11], 10), ("b", [5, 2], 12), ("c", [9, 1, 4, 8], 8)]
    outs = []
    for mod, fwd, cfg, dt, pp in ((jb, _jfwd, JCFG, jnp.float32, jp),
                                  (tb, _tfwd, TCFG, torch.float32, tp)):
        cb = mod.PagedContinuousBatcher(fwd(), pp, cfg, slots=2, max_len=64,
                                        page_size=4, num_pages=6, dtype=dt)
        outs.append(cb.run_all(reqs))
        assert all(not v for v in cb.alloc.owned.values())
    assert outs[1] == outs[0]


def test_sampled_row_leaves_greedy_rows_alone(params):
    """A sampled request batched beside greedy ones changes none of their
    tokens; the same seed draws the same tokens; a greedy row draws no
    random numbers (its generator is never made)."""
    _, tp = params

    def run(sampled, seed=1):
        cb = tb.PagedContinuousBatcher(_tfwd(), tp, TCFG, slots=3,
                                       max_len=64, page_size=8,
                                       dtype=torch.float32)
        cb.submit("g1", [3, 7, 11], 8)
        if sampled:
            cb.submit("s", [5, 2], 8, sampler=SamplerConfig(
                temperature=1.2, top_k=20, top_p=0.9), seed=seed)
        cb.submit("g2", [9, 1, 4], 8)
        out = cb.run_all([])
        return out, cb.gens

    alone, gens = run(False)
    assert all(g is None for g in gens)
    mixed, _ = run(True)
    again, _ = run(True)
    assert mixed["g1"] == alone["g1"] and mixed["g2"] == alone["g2"]
    assert mixed["s"] == again["s"]
    assert all(0 <= t < TCFG.vocab_size for t in mixed["s"])


def test_batcher_abort_cancel_and_unported_options(params):
    """abort_all fails every request with an error of its own (never the
    None of a finished request); cancel frees a slot and ends with None;
    the batchers take no speculative (draft) arguments; an oversize
    prompt is refused; a prompt the pool can never hold fails with a
    ValueError."""
    _, tp = params
    cb = tb.PagedContinuousBatcher(_tfwd(), tp, TCFG, slots=2, max_len=64,
                                   page_size=8, dtype=torch.float32)
    sink = {"a": [], "b": [], "c": []}
    for rid in sink:
        cb.submit(rid, [3, 7], 20, emit=sink[rid].append)
    cb.step()
    assert cb.cancel("a") and sink["a"][-1] is None
    cb.abort_all("stop")
    assert not cb.pending()
    for rid in ("b", "c"):
        assert isinstance(sink[rid][-1], RuntimeError)
        assert str(sink[rid][-1]) == "stop"
        assert None not in sink[rid]
    assert sink["b"][-1] is not sink["c"][-1]
    assert len(cb.alloc.free) == cb.num_pages - 1
    with pytest.raises(ValueError):
        cb.submit("big", list(range(64)), 4)
    with pytest.raises(TypeError):
        tb.ContinuousBatcher(
            _tfwd(), tp, TCFG,
            lambda cfg, b, ml: tbase.init_cache(cfg, b, ml, torch.float32),
            draft_forward_fn=_tfwd(), draft_params=tp)
    small = tb.PagedContinuousBatcher(_tfwd(), tp, TCFG, slots=2,
                                      max_len=64, page_size=4, num_pages=4,
                                      dtype=torch.float32)
    got, fits = [], []
    small.submit("huge", list(range(1, 14)), 4, emit=got.append)
    small.submit("fits", [3, 7], 2, emit=fits.append)
    small.run_all([])
    assert len(got) == 1 and isinstance(got[0], ValueError)
    assert fits[-1] is None and len(fits) == 3
