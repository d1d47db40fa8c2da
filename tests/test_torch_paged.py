"""Port parity for the paged KV cache: ``PagedKVCache`` writes and logical
views, ``quantize_kv_tokens``, the plain paged decode attention (kernel
K3's plain version) against the JAX package's Pallas kernel run in
interpret mode, and the host-side ``PageAllocator`` / ``PrefixCache``.
K3 itself is checked on a CUDA card by tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core import paged_cache as jpc
from ominix_mlx_tpu.ops import paged_attention as jpa
from ominix_mlx_tpu_torch.core import paged_cache as tpc
from ominix_mlx_tpu_torch.ops import _build
from ominix_mlx_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(2)


def _to_jax_layout(k_pool, v_pool):
    """Port pools [P, n_kv, ps, D] -> JAX pools (k [n_kv, P, D, ps], v
    [n_kv, P, ps, D])."""
    return k_pool.permute(1, 0, 3, 2), v_pool.permute(1, 0, 2, 3)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_update_and_views_match_jax(quantized):
    """Shuffled tables, per-row and shared offsets, and a write that runs
    past the table width (those positions go to the null page 0): the
    views equal the JAX package's exactly, the pools (page 0 aside, whose
    duplicate writes land in either order) hold the same codes, and the
    int8 scales agree to rel 1e-6. Writes are in place."""
    B, n_kv, d, ps, mp = 2, 2, 8, 4, 4
    P = 1 + B * mp
    rng = np.random.default_rng(0)
    table = (rng.permutation(P - 1) + 1).reshape(B, mp).astype(np.int32)
    dt = torch.float32 if quantized else torch.bfloat16
    jc = jpc.PagedKVCache.init(B, n_kv, P, ps, d, mp,
                               jnp.float32 if quantized else jnp.bfloat16,
                               page_table=jnp.asarray(table),
                               quantized=quantized)
    tc = tpc.PagedKVCache.init(B, n_kv, P, ps, d, mp, dt,
                               page_table=torch.from_numpy(table),
                               quantized=quantized)
    kbuf = tc.k_pool
    writes = [(3, np.array([0, 2])), (1, np.array([3, 5])), (5, 8),
              (2, np.array([13, 15]))]          # row 1 writes 15, 16: OOB
    for T, off in writes:
        k = rng.standard_normal((B, n_kv, T, d)).astype(np.float32)
        v = rng.standard_normal((B, n_kv, T, d)).astype(np.float32)
        jo = jnp.asarray(off, jnp.int32)
        to = torch.from_numpy(off) if isinstance(off, np.ndarray) else off
        jc = jc.update(jnp.asarray(k), jnp.asarray(v), jo)
        out = tc.update(torch.from_numpy(k), torch.from_numpy(v), to)
        assert out is tc and tc.k_pool is kbuf
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    tk, tv = _to_jax_layout(tc.k_pool, tc.v_pool)
    np.testing.assert_array_equal(_np(tk)[:, 1:],
                                  np.asarray(jc.k_pool, np.float32)[:, 1:])
    np.testing.assert_array_equal(_np(tv)[:, 1:],
                                  np.asarray(jc.v_pool, np.float32)[:, 1:])
    if quantized:
        for ts, js in ((tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)):
            np.testing.assert_allclose(ts.permute(1, 0, 2).numpy()[:, 1:],
                                       np.asarray(js)[:, 1:], rtol=1e-6)
    assert tc.max_len == jc.max_len and tc.page_size == ps
    assert tc.quantized == quantized


def test_quantize_kv_tokens_matches_jax():
    """Codes equal, scales within rel 1e-6."""
    x = np.random.default_rng(1).standard_normal((3, 4, 5, 64)).astype(
        np.float32) * 3
    jq, js = jpc.quantize_kv_tokens(jnp.asarray(x))
    tq, ts = tpc.quantize_kv_tokens(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def _pools(B, NKV, D, PS, MP, quant, seed):
    """Random pools (bf16 or int8 codes + f32 scales) in the JAX layout as
    numpy, and a shuffled table."""
    rng = np.random.default_rng(seed)
    P = B * MP + 1
    kn = rng.standard_normal((NKV, P, PS, D)).astype(np.float32)
    vn = rng.standard_normal((NKV, P, PS, D)).astype(np.float32)
    table = (rng.permutation(P - 1) + 1).reshape(B, MP).astype(np.int32)
    q = rng.standard_normal((B, 4 * NKV, D)).astype(np.float32)
    if quant:
        kq, ks = jpc.quantize_kv_tokens(jnp.asarray(kn))
        vq, vs = jpc.quantize_kv_tokens(jnp.asarray(vn))
        return (q, np.asarray(kq), np.asarray(vq), table, np.asarray(ks),
                np.asarray(vs))
    return (q, kn.astype(ml_dtypes.bfloat16), vn.astype(ml_dtypes.bfloat16),
            table, None, None)


@pytest.mark.parametrize("case", ["bf16", "int8", "window"])
def test_paged_decode_reference_matches_jax_kernel(case):
    """The plain paged decode attention against the JAX package's kernel
    in interpret mode (as tests/test_paged_cache.py runs it), bf16 or int8
    pages, ragged lengths across page boundaries, shuffled tables, and a
    sliding window: max error within rel 2e-2 of max |JAX| (both round
    the softmax weights, or the kernel its probabilities, to bf16)."""
    B, NKV, D, PS, MP = 4, 2, 128, 128, 4
    quant = case == "int8"
    window = 200 if case == "window" else 0
    lengths = (np.array([150, 300, 512, 129]) if window
               else np.array([1, 128, 129, 512]))
    q, kp, vp, table, ks, vs = _pools(B, NKV, D, PS, MP, quant, seed=2)
    jk = jnp.transpose(jnp.asarray(kp), (0, 1, 3, 2))      # [NKV, P, D, PS]
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jk, jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths, jnp.int32), D ** -0.5, interpret=True,
        window=window,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    want = np.asarray(want, np.float32)

    def port(a):        # JAX [NKV, P, ...] -> port [P, NKV, ...]
        t = torch.from_numpy(np.array(a, np.float32 if a.dtype ==
                                      ml_dtypes.bfloat16 else a.dtype))
        t = t.to(torch.bfloat16) if a.dtype == ml_dtypes.bfloat16 else t
        return t.transpose(0, 1).contiguous()

    _build.reset_launches()
    got = tpa.paged_decode_attention(
        torch.from_numpy(q), port(kp), port(vp), torch.from_numpy(table),
        torch.from_numpy(lengths), D ** -0.5, window=window,
        k_scale=None if ks is None else port(ks),
        v_scale=None if vs is None else port(vs))
    assert _build.LAUNCHES["k3"] == 0       # CPU tensors: the plain version
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < 2e-2, err


def test_allocator_and_prefix_cache_match_jax():
    """The same sequence of alloc / share / release / register / lookup /
    evict on both packages' classes gives the same page ids and state."""
    ps = 4
    objs = {}
    for name, mod in (("jax", jpc), ("torch", tpc)):
        a = mod.PageAllocator(num_pages=12, page_size=ps)
        pc = mod.PrefixCache(ps)
        log = []
        prompt = list(range(10, 21))                   # 2 full pages + 3
        owned = a.alloc(0, len(prompt))
        log.append(list(owned))
        pc.register(prompt, owned[:len(prompt) // ps], a)
        log.append(pc.lookup(prompt, (len(prompt) - 1) // ps))
        hit = pc.lookup(prompt[:9] + [99, 98], 2, digests=pc.chain(
            prompt[:9] + [99, 98]))
        log.append(hit)
        a.share(1, hit)
        log.append(list(a.alloc(1, 13)))
        a.release(0)
        log.append(sorted(a.free))
        log.append(pc.evictable(a))
        a.release(1)
        log.append(pc.evictable(a))
        log.append(pc.evict(a, max_evict=1))
        log.append(sorted(a.free))
        try:
            a.alloc(2, 100)
            log.append("fit")
        except MemoryError:
            log.append("exhausted")
        pc.record(2)
        pc.record(0)
        log.append((pc.hits, pc.misses, pc.hit_tokens, len(pc.entries),
                    sorted(a.refs.items())))
        objs[name] = log
    assert objs["torch"] == objs["jax"]


def test_cpu_paths_never_touch_the_kernel_build(monkeypatch):
    """CPU tensors take the plain versions: K2c's, K3's and the w8a8
    product never reach ``_build.library`` (which would need nvcc)."""
    from ominix_mlx_tpu_torch.ops import flash_attention as tfa
    from ominix_mlx_tpu_torch.ops import quant_matmul as tqm

    def refuse():
        raise AssertionError("a CPU call reached the kernel build")

    monkeypatch.setattr(_build, "library", refuse)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 64, generator=g)
    kp = torch.randn(5, 2, 8, 64, generator=g)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    tpa.paged_decode_attention(q, kp, kp, table, torch.tensor([3, 16]), 0.1)
    qc = torch.randn(1, 4, 3, 64, generator=g)
    kc = torch.randn(1, 2, 7, 64, generator=g)
    tfa.flash_chunk_prefill(qc, kc, kc, 4, 0.1)
    w = tqm.channel_quantize(torch.randn(16, 64, generator=g))
    tqm.channel_matmul(torch.randn(3, 64, generator=g), w)
    assert _build._lib is None
