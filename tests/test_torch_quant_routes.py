"""Port parity for group-quantized weights in every layout the JAX package
dispatches: 8-bit packing, the dispatch flags (``panels``, ``batched``),
the route each (layout, bits, act_bits, M) takes, the plain versions of
K1's 8-bit modes, K6 and K7 against numpy transcriptions of the TPU
kernels they replace (_pt_kernel, _dq_kernel, _pm_kernel, _vpu_kernel),
every mode against the JAX package's CPU ``quantized_matmul``, and
``quantize_tree``. The kernels themselves are checked on a CUDA card by
tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core import quant as jquant
from ominix_mlx_tpu.ops import quant_matmul as jqm
from ominix_mlx_tpu_torch.core import quant as tquant
from ominix_mlx_tpu_torch.core.quant import QuantizedTensor
from ominix_mlx_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(2)

GS = 64
f32 = np.float32


def _bf16(a) -> np.ndarray:
    """Round to bf16 and widen back to float32 (numpy)."""
    return np.asarray(a, f32).astype(jnp.bfloat16).astype(f32)


def _rel(a, b) -> float:
    a = np.asarray(a, f32)
    b = np.asarray(b, f32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _canonical(seed, n, k, bits, exact_fold=False):
    """Canonical (q, scales, biases) as numpy, bf16-valued. By default the
    JAX package's quantizer on random weights. exact_fold=True draws
    scales m * 2^-8 (m in 4..7) and biases s * j (j in -8..7), so that the
    port's stored fold b - 8s and its unfold are exact: the transcription
    tests of the dq formula then hold the formula alone (the fold's one-ulp
    cost is held by test_unfolded_biases_within_one_ulp)."""
    rng = np.random.default_rng(seed)
    if exact_fold:
        lim = 1 << (bits - 1)
        q = rng.integers(-lim, lim, (n, k)).astype(np.int8)
        s = rng.integers(4, 8, (n, k // GS)).astype(f32) * f32(2.0 ** -8)
        b = s * rng.integers(-8, 8, (n, k // GS)).astype(f32)
        return q, s, b
    w = rng.standard_normal((n, k)).astype(f32) * 0.05
    qt = jquant.quantize_tensor(jnp.asarray(w), GS, bits)
    return (np.array(qt.q), _bf16(qt.scales), _bf16(qt.biases))


def _pair(can, bits, act_bits=8, batched=False, panels=False):
    """(JAX PackedQuantizedTensor, port PackedQuantizedTensor) of the same
    canonical weights, in the layout named."""
    q, s, b = can
    jw = jqm.prepare(jquant.QuantizedTensor(
        q=jnp.asarray(q), scales=jnp.asarray(s, jnp.bfloat16),
        biases=jnp.asarray(b, jnp.bfloat16), group_size=GS, bits=bits),
        act_bits=act_bits, batched=batched)
    tw = tqm.prepare(QuantizedTensor(
        q=torch.from_numpy(q), scales=torch.from_numpy(s).bfloat16(),
        biases=torch.from_numpy(b).bfloat16(), group_size=GS, bits=bits),
        act_bits=act_bits, batched=batched)
    if panels:
        jw = jqm.to_panels_t(jw)
        tw = tqm.to_panels(tw)
        assert jw.tn and tw.panels
    return jw, tw


def _x(seed, m, k):
    return _bf16(np.random.default_rng(seed).standard_normal((m, k)))


# ------------------------------------------------------- 8-bit packing ---

@pytest.mark.parametrize("layout", ["rows", "panels"])
def test_prepare_unpack_8bit_roundtrip_exact(layout):
    """8-bit weights: the port's prepare keeps the centred int8 codes and
    the unfolded biases; its unpack equals the JAX package's unpack of the
    same weights in either JAX layout, bit for bit."""
    can = _canonical(0, 256, 512, 8)
    jw, tw = _pair(can, 8, panels=layout == "panels")
    assert tw.data.dtype == torch.int8 and tuple(tw.data.shape) == (256, 512)
    ju, tu = jqm.unpack(jw), tqm.unpack(tw)
    np.testing.assert_array_equal(tu.q.numpy(), np.asarray(ju.q))
    np.testing.assert_array_equal(tu.scales.float().numpy(),
                                  np.asarray(ju.scales, f32))
    np.testing.assert_array_equal(tu.biases.float().numpy(),
                                  np.asarray(ju.biases, f32))


@pytest.mark.parametrize("bits", [4, 8])
def test_gather_rows_and_dense_match_jax(bits):
    """The quantized embedding lookup equals the JAX package's gather_rows
    on its row-major 8-bit layout exactly (4-bit: on its panel layout,
    whose biases carry the same fold), and the dense dequantization agrees
    with the JAX package's within bf16 rounding."""
    can = _canonical(1, 256, 512, bits)
    jw, tw = _pair(can, bits, panels=bits == 4)
    toks = np.array([[0, 7, 255], [3, 3, 128]])
    want = np.asarray(jqm.gather_rows(jw, jnp.asarray(toks)), f32)
    got = tqm.gather_rows(tw, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, 512)
    np.testing.assert_array_equal(got.float().numpy(), want)
    dense = np.asarray(jquant.dequantize(jqm.unpack(jw), jnp.float32))
    assert _rel(tqm.dequantize_packed(tw).float().numpy(), dense) < 1e-2


def test_unfolded_biases_within_one_ulp():
    """The 4-bit dq formula rebuilds b as bf16(b' + 8s) from the stored
    fold b' = b - 8s: within one bf16 ulp of |b| + 8s of the canonical b
    (the JAX package's row-major A3/A5 read b itself); 8-bit stores b."""
    q, s, b = _canonical(2, 256, 512, 4)
    _, tw = _pair((q, s, b), 4)
    got = tqm.unfolded_biases(tw).float().numpy()
    assert np.all(np.abs(got - b) <= 2.0 ** -8 * (np.abs(b) + 8 * s))
    _, tw8 = _pair(_canonical(2, 256, 512, 8), 8)
    assert tqm.unfolded_biases(tw8) is tw8.biases


# ---------------------------------------------------------- dispatch -----

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n,k", [(256, 512), (384, 256), (200, 512),
                                 (256, 384), (256, 2304), (128, 640)])
def test_panels_ok_matches_to_panels_t(bits, n, k):
    """The port marks a weight ``panels`` exactly where the JAX package's
    to_panels_t re-tiles it (K/2 or K a multiple of 128, K/2 a multiple of
    the group size, an even group count, N a multiple of 128), never a
    batched one."""
    for batched in (False, True):
        jw, tw = _pair(_canonical(3, n, k, bits), bits, batched=batched)
        assert tqm.panels_ok(tw) == bool(jqm.to_panels_t(jw).tn), \
            (bits, n, k, batched)


class _Routed(Exception):
    pass


class _Shape:
    """Stands for a weight array in the dispatch: only its shape is read."""

    def __init__(self, *shape):
        self.shape = shape


def _jax_weight(n, k, bits, act_bits, batched, tn):
    """A JAX PackedQuantizedTensor of the shape prepare (and to_panels_t)
    would give, with arrays that only carry their shapes."""
    G = k // GS
    big = n > jqm._SB_VMEM_MAX_N
    g_pad = 128 - G % 128 if big and G % 128 else 0
    n_pad = 2048 - n % 2048 if big and n % 2048 else 0
    kd = k // 2 if bits == 4 else k
    np_ = n + n_pad
    if tn:
        TN = jqm._pick_tn(np_, kd)
        return jqm.PackedQuantizedTensor(
            data=_Shape(np_ // TN, kd, TN), scales=_Shape(), biases=_Shape(),
            group_size=GS, bits=bits, in_features=k, act_bits=act_bits,
            n_pad=n_pad, tn=TN, g2p=32)
    return jqm.PackedQuantizedTensor(
        data=_Shape(np_, kd), scales=_Shape(np_, G + g_pad),
        biases=_Shape(np_, G + g_pad), group_size=GS, bits=bits,
        in_features=k, act_bits=act_bits, g_pad=g_pad, n_pad=n_pad,
        batched=batched)


def _port_weight(n, k, bits, act_bits, batched, tn):
    """The port's weight of that shape, built by prepare on meta tensors."""
    meta = dict(device="meta")
    tw = tqm.prepare(QuantizedTensor(
        q=torch.empty(n, k, dtype=torch.int8, **meta),
        scales=torch.empty(n, k // GS, dtype=torch.bfloat16, **meta),
        biases=torch.empty(n, k // GS, dtype=torch.bfloat16, **meta),
        group_size=GS, bits=bits), act_bits=act_bits, batched=batched)
    if tn:
        tw = tqm.to_panels(tw)
        assert tw.panels
    return tw


# shapes: a small one, Qwen3-4B's down (G = 152: the split P-kernel), its
# lm_head (padded rows and groups), G = 320 (no P-kernel), N > 32768 with
# G = 152 (no P-kernel, padded groups), and N not a multiple of 128
ROUTE_SHAPES = {"small": (256, 512), "down": (2560, 9728),
                "lm_head": (151936, 2560), "wide_g": (512, 20480),
                "big_n_wide_g": (40960, 9728), "ragged_n": (200, 512)}


@pytest.mark.parametrize("shape", list(ROUTE_SHAPES))
def test_route_matches_jax_branch(shape, monkeypatch):
    """The port's route names the branch the JAX package's quantized_matmul
    takes on the TPU, for every layout x batched x bits x act_bits and
    M in {1, 2, 16, 17, 64, 65}. The JAX dispatch runs for real with its
    backend reported as "tpu" and each formula's entry replaced by a stub
    that names it."""
    def stub(name):
        def f(*a, **k):
            raise _Routed(name)
        return f

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for attr, name in (("_qmm_pt_jit", "k1"), ("_from_panels_t", "k1_mn"),
                       ("_qmm_dq", "k1_mn"), ("_qmm_p8", "k6"),
                       ("_qmm_p4", "k6"), ("_qmm_vpu", "k7"),
                       ("_dense_tn", "dense"), ("unpack", "dense")):
        monkeypatch.setattr(jqm, attr, stub(name))
    n, k = ROUTE_SHAPES[shape]
    seen = set()
    for layout in ("rows", "batched", "panels"):
        tn = layout == "panels"
        if tn and shape == "ragged_n":
            continue                         # to_panels_t refuses it
        for bits in (4, 8):
            for act_bits in (8, None):
                jw = _jax_weight(n, k, bits, act_bits, layout == "batched",
                                 tn)
                tw = _port_weight(n, k, bits, act_bits,
                                  layout == "batched", tn)
                for M in (1, 2, 16, 17, 64, 65):
                    with pytest.raises(_Routed) as e:
                        jqm.quantized_matmul(jnp.zeros((M, k), jnp.bfloat16),
                                             jw)
                    want = e.value.args[0]
                    assert tqm.route(tw, M) == want, (layout, bits,
                                                      act_bits, M)
                    seen.add(want)
    if shape == "small":
        assert seen == {"k1", "k1_mn", "k6", "k7", "dense"}
    if shape == "lm_head":
        # Qwen3-4B's lm_head: padded, so never A5; the P-kernel up to 16
        assert tqm.route(_port_weight(n, k, 4, None, False, False), 40) \
            == "dense"


# ------------------------------------------ numpy transcriptions ---------

def _codes_rows(jw):
    """Codes of a JAX row-major weight as float32 [N, K] in natural column
    order: 4-bit unsigned u (byte j = elem[j] | elem[j + K/2] << 4), 8-bit
    centred q."""
    d = np.asarray(jw.data)
    if jw.bits == 4:
        b = d.view(np.uint8)
        return np.concatenate([b & 15, b >> 4], 1).astype(f32)
    return d.astype(f32)


def _tpu_pm(x, jw):
    """numpy transcription of the row-major P-kernel (_qmm_p + _pm_kernel,
    quant_matmul.py:592-620, :417-577): per-row int8 x (act8) or bf16 x,
    P per group, S * P summed with the row's scale, plus the bf16 group
    sums against the bias (4-bit: bf16(b - bf16(8s)), computed in bf16)."""
    M, K = x.shape
    G = K // GS
    c = _codes_rows(jw).reshape(-1, G, GS)
    s = np.asarray(jw.scales, f32)[:, :G]
    b = np.asarray(jw.biases, f32)[:, :G]
    xf = x.astype(f32)
    xg = _bf16(xf.reshape(M, G, GS).sum(-1, dtype=f32))
    if jw.act_bits == 8 or jw.bits == 4:          # 4-bit: w4a8 only
        sx = np.abs(xf).max(1) / f32(127.0) + f32(1e-12)
        cx = np.round(xf / sx[:, None])
    else:
        sx, cx = np.ones(M, f32), _bf16(xf)
    P = np.einsum("mgk,ngk->mng", cx.reshape(M, G, GS), c)
    o = sx[:, None] * (s[None] * P).sum(-1, dtype=f32)
    if jw.bits == 4:
        b = _bf16(b - _bf16(f32(8.0) * s))
    return o + xg @ b.T


def _tpu_dq(x, data, scales, biases, bits):
    """numpy transcription of _qmm_dq + _dq_kernel (quant_matmul.py
    :1141-1196, :1094-1135) on the row-major arrays it is handed: codes
    centred to bf16, times the bf16 scale expanded per column (one bf16
    rounding), x in bf16 summed in float32, plus bf16 group sums of x
    against the bf16 biases."""
    M, K = x.shape
    G = K // GS
    d = np.asarray(data)
    if bits == 4:
        b8 = d.view(np.uint8).astype(np.int32)
        c = np.concatenate([(b8 & 15) - 8, (b8 >> 4) - 8], 1).astype(f32)
    else:
        c = d.astype(f32)
    S = np.repeat(_bf16(np.asarray(scales, f32)[:, :G]), GS, 1)
    w = _bf16(c * S)
    xf = x.astype(f32)
    xg = _bf16(xf.reshape(M, G, GS).sum(-1, dtype=f32))
    return _bf16(xf) @ w.T + xg @ _bf16(np.asarray(biases, f32)[:, :G]).T


def _tpu_vpu(x, jw):
    """numpy transcription of _qmm_vpu + _vpu_kernel (quant_matmul.py
    :1253-1290, :1229-1250): x in bf16, bf16 group sums, codes u - 8 in
    bf16 times the bf16 scale (one bf16 rounding), both products summed in
    float32."""
    M, K = x.shape
    G = K // GS
    c = _codes_rows(jw) - f32(8)
    S = np.repeat(np.asarray(jw.scales, f32), GS, 1)
    w = _bf16(c * S)
    xb = _bf16(x)
    xg = _bf16(xb.reshape(M, G, GS).sum(-1, dtype=f32))
    return xb @ w.T + xg @ np.asarray(jw.biases, f32).T


def _tpu_pt8(x, pt):
    """numpy transcription of the 8-bit M=1 panel kernel (_qmm_pt bits=8
    + _pt_kernel, quant_matmul.py:979-999, :828-838, :916-927): x quantized
    per row to int8 (act8) or bf16, the group products per panel against
    the [K, TN] int8 panel, S * P summed then scaled, plus the bf16 group
    sums of x against the panel's biases."""
    K = x.shape[0]
    G = K // GS
    data = np.asarray(pt.data).astype(f32)              # [NCH, K, TN]
    NCH, _, TN = data.shape
    sc = np.asarray(pt.scales, f32)[:, :G]              # [NCH, G, TN]
    bs = np.asarray(pt.biases, f32)[:, :G]
    xf = x.astype(f32)
    if pt.act_bits == 8:
        sx = f32(np.abs(xf).max() / f32(127.0) + f32(1e-12))
        cx = np.round(xf / sx)
    else:
        sx, cx = f32(1.0), _bf16(xf)
    xg = _bf16(xf.reshape(G, GS).sum(-1, dtype=f32))
    y = np.zeros(NCH * TN, f32)
    for p in range(NCH):
        P = (cx.reshape(G, GS, 1) * data[p].reshape(G, GS, TN)).sum(1)
        y[p * TN:(p + 1) * TN] = ((sc[p] * P).sum(0, dtype=f32) * sx
                                  + xg @ bs[p])
    return y


@pytest.mark.parametrize("act_bits", [8, None])
def test_k1_w8_reference_is_the_tpu_formula(act_bits):
    """K1 at M=1 on 8-bit panels (w8a8, w8a16): the port's plain version
    within rel 1e-3 of a numpy transcription of _pt_kernel's 8-bit branch,
    reading the JAX panel layout; quantized_matmul on the CPU takes it."""
    jw, tw = _pair(_canonical(4, 384, 512, 8), 8, act_bits, panels=True)
    x = _x(5, 1, 512)
    want = _tpu_pt8(x[0], jw)
    assert tqm.route(tw, 1) == "k1"
    got = tqm.qmm_p_reference(torch.from_numpy(x), tw)
    assert _rel(got[0].numpy(), want) < 1e-3
    via = tqm.quantized_matmul(torch.from_numpy(x), tw)
    np.testing.assert_array_equal(via.numpy(), got.numpy())


@pytest.mark.parametrize("M", [2, 5, 16])
@pytest.mark.parametrize("case", ["panels_w4", "panels_w8", "batched_w4",
                                  "batched_w8"])
def test_dq_reference_is_the_tpu_formula(case, M):
    """K1 at 2 <= M <= 16 (A3's dq formula) on panels (the JAX package
    re-tiles them row-major with _from_panels_t, unfolding the 4-bit
    biases) and on batched row-major weights: the port's plain version
    within rel 1e-3 of a numpy transcription of _dq_kernel."""
    bits = 8 if case.endswith("w8") else 4
    panels = case.startswith("panels")
    can = _canonical(6, 256, 512, bits, exact_fold=not panels)
    jw, tw = _pair(can, bits, None, batched=not panels, panels=panels)
    rw = jqm._from_panels_t(jw) if panels else jw
    x = _x(7 + M, M, 512)
    want = _tpu_dq(x, rw.data, rw.scales, rw.biases, bits)
    assert tqm.route(tw, M) == "k1_mn"
    got = tqm.qmm_dq_reference(torch.from_numpy(x), tw)
    assert _rel(got.numpy(), want) < 1e-3


@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("mode", ["w4a8", "w8a8", "w8a16"])
def test_k6_reference_is_the_tpu_formula(mode, M):
    """K6 (row-major, M <= 16): the port's plain version within rel 1e-3
    of a numpy transcription of _pm_kernel, reading the JAX row-major
    layout (4-bit bytes split by K halves, unfolded biases)."""
    bits = 4 if mode.startswith("w4") else 8
    act_bits = 8 if mode.endswith("a8") else None
    jw, tw = _pair(_canonical(8, 256, 512, bits), bits, act_bits)
    x = _x(9 + M, M, 512)
    want = _tpu_pm(x, jw)
    assert tqm.route(tw, M) == "k6"
    got = tqm.qmm_p_reference(torch.from_numpy(x), tw)
    assert _rel(got.numpy(), want) < 1e-3


@pytest.mark.parametrize("M", [17, 40, 64])
def test_k7_reference_is_the_tpu_formula(M):
    """K7 (exact w4a16, row-major, M <= 64): the port's plain version
    within rel 1e-3 of a numpy transcription of _vpu_kernel."""
    jw, tw = _pair(_canonical(10, 256, 512, 4, exact_fold=True), 4, None)
    x = _x(11 + M, M, 512)
    want = _tpu_vpu(x, jw)
    assert tqm.route(tw, M) == "k7"
    got = tqm.qmm_dq_reference(torch.from_numpy(x), tw)
    assert _rel(got.numpy(), want) < 1e-3


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("layout", ["rows", "batched", "panels"])
def test_every_mode_matches_jax_cpu(layout, bits):
    """quantized_matmul on the CPU against the JAX package's CPU
    quantized_matmul (exact dequantization) on the same weights, with an
    RMSNorm, for act_bits 8 and None and M in {1, 2, 16, 17, 64, 65}:
    rel < 1e-2 for the exact formulas, < 0.05 where the route quantizes the
    activations to int8 (the a8 tolerance of tests/test_quant_ops.py)."""
    can = _canonical(12, 256, 512, bits)
    rng = np.random.default_rng(13)
    nw = _bf16(1.0 + 0.1 * rng.standard_normal(512))
    routes = set()
    for act_bits in (8, None):
        jw, tw = _pair(can, bits, act_bits, batched=layout == "batched",
                       panels=layout == "panels")
        for M in (1, 2, 16, 17, 64, 65):
            x = _x(14 + M, M, 512)
            want = jqm.quantized_matmul(jnp.asarray(x, jnp.bfloat16), jw,
                                        norm_w=jnp.asarray(nw, jnp.bfloat16))
            got = tqm.quantized_matmul(torch.from_numpy(x).bfloat16(), tw,
                                       norm_w=torch.from_numpy(nw).bfloat16())
            r = tqm.route(tw, M)
            routes.add(r)
            a8 = r in ("k1", "k6") and act_bits == 8
            assert got.dtype == torch.bfloat16 and got.shape == (M, 256)
            assert _rel(got.float().numpy(), np.asarray(want, f32)) \
                < (0.05 if a8 else 1e-2), (act_bits, M, r)
    assert "dense" in routes and len(routes) >= 2


# ------------------------------------------------------- quantize_tree ---

def _tree(seed):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(f32)

    return {"blocks": [{"attn": {"w": w(256, 512), "b": w(256)},
                        "mlp": {"w": w(384, 256)}},
                       {"small": {"w": w(128, 128)},
                        "odd": {"w": w(200, 256)}}],
            "conv": {"w": w(256, 256, 3)}, "head": {"w": w(512, 256)},
            "norm": w(256)}


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree)


@pytest.mark.parametrize("bits,batched", [(4, False), (8, True)])
def test_quantize_tree_matches_jax(bits, batched):
    """The port's generic quantizer picks the same leaves as the JAX
    package's (2-D "w", both dims multiples of 128 and >= min_dim) and
    gives the same codes and scales, biases within the 4-bit fold's one
    ulp, row-major with the batched flag asked for."""
    src = _tree(16)
    jt = jquant.quantize_tree(_to_jax(src), GS, bits, batched=batched)
    tt = tquant.quantize_tree(_to_torch(src), GS, bits, batched=batched)
    paths = [("blocks", 0, "attn"), ("blocks", 0, "mlp"),
             ("blocks", 1, "small"), ("blocks", 1, "odd"), ("conv",),
             ("head",)]
    for path in paths:
        jn, tn = jt, tt
        for p in path:
            jn, tn = jn[p], tn[p]
        jq = isinstance(jn["w"], jqm.PackedQuantizedTensor)
        assert jq == isinstance(tn["w"], tqm.PackedQuantizedTensor), path
        if not jq:
            np.testing.assert_array_equal(tn["w"].numpy(),
                                          np.asarray(jn["w"]))
            continue
        assert tn["w"].batched == batched and not tn["w"].panels
        ju, tu = jqm.unpack(jn["w"]), tqm.unpack(tn["w"])
        np.testing.assert_array_equal(tu.q.numpy(), np.asarray(ju.q))
        s = np.asarray(ju.scales, f32)
        np.testing.assert_array_equal(tu.scales.float().numpy(), s)
        b = np.asarray(ju.biases, f32)
        assert np.all(np.abs(tu.biases.float().numpy() - b)
                      <= 2.0 ** -8 * (np.abs(b) + 8 * s))
    assert isinstance(tt["blocks"][0]["attn"]["w"], tqm.PackedQuantizedTensor)
    torch.testing.assert_close(tt["blocks"][0]["attn"]["b"],
                               _to_torch(src)["blocks"][0]["attn"]["b"])


def test_quantize_tree_channel8_and_scheme_check():
    """scheme="channel8" gives the JAX package's per-channel int8 leaves;
    an unknown scheme raises in the port, where the JAX package quantizes
    it as group weights (ROADMAP Queue C)."""
    src = _tree(17)
    jt = jquant.quantize_tree(_to_jax(src), scheme="channel8")
    tt = tquant.quantize_tree(_to_torch(src), scheme="channel8")
    jw, tw = jt["head"]["w"], tt["head"]["w"]
    assert isinstance(tw, tqm.ChannelQuantizedTensor)
    np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
    np.testing.assert_allclose(tw.scale.numpy(), np.asarray(jw.scale),
                               rtol=1e-6)
    assert isinstance(jquant.quantize_tree(_to_jax(src), scheme="int3")
                      ["head"]["w"], jqm.PackedQuantizedTensor)
    with pytest.raises(ValueError):
        tquant.quantize_tree(_to_torch(src), scheme="int3")


# (layout, bits, act_bits, M, route) of the float32-activation test
F32_CASES = {"k1_w8a8": ("panels", 8, 8, 1, "k1"),
             "k1_w8a16": ("panels", 8, None, 1, "k1"),
             "k1_w4a8": ("panels", 4, 8, 1, "k1"),
             "k1_mn_w4": ("batched", 4, None, 5, "k1_mn"),
             "k1_mn_w8": ("batched", 8, 8, 16, "k1_mn"),
             "k6_w4a8_m1": ("rows", 4, 8, 1, "k6"),
             "k6_w4a8": ("rows", 4, 8, 4, "k6"),
             "k6_w8a8": ("rows", 8, 8, 16, "k6"),
             "k6_w8a16": ("rows", 8, None, 4, "k6"),
             "k7": ("rows", 4, None, 40, "k7")}


@pytest.mark.parametrize("case", list(F32_CASES))
def test_float32_x_takes_the_tpu_formula(case):
    """float32 activations: the JAX formulas quantize and group-sum x as it
    is, unrounded (A4 quant_matmul.py:603-608, A1 8-bit :980-983, the dq
    formula's group sums :1150-1153), and round it to bf16 first only where
    A1 and A4 read a raw bf16 x at M=1 on 4-bit weights (act_ik) and in A5
    (:1256). The port's plain version on float32 x within rel 1e-5 of the
    numpy transcription given the same float32 x, and float32 out. Rounding
    x to bf16 where the formula does not (the port before this test) read
    1.6e-4 to 7.9e-3 here."""
    layout, bits, act_bits, M, path = F32_CASES[case]
    can = _canonical(30, 256, 512, bits, exact_fold=layout != "panels")
    jw, tw = _pair(can, bits, act_bits, batched=layout == "batched",
                   panels=layout == "panels")
    x = np.random.default_rng(31 + M).standard_normal((M, 512)).astype(f32)
    assert tqm.route(tw, M) == path
    got = tqm.quantized_matmul(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32
    if path == "k7" or (bits == 4 and M == 1):
        # the formula rounds x first: the same float32 result as x in bf16
        via_bf16 = tqm.quantized_matmul(torch.from_numpy(_bf16(x)), tw)
        assert torch.equal(got, via_bf16)
        x = _bf16(x)
    if path == "k1" and bits == 4:
        return              # 4-bit panels: as bf16 x (the tests above)
    if path == "k1":
        want = _tpu_pt8(x[0], jw)[None]
    elif path == "k1_mn":
        want = _tpu_dq(x, jw.data, jw.scales, jw.biases, bits)
    elif path == "k7":
        want = _tpu_vpu(x, jw)
    else:
        want = _tpu_pm(x, jw)
    assert _rel(got.numpy(), want) < 1e-5
