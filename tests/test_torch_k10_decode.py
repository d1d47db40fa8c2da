"""A lightning layer's decode step in the PyTorch port (models/
minicpm_sala.py ``_lightning_attn`` at T = 1, which runs
ops/lightning_attention.py ``lightning_decode``: kernel k10_decode on
CUDA, its plain version ``lightning_decode_reference`` on the CPU) against
the JAX package's (ominix_mlx_tpu/models/minicpm_sala.py:158-184) on the
same seeded numpy weights, in float32 on the CPU: each of the layer's four
flags on and off, at an int offset and at per-row offsets, and the state
carried over 8 steps. Both sides sum in float32 in another order (the
norms' means, the projections, the state step), so outputs and states are
held within DECODE_TOL of their largest magnitude; with RoPE on, the
packages' float32 exp of the frequencies may differ by an ulp, which
turns the angle at position p by up to about p 2^-23 radians, so the
limit grows by ROPE_TOL_PER_POSITION a position (positions here stay near
a thousand; the kernel at 524287 is held to the plain version on the
card). In bf16 the model's path is the unfused composition it replaced,
bit for bit."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import lightning as jgla
from ominix_mlx_tpu.models import minicpm_sala as jms
from ominix_mlx_tpu_torch.models import lightning as tgla
from ominix_mlx_tpu_torch.models import minicpm_sala as tms
from ominix_mlx_tpu_torch.nn.layers import linear, rms_norm
from ominix_mlx_tpu_torch.ops import lightning_attention as la
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(2)

DECODE_TOL = 2e-5
ROPE_TOL_PER_POSITION = 2 ** -22
B, H, HD, HID = 3, 4, 128, 64
# one lightning layer at MiniCPM-SALA's head width, a narrow model
CONFIG = dict(model_type="minicpm_sala", vocab_size=256, hidden_size=HID,
              num_hidden_layers=1, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, intermediate_size=128,
              qk_norm=True, lightning_nh=H, lightning_head_dim=HD,
              mixer_types=["lightning-attn"])
FLAGS = ("qk_norm", "lightning_use_rope", "use_output_norm",
         "use_output_gate")
OFFSETS = (1000, np.array([0, 300, 1023], np.int64))


def _layer(seed=0):
    """A lightning layer's numpy weights: projections uniform +-1/sqrt(in),
    the norms near one."""
    g = np.random.default_rng(seed)

    def w(o, i):
        return {"w": ((g.random((o, i)) * 2 - 1) * i ** -0.5).astype(
            np.float32)}

    def near_one(n):
        return (1 + 0.1 * g.standard_normal(n)).astype(np.float32)

    W = H * HD
    return {"q_proj": w(W, HID), "k_proj": w(W, HID), "v_proj": w(W, HID),
            "z_proj": w(W, HID), "o_proj": w(HID, W), "q_norm": near_one(HD),
            "k_norm": near_one(HD), "o_norm": near_one(W)}


def _configs(**flags):
    jcfg = dataclasses.replace(jms.MiniCPMConfig.from_hf(CONFIG), **flags)
    tcfg = dataclasses.replace(tms.MiniCPMConfig.from_hf(CONFIG), **flags)
    return jcfg, tcfg


def _offsets(offset):
    if isinstance(offset, np.ndarray):
        return jnp.asarray(offset, jnp.int32), torch.from_numpy(offset)
    return offset, offset


def _tol(flags, offset, steps=1):
    """DECODE_TOL, and with RoPE the angle's drift at the last position."""
    last = int(np.max(offset)) + steps - 1
    return DECODE_TOL + (ROPE_TOL_PER_POSITION * last
                         if flags["lightning_use_rope"] else 0.0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _steps(flags, offset, steps=1, seed=0):
    """``steps`` decode steps of the layer in both packages from the same
    random state: [(port out, JAX out)] and the final states."""
    jcfg, tcfg = _configs(**flags)
    lp = _layer(seed)
    jlp = jax.tree_util.tree_map(jnp.asarray, lp)
    tlp = params_from_numpy(lp, "cpu")
    g = np.random.default_rng(seed + 1)
    s0 = (g.standard_normal((B, H, HD, HD)) * 0.1).astype(np.float32)
    jc = jgla.GLACache(state=jnp.asarray(s0))
    tc = tgla.GLACache(state=torch.from_numpy(s0.copy()))
    outs = []
    for t in range(steps):
        x = g.standard_normal((B, 1, HID)).astype(np.float32)
        jo, to = _offsets(offset + t)
        want, jc = jms._lightning_attn(jlp, jcfg, jnp.asarray(x), jc, jo)
        got, tc = tms._lightning_attn(tlp, tcfg, torch.from_numpy(x), tc, to)
        outs.append((got, want))
    return outs, tc.state, jc.state


@pytest.mark.parametrize("offset", OFFSETS, ids=["int", "per_row"])
@pytest.mark.parametrize("on", list(itertools.product((True, False),
                                                      repeat=4)),
                         ids=lambda on: "".join("1" if f else "0"
                                                for f in on))
def test_decode_step_matches_jax(on, offset):
    """One step with each combination of QK-norm, RoPE, the output norm and
    the gate: the layer's output (after o_proj) and the state."""
    flags = dict(zip(FLAGS, on))
    outs, ts, js = _steps(flags, offset)
    (got, want), = outs
    assert got.shape == (B, 1, HID)
    assert _rel(got, want) < _tol(flags, offset)
    assert _rel(ts, js) < _tol(flags, offset)


@pytest.mark.parametrize("offset", OFFSETS, ids=["int", "per_row"])
def test_state_carried_over_eight_steps(offset):
    """Eight steps in a row, every output and the final state."""
    flags = dict.fromkeys(FLAGS, True)
    outs, ts, js = _steps(flags, offset, steps=8, seed=3)
    for got, want in outs:
        assert _rel(got, want) < _tol(flags, offset, 8)
    assert _rel(ts, js) < _tol(flags, offset, 8)


def _unfused(lp, cfg, x, cache, offset):
    """The decode step as the model composed it before k10_decode: QK-norm
    and RoPE, the scale, K10's step, the cast, the output norm, the gate,
    o_proj."""
    B_, T, _ = x.shape
    q, k, v = tms._qkv(lp, x, H, H, HD)
    q, k = tms._norm_rope(lp, cfg, q, k, offset, cfg.lightning_use_rope)
    q = q * HD ** -0.5
    out = la.lightning_attention(q, k, v, tgla.slopes_on(H, x.device),
                                 cache.state)
    out = out.transpose(1, 2).reshape(B_, T, H * HD).to(x.dtype)
    if cfg.use_output_norm:
        out = rms_norm(lp["o_norm"], out, cfg.rms_norm_eps)
    if cfg.use_output_gate:
        out = out * torch.sigmoid(linear(lp["z_proj"], x))
    return linear(lp["o_proj"], out)


@pytest.mark.parametrize("offset", OFFSETS, ids=["int", "per_row"])
@pytest.mark.parametrize("flags", [dict.fromkeys(FLAGS, True),
                                   dict.fromkeys(FLAGS, False)],
                         ids=["all_on", "all_off"])
def test_cpu_model_path_is_the_unfused_composition(flags, offset):
    """In bf16 on the CPU, the model's decode step (lightning_decode's
    plain version) gives the unfused composition's output and state bit
    for bit."""
    _, tcfg = _configs(**flags)
    tlp = params_from_numpy(_layer(5), "cpu", torch.bfloat16)
    g = np.random.default_rng(6)
    s0 = torch.from_numpy(
        (g.standard_normal((B, H, HD, HD)) * 0.1).astype(np.float32))
    x = torch.from_numpy(g.standard_normal((B, 1, HID)).astype(
        np.float32)).bfloat16()
    off = _offsets(offset)[1]
    c1, c2 = tgla.GLACache(state=s0.clone()), tgla.GLACache(state=s0.clone())
    got, _ = tms._lightning_attn(tlp, tcfg, x, c1, off)
    want = _unfused(tlp, tcfg, x, c2, off)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert torch.equal(c1.state, c2.state)


def test_plain_version_writes_q_and_k():
    """``qk_out`` receives q (normalized, rotated, scaled) and k as the
    state step reads them."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, H, 1, HD, generator=g).bfloat16()
               for _ in range(3))
    w = torch.ones(HD, dtype=torch.bfloat16)
    qk = torch.empty(2, 2, H * HD, dtype=torch.bfloat16)
    state = torch.zeros(2, H, HD, HD)
    la.lightning_decode_reference(q, k, v, tgla.slopes_on(H, "cpu"), state,
                                  q_norm=w, k_norm=w, rope_theta=1e4,
                                  offset=7, qk_out=qk)
    qn, kn = la.norm_rope(q, k, w, w, 1e-6, 1e4, 7)
    assert torch.equal(qk[:, 0], (qn * HD ** -0.5).reshape(2, H * HD))
    assert torch.equal(qk[:, 1], kn.reshape(2, H * HD))


@pytest.mark.parametrize("rows,n,width", [
    (1, 4096, 512), (2, 4096, 256), (4, 4096, 128), (8, 4096, 64),
    (16, 4096, 32), (64, 4096, 32), (1, 512, 128), (3, 512, 128),
    (8, 512, 64), (1, 128, 32), (32, 128, 32), (256, 128, 32)])
def test_reduce_width(rows, n, width):
    """The x-width of PyTorch's CUDA reduction block for a [rows, n] mean
    (Reduce.cuh setReduceConfig by hand: 4-vectors along n, at most 512
    threads, 32 lanes first, then the rows, then the rest of n): the
    order in which k10_decode sums the output norm's squares."""
    assert la.reduce_width(rows, n) == width


def test_decode_is_one_step_of_the_plain_rule():
    """With every flag off the mixer is K10's one step, cast: the output
    is decay_step_reference's, rounded once."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, H, 1, HD, generator=g) for _ in range(3))
    sl = tgla.slopes_on(H, "cpu")
    s1, s2 = torch.randn(2, H, HD, HD, generator=g), None
    s2 = s1.clone()
    got = la.lightning_decode(q, k, v, sl, s1)
    want = la.decay_step_reference(q * HD ** -0.5, k, v, sl, s2)
    assert torch.equal(got, want.transpose(1, 2).reshape(2, 1, H * HD))
    assert torch.equal(s1, s2)
