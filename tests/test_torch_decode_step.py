"""The engine's decode step (``core.generate.DecodeStep``: the forward at
T = 1 at a [B] int64 offset tensor, the sampler and the step's in-place
updates, captured as a CUDA graph on the card) against what it replaces
and against the JAX package, on the CPU, where the step's body runs
directly.

For the nine families the port serves (Qwen3; Qwen3-MoE with 4-bit and
with channel-int8 experts; Mistral with a sliding window; GLM-4;
Mixtral; GLM-4-MoE; DeepSeek with MLA; Qwen3-Next; MiniCPM-SALA), small
random models in float32 (the families' own test helpers):

* 8 steps of the body at B = 1 against the int-offset step the engine ran
  before (``forward`` at a host int offset, then the sampler): the same
  logits and every cache tensor equal bit for bit, except where the
  tensor offset takes another op (named in ``OTHER_OPS``), held there
  within 1e-6 relative with the greedy tokens equal;
* greedy tokens of the port's ``generate``, ``generate_scan`` and
  ``generate_batch`` equal to the JAX package's ``generate_scan`` and
  ``generate_batch`` token for token (a stop token and ragged lengths
  where the family's cache allows them), the body's logits within the
  family tests' float32 tolerance of the JAX forward's.

Also the repetition-penalty window against the JAX step's ``recent``, and
``ops._build.recording`` without a capture."""

import copy
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_families as fam
import test_torch_minicpm as mcpm
import test_torch_moe as moe4
import test_torch_moe8 as moe8
import test_torch_moe_families as moef
import test_torch_qwen3_next as qnext
from ominix_mlx_tpu.core.generate import Engine as JEngine
from ominix_mlx_tpu.core.sampling import SamplerConfig as JSampler
from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import glm4 as jglm4
from ominix_mlx_tpu.models import minicpm_sala as jms
from ominix_mlx_tpu.models import mistral as jmistral
from ominix_mlx_tpu.models import qwen3_next as jqn
from ominix_mlx_tpu_torch.core.cache import ModelCache
from ominix_mlx_tpu_torch.core.generate import DecodeStep, Engine
from ominix_mlx_tpu_torch.core.sampling import SamplerConfig, sample
from ominix_mlx_tpu_torch.models import base as tbase
from ominix_mlx_tpu_torch.models import glm4 as tglm4
from ominix_mlx_tpu_torch.models import minicpm_sala as tms
from ominix_mlx_tpu_torch.models import mistral as tmistral
from ominix_mlx_tpu_torch.models import qwen3_next as tqn
from ominix_mlx_tpu_torch.ops import _build

torch.set_num_threads(2)

STEPS = 8
OTHER_OP_TOL = 1e-6
# the families whose tensor-offset body takes another op than the int
# offset's, and the op: MiniCPM-SALA's sparse layers re-pool the touched
# block of SparseKVCache.update from a gathered [B, ks, Hkv, D] region
# (per-row blocks) where the int offset pools a slice of the cache
OTHER_OPS = {"minicpm_sala": "SparseKVCache.update's gathered re-pooling"}
FAMILIES = ("qwen3", "qwen3_moe_w4", "qwen3_moe_channel8", "mistral_window",
            "glm4", "mixtral", "glm4_moe", "deepseek_v3", "qwen3_next",
            "minicpm_sala")


@dataclasses.dataclass
class Family:
    jfwd: object          # (params, tokens, cache, **kw) of the JAX package
    tfwd: object          # the same of the port
    jp: dict
    tp: dict
    jcache: object        # (batch, max_len) -> JAX cache
    tcache: object        # (batch, max_len) -> the port's CPU cache
    prompt: np.ndarray    # [T] token ids
    tol: float            # the family tests' float32 logits tolerance
    ragged: bool          # right-padded prompts of other lengths allowed
    max_len: int = 64     # the caches' capacity


def _hf_dense(name):
    from transformers import MistralConfig, Qwen3Config
    from transformers.models.mistral import MistralForCausalLM
    from transformers.models.qwen3 import Qwen3ForCausalLM

    torch.manual_seed(0)
    if name == "qwen3":
        hf = Qwen3ForCausalLM(Qwen3Config(**fam.SMALL, head_dim=16,
                                          tie_word_embeddings=True)).eval()
        raw, jmod, tmod = (hf.config.to_dict() | {"model_type": "qwen3"},
                           jbase, tbase)
    elif name == "mistral_window":
        hf = MistralForCausalLM(MistralConfig(**fam.SMALL,
                                              sliding_window=4)).eval()
        raw, jmod, tmod = (hf.config.to_dict() | {"model_type": "mistral"},
                           jmistral, tmistral)
    else:
        hf, raw = fam._glm4_hf()
        jmod, tmod = jglm4, tglm4
    jf, tf = fam._flat(hf)
    jcfg = (jbase.TransformerConfig.from_hf(raw) if jmod is jbase
            else jmod.config_from_hf(raw))
    tcfg = (tbase.TransformerConfig.from_hf(raw) if tmod is tbase
            else tmod.config_from_hf(raw))
    # Mistral's trees are the base decoder's
    jp = (jglm4 if jmod is jglm4 else jbase).params_from_flat(jf, jcfg)
    tp = (tglm4 if tmod is tglm4 else tbase).params_from_flat(
        tf, tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _base_family(jcfg, tcfg, jp, tp, prompt, tol=1e-4, jinit=None,
                 tinit=None):
    jinit = jinit or jbase.init_cache
    tinit = tinit or tbase.init_cache
    return Family(
        jfwd=lambda p, t, c, **kw: jbase.forward(p, jcfg, t, c, **kw),
        tfwd=lambda p, t, c, **kw: tbase.forward(p, tcfg, t, c, **kw),
        jp=jp, tp=tp,
        jcache=lambda B, L: jinit(jcfg, B, L, jnp.float32),
        tcache=lambda B, L: tinit(tcfg, B, L, torch.float32, device="cpu"),
        prompt=prompt, tol=tol, ragged=tcfg.layer_types is None)


@functools.lru_cache(maxsize=None)
def _family(name) -> Family:
    rng = np.random.default_rng(7)
    if name in ("qwen3", "mistral_window", "glm4"):
        return _base_family(*_hf_dense(name), fam.TOKENS[0])
    if name in ("qwen3_moe_w4", "qwen3_moe_channel8"):
        # 4-bit experts: the 16-token bucket's prefill takes the sorted
        # dispatch on experts dequantized once, the JAX package scans
        # every expert: bf16 roundings apart (test_torch_moe's 2e-2)
        jp, tp = (moe4._quantized_pair(1, act_bits=None)
                  if name == "qwen3_moe_w4"
                  else moe8._quantized_pair(3, "channel8"))
        return _base_family(moe4.JCFG, moe4.TCFG, jp, tp,
                            rng.integers(0, 512, 12),
                            tol=2e-2 if name == "qwen3_moe_w4" else 1e-4)
    if name in ("mixtral", "glm4_moe", "deepseek_v3"):
        _, _, jmod, tmod, jcfg, tcfg, jp, tp = moef._build(name)
        return _base_family(jcfg, tcfg, jp, tp, moef.TOKENS[0],
                            jinit=jmod.init_cache, tinit=tmod.init_cache)
    if name == "qwen3_next":
        _, _, jcfg, tcfg, jp, tp = qnext._build()
        return _base_family(jcfg, tcfg, jp, tp, qnext.TOKENS[0],
                            jinit=jqn.init_cache, tinit=tqn.init_cache)
    jcfg, tcfg, jp, tp = mcpm._pair()
    return Family(
        jfwd=lambda p, t, c, **kw: jms.forward(p, jcfg, t, c, **kw),
        tfwd=lambda p, t, c, **kw: tms.forward(p, tcfg, t, c, **kw),
        jp=jp, tp=tp,
        jcache=lambda B, L: jms.init_cache(jcfg, B, L, jnp.float32),
        tcache=lambda B, L: tms.init_cache(tcfg, B, L, torch.float32,
                                           device="cpu"),
        prompt=mcpm.PROMPT[0, :60], tol=mcpm.PORT_TOL, ragged=False,
        max_len=160)


def _engines(f: Family, sampler=None):
    je = JEngine(f.jfwd, f.jp, JSampler(**(sampler or {})),
                 prefill_forward_fn=lambda p, t, c: f.jfwd(
                     p, t, c, fresh_prefill=True))
    te = Engine(f.tfwd, f.tp, SamplerConfig(**(sampler or {})),
                prefill_forward_fn=lambda p, t, c: f.tfwd(
                    p, t, c, fresh_prefill=True))
    return je, te


def _cache_tensors(cache: ModelCache):
    for i, lc in enumerate(cache.layers):
        for fld in dataclasses.fields(lc):
            t = getattr(lc, fld.name)
            if isinstance(t, torch.Tensor):
                yield f"layer {i} {fld.name}", t


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", FAMILIES)
def test_tensor_offset_body_matches_the_int_offset_step(name):
    """8 steps of the step body at a [B] offset against the int-offset
    step (forward at cache.offset, then the sampler), from one prefilled
    cache: bit-equal logits and caches, or, for OTHER_OPS, within 1e-6
    relative with the tokens equal."""
    f = _family(name)
    _, te = _engines(f)
    with torch.inference_mode():
        last, cache = te.prefill(torch.from_numpy(f.prompt)[None],
                                 f.tcache(1, f.max_len))
        tok = sample(last, None, te.sampler)
        ref = copy.deepcopy(cache)
        step = te.decode_step(cache, tok.clone())
        ref_tok = tok.clone()
        for i in range(STEPS):
            lg, ref = f.tfwd(f.tp, ref_tok[:, None], ref)
            lg = lg[:, -1]
            ref_tok = sample(lg, None, te.sampler)
            step()
            assert step.offset.tolist() == [ref.offset] == \
                [step.offset_host]
            assert step.tok.tolist() == ref_tok.tolist(), f"step {i}"
            pairs = [("logits", step.logits, lg)] + [
                (k, a, b) for (k, a), (_, b) in zip(
                    _cache_tensors(step.cache), _cache_tensors(ref))]
            for what, got, want in pairs:
                if name in OTHER_OPS:
                    assert _rel(got, want) <= OTHER_OP_TOL, \
                        f"{what} at step {i} ({OTHER_OPS[name]})"
                else:
                    assert torch.equal(got, want), f"{what} at step {i}"


def _jax_greedy_logits(f: Family, steps):
    """The JAX forward's logits of a fresh prefill of the prompt, then of
    ``steps`` one-token steps feeding their argmax."""
    jc = f.jcache(1, f.max_len)
    jt = jnp.asarray(f.prompt[None])
    out = []
    for i in range(steps + 1):
        jl, jc = f.jfwd(f.jp, jt, jc, fresh_prefill=i == 0)
        jl = np.asarray(jl[:, -1], np.float32)
        out.append(jl)
        jt = jnp.asarray(jl.argmax(-1)[:, None])
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_greedy_loops_match_jax(name):
    """Greedy generate, generate_scan and generate_batch against the JAX
    package's generate_scan and generate_batch, token for token, and the
    body's logits at each step against the JAX forward's (the family's
    tolerance). generate_batch: two rows with a stop token, right-padded
    ragged prompts where the family's caches allow them."""
    f = _family(name)
    je, te = _engines(f)
    n = STEPS
    p = f.prompt
    want, _ = je.generate_scan(jnp.asarray(p[None]), f.jcache(1, f.max_len),
                               max_tokens=n)
    want = np.asarray(want)[0].tolist()
    got, out_cache = te.generate_scan(torch.from_numpy(p)[None],
                                      f.tcache(1, f.max_len), max_tokens=n)
    assert got[0].tolist() == want
    assert out_cache.offset == len(p) + n
    assert list(te.generate(torch.from_numpy(p), f.tcache(1, f.max_len),
                            max_tokens=n)) == want

    # the body's logits against the JAX forward's
    jlog = _jax_greedy_logits(f, 3)
    with torch.inference_mode():
        last, cache = te.prefill(torch.from_numpy(p)[None], f.tcache(1, f.max_len))
        assert _rel(last, jlog[0]) < f.tol
        step = te.decode_step(cache, sample(last, None, te.sampler))
        for i in range(3):
            step()
            assert _rel(step.logits, jlog[i + 1]) < f.tol, f"step {i}"

    # generate_batch: a stop token, ragged rows where allowed
    T = len(p)
    lens = np.array([T - 3, T]) if f.ragged else np.array([T, T])
    second = np.roll(p, 3)
    prompts = np.stack([np.where(np.arange(T) < lens[0], p, 0), second])
    free, _ = je.generate_batch(jnp.asarray(prompts), f.jcache(2, f.max_len),
                                max_tokens=n, prompt_lengths=lens)
    stop = int(np.asarray(free)[0, 2])
    jt, jlen = je.generate_batch(jnp.asarray(prompts), f.jcache(2, f.max_len),
                                 max_tokens=n, stop_tokens=(stop,),
                                 pad_id=-1, prompt_lengths=lens)
    tt, tlen = te.generate_batch(torch.from_numpy(prompts), f.tcache(2, f.max_len),
                                 max_tokens=n, stop_tokens=(stop,),
                                 pad_id=-1, prompt_lengths=lens)
    assert tt.tolist() == np.asarray(jt).tolist()
    assert tlen.tolist() == np.asarray(jlen).tolist()
    assert -1 in tt[0].tolist()


def test_repetition_window_rolls_as_jax_recent():
    """With a repetition penalty, the step's window after each of 12
    steps equals the JAX decode step's ``recent`` (a window of 5 ids, so
    it rolls), and so do the greedy tokens it penalises."""
    f = _family("qwen3")
    sampler = {"repetition_penalty": 1.5, "repetition_context": 5}
    je, te = _engines(f, sampler)
    p = f.prompt
    jl, jc = je.prefill(jnp.asarray(p[None]), f.jcache(1, f.max_len))
    jrecent = jnp.full((1, 5), -1, jnp.int32)
    jtok = jnp.argmax(jl, -1)
    jrecent = jrecent.at[:, -1].set(jtok)
    with torch.inference_mode():
        last, cache = te.prefill(torch.from_numpy(p)[None], f.tcache(1, f.max_len))
        recent = torch.full((1, 5), -1, dtype=torch.long)
        tok = sample(last, None, te.sampler, recent)
        recent[:, -1] = tok
        assert tok.tolist() == np.asarray(jtok).tolist()
        step = te.decode_step(cache, tok, recent=recent)
        for i in range(12):
            jtok, _, jc, jrecent = je._decode_jit(
                je.params, jc, jtok, jax.random.PRNGKey(0), jrecent,
                sampler=je.sampler)
            step()
            assert step.tok.tolist() == np.asarray(jtok).tolist(), i
            assert recent.tolist() == np.asarray(jrecent).tolist(), i


def test_recording_counts_each_replay_as_an_eager_run():
    """Inside ``_build.recording`` (no capture, no card) a wrapper's
    increment of LAUNCHES and an ``on_run`` action go to the record;
    another thread counts as usual meanwhile; N ``replayed`` calls add
    what N eager runs of the recorded work would; a ReplayedCounter other
    than LAUNCHES is carried the same way."""
    _build.reset_launches()
    seen = []
    forwards = _build.ReplayedCounter()

    def wrapper_calls():
        _build.LAUNCHES["k1_m1"] += 1
        _build.LAUNCHES["k4"] += 2
        forwards["decode"] += 1
        _build.on_run(lambda: seen.append("ran"))

    wrapper_calls()
    eager = dict(_build.LAUNCHES), dict(forwards), list(seen)
    with _build.recording() as record:
        wrapper_calls()
        other = threading.Thread(
            target=lambda: _build.LAUNCHES.update({"k3": 1}))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
        assert _build.LAUNCHES == {"k1_m1": 1, "k4": 2, "k3": 1}
        assert forwards == {"decode": 1} and seen == ["ran"]
    _build.replayed(record, 3)
    assert _build.LAUNCHES == {"k1_m1": 4, "k4": 8, "k3": 1}
    assert forwards == {"decode": 4} and seen == ["ran"] * 4
    assert eager == ({"k1_m1": 1, "k4": 2}, {"decode": 1}, ["ran"])
    _build.reset_launches()


def test_decode_step_owns_its_offsets_and_mirrors_them():
    """The step copies a [B] offset (and needs its host mirror) or fills
    one from an int; ``advance`` moves the offsets and the step index in
    place; on the CPU a call is the body."""
    cache = ModelCache(layers=[], offset=torch.tensor([3, 5]))
    tok = torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError, match="host mirror"):
        DecodeStep(cache, tok)
    step = DecodeStep(cache, tok, start=5)
    step.body = lambda: step.advance(torch.tensor([1, 0]))
    step()
    step()
    assert cache.offset.tolist() == [3, 5]
    assert step.offset.tolist() == [5, 5] and step.index.tolist() == [2]
    assert step.offset_host == 7 and not step.captured.graphs
    step = DecodeStep(ModelCache(layers=[], offset=4), tok)
    step.body = step.advance
    step()
    assert step.offset.tolist() == [5, 5] and step.offset_host == 5
