"""The Qwen3-Next hybrid in the port (models/qwen3_next.py on
models/base.py): Gated DeltaNet layers and gated full-attention layers,
each followed by a MoE with a gated shared expert, against the JAX
package and HF ``Qwen3NextForCausalLM`` (random HF models, no download),
on the CPU.

Tolerances: port vs JAX logits 1e-4 in float32 (the same weights and
formulas; sums in another order); both vs HF 5e-3 (the JAX package's own
limit, tests/test_model_parity.py); one-shot prefill vs token-by-token
decode and chunked vs whole prefill 2e-4 (the JAX package's,
tests/test_model_parity.py and tests/test_batching.py); the quantized
w4a8 hybrid vs the JAX package's within rel 0.05 on bf16 activations
(the bound of tests/test_torch_moe_families.py); greedy tokens equal."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import qwen3_next as jqn
from ominix_mlx_tpu.models import registry as jregistry
from ominix_mlx_tpu.ops import quant_matmul as jqm
from ominix_mlx_tpu_torch.core.generate import Engine
from ominix_mlx_tpu_torch.core.quant import (QuantizedTensor, dequantize,
                                            quantize_tensor)
from ominix_mlx_tpu_torch.models import base as tbase
from ominix_mlx_tpu_torch.models import qwen3_next as tqn
from ominix_mlx_tpu_torch.models import registry
from ominix_mlx_tpu_torch.models.deltanet import RecurrentCache
from ominix_mlx_tpu_torch.ops.quant_matmul import (PackedQuantizedExperts,
                                                   PackedQuantizedTensor)
from ominix_mlx_tpu_torch.serving import server as tserver
from ominix_mlx_tpu_torch.serving.batching import (ContinuousBatcher,
                                                   PagedContinuousBatcher)
from ominix_mlx_tpu_torch.utils.loading import save_sharded
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(2)

PORT_TOL = 1e-4
HF_TOL = 5e-3
STEP_TOL = 2e-4
QUANT_REL = 0.05
TOKENS = np.array([[5, 17, 99, 3, 42, 7, 18, 1]])

# the 2-layer hybrid of tests/test_model_parity.py (linear, full)
SMALL = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             intermediate_size=64, moe_intermediate_size=16, num_experts=4,
             num_experts_per_tok=2, shared_expert_intermediate_size=32,
             norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[],
             linear_num_value_heads=4, linear_num_key_heads=2,
             linear_key_head_dim=8, linear_value_head_dim=8,
             linear_conv_kernel_dim=3,
             layer_types=["linear_attention", "full_attention"],
             partial_rotary_factor=0.25, pad_token_id=0)
# widths that group size 32 divides, for the quantized comparison; three
# layers, the last with a dense MLP (mlp_only_layers)
WIDE = dict(SMALL, hidden_size=64, moe_intermediate_size=32,
            shared_expert_intermediate_size=64, intermediate_size=64,
            linear_key_head_dim=16, linear_value_head_dim=16,
            num_hidden_layers=3, mlp_only_layers=[2],
            layer_types=["linear_attention", "full_attention",
                         "linear_attention"])


def _hf(d=SMALL, seed=0):
    from transformers import Qwen3NextConfig
    from transformers.models.qwen3_next import Qwen3NextForCausalLM
    torch.manual_seed(seed)
    hf = Qwen3NextForCausalLM(Qwen3NextConfig(**d)).eval()
    with torch.no_grad():      # norms off their init, so the +1 fold shows
        for n, p in hf.named_parameters():
            if n.endswith("norm.weight"):
                p.normal_(0, 0.1)
        for lyr in hf.model.layers:
            la = getattr(lyr, "linear_attn", None)
            if la is not None:     # slow heads (Mamba-2's dt init): the
                # state carries far, so a chunk or a slot that loses it
                # shows
                dt = torch.exp(torch.rand(la.dt_bias.shape)
                               * np.log(100.0) + np.log(1e-3))
                la.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
    return hf


def _build(d=SMALL, seed=0):
    hf = _hf(d, seed)
    raw = hf.config.to_dict() | {"model_type": "qwen3_next"}
    sd = {k: v.detach().float() for k, v in hf.state_dict().items()}
    jf = {k: jnp.asarray(v.numpy()) for k, v in sd.items()}
    jcfg, tcfg = jqn.config_from_hf(raw), tqn.config_from_hf(raw)
    jp = jqn.params_from_flat(jf, jcfg, raw)
    tp = tqn.params_from_flat(sd, tcfg, raw, device="cpu")
    return hf, raw, jcfg, tcfg, jp, tp


def _cache(tcfg, batch=1, max_len=32, dtype=torch.float32):
    return tqn.init_cache(tcfg, batch, max_len, dtype, device="cpu")


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_config_from_hf_matches_jax():
    """Every field equals the JAX package's; the DeltaNet and MoE configs
    field by field."""
    _, _, jcfg, tcfg, _, _ = _build()
    for k, v in _fields(tcfg).items():
        jv = getattr(jcfg, k)
        if k in ("moe", "deltanet"):
            assert _fields(v) == _fields(jv)
        else:
            assert v == jv, k
    assert tcfg.layer_types == ("linear_attention", "full_attention")
    assert tcfg.moe.n_shared_experts == 0 and tcfg.use_qk_norm


def test_logits_match_jax_and_hf():
    """The 2-layer hybrid's logits: port vs JAX at 1e-4, both vs HF at
    5e-3; the tree holds the folded norms (+1), a linear_attn layer, a
    split q_proj / g_proj and a shared expert with its gate."""
    hf, _, jcfg, tcfg, jp, tp = _build()
    with torch.no_grad():
        want = hf(torch.from_numpy(TOKENS)).logits.numpy()
    jl, _ = jbase.forward(jp, jcfg, jnp.asarray(TOKENS),
                          jqn.init_cache(jcfg, 1, 32, jnp.float32))
    with torch.inference_mode():
        tl, _ = tbase.forward(tp, tcfg, torch.from_numpy(TOKENS),
                              _cache(tcfg))
    jl, tl = np.asarray(jl), tl.numpy()
    np.testing.assert_allclose(tl, jl, rtol=PORT_TOL, atol=PORT_TOL)
    np.testing.assert_allclose(jl, want, rtol=HF_TOL, atol=HF_TOL)
    np.testing.assert_allclose(tl, want, rtol=HF_TOL, atol=HF_TOL)
    l0, l1 = tp["layers"]
    assert "linear_attn" in l0 and "q_proj" not in l0
    assert l1["g_proj"]["w"].shape == l1["q_proj"]["w"].shape == (64, 32)
    hf_norm = hf.model.layers[0].input_layernorm.weight.detach()
    assert torch.equal(l0["input_layernorm"], hf_norm + 1.0)
    assert torch.equal(l0["linear_attn"]["norm"],
                       hf.model.layers[0].linear_attn.norm.weight.detach())
    assert l1["moe"]["shared_expert_gate"]["w"].shape == (1, 32)


def _greedy(jcfg, tcfg, jp, tp, steps=8, jdt=jnp.float32,
            tdt=torch.float32):
    """Greedy tokens and per-call logits of both packages: a prefill of
    TOKENS then one-token steps, each feeding its own argmax."""
    jc = jqn.init_cache(jcfg, 1, 32, jdt)
    tc = _cache(tcfg, dtype=tdt)
    jt, tt = jnp.asarray(TOKENS), torch.from_numpy(TOKENS)
    jout, tout, logits = [], [], []
    for i in range(steps):
        jl, jc = jbase.forward(jp, jcfg, jt, jc, fresh_prefill=i == 0)
        with torch.inference_mode():
            tl, tc = tbase.forward(tp, tcfg, tt, tc, fresh_prefill=i == 0)
        jl, tl = np.asarray(jl, np.float32), tl.float().numpy()
        logits.append((jl, tl))
        jn, tn = int(jl[0, -1].argmax()), int(tl[0, -1].argmax())
        jout.append(jn)
        tout.append(tn)
        jt, tt = jnp.asarray([[jn]]), torch.tensor([[tn]])
    return jout, tout, logits


def test_greedy_decode_matches_jax():
    _, _, jcfg, tcfg, jp, tp = _build()
    jout, tout, logits = _greedy(jcfg, tcfg, jp, tp)
    assert jout == tout
    for jl, tl in logits:
        np.testing.assert_allclose(tl, jl, rtol=PORT_TOL, atol=PORT_TOL)


def test_prefill_matches_token_by_token_decode():
    """One-shot prefill equals the same tokens fed one at a time (the
    recurrent state and the conv window carried in place)."""
    _, _, _, tcfg, _, tp = _build(seed=1)
    toks = torch.from_numpy(TOKENS)
    with torch.inference_mode():
        full, c1 = tbase.forward(tp, tcfg, toks, _cache(tcfg))
        c2 = _cache(tcfg)
        outs = []
        for t in range(toks.shape[1]):
            lg, c2 = tbase.forward(tp, tcfg, toks[:, t:t + 1], c2)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=STEP_TOL, atol=STEP_TOL)
    for a, b in zip(c1.layers, c2.layers):
        if isinstance(a, RecurrentCache):
            np.testing.assert_allclose(b.state.numpy(), a.state.numpy(),
                                       rtol=STEP_TOL, atol=STEP_TOL)
            np.testing.assert_allclose(b.conv.numpy(), a.conv.numpy(),
                                       rtol=STEP_TOL, atol=STEP_TOL)


def _engine(tcfg, tp):
    return Engine(
        lambda p, t, c: tbase.forward(p, tcfg, t, c), tp,
        prefill_forward_fn=lambda p, t, c: tbase.forward(
            p, tcfg, t, c, fresh_prefill=True),
        chunk_forward_fn=lambda p, t, c, kl: tbase.forward(
            p, tcfg, t, c, kv_limit=kl),
        chunk_hidden_forward_fn=lambda p, t, c, kl: tbase.forward(
            p, tcfg, t, c, kv_limit=kl, skip_logits=True))


def test_engine_prefill_runs_the_exact_length():
    """Engine.prefill pads a KV-only model's prompt to its bucket but runs
    a hybrid's at exactly T (padding would feed the recurrent state), as
    the JAX package does; its last logits equal the plain forward's."""
    _, _, _, tcfg, _, tp = _build()
    widths = []

    def fwd(p, t, c, **kw):
        widths.append(t.shape[1])
        return tbase.forward(p, tcfg, t, c, **kw)

    eng = Engine(lambda p, t, c: fwd(p, t, c), tp,
                 prefill_forward_fn=lambda p, t, c: fwd(
                     p, t, c, fresh_prefill=True))
    toks = torch.tensor([[3, 9, 27, 81, 5]])
    last, cache = eng.prefill(toks, _cache(tcfg))
    assert widths == [5] and cache.offset == 5
    with torch.inference_mode():
        want, _ = tbase.forward(tp, tcfg, toks, _cache(tcfg))
    np.testing.assert_allclose(last.numpy(), want[:, -1].numpy(),
                               rtol=STEP_TOL, atol=STEP_TOL)


def test_chunked_prefill_matches_whole():
    """prefill_chunked on the hybrid (ports tests/test_batching.py::
    test_hybrid_chunked_prefill_matches_whole): exact-width chunks through
    the recurrence and kv_limit attention equal one whole prefill, the
    last logits and the next step's."""
    _, _, _, tcfg, _, tp = _build(seed=2)
    eng = _engine(tcfg, tp)
    toks = torch.tensor([[7, 3, 11, 5, 2, 9, 1, 8, 4, 6, 10, 12, 13]])
    last_w, cache_w = eng.prefill(toks, _cache(tcfg))
    last_c, cache_c = eng.prefill_chunked(toks, _cache(tcfg), chunk_size=4)
    np.testing.assert_allclose(last_c.numpy(), last_w.numpy(),
                               rtol=STEP_TOL, atol=STEP_TOL)
    with torch.inference_mode():
        lg_w, _ = tbase.forward(tp, tcfg, torch.tensor([[2]]), cache_w)
        lg_c, _ = tbase.forward(tp, tcfg, torch.tensor([[2]]), cache_c)
    np.testing.assert_allclose(lg_c.numpy(), lg_w.numpy(), rtol=STEP_TOL,
                               atol=STEP_TOL)


def test_batcher_matches_single_sequence_with_reused_slots():
    """The dense continuous batcher over the hybrid cache (ports
    tests/test_batching.py::test_batcher_hybrid_deltanet_matches_single_
    sequence): every request equals the same request alone, with two slots
    for five requests, so three adopt a slot a finished request left.
    Each adoption prefills at exactly T, and the recurrent state and conv
    window it leaves in its slot equal those of the same prompt prefilled
    alone into a fresh cache (2e-4): a reused slot starts from zero, not
    from the last request's state."""
    _, _, _, tcfg, _, tp = _build(seed=3)
    eng = _engine(tcfg, tp)
    fwd = lambda p, t, c: tbase.forward(p, tcfg, t, c)
    init_cache = lambda c, b, ml: tqn.init_cache(c, b, ml, torch.float32,
                                                 device="cpu")

    def alone(prompt, mt):
        return list(eng.generate(torch.tensor(prompt), _cache(tcfg, 1, 64),
                                 max_tokens=mt))

    cb = ContinuousBatcher(
        fwd, tp, tcfg, init_cache, slots=2, max_len=64,
        prefill_forward_fn=lambda p, t, c: tbase.forward(
            p, tcfg, t, c, fresh_prefill=True))
    adopted = []
    real = cb._adopt_request

    def spy(b, layers1, T, tok, req=None):
        adopted.append((b, T, req.tokens, [
            (lc.state.clone(), lc.conv.clone()) for lc in layers1
            if isinstance(lc, RecurrentCache)]))
        return real(b, layers1, T, tok, req)

    cb._adopt_request = spy
    reqs = [("a", [3, 7, 11], 6), ("b", [5, 2], 8), ("c", [9, 1, 4, 8], 5),
            ("d", [12, 6, 1, 1, 3, 2, 9], 4), ("a2", [3, 7, 11], 6)]
    got = cb.run_all(reqs)
    for rid, prompt, mt in reqs:
        want = alone(prompt, mt)
        assert got[rid] == want[:len(got[rid])] and \
            len(got[rid]) >= len(want) - 1, (rid, got[rid], want)
    assert got["a2"] == got["a"]
    assert len(adopted) == 5 and {b for b, _, _, _ in adopted} == {0, 1}
    for b, T, tokens, states in adopted:
        assert T == len(tokens)
        _, fresh = eng.prefill(torch.tensor([tokens]), _cache(tcfg))
        want = [(lc.state, lc.conv) for lc in fresh.layers
                if isinstance(lc, RecurrentCache)]
        for (s1, c1), (s2, c2) in zip(states, want):
            np.testing.assert_allclose(s1.numpy(), s2.numpy(),
                                       rtol=STEP_TOL, atol=STEP_TOL)
            np.testing.assert_allclose(c1.numpy(), c2.numpy(),
                                       rtol=STEP_TOL, atol=STEP_TOL)


def test_paged_cache_and_batcher_refuse_the_hybrid():
    """The paged pool backs GQA layers only: init_paged_cache and the paged
    batcher refuse a hybrid config, as the JAX package's batcher does."""
    _, _, _, tcfg, _, _ = _build()
    with pytest.raises(ValueError, match="hybrid"):
        tbase.init_paged_cache(tcfg, 1, 128, device="cpu")
    with pytest.raises(ValueError, match="hybrid"):
        PagedContinuousBatcher(lambda p, t, c: None, {}, tcfg, slots=2,
                               max_len=128, device="cpu")


def test_generate_batch_refuses_ragged_prompts_on_the_hybrid():
    _, _, _, tcfg, _, tp = _build()
    eng = _engine(tcfg, tp)
    with pytest.raises(ValueError, match="recurrent"):
        eng.generate_batch(torch.tensor([[3, 4, 5], [6, 7, 0]]),
                           _cache(tcfg, 2), max_tokens=2,
                           prompt_lengths=[3, 2])


def _to_numpy(tree):
    """JAX tree -> numpy tree with packed weights in canonical form
    (tests/test_torch_moe_families.py's bridge, group weights only)."""
    if isinstance(tree, jqm.PackedQuantizedExperts):
        G = tree.in_features // tree.group_size
        b = np.asarray(tree.data).view(np.uint8).astype(np.int16)
        q = np.concatenate([(b & 15) - 8, (b >> 4) - 8], -1).astype(np.int8)
        return {"q": q, "scales": np.asarray(tree.scales)[..., :G],
                "biases": np.asarray(tree.biases)[..., :G],
                "group_size": tree.group_size, "bits": tree.bits}
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


def test_quantized_hybrid_close_to_jax():
    """The 3-layer hybrid quantized by the JAX package's quantize_params
    (w4a8 group 32; the DeltaNet projections, g_proj and the gates left
    dense there, as here) and carried across by params_from_numpy: the
    same leaves quantized, the port's own quantize_params quantizing the
    same ones; logits of a prefill and 5 decode steps within rel 0.05 of
    the JAX package's on bf16 activations, and the same greedy tokens."""
    _, raw, jcfg, tcfg, jp, tp = _build(WIDE)
    jq = jbase.quantize_params(jp, 32, 4, consume=False)
    tq = params_from_numpy(_to_numpy(jq), "cpu", dtype=torch.bfloat16)
    l0, l1, l2 = tq["layers"]
    assert isinstance(l0["linear_attn"]["in_proj_qkvz"]["w"], torch.Tensor)
    assert isinstance(l1["g_proj"]["w"], torch.Tensor)
    assert isinstance(l1["q_proj"]["w"], PackedQuantizedTensor)
    assert isinstance(l1["moe"]["experts"]["down_proj"],
                      PackedQuantizedExperts)
    assert isinstance(l1["moe"]["shared_expert"]["down_proj"]["w"],
                      PackedQuantizedTensor)
    assert isinstance(l1["moe"]["shared_expert_gate"]["w"], torch.Tensor)
    assert "moe" not in l2 and isinstance(l2["down_proj"]["w"],
                                          PackedQuantizedTensor)
    own = tbase.quantize_params(tp, 32, 4)

    def kinds(tree):
        if isinstance(tree, dict):
            return {k: kinds(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [kinds(v) for v in tree]
        return type(tree).__name__

    assert kinds(own) == kinds(tq)
    jout, tout, logits = _greedy(jcfg, tcfg, jq, tq, steps=6,
                                 jdt=jnp.bfloat16, tdt=torch.bfloat16)
    for jl, tl in logits:
        rel = np.max(np.abs(jl - tl)) / np.max(np.abs(jl))
        assert rel < QUANT_REL, rel
    assert jout == tout


def test_random_inits_run_and_fuse():
    """qwen3_next.init_params / init_quantized_params on a 4-layer hybrid
    (3 DeltaNet layers to 1 attention layer): the shared expert of
    shared_expert_intermediate_size with a [1, D] gate, finite logits;
    fuse_layer_projections fuses q/k/v and gate/up, leaves g_proj and
    marks the packed DeltaNet projections and g_proj as panels where the
    JAX package re-tiles them (hidden 256, the least width it re-tiles;
    in_proj_ba's 8 rows stay row-major)."""
    d = dict(WIDE, num_hidden_layers=4, mlp_only_layers=[],
             layer_types=None, full_attention_interval=4, hidden_size=256,
             head_dim=32, linear_key_head_dim=32, linear_value_head_dim=64)
    cfg = tqn.config_from_hf(d | {"model_type": "qwen3_next"})
    assert cfg.layer_types == ("linear_attention",) * 3 + ("full_attention",)
    g = torch.Generator().manual_seed(0)
    dense = tqn.init_params(cfg, g, torch.float32, device="cpu",
                            shared_width=64)
    moe = dense["layers"][0]["moe"]
    assert moe["shared_expert"]["gate_proj"]["w"].shape == (64, 256)
    assert moe["shared_expert_gate"]["w"].shape == (1, 256)
    toks = torch.tensor([[1, 2, 3, 4, 5]])
    with torch.inference_mode():
        lg, _ = tbase.forward(dense, cfg, toks, _cache(cfg))
    assert torch.isfinite(lg).all()
    q = tbase.fuse_layer_projections(tqn.init_quantized_params(
        cfg, g, group_size=32, device="cpu", shared_width=64))
    la, attn = q["layers"][0]["linear_attn"], q["layers"][3]
    assert la["in_proj_qkvz"]["w"].panels and la["out_proj"]["w"].panels
    assert not la["in_proj_ba"]["w"].panels
    assert "qkv_proj" in attn and "q_proj" not in attn
    assert isinstance(attn["g_proj"]["w"], PackedQuantizedTensor)
    assert attn["g_proj"]["w"].panels
    assert isinstance(q["layers"][0]["moe"]["experts"]["gate_proj"],
                      PackedQuantizedExperts)
    with torch.inference_mode():
        lq, _ = tbase.forward(q, cfg, toks.clamp(max=cfg.vocab_size - 1),
                              _cache(cfg, dtype=torch.bfloat16))
    assert torch.isfinite(lq).all()


def test_quantized_q_proj_splits_by_rows():
    """An MLX-quantized q_proj (the JAX package splits its packed words as
    if they were the weight) splits into q_proj and g_proj rows of codes,
    scales and biases: each half dequantizes to that half of the weight."""
    rng = np.random.default_rng(0)
    H, hd, D = 2, 8, 32
    w = torch.from_numpy(rng.standard_normal((2 * H * hd, D)).astype(
        np.float32))
    qt = quantize_tensor(w, 16, 4)
    q, g = tqn._split_fused_q(qt, H, hd)
    assert isinstance(q, QuantizedTensor) and isinstance(g, QuantizedTensor)
    full = dequantize(qt).reshape(H, 2 * hd, D)
    assert torch.equal(dequantize(q), full[:, :hd].reshape(-1, D))
    assert torch.equal(dequantize(g), full[:, hd:].reshape(-1, D))


def _write_tokenizer(d):
    from tokenizers import Tokenizer as HFTokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {chr(97 + i): i for i in range(26)}
    vocab.update({"<eos>": 26, "hi": 27, "there": 28})
    tok = HFTokenizer(BPE(vocab=vocab, merges=[], unk_token=None))
    tok.pre_tokenizer = Whitespace()
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"eos_token": "<eos>",
                   "chat_template": "{% for m in messages %}{{ m['content'] }}"
                                    " {% endfor %}"}, f)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A random HF Qwen3-Next saved in HF names, two shards and an
    index, with a tokenizer."""
    hf = _hf(seed=4)
    d = str(tmp_path_factory.mktemp("ckpt") / "tiny-qwen3-next")
    os.makedirs(d)
    save_sharded(d, {k: v.detach().float().contiguous()
                     for k, v in hf.state_dict().items()})
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf.config.to_dict() | {"model_type": "qwen3_next"}, f)
    _write_tokenizer(d)
    return d


def test_registry_loads_the_checkpoint_as_the_jax_registry(checkpoint):
    jmod, jp, jcfg = jregistry.load_model(checkpoint)
    jl, _ = jmod.forward(jp, jcfg, jnp.asarray(TOKENS),
                         jmod.init_cache(jcfg, 1, 16, jnp.float32))
    mod, tp, tcfg = registry.load_model(checkpoint, device="cpu")
    assert mod is tqn
    with torch.inference_mode():
        tl, _ = mod.forward(tp, tcfg, torch.from_numpy(TOKENS),
                            mod.init_cache(tcfg, 1, 16, torch.float32,
                                           device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=PORT_TOL,
                               atol=PORT_TOL)


def test_server_serves_the_checkpoint(checkpoint):
    """Server.load_model then chat completions one at a time and on the
    dense continuous batcher (the same greedy answer); the paged batcher
    and a speculative batcher (the JAX package's ValueError for recurrent
    layers) are refused."""
    srv = tserver.Server(port=0)
    body = {"model": "m", "max_tokens": 4,
            "messages": [{"role": "user", "content": "hi there"}]}
    try:
        m = srv.load_model("m", checkpoint, device="cpu")
        assert m.module is tqn
        one = srv.chat_completion(dict(body))
        assert 1 <= one["usage"]["completion_tokens"] <= 4
        with pytest.raises(ValueError, match="hybrid"):
            srv.enable_batching("m", slots=2, max_len=64, paged=True)
        with pytest.raises(ValueError, match="recurrent"):
            srv.enable_batching("m", slots=2, max_len=64, draft_layers=1)
        srv.enable_batching("m", slots=2, max_len=64, dtype=torch.float32)
        batched = srv.chat_completion(dict(body))
        assert batched["choices"][0]["message"]["content"] == \
            one["choices"][0]["message"]["content"]
    finally:
        srv.shutdown()


def test_entry_points_default_to_the_card(monkeypatch, checkpoint):
    """The hybrid's inits, its cache and load_model allocate on the
    current CUDA device unless a device is named, and raise without a
    card."""
    _, _, _, tcfg, _, _ = _build()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    for call in (lambda: tqn.init_params(tcfg, g),
                 lambda: tqn.init_quantized_params(tcfg, g, group_size=32),
                 lambda: tqn.init_cache(tcfg, 1, 16),
                 lambda: RecurrentCache.init(1, tcfg.deltanet),
                 lambda: tqn.load_model(checkpoint)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
