"""MiniCPM-SALA of the PyTorch port (models/minicpm_sala.py) against the
JAX package's (ominix_mlx_tpu/models/minicpm_sala.py) on the same seeded
numpy weights, in float32 on the CPU (where every kernel wrapper takes its
plain version): the config, logits and greedy tokens, chunked prefill,
the draft prefix (``num_layers``), checkpoint loading (HF names, float and
MLX-quantized), the dense continuous batcher and the server. Logits are
float32 sums in another order than XLA's, held within PORT_TOL of their
largest magnitude."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core import quant as jquant
from ominix_mlx_tpu.models import minicpm_sala as jms
from ominix_mlx_tpu.models import registry as jregistry
from ominix_mlx_tpu_torch.core.generate import Engine
from ominix_mlx_tpu_torch.core.quant import QuantizedTensor
from ominix_mlx_tpu_torch.models import minicpm_sala as tms
from ominix_mlx_tpu_torch.models import registry
from ominix_mlx_tpu_torch.models.lightning import GLACache
from ominix_mlx_tpu_torch.models.sparse_attention import SparseKVCache
from ominix_mlx_tpu_torch.serving.batching import (ContinuousBatcher,
                                                   PagedContinuousBatcher)
from ominix_mlx_tpu_torch.utils.loading import save_sharded
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(2)

PORT_TOL = 2e-4
# MiniCPM-SALA as published (huggingface.co/openbmb/MiniCPM-SALA,
# config.json), the fields the port reads
PUBLISHED = dict(
    model_type="minicpm_sala", vocab_size=73448, hidden_size=4096,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=2,
    head_dim=128, intermediate_size=16384, tie_word_embeddings=False,
    scale_emb=12, scale_depth=1.4, dim_model_base=256, rope_theta=10000.0,
    rms_norm_eps=1e-6, qk_norm=True, attn_use_rope=False,
    lightning_use_rope=True, lightning_nh=32, lightning_head_dim=128,
    use_output_gate=True, use_output_norm=True,
    max_position_embeddings=524288,
    mixer_types=["minicpm4" if i in (0, 9, 16, 17, 22, 29, 30, 31)
                 else "lightning-attn" for i in range(32)])
# a 4-layer cut with both mixers, QK-norm and an InfLLMv2 config small
# enough that a 100-token prompt prunes (blocks of 8, window 32, top 4)
SMALL = dict(
    model_type="minicpm_sala", vocab_size=256, hidden_size=64,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, intermediate_size=128, qk_norm=True,
    mixer_types=["minicpm4", "lightning-attn", "lightning-attn",
                 "minicpm4"],
    sparse_config=dict(kernel_size=8, block_size=16, init_blocks=1,
                       window_size=32, topk=4))
PROMPT = np.random.default_rng(0).integers(0, 256, (1, 100))


def _numpy_tree(d=SMALL, seed=0):
    """The JAX init_params tree with q_norm / k_norm and norms off one and
    an lm_head, as numpy (what both packages load)."""
    cfg = jms.MiniCPMConfig.from_hf(d)
    jp = jms.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    g = np.random.default_rng(seed + 1)

    def near_one(n):
        return (1 + 0.1 * g.standard_normal(n)).astype(np.float32)

    for lp, mt in zip(tree["layers"], cfg.mixer_types):
        lp["q_norm"], lp["k_norm"] = near_one(16), near_one(16)
        lp["input_layernorm"] = near_one(d["hidden_size"])
        if mt == "lightning-attn":
            lp["o_norm"] = near_one(64)
    tree["lm_head"] = {"w": (g.standard_normal((256, 64)) * 0.1).astype(
        np.float32)}
    return cfg, tree


def _pair(d=SMALL, seed=0):
    jcfg, tree = _numpy_tree(d, seed)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tms.MiniCPMConfig.from_hf(d), jp, params_from_numpy(
        tree, "cpu")


def _cache(tcfg, batch=1, max_len=160):
    return tms.init_cache(tcfg, batch, max_len, torch.float32, device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_from_hf_published():
    cfg = tms.MiniCPMConfig.from_hf(PUBLISHED)
    assert cfg.res_scale == pytest.approx(1.4 / 32 ** 0.5)
    assert cfg.logits_scale == 16.0
    assert [i for i, m in enumerate(cfg.mixer_types) if m == "minicpm4"] \
        == [0, 9, 16, 17, 22, 29, 30, 31]
    assert cfg.gla_heads == 32 and cfg.gla_head_dim == 128
    assert cfg.sparse == tms.SparseConfig()
    jcfg = jms.MiniCPMConfig.from_hf(PUBLISHED)
    for f in jcfg.__dataclass_fields__:
        if f != "sparse":
            assert getattr(cfg, f) == getattr(jcfg, f), f


def _greedy(jcfg, tcfg, jp, tp, steps, num_layers=None):
    jc = jms.init_cache(jcfg, 1, 160, jnp.float32)
    tc = _cache(tcfg)
    jt, tt = jnp.asarray(PROMPT), torch.from_numpy(PROMPT)
    jout, tout, logits = [], [], []
    for i in range(steps):
        jl, jc = jms.forward(jp, jcfg, jt, jc, num_layers=num_layers)
        with torch.inference_mode():
            tl, tc = tms.forward(tp, tcfg, tt, tc, num_layers=num_layers,
                                 fresh_prefill=i == 0)
        jl, tl = np.asarray(jl), tl.numpy()
        logits.append((jl, tl))
        jn, tn = int(jl[0, -1].argmax()), int(tl[0, -1].argmax())
        jout.append(jn)
        tout.append(tn)
        jt, tt = jnp.asarray([[jn]]), torch.tensor([[tn]])
    return jout, tout, logits, tc


def test_logits_match_jax():
    """A 100-token prefill then 8 decode steps (each fed the JAX argmax):
    logits within PORT_TOL, the caches advanced in place."""
    jcfg, tcfg, jp, tp = _pair()
    jc = jms.init_cache(jcfg, 1, 160, jnp.float32)
    tc = _cache(tcfg)
    jl, jc = jms.forward(jp, jcfg, jnp.asarray(PROMPT), jc)
    tl, tc = tms.forward(tp, tcfg, torch.from_numpy(PROMPT), tc)
    assert _rel(tl, jl) < PORT_TOL
    for _ in range(8):
        tok = np.array(jl[:, -1:].argmax(-1))
        jl, jc = jms.forward(jp, jcfg, jnp.asarray(tok), jc)
        tl, tc = tms.forward(tp, tcfg, torch.from_numpy(tok), tc)
        assert _rel(tl, jl) < PORT_TOL
    assert tc.offset == 108
    assert isinstance(tc.layers[0], SparseKVCache)
    assert isinstance(tc.layers[1], GLACache)
    assert _rel(tc.layers[1].state, jc.layers[1].state) < PORT_TOL


def test_greedy_decode_equal_token_for_token():
    jcfg, tcfg, jp, tp = _pair(seed=1)
    jout, tout, logits, _ = _greedy(jcfg, tcfg, jp, tp, 16)
    assert jout == tout
    assert max(_rel(t, j) for j, t in logits) < PORT_TOL


def test_num_layers_runs_the_prefix():
    """The self-speculative draft's prefix: the first 2 layers against the
    JAX package's, the other layers' caches left as they were."""
    jcfg, tcfg, jp, tp = _pair(seed=2)
    jout, tout, logits, tc = _greedy(jcfg, tcfg, jp, tp, 3, num_layers=2)
    assert jout == tout
    assert max(_rel(t, j) for j, t in logits) < PORT_TOL
    assert tc.layers[2].state.eq(0).all() and tc.layers[3].k.eq(0).all()


def _engine(tcfg, tp):
    return Engine(
        lambda p, t, c: tms.forward(p, tcfg, t, c), tp,
        prefill_forward_fn=lambda p, t, c: tms.forward(
            p, tcfg, t, c, fresh_prefill=True),
        chunk_forward_fn=lambda p, t, c, kl: tms.forward(
            p, tcfg, t, c, kv_limit=kl),
        chunk_hidden_forward_fn=lambda p, t, c, kl: tms.forward(
            p, tcfg, t, c, kv_limit=kl, skip_logits=True))


@pytest.mark.parametrize("chunk", [16, 33])
def test_prefill_chunked_equals_whole(chunk):
    """Engine.prefill_chunked (exact-width chunks: the lightning states
    take every position; kv_limit attention in the sparse layers, dense
    even for a one-token tail) equals one whole prefill, the last logits
    and two decode steps after it (InfLLMv2 then prunes)."""
    _, tcfg, _, tp = _pair(seed=3)
    eng = _engine(tcfg, tp)
    toks = torch.from_numpy(PROMPT[:, :97])
    last_w, cache_w = eng.prefill(toks, _cache(tcfg))
    last_c, cache_c = eng.prefill_chunked(toks, _cache(tcfg), chunk)
    assert cache_c.offset == cache_w.offset == 97
    assert _rel(last_c, last_w) < PORT_TOL
    with torch.inference_mode():
        for t in (5, 9):
            lw, cache_w = tms.forward(tp, tcfg, torch.tensor([[t]]), cache_w)
            lc, cache_c = tms.forward(tp, tcfg, torch.tensor([[t]]), cache_c)
            assert _rel(lc, lw) < PORT_TOL


def _flat(tree, cfg):
    """The numpy tree in HF names (float)."""
    flat = {"model.embed_tokens.weight": tree["embed"],
            "model.norm.weight": tree["norm"],
            "lm_head.weight": tree["lm_head"]["w"]}
    for i, (lp, mt) in enumerate(zip(tree["layers"], cfg.mixer_types)):
        p = f"model.layers.{i}"
        flat[f"{p}.input_layernorm.weight"] = lp["input_layernorm"]
        flat[f"{p}.post_attention_layernorm.weight"] = \
            lp["post_attention_layernorm"]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj", "z_proj"):
            if n in lp:
                flat[f"{p}.self_attn.{n}.weight"] = lp[n]["w"]
        for n in ("q_norm", "k_norm", "o_norm"):
            if n in lp:
                flat[f"{p}.self_attn.{n}.weight"] = lp[n]
        for n in ("gate_proj", "up_proj", "down_proj"):
            flat[f"{p}.mlp.{n}.weight"] = lp[n]["w"]
    return flat


def _write(d, flat, config, quantize=False):
    out = {}
    for name, a in flat.items():
        if quantize and name.endswith(".weight") and a.ndim == 2:
            packed, scales, biases = jquant.quantize(jnp.asarray(a), 32, 4)
            stem = name[:-len(".weight")]
            out[name] = torch.from_numpy(
                np.array(np.asarray(packed).view(np.int32))).view(
                    torch.uint32)
            out[f"{stem}.scales"] = torch.from_numpy(np.array(scales))
            out[f"{stem}.biases"] = torch.from_numpy(np.array(biases))
        else:
            out[name] = torch.from_numpy(np.array(a))
    os.makedirs(d)
    save_sharded(d, out)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config | ({"quantization": {"group_size": 32, "bits": 4}}
                            if quantize else {}), f)
    return d


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(tree, QuantizedTensor) or hasattr(tree, "scales"):
        for f in ("q", "scales", "biases"):
            yield f"{path}.{f}", np.asarray(getattr(tree, f))
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("model_type", ["minicpm_sala", "minicpm4"])
def test_load_model_matches_jax(tmp_path, quantize, model_type):
    """The same HF-named directory (float, or MLX 4-bit g32 words) through
    registry.load_model of both packages: the port's module, the same
    leaves bit for bit, and the same logits."""
    cfg, tree = _numpy_tree(seed=4)
    d = _write(str(tmp_path / "ckpt"), _flat(tree, cfg),
               SMALL | {"model_type": model_type}, quantize)
    jmod, jp, jcfg = jregistry.load_model(d)
    mod, tp, tcfg = registry.load_model(d, device="cpu")
    assert mod is tms and registry.get_module(model_type) is tms
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    want, _ = jmod.forward(jp, jcfg, jnp.asarray(PROMPT[:, :20]),
                           jmod.init_cache(jcfg, 1, 32, jnp.float32))
    with torch.inference_mode():
        got, _ = mod.forward(tp, tcfg, torch.from_numpy(PROMPT[:, :20]),
                             _cache(tcfg, max_len=32))
    assert _rel(got, want) < PORT_TOL


def test_dense_batcher_matches_single_sequences():
    """The dense continuous batcher over the sparse and lightning caches
    (as tests/test_batching.py:348 holds the JAX one): two slots for five
    requests, so three adopt a slot a finished request left (its GLA rows
    zeroed, its sparse rows overwritten); each equals the same request
    alone."""
    _, tcfg, _, tp = _pair(seed=5)
    eng = _engine(tcfg, tp)

    def alone(prompt, mt):
        return list(eng.generate(torch.tensor(prompt), _cache(tcfg),
                                 max_tokens=mt))

    cb = ContinuousBatcher(
        lambda p, t, c: tms.forward(p, tcfg, t, c), tp, tcfg,
        lambda c, b, ml: tms.init_cache(c, b, ml, torch.float32,
                                        device="cpu"),
        slots=2, max_len=128,
        prefill_forward_fn=lambda p, t, c: tms.forward(
            p, tcfg, t, c, fresh_prefill=True))
    long = PROMPT[0, :60].tolist()
    reqs = [("a", [3, 7, 11], 6), ("b", long, 8), ("c", [9, 1, 4, 8], 5),
            ("d", long[:45], 4), ("a2", [3, 7, 11], 6)]
    got = cb.run_all(reqs)
    for rid, prompt, mt in reqs:
        want = alone(prompt, mt)
        assert got[rid] == want[:len(got[rid])] and \
            len(got[rid]) >= len(want) - 1, (rid, got[rid], want)
    assert got["a2"] == got["a"]


def test_paged_batcher_refuses_the_family():
    tcfg = tms.MiniCPMConfig.from_hf(SMALL)
    with pytest.raises(ValueError, match="hybrid"):
        PagedContinuousBatcher(lambda p, t, c: None, {}, tcfg, slots=2,
                               max_len=128, device="cpu")


def test_random_inits_run():
    """init_params and init_quantized_params (w8a8 g64, fused and on
    panels as the smoke serves it) build the published layout at a small
    width, with unit q_norm / k_norm, and run a prefill and a step."""
    from ominix_mlx_tpu_torch.models import base

    d = SMALL | dict(hidden_size=128, num_attention_heads=4, head_dim=32,
                     intermediate_size=256)
    cfg = tms.MiniCPMConfig.from_hf(d)
    g = torch.Generator().manual_seed(0)
    for p in (tms.init_params(cfg, g, torch.float32, device="cpu"),
              base.fuse_layer_projections(tms.init_quantized_params(
                  cfg, g, device="cpu"))):
        assert all(lp["q_norm"].eq(1).all() for lp in p["layers"])
        assert "z_proj" in p["layers"][1] and "o_norm" in p["layers"][1]
        cache = tms.init_cache(cfg, 1, 64, torch.bfloat16, device="cpu")
        with torch.inference_mode():
            lg, cache = tms.forward(p, cfg, torch.tensor([[1, 2, 3]]),
                                    cache)
            lg, cache = tms.forward(p, cfg, torch.tensor([[4]]), cache)
        assert lg.shape == (1, 1, 256) and torch.isfinite(lg.float()).all()


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tms.MiniCPMConfig.from_hf(SMALL)
    g = torch.Generator().manual_seed(0)
    for call in (lambda: tms.init_params(cfg, g),
                 lambda: tms.init_quantized_params(cfg, g, group_size=32),
                 lambda: tms.init_cache(cfg, 1, 16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_server_serves_the_checkpoint(tmp_path):
    """Server.load_model on a MiniCPM-SALA directory (HF names and a
    tokenizer), then a chat completion one at a time and on the dense
    continuous batcher (the same greedy answer); the paged batcher is
    refused."""
    from tokenizers import Tokenizer as HFTokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace

    from ominix_mlx_tpu_torch.serving import server as tserver

    cfg, tree = _numpy_tree(seed=6)
    d = _write(str(tmp_path / "ckpt"), _flat(tree, cfg), SMALL)
    vocab = {chr(97 + i): i for i in range(26)}
    vocab.update({"<eos>": 26, "hi": 27, "there": 28})
    tok = HFTokenizer(BPE(vocab=vocab, merges=[], unk_token=None))
    tok.pre_tokenizer = Whitespace()
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"eos_token": "<eos>",
                   "chat_template": "{% for m in messages %}{{ m['content'] }}"
                                    " {% endfor %}"}, f)
    srv = tserver.Server(port=0)
    body = {"model": "m", "max_tokens": 4,
            "messages": [{"role": "user", "content": "hi there"}]}
    try:
        m = srv.load_model("m", d, device="cpu")
        assert m.module is tms
        one = srv.chat_completion(dict(body))
        assert 1 <= one["usage"]["completion_tokens"] <= 4
        with pytest.raises(ValueError, match="hybrid"):
            srv.enable_batching("m", slots=2, max_len=64, paged=True)
        srv.enable_batching("m", slots=2, max_len=64, dtype=torch.float32)
        batched = srv.chat_completion(dict(body))
        assert batched["choices"][0]["message"]["content"] == \
            one["choices"][0]["message"]["content"]
    finally:
        srv.shutdown()
