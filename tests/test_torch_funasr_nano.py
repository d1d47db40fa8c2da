"""The port's Fun-ASR-Nano against the JAX package's on the CPU, at tiny
widths (the JAX tests' Paraformer encoder, a 1-layer adaptor, a 1-layer
Qwen3 decoder), the JAX trees carried across by
``utils.params.params_from_numpy``, inputs seeded numpy, float32:

  - ``adaptor_forward`` (the MHA adaptor and one with SAN-M names) and
    ``encode``: 1e-5 of the largest magnitude;
  - greedy ``transcribe_tokens``, ``transcribe``, ``translate``,
    ``transcribe_long`` and ``translate_long`` from raw samples: token ids
    and text equal (the port's prefill runs ``fresh_prefill=True``: K2 on
    CUDA, on the CPU the JAX call's masked sdpa);
  - ``chunk_ranges``, ``map_checkpoint_key``: equal;
  - a checkpoint directory in FunASR's and HF's names through both
    packages' ``load_model``: the same text.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import funasr_nano as jfn
from ominix_mlx_tpu.models import paraformer as jpf
from ominix_mlx_tpu_torch.models import base, paraformer
from ominix_mlx_tpu_torch.models import funasr_nano as fn
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(2)

ENC = dict(n_mels=8, lfr_m=2, encoder_dim=16, encoder_layers=2,
           encoder_heads=2, encoder_ffn_dim=24, sanm_kernel_size=3,
           decoder_layers=1, decoder_dim=16, decoder_heads=2,
           decoder_ffn_dim=24, vocab_size=32)
ADA = dict(in_dim=16, hidden=24, out_dim=32, layers=1, heads=2, downsample=2)
LM = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
          num_kv_heads=1, head_dim=16, intermediate_size=48,
          tie_word_embeddings=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    want = np.asarray(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jitter(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(
            scale=0.05, size=a.shape).astype(np.float32)), tree)


@pytest.fixture(scope="module")
def pair():
    ecfg, acfg = jpf.ParaformerConfig(**ENC), jfn.AdaptorConfig(**ADA)
    lcfg = jbase.TransformerConfig(**LM)
    ep = _jitter(jpf.init_params(ecfg, jax.random.PRNGKey(0)), 5)
    ap = _jitter(jfn.init_adaptor(acfg, jax.random.PRNGKey(1)), 6)
    lp = jbase.init_params(lcfg, jax.random.PRNGKey(2), jnp.float32)
    jm = jfn.FunASRNano(enc_params=ep, enc_cfg=ecfg, adaptor_params=ap,
                        adaptor_cfg=acfg, lm_params=lp, lm_cfg=lcfg)
    tm = fn.FunASRNano(
        enc_params=params_from_numpy(_np(ep), "cpu"),
        enc_cfg=paraformer.ParaformerConfig(**ENC),
        adaptor_params=params_from_numpy(_np(ap), "cpu"),
        adaptor_cfg=fn.AdaptorConfig(**ADA),
        lm_params=params_from_numpy(_np(lp), "cpu"),
        lm_cfg=base.TransformerConfig(**LM), device="cpu")
    return jm, tm


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_adaptor_and_encode_match_jax(pair):
    jm, tm = pair
    x = _x((1, 13, 16), seed=2)
    want = jfn.adaptor_forward(jm.adaptor_params, jm.adaptor_cfg,
                               jnp.asarray(x))
    got = fn.adaptor_forward(tm.adaptor_params, tm.adaptor_cfg,
                             torch.from_numpy(x))
    assert tuple(got.shape) == (1, 6, 32) and _rel(got, want) < 1e-5
    feats = _x((1, 12, 16), seed=3)
    assert _rel(tm.encode(torch.from_numpy(feats)),
                jm.encode(jnp.asarray(feats))) < 1e-5


def test_sanm_adaptor_matches_jax():
    """An adaptor layer holding SAN-M names takes Paraformer's attention
    in both packages."""
    acfg = jfn.AdaptorConfig(**ADA)
    ap = jfn.init_adaptor(acfg, jax.random.PRNGKey(4))
    sanm = jpf.init_params(jpf.ParaformerConfig(
        n_mels=12, lfr_m=2, encoder_dim=24, encoder_heads=2,
        sanm_kernel_size=3), jax.random.PRNGKey(5))["layers"][0]
    ap["layers"][0]["self_attn"] = sanm["self_attn"]
    ap = _jitter(ap, 7)
    x = _x((2, 10, 16), seed=8)
    want = jfn.adaptor_forward(ap, acfg, jnp.asarray(x))
    got = fn.adaptor_forward(params_from_numpy(_np(ap), "cpu"),
                             fn.AdaptorConfig(**ADA), torch.from_numpy(x))
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("stop", [False, True])
def test_transcribe_tokens_match_jax(pair, stop):
    jm, tm = pair
    feats = _x((1, 12, 16), seed=9)
    want = jm.transcribe_tokens(jnp.asarray(feats), [1, 2], [3],
                                max_tokens=6)
    stops = ()
    if stop:
        stops = (want[3],)
        want = jm.transcribe_tokens(jnp.asarray(feats), [1, 2], [3],
                                    max_tokens=6, stop_tokens=stops)
    got = tm.transcribe_tokens(torch.from_numpy(feats), [1, 2], [3],
                               max_tokens=6, stop_tokens=stops)
    assert got == want and (len(got) <= 3 if stop else len(got) == 6)


def _samples(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.4 * np.sin(2 * np.pi * 330 * t)
            + 0.1 * rng.normal(size=n)).astype(np.float32)


def test_transcribe_and_translate_match_jax(pair):
    jm, tm = pair
    x = _samples(6400, seed=1)
    assert tm.transcribe(x, 16000, max_tokens=4) == \
        jm.transcribe(x, 16000, max_tokens=4)
    assert tm.translate(x, 16000, max_tokens=4) == \
        jm.translate(x, 16000, max_tokens=4)
    assert tm.transcribe_batch([(x, 16000), (x[:3200], 16000)],
                               max_tokens=3) == \
        jm.transcribe_batch([(x, 16000), (x[:3200], 16000)], max_tokens=3)


def test_long_paths_match_jax(pair):
    """0.25 s chunks over 0.6 s of audio: three chunks, the last 0.1 s."""
    jm, tm = pair
    x = _samples(9600, seed=2)
    kw = dict(chunk_secs=0.25, max_tokens=3)
    got = tm.transcribe_long(x, 16000, sep=" | ", **kw)
    assert got == jm.transcribe_long(x, 16000, sep=" | ", **kw)
    assert got.count(" | ") == 2
    assert tm.translate_long(x, 16000, **kw) == \
        jm.translate_long(x, 16000, **kw)


@pytest.mark.parametrize("n,rate,chunk,overlap", [
    (16000 * 70, 16000, 30.0, 0.0), (16000 * 60, 16000, 30.0, 5.0),
    (16000 * 30 + 800, 16000, 30.0, 0.0), (16000 * 30 + 1600, 16000, 30.0,
                                           0.0),
    (999, 8000, 0.05, 0.1), (0, 16000, 30.0, 0.0)])
def test_chunk_ranges_are_the_jax_ones(n, rate, chunk, overlap):
    assert fn.chunk_ranges(n, rate, chunk, overlap) == \
        jfn.chunk_ranges(n, rate, chunk, overlap)


def test_map_checkpoint_key_is_the_jax_one():
    for k in ("encoder.encoders.0.attn.qkv.weight", "x.attn.out.bias",
              "llm.model.layers.0.attn.q_norm.weight", "x.ffn.w1.weight",
              "adaptor.blocks.0.fc1.weight"):
        assert fn.map_checkpoint_key(k) == jfn.map_checkpoint_key(k)


def _checkpoint_flat(rng):
    """Encoder (FunASR names, one with alias names), adaptor and an HF
    Qwen3 decoder under llm.*, float32 numpy."""
    d, f, din = 16, 24, 16
    flat = {}

    def lin(name, n_out, n_in):
        flat[f"{name}.weight"] = rng.normal(size=(n_out, n_in)) * n_in ** -0.5
        flat[f"{name}.bias"] = rng.normal(size=n_out) * 0.1

    def norm(name, n):
        flat[f"{name}.weight"] = 1 + rng.normal(size=n) * 0.1
        flat[f"{name}.bias"] = rng.normal(size=n) * 0.1

    for pre, n_in in (("encoder.encoders0.0", din),
                      ("encoder.encoders.0", d)):
        lin(f"{pre}.attn.qkv", 3 * d, n_in)             # alias names
        lin(f"{pre}.self_attn.linear_out", d, d)
        flat[f"{pre}.self_attn.fsmn_block.weight"] = \
            rng.normal(size=(d, 1, 3)) * 0.1
        lin(f"{pre}.feed_forward.w_1", f, d)
        lin(f"{pre}.feed_forward.w_2", d, f)
        norm(f"{pre}.norm1", n_in)
        norm(f"{pre}.norm2", d)
    norm("encoder.after_norm", d)
    h = 24
    lin("adaptor.linear1", h, 2 * d)
    for i in range(2):                  # the loader's AdaptorConfig depth
        pre = f"adaptor.blocks.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            lin(f"{pre}.self_attn.{n}", h, h)
        lin(f"{pre}.fc1", 2 * h, h)
        lin(f"{pre}.fc2", h, 2 * h)
        norm(f"{pre}.norm1", h)
        norm(f"{pre}.norm2", h)
    lin("adaptor.linear2", 32, h)
    L = 32
    flat["llm.model.embed_tokens.weight"] = rng.normal(size=(64, L)) * 0.02
    flat["llm.model.norm.weight"] = np.ones(L)
    p = "llm.model.layers.0"
    for n, shape in (("self_attn.q_proj", (32, L)), ("self_attn.k_proj",
                                                    (16, L)),
                     ("self_attn.v_proj", (16, L)), ("self_attn.o_proj",
                                                    (L, 32)),
                     ("mlp.gate_proj", (48, L)), ("mlp.up_proj", (48, L)),
                     ("mlp.down_proj", (L, 48))):
        flat[f"{p}.{n}.weight"] = rng.normal(size=shape) * shape[1] ** -0.5
    for n, width in (("input_layernorm", L), ("post_attention_layernorm", L),
                     ("self_attn.q_norm", 16), ("self_attn.k_norm", 16)):
        flat[f"{p}.{n}.weight"] = 1 + rng.normal(size=width) * 0.1
    return {k: v.astype(np.float32) for k, v in flat.items()}


def test_load_model_from_funasr_names(tmp_path):
    from ominix_mlx_tpu_torch.utils.loading import save_safetensors

    flat = _checkpoint_flat(np.random.default_rng(0))
    save_safetensors(str(tmp_path / "model.safetensors"),
                     {k: torch.from_numpy(v) for k, v in flat.items()})
    import json
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "funasr_nano",
        "audio_encoder_conf": {"num_blocks": 2},
        "adaptor_conf": {"llm_dim": 32},
        "llm_conf": {"model_type": "qwen3", "vocab_size": 64,
                     "hidden_size": 32, "num_hidden_layers": 1,
                     "num_attention_heads": 2, "num_key_value_heads": 1,
                     "head_dim": 16, "intermediate_size": 48,
                     "tie_word_embeddings": True}}))
    jm = jfn.load_model(str(tmp_path))
    tm = fn.load_model(str(tmp_path), device="cpu")
    assert tm.enc_cfg == paraformer.ParaformerConfig(encoder_layers=2)
    assert tm.adaptor_cfg == fn.AdaptorConfig(in_dim=512, out_dim=32)
    # the loaders' configs are Paraformer-large's apart from the depth:
    # run both at the tiny widths the checkpoint holds
    small = dict(n_mels=8, lfr_m=2, encoder_dim=16, encoder_layers=2,
                 encoder_heads=2)
    jm.enc_cfg = jpf.ParaformerConfig(**small)
    tm.enc_cfg = paraformer.ParaformerConfig(**small)
    jm.adaptor_cfg = jfn.AdaptorConfig(**dict(ADA, layers=2))
    tm.adaptor_cfg = fn.AdaptorConfig(**dict(ADA, layers=2))
    x = _samples(4800, seed=3)
    assert tm.transcribe(x, 16000, max_tokens=4) == \
        jm.transcribe(x, 16000, max_tokens=4)
