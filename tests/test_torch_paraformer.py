"""The port's Paraformer, CIF and CT-Transformer punctuation against the
JAX package's on the CPU, at tiny widths, the JAX trees carried across by
``utils.params.params_from_numpy``, inputs seeded numpy, float32:

  - SAN-M layers (with and without the attention residual), the encoder,
    the alphas, the decoder layer and the decoder: 1e-5 of the largest
    magnitude (float32 sums in other orders);
  - ``cif`` (the plain loop, which CPU tensors take): counts equal,
    frames at the JAX test's rtol = atol = 1e-5 (tests/test_paraformer.py),
    with rows that end on the tail, that never fire, that fire at every
    step of a stretch, and a short ``max_tokens`` (writes clamp to the last
    row, as ``jax.lax.dynamic_update_slice`` does);
  - ``transcribe_logits``: counts equal, logits 1e-5;
  - ``Transcriber.transcribe_ids`` and ``transcribe`` (token table, "@@",
    punctuation) from raw samples, and a checkpoint directory: ids and
    text equal;
  - punctuation: ``segment_text`` and ``ensure_sentence_ending`` equal,
    ``forward`` 1e-5, ``punctuate`` equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import paraformer as jpf
from ominix_mlx_tpu.models import punctuation as jpunc
from ominix_mlx_tpu.utils import loading as jloading
from ominix_mlx_tpu_torch.models import paraformer as pf
from ominix_mlx_tpu_torch.models import punctuation as punc
from ominix_mlx_tpu_torch.ops import cif as tcif
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(2)

TINY = dict(n_mels=8, lfr_m=2, encoder_dim=32, encoder_layers=2,
            encoder_heads=2, encoder_ffn_dim=48, sanm_kernel_size=5,
            decoder_dim=32, decoder_layers=2, decoder_heads=2,
            decoder_ffn_dim=48, vocab_size=50)
JCFG = jpf.ParaformerConfig(**TINY)
TCFG = pf.ParaformerConfig(**TINY)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    want = np.asarray(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def params():
    jp = jpf.init_params(JCFG, jax.random.PRNGKey(0))
    # random norms and biases, so the port is held to them
    rng = np.random.default_rng(7)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(
            scale=0.1, size=a.shape).astype(np.float32)), jp)
    return jp, params_from_numpy(_np(jp), "cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("residual", [False, True])
def test_encoder_layer_matches_jax(params, residual):
    jp, tp = params
    lj, lt = (jp["first_layer"], tp["first_layer"]) if not residual else \
        (jp["layers"][0], tp["layers"][0])
    d = JCFG.input_dim if not residual else JCFG.encoder_dim
    x = _x((2, 9, d))
    want = jpf.encoder_layer(lj, jnp.asarray(x), JCFG.encoder_heads, residual)
    got = pf.encoder_layer(lt, torch.from_numpy(x), TCFG.encoder_heads,
                           residual)
    assert _rel(got, want) < 1e-5


def test_sanm_attention_matches_jax(params):
    jp, tp = params
    x = _x((1, 13, JCFG.encoder_dim), seed=2)
    want = jpf.sanm_attention(jp["layers"][0]["self_attn"], jnp.asarray(x), 2)
    got = pf.sanm_attention(tp["layers"][0]["self_attn"], torch.from_numpy(x),
                            2)
    assert _rel(got, want) < 1e-5


def test_encode_and_alphas_match_jax(params):
    jp, tp = params
    feats = _x((1, 24, JCFG.input_dim), seed=3)
    want = jpf.encode(jp, JCFG, jnp.asarray(feats))
    got = pf.encode(tp, TCFG, torch.from_numpy(feats))
    assert _rel(got, want) < 1e-5
    a_want = jpf.predict_alphas(jp["predictor"], want)
    a_got = pf.predict_alphas(tp["predictor"], got)
    assert _rel(a_got, a_want) < 1e-5


def test_decoder_matches_jax(params):
    jp, tp = params
    x, enc = _x((2, 7, 32), seed=4), _x((2, 11, 32), seed=5)
    want = jpf.decoder_layer(jp["dec_layers"][0], jnp.asarray(x),
                             jnp.asarray(enc), 2)
    got = pf.decoder_layer(tp["dec_layers"][0], torch.from_numpy(x),
                           torch.from_numpy(enc), 2)
    assert _rel(got, want) < 1e-5
    want = jpf.decode(jp, JCFG, jnp.asarray(x), jnp.asarray(enc))
    got = pf.decode(tp, TCFG, torch.from_numpy(x), torch.from_numpy(enc))
    assert _rel(got, want) < 1e-5


def _cif_rows(T, seed):
    """Alphas of four kinds of row: random in (0.1, 0.6); one that fires
    every fourth frame and ends on the tail (its last alpha leaves 0.6 of
    weight); one that never fires (total under the tail threshold); one
    whose stretch of 0.9s fires at every step after the first."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 0.6, size=(4, T)).astype(np.float32)
    a[1] = 0.25
    a[1, -1] = (0.6 - 0.25 * (T - 1)) % 1.0
    a[2] = 0.4 / T
    a[3, : T // 2] = 0.9
    return a


@pytest.mark.parametrize("T", [1, 7, 20, 37])
def test_cif_matches_jax(T):
    hidden = _x((4, T, 6), seed=T)
    alphas = _cif_rows(T, seed=T)
    wf, wc = jpf.cif(jnp.asarray(hidden), jnp.asarray(alphas))
    gf, gc = tcif.cif(torch.from_numpy(hidden), torch.from_numpy(alphas))
    assert gc.dtype == torch.int32 and gf.dtype == torch.float32
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=1e-5,
                               atol=1e-5)
    for b in range(4):                  # rows past the count are zero
        assert not gf[b, int(gc[b]):].any()


def test_cif_rows_cover_their_cases():
    T = 20
    _, counts = tcif.cif(torch.zeros(4, T, 2),
                         torch.from_numpy(_cif_rows(T, seed=0)))
    a = _cif_rows(T, seed=0)
    assert counts[1] == int(a[1].sum()) + 1          # ends on the tail
    assert counts[2] == 0                            # never fires
    assert counts[3] >= T // 2 - 1


def test_cif_clamps_writes_at_max_tokens_as_jax():
    hidden = _x((2, 16, 3), seed=9)
    alphas = np.full((2, 16), 0.7, np.float32)
    wf, wc = jpf.cif(jnp.asarray(hidden), jnp.asarray(alphas), max_tokens=4)
    gf, gc = tcif.cif(torch.from_numpy(hidden), torch.from_numpy(alphas),
                      max_tokens=4)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert int(gc[0]) > 4
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=1e-5,
                               atol=1e-5)


def test_cif_constant_half_fires_five_times():
    _, counts = tcif.cif(torch.ones(1, 10, 2), torch.full((1, 10), 0.5))
    assert int(counts[0]) == 5


def test_cif_takes_bf16_as_the_kernel_does():
    """bf16 hidden and alphas (the main path's) are widened to float32
    first: the plain version equals itself on the widened inputs."""
    h = torch.from_numpy(_x((2, 30, 8), seed=11)).bfloat16()
    a = torch.from_numpy(_cif_rows(30, 11)[:2]).bfloat16()
    got = tcif.cif(h, a)
    want = tcif.cif_reference(h.float(), a.float())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_transcribe_logits_matches_jax(params):
    jp, tp = params
    feats = _x((1, 24, JCFG.input_dim), seed=6)
    wl, wc = jpf.transcribe_logits(jp, JCFG, jnp.asarray(feats))
    gl, gc = pf.transcribe_logits(tp, TCFG, torch.from_numpy(feats))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert _rel(gl, wl) < 1e-5


def _samples(n=6400, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.4 * np.sin(2 * np.pi * 300 * t)
            + 0.1 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("cmvn", [False, True])
def test_transcribe_ids_match_jax(params, cmvn):
    jp, tp = params
    kw_j, kw_t = {}, {}
    if cmvn:
        rng = np.random.default_rng(12)
        m, v = (rng.normal(size=JCFG.input_dim).astype(np.float32)
                for _ in range(2))
        kw_j = dict(cmvn_means=jnp.asarray(m), cmvn_vars=jnp.asarray(v))
        kw_t = dict(cmvn_means=torch.from_numpy(m),
                    cmvn_vars=torch.from_numpy(v))
    jt = jpf.Transcriber(params=jp, cfg=JCFG, **kw_j)
    tt = pf.Transcriber(params=tp, cfg=TCFG, device="cpu", **kw_t)
    x = _samples()
    want = jt.transcribe_ids(jnp.asarray(x))
    assert want and tt.transcribe_ids(x) == want
    assert tt.transcribe(x) == jt.transcribe(x)


def test_transcribe_text_with_tokens_and_punctuation(params):
    jp, tp = params
    tokens = [f"t{i}@@" if i % 3 else f"字{i}" for i in range(40)]
    jpunc_m, tpunc_m = _punc_models()
    jt = jpf.Transcriber(params=jp, cfg=JCFG, tokens=tokens, punc=jpunc_m)
    tt = pf.Transcriber(params=tp, cfg=TCFG, tokens=tokens, punc=tpunc_m,
                        device="cpu")
    x = _samples(seed=3)
    assert tt.transcribe(x) == jt.transcribe(x)


def test_load_model_from_a_checkpoint_directory(params, tmp_path):
    """The canonical format written by the JAX package (a CMVN subtree
    and tokens.txt beside it) loads through the port to the same ids."""
    jp, _ = params
    rng = np.random.default_rng(13)
    tree = dict(jp)
    tree["cmvn"] = {"means": jnp.asarray(rng.normal(size=JCFG.input_dim),
                                         jnp.float32),
                    "vars": jnp.asarray(rng.uniform(0.5, 1.5,
                                                    JCFG.input_dim),
                                        jnp.float32)}
    jloading.save_model(str(tmp_path), {"model_type": "paraformer", **TINY},
                        tree)
    (tmp_path / "tokens.txt").write_text(
        "\n".join(f"w{i}" for i in range(50)) + "\n", encoding="utf-8")
    jt = jpf.load_model(str(tmp_path))
    tt = pf.load_model(str(tmp_path), device="cpu")
    assert tt.cfg == TCFG and tt.tokens == jt.tokens
    x = _samples(seed=5)
    assert tt.transcribe(x) == jt.transcribe(x)


def test_load_model_without_a_card_raises(params, tmp_path, monkeypatch):
    jp, _ = params
    jloading.save_model(str(tmp_path), {"model_type": "paraformer", **TINY},
                        jp)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pf.load_model(str(tmp_path))


# ------------------------------------------------------------ punctuation

PUNC = dict(vocab_size=30, hidden=16, layers=2, heads=2, ffn=24,
            sanm_kernel=3)
VOCAB = {t: i for i, t in enumerate(
    ["<unk>", "我", "们", "去", "hello", "world", "好", "的", "吗", "ok"])}


def _punc_models():
    jcfg = jpunc.PunctuationConfig(**PUNC)
    jp = jpunc.init_params(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(8)
    jp["classifier"]["b"] = jnp.asarray(rng.normal(size=6) * 2, jnp.float32)
    tcfg = punc.PunctuationConfig(**PUNC)
    return (jpunc.PunctuationModel(jp, jcfg, VOCAB),
            punc.PunctuationModel(params_from_numpy(_np(jp), "cpu"), tcfg,
                                  VOCAB))


@pytest.mark.parametrize("text", ["我们去hello world好的", "  ok  吗 ",
                                  "abc def", "", "中文。", "ok，"])
def test_segment_and_ending_are_the_jax_ones(text):
    assert punc.segment_text(text) == jpunc.segment_text(text)
    assert punc.ensure_sentence_ending(text) == \
        jpunc.ensure_sentence_ending(text)


def test_punctuation_forward_and_punctuate_match_jax():
    jm, tm = _punc_models()
    ids = np.asarray([[1, 2, 3, 4, 5, 0, 9, 6]], np.int32)
    want = jpunc.forward(jm.params, jm.cfg, jnp.asarray(ids))
    got = punc.forward(tm.params, tm.cfg, torch.from_numpy(ids).long())
    assert _rel(got, want) < 1e-5
    for text in ("我们去hello world好的吗", "ok ok 我", ""):
        assert tm.punctuate(text) == jm.punctuate(text)


def test_punctuation_loads_funasr_names(tmp_path):
    """params_from_flat on FunASR's CT-Transformer names (torch's [C, 1, K]
    FSMN taps) gives the JAX package's tree."""
    rng = np.random.default_rng(4)
    d, f = 16, 24
    flat = {"embed.0.weight": rng.normal(size=(10, d)),
            "encoder.after_norm.weight": rng.normal(size=d),
            "encoder.after_norm.bias": rng.normal(size=d),
            "decoder.weight": rng.normal(size=(6, d)),
            "decoder.bias": rng.normal(size=6)}
    for i in range(2):
        pre = f"encoder.encoders.{i}"
        for name, shape in (("self_attn.linear_q_k_v", (3 * d, d)),
                            ("self_attn.linear_out", (d, d)),
                            ("feed_forward.w_1", (f, d)),
                            ("feed_forward.w_2", (d, f))):
            flat[f"{pre}.{name}.weight"] = rng.normal(size=shape)
            flat[f"{pre}.{name}.bias"] = rng.normal(size=shape[0])
        for n in ("norm1", "norm2"):
            flat[f"{pre}.{n}.weight"] = rng.normal(size=d)
            flat[f"{pre}.{n}.bias"] = rng.normal(size=d)
        flat[f"{pre}.self_attn.fsmn_block.weight"] = rng.normal(size=(d, 1, 3))
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    cfg = dict(PUNC, vocab_size=10)
    jp = jpunc.params_from_flat(flat, jpunc.PunctuationConfig(**cfg))
    tp = punc.params_from_flat({k: torch.from_numpy(v)
                                for k, v in flat.items()},
                               punc.PunctuationConfig(**cfg))
    ids = np.asarray([[1, 2, 3, 4]], np.int32)
    want = jpunc.forward(jp, jpunc.PunctuationConfig(**cfg), jnp.asarray(ids))
    got = punc.forward(tp, punc.PunctuationConfig(**cfg),
                       torch.from_numpy(ids).long())
    assert _rel(got, want) < 1e-5
    # and PunctuationModel.load reads the same from a directory
    from ominix_mlx_tpu_torch.utils.loading import save_safetensors
    save_safetensors(str(tmp_path / "punc.safetensors"),
                     {k: torch.from_numpy(v) for k, v in flat.items()})
    (tmp_path / "tokens.json").write_text(json.dumps(list(VOCAB)),
                                          encoding="utf-8")
    tm = punc.PunctuationModel.load(str(tmp_path), device="cpu")
    assert tm.vocab == VOCAB and len(tm.params["layers"]) == 2
