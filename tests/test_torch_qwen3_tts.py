"""The port's Qwen3-TTS against the JAX package's on the CPU, at the JAX
tests' tiny talker (``TINY`` of tests/test_qwen3_tts.py) and a tiny
codec, the JAX trees carried across by ``qwen3_tts.from_numpy``, inputs
seeded numpy, float32 (the talker's cache bf16 in both, as the JAX loop
allocates it):

  - ``text_projection``, ``apply_mrope_tts``: 1e-5 of the largest
    magnitude;
  - ``talker_step`` (a prefill then a step): 1e-2 (the JAX package's
    o_proj rounds its product to bf16 where attention read the bf16 cache
    with float32 weights, ``preferred_element_type``; the port's keeps
    float32: 1.8e-3 here); ``predict_codes``: codes equal;
  - the w8a8 talker (``quantize_params`` at 8 bits and group 64, fused),
    teacher-forced: codebook-0 logits within 0.05 of the largest (int8
    activations against the JAX package's exact CPU formula, as the
    port's other w8a8 parity tests);
  - ``Synthesizer.synthesize_codes``, ``stream`` and
    ``synthesize_voice_clone`` (reference codes teacher-forced): code for
    code, at least 3 frames each (the frame count is asserted, so an
    immediate EOS cannot pass); the codec's chunks of ``stream`` at 1e-4;
    a second request reuses the first's frame buffers; EOS at frame 0
    ends a request with no frame in both;
  - ``from_numpy``; ``TTSAdapter`` at speed 1.25 against the JAX adapter
    (WSOLA on the host): 1e-4.

The codec's layers and the speech encoder are held in
tests/test_torch_tts_codec.py, the speaker encoder and cloning from a
reference clip in tests/test_torch_speaker_encoder.py.

The weights are made by the port's seeded ``init_*`` and carried to both
packages as numpy; the JAX functions are jitted here where the JAX
package calls them eagerly (the same functions: XLA on the CPU either
way), to keep the file short.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import qwen3_tts as jqt
from ominix_mlx_tpu.nn import layers as jlayers
from ominix_mlx_tpu.ops import quant_matmul as jqm
from ominix_mlx_tpu.serving import adapters as jadapters
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.models import qwen3_tts as qt
from ominix_mlx_tpu_torch.nn import layers
from ominix_mlx_tpu_torch.serving import adapters

torch.set_num_threads(2)

BODY = dict(vocab_size=1, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=96)
TALK = dict(codec_vocab_size=32, codec_head_size=40, num_code_groups=16,
            text_vocab_size=128, text_embed_dim=48, cp_hidden=32,
            cp_layers=1, cp_heads=2, codec_eos_id=33, codec_pad_id=34,
            codec_bos_id=35, tts_pad_token_id=100)
JTINY = jqt.TalkerConfig(transformer=jbase.TransformerConfig(**BODY), **TALK)
TINY = qt.TalkerConfig(transformer=base.TransformerConfig(**BODY), **TALK)
CODEC = dict(frame_dim=32, up_strides=(2,), dec_strides=(2, 2),
             codec_vocab=32)
PREFIX = [36, 37, 38, 39]
TEXT = [5, 9, 3, 17, 11]
FRAMES = 6
REF_SEED = 8


def _np(tree):
    """A tree of tensors -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _jnp(tree):
    """A tree of tensors -> the JAX package's tree of the same values."""
    return jax.tree_util.tree_map(jnp.asarray, _np(tree))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def talker():
    """A random talker from a seeded generator, carried to both packages
    through numpy; its codec-0 head scaled up so the greedy codes move
    from frame to frame (at its initial range a tiny model repeats one
    code)."""
    tp = qt.init_params(TINY, _gen(0), device="cpu")
    tp["codec_head"]["w"] *= 4
    return _jnp(tp), qt.from_numpy(_np(tp), "cpu")


@pytest.fixture(scope="module")
def codec():
    dec, cfg = qt.init_codec(_gen(1), **CODEC, device="cpu")
    rng = np.random.default_rng(7)
    # non-trivial SnakeBeta parameters and biases
    dec = jax.tree_util.tree_map(
        lambda a: (a * rng.uniform(0.5, 1.5, size=a.shape)).astype(
            np.float32), _np(dec))
    return _jnp(dec), cfg, qt.from_numpy(dec, "cpu")


@pytest.fixture(scope="module")
def jax_decode(codec):
    """The JAX package's codec_decode, jitted (one compile a length)."""
    dec, cfg, _ = codec
    fn = jax.jit(lambda d, c: jqt.codec_decode(d, c, cfg))
    return lambda codes: np.asarray(fn(dec, jnp.asarray(codes, jnp.int32)))


@pytest.fixture(scope="module")
def synths(talker, codec):
    """(the JAX Synthesizer without a codec, the port's with one); every
    request here needs one capacity (4 + 2 + 6 + 8 frames), so the JAX
    package compiles its frame step once."""
    jp, tp = talker
    _, cfg, tdec = codec
    return jqt.Synthesizer(jp, JTINY), qt.Synthesizer(tp, TINY, tdec, cfg)


# ------------------------------------------------------------ functions

def test_text_projection_matches_jax(talker):
    jp, tp = talker
    x = np.random.default_rng(0).normal(size=(1, 5, 48)).astype(np.float32)
    want = jqt.text_projection(jp["text_projection"], jnp.asarray(x))
    assert _rel(qt.text_projection(tp["text_projection"], _t(x)),
                want) < 1e-5


def test_apply_mrope_tts_matches_jax():
    x = np.random.default_rng(3).normal(size=(1, 2, 5, 16)).astype(
        np.float32)
    for offset, ts in ((0, 4), (7, 4), (3, 8)):
        want = jqt.apply_mrope_tts(jnp.asarray(x), offset, ts)
        assert _rel(qt.apply_mrope_tts(_t(x), offset, ts), want) < 1e-5


# --------------------------------------------------------------- the loop

def test_synthesize_codes_match_jax(synths):
    js, ts = synths
    want = js.synthesize_codes(TEXT, PREFIX, max_frames=FRAMES)
    got = ts.synthesize_codes(TEXT, PREFIX, max_frames=FRAMES)
    assert want.frames == FRAMES and got.frames == want.frames
    np.testing.assert_array_equal(got.codes, want.codes)
    assert got.codes.dtype == np.int32
    # a second request reuses the first's frame buffers
    states = dict(ts._states)
    again = ts.synthesize_codes(TEXT, PREFIX, max_frames=FRAMES)
    np.testing.assert_array_equal(again.codes, want.codes)
    assert ts._states == states and ts.captures == 0


def test_eos_ends_a_request_as_in_jax(talker):
    """With a codec-head bias that makes EOS win, frame 0 is EOS: no frame
    in either package, an empty [0, 16] result."""
    jp, tp = talker
    bias = np.zeros(40, np.float32)
    bias[33] = 1e4
    jq = dict(jp, codec_head={**jp["codec_head"], "b": jnp.asarray(bias)})
    tq = dict(tp, codec_head={**tp["codec_head"], "b": _t(bias)})
    want = jqt.Synthesizer(jq, JTINY).synthesize_codes(TEXT, PREFIX, FRAMES)
    got = qt.Synthesizer(tq, TINY).synthesize_codes(TEXT, PREFIX, FRAMES)
    assert want.frames == got.frames == 0
    assert got.codes.shape == want.codes.shape == (0, 16)


def test_stream_matches_jax(synths, jax_decode):
    """Chunks of 4 frames: without a codec the code chunks of the JAX
    package's ``stream``, code for code; with one, each chunk's waveform
    within 1e-4 of the JAX codec_decode of the same codes."""
    js, ts = synths
    want = list(js.stream(TEXT, PREFIX, chunk_frames=4, max_frames=FRAMES))
    assert [len(c) for c in want] == [4, 2]
    codec, ts.codec = ts.codec, None
    try:
        got = list(ts.stream(TEXT, PREFIX, chunk_frames=4,
                             max_frames=FRAMES))
    finally:
        ts.codec = codec
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    waves = list(ts.stream(TEXT, PREFIX, chunk_frames=4, max_frames=FRAMES))
    per = qt.samples_per_frame(ts.codec_cfg)
    for g, w in zip(waves, want):
        assert len(g) == len(w) * per
        assert _rel(g, jax_decode(w)) < 1e-4


def test_voice_clone_matches_jax(synths):
    """Three reference frames teacher-forced through the frame step, then
    three free frames: code for code (the capacity of the plain requests,
    so no new JAX compile)."""
    js, ts = synths
    ref = np.random.default_rng(REF_SEED).integers(0, 31, (3, 16))
    want = js.synthesize_voice_clone([5, 9], [11, 3, 7], ref_codes=ref,
                                     max_frames=3)
    got = ts.synthesize_voice_clone([5, 9], [11, 3, 7], ref_codes=ref,
                                    max_frames=3)
    assert want.frames == 3 and got.frames == want.frames
    np.testing.assert_array_equal(got.codes, want.codes)
    inst = ts.synthesize_voice_clone_instruct([5, 9], [7], [11, 3],
                                              ref_codes=ref, max_frames=3)
    np.testing.assert_array_equal(inst.codes, got.codes)


class _Tok:
    def encode(self, text):
        return [ord(c) % 100 for c in text]


class _Short:
    """A synthesizer whose requests stop at FRAMES frames; the JAX one's
    codec is the jitted JAX codec_decode."""

    def __init__(self, synth, decode=None):
        self.synth, self.codec = synth, True
        self.decode = decode or synth.decode_audio

    def synthesize_codes(self, ids, prefix):
        return self.synth.synthesize_codes(ids, prefix, FRAMES)

    def decode_audio(self, codes):
        return self.decode(codes)


def test_tts_adapter_speed_matches_jax(synths, jax_decode):
    """TTSAdapter at speed 1.25 (at a 400 Hz rate, so that WSOLA's 30 ms
    frames fit the tiny codec's waveform several times): the waveform
    time-stretched by the port's WSOLA (numpy, copied) against the JAX
    adapter, within 1e-4."""
    js, ts = synths
    ja = jadapters.TTSAdapter(_Short(js, jax_decode), _Tok(), PREFIX, 400,
                              speed=1.25)
    ta = adapters.TTSAdapter(_Short(ts), _Tok(), PREFIX, 400, speed=1.25)
    want, wr = ja.synthesize("hello")
    got, gr = ta.synthesize("hello")
    full = ts.decode_audio(ts.synthesize_codes(_Tok().encode("hello"),
                                               PREFIX, FRAMES).codes)
    assert gr == wr == 400 and len(got) == len(want)
    assert 0 < len(got) < len(full)
    assert _rel(got, want) < 1e-4


# ---------------------------------------------------------- the talker

def _jax_cache(cap):
    return jbase.init_cache(JTINY.transformer, 1, cap, jnp.bfloat16)


def _port_cache(cap):
    return base.init_cache(TINY.transformer, 1, cap, torch.bfloat16, "cpu")


JAX_TALKER_STEP = jax.jit(jqt.talker_step, static_argnames=("tcfg",))


def test_talker_step_and_predict_codes_match_jax(talker):
    """A 5-token prefill into a cache of 20 (the shapes of the loop's, so
    the JAX package's compile is reused) then a step."""
    jp, tp = talker
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(1, 5, 64)).astype(np.float32) * 0.5
    step = rng.normal(size=(1, 1, 64)).astype(np.float32) * 0.5
    jl, jh, jc = JAX_TALKER_STEP(jp, JTINY, jnp.asarray(emb), _jax_cache(20))
    jl2, jh2, _ = JAX_TALKER_STEP(jp, JTINY, jnp.asarray(step), jc)
    with torch.inference_mode():
        tl, th, tc = qt.talker_step(tp, TINY, _t(emb), _port_cache(20),
                                    fresh_prefill=True)
        tl2, th2, _ = qt.talker_step(tp, TINY, _t(step), tc)
    for got, want in ((tl, jl), (th, jh), (tl2, jl2), (th2, jh2)):
        assert _rel(got, want) < 1e-2
    c0e = np.asarray(jp["codec_embedding"])[[[7]]]
    want = jqt.predict_codes(jp["code_predictor"], JTINY, jh2, c0e)
    got = qt.predict_codes(tp["code_predictor"], TINY, th2, _t(c0e))
    assert got.tolist() == np.asarray(want).tolist()
    # a scratch cache holding NaN is zeroed before use
    scratch = qt.predictor_cache(TINY, tp["code_predictor"], 1,
                                 torch.float32, "cpu")
    for lc in scratch.layers:
        lc.k.fill_(float("nan"))
    again = qt.predict_codes(tp["code_predictor"], TINY, th2, _t(c0e),
                             scratch)
    assert torch.equal(again, got)


def _to_numpy(tree):
    """A JAX tree with packed weights -> numpy, the packed ones in the
    canonical form with their dispatch flags (tests/test_torch_model.py)."""
    if isinstance(tree, jqm.PackedQuantizedTensor):
        u = jqm.unpack(tree)
        return {"q": np.array(u.q), "scales": np.asarray(u.scales),
                "biases": np.asarray(u.biases), "group_size": u.group_size,
                "bits": u.bits, "batched": tree.batched, "tn": tree.tn}
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return np.asarray(tree)


def _frame_embeds(mod, p, tcfg, codes, tok, emb_fn):
    te = mod.text_projection(p["text_projection"],
                             emb_fn(p["text_embedding"], tok))
    c0 = emb_fn(p["codec_embedding"], codes[:, :1])
    rest = sum(p["code_predictor"]["codec_embeddings"][g][codes[:, g + 1]]
               [:, None] for g in range(tcfg.num_code_groups - 1))
    return te + c0 + rest


def test_w8a8_talker_logits_close_to_jax(talker):
    """The talker at 8-bit group-64 weights (``quantize_params``, then
    fused; the predictor and the heads stay dense), int8 activations at
    its one-row steps: a prefill and 3 teacher-forced frames, codebook-0
    logits within 0.05 of the largest against the JAX package's CPU path
    on the same quantized tree."""
    jp, _ = talker
    jq = jbase.fuse_layer_projections(
        jbase.quantize_params(jp, 64, 8, consume=False))
    tq = qt.from_numpy(_to_numpy(jq), "cpu")
    assert tq["layers"][0]["qkv_proj"]["w"].bits == 8
    for w in (tq["code_predictor"]["layers"][0]["q_proj"]["w"],
              tq["codec_head"]["w"]):
        assert isinstance(w, torch.Tensor)
    rng = np.random.default_rng(6)
    emb = rng.normal(size=(1, 5, 64)).astype(np.float32) * 0.5
    jl, _, jc = JAX_TALKER_STEP(jq, JTINY, jnp.asarray(emb), _jax_cache(20))
    tc = _port_cache(20)
    with torch.inference_mode():
        tl, _, tc = qt.talker_step(tq, TINY, _t(emb), tc,
                                   fresh_prefill=True)
        assert _rel(tl, jl) < 0.05
        for f in range(3):
            codes = rng.integers(0, 32, (1, 16))
            tok = np.asarray([[TEXT[f]]])
            je = _frame_embeds(jqt, jq, JTINY, jnp.asarray(codes),
                               jnp.asarray(tok), jlayers.embedding)
            te = _frame_embeds(qt, tq, TINY, _t(codes), _t(tok),
                               layers.embedding)
            jl, _, jc = JAX_TALKER_STEP(jq, JTINY, je, jc)
            tl, _, tc = qt.talker_step(tq, TINY, te, tc)
            assert _rel(tl, jl) < 0.05, f


def test_from_numpy_carries_the_trees(talker, codec):
    _, tp = talker
    _, _, tdec = codec
    cp = tp["code_predictor"]
    assert len(cp["codec_embeddings"]) == 15 and len(cp["lm_heads"]) == 15
    assert tuple(tp["codec_head"]["w"].shape) == (40, 64)
    assert tp["text_embedding"].dtype == torch.float32
    assert tuple(tdec["decoder_blocks"][0]["conv_t"]["w"].shape) == \
        (32, 4, 32)                          # MLX [C_out, K, C_in] kept
    jcfg = jbase.TransformerConfig(vocab_size=1, hidden_size=16,
                                   num_layers=1, num_heads=4,
                                   num_kv_heads=4, head_dim=4,
                                   intermediate_size=32)
    tenc = qt.from_numpy({"final_conv": {"w": np.ones((2, 3, 2),
                                                      np.float32)},
                          "_tcfg": jcfg}, "cpu", torch.bfloat16)
    assert tenc["final_conv"]["w"].dtype == torch.bfloat16
    assert tenc["_tcfg"] == base.TransformerConfig(
        vocab_size=1, hidden_size=16, num_layers=1, num_heads=4,
        num_kv_heads=4, head_dim=4, intermediate_size=32)
