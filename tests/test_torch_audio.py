"""The port's audio front end, WAV I/O, native resampler and ``conv1d``
against the JAX package's on the CPU, on seeded numpy inputs:

  - the Hann window: within 2^-23 (one float32 step below 1: the two
    libraries' cos differ in the last place);
  - the mel filterbank and LFR: equal (the same numpy code, or a gather);
  - CMVN: equal (one add and one multiply);
  - the STFT: 1e-5 of its largest magnitude (two FFT libraries sum in
    other orders);
  - the log-mel (80 and 128 mels, Whisper norm): 1e-4 absolute on values
    of order 1 (the STFT's rounding through the log);
  - the resampler and the PCM conversions: bit for bit (the same C++
    source built with the same flags);
  - ``load_wav``: equal; ``conv1d`` (depthwise and full, with bias and
    padding): 1e-5 relative (float32 sums in other orders).
"""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu import native as jnative
from ominix_mlx_tpu.audio import dsp as jdsp
from ominix_mlx_tpu.audio import io as jio
from ominix_mlx_tpu.nn.layers import conv1d as jconv1d
from ominix_mlx_tpu_torch import native
from ominix_mlx_tpu_torch.audio import dsp, io
from ominix_mlx_tpu_torch.nn.layers import conv1d

torch.set_num_threads(2)


def _audio(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.normal(size=n)
    return x.astype(np.float32)


def test_hann_window_is_the_jax_one():
    for n, periodic in ((400, True), (64, False)):
        np.testing.assert_allclose(
            dsp.hann_window(n, periodic).numpy(),
            np.asarray(jdsp.hann_window(n, periodic)), rtol=0,
            atol=2.0 ** -23)


def test_mel_filterbank_is_the_jax_one():
    for args in ((80, 400, 16000), (128, 400, 16000), (40, 512, 8000, 0.0,
                                                       None, True, None)):
        np.testing.assert_array_equal(dsp.mel_filterbank(*args),
                                      jdsp.mel_filterbank(*args))


@pytest.mark.parametrize("n", [4000, 16123])
def test_stft_matches_jax(n):
    x = _audio(n, seed=n)
    want = np.asarray(jdsp.stft(jnp.asarray(x)))
    got = dsp.stft(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n_mels,rate", [(80, 16000), (128, 16000),
                                         (80, 8000)])
def test_log_mel_matches_jax(n_mels, rate):
    x = _audio(9000, seed=n_mels)
    want = np.asarray(jdsp.log_mel_spectrogram(
        jnp.asarray(x), 400, 160, n_mels, rate))
    got = dsp.log_mel_spectrogram(torch.from_numpy(x), 400, 160, n_mels,
                                  rate).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("T,m,n", [(1, 7, 6), (5, 7, 6), (37, 7, 6),
                                   (60, 7, 6), (11, 2, 1), (13, 4, 3)])
def test_lfr_is_the_jax_gather(T, m, n):
    feats = np.random.default_rng(T).normal(size=(T, 5)).astype(np.float32)
    want = np.asarray(jdsp.apply_lfr(jnp.asarray(feats), m, n))
    got = dsp.apply_lfr(torch.from_numpy(feats), m, n).numpy()
    np.testing.assert_array_equal(got, want)


def test_cmvn_is_the_jax_one():
    rng = np.random.default_rng(3)
    feats, means, vars_ = (rng.normal(size=s).astype(np.float32)
                           for s in ((9, 12), (12,), (12,)))
    want = np.asarray(jdsp.apply_cmvn(jnp.asarray(feats), jnp.asarray(means),
                                      jnp.asarray(vars_)))
    got = dsp.apply_cmvn(*(torch.from_numpy(a) for a in (feats, means,
                                                         vars_))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst,taps", [(16000, 24000, 16),
                                          (48000, 16000, 16),
                                          (44100, 16000, 32),
                                          (8000, 8000, 16)])
def test_resampler_is_the_jax_native_one_bit_for_bit(src, dst, taps):
    """Both packages build the same resample.cc with the same g++ flags
    (and the JAX package's numpy fallback is not the same function, so
    its library must have built)."""
    assert jnative.available()
    x = _audio(3001, seed=src)
    want = jnative.resample_sinc(x, src, dst, taps)
    got = native.resample_sinc(x, src, dst, taps)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_pcm_conversions_are_the_jax_native_ones():
    x = np.linspace(-1.2, 1.2, 2001).astype(np.float32)
    pcm = native.float_to_pcm16(x)
    np.testing.assert_array_equal(pcm, jnative.float_to_pcm16(x))
    np.testing.assert_array_equal(native.pcm16_to_float(pcm),
                                  jnative.pcm16_to_float(pcm))


def test_resampler_builds_into_the_ignored_build_dir():
    native.library()
    assert native.BUILD_DIR.name == "_build"
    assert list(native.BUILD_DIR.glob("libominix_native_*.so"))


@pytest.mark.parametrize("width,channels,target", [(2, 1, None),
                                                   (2, 2, 16000),
                                                   (4, 1, None),
                                                   (1, 2, 24000)])
def test_load_wav_matches_jax(tmp_path, width, channels, target):
    rng = np.random.default_rng(width * 10 + channels)
    n = 2400
    dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    info = np.iinfo(dtype)
    raw = rng.integers(info.min, info.max, n * channels, dtype=dtype)
    path = str(tmp_path / "x.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(8000)
        w.writeframes(raw.tobytes())
    got, rate = io.load_wav(path, target)
    want, want_rate = jio.load_wav(path, target)
    assert rate == want_rate
    np.testing.assert_array_equal(got, np.asarray(want))


def test_save_wav_matches_jax(tmp_path):
    x = _audio(1000) * 4          # past [-1, 1]: clamped
    io.save_wav(str(tmp_path / "a.wav"), x, 16000)
    jio.save_wav(str(tmp_path / "b.wav"), x, 16000)
    assert (tmp_path / "a.wav").read_bytes() == \
        (tmp_path / "b.wav").read_bytes()


@pytest.mark.parametrize("C_in,C_out,K,groups,padding,bias", [
    (12, 12, 11, 12, 5, False),        # depthwise (FSMN memory)
    (12, 16, 3, 1, 1, True),           # full (CIF predictor conv)
    (8, 8, 5, 2, ((3, 1),), True),     # grouped, uneven padding
])
def test_conv1d_matches_jax(C_in, C_out, K, groups, padding, bias):
    rng = np.random.default_rng(K)
    x = rng.normal(size=(2, 17, C_in)).astype(np.float32)
    p = {"w": rng.normal(size=(C_out, K, C_in // groups)).astype(np.float32)}
    if bias:
        p["b"] = rng.normal(size=(C_out,)).astype(np.float32)
    want = np.asarray(jconv1d({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), padding=padding,
                              groups=groups))
    got = conv1d({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), padding=padding, groups=groups)
    assert tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_conv1d_stride_and_dilation_match_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(1, 20, 4)).astype(np.float32)
    w = rng.normal(size=(6, 3, 4)).astype(np.float32)
    want = np.asarray(jconv1d({"w": jnp.asarray(w)}, jnp.asarray(x),
                              stride=2, padding=2, dilation=2))
    got = conv1d({"w": torch.from_numpy(w)}, torch.from_numpy(x), stride=2,
                 padding=2, dilation=2).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_jax_runs_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"
