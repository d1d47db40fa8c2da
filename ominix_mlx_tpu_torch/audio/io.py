"""WAV I/O and resampling on the host (counterpart of
ominix_mlx_tpu/audio/io.py): numpy and the stdlib ``wave`` only, the
resampler from the package's own native library (``native``)."""

from __future__ import annotations

import wave

import numpy as np


def load_wav(path: str, target_rate: int | None = None):
    """-> (samples float32 in [-1, 1], mono (channels averaged), sample
    rate), resampled to ``target_rate`` when it is given and differs."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    if target_rate and target_rate != rate:
        data = resample(data, rate, target_rate)
        rate = target_rate
    return data, rate


def save_wav(path: str, samples, rate: int):
    """Mono 16-bit PCM: samples clamped to [-1, 1], scaled by 32767 and
    truncated (the JAX package's rule)."""
    samples = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = (samples * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def resample(samples, src_rate: int, dst_rate: int) -> np.ndarray:
    """Band-limited resample by the native windowed-sinc kernel
    (``native.resample_sinc``; a failed build raises)."""
    from ominix_mlx_tpu_torch import native

    return native.resample_sinc(samples, src_rate, dst_rate)
