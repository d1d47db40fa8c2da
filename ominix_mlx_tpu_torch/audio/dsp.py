"""Audio front ends on the device (counterpart of
ominix_mlx_tpu/audio/dsp.py): a framed STFT, mel filterbanks, the
Whisper-style log-mel, low-frame-rate stacking and CMVN, in plain
PyTorch on the samples' device.

  - Qwen3-ASR: 128 mels, n_fft 400, hop 160, the Whisper norm;
  - Paraformer and Fun-ASR-Nano: 80 mels, then LFR (7 frames every 6)
    and, where the checkpoint has it, CMVN;
  - TTS speed control: ``wsola_time_stretch``, host numpy.

The filterbank is built in numpy and cached as numpy (``_hz_to_mel``,
``_mel_to_hz`` and ``mel_filterbank`` are copied from the JAX package).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def as_samples(samples, device) -> torch.Tensor:
    """An array or tensor of audio samples -> float32 [T] on ``device``."""
    t = samples if isinstance(samples, torch.Tensor) else \
        torch.from_numpy(np.asarray(samples, np.float32))
    return t.to(device=device, dtype=torch.float32).reshape(-1)


def hann_window(n: int, periodic: bool = True, device=None) -> torch.Tensor:
    """Hann window, float32 [n]."""
    m = n if periodic else n - 1
    k = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * k / m))


def stft(samples: torch.Tensor, n_fft: int = 400, hop: int = 160,
         center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """[T] float32 -> complex spectrogram [frames, n_fft // 2 + 1]: the
    signal padded by n_fft // 2 on both sides (reflected) where ``center``,
    cut into frames of n_fft every ``hop`` samples, each windowed (Hann)
    and transformed by ``torch.fft.rfft``."""
    if center:
        pad = n_fft // 2
        samples = F.pad(samples[None, None], (pad, pad),
                        mode=pad_mode)[0, 0]
    frames = samples.unfold(0, n_fft, hop)              # [F, n_fft]
    frames = frames * hann_window(n_fft, device=samples.device)
    return torch.fft.rfft(frames, dim=-1)


def _hz_to_mel(f, htk: bool):
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3.0)
    log_step = np.log(6.4) / 27.0
    brk = 1000.0
    above = f >= brk
    mel = np.where(above, 15.0 + np.log(np.maximum(f, brk) / brk) / log_step, mel)
    return mel


def _mel_to_hz(m, htk: bool):
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3.0)
    log_step = np.log(6.4) / 27.0
    above = m >= 15.0
    return np.where(above, 1000.0 * np.exp(log_step * (np.maximum(m, 15.0) - 15.0)), f)


@functools.lru_cache(maxsize=None)
def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int,
                   fmin: float = 0.0, fmax: Optional[float] = None,
                   htk: bool = False, norm: Optional[str] = "slaney"):
    """[n_mels, n_fft//2+1] triangular filterbank, float32 numpy (built
    once per configuration on the host)."""
    fmax = fmax or sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2.0, n_bins)
    mels = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2)
    hz = _mel_to_hz(mels, htk)
    fb = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lo, ctr, hi = hz[i], hz[i + 1], hz[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    if norm == "slaney":
        enorm = 2.0 / (hz[2:] - hz[:-2])
        fb *= enorm[:, None]
    return np.asarray(fb, np.float32)


def log_mel_spectrogram(samples: torch.Tensor, n_fft: int = 400,
                        hop: int = 160, n_mels: int = 128,
                        sample_rate: int = 16000, htk: bool = False,
                        log_base: str = "log10", whisper_norm: bool = True,
                        center: bool = True) -> torch.Tensor:
    """Whisper-compatible log-mel, [T] float32 -> [frames, n_mels]: power
    spectrum (|X| squared), mel, clamp to 1e-10, log10 (or ln), then with
    ``whisper_norm`` clamp to (max - 8) and (x + 4) / 4."""
    spec = stft(samples, n_fft, hop, center=center)
    power = spec.abs() ** 2                             # [F, bins]
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate,
                                         htk=htk)).to(samples.device)
    mel = power @ fb.T                                  # [F, n_mels]
    mel = torch.clamp_min(mel, 1e-10)
    logm = torch.log10(mel) if log_base == "log10" else torch.log(mel)
    if whisper_norm:
        logm = torch.maximum(logm, logm.max() - 8.0)
        logm = (logm + 4.0) / 4.0
    return logm


def lfr_index(T: int, lfr_m: int = 7, lfr_n: int = 6) -> np.ndarray:
    """[n_out, lfr_m] rows of the padded features that each output frame
    stacks (the padding repeats the first frame (lfr_m - 1) // 2 times in
    front and the last as often as the last window needs)."""
    lpad = (lfr_m - 1) // 2
    n_out = (T + lfr_n - 1) // lfr_n
    idx = np.arange(n_out)[:, None] * lfr_n + np.arange(lfr_m)[None, :]
    # the padded sequence: lpad copies of frame 0, the frames, then copies
    # of the last frame; map each of its positions to a frame
    return np.clip(idx - lpad, 0, T - 1)


def apply_lfr(feats: torch.Tensor, lfr_m: int = 7,
              lfr_n: int = 6) -> torch.Tensor:
    """Low-frame-rate stacking, [T, D] -> [ceil(T / lfr_n), lfr_m * D]:
    lfr_m frames every lfr_n, repeat-padded on both sides."""
    T, D = feats.shape
    idx = torch.from_numpy(lfr_index(T, lfr_m, lfr_n)).to(feats.device)
    return feats[idx].reshape(idx.shape[0], lfr_m * D)


def apply_cmvn(feats: torch.Tensor, means: torch.Tensor,
               vars_: torch.Tensor) -> torch.Tensor:
    """Global CMVN: (feats + means) * vars (the checkpoint stores the
    negated means and the inverse deviations)."""
    return (feats + means) * vars_


def wsola_time_stretch(samples, rate: int, speed: float,
                       frame_ms: float = 30.0, overlap_ms: float = 10.0,
                       search_ms: float = 8.0) -> np.ndarray:
    """WSOLA time stretching for TTS speed control: speed > 1 shortens the
    audio. Host numpy (a small sequential search over ms-scale windows),
    copied from the JAX package's ``audio.dsp.wsola_time_stretch``."""
    x = np.asarray(samples, np.float32)
    if abs(speed - 1.0) < 1e-3 or len(x) == 0:
        return x
    frame = int(rate * frame_ms / 1000)
    overlap = int(rate * overlap_ms / 1000)
    search = int(rate * search_ms / 1000)
    hop_out = frame - overlap
    hop_in = int(round(hop_out * speed))
    n_frames = max(1, (len(x) - frame - search) // hop_in)
    out = np.zeros(n_frames * hop_out + frame, np.float32)
    win = np.hanning(2 * overlap + 1)[:overlap] if overlap else None
    prev_tail = None
    pos_out = 0
    for i in range(n_frames):
        target = i * hop_in
        if prev_tail is not None and search > 0:
            lo = max(0, target - search)
            hi = min(len(x) - frame, target + search)
            best, best_c = target, -np.inf
            for cand in range(lo, hi + 1, max(1, search // 16)):
                seg = x[cand:cand + overlap]
                c = float(np.dot(seg, prev_tail))
                if c > best_c:
                    best_c, best = c, cand
            target = best
        seg = x[target:target + frame]
        if len(seg) < frame:
            seg = np.pad(seg, (0, frame - len(seg)))
        if prev_tail is not None and overlap:
            out[pos_out:pos_out + overlap] *= (1 - win)
            out[pos_out:pos_out + overlap] += seg[:overlap] * win
            out[pos_out + overlap:pos_out + frame] = seg[overlap:]
        else:
            out[pos_out:pos_out + frame] = seg
        prev_tail = x[target + hop_out:target + hop_out + overlap]
        pos_out += hop_out
    return out[:pos_out + overlap]
