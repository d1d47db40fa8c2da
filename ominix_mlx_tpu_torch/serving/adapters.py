"""Serving adapters: a model facade wrapped into the duck-typed capability
the server routes on (counterpart of ominix_mlx_tpu/serving/adapters.py):
``TTSAdapter`` (synthesize) and ``ASRAdapter`` (transcribe)."""

from __future__ import annotations

from typing import Optional

import numpy as np


class TTSAdapter:
    """Wraps a ``qwen3_tts.Synthesizer`` and a tokenizer into
    ``synthesize(text, voice)`` -> (samples, rate): greedy frames after
    ``codec_prefix``, the codec's waveform (1920 zeros a frame where no
    codec is loaded, as in the JAX package), time-stretched by WSOLA
    where ``speed`` is not 1. ``voice`` is not read."""

    def __init__(self, synthesizer, tokenizer, codec_prefix,
                 sample_rate: int = 24000, speed: float = 1.0):
        self.synth = synthesizer
        self.tokenizer = tokenizer
        self.codec_prefix = list(codec_prefix)
        self.sample_rate = sample_rate
        self.speed = speed
        self.dir = "<assembled>"

    def synthesize(self, text: str, voice: Optional[str] = None):
        from ominix_mlx_tpu_torch.audio.dsp import wsola_time_stretch

        ids = self.tokenizer.encode(text)
        res = self.synth.synthesize_codes(ids, self.codec_prefix)
        wav = (self.synth.decode_audio(res.codes)
               if self.synth.codec is not None
               else np.zeros((res.frames * 1920,), np.float32))
        if self.speed != 1.0:
            wav = wsola_time_stretch(wav, self.sample_rate, self.speed)
        return wav, self.sample_rate


class ASRAdapter:
    """Wraps a ``qwen3_asr.Qwen3ASR`` (or another model with
    ``encode_audio`` and ``transcribe_embeds``) and a tokenizer into
    ``transcribe(samples, rate)``: the samples resampled to 16 kHz, the
    audio features spliced between the given prompt ids, greedy decoding
    to a stop token, the ids decoded."""

    def __init__(self, model, tokenizer, prompt_prefix, prompt_suffix,
                 stop_tokens=()):
        self.model = model
        self.tokenizer = tokenizer
        self.prefix = [int(t) for t in prompt_prefix]
        self.suffix = [int(t) for t in prompt_suffix]
        self.stop_tokens = tuple(stop_tokens)
        self.dir = "<assembled>"

    def transcribe(self, samples, rate: int) -> str:
        from ominix_mlx_tpu_torch.audio.io import resample

        if rate != 16000:
            samples = resample(np.asarray(samples, np.float32), rate, 16000)
        feats = self.model.encode_audio(samples)
        ids = self.model.transcribe_embeds(feats, self.prefix, self.suffix,
                                           stop_tokens=self.stop_tokens)
        return self.tokenizer.decode(ids)
