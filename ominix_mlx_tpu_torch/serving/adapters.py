"""Serving adapters: a model facade wrapped into the duck-typed capability
the server routes on (counterpart of ominix_mlx_tpu/serving/adapters.py;
``ASRAdapter`` only, ``TTSAdapter`` is not ported yet)."""

from __future__ import annotations

import numpy as np


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
