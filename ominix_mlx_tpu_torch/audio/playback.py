"""Host audio playback (copied from ominix_mlx_tpu/audio/playback.py).

Best effort across environments: sounddevice or simpleaudio where
installed, else the first command-line player found (aplay, paplay,
afplay, ffplay), else a RuntimeError telling the caller that the WAV was
still written. Importing never fails, so headless servers and tests
import this module without an audio stack.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile

import numpy as np


def play(wav: np.ndarray, sample_rate: int = 32000,
         blocking: bool = True) -> str:
    """Play a mono float waveform on the host; returns the backend used.

    Raises RuntimeError when no playback backend exists (the caller
    should point the user at the written WAV file instead)."""
    wav = np.asarray(wav, dtype=np.float32).reshape(-1)
    try:
        import sounddevice

        sounddevice.play(wav, samplerate=sample_rate, blocking=blocking)
        return "sounddevice"
    except Exception:
        pass
    try:
        import simpleaudio

        pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
        p = simpleaudio.play_buffer(pcm, 1, 2, sample_rate)
        if blocking:
            p.wait_done()
        return "simpleaudio"
    except Exception:
        pass
    for player, args in (("aplay", []), ("paplay", []), ("afplay", []),
                         ("ffplay", ["-nodisp", "-autoexit",
                                     "-loglevel", "quiet"])):
        if shutil.which(player):
            from ominix_mlx_tpu_torch.audio.io import save_wav

            with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
                save_wav(tmp.name, wav, sample_rate)
                subprocess.run([player, *args, tmp.name], check=True)
            return player
    raise RuntimeError(
        "no audio backend found (sounddevice/simpleaudio/aplay/paplay/"
        "afplay/ffplay); the synthesized wav can still be written with "
        "audio.io.save_wav")
