"""Text to speech from the command line (the port's counterpart of
examples/speak.py, with its flags, and ``--device``):

    python -m ominix_mlx_tpu_torch.speak --model DIR --text "..." \\
        [--voice NAME] [--out out.wav] [--speed 1.0] [--play] [--device cpu]

The checkpoint directory loads through ``models.registry.load_pipeline``
(any model with ``synthesize(text, voice=None)``: Qwen3-TTS); the
waveform is time-stretched by WSOLA where ``--speed`` is not 1, written
as 16-bit mono WAV, and played on the host with ``--play``. The model
runs on the current CUDA device unless ``--device`` names another.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="synthesize speech to a WAV")
    ap.add_argument("--model", required=True)
    ap.add_argument("--text", required=True)
    ap.add_argument("--voice", default=None)
    ap.add_argument("--out", default="out.wav")
    ap.add_argument("--play", action="store_true",
                    help="play on the host after writing")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="WSOLA time-stretch factor")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    import numpy as np

    from ominix_mlx_tpu_torch.audio.io import save_wav
    from ominix_mlx_tpu_torch.core.device import resolve_device
    from ominix_mlx_tpu_torch.models import registry

    args = parse_args(argv)
    cap, tts = registry.load_pipeline(args.model, resolve_device(args.device))
    if not hasattr(tts, "synthesize"):
        raise SystemExit(f"{args.model} has no TTS capability (got {cap})")
    samples, rate = tts.synthesize(args.text, voice=args.voice)
    samples = np.asarray(samples, np.float32)
    if args.speed != 1.0:
        from ominix_mlx_tpu_torch.audio.dsp import wsola_time_stretch
        samples = wsola_time_stretch(samples, rate, args.speed)
    save_wav(args.out, samples, rate)
    print(f"{len(samples) / rate:.2f}s -> {args.out}")
    if args.play:
        from ominix_mlx_tpu_torch.audio.playback import play
        play(samples, rate)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
