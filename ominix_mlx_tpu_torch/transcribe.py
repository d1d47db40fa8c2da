"""Speech to text from the command line (the port's counterpart of
examples/transcribe.py, with its flags, and ``--device``):

    python -m ominix_mlx_tpu_torch.transcribe --model DIR --audio X.wav \\
        [--punc DIR] [--long] [--translate] [--device cpu]

The checkpoint directory loads through ``models.registry.load_pipeline``
(Paraformer, Qwen3-ASR, Fun-ASR-Nano or FunASR-Qwen4B); the WAV file is
read and resampled to 16 kHz (``audio.io.load_wav``); ``--long`` takes
the chunked long-audio path where the model has one, ``--translate``
speech-to-English where it translates, ``--punc`` restores punctuation
with a CT-Transformer directory. The text goes to standard output. The
model runs on the current CUDA device unless ``--device`` names another.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="transcribe a WAV file")
    ap.add_argument("--model", required=True)
    ap.add_argument("--audio", required=True)
    ap.add_argument("--punc", default=None,
                    help="CT-Transformer punctuation model dir")
    ap.add_argument("--long", action="store_true",
                    help="chunked long-audio transcription")
    ap.add_argument("--translate", action="store_true",
                    help="translate speech directly to English "
                         "(models exposing translate())")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ominix_mlx_tpu_torch.audio.io import load_wav
    from ominix_mlx_tpu_torch.core.device import resolve_device
    from ominix_mlx_tpu_torch.models import registry

    args = parse_args(argv)
    device = resolve_device(args.device)
    cap, asr = registry.load_pipeline(args.model, device)
    if not hasattr(asr, "transcribe"):
        raise SystemExit(f"{args.model} has no ASR capability (got {cap})")
    samples, rate = load_wav(args.audio, target_rate=16000)
    if args.translate:
        if not hasattr(asr, "translate"):
            raise SystemExit(f"{args.model} does not support speech "
                             "translation")
        text = (asr.translate_long(samples, rate)
                if args.long and hasattr(asr, "translate_long")
                else asr.translate(samples, rate))
    elif args.long and hasattr(asr, "transcribe_long"):
        text = asr.transcribe_long(samples, rate)
    else:
        text = asr.transcribe(samples, rate)
    if args.punc:
        from ominix_mlx_tpu_torch.models.punctuation import PunctuationModel
        text = PunctuationModel.load(args.punc, device).punctuate(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
