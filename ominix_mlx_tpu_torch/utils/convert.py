"""Checkpoint name maps (copied from ominix_mlx_tpu/utils/convert.py:143-160:
``PARAFORMER_RENAMES`` and ``paraformer_rename``; the rest of that module
is not ported yet)."""

from __future__ import annotations

PARAFORMER_RENAMES = {
    # reference convert.rs:253-381 Paraformer mapping table (subset; the
    # mapping is completed when checkpoints are wired)
    "encoder.encoders0.0.": "first_layer.",
    "encoder.encoders.": "layers.",
    "predictor.cif_conv1d.": "predictor.conv.",
    "predictor.cif_output.": "predictor.output_proj.",
    "decoder.decoders.": "dec_layers.",
    "decoder.after_norm.": "dec_after_norm.",
    "decoder.output_layer.": "output_layer.",
}


def paraformer_rename(name: str) -> str:
    for old, new in PARAFORMER_RENAMES.items():
        if name.startswith(old):
            return new + name[len(old):]
    return name
