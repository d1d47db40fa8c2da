"""Probes of the kernels' timing on the card, run by hand (``python -m
ominix_mlx_tpu_torch.probes.<name>``); nothing here runs at import."""
