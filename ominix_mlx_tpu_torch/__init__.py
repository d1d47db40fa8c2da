"""ominix_mlx_tpu_torch: the PyTorch + CUDA port of ominix_mlx_tpu.

The JAX package (``ominix_mlx_tpu``) stays the reference; this package
mirrors its module paths and names so each counterpart sits at the same
relative path. It imports ``torch`` and never ``jax``.

Layering:

    HTTP server               (serving.server)
    model                     (models.base, models.qwen3)
    core                      (core: quant, rope, attention, cache,
                               sampling, generate)
    layers                    (nn.layers)
    kernels                   (ops: quantized matmul K1, flash prefill K2,
                               hand-written CUDA for sm_90a in csrc/)
    PyTorch / CUDA

Every kernel wrapper runs its plain PyTorch version only for CPU tensors;
a CUDA tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
