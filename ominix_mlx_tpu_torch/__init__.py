"""ominix_mlx_tpu_torch: the PyTorch + CUDA port of ominix_mlx_tpu.

The JAX package (``ominix_mlx_tpu``) stays the reference; this package
mirrors its module paths and names so each counterpart sits at the same
relative path. It imports ``torch`` and never ``jax``.

Layering:

    HTTP server               (serving.server, serving.batching)
    loading                   (models.registry, utils.loading,
                               utils.tokenizer)
    model                     (models.base, models.qwen3,
                               models.qwen3_moe, models.moe,
                               models.mistral, models.glm4)
    core                      (core: device, quant, rope, attention,
                               cache, paged_cache, sampling, generate)
    layers                    (nn.layers; the audio front end
                               audio.dsp, audio.io and the native
                               resampler)
    kernels                   (ops: quantized matmul K1, flash prefill
                               K2 and K2c (with a sliding window),
                               paged decode attention K3,
                               expert gather-qmm K4, grouped matmul K5,
                               and the port's own K8-K12 (K12: CIF);
                               hand-written CUDA for sm_90a in csrc/)
    PyTorch / CUDA

Every kernel wrapper runs its plain PyTorch version only for CPU tensors;
a CUDA tensor launches the kernel or raises. Entry points allocate on the
current CUDA device unless the caller names a device.
"""

__version__ = "0.1.0"
