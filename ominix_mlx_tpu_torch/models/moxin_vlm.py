"""Moxin-7B VLM: dual vision towers (DINOv2 + SigLIP) -> channel concat ->
fused-GELU MLP projector -> Mistral-7B decoder (counterpart of
ominix_mlx_tpu/models/moxin_vlm.py).

Each tower takes its own normalization of the [0, 1] image; the patch
features are concatenated along channels and projected into the decoder's
space, and the image tokens are spliced before the text prompt. The
decoder is ``models.base``: the spliced prompt runs ``forward_embeds``
with ``fresh_prefill=True`` (kernel K2 on CUDA), and decoding replays the
engine's captured step (``core.generate.Engine.decode``), as the JAX
package calls its engine's compiled step. The projector's GELU is the
tanh form (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.core.generate import Engine
from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
from ominix_mlx_tpu_torch.models import base, vit
from ominix_mlx_tpu_torch.nn.layers import (embedding, gelu_tanh, linear,
                                            resize_bilinear)
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


def _norm(image01: torch.Tensor, mean, std) -> torch.Tensor:
    # float32 constants, as the JAX package's numpy ones
    m = torch.tensor(mean, dtype=torch.float32, device=image01.device)
    s = torch.tensor(std, dtype=torch.float32, device=image01.device)
    return (image01 - m) / s


def preprocess(image01: torch.Tensor):
    """image01: [B, H, W, 3] in [0, 1] -> per-tower normalized inputs."""
    return (_norm(image01, IMAGENET_MEAN, IMAGENET_STD),
            _norm(image01, SIGLIP_MEAN, SIGLIP_STD))


def project(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Prismatic fused-GELU MLP projector (tanh GELU)."""
    h = gelu_tanh(linear(p["fc1"], x))
    h = gelu_tanh(linear(p["fc2"], h))
    return linear(p["fc3"], h)


def as_image(image01, device) -> torch.Tensor:
    """An [H, W, 3] or [B, H, W, 3] array or tensor in [0, 1] -> a float32
    [B, H, W, 3] tensor on ``device``."""
    t = torch.as_tensor(np.asarray(image01) if not isinstance(
        image01, torch.Tensor) else image01)
    t = t.to(device=device, dtype=torch.float32)
    return t[None] if t.ndim == 3 else t


@dataclasses.dataclass
class MoxinVLM:
    dino_params: dict
    dino_cfg: vit.ViTConfig
    siglip_params: dict
    siglip_cfg: vit.ViTConfig
    projector: dict
    lm_params: dict
    lm_cfg: base.TransformerConfig
    tokenizer: Optional[object] = None
    device: torch.device = dataclasses.field(
        default_factory=lambda: resolve_device(None))

    def __post_init__(self):
        self.device = torch.device(self.device)
        self._engine = None

    def engine(self) -> Engine:
        """The decoder's greedy Engine (its captured step per call)."""
        if self._engine is None:
            cfg = self.lm_cfg
            self._engine = Engine(lambda p, t, c: base.forward(p, cfg, t, c),
                                  self.lm_params, SamplerConfig())
        return self._engine

    @torch.inference_mode()
    def encode_image(self, image01: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] -> LLM-space patch embeddings [B, N, D]
        (in the projector's type)."""
        dino_in, sig_in = preprocess(image01)
        fd = vit.encode(self.dino_params, self.dino_cfg, dino_in.to(
            self.dino_params["patch_embed"]["w"].dtype))
        fs = vit.encode(self.siglip_params, self.siglip_cfg, sig_in.to(
            self.siglip_params["patch_embed"]["w"].dtype))
        fused = torch.cat([fd, fs.to(fd.dtype)], -1)   # channel concat
        return project(self.projector,
                       fused.to(self.projector["fc1"]["w"].dtype))

    @torch.inference_mode()
    def prepare_inputs(self, image01: torch.Tensor,
                       prompt_tokens: List[int]) -> torch.Tensor:
        """The image patches spliced before the prompt's embeddings:
        [1, N + len(prompt_tokens), D] in the embedding's type."""
        patches = self.encode_image(image01)
        emb_txt = embedding(self.lm_params["embed"], torch.tensor(
            [prompt_tokens], dtype=torch.long, device=self.device))
        return torch.cat([patches.to(emb_txt.dtype), emb_txt], 1)

    @torch.inference_mode()
    def prefill(self, image01: torch.Tensor, prompt_tokens: List[int],
                max_tokens: int):
        """``prepare_inputs`` run through the decoder at once (K2 on CUDA)
        into a cache of the prompt, ``max_tokens`` and 8 slots. Returns
        (last logits [1, V], cache)."""
        embeds = self.prepare_inputs(image01, prompt_tokens)
        T = embeds.shape[1]
        cache = base.init_cache(self.lm_cfg, 1, T + max_tokens + 8,
                                embeds.dtype, self.device)
        logits, cache = base.forward_embeds(self.lm_params, self.lm_cfg,
                                            embeds, cache,
                                            fresh_prefill=True)
        return logits[:, -1], cache

    def generate(self, image01: torch.Tensor, prompt_tokens: List[int],
                 max_tokens: int = 64, stop_tokens=()) -> List[int]:
        """Greedy tokens after the image and ``prompt_tokens``; a stop
        token ends the list before it is appended (the JAX package's
        rule)."""
        logits, cache = self.prefill(image01, prompt_tokens, max_tokens)
        return list(self.engine().decode(logits, cache, max_tokens,
                                         tuple(stop_tokens)))

    # ------------------------------------------------- server/CLI facade ----

    def chat(self, prompt: str, image01=None, max_tokens: int = 256) -> str:
        """Image chat (the server's content arrays and /v1/describe):
        Prismatic's "Pure" prompt "In: {}\\nOut:", the image patches
        spliced before it; an image of another size is resized to the
        towers' (``nn.layers.resize_bilinear``); no image is a black one."""
        text = f"In: {prompt}\nOut:"
        if self.tokenizer is not None:
            ids = self.tokenizer.encode(text)
            stops = tuple({self.tokenizer.eos_token_id} - {None})
        else:
            ids = [1] + [ord(c) % self.lm_cfg.vocab_size for c in text][:32]
            stops = ()
        size = self.dino_cfg.image_size
        if image01 is None:
            image = torch.zeros((1, size, size, 3), device=self.device)
        else:
            image = as_image(image01, self.device)
        if image.shape[1] != size or image.shape[2] != size:
            image = resize_bilinear(image, size, size)
        out = self.generate(image, ids, max_tokens=max_tokens,
                            stop_tokens=stops)
        return (self.tokenizer.decode(out) if self.tokenizer
                else " ".join(map(str, out)))


def tiny_configs():
    """The JAX package's ``init_tiny`` configurations (tests)."""
    dcfg = vit.ViTConfig(image_size=28, patch_size=14, hidden_size=32,
                         num_layers=1, num_heads=2, mlp_dim=48,
                         has_cls_token=True, num_registers=2, layer_scale=True)
    scfg = vit.ViTConfig(image_size=28, patch_size=14, hidden_size=24,
                         num_layers=1, num_heads=2, mlp_dim=32,
                         has_cls_token=False)
    lm_cfg = base.TransformerConfig(
        vocab_size=64, hidden_size=48, num_layers=1, num_heads=2,
        num_kv_heads=1, head_dim=24, intermediate_size=64,
        tie_word_embeddings=True)
    return dcfg, scfg, lm_cfg


def init_projector(generator: torch.Generator, dims, dtype=torch.float32,
                   device=None) -> dict:
    """Random fc1-fc3 projector over ``dims`` (in, hidden, hidden, out):
    uniform +-1/sqrt(in) weights, zero biases."""
    device = resolve_device(device)

    def lin(n_in, n_out):
        w = torch.rand((n_out, n_in), generator=generator,
                       device=device) * 2 - 1
        return {"w": (w * n_in ** -0.5).to(dtype),
                "b": torch.zeros(n_out, dtype=dtype, device=device)}

    return {f"fc{i + 1}": lin(dims[i], dims[i + 1]) for i in range(3)}


def init_tiny(generator: torch.Generator, device=None,
              tokenizer=None) -> MoxinVLM:
    """A random tiny assembly at the JAX ``init_tiny`` shapes (tests)."""
    device = resolve_device(device)
    dcfg, scfg, lm_cfg = tiny_configs()
    return MoxinVLM(
        dino_params=vit.init_params(dcfg, generator, device=device),
        dino_cfg=dcfg,
        siglip_params=vit.init_params(scfg, generator, device=device),
        siglip_cfg=scfg,
        projector=init_projector(generator, (56, 64, 64, 48),
                                 device=device),
        lm_params=base.init_params(lm_cfg, generator, torch.float32,
                                   device),
        lm_cfg=lm_cfg, tokenizer=tokenizer, device=device)


def from_numpy(dino: dict, siglip: dict, projector: dict, lm: dict,
               dino_cfg: vit.ViTConfig, siglip_cfg: vit.ViTConfig,
               lm_cfg: base.TransformerConfig, device,
               tokenizer=None) -> MoxinVLM:
    """A JAX MoxinVLM's trees as numpy -> the port's assembly on
    ``device`` (the towers' patch convolutions OHWI -> OIHW)."""
    return MoxinVLM(
        dino_params=vit.from_numpy(dino, device), dino_cfg=dino_cfg,
        siglip_params=vit.from_numpy(siglip, device), siglip_cfg=siglip_cfg,
        projector=params_from_numpy(projector, device),
        lm_params=params_from_numpy(lm, device), lm_cfg=lm_cfg,
        tokenizer=tokenizer, device=device)


def load_model(model_dir: str, device=None) -> MoxinVLM:
    """A converted Moxin-7B directory: HF-named tower tensors under
    ``dino.`` / ``siglip.`` (``vit.params_from_hf_dinov2`` / ``_siglip``),
    ``projector.fc1``-``fc3``, and the Mistral decoder under ``llm.``
    (``base.params_from_flat``; MLX-quantized where the config says so),
    with the directory's tokenizer where it has a tokenizer.json, on
    ``device`` (default: the current CUDA device). The towers are
    ``vit.DINOV2_LARGE`` and ``vit.SIGLIP_SO400M``, as in the JAX package,
    unless config.json names others (``dino_config``, ``siglip_config``:
    ``ViTConfig`` fields), which small test checkpoints use."""
    from ominix_mlx_tpu_torch.utils.loading import (load_config,
                                                    load_safetensors)

    device = resolve_device(device)
    raw = load_config(model_dir)
    flat = load_safetensors(model_dir)

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}

    dcfg = vit.ViTConfig(**raw["dino_config"]) if "dino_config" in raw \
        else vit.DINOV2_LARGE
    scfg = vit.ViTConfig(**raw["siglip_config"]) \
        if "siglip_config" in raw else vit.SIGLIP_SO400M
    lm_raw = raw.get("text_config", raw)
    lm_cfg = base.TransformerConfig.from_hf(lm_raw)
    proj_flat = sub("projector.")
    projector = {
        name: {"w": proj_flat[f"{name}.weight"].to(device),
               **({"b": proj_flat[f"{name}.bias"].to(device)}
                  if f"{name}.bias" in proj_flat else {})}
        for name in ("fc1", "fc2", "fc3")}
    tok = None
    if os.path.exists(os.path.join(model_dir, "tokenizer.json")):
        from ominix_mlx_tpu_torch.utils.tokenizer import Tokenizer
        tok = Tokenizer(model_dir)
    return MoxinVLM(
        dino_params=vit.params_from_hf_dinov2(sub("dino."), dcfg, device),
        dino_cfg=dcfg,
        siglip_params=vit.params_from_hf_siglip(sub("siglip."), scfg,
                                                device),
        siglip_cfg=scfg, projector=projector,
        lm_params=base.params_from_flat(sub("llm."), lm_cfg,
                                        lm_raw.get("quantization"), device),
        lm_cfg=lm_cfg, tokenizer=tok, device=device)
