"""Generic ViT encoder for the VLM vision towers (counterpart of
ominix_mlx_tpu/models/vit.py): one parametric ViT with config switches
for DINOv2 ViT-L/14 (CLS + 4 register tokens, LayerScale, exact GELU)
and SigLIP SO400M/14 (no CLS, no registers, tanh GELU). The patch
embedding is a stride-P convolution over channels-last images, the blocks
are pre-norm, and ``encode`` returns the patch tokens (CLS and registers
stripped) for the projector.

Two quirks of the JAX package are kept: attention takes float32 scores
and softmax, then casts the probabilities to v's type; and ``encode``
adds ``pos_embed`` as it is, without interpolation, so an image whose
patch grid does not match it raises.

The ``init_params`` function allocates on the current CUDA device unless
the caller names one (``device="cpu"`` for the CPU).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.nn.layers import (ACTIVATIONS, conv2d,
                                            conv_weight, gelu_exact,
                                            layer_norm, linear)
from ominix_mlx_tpu_torch.utils.params import params_from_numpy


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    has_cls_token: bool = True
    num_registers: int = 0
    layer_scale: bool = False
    eps: float = 1e-6
    hidden_act: str = "gelu"        # dinov2: exact gelu; siglip: tanh-gelu

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2


DINOV2_LARGE = ViTConfig(has_cls_token=True, num_registers=4,
                         layer_scale=True)
SIGLIP_SO400M = ViTConfig(hidden_size=1152, num_layers=27, num_heads=16,
                          mlp_dim=4304, has_cls_token=False, num_registers=0,
                          hidden_act="gelu_pytorch_tanh")


def _act(cfg: ViTConfig):
    # the JAX block takes "gelu" as the exact form (vit.py:66-67), unlike
    # its ACTIVATIONS table, whose "gelu" is the tanh form
    return gelu_exact if cfg.hidden_act == "gelu" \
        else ACTIVATIONS[cfg.hidden_act]


def vit_block(p: dict, cfg: ViTConfig, x: torch.Tensor) -> torch.Tensor:
    B, T, D = x.shape
    H = cfg.num_heads
    hd = D // H
    h = layer_norm(p["norm1"], x, cfg.eps)
    q = linear(p["q"], h).reshape(B, T, H, hd)
    k = linear(p["k"], h).reshape(B, T, H, hd)
    v = linear(p["v"], h).reshape(B, T, H, hd)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) \
        / math.sqrt(hd)
    attn = torch.softmax(scores, -1).to(v.dtype)
    o = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, T, D)
    o = linear(p["proj"], o)
    if "ls1" in p:
        o = o * p["ls1"]
    x = x + o
    h = layer_norm(p["norm2"], x, cfg.eps)
    h = linear(p["fc2"], _act(cfg)(linear(p["fc1"], h)))
    if "ls2" in p:
        h = h * p["ls2"]
    return x + h


def encode(params: dict, cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """images: [B, H, W, 3] (normalized) -> patch tokens [B, N, D]."""
    x = conv2d(params["patch_embed"], images, stride=cfg.patch_size)
    B, gh, gw, D = x.shape
    x = x.reshape(B, gh * gw, D)
    pos = params["pos_embed"]
    prefix = []
    if cfg.has_cls_token:
        prefix.append(params["cls_token"].expand(B, 1, D).to(x.dtype))
    if pos.shape[1] == x.shape[1]:
        x = x + pos                           # pos before CLS (SigLIP)
    elif pos.shape[1] == x.shape[1] + len(prefix):
        x = torch.cat(prefix + [x], 1) + pos
        prefix = []
    else:
        raise ValueError(
            f"pos_embed holds {pos.shape[1]} positions for {gh}x{gw} = "
            f"{gh * gw} patches{' + CLS' if prefix else ''}: the encoder "
            f"adds it without interpolation (as the JAX package does), so "
            f"the image must be {cfg.image_size} px")
    if prefix:
        x = torch.cat(prefix + [x], 1)
    if cfg.num_registers:
        regs = params["register_tokens"].expand(
            B, cfg.num_registers, D).to(x.dtype)
        x = torch.cat([x[:, :1], regs, x[:, 1:]] if cfg.has_cls_token
                      else [regs, x], 1)
    for p in params["blocks"]:
        x = vit_block(p, cfg, x)
    x = layer_norm(params["norm"], x, cfg.eps)
    skip = (1 if cfg.has_cls_token else 0) + cfg.num_registers
    return x[:, skip:]


def init_params(cfg: ViTConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Random tower (tests and the smoke): uniform +-1/sqrt(in)
    projections, zero biases, unit norms, LayerScale 1e-5, N(0, 0.02)
    patch embedding and positions, zero CLS and registers (the JAX
    package's ``init_params``). ``device`` defaults to the current CUDA
    device; the generator must live on the same device."""
    device = resolve_device(device)
    D = cfg.hidden_size

    def lin(n_in, n_out):
        lim = n_in ** -0.5
        w = torch.rand((n_out, n_in), generator=generator,
                       device=device) * 2 - 1
        return {"w": (w * lim).to(dtype),
                "b": torch.zeros(n_out, dtype=dtype, device=device)}

    def nrm():
        return {"w": torch.ones(D, dtype=dtype, device=device),
                "b": torch.zeros(D, dtype=dtype, device=device)}

    def normal(shape):
        return (torch.randn(shape, generator=generator, device=device)
                * 0.02).to(dtype)

    def blk():
        p = {"norm1": nrm(), "norm2": nrm(), "q": lin(D, D), "k": lin(D, D),
             "v": lin(D, D), "proj": lin(D, D), "fc1": lin(D, cfg.mlp_dim),
             "fc2": lin(cfg.mlp_dim, D)}
        if cfg.layer_scale:
            p["ls1"] = torch.full((D,), 1e-5, dtype=dtype, device=device)
            p["ls2"] = torch.full((D,), 1e-5, dtype=dtype, device=device)
        return p

    P = cfg.patch_size
    npos = cfg.num_patches + (1 if cfg.has_cls_token else 0)
    params = {
        "patch_embed": {"w": normal((D, 3, P, P)),
                        "b": torch.zeros(D, dtype=dtype, device=device)},
        "pos_embed": normal((1, npos, D)),
        "blocks": [blk() for _ in range(cfg.num_layers)],
        "norm": nrm(),
    }
    if cfg.has_cls_token:
        params["cls_token"] = torch.zeros((1, 1, D), dtype=dtype,
                                          device=device)
    if cfg.num_registers:
        params["register_tokens"] = torch.zeros(
            (1, cfg.num_registers, D), dtype=dtype, device=device)
    return params


def from_numpy(tree: dict, device, dtype=None) -> dict:
    """A JAX ViT tree as numpy (its patch embedding OHWI) -> the port's
    (``conv2d``'s OIHW), on ``device``."""
    out = params_from_numpy(tree, device, dtype)
    out["patch_embed"] = {**out["patch_embed"],
                          "w": conv_weight(out["patch_embed"]["w"])}
    return out


# ------------------------------------------------------ HF weight maps ------

def _t(sd, name, device):
    t = torch.as_tensor(sd[name])
    return t if device is None else t.to(device)


def _lin(sd, name, device):
    p = {"w": _t(sd, f"{name}.weight", device)}
    if f"{name}.bias" in sd:
        p["b"] = _t(sd, f"{name}.bias", device)
    return p


def _nrm(sd, name, device):
    return {"w": _t(sd, f"{name}.weight", device),
            "b": _t(sd, f"{name}.bias", device)}


def params_from_hf_dinov2(sd: dict, cfg: ViTConfig, device=None) -> dict:
    """HF Dinov2Model / Dinov2WithRegistersModel state_dict (tensors or
    numpy arrays) -> the port's tree; the patch convolution stays in HF's
    OIHW layout, which ``conv2d`` takes. Tensors move to ``device`` where
    one is named."""
    out = {
        "patch_embed": {
            "w": _t(sd, "embeddings.patch_embeddings.projection.weight",
                    device),
            "b": _t(sd, "embeddings.patch_embeddings.projection.bias",
                    device)},
        "cls_token": _t(sd, "embeddings.cls_token", device),
        "pos_embed": _t(sd, "embeddings.position_embeddings", device),
        "norm": _nrm(sd, "layernorm", device),
        "blocks": [],
    }
    if "embeddings.register_tokens" in sd:
        out["register_tokens"] = _t(sd, "embeddings.register_tokens", device)
    for i in range(cfg.num_layers):
        b = f"encoder.layer.{i}"
        blk = {
            "norm1": _nrm(sd, f"{b}.norm1", device),
            "norm2": _nrm(sd, f"{b}.norm2", device),
            "q": _lin(sd, f"{b}.attention.attention.query", device),
            "k": _lin(sd, f"{b}.attention.attention.key", device),
            "v": _lin(sd, f"{b}.attention.attention.value", device),
            "proj": _lin(sd, f"{b}.attention.output.dense", device),
            "fc1": _lin(sd, f"{b}.mlp.fc1", device),
            "fc2": _lin(sd, f"{b}.mlp.fc2", device),
        }
        if f"{b}.layer_scale1.lambda1" in sd:
            blk["ls1"] = _t(sd, f"{b}.layer_scale1.lambda1", device)
            blk["ls2"] = _t(sd, f"{b}.layer_scale2.lambda1", device)
        out["blocks"].append(blk)
    return out


def params_from_hf_siglip(sd: dict, cfg: ViTConfig, device=None) -> dict:
    """HF SiglipVisionModel state_dict -> the port's tree (names may carry
    a ``vision_model.`` prefix)."""
    if any(k.startswith("vision_model.") for k in sd):
        sd = {k[len("vision_model."):]: v for k, v in sd.items()
              if k.startswith("vision_model.")}
    out = {
        "patch_embed": {
            "w": _t(sd, "embeddings.patch_embedding.weight", device),
            "b": _t(sd, "embeddings.patch_embedding.bias", device)},
        "pos_embed": _t(sd, "embeddings.position_embedding.weight",
                        device)[None],
        "norm": _nrm(sd, "post_layernorm", device),
        "blocks": [],
    }
    for i in range(cfg.num_layers):
        b = f"encoder.layers.{i}"
        out["blocks"].append({
            "norm1": _nrm(sd, f"{b}.layer_norm1", device),
            "norm2": _nrm(sd, f"{b}.layer_norm2", device),
            "q": _lin(sd, f"{b}.self_attn.q_proj", device),
            "k": _lin(sd, f"{b}.self_attn.k_proj", device),
            "v": _lin(sd, f"{b}.self_attn.v_proj", device),
            "proj": _lin(sd, f"{b}.self_attn.out_proj", device),
            "fc1": _lin(sd, f"{b}.mlp.fc1", device),
            "fc2": _lin(sd, f"{b}.mlp.fc2", device),
        })
    return out
