"""SAM ViT-B image encoder, DeepSeek-OCR-2's vision tower (counterpart of
ominix_mlx_tpu/models/sam_vit.py): ViT-B/16 with windowed attention
(window 14, global attention at blocks 2/5/8/11), a decomposed relative
position bias, an absolute position embedding, the SAM neck (1x1 and 3x3
convolutions with 2-D layer norms) and the OCR adapter's two stride-2
convolutions. Activations are channels last, [B, H, W, C].

Kept from the JAX package: attention is computed in the input's type,
scores and softmax included (unlike the ViT's float32 scores); windows
are zero padded and the padding is not masked, so a grid that the window
does not divide lets its padded keys into the softmax; the MLP and the
adapter take the tanh GELU.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.nn.layers import (conv2d, conv_weight, gelu_tanh,
                                            layer_norm, linear,
                                            resize_bilinear)
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

CONVS = ("patch_embed", "neck0", "neck1", "net2", "net3")


@dataclasses.dataclass(frozen=True)
class SamViTConfig:
    """Defaults: SAM ViT-B/16."""
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    window_size: int = 14
    global_attn_indexes: tuple = (2, 5, 8, 11)
    out_chans: int = 256
    use_rel_pos: bool = True
    # the OCR adapter's output width (896 in DeepSeek-OCR-2); None keeps
    # out_chans * 4
    adapter_chans: int = None

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


def _get_rel_pos(q_size: int, k_size: int,
                 rel_pos: torch.Tensor) -> torch.Tensor:
    """Relative position embeddings for the (q, k) index deltas; rel_pos
    [2 * max - 1, C] is first resized linearly along its first axis where
    it holds another length. Returns [q, k, C]."""
    max_rel = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel:
        n = rel_pos.shape[0]
        t = torch.linspace(0.0, n - 1.0, max_rel, device=rel_pos.device)
        lo = torch.floor(t).long()
        hi = (lo + 1).clamp(0, n - 1)
        frac = (t - lo)[:, None]
        rel_pos = rel_pos[lo] * (1 - frac) + rel_pos[hi] * frac
    dev = rel_pos.device
    qi = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    ki = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = (qi - ki) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def _attention(p: dict, x: torch.Tensor, num_heads: int,
               use_rel_pos: bool) -> torch.Tensor:
    """Spatial attention over [B, H, W, C] with the decomposed rel-pos
    bias, in x's type."""
    B, H, W, C = x.shape
    hd = C // num_heads
    qkv = linear(p["qkv"], x).reshape(B, H * W, 3, num_heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    attn = torch.einsum("bhqd,bhkd->bhqk", q * hd ** -0.5, k)
    if use_rel_pos:
        rh = _get_rel_pos(H, H, p["rel_pos_h"]).to(q.dtype)   # [H, H, hd]
        rw = _get_rel_pos(W, W, p["rel_pos_w"]).to(q.dtype)
        qr = q.reshape(B, num_heads, H, W, hd)
        bias_h = torch.einsum("bnhwd,hkd->bnhwk", qr, rh)       # [.., H]
        bias_w = torch.einsum("bnhwd,wkd->bnhwk", qr, rw)       # [.., W]
        attn = (attn.reshape(B, num_heads, H, W, H, W)
                + bias_h[..., :, None] + bias_w[..., None, :]
                ).reshape(B, num_heads, H * W, H * W)
    attn = torch.softmax(attn, -1)
    out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
    out = out.transpose(1, 2).reshape(B, H, W, C)
    return linear(p["proj"], out)


def _window_partition(x: torch.Tensor, ws: int):
    """[B, H, W, C] -> ([B * nW, ws, ws, C], padded (Hp, Wp)), zero
    padded at the bottom and right."""
    B, H, W, C = x.shape
    ph, pw = (-H) % ws, (-W) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)
    return x, (Hp, Wp)


def _window_unpartition(wins: torch.Tensor, ws: int, pad_hw: Tuple[int, int],
                        hw: Tuple[int, int]) -> torch.Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    C = wins.shape[-1]
    B = wins.shape[0] // (Hp * Wp // ws // ws)
    x = wins.reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W]


def _block(p: dict, cfg: SamViTConfig, x: torch.Tensor,
           window: bool) -> torch.Tensor:
    h = layer_norm(p["norm1"], x)
    if window:
        hw = h.shape[1:3]
        h, pad_hw = _window_partition(h, cfg.window_size)
    h = _attention(p["attn"], h, cfg.num_heads, cfg.use_rel_pos)
    if window:
        h = _window_unpartition(h, cfg.window_size, pad_hw, hw)
    x = x + h
    h = layer_norm(p["norm2"], x)
    h = linear(p["mlp_fc2"], gelu_tanh(linear(p["mlp_fc1"], h)))
    return x + h


def _ln2d(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Channel-wise 2-D layer norm over the last axis (SAM's LayerNorm2d),
    in x's type."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * p["w"] + p["b"]


def encode(params: dict, cfg: SamViTConfig,
           images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (normalized) -> features [B, h, w, C] after the
    neck and, where the tree holds it, the OCR adapter."""
    x = conv2d(params["patch_embed"], images, stride=cfg.patch_size)
    if "pos_embed" in params:
        pe = params["pos_embed"]
        if pe.shape[1:3] != x.shape[1:3]:
            pe = resize_bilinear(pe, x.shape[1], x.shape[2])
        x = x + pe
    for i, bp in enumerate(params["blocks"]):
        x = _block(bp, cfg, x, window=i not in cfg.global_attn_indexes)
    x = conv2d(params["neck0"], x)
    x = _ln2d(params["neck_ln0"], x)
    x = conv2d(params["neck1"], x, padding=1)
    x = _ln2d(params["neck_ln1"], x)
    if "net2" in params:
        x = conv2d(params["net2"], x, stride=2, padding=1)
        x = gelu_tanh(x)
        x = conv2d(params["net3"], x, stride=2, padding=1)
    return x


def init_params(cfg: SamViTConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Random tower (tests and the smoke), the JAX ``init_params``'s
    ranges: uniform +-1/sqrt(fan in) convolutions and projections, zero
    biases, zero positions and rel-pos tables, N(0, 0.02) neck weights,
    unit norms. ``device`` defaults to the current CUDA device."""
    device = resolve_device(device)
    D = cfg.embed_dim
    hd = D // cfg.num_heads
    g = cfg.grid
    mlp = int(D * cfg.mlp_ratio)

    def uniform(shape, lim):
        w = torch.rand(shape, generator=generator, device=device) * 2 - 1
        return (w * lim).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def c2(cin, cout, k):
        return {"w": uniform((cout, cin, k, k), (cin * k * k) ** -0.5),
                "b": zeros(cout)}

    def lin(n_in, n_out):
        return {"w": uniform((n_out, n_in), n_in ** -0.5), "b": zeros(n_out)}

    def nrm(d):
        return {"w": torch.ones(d, dtype=dtype, device=device),
                "b": zeros(d)}

    def normal(shape):
        return (torch.randn(shape, generator=generator, device=device)
                * 0.02).to(dtype)

    blocks = []
    for i in range(cfg.depth):
        ws = g if i in cfg.global_attn_indexes else cfg.window_size
        blocks.append({
            "norm1": nrm(D), "norm2": nrm(D),
            "attn": {"qkv": lin(D, 3 * D), "proj": lin(D, D),
                     "rel_pos_h": zeros(2 * ws - 1, hd),
                     "rel_pos_w": zeros(2 * ws - 1, hd)},
            "mlp_fc1": lin(D, mlp), "mlp_fc2": lin(mlp, D),
        })
    C = cfg.out_chans
    return {
        "patch_embed": c2(3, D, cfg.patch_size),
        "pos_embed": zeros(1, g, g, D),
        "blocks": blocks,
        "neck0": {"w": normal((C, D, 1, 1))},
        "neck_ln0": nrm(C),
        "neck1": {"w": normal((C, C, 3, 3))},
        "neck_ln1": nrm(C),
        "net2": c2(C, C * 2, 3),
        "net3": c2(C * 2, cfg.adapter_chans or C * 4, 3),
    }


def from_numpy(tree: dict, device, dtype=None) -> dict:
    """A JAX SAM tree as numpy (convolutions OHWI) -> the port's (OIHW),
    on ``device``."""
    out = params_from_numpy(tree, device, dtype)
    for name in CONVS:
        if name in out:
            out[name] = {**out[name], "w": conv_weight(out[name]["w"])}
    return out


def params_from_flat(flat: dict, cfg: SamViTConfig,
                     prefix: str = "vision_model", device=None) -> dict:
    """A torch checkpoint's SAM names (patch_embed.proj, blocks.N.attn.
    qkv / proj and rel_pos_h / w, mlp.lin1 / lin2, neck.0-3, net_2 /
    net_3) -> the port's tree; convolutions stay OIHW, as ``conv2d``
    takes them. Tensors move to ``device`` where one is named."""
    def t(name):
        v = torch.as_tensor(flat[name])
        return v if device is None else v.to(device)

    def lin(name):
        p = {"w": t(f"{name}.weight")}
        if f"{name}.bias" in flat:
            p["b"] = t(f"{name}.bias")
        return p

    def nrm(name):
        return {"w": t(f"{name}.weight"), "b": t(f"{name}.bias")}

    out = {
        "patch_embed": {"w": t(f"{prefix}.patch_embed.proj.weight"),
                        "b": t(f"{prefix}.patch_embed.proj.bias")},
        "pos_embed": t(f"{prefix}.pos_embed"),
        "blocks": [{
            "norm1": nrm(f"{prefix}.blocks.{i}.norm1"),
            "norm2": nrm(f"{prefix}.blocks.{i}.norm2"),
            "attn": {
                "qkv": lin(f"{prefix}.blocks.{i}.attn.qkv"),
                "proj": lin(f"{prefix}.blocks.{i}.attn.proj"),
                "rel_pos_h": t(f"{prefix}.blocks.{i}.attn.rel_pos_h"),
                "rel_pos_w": t(f"{prefix}.blocks.{i}.attn.rel_pos_w"),
            },
            "mlp_fc1": lin(f"{prefix}.blocks.{i}.mlp.lin1"),
            "mlp_fc2": lin(f"{prefix}.blocks.{i}.mlp.lin2"),
        } for i in range(cfg.depth)],
        "neck0": {"w": t(f"{prefix}.neck.0.weight")},
        "neck_ln0": nrm(f"{prefix}.neck.1"),
        "neck1": {"w": t(f"{prefix}.neck.2.weight")},
        "neck_ln1": nrm(f"{prefix}.neck.3"),
    }
    if f"{prefix}.net_2.weight" in flat:
        out["net2"] = {"w": t(f"{prefix}.net_2.weight"),
                       "b": t(f"{prefix}.net_2.bias")}
        out["net3"] = {"w": t(f"{prefix}.net_3.weight"),
                       "b": t(f"{prefix}.net_3.bias")}
    return out
