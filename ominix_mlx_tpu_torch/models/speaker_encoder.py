"""ECAPA-TDNN speaker (x-vector) encoder for Qwen3-TTS voice cloning
(counterpart of ominix_mlx_tpu/models/speaker_encoder.py): a TDNN, three
SE-Res2Net blocks (scale 8), their outputs concatenated (MFA), attentive
statistics pooling and a final projection to the talker's width, so the
x-vector joins the prefill as its speaker slot.

Every convolution runs channels last [B, T, C] through ``nn.layers.
conv1d`` (float32 without TF32 on the card); the Res2Net hierarchy is a
loop over channel groups. Plain PyTorch: the JAX package leaves it to
XLA.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn.functional as F

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.nn.layers import conv1d


@dataclasses.dataclass(frozen=True)
class SpeakerEncoderConfig:
    """Defaults: the JAX package's (enc_dim picks the 0.6B / 1.7B
    talker)."""
    mel_dim: int = 128
    enc_dim: int = 2048
    enc_channels: tuple = (512, 512, 512, 512, 1536)
    enc_kernel_sizes: tuple = (5, 3, 3, 3, 1)
    enc_dilations: tuple = (1, 2, 3, 4, 1)
    enc_attention_channels: int = 128
    enc_res2net_scale: int = 8
    enc_se_channels: int = 128


def _tdnn(p: dict, x: torch.Tensor, k: int, d: int) -> torch.Tensor:
    return F.relu(conv1d(p, x, padding=(k - 1) * d // 2, dilation=d))


def _res2net(p: dict, x: torch.Tensor, k: int, d: int,
             scale: int) -> torch.Tensor:
    """Hierarchical multi-scale convolutions over channel groups."""
    chunks = torch.chunk(x, scale, dim=-1)
    outs = [chunks[0]]
    y = None
    for i in range(1, scale):
        xi = chunks[i] if y is None else chunks[i] + y
        y = _tdnn(p["blocks"][i - 1], xi, k, d)
        outs.append(y)
    return torch.cat(outs, -1)


def _se(p: dict, x: torch.Tensor) -> torch.Tensor:
    s = x.mean(1, keepdim=True)
    s = F.relu(conv1d(p["conv1"], s))
    s = torch.sigmoid(conv1d(p["conv2"], s))
    return x * s


def _se_res2net(p: dict, cfg: SpeakerEncoderConfig, x: torch.Tensor, k: int,
                d: int) -> torch.Tensor:
    res = x
    y = _tdnn(p["tdnn1"], x, 1, 1)
    y = _res2net(p["res2net"], y, k, d, cfg.enc_res2net_scale)
    y = _tdnn(p["tdnn2"], y, 1, 1)
    y = _se(p["se"], y)
    return y + res


def _attentive_stats(p: dict, x: torch.Tensor,
                     eps: float = 1e-12) -> torch.Tensor:
    """[B, T, C] -> [B, 2C]: the attention-weighted mean and deviation
    (the context [x, mean, std] through a TDNN, tanh, a conv, softmax
    over T)."""
    mean = x.mean(1, keepdim=True)
    std = torch.sqrt(((x - mean) ** 2).mean(1, keepdim=True) + eps)
    ctx = torch.cat([x, mean.expand_as(x), std.expand_as(x)], -1)
    a = torch.tanh(_tdnn(p["tdnn"], ctx, 1, 1))
    a = torch.softmax(conv1d(p["conv"], a), 1)            # [B, T, C]
    mu = (a * x).sum(1)
    sg = torch.sqrt(torch.clamp((a * x * x).sum(1) - mu ** 2, min=eps))
    return torch.cat([mu, sg], -1)


def speaker_encoder(params: dict, cfg: SpeakerEncoderConfig,
                    mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, mel_dim] -> x-vector [B, enc_dim] (the talker's width)."""
    ks, ds = cfg.enc_kernel_sizes, cfg.enc_dilations
    x = _tdnn(params["tdnn0"], mel, ks[0], ds[0])
    feats: List[torch.Tensor] = []
    for i in range(1, 4):
        x = _se_res2net(params["blocks"][i - 1], cfg, x, ks[i], ds[i])
        feats.append(x)
    x = _tdnn(params["mfa"], torch.cat(feats, -1), ks[4], ds[4])
    x = _attentive_stats(params["asp"], x)                # [B, 2 C]
    return conv1d(params["fc"], x[:, None, :])[:, 0]      # [B, enc_dim]


def init_params(cfg: SpeakerEncoderConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Random encoder (tests and the smoke): conv weights [C_out, K, C_in]
    uniform +-1/sqrt(C_in K), zero biases. ``device`` defaults to the
    current CUDA device; the generator must live there."""
    device = resolve_device(device)

    def conv_p(cin, cout, k):
        s = (cin * k) ** -0.5
        w = torch.rand((cout, k, cin), generator=generator, device=device)
        return {"w": ((w * 2 - 1) * s).to(dtype),
                "b": torch.zeros(cout, dtype=dtype, device=device)}

    ch, kz = cfg.enc_channels, cfg.enc_kernel_sizes
    sc = cfg.enc_res2net_scale

    def se_res2net_p(c, k):
        return {
            "tdnn1": conv_p(c, c, 1),
            "res2net": {"blocks": [conv_p(c // sc, c // sc, k)
                                   for _ in range(sc - 1)]},
            "tdnn2": conv_p(c, c, 1),
            "se": {"conv1": conv_p(c, cfg.enc_se_channels, 1),
                   "conv2": conv_p(cfg.enc_se_channels, c, 1)},
        }

    return {
        "tdnn0": conv_p(cfg.mel_dim, ch[0], kz[0]),
        "blocks": [se_res2net_p(ch[i], kz[i]) for i in range(1, 4)],
        "mfa": conv_p(ch[0] * 3, ch[4], kz[4]),
        "asp": {"tdnn": conv_p(3 * ch[4], cfg.enc_attention_channels, 1),
                "conv": conv_p(cfg.enc_attention_channels, ch[4], 1)},
        "fc": conv_p(2 * ch[4], cfg.enc_dim, 1),
    }


def params_from_flat(flat: dict, cfg: SpeakerEncoderConfig,
                     prefix: str = "speaker_encoder") -> dict:
    """From PyTorch-layout weights (Conv1d [out, in, k] -> [out, k, in])."""
    def conv(name):
        p = {"w": flat[f"{prefix}.{name}.weight"].permute(0, 2, 1)
             .contiguous()}
        if f"{prefix}.{name}.bias" in flat:
            p["b"] = flat[f"{prefix}.{name}.bias"]
        return p

    sc = cfg.enc_res2net_scale
    return {
        "tdnn0": conv("blocks.0.conv"),
        "blocks": [{
            "tdnn1": conv(f"blocks.{i}.tdnn1.conv"),
            "res2net": {"blocks": [
                conv(f"blocks.{i}.res2net_block.blocks.{j}.conv")
                for j in range(sc - 1)]},
            "tdnn2": conv(f"blocks.{i}.tdnn2.conv"),
            "se": {"conv1": conv(f"blocks.{i}.se_block.conv1"),
                   "conv2": conv(f"blocks.{i}.se_block.conv2")},
        } for i in (1, 2, 3)],
        "mfa": conv("mfa.conv"),
        "asp": {"tdnn": conv("asp.tdnn.conv"), "conv": conv("asp.conv")},
        "fc": conv("fc"),
    }
