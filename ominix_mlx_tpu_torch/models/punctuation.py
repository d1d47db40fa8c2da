"""CT-Transformer punctuation restoration (counterpart of
ominix_mlx_tpu/models/punctuation.py): an embedding, a stack of
Paraformer's SAN-M encoder layers (``models.paraformer.encoder_layer``)
and a 6-class token classifier. The text utilities are copied:
``segment_text`` (CJK characters one token each, ASCII words grouped),
the classes ("<unk>", "", "，", "。", "？", "、") and the rule that the
output ends with sentence punctuation.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import torch

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.models import paraformer as pf
from ominix_mlx_tpu_torch.nn.layers import layer_norm, linear

PUNC_SYMBOLS = ("<unk>", "", "，", "。", "？", "、")
_SENTENCE_END = ("。", "？", "！", ".", "?", "!")


@dataclasses.dataclass(frozen=True)
class PunctuationConfig:
    vocab_size: int = 272727
    hidden: int = 256
    layers: int = 6
    heads: int = 8
    ffn: int = 1024
    sanm_kernel: int = 11
    num_classes: int = 6


# ----------------------------------------------------------- text utils ----

def _is_cjk(ch: str) -> bool:
    o = ord(ch)
    return (0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF
            or 0xF900 <= o <= 0xFAFF)


def segment_text(text: str) -> List[str]:
    """CJK characters as single tokens, ASCII words grouped."""
    out: List[str] = []
    word = ""
    for ch in text:
        if _is_cjk(ch):
            if word:
                out.append(word)
                word = ""
            out.append(ch)
        elif ch.isspace():
            if word:
                out.append(word)
                word = ""
        else:
            word += ch
    if word:
        out.append(word)
    return out


def _is_ascii_word(s: str) -> bool:
    return bool(s) and all(ord(c) < 128 for c in s)


def ensure_sentence_ending(text: str) -> str:
    """Append 。 (CJK tail) or . (ASCII tail) when missing."""
    t = text.rstrip()
    if not t or t.endswith(_SENTENCE_END):
        return t
    if t.endswith(("，", "、")):
        t = t[:-1]
    return t + ("。" if _is_cjk(t[-1]) else ".")


# -------------------------------------------------------------- model ------

def forward(params: dict, cfg: PunctuationConfig,
            token_ids: torch.Tensor) -> torch.Tensor:
    """[B, T] int -> [B, T, num_classes] logits."""
    x = params["embed"][token_ids] * (cfg.hidden ** 0.5)
    T = token_ids.shape[1]
    x = x + torch.from_numpy(pf.sinusoid_pe(T, cfg.hidden)).to(
        device=x.device, dtype=x.dtype)[None]
    for lp in params["layers"]:
        x = pf.encoder_layer(lp, x, cfg.heads, residual_attn=True)
    x = layer_norm(params["after_norm"], x)
    return linear(params["classifier"], x)


def init_params(cfg: PunctuationConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Random tree (tests): uniform +-1/sqrt(in) linears, zero biases, unit
    norms, N(0, 0.05) FSMN taps, N(0, 0.02) embedding."""
    device = resolve_device(device)

    def lin(n_in, n_out):
        w = torch.rand((n_out, n_in), generator=generator,
                       device=device) * 2 - 1
        return {"w": (w * n_in ** -0.5).to(dtype),
                "b": torch.zeros(n_out, dtype=dtype, device=device)}

    def norm_p(d):
        return {"w": torch.ones(d, dtype=dtype, device=device),
                "b": torch.zeros(d, dtype=dtype, device=device)}

    d = cfg.hidden
    layers = [{
        "norm1": norm_p(d), "norm2": norm_p(d),
        "self_attn": {
            "linear_q_k_v": lin(d, 3 * d), "out_proj": lin(d, d),
            "fsmn_block": {"w": (torch.randn(
                (d, cfg.sanm_kernel, 1), generator=generator,
                device=device) * 0.05).to(dtype)},
        },
        "ffn_up": lin(d, cfg.ffn), "ffn_down": lin(cfg.ffn, d),
    } for _ in range(cfg.layers)]
    return {
        "embed": (torch.randn((cfg.vocab_size, d), generator=generator,
                              device=device) * 0.02).to(dtype),
        "layers": layers,
        "after_norm": norm_p(d),
        "classifier": lin(d, cfg.num_classes),
    }


class PunctuationModel:
    """punctuate(text) facade."""

    def __init__(self, params: dict, cfg: PunctuationConfig,
                 vocab: Optional[Dict[str, int]] = None, unk_id: int = 0):
        self.params = params
        self.cfg = cfg
        self.vocab = vocab or {}
        self.unk_id = unk_id

    @staticmethod
    def load(model_dir: str, device=None) -> "PunctuationModel":
        """A FunASR punctuation directory: tokens.json and safetensors
        weights in FunASR's CT-Transformer names, on ``device`` (default:
        the current CUDA device)."""
        from ominix_mlx_tpu_torch.utils.loading import load_safetensors

        device = resolve_device(device)
        with open(os.path.join(model_dir, "tokens.json"),
                  encoding="utf-8") as f:
            toks = json.load(f)
        vocab = ({t: i for i, t in enumerate(toks)}
                 if isinstance(toks, list) else toks)
        cfg = PunctuationConfig(vocab_size=len(vocab))
        params = params_from_flat(load_safetensors(model_dir, device=device),
                                  cfg)
        return PunctuationModel(params, cfg, vocab,
                                unk_id=vocab.get("<unk>", 0))

    @torch.inference_mode()
    def punctuate(self, text: str) -> str:
        if not text:
            return ""
        tokens = segment_text(text)
        if not tokens:
            return text
        dev = self.params["embed"].device
        ids = torch.tensor([[self.vocab.get(t, self.unk_id)
                             for t in tokens]], dtype=torch.long, device=dev)
        logits = forward(self.params, self.cfg, ids)
        classes = logits[0].argmax(-1).tolist()
        out = []
        for i, tok in enumerate(tokens):
            if i and _is_ascii_word(tok) and _is_ascii_word(tokens[i - 1]):
                out.append(" ")
            out.append(tok)
            c = classes[i]
            if 2 <= c < len(PUNC_SYMBOLS):
                out.append(PUNC_SYMBOLS[c])
        return ensure_sentence_ending("".join(out))


def params_from_flat(flat: dict, cfg: PunctuationConfig) -> dict:
    """FunASR CT-Transformer tensor names (punc.pt layout) -> the tree (the
    FSMN taps from torch's [C, 1, K] to [C, K, 1])."""
    def lin(pre):
        p = {"w": flat[f"{pre}.weight"]}
        if f"{pre}.bias" in flat:
            p["b"] = flat[f"{pre}.bias"]
        return p

    def norm(pre):
        return {"w": flat[f"{pre}.weight"], "b": flat[f"{pre}.bias"]}

    layers = []
    i = 0
    while f"encoder.encoders.{i}.self_attn.linear_q_k_v.weight" in flat:
        pre = f"encoder.encoders.{i}"
        layers.append({
            "norm1": norm(f"{pre}.norm1"),
            "norm2": norm(f"{pre}.norm2"),
            "self_attn": {
                "linear_q_k_v": lin(f"{pre}.self_attn.linear_q_k_v"),
                "out_proj": lin(f"{pre}.self_attn.linear_out"),
                "fsmn_block": {"w": flat[
                    f"{pre}.self_attn.fsmn_block.weight"].permute(0, 2, 1)},
            },
            "ffn_up": lin(f"{pre}.feed_forward.w_1"),
            "ffn_down": lin(f"{pre}.feed_forward.w_2"),
        })
        i += 1
    return {
        "embed": flat["embed.0.weight"],
        "layers": layers,
        "after_norm": norm("encoder.after_norm"),
        "classifier": lin("decoder"),
    }
