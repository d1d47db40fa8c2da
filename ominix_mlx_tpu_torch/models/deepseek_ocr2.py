"""DeepSeek-OCR-2: SAM ViT-B -> Qwen2 visual-causal-flow compressor ->
projector -> MoE decoder with image-token splicing (counterpart of
ominix_mlx_tpu/models/deepseek_ocr2.py).

  - the SAM encoder (``models.sam_vit``; a ``models.vit`` tower is still
    accepted for small tests);
  - the visual flow: a 24-layer Qwen2 decoder run as an encoder over the
    SAM features and a bank of learnt query tokens, image tokens
    bidirectional among themselves and queries causal (an additive mask
    through ``base.decoder_layer``: the masked ``sdpa`` branch, never
    kernel K2, which is causal only);
  - a single-linear projector 896 -> 1280;
  - the DeepSeek-V2-style MoE decoder (``models.base`` with a first dense
    layer, softmax top-6 of 64 routed experts and 2 shared ones): the
    spliced prompt runs ``forward_embeds`` with ``fresh_prefill=True`` (K2,
    and K5 on the packed experts, on CUDA), decoding replays the engine's
    captured step (K4 on the packed experts);
  - the prompt "<|User|>: ... <|Assistant|>:" with IMAGE_TOKEN_ID slots
    overwritten by the image embeddings (``prepare_inputs``);
  - PDF pages through ``utils.pdf``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from ominix_mlx_tpu_torch.core.cache import KVCache
from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.core.generate import Engine
from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
from ominix_mlx_tpu_torch.models import base, sam_vit, vit
from ominix_mlx_tpu_torch.models.base import TransformerConfig
from ominix_mlx_tpu_torch.models.moe import MoEConfig
from ominix_mlx_tpu_torch.models.moxin_vlm import as_image
from ominix_mlx_tpu_torch.nn.layers import (embedding, gelu_tanh, linear,
                                            resize_bilinear, rms_norm)
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

IMAGE_TOKEN_ID = 128815
BOS_TOKEN_ID = 0
EOS_TOKEN_ID = 1


# ------------------------------------------------- visual causal flow -------

def visual_flow_config(hidden: int = 896, layers: int = 24) -> TransformerConfig:
    """The 24-layer Qwen2 compressor: 896 wide, 14 query / 2 KV heads,
    FFN 4864, theta 1e6 (narrower widths for tests)."""
    return TransformerConfig(
        vocab_size=1, hidden_size=hidden, num_layers=layers,
        num_heads=14 if hidden == 896 else max(2, hidden // 64),
        num_kv_heads=2, intermediate_size=4864 if hidden == 896 else 2 * hidden,
        head_dim=64 if hidden == 896 else None,
        rope_theta=1_000_000.0, rms_norm_eps=1e-6, tie_word_embeddings=True)


def visual_flow_mask(n_image: int, n_query: int, device=None) -> torch.Tensor:
    """[T, T] additive float32 mask: image tokens see every image token,
    query tokens every image token and the queries up to their own."""
    T = n_image + n_query
    m = torch.full((T, T), -1e9, dtype=torch.float32, device=device)
    m[:, :n_image] = 0.0
    m[n_image:, n_image:] = torch.triu(
        torch.full((n_query, n_query), -1e9, dtype=torch.float32,
                   device=device), 1)
    return m


def visual_flow_encode(params: dict, cfg: TransformerConfig,
                       feats: torch.Tensor) -> torch.Tensor:
    """SAM features [B, h, w, C] or [B, N, C] -> query features
    [B, n_query, C]. The query bank is picked by the grid: 144 tokens or
    fewer (768 px) take ``query_768``, more ``query_1024``. Each layer
    runs over a fresh cache of the sequence, through the masked ``sdpa``
    (``fresh_prefill`` is not set, so K2 is never reached)."""
    if feats.ndim == 4:
        feats = feats.reshape(feats.shape[0], -1, feats.shape[-1])
    B, n_image, C = feats.shape
    qname = "query_768" if n_image <= 144 else "query_1024"
    q = params[qname].to(feats.dtype)
    n_query = q.shape[0]
    x = torch.cat([feats, q[None].expand(B, n_query, C)], 1)
    T = n_image + n_query
    mask = visual_flow_mask(n_image, n_query, feats.device)
    rope = cfg.rope()
    for lp in params["layers"]:
        lc = KVCache.init(B, cfg.num_kv_heads, T, cfg.hd, x.dtype,
                          feats.device)
        x, _ = base.decoder_layer(lp, cfg, x, lc, 0, lambda: mask, rope)
    x = rms_norm(params["norm"], x, cfg.rms_norm_eps)
    return x[:, n_image:]


# --------------------------------------------------------------- prompts ----

def tokenize_prompt(tokenizer, prompt: str, n_image_tokens: int,
                    image_tag: str = "<image>"):
    """The conversation format and its image-token block: token ids with
    ``n_image_tokens`` + 1 IMAGE_TOKEN_ID slots (the view and its
    separator) at the ``<image>`` tag (prepended where absent)."""
    if image_tag not in prompt:
        prompt = image_tag + prompt
    formatted = f"<|User|>: {prompt}\n\n<|Assistant|>:"
    pre, _, post = formatted.partition(image_tag)
    ids = [BOS_TOKEN_ID] + tokenizer.encode(pre, add_special_tokens=False) \
        if hasattr(tokenizer, "encode") else [BOS_TOKEN_ID]
    img_block = [IMAGE_TOKEN_ID] * (n_image_tokens + 1)
    tail = tokenizer.encode(post, add_special_tokens=False) \
        if hasattr(tokenizer, "encode") else []
    return ids + img_block + tail


# --------------------------------------------------------------- decoder ----

def config_from_hf(d: dict) -> TransformerConfig:
    """The OCR-2 decoder (defaults: 1280 wide, 12 layers, 10 heads MHA, 64
    experts top 6 by softmax and 2 shared, expert width 896)."""
    cfg = TransformerConfig(
        vocab_size=d.get("vocab_size", 129280),
        hidden_size=d.get("hidden_size", 1280),
        num_layers=d.get("num_hidden_layers", 12),
        num_heads=d.get("num_attention_heads", 10),
        num_kv_heads=d.get("num_key_value_heads", 10),
        intermediate_size=d.get("intermediate_size", 6848),
        rms_norm_eps=d.get("rms_norm_eps", 1e-6),
        rope_theta=d.get("rope_theta", 10000.0),
        tie_word_embeddings=d.get("tie_word_embeddings", False))
    moe = MoEConfig(
        num_experts=d.get("n_routed_experts", 64),
        top_k=d.get("num_experts_per_tok", 6),
        norm_topk_prob=d.get("norm_topk_prob", False),
        routing="softmax",
        routed_scaling_factor=d.get("routed_scaling_factor", 1.0),
        n_shared_experts=d.get("n_shared_experts", 2),
        moe_intermediate_size=d.get("moe_intermediate_size", 896))
    return dataclasses.replace(cfg, moe=moe)


def _t(flat, name, device):
    t = torch.as_tensor(flat[name])
    return t if device is None else t.to(device)


def lm_params_from_flat(flat: dict, cfg: TransformerConfig,
                        first_k_dense: int = 1, device=None) -> dict:
    """``model.layers.{i}`` names (DeepSeek-V2 style) -> the decoder's
    tree: the first ``first_k_dense`` layers (and any holding a dense
    ``mlp.gate_proj``) dense, the others a MoE layer with its experts
    stacked [E, N, K] and its shared experts as one dense MLP."""
    E = cfg.moe.num_experts
    params = {"embed": _t(flat, "model.embed_tokens.weight", device),
              "norm": _t(flat, "model.norm.weight", device), "layers": []}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        lp = {"input_layernorm": _t(flat, f"{p}.input_layernorm.weight",
                                    device),
              "post_attention_layernorm":
                  _t(flat, f"{p}.post_attention_layernorm.weight", device)}
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            lp[n] = base._linear_params(flat, f"{p}.self_attn.{n}", None,
                                        device)
        if i < first_k_dense or f"{p}.mlp.gate_proj.weight" in flat:
            for n in ("gate_proj", "up_proj", "down_proj"):
                lp[n] = base._linear_params(flat, f"{p}.mlp.{n}", None,
                                            device)
        else:
            lp["moe"] = {
                "gate": {"w": _t(flat, f"{p}.mlp.gate.weight", device)},
                "experts": {
                    n: torch.stack([_t(flat, f"{p}.mlp.experts.{e}.{n}"
                                       ".weight", device)
                                    for e in range(E)])
                    for n in ("gate_proj", "up_proj", "down_proj")},
                "shared_expert": {
                    n: {"w": _t(flat, f"{p}.mlp.shared_experts.{n}.weight",
                                device)}
                    for n in ("gate_proj", "up_proj", "down_proj")},
            }
        params["layers"].append(lp)
    if not cfg.tie_word_embeddings and "lm_head.weight" in flat:
        params["lm_head"] = base._linear_params(flat, "lm_head", None, device)
    return params


def flow_params_from_flat(flat: dict, prefix: str = "model.qwen2_model",
                          device=None) -> dict:
    """``{prefix}.model.model.layers.{i}`` / ``.norm`` and
    ``{prefix}.query_768`` / ``query_1024`` -> the flow's tree."""
    mp = f"{prefix}.model.model"
    layers = []
    i = 0
    while f"{mp}.layers.{i}.input_layernorm.weight" in flat:
        p = f"{mp}.layers.{i}"
        lp = {"input_layernorm": _t(flat, f"{p}.input_layernorm.weight",
                                    device),
              "post_attention_layernorm":
                  _t(flat, f"{p}.post_attention_layernorm.weight", device)}
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            lp[n] = base._linear_params(flat, f"{p}.self_attn.{n}", None,
                                        device)
        for n in ("gate_proj", "up_proj", "down_proj"):
            lp[n] = base._linear_params(flat, f"{p}.mlp.{n}", None, device)
        layers.append(lp)
        i += 1
    return {"layers": layers, "norm": _t(flat, f"{mp}.norm.weight", device),
            "query_768": _t(flat, f"{prefix}.query_768.weight", device),
            "query_1024": _t(flat, f"{prefix}.query_1024.weight", device)}


# ----------------------------------------------------------------- model ----

@dataclasses.dataclass
class DeepSeekOCR2:
    vision_params: dict
    vision_cfg: object                # SamViTConfig or vit.ViTConfig
    projector: dict                   # {"w", "b"} linear, or fc1 / fc2 MLP
    lm_params: dict                   # the MoE decoder (base's tree)
    lm_cfg: TransformerConfig
    flow_params: Optional[dict] = None
    flow_cfg: Optional[TransformerConfig] = None
    view_separator: Optional[torch.Tensor] = None   # [D_lm]
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

    @property
    def image_size(self) -> int:
        return getattr(self.vision_cfg, "img_size",
                       getattr(self.vision_cfg, "image_size", 1024))

    @torch.inference_mode()
    def encode_page(self, image01: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] -> LLM-space image embeddings [B, N, D]."""
        x = (image01 * 2.0 - 1.0).to(
            self.vision_params["patch_embed"]["w"].dtype)
        if isinstance(self.vision_cfg, sam_vit.SamViTConfig):
            f = sam_vit.encode(self.vision_params, self.vision_cfg, x)
        else:
            f = vit.encode(self.vision_params, self.vision_cfg, x)
        if self.flow_params is not None:
            f = visual_flow_encode(self.flow_params, self.flow_cfg, f)
        if f.ndim == 4:
            f = f.reshape(f.shape[0], -1, f.shape[-1])
        if "fc1" in self.projector:       # the legacy two-layer projector
            h = gelu_tanh(linear(self.projector["fc1"], f))
            return linear(self.projector["fc2"], h)
        return linear(self.projector, f)

    @property
    def n_image_tokens(self) -> int:
        return (self.image_size // 16 // 4) ** 2   # patch 16, flow 4x down

    def ocr_pdf_tokens(self, pdf_bytes: bytes, prompt_tokens: List[int],
                       image_token_pos: int = 0, max_tokens: int = 128,
                       stop_tokens=(), dpi: int = 200) -> List[List[int]]:
        """OCR every page of a PDF (``utils.pdf.render_pdf_pages``), each
        page resized to the tower's size."""
        from ominix_mlx_tpu_torch.utils import pdf as pdf_mod

        size = self.image_size
        outs = []
        for page in pdf_mod.render_pdf_pages(pdf_bytes, dpi):
            img = as_image(np.asarray(page.image, np.float32) / 255.0,
                           self.device)
            img = resize_bilinear(img, size, size)
            outs.append(self.ocr_tokens(img, prompt_tokens, image_token_pos,
                                        max_tokens, stop_tokens))
        return outs

    @torch.inference_mode()
    def prepare_inputs(self, image01: torch.Tensor, prompt_tokens: List[int],
                       image_token_pos: int = 0) -> torch.Tensor:
        """Splice the image embeddings into the prompt's: where the prompt
        holds IMAGE_TOKEN_ID slots, the first of them (in row 0) are
        overwritten in place by the patches, followed by the view
        separator where there is one and the slots outnumber the patches;
        otherwise the patches are inserted at ``image_token_pos``."""
        patches = self.encode_page(image01)
        emb = embedding(self.lm_params["embed"], torch.tensor(
            [prompt_tokens], dtype=torch.long, device=self.device))
        slots = np.nonzero(np.asarray(prompt_tokens) == IMAGE_TOKEN_ID)[0]
        if slots.size:
            n = patches.shape[1]
            fill = patches[0]
            if self.view_separator is not None and slots.size >= n + 1:
                fill = torch.cat([fill, self.view_separator[None].to(
                    fill.dtype)], 0)
            k = min(slots.size, fill.shape[0])
            emb = emb.clone()
            emb[0, torch.as_tensor(slots[:k], device=self.device)] = \
                fill[:k].to(emb.dtype)
            return emb
        return torch.cat([emb[:, :image_token_pos], patches.to(emb.dtype),
                          emb[:, image_token_pos:]], 1)

    @torch.inference_mode()
    def prefill(self, image01: torch.Tensor, prompt_tokens: List[int],
                max_tokens: int, image_token_pos: int = 0):
        """``prepare_inputs`` run through the decoder at once (K2, and K5
        on packed experts, on CUDA) into a cache of the prompt,
        ``max_tokens`` and 8 slots. Returns (last logits [1, V], cache)."""
        embeds = self.prepare_inputs(image01, prompt_tokens, image_token_pos)
        cache = base.init_cache(self.lm_cfg, 1,
                                embeds.shape[1] + max_tokens + 8,
                                embeds.dtype, self.device)
        logits, cache = base.forward_embeds(self.lm_params, self.lm_cfg,
                                            embeds, cache,
                                            fresh_prefill=True)
        return logits[:, -1], cache

    def ocr_tokens(self, image01: torch.Tensor, prompt_tokens: List[int],
                   image_token_pos: int = 0, max_tokens: int = 128,
                   stop_tokens=()) -> List[int]:
        """Greedy tokens after the spliced prompt; a stop token ends the
        list before it is appended."""
        logits, cache = self.prefill(image01, prompt_tokens, max_tokens,
                                     image_token_pos)
        return list(self.engine().decode(logits, cache, max_tokens,
                                         tuple(stop_tokens)))

    # ------------------------------------------------- server/CLI facade ----

    def prompt_ids(self, prompt: str) -> List[int]:
        if self.tokenizer:
            return tokenize_prompt(self.tokenizer, prompt,
                                   self.n_image_tokens)
        return [BOS_TOKEN_ID] + [IMAGE_TOKEN_ID] * (self.n_image_tokens + 1)

    def ocr(self, image01, prompt: str = "Free OCR.",
            max_tokens: int = 512) -> str:
        """An [H, W, 3] float image (or [B, ...]) in [0, 1] -> text (the
        server's /v1/ocr), resized to the tower's size where it differs."""
        image = as_image(image01, self.device)
        size = self.image_size
        if image.shape[1] != size or image.shape[2] != size:
            image = resize_bilinear(image, size, size)
        out = self.ocr_tokens(image, self.prompt_ids(prompt),
                              max_tokens=max_tokens,
                              stop_tokens=(EOS_TOKEN_ID,))
        return (self.tokenizer.decode(out) if self.tokenizer
                else " ".join(map(str, out)))

    def ocr_pdf(self, pdf_bytes: bytes, prompt: str = "Free OCR.",
                max_tokens: int = 512, dpi: int = 200) -> List[str]:
        pages = self.ocr_pdf_tokens(pdf_bytes, self.prompt_ids(prompt),
                                    max_tokens=max_tokens,
                                    stop_tokens=(EOS_TOKEN_ID,), dpi=dpi)
        return [(self.tokenizer.decode(p) if self.tokenizer
                 else " ".join(map(str, p))) for p in pages]


def from_numpy(vision: dict, vision_cfg, projector: dict, lm: dict,
               lm_cfg: TransformerConfig, device, flow: dict = None,
               flow_cfg: TransformerConfig = None, view_separator=None,
               tokenizer=None) -> DeepSeekOCR2:
    """A JAX DeepSeekOCR2's trees as numpy -> the port's assembly on
    ``device`` (the tower's convolutions OHWI -> OIHW)."""
    tower = sam_vit if isinstance(vision_cfg, sam_vit.SamViTConfig) else vit
    return DeepSeekOCR2(
        vision_params=tower.from_numpy(vision, device),
        vision_cfg=vision_cfg,
        projector=params_from_numpy(projector, device),
        lm_params=params_from_numpy(lm, device), lm_cfg=lm_cfg,
        flow_params=None if flow is None else params_from_numpy(flow, device),
        flow_cfg=flow_cfg,
        view_separator=(None if view_separator is None
                        else params_from_numpy(view_separator, device)),
        tokenizer=tokenizer, device=device)


def load_model(model_dir: str, device=None) -> DeepSeekOCR2:
    """A checkpoint directory in HF names (model.sam_model.*,
    model.qwen2_model.*, model.projector.layers.*, model.view_seperator,
    model.embed_tokens / layers / norm, config.json), on ``device``
    (default: the current CUDA device). The tower is SAM ViT-B with the
    896-channel adapter and the flow the 24-layer 896-wide compressor, as
    in the JAX package, unless config.json names others: ``sam_config``
    (``SamViTConfig`` fields) and ``flow_config`` ({"hidden", "layers"}),
    which small test checkpoints use."""
    from ominix_mlx_tpu_torch.utils.loading import (load_config,
                                                    load_safetensors)

    device = resolve_device(device)
    raw = load_config(model_dir)
    flat = load_safetensors(model_dir)
    cfg = config_from_hf(raw)
    sam_kw = dict(raw.get("sam_config") or {"adapter_chans": 896})
    if "global_attn_indexes" in sam_kw:
        sam_kw["global_attn_indexes"] = tuple(sam_kw["global_attn_indexes"])
    sam_cfg = sam_vit.SamViTConfig(**sam_kw)
    projector = {"w": _t(flat, "model.projector.layers.weight", device)}
    if "model.projector.layers.bias" in flat:
        projector["b"] = _t(flat, "model.projector.layers.bias", device)
    tok = None
    if os.path.exists(os.path.join(model_dir, "tokenizer.json")):
        from ominix_mlx_tpu_torch.utils.tokenizer import Tokenizer
        tok = Tokenizer(model_dir)
    sep = flat.get("model.view_seperator")
    return DeepSeekOCR2(
        vision_params=sam_vit.params_from_flat(flat, sam_cfg,
                                               "model.sam_model", device),
        vision_cfg=sam_cfg, projector=projector,
        lm_params=lm_params_from_flat(
            flat, cfg, raw.get("first_k_dense_replace", 1), device),
        lm_cfg=cfg,
        flow_params=flow_params_from_flat(flat, device=device),
        flow_cfg=visual_flow_config(**(raw.get("flow_config") or {})),
        view_separator=None if sep is None else sep.to(device),
        tokenizer=tok, device=device)
