"""The port's DeepSeek-OCR-2 against the JAX package's on the CPU, on a
tiny assembly (SAM at 128 px, a 2-layer 16-wide visual flow, a 2-layer
MoE decoder: a dense first layer, 8 experts top 2 and a shared one, the
published 129280-token vocabulary so IMAGE_TOKEN_ID is a real id)
carried across by ``deepseek_ocr2.from_numpy``: the flow's mask and
``visual_flow_encode`` (1e-4 relative), ``encode_page``, ``prepare_inputs``
with the prompt's IMAGE_TOKEN_ID slots overwritten (and the view
separator) and with the patches inserted (1e-4 relative),
``tokenize_prompt`` (equal ids), the prefill's logits (1e-4 relative) and
greedy ``ocr_tokens`` (equal, token for token)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import deepseek_ocr2 as jocr
from ominix_mlx_tpu.models import sam_vit as jsam
from ominix_mlx_tpu.models.moe import init_moe_params
from ominix_mlx_tpu_torch.models import deepseek_ocr2 as ocr
from ominix_mlx_tpu_torch.models import sam_vit

torch.set_num_threads(2)

LM = {"vocab_size": 129280, "hidden_size": 32, "num_hidden_layers": 2,
      "num_attention_heads": 2, "num_key_value_heads": 2,
      "intermediate_size": 64, "n_routed_experts": 8,
      "num_experts_per_tok": 2, "n_shared_experts": 1,
      "moe_intermediate_size": 16}
SAM = dict(img_size=128, patch_size=16, embed_dim=32, depth=2, num_heads=2,
           window_size=3, global_attn_indexes=(1,), out_chans=8,
           adapter_chans=16)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / np.abs(want).max())


def _lm_params(cfg, key):
    """The decoder as the JAX package's bench builds it: layer 0 dense,
    the others MoE with a shared expert of n_shared experts' width."""
    params = jbase.init_params(cfg, key, jnp.float32)
    ks = iter(jax.random.split(jax.random.PRNGKey(7), 4 * cfg.num_layers))
    I = cfg.moe.moe_intermediate_size * cfg.moe.n_shared_experts
    s = cfg.hidden_size ** -0.5
    for lp in params["layers"][1:]:
        moe = init_moe_params(next(ks), cfg.hidden_size, cfg.moe,
                              jnp.float32)
        moe["shared_expert"] = {
            n: {"w": jax.random.uniform(next(ks), shape, jnp.float32, -s, s)}
            for n, shape in (("gate_proj", (I, cfg.hidden_size)),
                             ("up_proj", (I, cfg.hidden_size)),
                             ("down_proj", (cfg.hidden_size, I)))}
        for n in ("gate_proj", "up_proj", "down_proj"):
            del lp[n]
        lp["moe"] = moe
    return params


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    scfg = jsam.SamViTConfig(**SAM)
    vision = jsam.init_params(scfg, jax.random.PRNGKey(1))
    vision["pos_embed"] = jnp.asarray(
        rng.normal(size=vision["pos_embed"].shape) * 0.1, jnp.float32)
    fcfg = jocr.visual_flow_config(hidden=16, layers=2)
    flow = jbase.init_params(fcfg, jax.random.PRNGKey(2), jnp.float32)
    flow = {"layers": flow["layers"], "norm": flow["norm"],
            "query_768": jnp.asarray(rng.normal(size=(4, 16)), jnp.float32),
            "query_1024": jnp.asarray(rng.normal(size=(9, 16)),
                                      jnp.float32)}
    lm_cfg = jocr.config_from_hf(LM)
    lm = _lm_params(lm_cfg, jax.random.PRNGKey(3))
    proj = {"w": jnp.asarray(rng.uniform(-0.25, 0.25, (32, 16)), jnp.float32),
            "b": jnp.asarray(rng.normal(size=32) * 0.1, jnp.float32)}
    sep = jnp.asarray(rng.normal(size=32) * 0.02, jnp.float32)
    jm = jocr.DeepSeekOCR2(vision_params=vision, vision_cfg=scfg,
                           projector=proj, lm_params=lm, lm_cfg=lm_cfg,
                           flow_params=flow, flow_cfg=fcfg,
                           view_separator=sep)
    tm = ocr.from_numpy(_np(vision), sam_vit.SamViTConfig(**SAM), _np(proj),
                        _np(lm), ocr.config_from_hf(LM), "cpu",
                        flow=_np(flow),
                        flow_cfg=ocr.visual_flow_config(hidden=16, layers=2),
                        view_separator=np.asarray(sep))
    return jm, tm


def _page(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (1, 128, 128, 3)
                                               ).astype(np.float32)


def test_configs_match_jax():
    for d in ({}, LM):
        j, t = jocr.config_from_hf(d), ocr.config_from_hf(d)
        assert dataclasses.asdict(j.moe) == dataclasses.asdict(t.moe)
        assert all(getattr(j, k) == v for k, v in vars(t).items()
                   if k not in ("moe", "mla", "deltanet", "layer_types"))
    j, t = jocr.visual_flow_config(), ocr.visual_flow_config()
    assert (j.num_heads, j.num_kv_heads, j.hd, j.intermediate_size,
            j.rope_theta) == (t.num_heads, t.num_kv_heads, t.hd,
                              t.intermediate_size, t.rope_theta)


def test_visual_flow_mask_matches_jax():
    assert np.array_equal(ocr.visual_flow_mask(5, 4).numpy(),
                          np.asarray(jocr.visual_flow_mask(5, 4)))


def test_visual_flow_encode_matches_jax(pair):
    jm, tm = pair
    feats = np.random.default_rng(1).normal(size=(2, 2, 2, 16)).astype("f4")
    want = jocr.visual_flow_encode(jm.flow_params, jm.flow_cfg,
                                   jnp.asarray(feats))
    got = ocr.visual_flow_encode(tm.flow_params, tm.flow_cfg,
                                 torch.from_numpy(feats))
    assert got.shape == (2, 4, 16)
    assert _rel(got, want) < 1e-4


def test_encode_page_matches_jax(pair):
    jm, tm = pair
    img = _page()
    got = tm.encode_page(torch.from_numpy(img))
    assert got.shape == (1, 4, 32) and tm.n_image_tokens == 4
    assert _rel(got, jm.encode_page(jnp.asarray(img))) < 1e-4


class _Tok:
    def encode(self, text, add_special_tokens=True):
        return [3 + (ord(c) % 50) for c in text]


def test_tokenize_prompt_matches_jax():
    for prompt in ("Free OCR.", "Read <image> here"):
        assert ocr.tokenize_prompt(_Tok(), prompt, 4) == \
            jocr.tokenize_prompt(_Tok(), prompt, 4)


@pytest.mark.parametrize("prompt,pos", [
    ([0] + [ocr.IMAGE_TOKEN_ID] * 5 + [40, 41], 0),      # slots + separator
    ([0, 9] + [ocr.IMAGE_TOKEN_ID] * 3 + [40], 0),       # fewer slots
    ([0, 9, 40, 41], 2)], ids=["slots", "few_slots", "insert"])
def test_prepare_inputs_matches_jax(pair, prompt, pos):
    jm, tm = pair
    img = _page(1)
    want = jm.prepare_inputs(jnp.asarray(img), prompt, pos)
    got = tm.prepare_inputs(torch.from_numpy(img), prompt, pos)
    assert _rel(got, want) < 1e-4
    if pos:
        assert got.shape[1] == len(prompt) + 4


def test_prefill_logits_and_ocr_tokens_match_jax(pair):
    jm, tm = pair
    img = _page(2)
    prompt = tm.prompt_ids("Free OCR.")
    assert prompt == [0] + [ocr.IMAGE_TOKEN_ID] * 5
    embeds = jm.prepare_inputs(jnp.asarray(img), prompt)
    cache = jbase.init_cache(jm.lm_cfg, 1, 32, jnp.float32)
    want, _ = jbase.forward_embeds(jm.lm_params, jm.lm_cfg, embeds, cache)
    got, _ = tm.prefill(torch.from_numpy(img), prompt, 8)
    assert _rel(got, np.asarray(want)[:, -1]) < 1e-4
    want = jm.ocr_tokens(jnp.asarray(img), prompt, max_tokens=6)
    assert tm.ocr_tokens(torch.from_numpy(img), prompt, max_tokens=6) == want
    assert len(want) == 6


@pytest.mark.parametrize("kind", ["jpeg", "flate_gray"])
def test_render_pdf_pages_matches_jax(kind):
    """The copied PDF reader gives the JAX package's page arrays: an
    embedded JPEG page and a Flate-compressed grey one."""
    import io
    import zlib

    from PIL import Image

    from ominix_mlx_tpu.utils import pdf as jpdf
    from ominix_mlx_tpu_torch.utils import pdf

    rng = np.random.default_rng(6)
    if kind == "jpeg":
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (64, 48, 3), np.uint8)).save(
            buf, format="JPEG")
        head, data = b"/ColorSpace /DeviceRGB /Filter /DCTDecode", \
            buf.getvalue()
    else:
        head = b"/ColorSpace /DeviceGray /Filter /FlateDecode"
        data = zlib.compress(rng.integers(0, 256, (64, 48), np.uint8)
                             .tobytes())
    raw = (b"%PDF-1.4\n1 0 obj\n<< /Subtype /Image /Width 48 /Height 64 "
           b"/BitsPerComponent 8 " + head + b" /Length "
           + str(len(data)).encode() + b" >>\nstream\n" + data
           + b"\nendstream\nendobj\n%%EOF")
    got, want = pdf.render_pdf_pages(raw), jpdf.render_pdf_pages(raw)
    assert pdf.is_pdf(raw) and len(got) == len(want) == 1
    assert got[0].image.shape == (64, 48, 3)
    assert np.array_equal(got[0].image, want[0].image)
