"""The port's Moxin VLM against the JAX package's on the CPU, at the JAX
``init_tiny`` assembly carried across by ``moxin_vlm.from_numpy``: the
towers' fused patch embeddings (1e-4 relative), the prefill's logits over
the spliced prompt (1e-4 relative), greedy ``generate`` tokens (equal,
token for token, with and without a stop token), and ``chat`` on images
that its resize shrinks and enlarges (equal tokens)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import moxin_vlm as jmoxin
from ominix_mlx_tpu.nn.layers import embedding as jembedding
from ominix_mlx_tpu_torch.models import moxin_vlm

torch.set_num_threads(2)

PROMPT = [1, 7, 3, 60, 12]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    jm = jmoxin.init_tiny(jax.random.PRNGKey(0))
    # random LayerScale and CLS / registers, so the port is held to them
    rng = np.random.default_rng(5)
    for blk in jm.dino_params["blocks"]:
        for k in ("ls1", "ls2"):
            blk[k] = jnp.asarray(rng.uniform(0.5, 1.5, blk[k].shape),
                                 jnp.float32)
    for k in ("cls_token", "register_tokens"):
        jm.dino_params[k] = jnp.asarray(
            rng.normal(size=jm.dino_params[k].shape), jnp.float32)
    dcfg, scfg, lm_cfg = moxin_vlm.tiny_configs()
    tm = moxin_vlm.from_numpy(_np(jm.dino_params), _np(jm.siglip_params),
                              _np(jm.projector), _np(jm.lm_params), dcfg,
                              scfg, lm_cfg, "cpu")
    return jm, tm


def _image(shape=(1, 28, 28, 3), seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def test_tiny_configs_are_the_jax_ones(pair):
    jm, tm = pair
    for a, b in ((jm.dino_cfg, tm.dino_cfg), (jm.siglip_cfg, tm.siglip_cfg)):
        assert vars(a) == vars(b)
    assert all(getattr(jm.lm_cfg, k) == v for k, v in vars(tm.lm_cfg).items()
               if k not in ("moe", "mla", "deltanet", "layer_types"))


def test_encode_image_matches_jax(pair):
    jm, tm = pair
    img = _image((2, 28, 28, 3))
    want = jm.encode_image(jnp.asarray(img))
    got = tm.encode_image(torch.from_numpy(img))
    assert got.shape == (2, 4, 48)
    assert _rel(got, want) < 1e-4


def test_prefill_logits_match_jax(pair):
    jm, tm = pair
    img = _image()
    patches = jm.encode_image(jnp.asarray(img))
    emb = jembedding(jm.lm_params["embed"], jnp.asarray([PROMPT]))
    embeds = jnp.concatenate([patches.astype(emb.dtype), emb], 1)
    cache = jbase.init_cache(jm.lm_cfg, 1, embeds.shape[1] + 16, jnp.float32)
    want, _ = jbase.forward_embeds(jm.lm_params, jm.lm_cfg, embeds, cache)
    got, cache = tm.prefill(torch.from_numpy(img), PROMPT, 8)
    assert cache.offset == 4 + len(PROMPT)
    assert _rel(got, np.asarray(want)[:, -1]) < 1e-4


@pytest.mark.parametrize("stop", [False, True])
def test_generate_tokens_match_jax(pair, stop):
    jm, tm = pair
    img = _image(seed=1)
    want = jm.generate(jnp.asarray(img), PROMPT, max_tokens=6)
    stops = ()
    if stop:
        stops = (want[3],)
        want = jm.generate(jnp.asarray(img), PROMPT, max_tokens=6,
                           stop_tokens=stops)
    got = tm.generate(torch.from_numpy(img), PROMPT, max_tokens=6,
                      stop_tokens=stops)
    assert got == want
    if stop:
        assert stops[0] not in got and len(got) <= 3
    else:
        assert len(got) == 6


@pytest.mark.parametrize("hw", [(30, 41), (20, 17)], ids=["shrink",
                                                          "enlarge"])
def test_chat_resizes_as_jax(pair, hw):
    jm, tm = pair
    img = _image(hw + (3,), seed=2)
    assert tm.chat("what is this?", img, max_tokens=5) == jm.chat(
        "what is this?", jnp.asarray(img), max_tokens=5)
