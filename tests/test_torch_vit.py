"""The port's vision layers and ViT towers against the JAX package on the
same seeded inputs, on the CPU: ``layer_norm``, ``conv2d`` (stride,
padding, groups), each GELU flavour, the bilinear resize, and
``vit.encode`` for a DINOv2-like tower (CLS, registers, LayerScale, exact
GELU) and a SigLIP-like one (positions before any prefix, tanh GELU),
with the JAX trees carried across by ``vit.from_numpy``. Float32
throughout: each result within 1e-5 relative to its largest value (1e-4
for the towers, whose float32 sums differ in order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import vit as jvit
from ominix_mlx_tpu.nn import layers as jl
from ominix_mlx_tpu_torch.models import vit
from ominix_mlx_tpu_torch.nn import layers as tl

torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err < tol, err


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32) * 3 + 1
    p = {"w": rng.normal(size=24).astype(np.float32),
         "b": rng.normal(size=24).astype(np.float32)}
    want = jl.layer_norm(_np(p), jnp.asarray(x), 1e-6)
    got = tl.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), 1e-6)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("stride,padding,groups", [
    (1, 0, 1), (2, 1, 1), ((2, 1), (1, 0), 1), (1, 1, 2)])
def test_conv2d_matches_jax(stride, padding, groups):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 11, 4)).astype(np.float32)
    w = rng.normal(size=(6, 3, 3, 4 // groups)).astype(np.float32)   # OHWI
    b = rng.normal(size=6).astype(np.float32)
    want = jl.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(x), stride=stride, padding=padding,
                     groups=groups)
    got = tl.conv2d({"w": tl.conv_weight(torch.from_numpy(w)),
                     "b": torch.from_numpy(b)}, torch.from_numpy(x),
                    stride=stride, padding=padding, groups=groups)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("name", ["gelu", "gelu_new", "gelu_pytorch_tanh",
                                  "relu2", "sigmoid"])
def test_activations_match_jax(name):
    """The table's "gelu" is jax.nn.gelu's default, the tanh form."""
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    _close(tl.ACTIVATIONS[name](torch.from_numpy(x)),
           jl.ACTIVATIONS[name](jnp.asarray(x)), 1e-6)


def test_exact_gelu_matches_jax():
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    _close(tl.gelu_exact(torch.from_numpy(x)),
           jax.nn.gelu(jnp.asarray(x), approximate=False), 1e-6)
    # and the two forms differ, so the tests above tell them apart
    assert float(np.abs(np.asarray(jax.nn.gelu(jnp.asarray(x)))
                        - tl.gelu_exact(torch.from_numpy(x)).numpy()
                        ).max()) > 1e-4


@pytest.mark.parametrize("shape", [(1, 30, 41, 3), (2, 20, 12, 3)])
def test_resize_matches_jax_image_resize(shape):
    """Shrink (antialiased in both) and enlarge to 28 px, within 1e-4
    absolute."""
    img = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(img), (shape[0], 28, 28, 3),
                            "bilinear")
    got = tl.resize_bilinear(torch.from_numpy(img), 28, 28)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 1e-4


DINO_LIKE = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
                 num_heads=2, mlp_dim=48, has_cls_token=True, num_registers=3,
                 layer_scale=True)
SIGLIP_LIKE = dict(image_size=42, patch_size=14, hidden_size=24,
                   num_layers=2, num_heads=3, mlp_dim=40,
                   has_cls_token=False, hidden_act="gelu_pytorch_tanh")


def _random_ls(params, rng):
    """LayerScale and CLS / registers away from their init values, so the
    test sees them."""
    for blk in params["blocks"]:
        for k in ("ls1", "ls2"):
            if k in blk:
                blk[k] = jnp.asarray(rng.uniform(0.5, 1.5, blk[k].shape),
                                     jnp.float32)
    for k in ("cls_token", "register_tokens"):
        if k in params:
            params[k] = jnp.asarray(rng.normal(size=params[k].shape),
                                    jnp.float32)
    return params


@pytest.mark.parametrize("kw", [DINO_LIKE, SIGLIP_LIKE],
                         ids=["dinov2", "siglip"])
def test_vit_encode_matches_jax(kw):
    rng = np.random.default_rng(3)
    jcfg = jvit.ViTConfig(**kw)
    cfg = vit.ViTConfig(**dataclasses.asdict(jcfg))
    jp = _random_ls(jvit.init_params(jcfg, jax.random.PRNGKey(0)), rng)
    img = rng.normal(size=(2, kw["image_size"], kw["image_size"], 3)
                     ).astype(np.float32)
    want = jvit.encode(jp, jcfg, jnp.asarray(img))
    got = vit.encode(vit.from_numpy(_np(jp), "cpu"), cfg,
                     torch.from_numpy(img))
    assert got.shape == (2, cfg.num_patches, cfg.hidden_size)
    _close(got, want, 1e-4)


def test_vit_pos_embed_is_not_interpolated():
    cfg = vit.ViTConfig(**DINO_LIKE)
    params = vit.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(ValueError, match="without interpolation"):
        vit.encode(params, cfg, torch.zeros(1, 42, 42, 3))
