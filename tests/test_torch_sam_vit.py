"""The port's SAM ViT encoder against the JAX package on the same seeded
inputs, on the CPU: the window partition round trip, ``_get_rel_pos``
with its linear resize, and ``sam_vit.encode`` on a grid the window does
not divide (zero padding, unmasked) with resized rel-pos tables, random
positions, the neck and the OCR adapter, the JAX tree carried across by
``sam_vit.from_numpy``. Float32: within 1e-4 relative to the largest
value."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import sam_vit as jsam
from ominix_mlx_tpu_torch.models import sam_vit

torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got.detach().numpy() - want).max()
                 / np.abs(want).max())


def test_window_partition_roundtrip_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 10, 12, 8)).astype("f4")
    jw, jpad = jsam._window_partition(jnp.asarray(x), 4)
    w, pad = sam_vit._window_partition(torch.from_numpy(x), 4)
    assert pad == jpad and w.shape == (2 * 3 * 3, 4, 4, 8)
    assert _rel(w, jw) == 0.0
    back = sam_vit._window_unpartition(w, 4, pad, (10, 12))
    assert torch.equal(back, torch.from_numpy(x))


@pytest.mark.parametrize("q,k,n", [(5, 5, 9), (5, 5, 7), (3, 6, 11)])
def test_get_rel_pos_matches_jax(q, k, n):
    """Tables of the wanted length (2 max - 1) and of others, resized."""
    t = np.random.default_rng(1).normal(size=(n, 6)).astype("f4")
    want = jsam._get_rel_pos(q, k, jnp.asarray(t))
    got = sam_vit._get_rel_pos(q, k, torch.from_numpy(t))
    assert _rel(got, want) < 1e-6


def test_sam_encode_matches_jax():
    """Grid 5 under window 3 (padded to 6), one global block, rel-pos
    tables of 7 rows where 5 are wanted (resized) and 9 for the global
    block, random positions: features after the adapter, 2x2x12."""
    jcfg = jsam.SamViTConfig(img_size=80, patch_size=16, embed_dim=32,
                             depth=3, num_heads=2, window_size=3,
                             global_attn_indexes=(1,), out_chans=8,
                             adapter_chans=12)
    cfg = sam_vit.SamViTConfig(**dataclasses.asdict(jcfg))
    p = jsam.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    hd = jcfg.embed_dim // jcfg.num_heads
    for i, blk in enumerate(p["blocks"]):
        n = 9 if i in jcfg.global_attn_indexes else 7
        for k in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][k] = jnp.asarray(rng.normal(size=(n, hd)) * 0.5,
                                         jnp.float32)
    p["pos_embed"] = jnp.asarray(rng.normal(size=p["pos_embed"].shape) * 0.1,
                                 jnp.float32)
    img = rng.normal(size=(2, 80, 80, 3)).astype("f4")
    want = jsam.encode(p, jcfg, jnp.asarray(img))
    got = sam_vit.encode(sam_vit.from_numpy(_np(p), "cpu"), cfg,
                         torch.from_numpy(img))
    assert got.shape == (2, 2, 2, 12)
    assert _rel(got, want) < 1e-4


def test_sam_params_from_flat_keeps_oihw():
    """A torch checkpoint's OIHW convolutions load as the port's conv2d
    takes them, equal to the JAX loader's OHWI weights transposed."""
    cfg = jsam.SamViTConfig(img_size=32, patch_size=16, embed_dim=16,
                            depth=1, num_heads=2, window_size=2,
                            global_attn_indexes=(0,), out_chans=8)
    p = jsam.init_params(cfg, jax.random.PRNGKey(3))
    flat = {"m.patch_embed.proj.weight": np.transpose(
                np.asarray(p["patch_embed"]["w"]), (0, 3, 1, 2)),
            "m.patch_embed.proj.bias": np.asarray(p["patch_embed"]["b"]),
            "m.pos_embed": np.asarray(p["pos_embed"])}
    b = p["blocks"][0]
    for n, src in (("norm1", b["norm1"]), ("norm2", b["norm2"]),
                   ("attn.qkv", b["attn"]["qkv"]),
                   ("attn.proj", b["attn"]["proj"]),
                   ("mlp.lin1", b["mlp_fc1"]), ("mlp.lin2", b["mlp_fc2"])):
        flat[f"m.blocks.0.{n}.weight"] = np.asarray(src["w"])
        flat[f"m.blocks.0.{n}.bias"] = np.asarray(src["b"])
    for k in ("rel_pos_h", "rel_pos_w"):
        flat[f"m.blocks.0.attn.{k}"] = np.asarray(b["attn"][k])
    for i, n in ((0, "neck0"), (2, "neck1")):
        flat[f"m.neck.{i}.weight"] = np.transpose(np.asarray(p[n]["w"]),
                                                  (0, 3, 1, 2))
    for i, n in ((1, "neck_ln0"), (3, "neck_ln1")):
        flat[f"m.neck.{i}.weight"] = np.asarray(p[n]["w"])
        flat[f"m.neck.{i}.bias"] = np.asarray(p[n]["b"])
    for n in ("net2", "net3"):
        flat[f"m.net_{n[-1]}.weight"] = np.transpose(np.asarray(p[n]["w"]),
                                                     (0, 3, 1, 2))
        flat[f"m.net_{n[-1]}.bias"] = np.asarray(p[n]["b"])
    want = jsam.params_from_flat(flat, cfg, prefix="m")
    got = sam_vit.params_from_flat(flat, sam_vit.SamViTConfig(
        **dataclasses.asdict(cfg)), prefix="m")
    ref = sam_vit.from_numpy(_np(want), "cpu")
    for n in sam_vit.CONVS:
        assert torch.equal(got[n]["w"], ref[n]["w"])
    img = np.random.default_rng(4).normal(size=(1, 32, 32, 3)).astype("f4")
    assert _rel(sam_vit.encode(got, sam_vit.SamViTConfig(
        **dataclasses.asdict(cfg)), torch.from_numpy(img)),
        jsam.encode(want, cfg, jnp.asarray(img))) < 1e-4
