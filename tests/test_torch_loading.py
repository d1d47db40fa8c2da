"""The port's checkpoint reader and writer (``utils.loading``) against the
``safetensors`` package, both ways, for every dtype the loader takes (bf16
bit for bit), a sharded index, the canonical flatten / unflatten round
trip, and MLX's packed uint32 weights (``core.quant.from_mlx_arrays``)
bit-equal to the JAX package's on the same words."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core import quant as jquant
from ominix_mlx_tpu_torch.core import quant as tquant
from ominix_mlx_tpu_torch.utils import loading

torch.set_num_threads(2)


def _tensors(seed=0):
    """One small tensor of every dtype the loader takes, with values at
    the ends of each range (U32 words above 2^31 among them)."""
    g = torch.Generator().manual_seed(seed)
    return {
        "a.bf16": torch.randn(3, 5, generator=g).bfloat16(),
        "b.f16": torch.randn(7, generator=g).half(),
        "c.f32": torch.randn(2, 3, 4, generator=g),
        "d.i8": torch.tensor([-128, -1, 0, 1, 127], dtype=torch.int8),
        "e.u8": torch.tensor([0, 1, 128, 255], dtype=torch.uint8),
        "f.i32": torch.tensor([[-2 ** 31, -1], [0, 2 ** 31 - 1]],
                              dtype=torch.int32),
        "g.u32": torch.tensor([0, 1, 2 ** 31 - 1, -2 ** 31, -1],
                              dtype=torch.int32).view(torch.uint32),
        "h.i64": torch.tensor([-2 ** 63, 0, 2 ** 63 - 1],
                              dtype=torch.int64),
        "i.scalar": torch.tensor(1.5, dtype=torch.float32),
    }


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    words = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
             torch.float32: torch.int32, torch.uint32: torch.int32}
    if a.dtype in words:
        a, b = a.view(words[a.dtype]), b.view(words[b.dtype])
    return torch.equal(a, b)


def test_writer_is_read_by_safetensors(tmp_path):
    from safetensors import safe_open

    ts = _tensors()
    path = str(tmp_path / "w.safetensors")
    loading.save_safetensors(path, ts)
    with safe_open(path, framework="pt") as f:
        assert set(f.keys()) == set(ts)
        for k, t in ts.items():
            assert _same(f.get_tensor(k), t), k


def test_reader_reads_safetensors_files(tmp_path):
    from safetensors.torch import save_file

    ts = _tensors(1)
    path = str(tmp_path / "r.safetensors")
    save_file(ts, path, metadata={"format": "pt"})
    got = loading.read_safetensors(path)
    assert set(got) == set(ts)
    for k, t in ts.items():
        assert _same(got[k], t), k
    only = loading.read_safetensors(path, filter_fn=lambda n: "bf16" in n)
    assert list(only) == ["a.bf16"]


def test_reader_rejects_a_dtype_it_does_not_take(tmp_path):
    from safetensors.torch import save_file

    path = str(tmp_path / "x.safetensors")
    save_file({"x": torch.zeros(2, dtype=torch.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        loading.read_safetensors(path)


def test_round_trip_through_the_port_keeps_bits(tmp_path):
    ts = _tensors(2)
    path = str(tmp_path / "p.safetensors")
    loading.save_safetensors(path, ts)
    got = loading.read_safetensors(path, device="cpu")
    for k, t in ts.items():
        assert _same(got[k], t), k


def test_sharded_index_is_walked(tmp_path):
    """``save_sharded`` writes two shards and an index; the loader walks
    the index and returns every tensor, and the safetensors package reads
    each shard."""
    from safetensors import safe_open

    g = torch.Generator().manual_seed(3)
    flat = {f"model.layers.{i}.w": torch.randn(8, 4, generator=g).bfloat16()
            for i in range(6)}
    loading.save_sharded(str(tmp_path), flat, shards=2)
    files = loading.list_safetensor_files(str(tmp_path))
    assert [os.path.basename(f) for f in files] == [
        "model-00001-of-00002.safetensors",
        "model-00002-of-00002.safetensors"]
    with open(tmp_path / "model.safetensors.index.json") as f:
        wm = json.load(f)["weight_map"]
    assert set(wm) == set(flat) and len(set(wm.values())) == 2
    got = loading.load_safetensors(str(tmp_path))
    assert set(got) == set(flat)
    for k in flat:
        assert _same(got[k], flat[k])
    n = 0
    for path in files:
        with safe_open(path, framework="pt") as f:
            for k in f.keys():
                assert _same(f.get_tensor(k), flat[k])
                n += 1
    assert n == len(flat)


def test_cpu_load_is_a_view_of_the_file(tmp_path):
    """On the CPU the loaded tensor shares the mapped file's pages (a
    copy-on-write mapping): writing it leaves the file as it was."""
    path = str(tmp_path / "v.safetensors")
    t = torch.arange(16, dtype=torch.float32)
    loading.save_safetensors(path, {"t": t})
    got = loading.read_safetensors(path)["t"]
    assert torch.equal(got, t)
    got.zero_()
    assert torch.equal(loading.read_safetensors(path)["t"], t)


@pytest.mark.parametrize("tree", [
    {"embed": torch.ones(2, 2), "layers": [{"w": torch.zeros(3)},
                                           {"w": torch.ones(3)}],
     "norm": torch.full((2,), 2.0)},
    {"a": {"b": {"c": torch.arange(4)}}, "d": [torch.zeros(1)] * 11},
])
def test_flatten_unflatten_round_trip(tree, tmp_path):
    flat = loading.flatten_params(tree)
    assert all(isinstance(k, str) and not k.endswith(".") for k in flat)
    back = loading.unflatten_params(flat)

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return len(a) == len(b) and all(map(same, a, b))
        return torch.equal(a, b)

    assert same(tree, back)
    loading.save_model(str(tmp_path), {"model_type": "x"}, tree)
    cfg, loaded = loading.load_canonical(str(tmp_path), device="cpu")
    assert cfg == {"model_type": "x"} and same(tree, loaded)


@pytest.mark.parametrize("bits", [4, 8])
def test_from_mlx_arrays_equals_the_jax_package(bits):
    """The same MLX words (from the JAX package's ``quantize``) through
    both ``from_mlx_arrays``: codes, scales and biases bit-equal; and the
    port's ``pack_codes`` writes those words from its own ``quantize``."""
    g = np.random.default_rng(bits)
    w = g.standard_normal((24, 128)).astype(np.float32)
    packed, scales, biases = jquant.quantize(jnp.asarray(w), 32, bits)
    jq = jquant.from_mlx_arrays(packed, scales, biases, 32, bits)
    words = np.asarray(packed)
    assert words.dtype == np.uint32 and (words >= 2 ** 31).any()
    tq = tquant.from_mlx_arrays(
        torch.from_numpy(np.array(words.view(np.int32))).view(torch.uint32),
        torch.from_numpy(np.asarray(scales)),
        torch.from_numpy(np.asarray(biases)), 32, bits)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.biases.numpy(), np.asarray(jq.biases))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(
        tquant.unpack_to_int8(torch.from_numpy(np.array(words.view(np.int32))), bits)
        .numpy(), np.asarray(jquant.unpack_to_int8(packed, bits)))
    codes, _, _ = tquant.quantize(torch.from_numpy(w), 32, bits)
    np.testing.assert_array_equal(
        tquant.pack_codes(codes, bits).view(torch.int32).numpy(),
        words.view(np.int32))
    # the dequantize-then-product path of a plain QuantizedTensor
    x = g.standard_normal((3, 128)).astype(np.float32)
    want = jquant.quantized_matmul(jnp.asarray(x), jq, dtype=jnp.float32)
    got = tquant.quantized_matmul(torch.from_numpy(x), tq, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
