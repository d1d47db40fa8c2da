"""Checkpoint loading: HF config.json and (sharded) safetensors
(counterpart of ominix_mlx_tpu/utils/loading.py; the index walk of
``list_safetensor_files`` and the canonical save / load are copied from
there).

The safetensors format is read and written here with the standard
library, numpy and torch, so that serving needs no ``safetensors``
package: an 8-byte little-endian header length, a JSON
header {name: {"dtype", "shape", "data_offsets"}} (offsets from the end of
the header), then the raw little-endian bytes. A shard is mapped into
memory copy-on-write, so a tensor loaded onto the CPU is a view of the
file and one loaded onto the card is copied there from the mapped pages:
a checkpoint is never held twice in host memory. bf16 travels as its raw
16-bit words, never through float32.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Callable, Dict, Optional

import numpy as np
import torch

# safetensors dtype -> (numpy type of the stored words, torch type)
_DTYPES = {
    "BF16": (np.int16, torch.bfloat16),
    "F16": (np.float16, torch.float16),
    "F32": (np.float32, torch.float32),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "I32": (np.int32, torch.int32),
    "U32": (np.int32, torch.uint32),
    "I64": (np.int64, torch.int64),
}
_NAMES = {tt: name for name, (_, tt) in _DTYPES.items()}
# torch types whose words numpy reads as another type of the same width
_WORDS = {torch.bfloat16: torch.int16, torch.uint32: torch.int32}


def load_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def list_safetensor_files(model_dir: str):
    """The shards of a checkpoint: those named by
    ``model.safetensors.index.json``, else ``model.safetensors``, else
    every ``*.safetensors`` in the directory."""
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            meta = json.load(f)
        files = sorted(set(meta["weight_map"].values()))
        return [os.path.join(model_dir, f) for f in files]
    single = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(single):
        return [single]
    return sorted(
        os.path.join(model_dir, f) for f in os.listdir(model_dir)
        if f.endswith(".safetensors"))


def read_header(path: str):
    """(header dict without "__metadata__", offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_safetensors(path: str,
                     filter_fn: Optional[Callable[[str], bool]] = None,
                     device=None) -> Dict[str, torch.Tensor]:
    """One shard -> {name: tensor}. With ``device`` None or the CPU the
    tensors are views of the file mapped copy-on-write; any other device
    gets a copy of each, made from the mapped pages."""
    header, start = read_header(path)
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    out = {}
    for name, meta in header.items():
        if filter_fn is not None and not filter_fn(name):
            continue
        if meta["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{meta['dtype']}, not one of {sorted(_DTYPES)}")
        words, tt = _DTYPES[meta["dtype"]]
        shape = tuple(meta["shape"])
        begin, end = meta["data_offsets"]
        n = int(np.prod(shape, dtype=np.int64))
        if end - begin != n * np.dtype(words).itemsize:
            raise ValueError(f"{path}: tensor {name!r} holds {end - begin} "
                             f"bytes, want {n} x {meta['dtype']}")
        off = start + begin
        if off % np.dtype(words).itemsize:       # not aligned: copy it
            a = np.frombuffer(mm[off:off + end - begin].tobytes(), words)
        else:
            a = np.ndarray((n,), dtype=words, buffer=mm, offset=off)
        t = torch.from_numpy(a)
        if tt in _WORDS:
            t = t.view(tt)
        t = t.reshape(shape)
        if device is not None:
            t = t.to(device)
        out[name] = t
    return out


def load_safetensors(model_dir: str,
                     filter_fn: Optional[Callable[[str], bool]] = None,
                     device=None) -> Dict[str, torch.Tensor]:
    """Every shard of ``model_dir`` into one flat {name: tensor} dict, on
    ``device`` (None: views of the mapped files on the CPU)."""
    out: Dict[str, torch.Tensor] = {}
    for path in list_safetensor_files(model_dir):
        out.update(read_safetensors(path, filter_fn, device))
    return out


def _words(t: torch.Tensor) -> np.ndarray:
    """The little-endian words of a tensor, on the host."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype in _WORDS:
        t = t.view(_WORDS[t.dtype])
    return t.numpy()


def save_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                     metadata: Optional[Dict[str, str]] = None):
    """Write {name: tensor} as one safetensors file, one tensor at a time
    copied to the host. The data are packed without gaps (the format's
    rule) in order of element size, widest first, then name, so every
    tensor starts aligned to its element size."""
    order = sorted(tensors, key=lambda n: (-tensors[n].element_size(), n))
    header, offset = {}, 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} is not one "
                             f"of {sorted(map(str, _NAMES))}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = dict(metadata)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            f.write(memoryview(_words(tensors[name]).reshape(-1)).cast("B"))


def save_sharded(model_dir: str, flat: Dict[str, torch.Tensor],
                 shards: int = 2):
    """Write ``flat`` as ``shards`` files of about equal size plus the
    ``model.safetensors.index.json`` that maps each name to its file."""
    names = sorted(flat)
    total = sum(flat[n].numel() * flat[n].element_size() for n in names)
    groups, acc = [[] for _ in range(shards)], 0
    for n in names:
        groups[min(shards - 1, acc * shards // max(total, 1))].append(n)
        acc += flat[n].numel() * flat[n].element_size()
    weight_map = {}
    for i, group in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        save_safetensors(os.path.join(model_dir, fname),
                         {n: flat[n] for n in group})
        weight_map.update({n: fname for n in group})
    with open(os.path.join(model_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=1)


# ------------------------------------------------ canonical save / load -----
#
# Every family can round-trip its parameter tree through one canonical
# on-disk form: flat dotted names in safetensors beside config.json.

def flatten_params(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts / lists of tensors -> flat {dotted.name: tensor}."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        if tree is not None:
            out[prefix.rstrip(".")] = torch.as_tensor(tree)
        return out
    for k, v in items:
        out.update(flatten_params(v, f"{prefix}{k}."))
    return out


def unflatten_params(flat: Dict[str, torch.Tensor]):
    """Inverse of ``flatten_params``: dict levels whose keys are all
    integers become lists."""
    root: dict = {}
    for name, v in flat.items():
        parts = name.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [fix(node[str(i)]) for i in range(len(keys))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def save_model(model_dir: str, config: dict, params,
               filename: str = "model.safetensors"):
    """Write config.json and the flattened parameter tree."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    save_safetensors(os.path.join(model_dir, filename),
                     flatten_params(params))


def load_canonical(model_dir: str, device=None):
    """-> (config dict, nested params) from the canonical form."""
    return load_config(model_dir), unflatten_params(
        load_safetensors(model_dir, device=device))
