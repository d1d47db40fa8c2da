"""The local model directory: list and delete the checkpoints under it
(``models_dir``, ``model_path``, ``list_models`` and ``delete_model``
copied from ominix_mlx_tpu/utils/hub.py, stdlib only; its
``download_model`` needs the network and is not copied).

The directory is ``root`` where a caller names one, else
``$OMINIX_MODELS_DIR``, else ``~/.ominix/models``.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional


def models_dir(root: Optional[str] = None) -> str:
    d = root or os.environ.get("OMINIX_MODELS_DIR",
                               os.path.expanduser("~/.ominix/models"))
    os.makedirs(d, exist_ok=True)
    return d


def model_path(name: str, root: Optional[str] = None) -> str:
    """Resolve a model name / repo id to a local directory."""
    if os.path.isdir(name):
        return name
    return os.path.join(models_dir(root), name.replace("/", "--"))


def list_models(root: Optional[str] = None) -> List[dict]:
    out = []
    base = models_dir(root)
    for entry in sorted(os.listdir(base)):
        p = os.path.join(base, entry)
        if not os.path.isdir(p):
            continue
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(p) for f in fs)
        out.append({"id": entry.replace("--", "/"), "path": p,
                    "size_bytes": size,
                    "has_config": os.path.exists(os.path.join(p,
                                                              "config.json"))})
    return out


def delete_model(name: str, root: Optional[str] = None) -> bool:
    """Delete a managed model directory. Only names strictly inside
    ``models_dir(root)`` are deletable: paths are canonicalized before the
    comparison, and separators and parent references are refused
    outright."""
    if "\\" in name or ".." in name:
        return False
    name = name.replace("/", "--")  # the hub's repo-id convention
    if "/" in name:
        return False
    p = os.path.realpath(os.path.join(models_dir(root), name))
    top = os.path.realpath(models_dir(root))
    if not os.path.isdir(p) or p == top:
        return False
    if os.path.commonpath([p, top]) != top:
        return False
    shutil.rmtree(p)
    return True
