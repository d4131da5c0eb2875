"""NumPy-backed checkpoints in the JAX package's layout (torch twin of
``repro/training/checkpoint.py``), so each package reads what the other
writes.

Layout: <dir>/step_<N:08d>/
  manifest.json   — {"step", "dtypes": {path: dtype name}, "treedef"}
  arrays.npz      — flat arrays keyed by path (dict keys joined by "/")
Restores exactly: bfloat16 is stored as a uint16 view of its bits with
dtype "bfloat16" in the manifest. Neither loader reads "treedef"; the port
writes its own description of the tree there.
"""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_paths, tree_unflatten

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str, like: torch.Tensor
                ) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(like.device)


def save_checkpoint(directory: str, step: int, tree) -> str:
    """Write ``tree`` (nested dicts of tensors) as step
    ``step`` under ``directory``; returns the step's directory."""
    out = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(out, exist_ok=True)
    arrays, meta = {}, {}
    for k, v in tree_paths(tree).items():
        arrays[k], meta[k] = _to_numpy(v)
    np.savez(os.path.join(out, "arrays.npz"), **arrays)
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump({"step": step, "dtypes": meta,
                   "treedef": "repro_torch: " + " ".join(meta)}, f)
    return out


def load_checkpoint(directory: str, step: int, template) -> Tuple[Any, int]:
    """Restore step ``step`` into the structure of ``template`` (same
    paths); each tensor lands on its template leaf's device, with the
    dtype that was stored. Returns (tree, step)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = [_from_numpy(data[k], manifest["dtypes"].get(k, ""), like)
                  for k, like in tree_paths(template).items()]
    return tree_unflatten(template, leaves), manifest["step"]


def latest_step(directory: str) -> int:
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    return max(steps)
