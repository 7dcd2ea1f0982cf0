"""Checkpointing: a flattened tree in ``.npz`` with a JSON manifest.

The counterpart of ``repro.checkpoint.io``, file for file and key for key:
``ckpt_%08d.npz`` holds one array per leaf under the JAX package's path
string (each path entry as JAX prints it — ``['y']`` for a dict key, ``[0]``
for a list item — joined by ``::``), bf16 stored as f32, and
``ckpt_%08d.json`` the step, the sorted keys and ``extra``. So a checkpoint
written by either package restores in the other. Trees are
``torch.utils._pytree`` trees (dicts, lists, tuples) of tensors or anything
``numpy.asarray`` takes; leaves are copied to the host to be written.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

Tree = Any
_SEP = "::"


def _key(path) -> str:
    """A leaf's key: its path entries as both packages print them
    (``['y']``, ``[0]``), joined by ``::``."""
    return _SEP.join(str(k) for k in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:  # numpy .npz can't store bf16
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def save(path: str, step: int, tree: Tree, extra: dict | None = None) -> str:
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    flat = {_key(p): _to_numpy(v)
            for p, v in pytree.tree_flatten_with_path(tree)[0]}
    np.savez(fname, **flat)
    manifest = {"step": step, "keys": sorted(flat), "extra": extra or {}}
    with open(os.path.join(path, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump(manifest, f)
    return fname


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def load_pytree(path: str, step: int) -> dict[str, np.ndarray]:
    with np.load(os.path.join(path, f"ckpt_{step:08d}.npz")) as z:
        return {k: z[k] for k in z.files}


def restore(path: str, step: int, template: Tree) -> Tree:
    """Restore into the structure of ``template``, a tree of tensors: each
    leaf takes the template leaf's dtype and device (shapes checked)."""
    flat = load_pytree(path, step)
    paths, spec = pytree.tree_flatten_with_path(template)
    leaves = []
    for p, leaf in paths:
        key = _key(p)
        arr = flat[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        leaves.append(torch.from_numpy(arr).to(device=leaf.device,
                                               dtype=leaf.dtype))
    return pytree.tree_unflatten(leaves, spec)
