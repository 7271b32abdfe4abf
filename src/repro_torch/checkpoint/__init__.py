"""Checkpointing (``repro.checkpoint``): a tree of tensors <-> ``.npz``
with a JSON manifest.

The on-disk format is the JAX package's: an ``.npz`` whose keys are the
leaves' paths joined by "/" (dict keys, sequence indices), and beside it
a ``.json`` manifest holding ``step``, the sorted ``keys`` and ``extra``.
numpy has no bf16, so bf16 tensors are widened to fp32 on save (losslessly)
and cast back to the template's dtype on restore.  Python ints (the
state's host ``round`` counter) are stored as 0-d int64 arrays.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _paths(tree, prefix=()):
    """``(path, leaf)`` pairs of a tree of dicts / tuples / lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _paths(tree)}


def save(path: str, tree, step: int = 0,
         extra: Optional[Dict[str, Any]] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
    manifest_ = {"step": int(step), "keys": sorted(flat),
                 "extra": extra or {}}
    with open(path.removesuffix(".npz") + ".json", "w") as f:
        json.dump(manifest_, f, indent=1)


def _unflatten(like, leaf_fn, prefix=()):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaf_fn, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaf_fn, prefix + (str(i),))
                          for i, v in enumerate(like))
    return leaf_fn("/".join(prefix), like)


def restore(path: str, like, device=None):
    """Restore into the structure of ``like`` (a template tree: tensors,
    ``meta`` tensors included, numpy arrays or Python ints).  Each tensor
    comes back with its template's dtype on ``device`` (default: the
    template's device, which a ``meta`` template must not leave as it
    is)."""
    npz = np.load(path if path.endswith(".npz") else path + ".npz")

    def leaf(key, tmpl):
        arr = npz[key]
        if isinstance(tmpl, torch.Tensor):
            assert arr.shape == tuple(tmpl.shape), (key, arr.shape,
                                                    tuple(tmpl.shape))
            dev = tmpl.device if device is None else torch.device(device)
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=dev, dtype=tmpl.dtype)
        if isinstance(tmpl, np.ndarray):
            assert arr.shape == tmpl.shape, (key, arr.shape, tmpl.shape)
            return arr.astype(tmpl.dtype)
        return type(tmpl)(arr)
    return _unflatten(like, leaf)


def manifest(path: str) -> Dict[str, Any]:
    with open(path.removesuffix(".npz") + ".json") as f:
        return json.load(f)
