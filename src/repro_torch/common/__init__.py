"""Shared utilities: dtypes, device resolution and helpers over nested
dict/tuple trees of tensors (the port's counterpart of JAX pytrees)."""
from __future__ import annotations

from typing import Callable

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def resolve_device(device) -> torch.device:
    """``torch.device`` of ``device``; a CUDA device with no card raises —
    the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over nested dicts / tuples / lists; every tree
    in ``rest`` must have the structure of ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def bytes_of(tree) -> int:
    """Total bytes of all tensors (real or ``meta`` shape specs) in a tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def count_params(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree))
