"""Tensor trees: NamedTuples, tuples, lists and dataclasses of tensors."""
from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, x):
    """``x`` with ``fn`` applied to every tensor leaf of its NamedTuples,
    tuples, lists and dataclasses."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(
            x, **{f.name: tree_map(fn, getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def tree_leaves(x) -> list[torch.Tensor]:
    """``x``'s tensor leaves in ``tree_map`` order."""
    out = []
    tree_map(out.append, x)
    return out
