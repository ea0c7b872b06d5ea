"""Checkpointing: atomic, async, in the reference's format (counterpart of
``repro.train.checkpoint``).

* **atomic**: write to ``<dir>/tmp-<step>`` then ``os.replace`` to
  ``<dir>/step-<step:09d>``, so a crash mid-write never corrupts the
  latest checkpoint (restore scans for the newest complete directory);
* **async**: the device-to-host copy happens on the caller's thread, the
  serialisation and fsync on a background thread; ``wait()`` joins it
  before the next save or at exit;
* **retention**: keep the last ``keep`` checkpoints;
* **format**: one ``manifest.json`` (step, per-leaf shapes and dtypes) and
  one ``arrays.npz`` of the flattened leaves keyed by their path, with
  bf16 leaves stored as float32 (npz has no bf16).

A tree is nested dicts, tuples/lists and NamedTuples of tensors; dict
keys are the port's names (parameters: ``dict(model.named_parameters())``
keys), so a path reads ``0/blocks.3.attn.wq.kernel`` or ``1/m/...``.
Restore places every leaf on the device and in the dtype of the matching
leaf of ``like``.

Sharded worlds (``sharding.fsdp``): ``shardings=`` is a tree of
``rules.DataShard`` shaped as the tree, each leaf's placement on the
``"data"`` and ``"model"`` axes (``fsdp.shardings(model, opt_state)`` for
``(params, opt_state)``).  ``save(..., shardings=)`` gathers every sharded
leaf whole on the caller's thread (along its data dim, then its model dim;
every rank takes part), and rank 0 of both axes writes the same
``arrays.npz`` layout as a one-process save; the other ranks write
nothing and every rank waits at a barrier over each axis in ``wait()``
(``blocking=True`` waits at once).  ``restore(..., shardings=)`` is the
reference's reshard-on-restore: each rank reads the whole leaves and
keeps its chunk along each leaf's data and model dims, whatever world and
layout wrote them.  A checkpoint is one layout for every world: saved on
a ``(1, 2)`` mesh it restores into ``(2, 1)``, ``(1, 1)`` and ``(2, 2)``
ones, and the other way round, bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.sharding import rules
from repro_torch.sharding.rules import DataShard


_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def _leaves(tree: Any, prefix: tuple = (), leaf=torch.Tensor):
    """``(path, leaf)`` pairs in a fixed order (the leaves instances of
    ``leaf``)."""
    if isinstance(tree, leaf):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], prefix + (str(k),), leaf)
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), prefix + (k,), leaf)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),), leaf)
    else:
        raise TypeError(f"checkpoint leaves must be {leaf.__name__}, got {type(tree)} at "
                        f"{prefix}")


def _placements(tree: Any, shardings: Any) -> list:
    """The ``DataShard`` of each leaf of ``tree`` that is split over either
    axis, from the same path of ``shardings``; None for a whole leaf
    (every leaf without ``shardings``)."""
    paths = [p for p, _ in _leaves(tree)]
    if shardings is None:
        return [None] * len(paths)
    by_path = dict(_leaves(shardings, leaf=DataShard))
    missing = [p for p in paths if p not in by_path]
    if missing:
        raise ValueError(f"no sharding for the leaf {'/'.join(missing[0])}")
    return [by_path[p] if by_path[p].split else None for p in paths]


def _rebuild(tree: Any, it) -> Any:
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, k), it) for k in tree._fields))
    return type(tree)(_rebuild(v, it) for v in tree)


def _flatten(tree: Any, shardings: Any = None, keep: bool = True) -> dict[str, np.ndarray]:
    """``{path: whole leaf on the host}``; a sharded leaf gathered whole
    first (a collective: every rank calls it).  With ``keep=False`` the
    leaves are gathered and dropped (a rank that does not write)."""
    flat = {}
    for (path, leaf), place in zip(_leaves(tree), _placements(tree, shardings)):
        t = leaf.detach()
        if place is not None:
            # gloo gathers host tensors natively (CUDA ones it copies through
            # the host both ways); nccl gathers on the device
            for dim, group in ((place.dim, place.group),
                               (place.model_dim, place.model and place.model.group)):
                if dim is not None:
                    t = rules.all_gather_dim(t if rules.nccl(group) else t.cpu(), dim, group)
        if not keep:
            continue
        if t.dtype.is_floating_point and t.dtype not in _NUMPY_FLOATS:
            t = t.to(torch.float32)  # bf16/f8: npz cannot round-trip them
        flat["/".join(path)] = t.cpu().numpy()
    return flat


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._barrier = ()  # the axes' groups after a sharded save
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save --

    def save(self, step: int, tree: Any, *, blocking: bool = False,
             shardings: Any = None) -> None:
        """Save ``tree`` as step ``step`` (in the background unless
        ``blocking``).  With ``shardings`` (a sharded world; every rank
        calls it) the leaves are gathered whole and rank 0 of the data
        axis writes them."""
        self.wait()
        writes = True
        if shardings is not None:
            axis = next(s for _, s in _leaves(shardings, leaf=DataShard))
            model = axis.model
            self._barrier = (axis.group,) + (() if model is None else (model.group,))
            writes = axis.rank == 0 and (model is None or model.rank == 0)
        flat = _flatten(tree, shardings, writes)  # device -> host on the caller's thread
        if not writes:
            if blocking:
                self.wait()
            return
        manifest = {
            "step": int(step),
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in flat.items()},
        }

        def write():
            tmp = os.path.join(self.directory, f"tmp-{step}")
            final = os.path.join(self.directory, f"step-{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):  # a re-save of the same step
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the background write; after a sharded save, every rank
        then waits for the others (a barrier on the data axis, then one on
        the model axis: each rank has then seen every rank arrive)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist

            groups, self._barrier = self._barrier, ()
            for group in groups:
                dist.barrier(group=group)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step-{s:09d}"), ignore_errors=True)

    # ---------------------------------------------------------- restore --

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step-(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None, like: Any, *,
                shardings: Any = None) -> tuple[int, Any]:
        """Restore into the structure of ``like``: each leaf on the device
        and in the dtype of ``like``'s leaf at the same path.  With
        ``shardings`` (a ``DataShard`` tree shaped as ``like``) each
        leaf is this rank's chunk along its data and model dims, ``like``'s
        leaves the shards (reshard-on-restore: any world's checkpoint).  A save
        still in flight is waited for first."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        d = os.path.join(self.directory, f"step-{step:09d}")
        with np.load(os.path.join(d, "arrays.npz")) as arrays:
            leaves = []
            for (path, leaf), place in zip(_leaves(like), _placements(like, shardings)):
                key = "/".join(path)
                arr = arrays[key]
                if place is not None:
                    model = place.model
                    for dim, n, rank in ((place.dim, place.size, place.rank),
                                         (place.model_dim, model and model.size,
                                          model and model.rank)):
                        if dim is None:
                            continue
                        if arr.ndim <= dim or arr.shape[dim] % n:
                            raise ValueError(f"{key}: {arr.shape} does not split over {n} "
                                             f"ranks along dim {dim}")
                        arr = np.split(arr, n, axis=dim)[rank]
                    arr = np.ascontiguousarray(arr)
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(leaf.shape)}")
                leaves.append(torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype))
        return step, _rebuild(like, iter(leaves))
