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
leaf of ``like``.  The reference's reshard-on-restore (``shardings=``)
comes with multi-GPU sharding (ROADMAP.md).
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


_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def _leaves(tree: Any, prefix: tuple = ()):
    """``(path, leaf)`` pairs in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], prefix + (str(k),))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        raise TypeError(f"checkpoint leaves must be tensors, got {type(tree)} at {prefix}")


def _rebuild(tree: Any, it) -> Any:
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, k), it) for k in tree._fields))
    return type(tree)(_rebuild(v, it) for v in tree)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    flat = {}
    for path, leaf in _leaves(tree):
        t = leaf.detach()
        if t.dtype.is_floating_point and t.dtype not in _NUMPY_FLOATS:
            t = t.to(torch.float32)  # bf16/f8: npz cannot round-trip them
        flat["/".join(path)] = t.cpu().numpy()
    return flat


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save --

    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        self.wait()
        flat = _flatten(tree)  # device -> host on the caller's thread
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
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def restore(self, step: int | None, like: Any) -> tuple[int, Any]:
        """Restore into the structure of ``like``: each leaf on the device
        and in the dtype of ``like``'s leaf at the same path."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        d = os.path.join(self.directory, f"step-{step:09d}")
        with np.load(os.path.join(d, "arrays.npz")) as arrays:
            leaves = []
            for path, leaf in _leaves(like):
                key = "/".join(path)
                arr = arrays[key]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(leaf.shape)}")
                leaves.append(torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype))
        return step, _rebuild(like, iter(leaves))
