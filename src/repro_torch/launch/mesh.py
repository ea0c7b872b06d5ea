"""Process worlds and production meshes.

Port of ``repro.launch.mesh``.  Functions, not module-level constants:
importing this module starts no process group.  Nothing on a machine
tells a program of its cluster, so ``init_world`` takes the rendezvous
(``init_method``, e.g. ``tcp://localhost:<port>`` or a ``file://`` path),
the world size and the rank, and always an explicit backend: nccl for
``cuda`` unless the caller asks for gloo (ranks that share one card: nccl
refuses two ranks on one device), gloo for ``cpu``.
"""
from __future__ import annotations

import datetime
import math

import torch

from repro_torch.sharding.rules import make_mesh

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# Bounds the rendezvous and every collective, so a rank that dies fails its
# peers instead of hanging them.
TIMEOUT_S = 120.0


def init_world(rank: int, world_size: int, init_method: str, *, device_type: str = "cuda",
               backend: str | None = None) -> str:
    """Join the default process group as ``rank`` of ``world_size``;
    returns the backend.  On ``cuda`` each rank takes card ``rank % cards``
    (every rank the one card when ranks share it).  Collectives time out
    after ``TIMEOUT_S``."""
    import torch.distributed as dist

    if device_type not in _BACKENDS:
        raise ValueError(f"device_type {device_type!r} (expected 'cuda' or 'cpu')")
    backend = _BACKENDS[device_type] if backend is None else backend
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return backend


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16 x 16 = 256 ranks (``("data", "model")``), or 2 x 16 x 16 = 512 over
    two pods (``("pod", "data", "model")``).  DP runs over ("pod", "data"):
    cross-pod traffic is only the gradient reduction over the pod axis;
    TP/EP stay inside a pod on "model"."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world, need = _world_size(), math.prod(shape)
    if world != need:
        raise ValueError(f"the production mesh {shape} needs a world of {need} ranks; this "
                         f"one has {world}")
    return make_mesh(shape, axes, device_type=device_type)


def make_host_mesh(model_parallel: int = 1, *, device_type: str = "cuda"):
    """A ``(world // mp, mp)`` ``("data", "model")`` mesh over the world
    there is, ``mp = min(model_parallel, world)``."""
    n = _world_size()
    mp = min(model_parallel, n)
    return make_mesh((n // mp, mp), ("data", "model"), device_type=device_type)
