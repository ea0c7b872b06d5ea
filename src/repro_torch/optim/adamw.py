"""AdamW with global-norm clipping and a configurable state dtype
(counterpart of ``repro.optim.adamw``).

Parameters, gradients and moments are dicts keyed by the model's
parameter names (``dict(model.named_parameters())``).  The update math
runs in float32 whatever the parameter and state types, as in the
reference; parameters are updated in place (the model's own tensors, so a
step allocates no second copy of the weights) and returned.

Weight decay follows the reference's layout, not the port's.  The
reference decays a leaf iff its rank is at least 2, and its decoder-block
leaves are stacked over layers, so every in-block norm scale is a
``(n_layers, d)`` matrix there and is decayed; only the unstacked final
norm is exempt.  The port keeps one module per layer (``blocks.{i}.*``,
the norm scale ``(d,)``), so ``reference_ndim`` adds the stacking axis
back before the rank test.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"  # "bfloat16" for huge models


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: dict
    v: dict


def adamw_init(params: dict, cfg: AdamWConfig) -> AdamWState:
    """Zero moments in ``cfg.state_dtype`` beside each parameter."""
    dt = _DTYPES[cfg.state_dtype]
    dev = next(iter(params.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={n: zeros(p) for n, p in params.items()},
        v={n: zeros(p) for n, p in params.items()},
    )


def global_norm(tree: dict) -> torch.Tensor:
    """``sqrt(sum of squares)`` of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32))) for x in tree.values()))


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The rank of parameter ``name`` in the reference's parameter tree,
    where the ``blocks.{i}.*`` leaves are stacked on a leading layer axis."""
    return p.ndim + (1 if name.startswith("blocks.") else 0)


@torch.no_grad()
def adamw_update(
    grads: dict,
    state: AdamWState,
    params: dict,
    cfg: AdamWConfig,
    lr_scale: torch.Tensor | float = 1.0,
) -> tuple[dict, AdamWState, dict]:
    """One clipped AdamW step; returns ``(params, state, metrics)`` with
    ``grad_norm`` (before clipping) and ``lr``.  Matrices in the
    reference's layout are decayed (``reference_ndim``)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    stepf = step.to(F32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=F32, device=gnorm.device)
    dt = _DTYPES[cfg.state_dtype]
    new_m, new_v = {}, {}
    for name, p in params.items():
        g32 = grads[name].to(F32) * scale
        m32 = cfg.b1 * state.m[name].to(F32) + (1 - cfg.b1) * g32
        v32 = cfg.b2 * state.v[name].to(F32) + (1 - cfg.b2) * torch.square(g32)
        delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        if reference_ndim(name, p) >= 2:
            delta = delta + cfg.weight_decay * p.to(F32)
        p.copy_(p.to(F32) - lr * delta)
        new_m[name], new_v[name] = m32.to(dt), v32.to(dt)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, m=new_m, v=new_v), metrics
