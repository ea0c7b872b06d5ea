"""AdamW with global-norm clipping and a configurable state dtype
(counterpart of ``repro.optim.adamw``).

Parameters, gradients and moments are dicts keyed by the model's
parameter names (``dict(model.named_parameters())``).  The update math
runs in float32 whatever the parameter and state types, as in the
reference; parameters are updated in place (the model's own tensors, so a
step allocates no second copy of the weights) and returned.

Weight decay follows the reference's layout, not the port's.  The
reference decays a leaf iff its rank is at least 2, and its decoder-block
leaves are stacked over layers (``blocks``; for ``moe`` ``dense_blocks``
and ``moe_blocks``), so every in-block norm scale is a ``(n_layers, d)``
matrix there and is decayed, and so is the sigmoid router's ``(n_layers,
E)`` bias; only the unstacked norms (``ln_f``, the MTP head's) are exempt.
The hybrid family's Mamba leaves are stacked twice (``(n_groups,
shared_every, ...)``), so every one of them is decayed, ``a_log``,
``dt_bias``, ``d_skip`` and ``out_norm.scale`` too; its ``shared`` block
is not stacked, so its norm scales are not.
The port keeps one module per layer (``blocks.{i}.*``, the norm scale
``(d,)``), so ``reference_ndim`` adds the stacking axis back before the
rank test.

The update runs a leaf of more than ``CHUNK_ELEMENTS`` elements over
slices of its leading axis, and ``global_norm`` sums such a leaf's squares
slice by slice, so their float32 temporaries stay bounded (a routed-expert
matrix of deepseek-v2 holds 1.26 B elements: 5 GB a float32 copy).  The
update is elementwise, so the slices give the same bits as the whole leaf.
The moments are updated in place: the state returned holds the tensors of
the state passed in (one copy of the moments, not two, at any time).

On a model that ``sharding.fsdp.shard_model`` placed on a mesh, the
parameters are this rank's shards and ``adamw_init`` gives moments of the
same shards (the reference's ``opt_sh = (repl, param_sh, param_sh)``);
the update is elementwise, so it runs on the shards unchanged.
``global_norm`` is then the global gradient's (``fsdp.sum_of_squares``:
each ``"model"``-sharded leaf summed over both axes, a leaf the rules
replicate over an axis counted once; the ranks' partial sums reassociate
the one-process sum, so the norm, and with it the clip scale, may differ
from it by float32 ulps past one rank; every rank gets the same bits).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models.transformer import STACK_DEPTH
from repro_torch.sharding import fsdp

F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Leaves larger than this run over slices of their leading axis (each slice
# at least one row): 128 MiB a float32 temporary.
CHUNK_ELEMENTS = 1 << 25


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


def _slices(x: torch.Tensor):
    """``x`` whole, or over slices of its leading axis of at most
    ``CHUNK_ELEMENTS`` elements (at least one row) if it is larger."""
    if x.numel() <= CHUNK_ELEMENTS:
        yield ...
        return
    rows = max(1, CHUNK_ELEMENTS // x[0].numel())
    for i in range(0, x.shape[0], rows):
        yield slice(i, i + rows)


def global_norm(tree: dict, params: dict) -> torch.Tensor:
    """``sqrt(sum of squares)`` of every leaf, in float32 (a large leaf
    summed slice by slice), ``tree`` the gradients of ``params`` by name:
    of a sharded model, the global gradient's (``fsdp.sum_of_squares``)."""
    return torch.sqrt(fsdp.sum_of_squares(tree, params, _slices))


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The rank of parameter ``name`` in the reference's parameter tree,
    where the leaves of ``transformer.STACKS`` (``blocks.{i}.*``,
    ``dense_blocks.{i}.*``, ``moe_blocks.{i}.*``, the encoder-decoder's
    ``enc_blocks.{i}.*`` and ``dec_blocks.{i}.*``) are stacked on a leading
    layer axis and the hybrid ``groups.{g}.{k}.*`` on two (the MTP head's
    and the hybrid ``shared.*`` are not): a stacked layernorm scale is
    decayed, ``ln_f``'s is not."""
    return p.ndim + STACK_DEPTH.get(name.partition(".")[0], 0)


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
    reference's layout are decayed (``reference_ndim``).  Parameters and
    moments are updated in place, a large leaf slice by slice."""
    gnorm = global_norm(grads, params)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    stepf = step.to(F32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=F32, device=gnorm.device)
    for name, p in params.items():
        decay = reference_ndim(name, p) >= 2
        for s in _slices(p):
            pp, m, v = p[s], state.m[name][s], state.v[name][s]
            g32 = grads[name][s].to(F32) * scale
            m32 = cfg.b1 * m.to(F32) + (1 - cfg.b1) * g32
            v32 = cfg.b2 * v.to(F32) + (1 - cfg.b2) * torch.square(g32)
            delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
            if decay:
                delta = delta + cfg.weight_decay * pp.to(F32)
            pp.copy_(pp.to(F32) - lr * delta)
            m.copy_(m32)
            v.copy_(v32)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics
