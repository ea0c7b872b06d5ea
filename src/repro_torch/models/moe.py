"""Mixture-of-experts FFN, DeepSeek-V2/V3 style (counterpart of
``repro.models.moe``).

  * fine-grained routed experts plus shared experts (DeepSeekMoE);
  * two routers: softmax top-k with a load-balance aux loss (V2), and
    sigmoid scores with a learned bias that enters the selection only, the
    gates taking the raw scores (V3, aux-loss-free);
  * capacity-bounded dispatch in groups of ``group_size`` tokens, zero-padded
    at the end: capacity ``max(int(cf * S * k / E), k)``, a (token, choice)
    pair's slot the count of earlier pairs of its group at its expert, pairs
    at or past capacity dropped.  Padded rows route to expert 0 with gate 0,
    take slots after every real token, and count in ``dropped_fraction``, as
    in the reference.

The reference dispatches and combines with one-hot einsums over ``(G, S,
E, C)``; the port gathers and scatters rows by index, which gives the same
result: each expert slot holds at most one token, so the dispatch einsum is
a copy, and the combine sums a token's kept choices (gate rounded to the
model's type times its expert's output) in float32, rounded once to the
model's type.  The experts run as batched products over ``(E, G * C, d)``,
outside any kernel, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L

F32 = torch.float32


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor  # () float32, 0 for ``sigmoid_bias``
    router_z_loss: torch.Tensor  # () float32
    expert_load: torch.Tensor  # (E,) float32: assignments per real token
    dropped_fraction: torch.Tensor  # () float32, padded rows' pairs included


class Router(nn.Module):
    """``{"kernel": (d, E) float32, "bias"?: (E,) float32}``: the router runs
    in float32 whatever the model's type; the bias (``sigmoid_bias`` only)
    gets no gradient and is updated outside the gradient path
    (``update_router_bias``, which the train step calls after AdamW)."""

    def __init__(self, d: int, n_experts: int, *, with_bias: bool, device):
        super().__init__()
        self.kernel = L._param((d, n_experts), F32, device)
        self.bias = L._param((n_experts,), F32, device) if with_bias else None


class Experts(nn.Module):
    """The routed experts' stacked weights ``w_gate``, ``w_up`` ``(E, d,
    d_expert)`` and ``w_down`` ``(E, d_expert, d)``."""

    def __init__(self, n_experts: int, d: int, d_expert: int, *, dtype, device):
        super().__init__()
        self.w_gate = L._param((n_experts, d, d_expert), dtype, device)
        self.w_up = L._param((n_experts, d, d_expert), dtype, device)
        self.w_down = L._param((n_experts, d_expert, d), dtype, device)


class MoE(nn.Module):
    """``init_moe``: ``router``, ``experts`` and, with
    ``n_shared_experts``, ``shared``, an FFN of width ``d_expert *
    n_shared_experts``."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        mo = cfg.moe
        self.cfg = cfg
        self.router = Router(cfg.d_model, mo.n_experts, with_bias=mo.router == "sigmoid_bias",
                             device=device)
        self.experts = Experts(mo.n_experts, cfg.d_model, mo.d_expert, dtype=dtype, device=device)
        self.shared = (L.FFN(cfg.d_model, mo.d_expert * mo.n_shared_experts, cfg.ffn, dtype=dtype,
                             device=device) if mo.n_shared_experts else None)

    def forward(self, x, *, group_size: int = 256):
        return moe_fwd(self, self.cfg, x, group_size=group_size)


def route(p: MoE, cfg, x_flat: torch.Tensor):
    """``_route``: ``(gates (N, k), indices (N, k), scores (N, E), logits
    (N, E))``, all float32 but the indices.  The logits are ``x_flat``
    widened to float32 times the float32 router kernel; the experts are the
    top ``k`` of ``select_scores`` in descending order, and the gates their
    raw scores renormalised to sum to 1 (floor 1e-9)."""
    k = cfg.moe.experts_per_token
    logits = x_flat.to(F32) @ p.router.kernel
    if cfg.moe.router == "sigmoid_bias":
        scores = torch.sigmoid(logits)
        idx = torch.topk(select_scores(p, cfg, scores), k, dim=-1).indices
        w = torch.gather(scores, -1, idx)
    else:
        scores = torch.softmax(logits, dim=-1)
        w, idx = torch.topk(scores, k, dim=-1)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    return w, idx, scores, logits


def select_scores(p: MoE, cfg, scores: torch.Tensor) -> torch.Tensor:
    """What the top-k selection ranks: the scores, plus the bias for
    ``sigmoid_bias``."""
    if cfg.moe.router == "sigmoid_bias":
        return scores + p.router.bias[None, :]
    return scores


class Slots(NamedTuple):
    """The capacity dispatch of ``n`` real tokens' choices ``(N, k)``: ``g``
    groups of ``s`` rows (the last zero-padded), ``capacity`` slots an
    expert and group, and per (group, row * k + choice) pair its expert,
    its slot and whether it is kept (``slot < capacity``)."""

    g: int
    s: int
    capacity: int
    expert: torch.Tensor  # (G, S * k) int64
    slot: torch.Tensor  # (G, S * k) int64
    keep: torch.Tensor  # (G, S * k) bool


def slots(idx: torch.Tensor, cfg, group_size: int = 256) -> Slots:
    """``moe_fwd``'s per-group slot assignment for the choices ``idx (N,
    k)``: padded rows choose expert 0 ``k`` times; a pair's slot is the
    number of earlier pairs (row-major, then by choice) of its group at its
    expert."""
    mo = cfg.moe
    n, k = idx.shape
    e = mo.n_experts
    s = min(group_size, n)
    pad = -n % s
    g = (n + pad) // s
    capacity = max(int(mo.capacity_factor * s * k / e), k)
    expert = F.pad(idx, (0, 0, 0, pad)).reshape(g, s * k)
    onehot = F.one_hot(expert, e)
    slot = torch.sum((torch.cumsum(onehot, dim=1) - onehot) * onehot, dim=-1)
    return Slots(g=g, s=s, capacity=capacity, expert=expert, slot=slot, keep=slot < capacity)


def _mean_exact(total: torch.Tensor, count: int) -> torch.Tensor:
    """A float32 mean of values whose float32 sum ``total`` is exact (counts)
    as XLA evaluates ``jnp.mean``: the sum times the float32 reciprocal of
    the count, so the two agree bit for bit."""
    return total.to(F32) * float(np.float32(1.0 / count))


def moe_fwd(p: MoE, cfg, x: torch.Tensor, *, group_size: int = 256):
    """``(y (B, T, D), MoEAux)`` of the grouped capacity dispatch."""
    mo = cfg.moe
    b, t, d = x.shape
    n = b * t
    e, k = mo.n_experts, mo.experts_per_token
    x_flat = x.reshape(n, d)

    w, idx, scores, logits = route(p, cfg, x_flat)
    sl = slots(idx, cfg, group_size)
    g, s, cap = sl.g, sl.s, sl.capacity
    dropped = 1.0 - _mean_exact(torch.sum(sl.keep), g * s * k)

    # Dispatch: row e * G * C + g * C + slot of the (E, G * C, d) buffer holds
    # the kept pair's token (the reference's (G, E, C, d) -> (E, G * C, d)).
    # Padded rows are zero and may stay unwritten.
    group = torch.arange(g, device=x.device)[:, None].expand(g, s * k)
    dest = (sl.expert * g + group) * cap + sl.slot
    real = (torch.arange(g * s, device=x.device) < n).reshape(g, s).repeat_interleave(k, dim=1)
    take = sl.keep & real
    src = torch.arange(g * s * k, device=x.device).reshape(g, s * k) // k
    xe = x.new_zeros((e * g * cap, d))
    xe[dest[take]] = x_flat[src[take]]
    xe = xe.reshape(e, g * cap, d)

    ex = p.experts
    act = F.silu if cfg.ffn == "swiglu" else L.gelu
    ye = torch.bmm(act(torch.bmm(xe, ex.w_gate)) * torch.bmm(xe, ex.w_up), ex.w_down)

    # Combine: each real token's kept choices, the gate rounded to the
    # model's type, summed in float32.
    keep_n = sl.keep.reshape(g * s, k)[:n]
    rows = ye.reshape(e * g * cap, d)[torch.where(keep_n, dest.reshape(g * s, k)[:n], 0)]
    gate = torch.where(keep_n, w.to(x.dtype), torch.zeros((), dtype=x.dtype, device=x.device))
    y = torch.sum(rows.to(F32) * gate.to(F32)[..., None], dim=1).to(x.dtype)
    if p.shared is not None:
        y = y + p.shared(x_flat)

    # Aux losses over the real tokens.
    load = _mean_exact(torch.bincount(idx.reshape(-1), minlength=e), n)
    if mo.router == "softmax_topk":
        importance = torch.mean(scores, dim=0)
        lb = e * torch.sum(load / k * importance)
    else:
        lb = torch.zeros((), dtype=F32, device=x.device)
    zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = MoEAux(load_balance_loss=lb.to(F32), router_z_loss=zl.to(F32), expert_load=load,
                 dropped_fraction=dropped)
    return y.reshape(b, t, d), aux


@torch.no_grad()
def update_router_bias(p: MoE, cfg, expert_load: torch.Tensor, lr: float = 1e-3) -> None:
    """The V3 aux-loss-free balancer: nudge the routing bias against the load
    skew, in place (outside the gradient path).  ``train.build_train_step``
    calls it for every MoE layer with the layer-averaged ``expert_load``,
    as the reference's step does.  A router without a bias
    (``softmax_topk``) is left as it is."""
    if p.router.bias is None:
        return
    err = expert_load - cfg.moe.experts_per_token / cfg.moe.n_experts
    p.router.bias.copy_(p.router.bias - lr * torch.sign(err))
