"""Public kernel API with device dispatch.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version (``ref``).  ``force`` overrides: ``"ref"`` runs the
plain version on any device (``chip_smoke.py`` holds the kernels against
it on the card), ``"cuda"`` demands the kernel and raises for CPU tensors.
There is no fallback: a kernel that fails to build or launch raises.
``with ops.forced("ref"):`` sets the default ``force`` of every call made
inside it (in this thread or task), so a whole model step can run its
plain versions on the card for comparison.  The setting is a context
variable, which autograd's backward thread does not see: code that reruns
a forward from the backward pass (activation checkpointing) reads
``current_mode()`` when it first runs and re-enters it.

``rmsnorm`` and ``attention`` are differentiable on every path: the plain
versions under autograd, the kernels through ``torch.autograd.Function``s
whose backward runs on the card too (the flash-attention backward
kernels; the plain rmsnorm gradient, as the reference has no rmsnorm
backward kernel).  ``rwkv6_scan`` is differentiable through its plain
versions, which a recording autograd graph takes on every device (the
reference's training route: its kernel has no gradient either).

The kernel-level entry of the hardware path and the burn baseline:
``lc_filter`` (the LC filter over a trace), ``pdu_sim`` (the fused ESS +
SoC + LC path over a trace, unweighted or with an ``(R,)`` or ``(T, R)``
ESS availability weight) and ``gemm_burn`` (the burn GEMM with a FLOP
knob).  None of the three is differentiable on the kernel route (the
reference's kernels have no ``custom_vjp`` either, and no training path
reaches them): on the card they raise under a recording autograd graph;
their plain versions are ordinary PyTorch code.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import (
    admm_step as _ad, flash_attention as _fa, gemm_burn as _gb, lc_filter as _lc, pdu_health as _ph,
    pdu_sim as _ps, ref as _ref, rmsnorm as _rn, rwkv6_scan as _rw,
)

_FORCED: contextvars.ContextVar[str | None] = contextvars.ContextVar("force", default=None)
_ALGORITHM: contextvars.ContextVar[str] = contextvars.ContextVar("algorithm", default="auto")


@contextlib.contextmanager
def forced(mode: str | None, *, algorithm: str = "auto"):
    """Make ``mode`` (``"ref"``, ``"cuda"`` or None) the ``force`` of every
    ``ops`` call inside the block that does not pass its own, and
    ``algorithm`` that of every ``rwkv6_scan`` call left at ``"auto"``."""
    _check_algorithm(algorithm)
    token, atoken = _FORCED.set(mode), _ALGORITHM.set(algorithm)
    try:
        yield
    finally:
        _FORCED.reset(token)
        _ALGORITHM.reset(atoken)


def _check_algorithm(algorithm: str) -> None:
    if algorithm not in ("auto", "sequential"):
        raise ValueError(f"algorithm must be 'auto' or 'sequential', got {algorithm!r}")


def current_mode() -> str | None:
    """The ``force`` that ``forced`` set for this context (None if unset)."""
    return _FORCED.get()


def current_algorithm() -> str:
    """The ``rwkv6_scan`` algorithm that ``forced`` set for this context
    (``"auto"`` if unset)."""
    return _ALGORITHM.get()


def _records_graph(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _use_kernel(t: torch.Tensor, force: str | None) -> bool:
    if force is None:
        force = _FORCED.get()
    if force == "ref":
        return False
    if force == "cuda":
        if t.device.type != "cuda":
            raise ValueError("force='cuda' needs CUDA tensors")
        return True
    if force is None:
        return t.device.type == "cuda"
    raise ValueError(f"force must be None, 'ref' or 'cuda', got {force!r}")


def pdu_health_sim(
    rack_power, g0, soc0, x0, ad, bd, c_row, *, health=None, rack_span=None, guard=False,
    force=None, ess_on=None, ess_events=None, ess_edge=1, **kw,
):
    """One controller interval of the rack hardware path for every rack
    (ESS + SoC + LC, command slew via ``slew=(applied, target)`` or a dense
    ``corrective``, wear fold via ``health=(step_consts, state_leaves)``,
    its block sums of campus columns ``rack_span=(lo, n)`` when given);
    see ``ref.pdu_health_sim`` and ``ref.block_sums``.  The ESS availability weight is ``ess_on``
    (an ``(R,)`` row or a ``(T, R)`` series) or ``ess_events=(starts, ends,
    base, i0, t_last)`` with ``ess_edge``, rendered per sample from the
    fault schedule's ``(E, R)`` int32 episode tables; the kernel has a mode
    for each.

    ``guard=True`` (safe mode's output guard) replaces every non-finite
    sample of the grid trace with the rack sample passed in, so the
    grid-facing waveform degrades to passthrough instead of exporting NaN;
    one ``torch.where`` after either route, the identity on finite outputs.
    The carried machine state is not guarded: the sanitizer quarantines the
    rack from it at the next interval."""
    if ess_on is not None:
        ess_on = ess_on.to(torch.float32)
    fn = _ph.pdu_health_sim if _use_kernel(rack_power, force) else _ref.pdu_health_sim
    grid, soc_t, finals, h_leaves = fn(
        rack_power, g0, soc0, x0, ad, bd, c_row, health=health, rack_span=rack_span,
        ess_on=ess_on, ess_events=ess_events, ess_edge=ess_edge, **kw)
    if guard:  # (grid * 0 == 0: isfinite in two launches)
        grid = torch.where(grid * 0.0 == 0.0, grid, rack_power)
    return grid, soc_t, finals, h_leaves


def admm_iterate(kkt_stack, g_blk, kq, lo, hi, x0, z0, y0, *, rho, iters, force=None):
    """Fused batched-ADMM iteration loop (see ``ref.admm_iterate``).  An
    unbatched (1-D) solve is lifted to a one-column batch so that it runs
    the kernel on the card too."""
    if kq.ndim == 1:
        x, z, y = admm_iterate(
            kkt_stack, g_blk, kq[:, None], lo[:, None], hi[:, None],
            x0[:, None], z0[:, None], y0[:, None], rho=rho, iters=iters, force=force,
        )
        return x[:, 0], z[:, 0], y[:, 0]
    args = (kkt_stack, g_blk, kq, lo, hi, x0, z0, y0)
    if _use_kernel(kq, force):
        args = tuple(a.contiguous() for a in args)
        return _ad.admm_iterate(*args, rho=rho, iters=iters)
    return _ref.admm_iterate(*args, rho=rho, iters=iters)


def rmsnorm(x, weight, eps: float = 1e-6, *, force=None):
    """RMSNorm over the last axis, statistics in float32 (see
    ``ref.rmsnorm``); differentiable in ``x`` and ``weight``."""
    if not _use_kernel(x, force):
        return _ref.rmsnorm(x, weight, eps)
    if _records_graph(x, weight):
        return _rn.RMSNorm.apply(x, weight, eps)
    return _rn.rmsnorm(x, weight, eps)


def attention(q, k, v, *, causal=True, scale=None, force=None):
    """Softmax attention with GQA, ``q (B, H, Tq, D)``, ``k (B, Hkv, Tk,
    D)``, ``v (B, Hkv, Tk, Dv)`` (see ``ref.attention``).  On the card the
    flash-attention forward kernel serves every shape (it masks ragged
    tails itself), so the reference's dense fallback for sequences its
    tiles do not divide is not carried over; a value head dim ``Dv < D``
    (DeepSeek MLA's 128 beside 192) runs the kernel on ``v`` zero-padded to
    ``D``, the output cut back (the reference's Pallas route cannot take
    it: ROADMAP.md).  Differentiable: on the card the backward launches
    the dK/dV and dQ kernels (``flash_attention.FlashAttention``)."""
    if not _use_kernel(q, force):
        return _ref.attention(q, k, v, causal=causal, scale=scale)
    if _records_graph(q, k, v):
        return _fa.FlashAttention.apply(q, k, v, causal, scale)
    return _fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]


def rwkv6_scan(r, k, v, w, u, state0=None, *, force=None, algorithm="auto"):
    """The RWKV-6 recurrence, ``r, k, v, w (B, H, T, D)``, ``u (H, D)``,
    ``state0 (B, H, D, D)`` float32 or None; returns ``(o, S_T)`` (see
    ``ref.rwkv6_scan``).  Outside a recording autograd graph on the card it
    launches the kernel, which is the sequential recurrence whatever
    ``algorithm`` says.  Everywhere else (a CPU tensor, ``force="ref"``, or
    a recording graph on any device) it takes the plain versions by the
    reference's host rule: the chunk-parallel ``rwkv6_chunked(chunk=32)``
    when ``algorithm == "auto"`` and ``T`` is a multiple of 32 above 32,
    else the sequential ``rwkv6_scan`` (``algorithm="sequential"``, given
    here or by ``forced``, forces it).

    The graph rule is the reference's training route, not a fallback: the
    reference's kernel has no gradient (no ``custom_vjp``), so every step
    the JAX package trains runs these jnp forms, and the port's training
    step runs their PyTorch counterparts on the card.  The rule reads only
    whether a graph is recorded, so a block's forward and its activation
    checkpoint's recompute take the same route.  ``force="cuda"`` (given
    here or by ``forced``) demands the kernel and raises under a recording
    graph."""
    _check_algorithm(algorithm)
    graph = _records_graph(r, k, v, w, u, *(() if state0 is None else (state0,)))
    if force is None:
        force = _FORCED.get()
    if force is None and graph:
        force = "ref"
    if _use_kernel(r, force):
        if graph:
            raise NotImplementedError("rwkv6_scan has no backward kernel (nor has the "
                                      "reference's kernel route); leave force unset to train")
        return _rw.rwkv6_scan(r, k, v, w, u, state0)
    if algorithm == "auto":
        algorithm = _ALGORITHM.get()
    t = r.shape[2]
    if algorithm == "auto" and t > 32 and t % 32 == 0:
        return _ref.rwkv6_chunked(r, k, v, w, u, state0, chunk=32)
    return _ref.rwkv6_scan(r, k, v, w, u, state0)


def _no_graph(name: str, *ts) -> None:
    if _records_graph(*(t for t in ts if isinstance(t, torch.Tensor))):
        raise NotImplementedError(
            f"{name} has no backward kernel (nor has the reference's kernel route)")


def lc_filter(ad, bd, c_row, x0, node_power, *, force=None):
    """The LC filter with ``v_in = 1`` over ``node_power (T, R)`` from ``x0
    (R, 3)``; returns ``(grid (T, R), x_final (R, 3))`` float32 (see
    ``ref.lc_filter``).  The filter matrices may be tensors or host
    arrays."""
    if not _use_kernel(node_power, force):
        return _ref.lc_filter(ad, bd, c_row, x0, node_power)
    _no_graph("lc_filter", x0, node_power)
    f32 = lambda t: t.to(torch.float32).contiguous()
    return _lc.lc_filter(ad, bd, c_row, f32(x0), f32(node_power))


def pdu_sim(rack_power, g0, soc0, x0, ad, bd, c_row, corrective=0.0, *, force=None,
            ess_on=None, **kw):
    """The fused hardware path (ESS ramp filter, SoC, LC filter) over
    ``rack_power (T, R)``; ``corrective`` a scalar or ``(T, R)``, ``ess_on``
    None, an ``(R,)`` or a ``(T, R)`` availability weight; ``kw`` the
    hardware scalars (``beta, dt, q_max, eta_c, eta_d, p_max, soc_min,
    soc_max``).  Returns ``(grid, soc, (g_f, soc_f, x_f))`` float32 (see
    ``ref.pdu_sim``)."""
    if not _use_kernel(rack_power, force):
        return _ref.pdu_sim(rack_power, g0, soc0, x0, ad, bd, c_row, corrective,
                            ess_on=ess_on, **kw)
    _no_graph("pdu_sim", rack_power, g0, soc0, x0, corrective, ess_on)
    f32 = lambda t: t if t is None else t.to(torch.float32).contiguous()
    corr = torch.as_tensor(corrective, dtype=torch.float32, device=rack_power.device)
    return _ps.pdu_sim(f32(rack_power), f32(g0), f32(soc0), f32(x0), ad, bd, c_row,
                       f32(corr.expand(rack_power.shape)), ess_on=f32(ess_on), **kw)


def gemm_burn(a, b, n_iters: int = 1, *, force=None):
    """The burn GEMM: the mean of ``n_iters`` float32-accumulated products
    ``a @ b`` in ``a``'s type (see ``ref.gemm_burn``).  ``n_iters`` scales
    the work, not the value."""
    if not _use_kernel(a, force):
        return _ref.gemm_burn(a, b, n_iters)
    _no_graph("gemm_burn", a, b)
    return _gb.gemm_burn(a.contiguous(), b.contiguous(), n_iters)
