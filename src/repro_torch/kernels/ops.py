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
backward kernel).  ``rwkv6_scan`` is differentiable only through its
plain versions: the reference's kernel route has no gradient either.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import (
    admm_step as _ad, flash_attention as _fa, pdu_health as _ph, ref as _ref, rmsnorm as _rn,
    rwkv6_scan as _rw,
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
    rack_power, g0, soc0, x0, ad, bd, c_row, *, health=None, force=None,
    ess_on=None, ess_events=None, **kw,
):
    """One controller interval of the rack hardware path for every rack
    (ESS + SoC + LC, command slew via ``slew=(applied, target)`` or a dense
    ``corrective``, wear fold via ``health=(step_consts, state_leaves)``);
    see ``ref.pdu_health_sim``.  The per-sample ESS availability operands
    (``ess_on``/``ess_events``) come with degraded mode (ROADMAP.md,
    queue 2 item 1)."""
    if ess_on is not None or ess_events is not None:
        raise NotImplementedError(
            "ess_on/ess_events are not ported yet (ROADMAP.md queue 2 item 1)"
        )
    fn = _ph.pdu_health_sim if _use_kernel(rack_power, force) else _ref.pdu_health_sim
    return fn(rack_power, g0, soc0, x0, ad, bd, c_row, health=health, **kw)


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
    """Softmax attention with GQA, ``q (B, H, Tq, D)``, ``k, v (B, Hkv, Tk,
    D)`` (see ``ref.attention``).  On the card the flash-attention forward
    kernel serves every shape (it masks ragged tails itself), so the
    reference's dense fallback for sequences its tiles do not divide is
    not carried over.  Differentiable: on the card the backward launches
    the dK/dV and dQ kernels (``flash_attention.FlashAttention``)."""
    if not _use_kernel(q, force):
        return _ref.attention(q, k, v, causal=causal, scale=scale)
    if _records_graph(q, k, v):
        return _fa.FlashAttention.apply(q, k, v, causal, scale)
    return _fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]


def rwkv6_scan(r, k, v, w, u, state0=None, *, force=None, algorithm="auto"):
    """The RWKV-6 recurrence, ``r, k, v, w (B, H, T, D)``, ``u (H, D)``,
    ``state0 (B, H, D, D)`` float32 or None; returns ``(o, S_T)`` (see
    ``ref.rwkv6_scan``).  On the card it launches the kernel, which is the
    sequential recurrence whatever ``algorithm`` says, and raises under a
    recording autograd graph: the kernel has no backward, as the
    reference's has none.  The
    plain versions follow the reference's host rule: the chunk-parallel
    ``rwkv6_chunked(chunk=32)`` when ``algorithm == "auto"`` and ``T`` is a
    multiple of 32 above 32, else the sequential ``rwkv6_scan``
    (``algorithm="sequential"``, given here or by ``forced``, forces it)."""
    _check_algorithm(algorithm)
    if _use_kernel(r, force):
        if _records_graph(r, k, v, w, u, *(() if state0 is None else (state0,))):
            raise NotImplementedError(
                "rwkv6_scan has no backward kernel (nor has the reference's kernel route); "
                "ssm training is an open question in ROADMAP.md")
        return _rw.rwkv6_scan(r, k, v, w, u, state0)
    if algorithm == "auto":
        algorithm = _ALGORITHM.get()
    t = r.shape[2]
    if algorithm == "auto" and t > 32 and t % 32 == 0:
        return _ref.rwkv6_chunked(r, k, v, w, u, state0, chunk=32)
    return _ref.rwkv6_scan(r, k, v, w, u, state0)
