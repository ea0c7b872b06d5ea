"""Public kernel API with device dispatch.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version (``ref``).  ``force`` overrides: ``"ref"`` runs the
plain version on any device (``chip_smoke.py`` holds the kernels against
it on the card), ``"cuda"`` demands the kernel and raises for CPU tensors.
There is no fallback: a kernel that fails to build or launch raises.
``with ops.forced("ref"):`` sets the default ``force`` of every call made
inside it (in this thread or task), so a whole model step can run its
plain versions on the card for comparison.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import (
    admm_step as _ad, flash_attention as _fa, pdu_health as _ph, ref as _ref, rmsnorm as _rn,
)

_FORCED: contextvars.ContextVar[str | None] = contextvars.ContextVar("force", default=None)


@contextlib.contextmanager
def forced(mode: str | None):
    """Make ``mode`` (``"ref"``, ``"cuda"`` or None) the ``force`` of every
    ``ops`` call inside the block that does not pass its own."""
    token = _FORCED.set(mode)
    try:
        yield
    finally:
        _FORCED.reset(token)


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
    ``ref.rmsnorm``)."""
    fn = _rn.rmsnorm if _use_kernel(x, force) else _ref.rmsnorm
    return fn(x, weight, eps)


def attention(q, k, v, *, causal=True, scale=None, force=None):
    """Softmax attention with GQA, ``q (B, H, Tq, D)``, ``k, v (B, Hkv, Tk,
    D)`` (see ``ref.attention``).  On the card the flash-attention forward
    kernel serves every shape (it masks ragged tails itself), so the
    reference's dense fallback for sequences its tiles do not divide is
    not carried over.  The kernel has no backward yet: recording a graph
    through it raises instead of differentiating the plain version."""
    if not _use_kernel(q, force):
        return _ref.attention(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash-attention backward kernels are not ported yet (ROADMAP.md queue 2 "
            "item 7, the training slice); run under torch.inference_mode() or no_grad()"
        )
    return _fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
