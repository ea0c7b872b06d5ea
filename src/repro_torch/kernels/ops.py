"""Public kernel API with device dispatch.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version (``ref``).  ``force`` overrides: ``"ref"`` runs the
plain version on any device (``chip_smoke.py`` holds the kernels against
it on the card), ``"cuda"`` demands the kernel and raises for CPU tensors.
There is no fallback: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import admm_step as _ad, pdu_health as _ph, ref as _ref


def _use_kernel(t: torch.Tensor, force: str | None) -> bool:
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
