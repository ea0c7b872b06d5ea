"""The interval-resident conditioning kernel on Hopper: wrapper and launch.

Ports ``repro.kernels.pdu_health.pdu_health_sim`` (the Pallas megakernel):
one launch runs one controller interval of every rack's hardware path —
ESS ramp filter, SoC integration with the window clamp and its power
back-off, the 3-state LC filter, the corrective-command slew rendered from
``(applied, target)`` and the battery-wear turning-point machine.  The CUDA
source (``csrc/pdu_health.cu``) keeps one rack per thread with its whole
state in registers; see its header for the design.

The block throughput/SoC sums of the health fold stay torch reductions in
this wrapper at the reference's ``(t, r)`` reduce shape
(``ref.block_sums``), shared with the plain version.  ``prepare`` /
``launch`` / ``finish`` split one call so the kernel can be timed alone;
``pdu_health_sim.launches`` counts kernel launches (``launch`` adds one).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build, ref

F32 = torch.float32
_NUM_CONSTS = 32


def _consts(kw: dict, ad, bd, c_row, t_len: int, health) -> np.ndarray:
    """Pack the step scalars in ``csrc/pdu_health.cu``'s ``PduConsts``
    order: the same float32 values the plain version uses."""
    k = ref.hw_consts(**kw)
    a, bl, bv, c = ref.lc_consts(ad, bd, c_row)
    c0, c1, eps, kappa = ref.health_step_consts(health[0]) if health else (0.0,) * 4
    vals = [
        k.alpha, k.k_soc, k.eta_c, k.inv_eta_d, k.p_max, k.soc_min, k.soc_max,
        k.bo_hi, k.bo_lo, *a, *bl, *bv, *c,
        float(np.float32(1.0) / np.float32(t_len)), c0, c1, eps, kappa,
    ]
    out = np.asarray(vals, np.float32)
    if out.shape != (_NUM_CONSTS,):
        raise ValueError(f"pdu_health: packed {out.shape[0]} constants, expected {_NUM_CONSTS}")
    return out


def _kappa_mode(kappa: float) -> int:
    """1..4: repeated multiplication (as the reference); 0: powf."""
    if kappa == 1.0 or (kappa.is_integer() and 2 <= int(kappa) <= 4):
        return int(kappa)
    return 0


def _check(name: str, t: torch.Tensor, shape: tuple, dev) -> None:
    if t.device != dev or t.dtype != F32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"pdu_health: {name} must be a contiguous float32 {shape} tensor on "
            f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


class Prepared(NamedTuple):
    """One launch's operands and outputs, checked and allocated (see
    ``prepare``); ``launch`` runs the kernel on them any number of times."""

    args: tuple  # the C launch function's arguments (without the stream)
    inputs: tuple  # operand tensors, referenced while the launch reads them
    grid: torch.Tensor
    soc_t: torch.Tensor
    sf: torch.Tensor
    hf: torch.Tensor | None
    health_state: tuple | None
    consts: np.ndarray  # kept alive while the launch may read it


def prepare(
    rack_power, g0, soc0, x0, ad, bd, c_row, *,
    beta, dt, q_max, eta_c, eta_d, p_max, soc_min, soc_max,
    corrective=0.0, slew=None, health=None,
) -> Prepared:
    """Check the operands (CUDA, float32, shapes, contiguity), pack the
    step constants and allocate the outputs for ``launch``.  ``ad``,
    ``bd``, ``c_row`` may be tensors or host arrays (host arrays avoid a
    device read per launch)."""
    dev = rack_power.device
    if dev.type != "cuda":
        raise ValueError("pdu_health kernel needs CUDA tensors")
    t_len, r = rack_power.shape
    _check("rack_power", rack_power, (t_len, r), dev)
    s0 = torch.stack([g0.expand(r), soc0.expand(r), x0[:, 0], x0[:, 1], x0[:, 2]]).to(F32).contiguous()
    _check("state", s0, (5, r), dev)
    if slew is not None:
        applied = slew[0].to(F32).expand(r)
        corr = torch.stack([applied, slew[1].to(F32).expand(r) - applied]).contiguous()
        _check("slew", corr, (2, r), dev)
    else:
        corr = torch.as_tensor(corrective, dtype=F32, device=dev).expand(t_len, r).contiguous()
        _check("corrective", corr, (t_len, r), dev)
    h0 = None
    kappa_mode = 1
    if health is not None:
        h0 = torch.stack([leaf.to(F32).expand(r) for leaf in health[1][:6]]).contiguous()
        _check("health state", h0, (6, r), dev)
        kappa_mode = _kappa_mode(float(health[0][3]))
    kw = dict(beta=beta, dt=dt, q_max=q_max, eta_c=eta_c, eta_d=eta_d,
              p_max=p_max, soc_min=soc_min, soc_max=soc_max)
    consts = _consts(kw, ad, bd, c_row, t_len, health)
    grid = torch.empty((t_len, r), dtype=F32, device=dev)
    soc_t = torch.empty((t_len, r), dtype=F32, device=dev)
    sf = torch.empty((5, r), dtype=F32, device=dev)
    hf = torch.empty((6, r), dtype=F32, device=dev) if health is not None else None
    ptr = lambda x: None if x is None else x.data_ptr()
    args = (
        ptr(rack_power), ptr(corr), int(slew is not None), ptr(s0), ptr(h0),
        ptr(grid), ptr(soc_t), ptr(sf), ptr(hf), t_len, r,
        consts.ctypes.data, kappa_mode,
    )
    return Prepared(args, (rack_power, corr, s0, h0), grid, soc_t, sf, hf,
                    None if health is None else tuple(health[1]), consts)


def launch(p: Prepared) -> None:
    """Launch the kernel on prepared operands (on the current stream; no
    synchronization) and count the launch."""
    dev = p.grid.device
    vp = ctypes.c_void_p
    fn = _build.launch_fn("pdu_health", "pdu_health_launch",
                          [vp, vp, ctypes.c_int, vp, vp, vp, vp, vp, vp, ctypes.c_int,
                           ctypes.c_int, vp, ctypes.c_int, vp])
    with torch.cuda.device(dev):
        err = fn(*p.args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("pdu_health", err)
    pdu_health_sim.launches += 1


def finish(p: Prepared):
    """The launch's return value: ``(grid, soc_t, (g_f, soc_f, x_f),
    health_leaves_or_None)``, with the block sums of the health fold."""
    finals = (p.sf[0], p.sf[1], p.sf[2:5].T)
    if p.hf is None:
        return p.grid, p.soc_t, finals, None
    return (p.grid, p.soc_t, finals,
            tuple(p.hf[i] for i in range(6)) + ref.block_sums(p.soc_t, p.health_state))


def pdu_health_sim(rack_power, g0, soc0, x0, ad, bd, c_row, **kw):
    """Launch the kernel on CUDA tensors; same contract and return value as
    ``ref.pdu_health_sim``.  Raises for tensors that are not on a CUDA
    device (the CPU path is ``ops``' business)."""
    p = prepare(rack_power, g0, soc0, x0, ad, bd, c_row, **kw)
    launch(p)
    return finish(p)


pdu_health_sim.launches = 0
