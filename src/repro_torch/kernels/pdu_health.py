"""The interval-resident conditioning kernel on Hopper: wrapper and launch.

Ports ``repro.kernels.pdu_health.pdu_health_sim`` (the Pallas megakernel):
one launch runs one controller interval of every rack's hardware path —
ESS ramp filter, SoC integration with the window clamp and its power
back-off, the 3-state LC filter, the corrective-command slew rendered from
``(applied, target)``, the battery-wear turning-point machine and the ESS
availability weight: none, an ``(R,)`` row or a ``(T, R)`` series
(``ess_on``), or rendered in the kernel from the fault schedule's episode
tables (``ess_events`` with ``ess_edge``).  The CUDA source
(``csrc/pdu_health.cu``) runs the warp-specialised pipeline of
``csrc/hw_stages.cuh`` (a block of 32 racks, a warp a stage, fed by a
shared-memory ring); ``hw_plan.plan`` gives each launch its chunk, ring
depth, shared-memory bytes and load route.

The block throughput/SoC sums of the health fold stay torch reductions in
this wrapper at the reference's ``(t, r)`` reduce shape
(``ref.block_sums``), shared with the plain version.  ``prepare`` /
``launch`` / ``finish`` split one call so the kernel can be timed alone;
``pdu_health_sim.launches`` counts kernel launches (``launch`` adds one),
and ``pdu_health_sim.launches_by_mask`` them by weight mode (``MASK_*``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build, hw_plan, ref

F32 = torch.float32
_NUM_CONSTS = 32
MASK_NONE, MASK_ROW, MASK_SERIES, MASK_EVENTS = (hw_plan.MASK_NONE, hw_plan.MASK_ROW,
                                                 hw_plan.MASK_SERIES, hw_plan.MASK_EVENTS)


def _consts(kw: dict, ad, bd, c_row, t_len: int, health) -> np.ndarray:
    """Pack the step scalars in ``csrc/hw_stages.cuh``'s ``StepConsts``
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
    mask: int  # the weight mode (MASK_*)
    plan: hw_plan.Plan  # chunk, ring depth, shared memory, load route
    inputs: tuple  # operand tensors, referenced while the launch reads them
    grid: torch.Tensor
    soc_t: torch.Tensor
    sf: torch.Tensor
    hf: torch.Tensor | None
    health_state: tuple | None
    consts: np.ndarray  # kept alive while the launch may read it
    rack_span: tuple[int, int] | None = None  # the campus columns (``ref.block_sums``)


def prepare(
    rack_power, g0, soc0, x0, ad, bd, c_row, *,
    beta, dt, q_max, eta_c, eta_d, p_max, soc_min, soc_max,
    corrective=0.0, slew=None, health=None, rack_span=None, ess_on=None, ess_events=None,
    ess_edge=1,
) -> Prepared:
    """Check the operands (CUDA, float32, shapes, contiguity), pack the
    step constants and allocate the outputs for ``launch``.  ``ad``,
    ``bd``, ``c_row`` may be tensors or host arrays (host arrays avoid a
    device read per launch).  ``ess_on`` is an ``(R,)`` or ``(T, R)``
    float32 weight; ``ess_events = (starts, ends, base, i0, t_last)`` holds
    ``(E, R)`` int32 tables, an ``(R,)`` float32 base row and two absolute
    sample indices (ints or one-element tensors)."""
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
    if ess_on is not None and ess_events is not None:
        raise ValueError("pass either ess_on or ess_events, not both")
    mask, w, ev, ev_args = MASK_NONE, None, (), (None, None, None, 0, 0, 0, 1, 1.0)
    if ess_on is not None:
        w = ess_on.contiguous()
        mask = MASK_ROW if w.ndim == 1 else MASK_SERIES
        _check("ess_on", w, (r,) if w.ndim == 1 else (t_len, r), dev)
    elif ess_events is not None:
        st, en, base, i0, t_last = ess_events
        st, en = st.contiguous(), en.contiguous()
        n_ev = st.shape[0]
        for name, tab in (("ess_events starts", st), ("ess_events ends", en)):
            if (tab.device != dev or tab.dtype != torch.int32 or tab.ndim != 2
                    or tuple(tab.shape) != (n_ev, r) or n_ev < 1):
                raise ValueError(
                    f"pdu_health: {name} must be a contiguous int32 (E >= 1, {r}) tensor "
                    f"on {dev}, got {tab.dtype} {tuple(tab.shape)} on {tab.device}")
        base = base.to(F32).expand(r).contiguous()
        _check("ess_events base", base, (r,), dev)
        edge = int(ess_edge)
        inv = float(np.float32(1.0 / edge)) if edge > 1 else 1.0
        mask, ev = MASK_EVENTS, (st, en, base)
        ev_args = (st.data_ptr(), en.data_ptr(), base.data_ptr(), n_ev, int(i0), int(t_last),
                   edge, inv)
    kw = dict(beta=beta, dt=dt, q_max=q_max, eta_c=eta_c, eta_d=eta_d,
              p_max=p_max, soc_min=soc_min, soc_max=soc_max)
    consts = _consts(kw, ad, bd, c_row, t_len, health)
    grid = torch.empty((t_len, r), dtype=F32, device=dev)
    soc_t = torch.empty((t_len, r), dtype=F32, device=dev)
    sf = torch.empty((5, r), dtype=F32, device=dev)
    hf = torch.empty((6, r), dtype=F32, device=dev) if health is not None else None
    # The TMA route copies the rack power, the dense corrective and the
    # (T, R) weight; each must start on 16 bytes for it.
    plan = hw_plan.plan(r, mask, aligned=hw_plan.aligned(
        rack_power, None if slew is not None else corr, w if mask == MASK_SERIES else None))
    ptr = lambda x: None if x is None else x.data_ptr()
    args = (
        ptr(rack_power), ptr(corr), int(slew is not None), ptr(s0), ptr(h0),
        ptr(grid), ptr(soc_t), ptr(sf), ptr(hf), t_len, r,
        consts.ctypes.data, kappa_mode, mask, ptr(w), *ev_args, *hw_plan.launch_args(plan),
    )
    return Prepared(args, mask, plan, (rack_power, corr, s0, h0, w, *ev), grid, soc_t, sf, hf,
                    None if health is None else tuple(health[1]), consts, rack_span)


def launch(p: Prepared) -> None:
    """Launch the kernel on prepared operands (on the current stream; no
    synchronization) and count the launch."""
    dev = p.grid.device
    vp = ctypes.c_void_p
    ci = ctypes.c_int
    fn = _build.launch_fn("pdu_health", "pdu_health_launch",
                          [vp, vp, ci, vp, vp, vp, vp, vp, vp, ci, ci, vp, ci,
                           ci, vp, vp, vp, vp, ci, ci, ci, ci, ctypes.c_float,
                           ci, ci, ci, ctypes.c_longlong, vp])
    with torch.cuda.device(dev):
        err = fn(*p.args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("pdu_health", err)
    pdu_health_sim.launches += 1
    pdu_health_sim.launches_by_mask[p.mask] += 1


def finish(p: Prepared):
    """The launch's return value: ``(grid, soc_t, (g_f, soc_f, x_f),
    health_leaves_or_None)``, with the block sums of the health fold."""
    finals = (p.sf[0], p.sf[1], p.sf[2:5].T)
    if p.hf is None:
        return p.grid, p.soc_t, finals, None
    return (p.grid, p.soc_t, finals,
            tuple(p.hf[i] for i in range(6))
            + ref.block_sums(p.soc_t, p.health_state, p.rack_span))


def pdu_health_sim(rack_power, g0, soc0, x0, ad, bd, c_row, **kw):
    """Launch the kernel on CUDA tensors; same contract and return value as
    ``ref.pdu_health_sim``.  Raises for tensors that are not on a CUDA
    device (the CPU path is ``ops``' business)."""
    p = prepare(rack_power, g0, soc0, x0, ad, bd, c_row, **kw)
    launch(p)
    return finish(p)


# Launches made from Python: a launch captured in a CUDA graph (the scanned
# engine's) counts once, at capture, and not when the graph is replayed.
pdu_health_sim.launches = 0
pdu_health_sim.launches_by_mask = [0, 0, 0, 0]
