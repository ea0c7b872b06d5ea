"""The fused rack hardware path on Hopper: wrapper and launch.

Ports ``repro.kernels.pdu_sim.pdu_sim`` (Pallas ``_pdu_kernel``): ESS ramp
filter, SoC integration with the window clamp and its power back-off, and
the LC filter over a whole ``(T, R)`` trace in one launch, unweighted or
with an ``(R,)`` or ``(T, R)`` ESS availability weight (one kernel, three
instantiations).  The CUDA source (``csrc/pdu_sim.cu``) runs the
warp-specialised pipeline of ``csrc/hw_stages.cuh`` (producer, ESS + SoC
and LC warps over a shared-memory ring), planned by ``hw_plan.plan``.
``pdu_sim.launches`` counts kernel launches.  No gradient: the reference's
kernel route has none.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, hw_plan, ref
from repro_torch.kernels.lc_filter import check_trace

F32 = torch.float32


def _consts(kw: dict, ad, bd, c_row) -> np.ndarray:
    """The first 27 step constants in ``csrc/hw_stages.cuh``'s ``StepConsts`` order: the
    float32 values of ``ref.pdu_sim``."""
    k = ref.pdu_sim_consts(**kw)
    a, bl, bv, c = ref.lc_consts(ad, bd, c_row)
    return np.asarray([k.alpha, k.k_soc, k.eta_c, k.inv_eta_d, k.p_max, k.soc_min, k.soc_max,
                       k.bo_hi, k.bo_lo, *a, *bl, *bv, *c], np.float32)


def pdu_sim(rack_power, g0, soc0, x0, ad, bd, c_row, corrective, *, ess_on=None, **kw):
    """Launch the kernel on CUDA tensors; same contract as ``ref.pdu_sim``
    (``kw``: ``beta, dt, q_max, eta_c, eta_d, p_max, soc_min, soc_max``).
    ``rack_power`` and ``corrective`` (T, R) and ``ess_on`` ((R,) or
    (T, R)) are contiguous float32 (``ops`` converts and expands).  Returns
    ``(grid, soc, (g_f, soc_f, x_f))``.  Any ``T >= 1``."""
    dev = rack_power.device
    if dev.type != "cuda":
        raise ValueError("pdu_sim kernel needs CUDA tensors")
    if rack_power.ndim != 2 or rack_power.shape[0] < 1:
        raise ValueError(f"pdu_sim: rack_power must be (T >= 1, R), got {tuple(rack_power.shape)}")
    t_len, r = rack_power.shape
    check_trace("pdu_sim: rack_power", rack_power, (t_len, r), dev)
    s0 = torch.stack([g0.expand(r), soc0.expand(r), x0[:, 0], x0[:, 1], x0[:, 2]])
    check_trace("pdu_sim: state", s0, (5, r), dev)
    check_trace("pdu_sim: corrective", corrective, (t_len, r), dev)
    mask = 0
    if ess_on is not None:
        mask = 2 if ess_on.ndim == 2 else 1
        check_trace("pdu_sim: ess_on", ess_on, (t_len, r) if mask == 2 else (r,), dev)
    consts = _consts(kw, ad, bd, c_row)
    grid = torch.empty((t_len, r), dtype=F32, device=dev)
    soc_t = torch.empty((t_len, r), dtype=F32, device=dev)
    sf = torch.empty((5, r), dtype=F32, device=dev)
    plan = hw_plan.plan(r, mask, aligned=hw_plan.aligned(rack_power, corrective,
                                                         ess_on if mask == 2 else None))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.launch_fn("pdu_sim", "pdu_sim_launch",
                          [vp, vp, vp, ci, vp, vp, vp, vp, ci, ci, vp, ci, ci, ci,
                           ctypes.c_longlong, vp])
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        err = fn(rack_power.data_ptr(), corrective.data_ptr(), ptr(ess_on), mask, s0.data_ptr(),
                 grid.data_ptr(), soc_t.data_ptr(), sf.data_ptr(), t_len, r, consts.ctypes.data,
                 *hw_plan.launch_args(plan), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("pdu_sim", err)
    pdu_sim.launches += 1
    return grid, soc_t, (sf[0], sf[1], sf[2:5].T)


pdu_sim.launches = 0
