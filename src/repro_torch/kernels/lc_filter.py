"""The LC input filter on Hopper: wrapper and launch.

Ports ``repro.kernels.lc_filter.lc_filter`` (Pallas ``_lc_kernel``): the
3-state LC filter with ``v_in = 1`` over a whole ``(T, R)`` trace in one
launch.  The CUDA source (``csrc/lc_filter.cu``) runs the LC-only instance
of the pipeline of ``csrc/hw_stages.cuh`` (producer, LC and store warps a
block of 32 racks over shared-memory rings), planned by ``hw_plan.lc_plan``;
see its header for the design.  ``lc_filter.launches`` counts kernel
launches.  No gradient: the reference's kernel route has none.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, hw_plan, ref

F32 = torch.float32


def _consts(ad, bd, c_row) -> np.ndarray:
    """The 18 filter constants in the order of the LC fields of
    ``csrc/hw_stages.cuh``'s ``StepConsts`` (``a``, ``bl``, ``bv``, ``c``)."""
    a, bl, bv, c = ref.lc_consts(ad, bd, c_row)
    return np.asarray([*a, *bl, *bv, *c], np.float32)


def check_trace(name: str, t: torch.Tensor, shape: tuple, dev) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``dev`` (what the trace kernels take)."""
    if t.device != dev or t.dtype != F32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous float32 {shape} tensor on {dev}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def lc_filter(ad, bd, c_row, x0: torch.Tensor, node_power: torch.Tensor, *,
              plan: hw_plan.LcPlan | None = None):
    """Launch the kernel on CUDA tensors; same contract as
    ``ref.lc_filter``: ``node_power (T, R)`` and ``x0 (R, 3)`` float32 (``ops``
    converts), ``ad``, ``bd``, ``c_row`` tensors or host arrays; returns
    ``(grid (T, R), x_final (R, 3))``.  Any ``T >= 1``, any ``R >= 1``.
    ``plan`` (default ``hw_plan.lc_plan`` for ``R`` and the trace's
    alignment) runs the call on other routes or another chunk, the same
    bits; the launch refuses one it does not run."""
    dev = node_power.device
    if dev.type != "cuda":
        raise ValueError("lc_filter kernel needs CUDA tensors")
    if node_power.ndim != 2 or node_power.shape[0] < 1:
        raise ValueError(
            f"lc_filter: node_power must be (T >= 1, R), got {tuple(node_power.shape)}")
    t_len, r = node_power.shape
    check_trace("lc_filter: node_power", node_power, (t_len, r), dev)
    check_trace("lc_filter: x0", x0, (r, 3), dev)
    consts = _consts(ad, bd, c_row)
    grid = torch.empty((t_len, r), dtype=F32, device=dev)
    xf = torch.empty((r, 3), dtype=F32, device=dev)
    if plan is None:
        plan = hw_plan.lc_plan(r, aligned=hw_plan.aligned(node_power))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.launch_fn("lc_filter", "lc_filter_launch",
                          [vp, vp, vp, vp, ci, ci, vp, ci, ci, ci, ci, ctypes.c_longlong, vp])
    with torch.cuda.device(dev):
        err = fn(node_power.data_ptr(), x0.data_ptr(), grid.data_ptr(), xf.data_ptr(), t_len, r,
                 consts.ctypes.data, *hw_plan.lc_launch_args(plan),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("lc_filter", err)
    lc_filter.launches += 1
    return grid, xf


lc_filter.launches = 0
