"""The batched controller-QP ADMM loop on Hopper: wrapper and launch.

Ports ``repro.kernels.admm_step.admm_iterate`` (Pallas ``_admm_kernel``):
``iters`` OSQP-style ADMM steps for every rack column in one launch, the
plan matrices in shared memory and each column's ``x, z, y`` iterates in
registers (see ``csrc/admm_step.cu``).  ``prepare`` / ``launch`` split one
call so the kernel can be timed alone; ``admm_iterate.launches`` counts
kernel launches (``launch`` adds one).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

F32 = torch.float32
HORIZONS = (12,)  # instantiated template horizons (ControllerConfig default)


class Prepared(NamedTuple):
    """One launch's checked operands and allocated outputs."""

    args: tuple  # the C launch function's arguments (without the stream)
    inputs: tuple  # the operands, referenced while the launch reads them
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor


def prepare(kkt_stack, g_blk, kq, lo, hi, x0, z0, y0, *, rho, iters) -> Prepared:
    """Check the operands (CUDA, float32, shapes, contiguity) and allocate
    the outputs for ``launch``."""
    dev = kq.device
    if dev.type != "cuda":
        raise ValueError("admm_step kernel needs CUDA tensors")
    h = g_blk.shape[0]
    if h not in HORIZONS:
        raise ValueError(
            f"admm_step kernel is instantiated for horizons {HORIZONS}, got {h}"
        )
    if kq.ndim != 2:
        raise ValueError("admm_step kernel needs a (2h, R) rack batch")
    r = kq.shape[1]
    shapes = dict(
        kkt_stack=(kkt_stack, (2 * h, 5 * h)), g_blk=(g_blk, (h, 2 * h)),
        kq=(kq, (2 * h, r)), lo=(lo, (3 * h, r)), hi=(hi, (3 * h, r)),
        x0=(x0, (2 * h, r)), z0=(z0, (3 * h, r)), y0=(y0, (3 * h, r)),
    )
    for name, (t, shape) in shapes.items():
        if t.device != dev or t.dtype != F32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"admm_step: {name} must be a contiguous float32 {shape} tensor "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    x = torch.empty((2 * h, r), dtype=F32, device=dev)
    z = torch.empty((3 * h, r), dtype=F32, device=dev)
    y = torch.empty((3 * h, r), dtype=F32, device=dev)
    return Prepared(
        tuple(t.data_ptr() for t in (kkt_stack, g_blk, kq, lo, hi, x0, z0, y0, x, z, y))
        + (h, r, float(rho), int(iters)),
        (kkt_stack, g_blk, kq, lo, hi, x0, z0, y0), x, z, y,
    )


def launch(p: Prepared) -> None:
    """Launch the kernel on prepared operands (current stream, no
    synchronization) and count the launch."""
    dev = p.x.device
    vp = ctypes.c_void_p
    fn = _build.launch_fn("admm_step", "admm_step_launch",
                          [vp] * 11 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, vp])
    with torch.cuda.device(dev):
        err = fn(*p.args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("admm_step", err)
    admm_iterate.launches += 1


def admm_iterate(kkt_stack, g_blk, kq, lo, hi, x0, z0, y0, *, rho, iters):
    """Launch the kernel on CUDA tensors with a rack batch in the trailing
    axis; returns ``(x, z, y)`` like ``ref.admm_iterate``."""
    p = prepare(kkt_stack, g_blk, kq, lo, hi, x0, z0, y0, rho=rho, iters=iters)
    launch(p)
    return p.x, p.z, p.y


admm_iterate.launches = 0
