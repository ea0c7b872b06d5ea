"""RMSNorm on Hopper: wrapper and launch.

Ports ``repro.kernels.rmsnorm.rmsnorm`` (Pallas ``_rmsnorm_kernel``):
``x * rsqrt(mean(x^2) + eps) * w`` over the last axis, statistics in
float32, the result in ``x.dtype``.  The CUDA source
(``csrc/rmsnorm.cu``) reads each row once as 16-byte vectors; see its
header for the design.  ``rmsnorm.launches`` counts kernel launches.

``RMSNorm`` makes the kernel differentiable: its forward launches the
kernel, its backward is the gradient of the plain version (``ref.rmsnorm``)
recomputed from ``x`` and the weight with plain PyTorch ops.  The
reference has no backward kernel either (``repro.kernels.rmsnorm`` has no
VJP, so JAX differentiates its jnp reference), so this is the port of what
it runs, not a fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_VECTORS = 8 * 1024  # 16-byte vectors a row may hold (8 per thread, 1024 threads)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor ``(..., D)``; same contract as
    ``ref.rmsnorm``.  ``x`` and ``weight`` share one type (float32 or
    bfloat16) and ``D`` is a multiple of 8.  Raises for tensors that are not
    on a CUDA device (the CPU path is ``ops``' business)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("rmsnorm kernel needs CUDA tensors")
    d = x.shape[-1]
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise ValueError(
            f"rmsnorm kernel takes float32 or bfloat16 x and weight of one type, got "
            f"{x.dtype} and {weight.dtype}"
        )
    if weight.device != dev or tuple(weight.shape) != (d,):
        raise ValueError(f"rmsnorm: weight must be a ({d},) tensor on {dev}")
    if d % 8 or d // (16 // x.element_size()) > _MAX_VECTORS:
        raise ValueError(f"rmsnorm kernel needs D a multiple of 8 and at most "
                         f"{_MAX_VECTORS} 16-byte vectors, got D = {d}")
    x2 = x.contiguous()
    w = weight.contiguous()
    y = torch.empty_like(x2)
    rows = x2.numel() // d
    if rows == 0:
        return y
    if x2.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("rmsnorm kernel needs 16-byte aligned x and weight")
    vp = ctypes.c_void_p
    fn = _build.launch_fn("rmsnorm", "rmsnorm_launch",
                          [vp, vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.c_int, vp])
    with torch.cuda.device(dev):
        err = fn(x2.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, float(eps),
                 _DTYPES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("rmsnorm", err)
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0


class RMSNorm(torch.autograd.Function):
    """``rmsnorm`` with a gradient: the kernel forward, the plain version's
    gradient backward (its autograd graph, rebuilt from the saved inputs)."""

    @staticmethod
    def forward(ctx, x, weight, eps: float):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rmsnorm(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        with torch.enable_grad():
            xd, wd = x.detach().requires_grad_(), weight.detach().requires_grad_()
            dx, dw = torch.autograd.grad(ref.rmsnorm(xd, wd, ctx.eps), (xd, wd), dy)
        return dx, dw, None
