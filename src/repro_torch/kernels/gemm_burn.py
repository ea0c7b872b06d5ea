"""The burn GEMM on Hopper: wrapper and launch.

Ports ``repro.kernels.gemm_burn.gemm_burn`` (Pallas ``_burn_kernel``): the
mean of ``n_iters`` float32-accumulated products ``A @ B``, in A's type, a
matrix product whose work is a knob (the software-burn baseline,
``core/burn.py``).  The CUDA source (``csrc/gemm_burn.cu``) is a tiled
shared-memory GEMM on FP32 FMAs that accumulates every iteration into one
running sum, so the work cannot be folded away; see its header.
``gemm_burn.launches`` counts kernel launches.  No gradient: the
reference's kernel route has none.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gemm_burn(a: torch.Tensor, b: torch.Tensor, n_iters: int = 1) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; same contract as
    ``ref.gemm_burn``.  ``a (M, K)`` and ``b (K, N)`` are contiguous and of
    one type, float32 or bfloat16; any M, N, K >= 1 and ``n_iters >= 1``."""
    dev = a.device
    if dev.type != "cuda" or b.device != dev:
        raise ValueError("gemm_burn kernel needs CUDA tensors on one device")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"gemm_burn kernel takes float32 or bfloat16 a, b of one type, got "
                         f"{a.dtype}, {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0] or min(*a.shape, b.shape[1]) < 1:
        raise ValueError(f"gemm_burn: shapes {tuple(a.shape)} @ {tuple(b.shape)} do not chain")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm_burn kernel takes contiguous operands")
    n_iters = int(n_iters)
    if n_iters < 1:
        raise ValueError(f"gemm_burn: n_iters must be >= 1, got {n_iters}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.launch_fn("gemm_burn", "gemm_burn_launch", [vp, vp, vp, ci, ci, ci, ci, ci, vp])
    with torch.cuda.device(dev):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, n_iters, _DTYPES[a.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("gemm_burn", err)
    gemm_burn.launches += 1
    return out


gemm_burn.launches = 0
