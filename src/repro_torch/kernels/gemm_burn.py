"""The burn GEMM on Hopper: wrapper and launch.

Ports ``repro.kernels.gemm_burn.gemm_burn`` (Pallas ``_burn_kernel``): the
mean of ``n_iters`` float32-accumulated products ``A @ B``, in A's type, a
matrix product whose work is a knob (the software-burn baseline,
``core/burn.py``).  The CUDA source (``csrc/gemm_burn.cu``) runs bf16 on
the tensor cores (``wgmma`` fed by TMA, each staged k-tile feeding all
``n_iters`` rounds) and float32 as FP32 FMAs (round after round, with a
deterministic split-K where the output tiles alone would not fill the
card); every round's products go into one running float32 sum, so the
work cannot be folded away; see its header.  The TMA loads need 16-byte
row pitches, so a bf16 ``K`` or ``N`` that is not a multiple of 8 is
zero-padded here (``pad_operands``): zero columns of ``K`` add nothing to
any product, and the padded columns of ``N`` are never stored.
``gemm_burn.launches`` counts the calls that launch the kernel, and
``gemm_burn.sum_launches`` those that also launch the split-K second pass
(``gemm_burn_f32_sum``, a second kernel of the same source).  No gradient: the
reference's kernel route has none.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PITCH = 8  # bf16 elements in the 16 bytes a TMA row pitch is a multiple of


def pad_operands(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``a (M, K)`` and ``b (K, N)`` with ``K`` and ``N`` zero-padded up to
    multiples of 8, 16-byte aligned and contiguous, as the bf16 kernel's
    tensor maps need them.  ``pad_operands(a, b)[0] @ pad_operands(a,
    b)[1]`` holds ``a @ b`` in its first ``N`` columns exactly: every
    product gains only zero terms."""
    k, n = b.shape
    pk, pn = -k % _PITCH, -n % _PITCH
    if pk or pn:
        a, b = F.pad(a, (0, pk)), F.pad(b, (0, pn, 0, pk))
    return tuple(t if t.data_ptr() % 16 == 0 and t.is_contiguous() else t.clone(
        memory_format=torch.contiguous_format) for t in (a, b))


def f32_split_k(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """``(splits, k_split)`` of the float32 kernel on a card of ``sms``
    multiprocessors.  Where its 32 x 64 output tiles number fewer than
    ``sms``, K is cut into ranges of ``k_split`` (a multiple of 32): 64 or
    less where 8 ranges cover K, so that a range's two k-tiles stay in the
    kernel's two shared-memory buffers for every round, and at most 8
    ranges, which bounds the workspace the second pass reads to
    8 x M x N floats.  Else K stays whole.  The ranges cover K and none is
    empty."""
    tiles = -(-m // 32) * -(-n // 64)
    splits = min(8, -(-k // 64)) if tiles < sms else 1
    if splits == 1:
        return 1, k
    k_split = -(-k // (32 * splits)) * 32
    return -(-k // k_split), k_split


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
    m, n = a.shape[0], b.shape[1]
    if a.dtype == torch.bfloat16:
        a, b = pad_operands(a, b)
    k, ldb = b.shape
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    splits, k_split = (1, k) if a.dtype == torch.bfloat16 else f32_split_k(
        m, n, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1 else None
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.launch_fn("gemm_burn", "gemm_burn_launch",
                          [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp])
    with torch.cuda.device(dev):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
                 m, n, k, ldb, n_iters, splits, k_split, _DTYPES[a.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("gemm_burn", err)
    gemm_burn.launches += 1
    gemm_burn.sum_launches += int(splits > 1)
    return out


gemm_burn.launches = 0
gemm_burn.sum_launches = 0
