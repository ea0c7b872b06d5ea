"""RWKV-6 recurrence on Hopper: wrapper and launch.

Ports ``repro.kernels.rwkv6_scan.rwkv6_scan`` (Pallas ``_rwkv6_kernel``):
per (batch, head), with time sequential, ``o_t = r_t (S_{t-1} + diag(u)
k_t^T v_t)`` and ``S_t = diag(w_t) S_{t-1} + k_t^T v_t`` with a (D, D)
float32 state.  The CUDA source (``csrc/rwkv6_scan.cu``) keeps the state
in registers for the whole sequence; see its header for the design.
``rwkv6_scan.launches`` counts kernel launches.

The reference's kernel route has no gradient (no ``custom_vjp``), and
neither does this one: ``ops.rwkv6_scan`` refuses a recording autograd
graph on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)  # instantiated template head dims


def rwkv6_scan(
    r: torch.Tensor,  # (B, H, T, D)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # decay in (0, 1)
    u: torch.Tensor,  # (H, D)
    state0: torch.Tensor | None = None,  # (B, H, D, D) float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; same contract as
    ``ref.rwkv6_scan``: ``(o (B, H, T, D) in r's type, S_T (B, H, D, D)
    float32)``.  ``r, k, v, w, u`` share one type (float32 or bfloat16);
    any strides are taken as long as the last axis is contiguous, and ``o``
    gets ``r``'s memory layout (so the time mix's ``(B, T, H, D)`` views go
    in and come out without a copy).  ``D`` is 64 or 128 and ``T >= 1``."""
    dev = r.device
    if dev.type != "cuda":
        raise ValueError("rwkv6_scan kernel needs CUDA tensors")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, w, u)):
        raise ValueError(f"rwkv6_scan kernel takes float32 or bfloat16 r, k, v, w, u of one "
                         f"type, got {[t.dtype for t in (r, k, v, w, u)]}")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError("rwkv6_scan: r, k, v, w must be (B, H, T, D) of one shape")
    b, h, t, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan kernel takes head dims {HEAD_DIMS}, got {d}")
    if t < 1:
        raise ValueError("rwkv6_scan kernel needs T >= 1")
    if tuple(u.shape) != (h, d):
        raise ValueError(f"rwkv6_scan: u must be ({h}, {d}), got {tuple(u.shape)}")
    if state0 is not None and (tuple(state0.shape) != (b, h, d, d) or state0.dtype != torch.float32):
        raise ValueError(f"rwkv6_scan: state0 must be float32 ({b}, {h}, {d}, {d})")
    if any(x.device != dev for x in (k, v, w, u) + (() if state0 is None else (state0,))):
        raise ValueError("rwkv6_scan: all operands must lie on one device")
    r, k, v, w = (x if x.stride(-1) == 1 else x.contiguous() for x in (r, k, v, w))
    u = u.contiguous()
    s0 = None if state0 is None else state0.contiguous()
    o = torch.empty_like(r)  # r's strides when r is dense, else contiguous
    sf = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    if b == 0 or h == 0:
        return o, sf
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = _build.launch_fn("rwkv6_scan", "rwkv6_scan_launch",
                          [vp] * 8 + [ctypes.c_int] * 4 + [ll] * 15 + [ctypes.c_int, vp])
    strides = [s for x in (r, k, v, w, o) for s in x.stride()[:3]]
    with torch.cuda.device(dev):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                 None if s0 is None else s0.data_ptr(), o.data_ptr(), sf.data_ptr(),
                 b, h, t, d, *strides, _DTYPES[r.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("rwkv6_scan", err)
    rwkv6_scan.launches += 1
    return o, sf


rwkv6_scan.launches = 0
