"""Flash-attention forward on Hopper: wrapper and launch.

Ports ``repro.kernels.flash_attention._flash_fwd`` (Pallas
``_flash_kernel``) together with the GQA grouping of its public wrapper:
causal or non-causal online-softmax attention that returns the output in
the input type and the row log-sum-exp in float32.  The CUDA source
(``csrc/flash_attention.cu``) reads KV head ``h // (H // Hkv)`` directly
(no repeated K/V), skips key tiles above the causal diagonal and masks
ragged tails itself, so every sequence length runs the kernel.

The backward ports ``_flash_bwd`` (Pallas ``_flash_bwd_dkv_kernel`` and
``_flash_bwd_dq_kernel``, ``csrc/flash_attention_bwd.cu``): two kernels
that recompute the probabilities from the forward's log-sum-exp, the
dK/dV one summing the GQA head group in float32.  ``FlashAttention`` is
the ``torch.autograd.Function`` that pairs them, the counterpart of the
reference's ``_flash_core`` with ``defvjp``.  ``flash_attention_fwd``,
``flash_bwd_dkv`` and ``flash_bwd_dq`` each count their launches in
``.launches``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)  # instantiated template head dims; others are zero-padded up


def flash_attention_fwd(
    q: torch.Tensor,  # (B, H, Tq, D)
    k: torch.Tensor,  # (B, Hkv, Tk, D)
    v: torch.Tensor,  # (B, Hkv, Tk, D)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; returns ``(o, lse)`` like
    ``ref.attention(..., with_lse=True)``.  Any strides are taken as long
    as the last axis is contiguous; ``o`` is laid out ``(B, Tq, H, D)`` in
    memory (returned as its ``(B, H, Tq, D)`` view), so merging the heads
    afterwards is free.  A head dim between the instantiated ones (say 30)
    is zero-padded to the next one.  Causal attention needs ``Tq <= Tk``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 q, k, v of one "
                         f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.device != dev or v.device != dev:
        raise ValueError("flash_attention: q (B, H, Tq, D), k and v (B, Hkv, Tk, D) on one device")
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv:
        raise ValueError(f"flash_attention: incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    if d > HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention kernel takes head dims up to {HEAD_DIMS[-1]}, got {d}")
    if causal and tq > tk:
        raise ValueError(f"flash_attention: causal attention needs Tq <= Tk, got {tq} > {tk}")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B * H = {b * h} exceeds the grid's 65535")
    if scale is None:
        scale = 1.0 / (d**0.5)
    dk = next(n for n in HEAD_DIMS if n >= d)
    if dk != d:
        # Zero columns add nothing to q k^T, and the output's are cut off.
        o, lse = flash_attention_fwd(*(F.pad(t, (0, dk - d)) for t in (q, k, v)),
                                     causal=causal, scale=scale)
        return o[..., :d], lse
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=dev)
    if b == 0 or tq == 0:
        return o, lse
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = _build.launch_fn("flash_attention", "flash_fwd_launch",
                          [vp] * 5 + [ctypes.c_int] * 6 + [ll] * 12
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_int, vp])
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 b, h, hkv, tq, tk, d, *strides, float(scale), int(causal),
                 _DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("flash_attention", err)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _check_bwd_operands(q, k, v, o, lse, do, causal):
    dev = q.device
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise ValueError(f"flash_attention backward takes float32 or bfloat16 q, k, v, o, do of "
                         f"one type, got {[t.dtype for t in (q, k, v, o, do)]}")
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if (k.shape != v.shape or o.shape != q.shape or do.shape != q.shape or k.shape[0] != b
            or k.shape[3] != d or h % hkv or lse.shape != (b, h, tq) or lse.dtype != torch.float32
            or any(t.device != dev for t in (k, v, o, lse, do))):
        raise ValueError("flash_attention backward: q, o, do (B, H, Tq, D), k, v (B, Hkv, Tk, D) "
                         "and a float32 lse (B, H, Tq) on one device")
    if d > HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention kernel takes head dims up to {HEAD_DIMS[-1]}, got {d}")
    if causal and tq > tk:
        raise ValueError(f"flash_attention: causal attention needs Tq <= Tk, got {tq} > {tk}")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B * H = {b * h} exceeds the grid's 65535")


def _strides(*ts) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(ts)))(*(s for t in ts for s in t.stride()[:3]))


def _bwd_args(q, k, v, do, lse, delta):
    b, h, tq, d = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr()), (b, h, k.shape[1], tq, k.shape[2], d)


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """Launch the dK/dV kernel on prepared operands (head dim instantiated,
    last axes contiguous, ``lse`` and ``delta`` contiguous float32
    ``(B, H, Tq)``); returns ``(dk, dv)`` in ``k``'s type, laid out
    ``(B, Tk, Hkv, D)`` in memory."""
    b, hkv, tk, d = k.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention backward kernels need CUDA tensors")
    dk = torch.empty((b, tk, hkv, d), dtype=k.dtype, device=dev).transpose(1, 2)
    dv = torch.empty_like(dk)
    vp, ii = ctypes.c_void_p, ctypes.c_int
    fn = _build.launch_fn("flash_attention_bwd", "flash_bwd_dkv_launch",
                          [vp] * 8 + [ii] * 6 + [vp, ctypes.c_float, ii, ii, vp])
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta)
    with torch.cuda.device(dev):
        err = fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims, _strides(q, k, v, do, dk, dv),
                 float(scale), int(causal), _DTYPES[q.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("flash_attention_bwd (dK/dV)", err)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """Launch the dQ kernel on operands prepared as for ``flash_bwd_dkv``;
    returns ``dq`` in ``q``'s type, laid out ``(B, Tq, H, D)`` in memory."""
    b, h, tq, d = q.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention backward kernels need CUDA tensors")
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    vp, ii = ctypes.c_void_p, ctypes.c_int
    fn = _build.launch_fn("flash_attention_bwd", "flash_bwd_dq_launch",
                          [vp] * 7 + [ii] * 6 + [vp, ctypes.c_float, ii, ii, vp])
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta)
    with torch.cuda.device(dev):
        err = fn(*ptrs, dq.data_ptr(), *dims, _strides(q, k, v, do, dq), float(scale),
                 int(causal), _DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("flash_attention_bwd (dQ)", err)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,  # (B, H, Tq, D)
    k: torch.Tensor,  # (B, Hkv, Tk, D)
    v: torch.Tensor,  # (B, Hkv, Tk, D)
    o: torch.Tensor,  # (B, H, Tq, D), the forward's output
    lse: torch.Tensor,  # (B, H, Tq) float32, the forward's log-sum-exp
    do: torch.Tensor,  # (B, H, Tq, D), the output's cotangent
    *,
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of ``ref.flash_attention_bwd`` from the two CUDA
    kernels: ``delta = sum(do * o)`` in float32 (as the reference computes
    it before its ``pallas_call``s), then dK/dV and dQ.  Any strides are
    taken (a tensor whose last axis is not contiguous, such as an expanded
    ``do``, is copied first); a head dim between the instantiated ones is
    zero-padded, with the scale taken from the unpadded one."""
    _check_bwd_operands(q, k, v, o, lse, do, causal)
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    dk_ = next(n for n in HEAD_DIMS if n >= d)
    if dk_ != d:
        # Zero columns add nothing to q k^T, dO V^T or delta; the padded
        # gradient columns are cut off.
        dq, dk, dv = flash_attention_bwd(*(F.pad(t, (0, dk_ - d)) for t in (q, k, v, o)), lse,
                                         F.pad(do, (0, dk_ - d)), causal=causal, scale=scale)
        return dq[..., :d], dk[..., :d], dv[..., :d]
    q, k, v, do = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, do))
    lse = lse.contiguous()
    delta = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1).contiguous()
    if q.shape[0] == 0 or q.shape[2] == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention on the card: the forward kernel saves
    ``q, k, v, o, lse``; the backward launches the dK/dV and dQ kernels
    (``repro.kernels.flash_attention._flash_core`` with ``defvjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float | None):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None
