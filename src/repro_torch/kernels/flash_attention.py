"""Flash-attention forward on Hopper: wrapper and launch.

Ports ``repro.kernels.flash_attention._flash_fwd`` (Pallas
``_flash_kernel``) together with the GQA grouping of its public wrapper:
causal or non-causal online-softmax attention that returns the output in
the input type and the row log-sum-exp in float32.  The CUDA source
(``csrc/flash_attention.cu``) runs bf16 on the tensor cores (``mma.sync``
with the float32 probabilities split into three bf16 parts, so the P V
product multiplies float32 P) and float32 as FP32 FMAs; both read KV head
``h // (H // Hkv)`` directly (no repeated K/V), skip key tiles above the
causal diagonal and mask ragged tails themselves, so every sequence length
runs the kernel.

The backward ports ``_flash_bwd`` (Pallas ``_flash_bwd_dkv_kernel`` and
``_flash_bwd_dq_kernel``, ``csrc/flash_attention_bwd.cu``): two kernels
that recompute the probabilities from the forward's log-sum-exp, the
dK/dV one summing the GQA head group in float32.  bf16 at head dims 32,
64 and 128 runs them on the tensor cores (``mma.sync``, the float32
probabilities and dS split into three bf16 parts); float32, and bf16 at
160 and up, on FP32 FMAs.  ``FlashAttention`` is the
``torch.autograd.Function`` that pairs them, the counterpart of the
reference's ``_flash_core`` with ``defvjp``.  ``flash_attention_fwd``,
``flash_bwd_dkv`` and ``flash_bwd_dq`` each count their launches in
``.launches``, the backward ones also by route (``bwd_route``, which the
launches follow) in ``.route_launches``.

Any head dim runs: above 256 the kernels split the head dim into column
chunks (``column_chunks``) on a grid axis, each block computing the scores
over the full head dim and writing only its chunk of the output.  The
kernels take one head dim for q, k and v; a value head dim other than the
query's (DeepSeek MLA: q and k 192, v 128) is zero-padded to the wider of
the two and the output cut back (``flash_attention_fwd`` and
``FlashAttention``): zero value columns add zero output columns, and the
backward's ``dv`` is cut the same way.  At 192/128 this costs 1.5x the P V
work.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Instantiated column-chunk widths, forward and backward alike: a head dim
# up to 256 is one chunk of the next width up (zero-padded), a larger one
# n chunks of a width from 160 up (``column_chunks``).  At W = 256 the
# FP32-FMA backward kernels walk 32-row tiles so their tiles fit the 227 KB
# a block may use.
HEAD_DIMS = (32, 64, 128, 160, 192, 256)
# Head dims whose bf16 backward runs on the tensor cores; from 160 on the
# dK/dV kernel's float32 accumulators (D floats a thread) would spill.
TC_BWD_HEAD_DIMS = (32, 64, 128)
# The backward's routes (``bwd_route``); each backward wrapper counts its
# launches by route in ``.route_launches``.
BWD_ROUTES = ("tensor cores", "fp32 fma")
_MAX_ROWS = 64 * 65535  # query (or key) tiles of 64 ride gridDim.y


def column_chunks(d: int) -> tuple[int, int]:
    """``(n_chunks, width)`` of head dim ``d``: as few chunks as a width of
    at most 256 allows, each of the narrowest instantiated width that
    covers ``d`` in that many.  The kernels run one block per chunk of
    output columns (``gridDim.z``); ``n_chunks * width >= d``, and the
    padding columns are zero."""
    if d < 1:
        raise ValueError(f"flash_attention: head dim must be positive, got {d}")
    n = -(-d // HEAD_DIMS[-1])
    return n, next(w for w in HEAD_DIMS if n * w >= d)


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run for ``d``: ``n_chunks * width`` of
    ``column_chunks``, whose extra zero columns change nothing (``d``
    itself or the next instantiated one up to 256)."""
    n, w = column_chunks(d)
    return n * w


def _check_grid(b: int, h: int, tq: int, tk: int) -> None:
    """The kernels' only shape limits: the batch-head index rides
    ``gridDim.x`` (``B * H < 2**31``) and the 64-row query or key tiles
    ``gridDim.y`` (``Tq, Tk <= 64 * 65535``)."""
    if b * h > 2**31 - 1 or max(tq, tk) > _MAX_ROWS:
        raise ValueError(f"flash_attention: B * H = {b * h} must stay below 2**31 and Tq, Tk "
                         f"= {tq}, {tk} at most {_MAX_ROWS}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether the forward kernel can read ``t``'s rows in place: the last
    axis contiguous and, for bf16 (which the tensor-core kernel stages with
    16-byte copies), every row starting on a 16-byte boundary."""
    if t.stride(-1) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])


def pad_value(v: torch.Tensor, d: int) -> torch.Tensor:
    """``v (B, Hkv, Tk, Dv)`` zero-padded to head dim ``d >= Dv`` (``v``
    itself when ``Dv == d``): the kernels' operand for a value head dim
    narrower than the query's."""
    return v if v.shape[-1] == d else F.pad(v, (0, d - v.shape[-1]))


def flash_attention_fwd(
    q: torch.Tensor,  # (B, H, Tq, D)
    k: torch.Tensor,  # (B, Hkv, Tk, D)
    v: torch.Tensor,  # (B, Hkv, Tk, Dv)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; returns ``(o, lse)`` like
    ``ref.attention(..., with_lse=True)``, ``o`` of head dim ``Dv``.  Any
    strides are taken as long
    as the last axis is contiguous (bf16 rows not on 16-byte boundaries
    are copied first); ``o`` is laid out ``(B, Tq, H, D)`` in
    memory (returned as its ``(B, H, Tq, D)`` view), so merging the heads
    afterwards is free.  Any head dim runs: one between the instantiated
    widths (say 30) is zero-padded to the next one, one above 256 to whole
    column chunks (``kernel_head_dim``).  A value head dim ``Dv < D`` is
    zero-padded to ``D`` and the output cut back to ``Dv`` (a view of the
    padded output).  Causal attention needs ``Tq <= Tk``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 q, k, v of one "
                         f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or k.shape[:3] != v.shape[:3]
            or k.device != dev or v.device != dev):
        raise ValueError("flash_attention: q (B, H, Tq, D), k (B, Hkv, Tk, D) and v (B, Hkv, Tk, "
                         "Dv) on one device")
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv or v.shape[3] > d:
        raise ValueError(f"flash_attention: incompatible q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} (the value head dim at most the query's)")
    dk = kernel_head_dim(d)
    if causal and tq > tk:
        raise ValueError(f"flash_attention: causal attention needs Tq <= Tk, got {tq} > {tk}")
    _check_grid(b, h, tq, tk)
    if scale is None:
        scale = 1.0 / (d**0.5)
    if v.shape[3] != d:
        # Zero value columns add zero output columns, which are cut off.
        o, lse = flash_attention_fwd(q, k, pad_value(v, d), causal=causal, scale=scale)
        return o[..., :v.shape[3]], lse
    if dk != d:
        # Zero columns add nothing to q k^T, and the output's are cut off.
        o, lse = flash_attention_fwd(*(F.pad(t, (0, dk - d)) for t in (q, k, v)),
                                     causal=causal, scale=scale)
        return o[..., :d], lse
    q, k, v = (t if _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=dev)
    if b == 0 or tq == 0:
        return o, lse
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = _build.launch_fn("flash_attention", "flash_fwd_launch",
                          [vp] * 5 + [ctypes.c_int] * 7 + [ll] * 12
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_int, vp])
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 b, h, hkv, tq, tk, d, column_chunks(d)[0], *strides, float(scale), int(causal),
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
    column_chunks(d)
    if causal and tq > tk:
        raise ValueError(f"flash_attention: causal attention needs Tq <= Tk, got {tq} > {tk}")
    _check_grid(b, h, tq, tk)


def _strides(*ts) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(ts)))(*(s for t in ts for s in t.stride()[:3]))


def _bwd_args(q, k, v, do, lse, delta):
    b, h, tq, d = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr()), (b, h, k.shape[1], tq, k.shape[2], d, column_chunks(d)[0])


def bwd_route(d: int, dtype: torch.dtype) -> str:
    """Which backward kernels serve head dim ``d`` (after padding) in
    ``dtype``: ``"tensor cores"`` (bf16 in one chunk of 32, 64 or 128
    columns) or ``"fp32 fma"`` (everything else, in ``column_chunks(d)``
    chunks).  The launches take their route from here; the launcher
    refuses a route its kernels do not run."""
    n, w = column_chunks(d)
    tc = dtype == torch.bfloat16 and n == 1 and w in TC_BWD_HEAD_DIMS
    return "tensor cores" if tc else "fp32 fma"


def _launch_bwd(which: str, wrapper, symbol: str, n_out: int, q, k, v, do, lse, delta, outs,
                causal: bool, scale: float) -> None:
    """Launch one backward kernel on the route ``bwd_route`` picks and
    count the launch in ``wrapper.launches`` and ``wrapper.route_launches``."""
    dev = q.device
    vp, ii = ctypes.c_void_p, ctypes.c_int
    fn = _build.launch_fn("flash_attention_bwd", symbol,
                          [vp] * (6 + n_out) + [ii] * 7 + [vp, ctypes.c_float, ii, ii, ii, vp])
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta)
    route = bwd_route(q.shape[-1], q.dtype)
    with torch.cuda.device(dev):
        err = fn(*ptrs, *(t.data_ptr() for t in outs), *dims, _strides(q, k, v, do, *outs),
                 float(scale), int(causal), _DTYPES[q.dtype], int(route == "tensor cores"),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(f"flash_attention_bwd ({which})", err)
    wrapper.launches += 1
    wrapper.route_launches[route] += 1


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """Launch the dK/dV kernel on prepared operands (head dim
    ``kernel_head_dim``, last axes contiguous, bf16 rows 16-byte aligned,
    ``lse`` and ``delta`` contiguous float32 ``(B, H, Tq)``); returns
    ``(dk, dv)`` in ``k``'s type, laid out ``(B, Tk, Hkv, D)`` in memory."""
    b, hkv, tk, d = k.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention backward kernels need CUDA tensors")
    dk = torch.empty((b, tk, hkv, d), dtype=k.dtype, device=dev).transpose(1, 2)
    dv = torch.empty_like(dk)
    _launch_bwd("dK/dV", flash_bwd_dkv, "flash_bwd_dkv_launch", 2, q, k, v, do, lse, delta,
                (dk, dv), causal, scale)
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.route_launches = dict.fromkeys(BWD_ROUTES, 0)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """Launch the dQ kernel on operands prepared as for ``flash_bwd_dkv``;
    returns ``dq`` in ``q``'s type, laid out ``(B, Tq, H, D)`` in memory."""
    b, h, tq, d = q.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention backward kernels need CUDA tensors")
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    _launch_bwd("dQ", flash_bwd_dq, "flash_bwd_dq_launch", 1, q, k, v, do, lse, delta, (dq,),
                causal, scale)
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.route_launches = dict.fromkeys(BWD_ROUTES, 0)


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
    ``do``, or a bf16 one whose rows are not 16-byte aligned, is copied
    first); any head dim runs, zero-padded to ``kernel_head_dim`` with the
    scale taken from the unpadded one."""
    _check_bwd_operands(q, k, v, o, lse, do, causal)
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    dk_ = kernel_head_dim(d)
    if dk_ != d:
        # Zero columns add nothing to q k^T, dO V^T or delta; the padded
        # gradient columns are cut off.
        dq, dk, dv = flash_attention_bwd(*(F.pad(t, (0, dk_ - d)) for t in (q, k, v, o)), lse,
                                         F.pad(do, (0, dk_ - d)), causal=causal, scale=scale)
        return dq[..., :d], dk[..., :d], dv[..., :d]
    q, k, v, do = (t if _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v, do))
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
    (``repro.kernels.flash_attention._flash_core`` with ``defvjp``).  A
    value head dim narrower than the query's runs zero-padded (``v`` and
    the cotangent), and its ``dv`` is cut back."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float | None):
        dv = v.shape[-1]
        if scale is None:
            scale = 1.0 / (q.shape[-1] ** 0.5)
        v = pad_value(v, q.shape[-1])
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.dv = causal, scale, dv
        return o if dv == o.shape[-1] else o[..., :dv]

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, pad_value(do, q.shape[-1]),
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv[..., :ctx.dv], None, None
