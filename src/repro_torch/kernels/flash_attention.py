"""Flash-attention forward on Hopper: wrapper and launch.

Ports ``repro.kernels.flash_attention._flash_fwd`` (Pallas
``_flash_kernel``) together with the GQA grouping of its public wrapper:
causal or non-causal online-softmax attention that returns the output in
the input type and the row log-sum-exp in float32.  The CUDA source
(``csrc/flash_attention.cu``) reads KV head ``h // (H // Hkv)`` directly
(no repeated K/V), skips key tiles above the causal diagonal and masks
ragged tails itself, so every sequence length runs the kernel.  Only the
forward is ported: the backward kernels come with the training slice
(ROADMAP.md), and ``ops.attention`` refuses to record a graph through this
path.  ``flash_attention_fwd.launches`` counts kernel launches.
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
