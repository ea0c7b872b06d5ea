"""RWKV-6 recurrence on Hopper: wrapper and launch.

Ports ``repro.kernels.rwkv6_scan.rwkv6_scan`` (Pallas ``_rwkv6_kernel``):
per (batch, head), with time sequential, ``o_t = r_t (S_{t-1} + diag(u)
k_t^T v_t)`` and ``S_t = diag(w_t) S_{t-1} + k_t^T v_t`` with a (D, D)
float32 state.  The CUDA source (``csrc/rwkv6_scan.cu``) keeps the state
in registers for the whole sequence (a column split over two threads at
D = 256, over D / 128 lanes above; ``lane_plan``); see its header for the
design.
``rwkv6_scan.launches`` counts kernel launches.

The reference's kernel route has no gradient (no ``custom_vjp``), and
neither does this one: ``ops.rwkv6_scan`` refuses a recording autograd
graph on the card.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Instantiated template head dims up to 256.  A thread keeps a column of
# the (D, D) float32 state in registers, 128 rows at most: at D = 256 two
# threads share a column (255 registers a thread); above 256, D is padded
# to a multiple of 128 and D / 128 lanes share a column (``lane_plan``).
HEAD_DIMS = (32, 64, 128, 256)
LANE_ROWS = 128
# A column's lanes must fit one warp (32 x 128 rows); the state is then a
# 64 MB float32 matrix a head.
MAX_HEAD_DIM = 32 * LANE_ROWS


def kernel_head_dim(d: int) -> int:
    """The head dim the kernel runs for ``d``: ``d`` or the next
    instantiated one up to 256, else ``d`` rounded up to a multiple of 128.
    Zero padding is exact: zero ``k`` rows keep the padded state rows at
    zero from a zero-padded ``state0``, zero ``v`` columns keep the padded
    state columns at zero, zero ``r`` and ``u`` add nothing to ``o``, and
    the padded columns of ``o`` are cut off.  Raises above 4096, where a
    column would need more lanes than a warp has (and a head's float32
    state is 64 MB)."""
    if d > MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan kernel takes head dims up to {MAX_HEAD_DIM} (a column's "
                         f"{MAX_HEAD_DIM // LANE_ROWS} lanes of {LANE_ROWS} rows fill a warp; a "
                         f"head's float32 state is 64 MB), got {d}")
    if d > HEAD_DIMS[-1]:
        return -(-d // LANE_ROWS) * LANE_ROWS
    return next(n for n in HEAD_DIMS if n >= d)


def lane_plan(d: int) -> tuple[int, int, int, int]:
    """How the kernel splits the state of head dim ``d``: ``(D, lanes,
    group, columns)`` with ``D = kernel_head_dim(d)``, ``lanes`` threads
    holding ``D / lanes`` rows of a column each, in a shuffle group of
    ``group`` adjacent lanes (``lanes`` rounded up to a power of two; the
    extra lanes hold no rows) and ``columns`` columns a block (a head's
    ``D`` columns over ``D / columns`` blocks).  The launch takes ``group``
    and ``columns`` from here; the launcher refuses a plan that ``D``'s
    kernel does not run."""
    dk = kernel_head_dim(d)
    if dk <= HEAD_DIMS[-1]:
        lanes = 2 if dk > LANE_ROWS else 1
        return dk, lanes, lanes, dk // lanes
    lanes = dk // LANE_ROWS
    group = 1 << (lanes - 1).bit_length()
    return dk, lanes, group, 256 // group


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
    in and come out without a copy).  ``D <= 4096`` (other than 32, 64, 128,
    256 and multiples of 128 above zero-padded, ``kernel_head_dim``) and
    ``T >= 1``."""
    dev = r.device
    if dev.type != "cuda":
        raise ValueError("rwkv6_scan kernel needs CUDA tensors")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, w, u)):
        raise ValueError(f"rwkv6_scan kernel takes float32 or bfloat16 r, k, v, w, u of one "
                         f"type, got {[t.dtype for t in (r, k, v, w, u)]}")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError("rwkv6_scan: r, k, v, w must be (B, H, T, D) of one shape")
    b, h, t, d = r.shape
    dk = kernel_head_dim(d)
    if t < 1:
        raise ValueError("rwkv6_scan kernel needs T >= 1")
    if tuple(u.shape) != (h, d):
        raise ValueError(f"rwkv6_scan: u must be ({h}, {d}), got {tuple(u.shape)}")
    if state0 is not None and (tuple(state0.shape) != (b, h, d, d) or state0.dtype != torch.float32):
        raise ValueError(f"rwkv6_scan: state0 must be float32 ({b}, {h}, {d}, {d})")
    if any(x.device != dev for x in (k, v, w, u) + (() if state0 is None else (state0,))):
        raise ValueError("rwkv6_scan: all operands must lie on one device")
    if dk != d:
        pad = dk - d
        s0 = None if state0 is None else F.pad(state0, (0, pad, 0, pad))
        o, sf = rwkv6_scan(*(F.pad(x, (0, pad)) for x in (r, k, v, w, u)), s0)
        return o[..., :d], sf[..., :d, :d].contiguous()
    r, k, v, w = (x if x.stride(-1) == 1 else x.contiguous() for x in (r, k, v, w))
    u = u.contiguous()
    s0 = None if state0 is None else state0.contiguous()
    o = torch.empty_like(r)  # r's strides when r is dense, else contiguous
    sf = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    if b == 0 or h == 0:
        return o, sf
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = _build.launch_fn("rwkv6_scan", "rwkv6_scan_launch",
                          [vp] * 8 + [ctypes.c_int] * 6 + [ll] * 15 + [ctypes.c_int, vp])
    strides = [s for x in (r, k, v, w, o) for s in x.stride()[:3]]
    _, _, group, cols = lane_plan(d)
    with torch.cuda.device(dev):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                 None if s0 is None else s0.data_ptr(), o.data_ptr(), sf.data_ptr(),
                 b, h, t, d, group, cols, *strides, _DTYPES[r.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("rwkv6_scan", err)
    rwkv6_scan.launches += 1
    return o, sf


rwkv6_scan.launches = 0
