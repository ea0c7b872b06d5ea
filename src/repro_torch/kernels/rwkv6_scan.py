"""RWKV-6 recurrence on Hopper: wrapper and launch.

Ports ``repro.kernels.rwkv6_scan.rwkv6_scan`` (Pallas ``_rwkv6_kernel``):
per (batch, head), with time sequential, ``o_t = r_t (S_{t-1} + diag(u)
k_t^T v_t)`` and ``S_t = diag(w_t) S_{t-1} + k_t^T v_t`` with a (D, D)
float32 state.  The CUDA source (``csrc/rwkv6_scan.cu``) keeps the state
in registers for the whole sequence, a column's rows split over several
threads, and stages the inputs a chunk of steps at a time (``lane_plan``);
above head dim 1024 a column's rows are split into slabs whose partial
outputs a second kernel sums.  A single step (a decode) up to head dim 128
runs the step kernel, one thread a column, which is faster there and does
the chunk kernel's arithmetic in its order, so a step rounds alike in
either.  See the source's header for both.
``rwkv6_scan.launches`` counts the calls that launch the kernel,
``rwkv6_scan.sum_launches`` those that also launch the slab sum.

The reference's kernel route has no gradient (no ``custom_vjp``), and
neither does this one: under a recording autograd graph ``ops.rwkv6_scan``
takes the plain forms, the reference's training route, and launches
nothing.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Head dims the kernel runs as they are up to 256; above, D is padded to a
# multiple of LANE_ROWS, the rows a thread holds there.
HEAD_DIMS = (32, 64, 128, 256)
LANE_ROWS = 128
MAX_PARTS = 8  # threads of a column in one block (a slab of its rows)
MAX_THREADS = 256


class Plan(NamedTuple):
    """How a kernel splits the state of one head (``lane_plan``)."""

    d: int  # the kernel's head dim
    rows: int  # rows of a column a thread holds, or sums as one part
    span: int  # adjacent columns a thread holds
    parts: int  # threads of a column in a block: a slab of parts x rows rows
    cols: int  # columns a block
    slabs: int  # slabs of a column's rows, one set of blocks each
    chunk: int  # steps staged a barrier


def kernel_head_dim(d: int) -> int:
    """The head dim the kernel runs for ``d``: ``d`` or the next
    instantiated one up to 256, else ``d`` rounded up to a multiple of 128.
    Zero padding is exact: zero ``k`` rows keep the padded state rows at
    zero from a zero-padded ``state0``, zero ``v`` columns keep the padded
    state columns at zero, zero ``r`` and ``u`` add nothing to ``o``, and
    the padded columns of ``o`` are cut off.  No upper limit: a column's
    rows above 1024 are split into slabs (``lane_plan``)."""
    if d > HEAD_DIMS[-1]:
        return -(-d // LANE_ROWS) * LANE_ROWS
    return next(n for n in HEAD_DIMS if n >= d)


def lane_plan(d: int, steps: int = 2) -> Plan:
    """How the kernel splits the state of head dim ``d``
    (``D = kernel_head_dim(d)``) for a call of ``steps`` steps.

    A single step up to D = 128 runs the step kernel: one thread a column,
    D columns a block, summing the column in ``parts`` parts of ``rows``
    rows as the chunk kernel's threads do.  Every other call runs the chunk
    kernel: a column's rows over threads of ``rows`` rows (D / 8 up to
    D = 256, at least 8; 128 above), each holding ``span`` adjacent columns
    (2 up to 256, 1 above), ``parts`` of them in one block (at most 8: a
    slab of ``parts x rows`` rows; above D = 1024 the ``slabs`` slabs as
    even as whole threads allow, the last one taking what is left),
    ``cols`` columns a block (64 where the block fits 256 threads and D,
    else 32) and ``chunk`` steps of inputs staged a barrier (16 up to 128,
    8 at 256, 1 above).  The launch refuses a plan that its kernels do not
    run."""
    dk = kernel_head_dim(d)
    if dk <= HEAD_DIMS[-1]:
        rows = max(8, dk // MAX_PARTS)
        if steps == 1 and dk <= 128:
            return Plan(dk, rows, 1, dk // rows, dk, 1, 1)
        span, parts, slabs, chunk = 2, dk // rows, 1, 16 if dk <= 128 else 8
    else:
        rows, span, chunk = LANE_ROWS, 1, 1
        lanes = dk // LANE_ROWS
        slabs = -(-lanes // MAX_PARTS)
        parts = -(-lanes // slabs)
    cols = 64 if 64 // span * parts <= MAX_THREADS and dk % 64 == 0 else 32
    return Plan(dk, rows, span, parts, cols, slabs, chunk)


def _vector_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the kernel can read its rows in four-element loads (a
    contiguous last axis, the other strides multiples of 4, an aligned
    start), else a contiguous copy."""
    ok = (x.stride(-1) == 1 and all(s % 4 == 0 for s in x.stride()[:-1])
          and x.data_ptr() % (4 * x.element_size()) == 0)
    return x if ok else torch.empty_like(x, memory_format=torch.contiguous_format).copy_(x)


def rwkv6_scan(
    r: torch.Tensor,  # (B, H, T, D)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # decay in (0, 1)
    u: torch.Tensor,  # (H, D)
    state0: torch.Tensor | None = None,  # (B, H, D, D) float32
    plan: Plan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; same contract as
    ``ref.rwkv6_scan``: ``(o (B, H, T, D) in r's type, S_T (B, H, D, D)
    float32)``.  ``r, k, v, w, u`` share one type (float32 or bfloat16);
    any strides are taken as long as the last axis is contiguous, and ``o``
    gets ``r``'s memory layout (so the time mix's ``(B, T, H, D)`` views go
    in and come out without a copy; a misaligned one is copied first).
    Any ``D`` (other than 32, 64, 128, 256 and multiples of 128 above
    zero-padded, ``kernel_head_dim``) and ``T >= 1``.  ``plan`` replaces
    ``lane_plan(D, T)``, to run a call on another plan of the same head
    dim (the chunk kernel's single step, held against the step kernel)."""
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
        o, sf = rwkv6_scan(*(F.pad(x, (0, pad)) for x in (r, k, v, w, u)), s0, plan)
        return o[..., :d], sf[..., :d, :d].contiguous()
    r, k, v, w = (_vector_ready(x) for x in (r, k, v, w))
    u = u.contiguous()
    s0 = None if state0 is None else state0.contiguous()
    o = torch.empty_like(r)  # r's strides when r is dense, else contiguous
    sf = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    if b == 0 or h == 0:
        return o, sf
    plan = lane_plan(d, t) if plan is None else plan
    if plan.d != d:
        raise ValueError(f"rwkv6_scan: a plan of head dim {plan.d} for head dim {d}")
    opart = (torch.empty((plan.slabs, b, h, t, d), dtype=torch.float32, device=dev)
             if plan.slabs > 1 else None)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = _build.launch_fn("rwkv6_scan", "rwkv6_scan_launch",
                          [vp] * 9 + [ctypes.c_int] * 10 + [ll] * 15 + [ctypes.c_int, vp])
    strides = [s for x in (r, k, v, w, o) for s in x.stride()[:3]]
    with torch.cuda.device(dev):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                 None if s0 is None else s0.data_ptr(), o.data_ptr(),
                 None if opart is None else opart.data_ptr(), sf.data_ptr(),
                 b, h, t, d, plan.rows, plan.span, plan.parts, plan.cols, plan.slabs,
                 min(plan.chunk, t), *strides,
                 _DTYPES[r.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("rwkv6_scan", err)
    rwkv6_scan.launches += 1
    rwkv6_scan.sum_launches += int(plan.slabs > 1)
    return o, sf


rwkv6_scan.launches = 0
rwkv6_scan.sum_launches = 0
