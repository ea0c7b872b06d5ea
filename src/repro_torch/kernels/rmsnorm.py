"""RMSNorm on Hopper: wrapper and launch.

Ports ``repro.kernels.rmsnorm.rmsnorm`` (Pallas ``_rmsnorm_kernel``):
``x * rsqrt(mean(x^2) + eps) * w`` over the last axis, statistics in
float32, the result in ``x.dtype``.  The CUDA source
(``csrc/rmsnorm.cu``) reads each row once as 16-byte vectors where ``D`` is
a multiple of 8 of at most ``ROW_MAX_VECTORS`` vectors and the tensors are
aligned, on a persistent grid that ``launch_plan`` sizes to the card, and
takes a scalar route for any other ``D``; see its header for the design.
``rmsnorm.launches`` counts kernel launches.

``RMSNorm`` makes the kernel differentiable: its forward launches the
kernel, its backward is the gradient of the plain version (``ref.rmsnorm``)
recomputed from ``x`` and the weight with plain PyTorch ops.  The
reference has no backward kernel either (``repro.kernels.rmsnorm`` has no
VJP, so JAX differentiates its jnp reference), so this is the port of what
it runs, not a fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# csrc/rmsnorm.cu's kRowMaxVec, kStageMaxD, kRowThreads and kAnyThreads.
ROW_MAX_VECTORS = 4096
STAGE_MAX_D = 10240
ROW_THREADS = 256
ANY_THREADS = 256
# CH of the plan with the weight in registers, by G x CH = P / 32 (the
# fastest of every plan at the main paths' shapes on an H100, PERF.md).
REGISTER_CHUNKS = {1: 1, 2: 2, 4: 2, 8: 2, 16: 4, 32: 4, 64: 8, 128: 8}
# The row route's instantiations, (G warps a row, CH 16-byte vectors a
# lane, the weight staged): the plans ``launch_plan`` picks, no other.
ROW_PLANS = tuple((n // ch, ch, 0) for n, ch in REGISTER_CHUNKS.items()) + (
    (4, 8, 1), (8, 8, 1), (16, 8, 1))


class Plan(NamedTuple):
    """How a call's rows go onto the card (``launch_plan``)."""

    warps_per_row: int  # G, the warps of a row group; 0 on the scalar route
    chunks: int  # CH, 16-byte vectors a lane holds (0 on the scalar route)
    stage: int  # 1: the weight staged in shared memory, 0: in registers
    blocks: int  # the grid

    @property
    def route(self) -> str:
        return "scalar" if self.warps_per_row == 0 else "rows"

    @property
    def threads(self) -> int:
        return max(ROW_THREADS, 32 * self.warps_per_row) if self.warps_per_row else ANY_THREADS

    @property
    def groups(self) -> int:
        """Row groups a block (1 on the scalar route: a block a row)."""
        return self.threads // (32 * self.warps_per_row) if self.warps_per_row else 1


def padded_vectors(d: int, dtype: torch.dtype) -> int:
    """The 16-byte vectors a row of the row route pads to (zeros past
    ``d``): the power of two at least 32 and at least the row's."""
    nvec, p = d // (8 if dtype == torch.bfloat16 else 4), 32
    while p < nvec:
        p *= 2
    return p


def launch_plan(rows: int, d: int, dtype: torch.dtype, sms: int, resident,
                aligned: bool = True) -> Plan:
    """The launch of ``rows`` rows of width ``d`` on a card of ``sms`` SMs;
    ``resident(g, ch, stage)`` is the blocks of that instantiation an SM
    holds at once.

    The row route (``d`` a multiple of 8 padding to at most
    ``ROW_MAX_VECTORS``, ``aligned`` tensors) pads a row to
    ``padded_vectors`` = 32 G CH 16-byte vectors.  Every (G, CH, stage)
    folds the same tree, so the plan moves only the time (chosen on an
    H100, PERF.md):

    * the weight in registers, loaded beside each group's first row, CH
      by ``REGISTER_CHUNKS`` (G = 1 to 4 warps up to P = 512, 8 up to 2048,
      16 at 4096);
    * the weight staged in shared memory, CH = 8: where the row has at
      least 1024 vectors, ``d`` is at most ``STAGE_MAX_D`` and the call has
      more rows than the register plan's groups the card holds at once, so
      that each block's weight serves several rows.

    The grid is persistent: at most as many blocks as fit the card once and
    at most one a row; group ``k`` of block ``b`` walks rows ``k * blocks +
    b``, ``+ blocks * groups``, ...  Any other call takes the scalar route,
    one block a row."""
    if d % 8 or not aligned:
        return Plan(0, 0, 0, rows)
    n = padded_vectors(d, dtype) // 32  # G x CH
    if n > ROW_MAX_VECTORS // 32:
        return Plan(0, 0, 0, rows)
    ch, st = REGISTER_CHUNKS[n], 0
    if (n >= 32 and d <= STAGE_MAX_D
            and rows > sms * resident(n // ch, ch, 0) * Plan(n // ch, ch, 0, 0).groups):
        ch, st = 8, 1
    return Plan(n // ch, ch, st, min(rows, sms * resident(n // ch, ch, st)))


def fold_sumsq(x: torch.Tensor) -> torch.Tensor:
    """The row route's sum of squares of each row of ``x`` (bfloat16 or
    float32, ``D`` a multiple of 8), in float32 and in its order: each
    16-byte vector's squares (each rounded) folded in half until one is
    left, then the row's vector sums zero-padded to ``padded_vectors`` and
    folded in half (``s[v] + s[v + P / 2]``, then ``+ s[v + P / 4]``, ...)."""
    d = x.shape[-1]
    v = 8 if x.dtype == torch.bfloat16 else 4
    xf = x.float().reshape(-1, d)
    s = (xf * xf).reshape(-1, d // v, v)
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    s = torch.nn.functional.pad(s[..., 0], (0, padded_vectors(d, x.dtype) - d // v))
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s[..., 0]


def fold_rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The row route's arithmetic in plain float32 operations, for holding
    its order on any device: ``fold_sumsq``, then ``1 / sqrt(sum / D +
    eps)`` and ``(x * scale) * w``, each step rounded to float32, and the
    result cast once."""
    d = x.shape[-1]
    s = fold_sumsq(x)[:, None]
    # A tensor divisor: a scalar one may be applied as its reciprocal.
    inv = 1.0 / torch.sqrt(s / torch.full_like(s, d) + torch.tensor(eps, dtype=torch.float32))
    return ((x.float().reshape(-1, d) * inv) * weight.float()).to(x.dtype).reshape(x.shape)


@functools.lru_cache(maxsize=None)
def _resident(dtype: torch.dtype, g: int, ch: int, stage: int) -> int:
    """The kernel library's occupancy of instantiation (G, CH, stage),
    asked once."""
    fn = _build.launch_fn("rmsnorm", "rmsnorm_resident", [ctypes.c_int] * 4)
    n = fn(_DTYPES[dtype], g, ch, stage)
    if n < 1:
        raise RuntimeError(f"rmsnorm: no row-route kernel for G = {g}, CH = {ch}")
    return n


@functools.lru_cache(maxsize=4096)
def _launch_args(rows: int, d: int, dtype: torch.dtype, aligned: bool, idx: int) -> tuple:
    """``launch_plan`` on CUDA device ``idx`` and the device's SM count,
    worked out once a shape: (G, CH, stage, blocks, SMs)."""
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    return (*launch_plan(rows, d, dtype, sms, functools.partial(_resident, dtype), aligned), sms)


def plan_for(x: torch.Tensor, weight: torch.Tensor) -> Plan:
    """The plan of a launch on CUDA tensors ``x`` (contiguous) and
    ``weight`` (the output, a fresh allocation, is aligned)."""
    d = x.shape[-1]
    aligned = (x.data_ptr() | weight.data_ptr()) % 16 == 0
    return Plan(*_launch_args(x.numel() // d, d, x.dtype, aligned, x.device.index)[:4])


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor ``(..., D)``; same contract as
    ``ref.rmsnorm``.  ``x`` and ``weight`` share one type (float32 or
    bfloat16); any ``D`` runs.  Raises for tensors that are not on a CUDA
    device (the CPU path is ``ops``' business)."""
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
    x2 = x.contiguous()
    w = weight.contiguous()
    y = torch.empty_like(x2)
    rows = x2.numel() // d
    if rows == 0:
        return y
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.launch_fn("rmsnorm", "rmsnorm_launch",
                          [vp, vp, vp, ci, ci, ctypes.c_float, ci, ci, ci, ci, ci, ci, vp])
    xp, wp = x2.data_ptr(), w.data_ptr()
    with torch.cuda.device(dev):
        g, ch, st, blocks, sms = _launch_args(rows, d, x.dtype, (xp | wp) % 16 == 0, dev.index)
        err = fn(xp, wp, y.data_ptr(), rows, d, float(eps), _DTYPES[x.dtype], g, ch, st, blocks,
                 sms, torch.cuda.current_stream(dev).cuda_stream)
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
