"""The batched controller-QP ADMM loop on Hopper: wrapper and launch.

Ports ``repro.kernels.admm_step.admm_iterate`` (Pallas ``_admm_kernel``):
``iters`` OSQP-style ADMM steps for every rack column in one launch.  At
horizons 12 and 24 the kernel is row-parallel: a rack a warp (two at 24),
lane i holding x-row i of the plan in registers; above 24 one thread
solves one rack, the plan in shared memory up to horizon 57 and read from
global memory above, the iterates in shared memory (in a global scratch
above 181; see ``csrc/admm_step.cu``).
``prepare`` / ``launch`` split one call so the kernel can be timed alone;
``admm_iterate.launches`` counts kernel launches (``launch`` adds one).

The row-parallel kernel is instantiated for horizons 12 and 24;
``pad_horizon`` lifts any smaller horizon to the next one with decoupled
variables whose rows of the KKT operator and of ``G`` are zero and whose
bounds are ``lo = hi = 0``, so they stay 0, and the real variables keep
their order: every real sum gains only zero terms, and the real iterates
come out bit for bit.  Horizons 25 to ``SHARED_PLAN_MAX`` run a variant
that takes the horizon at run time and keeps the plan and the iterates in
shared memory; any larger horizon one that reads the plan from global
memory and keeps the iterates in shared memory up to
``SHARED_ITERATES_MAX``, in a global scratch above (``kernel_variant``).
Every variant runs each row's FMA chain in one order, so where two serve
a horizon they agree bit for bit: ``prepare(..., variant=...)`` forces
one, the shared-plan kernel at any horizon up to ``SHARED_PLAN_MAX``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

F32 = torch.float32
# The row-parallel kernel's horizons (12 is ControllerConfig's default);
# above the largest the kernel takes h itself: up to SHARED_PLAN_MAX with the
# plan and iterates in shared memory (48 h^2 + 1280 h bytes of a block's
# 232,448), then with the plan read from global memory and the iterates in
# shared memory (1280 h bytes) up to SHARED_ITERATES_MAX, then with the
# iterates in a (10 h, R) float32 global scratch.
HORIZONS = (12, 24)
SHARED_PLAN_MAX = 57
SHARED_ITERATES_MAX = 181
# The C launch function's variant codes ("registers": the row-parallel
# kernel, a plan row in each lane's registers).
VARIANTS = {"registers": 0, "global plan": 1, "global plan and iterates": 2, "shared plan": 3}


def kernel_horizon(h: int) -> int:
    """The horizon the kernel runs for ``h``: the instantiated one at or
    above it up to 24, else ``h`` itself (any horizon whose plan and
    iterates the card's memory holds)."""
    if h < 1:
        raise ValueError(f"admm_step: horizon must be positive, got {h}")
    return next((n for n in HORIZONS if n >= h), h)


def kernel_variant(h: int) -> str:
    """Which kernel serves the (padded) horizon ``h``: ``"registers"`` (12,
    24), ``"shared plan"`` (25-57), ``"global plan"`` (58-181) or ``"global
    plan and iterates"``."""
    if h in HORIZONS:
        return "registers"
    if h <= SHARED_PLAN_MAX:
        return "shared plan"
    return "global plan" if h <= SHARED_ITERATES_MAX else "global plan and iterates"


def _real_rows(h: int, hp: int, n_blocks: int) -> list[int]:
    """Indices of the real rows when ``n_blocks`` blocks of ``h`` rows
    each grow to ``hp`` rows (the layout [u; s] of x, [u; s; G x] of z)."""
    return [i * hp + j for i in range(n_blocks) for j in range(h)]


@functools.cache
def _index(rows: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``rows`` as an index tensor on ``device``, made once: a copy from
    host memory cannot be captured in a CUDA graph (the scanned engine's),
    and the graph keeps reading this tensor."""
    return torch.tensor(rows, dtype=torch.long, device=device)


def _scatter(t: torch.Tensor, rows: list[int], n: int, dim: int = 0) -> torch.Tensor:
    """``t`` placed at ``rows`` along ``dim`` of a zero tensor of size ``n``
    there (an exact copy: no arithmetic)."""
    shape = list(t.shape)
    shape[dim] = n
    return t.new_zeros(shape).index_copy_(dim, _index(tuple(rows), t.device), t)


def pad_horizon(kkt_stack, g_blk, kq, lo, hi, x0, z0, y0, hp: int):
    """The QP of horizon ``h`` embedded in horizon ``hp >= h``: each block
    of x (2) and z (3) gains ``hp - h`` decoupled rows after its real ones,
    with zero rows and columns in ``kkt_stack`` and ``G`` and zero
    bounds."""
    h = g_blk.shape[0]
    if hp == h:
        return kkt_stack, g_blk, kq, lo, hi, x0, z0, y0
    xr, zr = _real_rows(h, hp, 2), _real_rows(h, hp, 3)
    ks_cols = xr + [2 * hp + i for i in zr]  # [x; rho z - y] operand columns
    ks = _scatter(_scatter(kkt_stack, xr, 2 * hp), ks_cols, 5 * hp, dim=1)
    g = _scatter(_scatter(g_blk, list(range(h)), hp), xr, 2 * hp, dim=1)
    pad2 = lambda t: _scatter(t, xr, 2 * hp)
    pad3 = lambda t: _scatter(t, zr, 3 * hp)
    return ks, g, pad2(kq), pad3(lo), pad3(hi), pad2(x0), pad3(z0), pad3(y0)


def unpad_horizon(x, z, y, h: int):
    """The real rows of padded iterates (see ``pad_horizon``)."""
    hp = x.shape[0] // 2
    if hp == h:
        return x, z, y
    take = lambda t, n: t[_index(tuple(_real_rows(h, hp, n)), t.device)]
    return take(x, 2), take(z, 3), take(y, 3)


def resolve_variant(h: int, variant: str | None = None) -> str:
    """The kernel that runs the (padded) horizon ``h``: ``kernel_variant``'s,
    or ``variant`` where that kernel serves ``h`` too (to hold one kernel
    against another where both run): the shared-plan one every horizon up
    to ``SHARED_PLAN_MAX``, 12 and 24 too; the global-plan ones every
    horizon from 25 (up to 181 with shared iterates).  Raises for a horizon
    that ``admm_iterate`` would pad, or a kernel that does not serve it."""
    if kernel_horizon(h) != h:
        raise ValueError(
            f"admm_step kernel runs horizons {HORIZONS} and every one above {HORIZONS[-1]}, "
            f"got {h} (admm_iterate pads it)"
        )
    if variant is None or variant == kernel_variant(h):
        return kernel_variant(h)
    forcible = {"shared plan": h <= SHARED_PLAN_MAX,
                "global plan": HORIZONS[-1] < h <= SHARED_ITERATES_MAX,
                "global plan and iterates": h > HORIZONS[-1]}
    if not forcible.get(variant, False):
        raise ValueError(f"admm_step: the {variant!r} kernel does not serve horizon {h}")
    return variant


ROW_THREADS = 128  # a block of the row-parallel kernel


class RowPlan(NamedTuple):
    """The row-parallel kernel's split of the racks at horizon ``h``: lane i
    of a rack computes x-row i and updates z/y row i (i < 2h), and lane
    i < h computes G-row i and updates z/y row 2h + i."""

    warps: int  # warps a rack: a lane per x-row
    racks: int  # racks a block of ROW_THREADS


def row_plan(h: int) -> RowPlan:
    """The row-parallel kernel's warps a rack and racks a block at horizon
    ``h``; the launch refuses any others."""
    warps = -(-2 * h // 32)
    return RowPlan(warps, ROW_THREADS // (32 * warps))


class Prepared(NamedTuple):
    """One launch's checked operands and allocated outputs."""

    args: tuple  # the C launch function's arguments (without the stream)
    inputs: tuple  # the operands and scratch, referenced while the launch uses them
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor


def prepare(kkt_stack, g_blk, kq, lo, hi, x0, z0, y0, *, rho, iters,
            variant: str | None = None) -> Prepared:
    """Check the operands (CUDA, float32, shapes, contiguity) and allocate
    the outputs for ``launch``.  ``variant`` (``kernel_variant``'s names)
    forces a kernel where it serves ``h``, to hold one against another
    where both run: the shared-plan one serves every horizon up to
    ``SHARED_PLAN_MAX`` (12 and 24 too), the global-plan ones every horizon
    from 25 (up to 181 with shared iterates)."""
    dev = kq.device
    if dev.type != "cuda":
        raise ValueError("admm_step kernel needs CUDA tensors")
    h = g_blk.shape[0]
    variant = resolve_variant(h, variant)
    if kq.ndim != 2:
        raise ValueError("admm_step kernel needs a (2h, R) rack batch")
    r = kq.shape[1]
    shapes = dict(
        kkt_stack=(kkt_stack, (2 * h, 5 * h)), g_blk=(g_blk, (h, 2 * h)),
        kq=(kq, (2 * h, r)), lo=(lo, (3 * h, r)), hi=(hi, (3 * h, r)),
        x0=(x0, (2 * h, r)), z0=(z0, (3 * h, r)), y0=(y0, (3 * h, r)),
    )
    for name, (t, shape) in shapes.items():
        if t.device != dev or t.dtype != F32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"admm_step: {name} must be a contiguous float32 {shape} tensor "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    x = torch.empty((2 * h, r), dtype=F32, device=dev)
    z = torch.empty((3 * h, r), dtype=F32, device=dev)
    y = torch.empty((3 * h, r), dtype=F32, device=dev)
    scratch = (torch.empty((10 * h, r), dtype=F32, device=dev)
               if variant == "global plan and iterates" else None)
    rp = row_plan(h) if variant == "registers" else RowPlan(0, 0)
    return Prepared(
        tuple(t.data_ptr() for t in (kkt_stack, g_blk, kq, lo, hi, x0, z0, y0, x, z, y))
        + (None if scratch is None else scratch.data_ptr(), h, r, float(rho), int(iters),
           VARIANTS[variant], rp.warps, rp.racks),
        (kkt_stack, g_blk, kq, lo, hi, x0, z0, y0, scratch), x, z, y,
    )


def launch(p: Prepared) -> None:
    """Launch the kernel on prepared operands (current stream, no
    synchronization) and count the launch."""
    dev = p.x.device
    vp = ctypes.c_void_p
    ii = ctypes.c_int
    fn = _build.launch_fn("admm_step", "admm_step_launch",
                          [vp] * 12 + [ii, ii, ctypes.c_float, ii, ii, ii, ii, vp])
    with torch.cuda.device(dev):
        err = fn(*p.args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("admm_step", err)
    admm_iterate.launches += 1


def admm_iterate(kkt_stack, g_blk, kq, lo, hi, x0, z0, y0, *, rho, iters):
    """Launch the kernel on CUDA tensors with a rack batch in the trailing
    axis; returns ``(x, z, y)`` like ``ref.admm_iterate``.  A horizon below
    24 that is not instantiated runs padded (``pad_horizon``); any other
    runs as it is, on the kernel ``kernel_variant`` names."""
    h = g_blk.shape[0]
    args = pad_horizon(kkt_stack, g_blk, kq, lo, hi, x0, z0, y0, kernel_horizon(h))
    p = prepare(*args, rho=rho, iters=iters)
    launch(p)
    return unpad_horizon(p.x, p.z, p.y, h)


# Launches made from Python: a launch captured in a CUDA graph (the scanned
# engine's) counts once, at capture, and not when the graph is replayed.
admm_iterate.launches = 0
