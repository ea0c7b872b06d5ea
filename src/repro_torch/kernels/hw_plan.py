"""Launch plan of the staged hardware-path kernels (``csrc/hw_stages.cuh``).

``pdu_health`` and ``pdu_sim`` run one pipeline: a block of 32 racks whose
``WARPS`` warps are stages (producer, render, wear, ESS ramp, SoC, LC; the
render and wear warps idle where a mode has no such stage), fed by a
shared-memory ring of ``CHUNK``-sample slots.  ``plan`` gives a launch its
chunk, ring depth, shared-memory bytes and load route.  ``lc_filter`` runs
the LC-only instance (``LC_WARPS`` warps: producer, LC, store; one input
and one output array a slot), planned by ``lc_plan`` with its load and
store routes apart.  The C launches recompute the bytes from their
instantiation and refuse a plan that differs, so this module and the
kernels cannot drift apart silently.
"""
from __future__ import annotations

from typing import NamedTuple

MASK_NONE, MASK_ROW, MASK_SERIES, MASK_EVENTS = range(4)  # csrc/hw_stages.cuh's Mask
RACKS = 32  # racks a block, one a lane
WARPS = 6  # stage warps a block
SMEM_LIMIT = 232_448  # shared memory a block may use on the H100
MAX_CHUNK = 256  # a TMA box's rows
CHUNK = 64  # samples a slot, chosen on the card (PERF.md section 6)
# Samples the ring holds: three slots of CHUNK.  The third slot lets the
# events mode's render warp, nearly as busy as the SoC warp, run a chunk
# further ahead of it (PERF.md section 6: two slots against three).
AHEAD = 192
N_HAND = 3  # hand-off slot arrays: node, SoC, grid
_MBARRIERS = 5  # a slot's full/empty pairs (input, hand-off) and the ramp's full
# The LC-only instance (csrc/hw_stages.cuh's LcLayout): warps, the input and
# output slot arrays (node; grid) and a slot's mbarriers (two full/empty pairs).
LC_WARPS, LC_N_IN, LC_N_OUT, LC_MBARRIERS = 3, 1, 1, 4
# Samples a slot of the LC-only kernel: a TMA box's most rows, the fastest
# of 32, 64, 128 and 256 at every shape timed (PERF.md section 6,
# tools/hw_pipeline_time.py --chunks); two slots.
LC_CHUNK = MAX_CHUNK


class Plan(NamedTuple):
    chunk: int  # samples a slot
    slots: int  # ring depth
    n_in: int  # input-slot arrays: rack, command, [weight], the ramp's p and x
    smem_bytes: int
    route: str  # "tma" (2-D boxes) or "cp.async" (4-byte copies)


class LcPlan(NamedTuple):
    chunk: int  # samples a slot
    slots: int  # ring depth
    smem_bytes: int
    loads: str  # "tma" (2-D boxes) or "cp.async" (4-byte copies)
    stores: str  # "tma" (box stores) or "spread" (4-byte stores)


def smem_bytes(chunk: int, slots: int, n_in: int, n_hand: int = N_HAND,
               n_bar: int = _MBARRIERS) -> int:
    """``hw::ring_bytes``: ``slots`` input and hand-off slots of ``chunk`` x
    32 floats an array, and ``n_bar`` 8-byte mbarriers a slot."""
    return slots * (n_in + n_hand) * chunk * RACKS * 4 + n_bar * slots * 8


def _ring(chunk: int, n_in: int, n_hand: int, n_bar: int) -> tuple[int, int]:
    """Slots and bytes of a ring ``AHEAD`` samples deep (at least two slots,
    fewer if the shared memory would not hold them); raise if two do not
    fit."""
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    slots = max(2, -(-AHEAD // chunk))
    while slots > 2 and smem_bytes(chunk, slots, n_in, n_hand, n_bar) > SMEM_LIMIT:
        slots -= 1
    nbytes = smem_bytes(chunk, slots, n_in, n_hand, n_bar)
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} needs {nbytes} bytes of shared memory (> {SMEM_LIMIT})")
    return slots, nbytes


def load_route(r: int, aligned: bool = True) -> str:
    """TMA where the row stride ``4 r`` is a multiple of 16 bytes and every
    copied operand is 16-byte aligned; 4-byte ``cp.async`` otherwise."""
    return "tma" if r % 4 == 0 and aligned else "cp.async"


def plan(r: int, mask: int, *, aligned: bool = True, chunk: int = CHUNK) -> Plan:
    """The launch plan of a pipeline instantiation with weight mode ``mask``
    for ``r`` racks (the slew and the wear fold change no slot array):
    ``chunk`` samples a slot, a ring ``AHEAD`` samples deep (at least two
    slots, fewer if the shared memory would not hold them), the load route
    by ``r`` and ``aligned``."""
    if mask not in (MASK_NONE, MASK_ROW, MASK_SERIES, MASK_EVENTS):
        raise ValueError(f"unknown weight mode {mask}")
    n_in = 4 + (mask in (MASK_SERIES, MASK_EVENTS))
    slots, nbytes = _ring(chunk, n_in, N_HAND, _MBARRIERS)
    return Plan(chunk, slots, n_in, nbytes, load_route(r, aligned))


def lc_plan(r: int, *, aligned: bool = True, chunk: int = LC_CHUNK, loads: str | None = None,
            stores: str | None = None) -> LcPlan:
    """The launch plan of the LC-only instance for ``r`` racks: ``chunk``
    samples a slot, a ring ``AHEAD`` samples deep, and both routes by
    ``load_route(r, aligned)`` (TMA boxes and box stores, or ``cp.async``
    copies and spread stores) unless ``loads`` / ``stores`` name one.  The
    C launch refuses a TMA route that ``r`` or the operands do not allow."""
    tma = load_route(r, aligned) == "tma"
    loads = loads or ("tma" if tma else "cp.async")
    stores = stores or ("tma" if tma else "spread")
    if loads not in ("tma", "cp.async") or stores not in ("tma", "spread"):
        raise ValueError(f"unknown routes: loads {loads!r}, stores {stores!r}")
    slots, nbytes = _ring(chunk, LC_N_IN, LC_N_OUT, LC_MBARRIERS)
    return LcPlan(chunk, slots, nbytes, loads, stores)


def aligned(*ts) -> bool:
    """Whether every tensor given (None skipped) starts on 16 bytes."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def launch_args(p: Plan) -> tuple:
    """The plan's trailing C launch arguments: chunk, slots, tma, bytes."""
    return p.chunk, p.slots, int(p.route == "tma"), p.smem_bytes


def lc_launch_args(p: LcPlan) -> tuple:
    """The LC plan's trailing C launch arguments: chunk, slots, tma_load,
    tma_store, bytes."""
    return p.chunk, p.slots, int(p.loads == "tma"), int(p.stores == "tma"), p.smem_bytes
