"""Launch plan of the staged hardware-path kernels (``csrc/hw_stages.cuh``).

``pdu_health`` and ``pdu_sim`` run one pipeline: a block of 32 racks whose
``WARPS`` warps are stages (producer, render, wear, ESS ramp, SoC, LC; the
render and wear warps idle where a mode has no such stage), fed by a
shared-memory ring of ``CHUNK``-sample slots.  ``plan`` gives a launch its
chunk, ring depth, shared-memory bytes and load route; the C launch
recomputes the bytes from its instantiation and refuses a plan that
differs, so this module and the kernel cannot drift apart silently.
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


class Plan(NamedTuple):
    chunk: int  # samples a slot
    slots: int  # ring depth
    n_in: int  # input-slot arrays: rack, command, [weight], the ramp's p and x
    smem_bytes: int
    route: str  # "tma" (2-D boxes) or "cp.async" (4-byte copies)


def smem_bytes(chunk: int, slots: int, n_in: int) -> int:
    """``hw::ring_bytes``: ``slots`` input and hand-off slots of ``chunk`` x
    32 floats an array, and five 8-byte mbarriers a slot."""
    return slots * (n_in + N_HAND) * chunk * RACKS * 4 + _MBARRIERS * slots * 8


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
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    n_in = 4 + (mask in (MASK_SERIES, MASK_EVENTS))
    slots = max(2, -(-AHEAD // chunk))
    while slots > 2 and smem_bytes(chunk, slots, n_in) > SMEM_LIMIT:
        slots -= 1
    nbytes = smem_bytes(chunk, slots, n_in)
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} needs {nbytes} bytes of shared memory (> {SMEM_LIMIT})")
    return Plan(chunk, slots, n_in, nbytes, load_route(r, aligned))


def aligned(*ts) -> bool:
    """Whether every tensor given (None skipped) starts on 16 bytes."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def launch_args(p: Plan) -> tuple:
    """The plan's trailing C launch arguments: chunk, slots, tma, bytes."""
    return p.chunk, p.slots, int(p.route == "tma"), p.smem_bytes
