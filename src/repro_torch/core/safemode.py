"""Supervisory safe-mode control plane.

Port of ``repro.core.safemode``.  The conditioner sits between training
racks and grid protection equipment, so its own failures are grid-safety
events: a diverged QP or a non-finite SoC leaf would put a garbage battery
command on the grid exactly when transients are worst.  This module is the
per-rack supervisor that detects, contains and recovers from them:

    NORMAL --(ADMM residual over threshold for ``trip_intervals``)--> PASSTHROUGH
    NORMAL / PASSTHROUGH --(non-finite state leaf)--> QUARANTINE
    PASSTHROUGH / QUARANTINE --(``readmit_intervals`` clean probes)--> NORMAL

* The **ADMM divergence watchdog** compares each rack's QP primal residual
  with ``resid_threshold`` every control interval (a non-finite residual
  counts as over it); ``trip_intervals`` consecutive bad intervals trip a
  NORMAL rack to PASSTHROUGH: its command is zeroed and its warm iterates
  reset, while the autonomous hardware ramp filter stays engaged.
* The **state-corruption sanitizer** (``pdu.condition``) quarantines a rack
  whose carried state holds a non-finite leaf at the start of an interval
  and reinitializes that state.  QUARANTINE is the only mode that winds the
  converter down to LC passthrough.

A tripped rack keeps probing (its QP solves cold every interval while its
command stays zeroed) and returns to NORMAL after ``readmit_intervals``
consecutive clean probes.  ``SafeModeState`` rides in ``PDUState``, so
chunked and resumed streams supervise as one call does.  These are plain
functions on tensors with the reference's float32 / int32 arithmetic; only
``summary`` reads the card, after a run.  Each op is a node of the scanned
engine's CUDA graph once an interval, so they are written in few launches
(``torch.where`` against a Python number is one; ``masked_fill`` would
copy first; ``finite`` takes two).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils.devices import resolve_device
from repro_torch.utils.structures import Struct

F32, I32 = torch.float32, torch.int32

# Mode encoding (int32 per rack); higher is more contained.
NORMAL = 0
PASSTHROUGH = 1  # divergence trip: command zeroed, probing
QUARANTINE = 2  # state corruption: state reinitialized, LC passthrough


@dataclasses.dataclass(frozen=True)
class SafeModeConfig(Struct):
    """Watchdog knobs.  ``resid_threshold`` is in the units of the QP primal
    residual (the warm-started plan converges to ~5e-3 on the acceptance
    campus; the default trips at 10x that); the interval counts are host
    ints."""

    resid_threshold: torch.Tensor
    trip_intervals: int = 3
    readmit_intervals: int = 8

    @staticmethod
    def create(
        resid_threshold: float = 0.05,
        trip_intervals: int = 3,
        readmit_intervals: int = 8,
        *,
        device="cuda",
    ) -> "SafeModeConfig":
        if trip_intervals < 1:
            raise ValueError(f"trip_intervals must be >= 1, got {trip_intervals}")
        if readmit_intervals < 1:
            raise ValueError(f"readmit_intervals must be >= 1, got {readmit_intervals}")
        return SafeModeConfig(
            resid_threshold=torch.tensor(resid_threshold, dtype=F32, device=resolve_device(device)),
            trip_intervals=int(trip_intervals),
            readmit_intervals=int(readmit_intervals),
        )


class SafeModeState(NamedTuple):
    """Per-rack supervisor state carried across intervals, chunks and
    resumes.  The seven int32 leaves have the rack batch shape; the three
    counters are monotone event totals.  ``hw_weight`` is the float32 ESS
    weight the hardware plane applied at the end of the last interval: the
    engine slews it linearly across each interval toward the gate
    (converter wind-down on containment, soft-start on re-admission)."""

    mode: torch.Tensor  # NORMAL / PASSTHROUGH / QUARANTINE
    resid_streak: torch.Tensor  # consecutive over-threshold intervals
    clean_streak: torch.Tensor  # consecutive clean probes while tripped
    worst_streak: torch.Tensor  # longest resid_streak seen (telemetry)
    passthrough_entries: torch.Tensor  # divergence trips (total)
    quarantine_entries: torch.Tensor  # corruption events (total)
    readmissions: torch.Tensor  # re-admissions to NORMAL (total)
    hw_weight: torch.Tensor  # float32 applied ESS weight


def finite(x: torch.Tensor) -> torch.Tensor:
    """``torch.isfinite`` of a float tensor in two launches (it takes four):
    ``x * 0`` is 0 for every finite ``x`` and NaN for NaN and the
    infinities."""
    return (x * 0.0) == 0.0


def over_threshold(cfg: SafeModeConfig, resid: torch.Tensor) -> torch.Tensor:
    """The watchdog's predicate: a residual over the threshold, or a
    non-finite one (NaN compares false against any threshold, which is how
    a diverged solver would otherwise hide)."""
    return (resid > cfg.resid_threshold) | ~finite(resid)


def init_state(batch_shape: tuple[int, ...] = (), device="cuda") -> SafeModeState:
    """All racks NORMAL at full hardware weight; each leaf its own buffer."""
    dev = resolve_device(device)
    return SafeModeState(
        *(torch.zeros(batch_shape, dtype=I32, device=dev) for _ in range(7)),
        torch.ones(batch_shape, dtype=F32, device=dev),
    )


def gate(st: SafeModeState) -> torch.Tensor:
    """1.0 where the rack may command its battery (NORMAL), else 0.0: the
    software-admission multiplier (degraded mode's ``ess_online``)."""
    return (st.mode == NORMAL).to(F32)


def quarantine(st: SafeModeState, corrupt: torch.Tensor) -> SafeModeState:
    """Mode update for racks whose carried state went non-finite: every
    event is counted (a rack corrupted again while quarantined counts
    again), the streaks reset and the mode latches to QUARANTINE.  The
    caller reinitializes the state itself."""
    corrupt = corrupt.to(torch.bool)
    return st._replace(
        mode=torch.where(corrupt, QUARANTINE, st.mode),
        resid_streak=torch.where(corrupt, 0, st.resid_streak),
        clean_streak=torch.where(corrupt, 0, st.clean_streak),
        quarantine_entries=st.quarantine_entries + corrupt,
    )


def residual_update(cfg: SafeModeConfig, st: SafeModeState, resid: torch.Tensor, *,
                    bad: torch.Tensor | None = None) -> SafeModeState:
    """The watchdog's fold after an interval's QP solve.  ``resid`` is the
    raw per-rack primal residual (unmasked by safe mode, so tripped racks
    keep probing; degraded-mode offline racks arrive masked to zero).
    Non-finite residuals count as over the threshold (``bad``, if given,
    is ``over_threshold(cfg, resid)``).  Trips happen only from NORMAL;
    re-admission takes ``readmit_intervals`` consecutive clean probes from
    either contained mode."""
    if bad is None:
        bad = over_threshold(cfg, resid)
    streak = (st.resid_streak + 1) * bad
    trip = (st.mode == NORMAL) & (streak >= cfg.trip_intervals)
    mode = torch.where(trip, PASSTHROUGH, st.mode)
    tripped = mode != NORMAL
    clean = torch.where(bad | ~tripped, 0, st.clean_streak + 1)
    readmit = tripped & (clean >= cfg.readmit_intervals)
    return st._replace(
        mode=torch.where(readmit, NORMAL, mode),
        resid_streak=streak,
        clean_streak=torch.where(readmit, 0, clean),
        worst_streak=torch.maximum(st.worst_streak, streak),
        passthrough_entries=st.passthrough_entries + trip,
        readmissions=st.readmissions + readmit,
    )


def chunk_snapshot(st: SafeModeState) -> torch.Tensor:
    """(6,) float32 campus aggregate at a chunk boundary: [frac_normal,
    n_passthrough, n_quarantined, entries_total, readmissions_total,
    worst_resid_streak].  The mean is the sum times float32(1 / R), as the
    reference's compiled mean evaluates it."""
    inv_n = float(np.float32(1.0 / max(st.mode.numel(), 1)))
    return torch.stack([
        torch.sum((st.mode == NORMAL).to(F32)) * inv_n,
        torch.sum((st.mode == PASSTHROUGH).to(F32)),
        torch.sum((st.mode == QUARANTINE).to(F32)),
        torch.sum(st.passthrough_entries + st.quarantine_entries).to(F32),
        torch.sum(st.readmissions).to(F32),
        torch.amax(st.worst_streak).to(F32),
    ])


def summary(st: SafeModeState) -> dict:
    """JSON-safe host summary of one fleet's supervisor state (reads the
    card; call it after a run)."""
    h = lambda x: x.detach().cpu().reshape(-1)
    mode = h(st.mode)
    racks = lambda m: [int(i) for i in torch.nonzero(mode == m).reshape(-1)]
    return dict(
        n_normal=int((mode == NORMAL).sum()),
        n_passthrough=int((mode == PASSTHROUGH).sum()),
        n_quarantined=int((mode == QUARANTINE).sum()),
        passthrough_racks=racks(PASSTHROUGH),
        quarantined_racks=racks(QUARANTINE),
        passthrough_entries=int(h(st.passthrough_entries).sum()),
        quarantine_entries=int(h(st.quarantine_entries).sum()),
        readmissions=int(h(st.readmissions).sum()),
        worst_resid_streak=int(h(st.worst_streak).max()),
    )
