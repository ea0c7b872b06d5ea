"""Workload -> power-phase modeling (paper §2.2).

Synchronous training is a loop of phases with sharply different power:

    compute (MXU busy, ~peak) -> exposed collective (idle-ish) -> compute ...
    every K steps: checkpoint stall (idle)
    job start: staggered ramp;  job end / fault: instant drop

Given a compiled step's cost analysis (FLOPs, HBM bytes, collective bytes —
the same numbers the roofline uses, see launch/dryrun.py) and hardware
constants, this module derives the per-step phase timeline that drives the
power trace: this is how the *actual* assigned-architecture workloads are
mapped onto EasyRider's testbench, rather than hand-picking frequencies.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.power.device import DevicePower, TPU_V5E


@dataclasses.dataclass(frozen=True)
class HardwareConstants:
    """TPU v5e roofline constants (per chip), also used by launch/dryrun."""

    peak_flops: float = 197e12  # bf16 FLOP/s
    hbm_bw: float = 819e9  # bytes/s
    ici_bw: float = 50e9  # bytes/s/link (~per-direction per link)
    chips: int = 256


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Per-step aggregate cost (whole mesh)."""

    flops: float
    hbm_bytes: float
    collective_bytes: float


@dataclasses.dataclass(frozen=True)
class PhaseModel:
    """Timing/power knobs for the phase derivation."""

    mfu: float = 0.5  # achieved fraction of peak during compute
    comm_efficiency: float = 0.7  # achieved fraction of link bandwidth
    overlap: float = 0.6  # fraction of collective hidden under compute
    checkpoint_every_steps: int = 200
    checkpoint_stall_s: float = 4.0
    device: DevicePower = TPU_V5E


def step_phases(
    cost: StepCost, hw: HardwareConstants, model: PhaseModel
) -> tuple[np.ndarray, np.ndarray]:
    """One training step -> (durations_s, per-unit powers).

    The compute phase runs at ~peak power; the *exposed* part of the
    collective (not hidden under compute) runs at comm power.  Memory time
    is folded into compute (TPU compute phases are themselves a
    compute/memory mix; the power difference within that mix is smoothed by
    board-level regulation, paper §2.2 — only the >=10 ms structure
    matters to the grid).
    """
    t_compute = cost.flops / (hw.chips * hw.peak_flops * model.mfu)
    t_mem = cost.hbm_bytes / (hw.chips * hw.hbm_bw)
    t_busy = max(t_compute, t_mem)
    t_coll = cost.collective_bytes / (hw.chips * hw.ici_bw * model.comm_efficiency)
    t_exposed = max(t_coll - model.overlap * t_busy, 0.0)

    d = model.device
    p_busy = 1.0  # per-unit of rack rated power
    p_comm = d.p_comm_w / d.p_peak_w
    durations = np.array([t_busy, max(t_exposed, 1e-4)])
    powers = np.array([p_busy, p_comm], np.float32)
    return durations, powers


def training_timeline(
    cost: StepCost,
    hw: HardwareConstants,
    model: PhaseModel,
    n_steps: int,
    *,
    warmup_s: float = 10.0,
    warmup_levels: int = 20,
    end_idle_s: float = 10.0,
) -> tuple[np.ndarray, np.ndarray]:
    """A full job timeline: warmup ramp, steps (+checkpoint stalls), end drop.

    Fully vectorized phase-list construction (tile + insert);
    ``training_scenario`` compiles it into a segment-table scenario.
    """
    d = model.device
    p_idle = d.p_idle_w / d.p_peak_w

    # Staggered warm-up ramp (control planes stagger job starts, §2.2).
    step_d, step_p = step_phases(cost, hw, model)
    p_avg = float(np.sum(step_d * step_p) / np.sum(step_d))
    levels = np.arange(1, warmup_levels + 1, dtype=np.float64)
    warm_d = np.full(warmup_levels, warmup_s / warmup_levels)
    warm_p = p_idle + (p_avg - p_idle) * levels / warmup_levels

    durs = np.tile(step_d, n_steps)
    pows = np.tile(step_p.astype(np.float64), n_steps)
    c = model.checkpoint_every_steps
    if c:
        n_stalls = n_steps // c
        # insert a stall after every c-th step (each step = len(step_d) phases)
        at = np.arange(1, n_stalls + 1) * c * step_d.shape[0]
        durs = np.insert(durs, at, model.checkpoint_stall_s)
        pows = np.insert(pows, at, p_idle)

    durs = np.concatenate([warm_d, durs, [end_idle_s]])
    pows = np.concatenate([warm_p, pows, [p_idle]])
    return durs, pows.astype(np.float32)


def training_scenario(
    cost: StepCost,
    hw: HardwareConstants,
    model: PhaseModel,
    n_steps: int,
    sample_hz: float,
    *,
    edge_time_s: float = 0.1,
    device="cuda",
    **timeline_kwargs,
):
    """Compile a training job's phase timeline straight into the scenario
    IR (``power.scenario``): a renderable segment-table ``Scenario``."""
    from repro_torch.power import scenario as SC

    durs, pows = training_timeline(cost, hw, model, n_steps, **timeline_kwargs)
    return SC.from_phase_timeline(durs, pows, sample_hz, edge_time_s=edge_time_s, device=device)


def step_fundamental_hz(cost: StepCost, hw: HardwareConstants, model: PhaseModel) -> float:
    """The iteration frequency — where the workload's spectral line sits."""
    d, _ = step_phases(cost, hw, model)
    return 1.0 / float(np.sum(d))
