"""Battery health telemetry: online cycle counting + aging (paper §2, §6).

Port of ``repro.core.health``.  All wear telemetry lives in a constant-size
``HealthState`` per rack that rides the conditioning loop:

  * a turning-point machine (last extremum, direction) closing a
    half-cycle of depth ``|extremum - previous extremum|`` at every SoC
    direction reversal;
  * charge/discharge throughput accumulators (equivalent full cycles);
  * SoC and SoC^2 sums feeding a SoC-weighted calendar-aging model.

A half-cycle of depth ``d`` at mid-SoC ``m`` consumes
``0.5 max(1 + g (m - soc_ref), 0) d^kappa / n_cycles_ref`` of cycle life;
calendar life drains at ``(1 + cal_soc_gain (soc - soc_ref)) /
calendar_life_s``; capacity fade is ``eol_fade`` at combined damage 1.

The per-sample fold runs inside the ``pdu_health`` kernel (and its plain
version), one controller interval per call, so every engine folds the same
blocks and agrees on the whole state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core import ess
from repro_torch.utils.devices import resolve_device
from repro_torch.utils.structures import Struct

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class HealthParams(Struct):
    """Aging-model constants (per-unit SoC domain; times in seconds)."""

    n_cycles_ref: torch.Tensor  # cycle life at 100% DoD, w = 1
    soc_stress_gain: torch.Tensor  # cycle-wear slope vs mid-SoC
    cal_soc_gain: torch.Tensor  # calendar-wear slope vs SoC
    soc_ref: torch.Tensor  # reference SoC for both stress weights
    calendar_life_s: torch.Tensor  # calendar life at soc_ref [s]
    eol_fade: torch.Tensor  # capacity-fade fraction at end of life
    rest_eps: torch.Tensor  # SoC hysteresis below which movement is "rest"
    kappa: float = 2.0  # Wöhler DoD exponent

    @staticmethod
    def create(
        n_cycles_ref: float = 4000.0,
        soc_stress_gain: float = 0.6,
        cal_soc_gain: float = 0.8,
        soc_ref: float = 0.5,
        calendar_life_years: float = 12.0,
        eol_fade: float = 0.2,
        rest_eps: float = 0.0,
        kappa: float = 2.0,
        *,
        device="cuda",
    ) -> "HealthParams":
        dev = resolve_device(device)
        f = lambda v: torch.tensor(v, dtype=F32, device=dev)
        return HealthParams(
            n_cycles_ref=f(n_cycles_ref),
            soc_stress_gain=f(soc_stress_gain),
            cal_soc_gain=f(cal_soc_gain),
            soc_ref=f(soc_ref),
            calendar_life_s=f(calendar_life_years * 365.25 * 86400.0),
            eol_fade=f(eol_fade),
            rest_eps=f(rest_eps),
            kappa=float(kappa),
        )


class HealthState(NamedTuple):
    """Constant-size wear telemetry carried across samples/chunks/resumes;
    every leaf has the rack batch shape, ``samples`` is an exact int32."""

    prev_soc: torch.Tensor  # last SoC sample seen
    last_ext: torch.Tensor  # SoC at the last direction reversal
    direction: torch.Tensor  # +1 rising / -1 falling / 0 not yet moved
    half_cycles: torch.Tensor  # closed half-cycle count
    cycle_damage: torch.Tensor  # sum of 0.5 * w(mid) * depth**kappa
    max_dod: torch.Tensor  # deepest closed half-cycle
    charge_soc: torch.Tensor  # sum of positive SoC steps
    discharge_soc: torch.Tensor  # sum of negative SoC steps (magnitudes)
    soc_sum: torch.Tensor  # running sum of SoC samples
    soc_sq_sum: torch.Tensor  # running sum of SoC^2 samples
    samples: torch.Tensor  # int32 samples observed


def init_state(soc0: torch.Tensor) -> HealthState:
    """A fresh history at ``soc0`` (any shape; the leaves take its shape
    and device)."""
    s0 = soc0.to(F32)
    z = lambda: torch.zeros_like(s0)
    return HealthState(
        prev_soc=s0.clone(),
        last_ext=s0.clone(),
        direction=z(), half_cycles=z(), cycle_damage=z(), max_dod=z(),
        charge_soc=z(), discharge_soc=z(), soc_sum=z(), soc_sq_sum=z(),
        samples=torch.zeros_like(s0, dtype=torch.int32),
    )


def step_consts(p: HealthParams) -> tuple:
    """``(c0, c1, rest_eps, kappa)`` host floats with the mid-SoC stress
    weight folded: ``0.5 max(1 + g (0.5 (prev+ext) - ref), 0) ==
    max(c0 + c1 (prev+ext), 0)``."""
    g = float(p.soc_stress_gain)
    ref = float(p.soc_ref)
    return 0.5 * (1.0 - g * ref), 0.25 * g, float(p.rest_eps), p.kappa


# ------------------------------------------------------------------ derived


def elapsed_seconds(state: HealthState, dt: float) -> torch.Tensor:
    return state.samples.to(F32) * dt


def equivalent_full_cycles(state: HealthState) -> torch.Tensor:
    """Throughput EFC: total |dSoC| / 2."""
    return 0.5 * (state.charge_soc + state.discharge_soc)


def terminal_throughput_s(ep: ess.ESSParams, state: HealthState) -> torch.Tensor:
    """Terminal-side energy throughput [s * P_RATED]."""
    return ep.q_max * (state.charge_soc / ep.eta_c + state.discharge_soc * ep.eta_d)


def cycle_life_fraction(p: HealthParams, state: HealthState) -> torch.Tensor:
    """Fraction of cycle life consumed (the controller's wear signal)."""
    return state.cycle_damage / p.n_cycles_ref


def calendar_life_fraction(p: HealthParams, state: HealthState, dt: float) -> torch.Tensor:
    """SoC-weighted calendar life consumed:
    ``elapsed + g (soc_sum dt - soc_ref elapsed)`` over the calendar life."""
    t = elapsed_seconds(state, dt)
    stress_t = t + p.cal_soc_gain * (state.soc_sum * dt - p.soc_ref * t)
    return torch.clamp(stress_t, min=0.0) / p.calendar_life_s


def capacity_fade(p: HealthParams, state: HealthState, dt: float) -> torch.Tensor:
    frac = cycle_life_fraction(p, state) + calendar_life_fraction(p, state, dt)
    return p.eol_fade * frac


def projected_lifetime_s(p: HealthParams, state: HealthState, dt: float) -> torch.Tensor:
    """Extrapolated time to end of life at the observed damage rate."""
    t = elapsed_seconds(state, dt)
    frac = cycle_life_fraction(p, state) + calendar_life_fraction(p, state, dt)
    return torch.where(frac > 0.0, t / torch.clamp(frac, min=1e-30), math.inf)


class HealthReport(NamedTuple):
    """Derived per-rack wear report."""

    efc: torch.Tensor
    half_cycles: torch.Tensor
    max_dod: torch.Tensor
    throughput_s: torch.Tensor
    cycle_life_frac: torch.Tensor
    calendar_life_frac: torch.Tensor
    capacity_fade: torch.Tensor
    projected_life_s: torch.Tensor
    mean_soc: torch.Tensor
    soc_std: torch.Tensor
    elapsed_s: torch.Tensor


def report(p: HealthParams, ep: ess.ESSParams, state: HealthState, dt: float) -> HealthReport:
    n = torch.clamp(state.samples.to(F32), min=1.0)
    mean = state.soc_sum / n
    var = torch.clamp(state.soc_sq_sum / n - mean * mean, min=0.0)
    return HealthReport(
        efc=equivalent_full_cycles(state),
        half_cycles=state.half_cycles,
        max_dod=state.max_dod,
        throughput_s=terminal_throughput_s(ep, state),
        cycle_life_frac=cycle_life_fraction(p, state),
        calendar_life_frac=calendar_life_fraction(p, state, dt),
        capacity_fade=capacity_fade(p, state, dt),
        projected_life_s=projected_lifetime_s(p, state, dt),
        mean_soc=mean,
        soc_std=torch.sqrt(var),
        elapsed_s=elapsed_seconds(state, dt),
    )


def fleet_summary(rep: HealthReport, *, json_safe: bool = False) -> dict:
    """Campus-level headline numbers from a per-rack report (host floats);
    ``json_safe`` maps non-finite values (the infinite lifetime of an empty
    history) to None."""
    a = lambda x: x.detach().cpu().numpy()
    out = {
        "efc_mean": float(a(rep.efc).mean()),
        "efc_max": float(a(rep.efc).max()),
        "half_cycles_mean": float(a(rep.half_cycles).mean()),
        "worst_dod": float(a(rep.max_dod).max()),
        "fade_mean": float(a(rep.capacity_fade).mean()),
        "fade_max": float(a(rep.capacity_fade).max()),
        "projected_life_years_min": float(
            a(rep.projected_life_s).min() / (365.25 * 86400.0)
        ),
        "mean_soc": float(a(rep.mean_soc).mean()),
    }
    if json_safe:
        out = {k: (v if math.isfinite(v) else None) for k, v in out.items()}
    return out


def chunk_aggregates(p: HealthParams, state: HealthState, dt: float) -> torch.Tensor:
    """(3,) fleet snapshot: [mean EFC, max fade, max closed-half-cycle DoD]."""
    fade = capacity_fade(p, state, dt)
    return torch.stack(
        [
            torch.mean(equivalent_full_cycles(state)),
            torch.amax(fade),
            torch.amax(state.max_dod),
        ]
    )
