"""Software GPU-burn baseline (paper §7.3, Appendix C).

Port of ``repro.core.burn``: the software-only mitigation EasyRider is
compared with, which injects GEMM "burn" work so that the power a job
draws never falls (or rises) faster than the grid allows.

* **Algorithm 1 (calibration):** sweep duty cycles against a device power
  model, fit the linear map ``P(d) = a d + b`` by least squares, invert it
  to ``d(P)``.
* **Algorithm 2 (burn-augmented schedule):** a warm-up ramp from idle,
  compensation of dips and a cool-down ramp.  At trace level this is the
  minimal ramp-compliant upper envelope of the rack trace (burn can only
  add power): the smallest ``e(t) >= rack(t)`` with ``|de/dt| <= beta``.
  The reference computes it with two sequential max-scans; here it is
  their closed form (``ramp_compliant_envelope``).

The burn compute itself is the ``gemm_burn`` kernel (``kernels.ops``);
this module is the scheduling layer.  Fig. 11's headline: burn costs ~19 %
more energy than rack + EasyRider, because it holds power at the peak
while the battery lets grid power sag toward the mean.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils.devices import resolve_device

F32 = torch.float32


class DutyCalibration(NamedTuple):
    a: torch.Tensor  # slope [power fraction per unit duty]
    b: torch.Tensor  # intercept (idle power fraction)
    residual: torch.Tensor


def true_duty_power(duty, p_idle: float, p_peak: float):
    """Ground-truth device behaviour for the calibration harness."""
    return p_idle + duty * (p_peak - p_idle)


def calibrate(
    generator: torch.Generator | None,
    p_idle: float,
    p_peak: float,
    *,
    n_duties: int = 16,
    samples_per_duty: int = 32,
    noise_std: float = 0.01,
    noise: torch.Tensor | None = None,
    device="cuda",
) -> DutyCalibration:
    """Algorithm 1: sample the power at ``n_duties`` duty cycles with
    Gaussian measurement noise of ``noise_std`` (standard normals drawn from
    ``generator``, or the given ``noise (n_duties, samples_per_duty)``),
    average each duty's samples and fit ``P(d) = a d + b`` by least
    squares."""
    dev = resolve_device(device)
    duties = torch.linspace(0.0, 1.0, n_duties, dtype=F32, device=dev)
    clean = true_duty_power(duties, p_idle, p_peak)
    if noise is None:
        if generator is None:
            raise ValueError("calibrate needs a generator or the noise")
        noise = torch.randn((n_duties, samples_per_duty), generator=generator, device=dev)
    measured = torch.mean(clean[:, None] + noise_std * noise.to(F32), dim=1)
    x = torch.stack([duties, torch.ones_like(duties)], dim=1)
    coef = torch.linalg.lstsq(x, measured[:, None]).solution[:, 0]
    resid = torch.sqrt(torch.mean((x @ coef - measured) ** 2))
    return DutyCalibration(a=coef[0], b=coef[1], residual=resid)


def duty_for_power(cal: DutyCalibration, p_target: torch.Tensor) -> torch.Tensor:
    """The inverse map ``d(P) = clip((P - b) / a, 0, 1)`` (Algorithm 1)."""
    return torch.clamp((p_target - cal.b) / cal.a, 0.0, 1.0)


def ramp_compliant_envelope(rack_power: torch.Tensor, dt: float, beta: float) -> torch.Tensor:
    """The minimal ``e(t) >= rack(t)`` with ``|e(t) - e(t-1)| <= beta dt``,
    over the leading (time) axis.

    The reference runs two sequential max-scans, forward (``e = max(r,
    e_prev - step)``, bounding falls) then backward (bounding rises).
    Their closed form is two cumulative maxima: with ``s = step t``,
    ``e_fwd = cummax(r + s) - s`` and ``e = rev_cummax(e_fwd - s) + s``.
    It is evaluated in float64 (``s`` reaches ~30 on a long trace) with
    the reference's float32 step and rounded once to the input type, so it
    agrees with the scans up to their own accumulated float32 rounding."""
    step = float(np.float32(beta * dt))
    r = rack_power.to(torch.float64)
    shape = (-1,) + (1,) * (r.ndim - 1)
    s = torch.arange(r.shape[0], dtype=torch.float64, device=r.device).reshape(shape) * step
    e_fwd = torch.cummax(r + s, dim=0).values - s
    e = torch.flip(torch.cummax(torch.flip(e_fwd - s, (0,)), dim=0).values, (0,)) + s
    return e.to(rack_power.dtype)


class BurnSchedule(NamedTuple):
    conditioned: torch.Tensor  # grid-visible power (rack + burn)
    burn_power: torch.Tensor  # extra power burned at each sample
    duty: torch.Tensor  # duty cycle commanded to the burn kernel
    energy_overhead_frac: torch.Tensor  # extra energy / rack energy


def burn_schedule(
    rack_power: torch.Tensor,
    dt: float,
    beta: float,
    cal: DutyCalibration,
    *,
    warmup_s: float = 30.0,
    p_warm: float = 0.1,
) -> BurnSchedule:
    """Algorithm 2 at trace level: ``warmup_s`` of ``p_warm`` is prepended
    (the paper delays the trace ~41 s for the scheduled warm-up), and the
    envelope's backward pass produces the pre-warm-up and cool-down ramps."""
    n_warm = int(round(warmup_s / dt))
    warm = torch.full((n_warm,) + tuple(rack_power.shape[1:]), p_warm, dtype=rack_power.dtype,
                      device=rack_power.device)
    full = torch.cat([warm, rack_power], dim=0)
    env = ramp_compliant_envelope(full, dt, beta)
    burn = env - full
    return BurnSchedule(
        conditioned=env,
        burn_power=burn,
        duty=duty_for_power(cal, env),
        energy_overhead_frac=torch.sum(burn, dim=0) * dt / (torch.sum(full, dim=0) * dt),
    )


def compare_energy(
    rack_power: torch.Tensor,
    grid_power_easyrider: torch.Tensor,
    burn_conditioned: torch.Tensor,
    dt: float,
    *,
    soc_delta=0.0,
    q_max_seconds=0.0,
) -> dict:
    """Paper Fig. 11's numbers: the energies of the rack, the EasyRider grid
    (battery losses included; the energy ``soc_delta * q_max_seconds`` still
    parked in the battery at the window's end credited back) and the burn
    envelope, and their overheads relative to one another."""
    e_rack = torch.sum(rack_power) * dt
    e_ez = torch.sum(grid_power_easyrider) * dt - float(soc_delta) * float(q_max_seconds)
    e_burn = torch.sum(burn_conditioned) * dt
    return {
        "rack_energy": e_rack,
        "easyrider_energy": e_ez,
        "burn_energy": e_burn,
        "easyrider_overhead_frac": (e_ez - e_rack) / e_rack,
        "burn_overhead_frac": (e_burn - e_rack) / e_rack,
        "burn_vs_easyrider_frac": (e_burn - e_ez) / e_ez,
    }
