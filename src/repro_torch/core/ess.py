"""Auxiliary energy storage system (paper §5.3, Appendix A.1).

Port of the parameter and state containers of ``repro.core.ess``.  The
battery branch holds the grid-facing current to a first-order low-pass of
the rack current, ``dg/dt = beta (i_R - g)``, discretized exactly (ZOH) as
``g[t+1] = g[t] + (1 - exp(-beta dt)) (i_R[t] - g[t])``; the state of
charge integrates the battery power with charge/discharge efficiencies and
saturates at the safe window.  ``step``/``simulate`` are the unfused
per-sample physics (the ``pdu_sim`` kernel is held to ``simulate`` piped
into ``filters.simulate``); conditioning runs it fused, in the
``pdu_health`` kernel.  The sizing bounds are Appendix A.1 Eqs. 7-9.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils.devices import resolve_device
from repro_torch.utils.structures import Struct


@dataclasses.dataclass(frozen=True)
class ESSParams(Struct):
    """Battery + control parameters (normalized to rated rack power)."""

    beta: torch.Tensor  # grid ramp limit [1/s]
    q_max: torch.Tensor  # usable energy capacity [s] (energy / P_RATED)
    eta_c: torch.Tensor  # charge efficiency in (0, 1]
    eta_d: torch.Tensor  # discharge efficiency in (0, 1]
    p_max: torch.Tensor  # max |battery power| as fraction of rated power
    soc_safe_min: torch.Tensor
    soc_safe_max: torch.Tensor

    @staticmethod
    def create(
        beta: float = 0.1,
        q_max_seconds: float = 60.0,
        eta_c: float = 0.97,
        eta_d: float = 0.97,
        p_max: float = 1.0,
        soc_safe_min: float = 0.1,
        soc_safe_max: float = 0.9,
        *,
        device="cuda",
    ) -> "ESSParams":
        dev = resolve_device(device)
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        return ESSParams(
            beta=f(beta),
            q_max=f(q_max_seconds),
            eta_c=f(eta_c),
            eta_d=f(eta_d),
            p_max=f(p_max),
            soc_safe_min=f(soc_safe_min),
            soc_safe_max=f(soc_safe_max),
        )

    def cutoff_hz(self) -> torch.Tensor:
        return self.beta / (2.0 * np.pi)


class ESSState(NamedTuple):
    g_filter: torch.Tensor  # first-order filter state tracking rack power
    soc: torch.Tensor  # state of charge in [0, 1]


def init_state(p: ESSParams, rack_power0: torch.Tensor, soc0=0.5) -> ESSState:
    """Filter at the starting rack power, SoC at ``soc0``, on ``p``'s device."""
    r0 = torch.as_tensor(rack_power0, dtype=torch.float32, device=p.beta.device)
    soc = torch.as_tensor(soc0, dtype=torch.float32, device=r0.device)
    return ESSState(g_filter=r0, soc=soc.expand(r0.shape).clone())


def soc_increment(p: ESSParams, battery_power: torch.Tensor, dt: float) -> torch.Tensor:
    """SoC change for one step of signed battery power (> 0 charges):
    charging stores ``eta_c`` of the energy, discharging removes ``1 /
    eta_d`` per unit delivered (paper Eq. 14)."""
    charge = torch.clamp(battery_power, min=0.0)
    discharge = torch.clamp(-battery_power, min=0.0)
    return (dt / p.q_max) * (p.eta_c * charge - discharge / p.eta_d)


def battery_power_from_soc_delta(p: ESSParams, d_soc: torch.Tensor, dt: float) -> torch.Tensor:
    """Inverse of ``soc_increment``: the signed terminal-side battery power
    implied by an observed SoC step (its sign selects the efficiency)."""
    q = d_soc * (p.q_max / dt)
    return torch.where(d_soc > 0, q / p.eta_c, q * p.eta_d)


def step(
    p: ESSParams,
    state: ESSState,
    rack_power: torch.Tensor,
    dt: float,
    corrective_power=0.0,
    online: torch.Tensor | None = None,
) -> tuple[ESSState, torch.Tensor]:
    """Advance one sample; returns ``(new_state, node power)``.

    The corrective command drives battery power directly and never enters
    the ramp filter.  Battery power is clipped to ``p_max``; SoC overshoot
    past the safe window is converted back to power and shed to the grid.
    ``online`` is an availability weight in [0, 1]: 0 passes the rack
    straight through (battery idle, SoC frozen, the filter tracking the
    rack), fractions scale the delivered battery power."""
    w = online
    alpha = 1.0 - torch.exp(-p.beta * dt)
    g_new = state.g_filter + alpha * (rack_power - state.g_filter)
    if w is not None:
        g_new = torch.where(w > 0, g_new, rack_power)
    p_batt = torch.clamp(g_new - rack_power + corrective_power, -p.p_max, p.p_max)
    if w is not None:
        p_batt = p_batt * w
    new_soc = state.soc + soc_increment(p, p_batt, dt)
    over_hi = torch.clamp(new_soc - p.soc_safe_max, min=0.0)
    over_lo = torch.clamp(p.soc_safe_min - new_soc, min=0.0)
    p_batt = p_batt - over_hi * p.q_max / (p.eta_c * dt) + over_lo * p.q_max * p.eta_d / dt
    new_soc = torch.clamp(new_soc, p.soc_safe_min, p.soc_safe_max)
    if w is not None:
        new_soc = torch.where(w > 0, new_soc, state.soc)
    return ESSState(g_filter=g_new, soc=new_soc), rack_power + p_batt


def simulate(
    p: ESSParams,
    state: ESSState,
    rack_power: torch.Tensor,  # (T, ...)
    dt: float,
    corrective_power=0.0,  # scalar or (T, ...)
    online: torch.Tensor | None = None,  # (...) or (T, ...) weight
) -> tuple[torch.Tensor, torch.Tensor, ESSState]:
    """``step`` over a trace; ``online`` is a constant weight or a
    per-sample series.  Returns ``(node power (T, ...), soc (T, ...),
    final state)``."""
    corr = torch.as_tensor(corrective_power, dtype=torch.float32,
                           device=rack_power.device).expand(rack_power.shape)
    per_sample = online is not None and online.ndim == rack_power.ndim
    node = torch.empty_like(rack_power)
    soc = torch.empty_like(rack_power)
    for t in range(rack_power.shape[0]):
        w = online[t] if per_sample else online
        state, node[t] = step(p, state, rack_power[t], dt, corr[t], online=w)
        soc[t] = state.soc
    return node, soc, state


def transfer_function(p: ESSParams, f_hz: torch.Tensor) -> torch.Tensor:
    """``|H(j 2 pi f)|`` of the ESS stage: a first-order low-pass at
    ``beta / 2 pi``."""
    s = 2j * np.pi * f_hz
    return torch.abs(p.beta / (s + p.beta))


def worst_case_energy_swing(p: ESSParams, epsilon) -> torch.Tensor:
    """Appendix A.1 Eq. 7: ``|dE_B| <= epsilon / beta`` (seconds x P_RATED)."""
    return torch.as_tensor(epsilon, dtype=torch.float32, device=p.beta.device) / p.beta


def required_capacity_seconds(beta: float, epsilon: float, gamma: float) -> float:
    """Appendix A.1 Eq. 8: ``E_B >= epsilon / (gamma beta)`` (seconds)."""
    return epsilon / (gamma * beta)


def required_power_fraction(epsilon: float) -> float:
    """Appendix A.1 Eq. 9: ``P_B >= epsilon`` (fraction of rated power)."""
    return epsilon
