"""Auxiliary energy storage system (paper §5.3, Appendix A.1).

Port of the parameter and state containers of ``repro.core.ess``.  The
battery branch holds the grid-facing current to a first-order low-pass of
the rack current, ``dg/dt = beta (i_R - g)``, discretized exactly (ZOH) as
``g[t+1] = g[t] + (1 - exp(-beta dt)) (i_R[t] - g[t])``; the state of
charge integrates the battery power with charge/discharge efficiencies and
saturates at the safe window.  The per-sample simulation itself lives in
the ``pdu_health`` kernel and its plain version (``kernels``).
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
