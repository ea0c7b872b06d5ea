"""Passive input filter (paper §5.1) as an exact discrete state-space system.

Port of ``repro.core.filters``: the second-order LC low-pass with an R-L
damping leg in parallel with the filter inductor, states
``x = [i_L, v_C, i_D]``, inputs ``u = [v_in, i_load]`` and the grid-side
observable ``i_L + i_D``.  The continuous matrices are built in float64
numpy and discretized exactly under a zero-order hold with
``scipy.linalg.expm`` of the augmented matrix, then rounded to float32 —
the same host computation as the reference, so ``Ad``/``Bd``/``C`` are
bit-identical to it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.linalg
import torch

from repro_torch.utils.devices import resolve_device
from repro_torch.utils.structures import Struct


@dataclasses.dataclass(frozen=True)
class LCFilterParams(Struct):
    """Component values for the input filter (SI units or per-unit)."""

    l_f: torch.Tensor  # filter inductance
    c_f: torch.Tensor  # filter capacitance
    r_da: torch.Tensor  # damping resistance
    l_da: torch.Tensor  # damping inductance

    @staticmethod
    def create(
        l_f: float, c_f: float, r_da: float, l_da: float, *, device="cuda"
    ) -> "LCFilterParams":
        dev = resolve_device(device)
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        return LCFilterParams(l_f=f(l_f), c_f=f(c_f), r_da=f(r_da), l_da=f(l_da))

    def cutoff_hz(self) -> torch.Tensor:
        return 1.0 / (2.0 * np.pi * torch.sqrt(self.l_f * self.c_f))


def continuous_abc(p: LCFilterParams):
    """(A, B, C) continuous state-space matrices as float64 numpy."""
    l_f, c_f, r_da, l_da = (float(v) for v in (p.l_f, p.c_f, p.r_da, p.l_da))
    a = np.array(
        [
            [0.0, -1.0 / l_f, 0.0],
            [1.0 / c_f, 0.0, 1.0 / c_f],
            [0.0, -1.0 / l_da, -r_da / l_da],
        ]
    )
    b = np.array([[1.0 / l_f, 0.0], [0.0, -1.0 / c_f], [1.0 / l_da, 0.0]])
    c = np.array([[1.0, 0.0, 1.0]])  # observe grid-side current i_L + i_D
    return a, b, c


def discretize_zoh(a: np.ndarray, b: np.ndarray, dt: float):
    """Exact zero-order-hold discretization via the augmented exponential:
    ``expm([[A, B], [0, 0]] * dt) = [[Ad, Bd], [0, I]]`` (float64)."""
    n, m = b.shape
    aug = np.zeros((n + m, n + m))
    aug[:n, :n] = a
    aug[:n, n:] = b
    e = scipy.linalg.expm(aug * dt)
    return e[:n, :n], e[:n, n:]


@dataclasses.dataclass(frozen=True)
class DiscreteFilter(Struct):
    """x[t+1] = Ad x[t] + Bd u[t];  y[t] = C x[t]."""

    ad: torch.Tensor  # (n, n)
    bd: torch.Tensor  # (n, m)
    c: torch.Tensor  # (p, n)
    dt: float = 1e-3


def make_discrete_filter(p: LCFilterParams, dt: float) -> DiscreteFilter:
    """Discretize on the host; the matrices land on ``p``'s device."""
    a, b, c = continuous_abc(p)
    ad, bd = discretize_zoh(a, b, dt)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=p.l_f.device)
    return DiscreteFilter(ad=f(ad), bd=f(bd), c=f(c), dt=float(dt))


def steady_state(filt: DiscreteFilter, u: torch.Tensor) -> torch.Tensor:
    """State for a constant input ``u`` (..., m): solves ``(I - Ad) x = Bd u``
    in float32 for every leading index."""
    n = filt.ad.shape[0]
    eye = torch.eye(n, dtype=filt.ad.dtype, device=filt.ad.device)
    rhs = (u @ filt.bd.T)[..., None]  # (..., n, 1)
    lhs = (eye - filt.ad).expand(rhs.shape[:-2] + (n, n))
    return torch.linalg.solve(lhs, rhs)[..., 0]
