"""Passive input filter (paper §5.1) as an exact discrete state-space system.

Port of ``repro.core.filters``: the second-order LC low-pass with an R-L
damping leg in parallel with the filter inductor, states
``x = [i_L, v_C, i_D]``, inputs ``u = [v_in, i_load]`` and the grid-side
observable ``i_L + i_D``.  The continuous matrices are built in float64
numpy and discretized exactly under a zero-order hold with
``scipy.linalg.expm`` of the augmented matrix, then rounded to float32 —
the same host computation as the reference, so ``Ad``/``Bd``/``C`` are
bit-identical to it.  ``simulate`` runs the general state-space recurrence
step by step (the physics the ``lc_filter`` and ``pdu_sim`` kernels are
held to); the transfer functions evaluate the continuous circuit.
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


def simulate(
    filt: DiscreteFilter, x0: torch.Tensor, u: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the filter over inputs ``u (T, ..., m)`` from ``x0 (..., n)``
    (leading dimensions broadcast over racks): ``y_t = x_t C^T``,
    ``x_{t+1} = x_t Ad^T + u_t Bd^T``.  Returns ``(y (T, ..., p), x_final
    (..., n))``."""
    ad_t, bd_t, c_t = filt.ad.T, filt.bd.T, filt.c.T
    x = x0
    y = torch.empty((u.shape[0],) + torch.broadcast_shapes(x0.shape[:-1], u.shape[1:-1])
                    + (c_t.shape[1],), dtype=x0.dtype, device=x0.device)
    for t in range(u.shape[0]):
        y[t] = x @ c_t
        x = x @ ad_t + u[t] @ bd_t
    return y, x


def transfer_function_rack_to_grid(p: LCFilterParams, f_hz: torch.Tensor) -> torch.Tensor:
    """``|H(j 2 pi f)|`` from rack (node) current to grid current with
    ``v_in`` held fixed: ``H = Z_C / (Z_C + Z_series)``, ``Z_C = 1/(s C_F)``,
    ``Z_series = s L_F || (R_Da + s L_Da)``."""
    s = 2j * np.pi * f_hz
    z_c = 1.0 / (s * p.c_f)
    z_lf = s * p.l_f
    z_d = p.r_da + s * p.l_da
    z_series = z_lf * z_d / (z_lf + z_d)
    return torch.abs(z_c / (z_c + z_series))


def resonance_peak_db(p: LCFilterParams, n_points: int = 2048) -> torch.Tensor:
    """Worst-case magnification (dB) of the damped filter over 1/30 to 30
    times its cutoff, on ``n_points`` log-spaced frequencies."""
    f0 = p.cutoff_hz()
    f = 10.0 ** torch.linspace(float(torch.log10(f0 / 30.0)), float(torch.log10(f0 * 30.0)),
                               n_points, dtype=torch.float32, device=f0.device)
    return 20.0 * torch.log10(torch.max(transfer_function_rack_to_grid(p, f)))
