"""Component sizing from grid spec + rack rating (paper Appendix A.1).

Given the grid spec (beta, alpha, f_c) and the rack's rated power and
peak-to-idle swing epsilon = (P_RATED - P_MIN)/P_RATED, this module derives:

  * minimum battery capacity      E_B >= eps/(gamma*beta) * P_RATED  (Eq. 8)
  * minimum battery power rating  P_B >= eps * P_RATED               (Eq. 9)
  * LC values for a target filter cutoff f_f = 1/(2*pi*sqrt(LC))     (Eq. 10)
  * an R-L damping leg sized to bound the resonant peak.

It also computes the filter cutoff needed to push a workload's residual
spectrum under alpha: the ESS stage attenuates by (f_b/f) above
f_b = beta/2pi (-20 dB/dec) and the LC stage by (f_f/f)^2 above f_f
(-40 dB/dec); their product must map the worst-case rack magnitude at every
f >= f_c below alpha.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.filters import LCFilterParams


@dataclasses.dataclass(frozen=True)
class RackRating:
    p_rated_w: float  # rack TDP [W]
    p_min_w: float  # minimum rack power [W]
    v_dc: float = 400.0  # bus voltage [V]

    @property
    def epsilon(self) -> float:
        """Maximum power swing as a fraction of rated power (Eq. 5)."""
        return (self.p_rated_w - self.p_min_w) / self.p_rated_w

    @property
    def i_rated(self) -> float:
        return self.p_rated_w / self.v_dc


@dataclasses.dataclass(frozen=True)
class SizingResult:
    battery_energy_j: float  # Eq. 8 (with usable-window derating gamma)
    battery_power_w: float  # Eq. 9
    battery_capacity_ah: float  # at v_dc
    l_f: float
    c_f: float
    r_da: float
    l_da: float
    f_f_hz: float
    f_b_hz: float


def lc_from_cutoff(f_f_hz: float, z0_ohm: float) -> tuple[float, float]:
    """L, C with cutoff f_f and characteristic impedance Z0 = sqrt(L/C)."""
    w = 2.0 * math.pi * f_f_hz
    l = z0_ohm / w
    c = 1.0 / (w * z0_ohm)
    return l, c


def damping_leg(l_f: float, c_f: float, n: float = 0.5) -> tuple[float, float]:
    """R-L damping leg in parallel with L_F (Erickson Rf-Lb damping).

    L_da = n * L_f; R is chosen by direct numerical minimization of the
    worst-case transfer-function peak (robust to formula-misremembering —
    the resulting peak is asserted in tests).  Smaller n damps better but
    shifts the high-frequency asymptote from L_f to L_f*n/(1+n); n = 0.5
    gives a ~6 dB-max peak while keeping the -40 dB/dec rolloff within
    a factor ~3 of f_f.
    """
    import numpy as np

    z0 = math.sqrt(l_f / c_f)
    l_da = n * l_f
    f0 = 1.0 / (2.0 * math.pi * math.sqrt(l_f * c_f))
    f = np.logspace(math.log10(f0 / 30.0), math.log10(f0 * 30.0), 1200)
    s = 2j * np.pi * f

    def peak(r: float) -> float:
        z_c = 1.0 / (s * c_f)
        z_lf = s * l_f
        z_d = r + s * l_da
        z_series = z_lf * z_d / (z_lf + z_d)
        return float(np.max(np.abs(z_c / (z_c + z_series))))

    rs = z0 * np.logspace(-2.0, 2.0, 160)
    peaks = np.array([peak(r) for r in rs])
    r_best = float(rs[int(np.argmin(peaks))])
    return r_best, l_da


def size_system(
    rack: RackRating,
    beta: float,
    f_f_hz: float = 4.0,
    gamma: float = 0.5,
    z0_ohm: float | None = None,
) -> SizingResult:
    """Full Appendix A.1 sizing for a rack and ramp limit beta."""
    eps = rack.epsilon
    e_b = eps / (gamma * beta) * rack.p_rated_w  # joules
    p_b = eps * rack.p_rated_w
    ah = e_b / (rack.v_dc * 3600.0)
    if z0_ohm is None:
        # Characteristic impedance a fraction of the load impedance keeps the
        # filter stiff under load steps; 1/4 of R_load is a common choice.
        r_load = rack.v_dc**2 / rack.p_rated_w
        z0_ohm = r_load / 4.0
    l_f, c_f = lc_from_cutoff(f_f_hz, z0_ohm)
    r_da, l_da = damping_leg(l_f, c_f)
    return SizingResult(
        battery_energy_j=e_b,
        battery_power_w=p_b,
        battery_capacity_ah=ah,
        l_f=l_f,
        c_f=c_f,
        r_da=r_da,
        l_da=l_da,
        f_f_hz=f_f_hz,
        f_b_hz=beta / (2.0 * math.pi),
    )


def filter_cutoff_for_workload(
    rack_spectrum: "tuple",  # (freqs_hz ndarray, magnitudes ndarray)
    beta: float,
    alpha: float,
    f_c: float,
    *,
    peak_margin: float = 2.0,
    safety: float = 2.0,
    f_min: float = 0.2,
    f_max: float = 50.0,
) -> float:
    """Workload-informed LC cutoff (Appendix A.1: "the cutoff frequency is
    chosen such that the grid power harmonic content is acceptable").

    The ESS contributes |H_ess(f)| = f_b/f above f_b = beta/2pi; the LC
    contributes ~(f_f/f)^2 above f_f (with up to ``peak_margin`` of
    resonant magnification near f_f).  We return the largest f_f such that
    every rack spectral line at f >= f_c lands below alpha after both
    stages — larger f_f means smaller (cheaper) passives, so we take the
    max feasible.
    """
    import numpy as np

    freqs, mags = rack_spectrum
    freqs = np.asarray(freqs, np.float64)
    mags = np.asarray(mags, np.float64)
    sel = freqs >= f_c
    freqs, mags = freqs[sel], mags[sel]
    if freqs.size == 0:
        return f_max
    f_b = beta / (2.0 * math.pi)
    h_ess = np.minimum(f_b / freqs, 1.0)

    candidates = np.logspace(math.log10(f_min), math.log10(f_max), 400)
    feasible = f_min
    for f_f in candidates:
        h_lc = np.minimum((f_f / freqs) ** 2, 1.0) * peak_margin
        h_lc = np.minimum(h_lc, peak_margin)
        if np.all(mags * h_ess * np.minimum(h_lc, 1.0 * peak_margin) <= alpha / safety):
            feasible = float(f_f)
    return feasible


def prototype_rack() -> RackRating:
    """The paper's 10 kW, 400 V_DC prototype (§7.1)."""
    return RackRating(p_rated_w=10_000.0, p_min_w=2_000.0, v_dc=400.0)


def mw_rack() -> RackRating:
    """A 1 MW future rack (OCP Mt. Diablo regime, §2.3) with an 80% swing."""
    return RackRating(p_rated_w=1_000_000.0, p_min_w=200_000.0, v_dc=400.0)


def prototype_filter(f_f_hz: float = 4.0) -> LCFilterParams:
    rack = prototype_rack()
    s = size_system(rack, beta=0.1, f_f_hz=f_f_hz)
    return LCFilterParams.create(l_f=s.l_f, c_f=s.c_f, r_da=s.r_da, l_da=s.l_da)
