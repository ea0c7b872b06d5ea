"""Grid compliance checks (paper §3): ramp rate and frequency content.

Port of ``repro.core.compliance``.  The grid operator supplies a spec
``(beta, alpha, f_c)``:

  * ``|dP/dt| <= beta``  for all t   (P normalized to rated power)
  * ``S(f) <= alpha``    for all f >= f_c

with ``S`` the one-sided normalized DFT magnitude (``S(0)`` is the mean).

Two interfaces, as in the reference:

  * ``check`` — whole-trace oracle (forward-difference ramp + Hann FFT).
  * Streaming observers folded chunk by chunk inside the fleet engines:
    ``RampObserver`` carries the last sample across chunk boundaries, and
    ``SpectrumObserver`` accumulates the spec lines ``f >= f_c`` of a
    ``SpectrumBank``.

Spectrum observer design.  The reference folds each chunk with a
per-sample Goertzel recurrence (a ``lax.scan`` over the chunk).  Eagerly
on a GPU that recurrence is several kernel launches per sample, so the
port instead computes each chunk's line sums directly as an ``(L, m)``
cosine/sine product against the windowed chunk, in float64, with exact
integer bin phases (``bin * j mod modulus``), then rotates them onto the
absolute stream position with the carried integer phase exactly as the
reference does.  Both are the same DFT sum; the finalized magnitudes are
held to the reference's own contract of agreeing with
``normalized_spectrum`` at the bank lines to 1e-5 (tests).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils.devices import resolve_device
from repro_torch.utils.structures import Struct


@dataclasses.dataclass(frozen=True)
class GridSpec(Struct):
    beta: torch.Tensor  # max ramp rate [fraction of rated power / s]
    alpha: torch.Tensor  # spectral cap above f_c
    f_c: torch.Tensor  # cutoff frequency [Hz]

    @staticmethod
    def create(
        beta: float = 0.1, alpha: float = 1e-4, f_c: float = 2.0, *, device="cuda"
    ) -> "GridSpec":
        dev = resolve_device(device)
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        return GridSpec(beta=f(beta), alpha=f(alpha), f_c=f(f_c))


def ramp_rate(power: torch.Tensor, dt: float) -> torch.Tensor:
    """dP/dt via forward differences; shape (T-1, ...)."""
    return torch.diff(power, dim=0) / dt


def max_abs_ramp(power: torch.Tensor, dt: float) -> torch.Tensor:
    return torch.amax(torch.abs(ramp_rate(power, dt)), dim=0)


def _hann(n: int, device) -> torch.Tensor:
    """Periodic Hann window ``0.5 - 0.5 cos(2 pi i / n)`` (float64)."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    return 0.5 - 0.5 * torch.cos((2.0 * np.pi / n) * i)


def normalized_spectrum(
    power: torch.Tensor, dt: float, *, window: str | None = "hann"
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-sided normalized magnitude spectrum along axis 0.

    Returns ``(freqs [Hz], S)`` with ``S[0] ~= mean(power)`` and interior
    bins scaled so a sinusoid of amplitude A produces ``S = A``.  The Hann
    window is coherent-gain corrected (see the reference docstring);
    ``window=None`` gives the raw DFT.
    """
    n = power.shape[0]
    if window == "hann":
        w = _hann(n, power.device).to(power.dtype)
    elif window is None:
        w = torch.ones(n, dtype=power.dtype, device=power.device)
    else:
        raise ValueError(f"unknown window {window!r}")
    coherent_gain = torch.mean(w)
    wshape = (-1,) + (1,) * (power.ndim - 1)
    spec = torch.abs(torch.fft.rfft(power * w.reshape(wshape), dim=0)) / (
        n * coherent_gain
    )
    scale = torch.full((spec.shape[0],), 2.0, dtype=power.dtype, device=power.device)
    scale[0] = 1.0
    if n % 2 == 0:
        scale[-1] = 1.0
    spec = spec * scale.reshape(wshape)
    freqs = torch.fft.rfftfreq(n, d=dt, device=power.device)
    return freqs, spec


class ComplianceReport(NamedTuple):
    max_ramp: torch.Tensor
    ramp_ok: torch.Tensor
    worst_high_freq_mag: torch.Tensor
    spectrum_ok: torch.Tensor
    ok: torch.Tensor


def check(power: torch.Tensor, dt: float, spec: GridSpec) -> ComplianceReport:
    """Full compliance check of a normalized power trace (T,) or (T, racks)."""
    mr = max_abs_ramp(power, dt)
    ramp_ok = mr <= spec.beta
    freqs, s = normalized_spectrum(power, dt)
    above = freqs >= spec.f_c
    shape = (-1,) + (1,) * (power.ndim - 1)
    worst = torch.amax(torch.where(above.reshape(shape), s, 0.0), dim=0)
    spectrum_ok = worst <= spec.alpha
    return ComplianceReport(
        max_ramp=mr,
        ramp_ok=ramp_ok,
        worst_high_freq_mag=worst,
        spectrum_ok=spectrum_ok,
        ok=ramp_ok & spectrum_ok,
    )


# ------------------------------------------------------- streaming observers


class RampObserver(NamedTuple):
    """Cross-chunk running max-ramp: carries the last sample seen so the
    boundary difference between consecutive chunks is never dropped."""

    last: torch.Tensor  # last sample of the previous chunk
    n: torch.Tensor  # int32 samples seen
    max_ramp: torch.Tensor  # running max |dP/dt|


def ramp_observer_init(batch_shape: tuple[int, ...] = (), *, device="cuda") -> RampObserver:
    dev = resolve_device(device)
    return RampObserver(
        last=torch.zeros(batch_shape, dtype=torch.float32, device=dev),
        n=torch.zeros((), dtype=torch.int32, device=dev),
        max_ramp=torch.zeros(batch_shape, dtype=torch.float32, device=dev),
    )


def ramp_observer_update(obs: RampObserver, chunk: torch.Tensor, dt: float) -> RampObserver:
    """Fold one (T, ...) chunk; the running max equals the whole-trace
    ``max_abs_ramp`` exactly (the first chunk's carried sample is its own
    first sample, adding an exact zero difference)."""
    prev = torch.where(obs.n > 0, obs.last, chunk[0])
    ext = torch.cat([prev[None], chunk], dim=0)
    mr = torch.amax(torch.abs(torch.diff(ext, dim=0)), dim=0) / dt
    return RampObserver(
        last=chunk[-1],
        n=obs.n + chunk.shape[0],
        max_ramp=torch.maximum(obs.max_ramp, mr),
    )


@dataclasses.dataclass(frozen=True)
class SpectrumBank:
    """Static configuration of a spec-line bank: integer line indices
    ``bins`` on a length-``modulus`` DFT grid (line frequency
    ``bin / (modulus * dt)``).  ``window="hann"`` with ``modulus = n_total``
    matches ``normalized_spectrum`` at those bins; ``window=None`` (the
    reference's open-ended online form) normalizes by the samples seen."""

    bins: tuple[int, ...]
    modulus: int
    dt: float
    window: str | None = "hann"

    @property
    def freqs(self) -> np.ndarray:
        return np.asarray(self.bins, np.float64) / (self.modulus * self.dt)


def spec_lines(n_total: int, dt: float, f_c: float, n_lines: int = 48) -> tuple[int, ...]:
    """Log-spaced DFT bins of a length-``n_total`` trace covering
    [f_c, Nyquist] — the operator's monitored spec lines."""
    k_lo = max(int(np.ceil(f_c * n_total * dt)), 1)
    k_hi = n_total // 2
    if k_lo > k_hi:
        return ()
    ks = np.round(
        np.logspace(np.log10(k_lo), np.log10(max(k_hi, k_lo)), max(n_lines, 1))
    ).astype(np.int64)
    return tuple(int(k) for k in np.unique(ks))


def make_bank(n_total: int, dt: float, f_c: float, *, n_lines: int = 48) -> SpectrumBank:
    """Whole-trace-equivalent bank: Hann window, lines on the trace's bins."""
    return SpectrumBank(
        bins=spec_lines(n_total, dt, f_c, n_lines),
        modulus=int(n_total),
        dt=float(dt),
        window="hann",
    )


def make_online_bank(dt: float, f_c: float, *, n_lines: int = 24,
                     modulus: int = 1 << 15) -> SpectrumBank:
    """Open-ended bank (total length unknown): rectangular window, lines on
    a fixed length-``modulus`` frequency grid."""
    return SpectrumBank(
        bins=spec_lines(modulus, dt, f_c, n_lines),
        modulus=int(modulus),
        dt=float(dt),
        window=None,
    )


class SpectrumObserver(NamedTuple):
    """Running line-bank state: complex line accumulators plus the exact
    integer bin phase of the next sample (kept mod ``modulus``)."""

    acc_re: torch.Tensor  # (L,) float32
    acc_im: torch.Tensor  # (L,) float32
    phase: torch.Tensor  # (L,) int64: (bin * samples_seen) mod modulus
    n: torch.Tensor  # int32 samples seen


def spectrum_observer_init(bank: SpectrumBank, *, device="cuda") -> SpectrumObserver:
    dev = resolve_device(device)
    l = len(bank.bins)
    return SpectrumObserver(
        acc_re=torch.zeros(l, dtype=torch.float32, device=dev),
        acc_im=torch.zeros(l, dtype=torch.float32, device=dev),
        phase=torch.zeros(l, dtype=torch.int64, device=dev),
        n=torch.zeros((), dtype=torch.int32, device=dev),
    )


def spectrum_observer_update(
    bank: SpectrumBank, obs: SpectrumObserver, chunk: torch.Tensor
) -> SpectrumObserver:
    """Fold one (m,) chunk: the chunk's local line sums as one (L, m)
    cosine/sine product in float64 (integer phases, so no precision is lost
    to long streams), rotated onto the absolute position by the carried
    phase."""
    m = chunk.shape[0]
    if not bank.bins:
        return obs._replace(n=obs.n + m)
    mod = bank.modulus
    dev = chunk.device
    two_pi_n = 2.0 * np.pi / mod
    j = torch.arange(m, dtype=torch.int64, device=dev)
    x = chunk.to(torch.float64)
    if bank.window == "hann":
        wp = torch.remainder(obs.n.to(torch.int64) + j, mod)
        x = x * (0.5 - 0.5 * torch.cos(wp.to(torch.float64) * two_pi_n))
    elif bank.window is not None:
        raise ValueError(f"unknown window {bank.window!r}")
    bins = torch.tensor(bank.bins, dtype=torch.int64, device=dev)
    ang = torch.remainder(bins[:, None] * j[None, :], mod).to(torch.float64) * two_pi_n
    xb_re = torch.cos(ang) @ x
    xb_im = -(torch.sin(ang) @ x)
    rot = obs.phase.to(torch.float64) * two_pi_n
    r_re, r_im = torch.cos(rot), -torch.sin(rot)
    acc_re = obs.acc_re + (xb_re * r_re - xb_im * r_im).to(torch.float32)
    acc_im = obs.acc_im + (xb_re * r_im + xb_im * r_re).to(torch.float32)
    phase = torch.remainder(obs.phase + torch.remainder(bins * (m % mod), mod), mod)
    return SpectrumObserver(acc_re=acc_re, acc_im=acc_im, phase=phase, n=obs.n + m)


def spectrum_observer_finalize(
    bank: SpectrumBank, obs: SpectrumObserver
) -> tuple[np.ndarray, torch.Tensor]:
    """(freqs [Hz], S) at the bank lines, normalized like
    ``normalized_spectrum``: Hann banks by the configured total length and
    coherent gain, rectangular banks by the samples seen so far."""
    dev = obs.acc_re.device
    if not bank.bins:
        return np.zeros((0,)), torch.zeros(0, dtype=torch.float32, device=dev)
    mag = torch.sqrt(obs.acc_re**2 + obs.acc_im**2)
    if bank.window == "hann":
        n = bank.modulus
        norm = torch.tensor(
            n * np.mean(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)),
            dtype=torch.float32,
            device=dev,
        )
    else:
        norm = torch.clamp(obs.n.to(torch.float32), min=1.0)
    bins = np.asarray(bank.bins, np.int64)
    nyq = bank.modulus % 2 == 0
    scale = np.where((bins > 0) & ~(nyq & (bins == bank.modulus // 2)), 2.0, 1.0)
    scale_t = torch.tensor(scale, dtype=torch.float32, device=dev)
    return bank.freqs, mag * scale_t / norm


def report_from_observers(
    spec: GridSpec, ramp: RampObserver, bank: SpectrumBank, sob: SpectrumObserver
) -> ComplianceReport:
    """ComplianceReport from streaming state: the ramp bound is exact; the
    spectral bound is evaluated at the bank's monitored lines."""
    _, s = spectrum_observer_finalize(bank, sob)
    worst = torch.amax(s) if s.numel() else torch.zeros((), device=s.device)
    worst = torch.clamp(worst, min=0.0)  # the reference's max(..., initial=0)
    ramp_ok = ramp.max_ramp <= spec.beta
    spectrum_ok = worst <= spec.alpha
    return ComplianceReport(
        max_ramp=ramp.max_ramp,
        ramp_ok=ramp_ok,
        worst_high_freq_mag=worst,
        spectrum_ok=spectrum_ok,
        ok=ramp_ok & spectrum_ok,
    )
