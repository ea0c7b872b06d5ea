"""Grid-region layer: multi-campus conditioning at a point of interconnection.

Port of ``repro.core.grid``.  What the grid sees is the sum of many
campuses at one point of interconnection (POI):

* ``GridRegion`` — N campuses (each a ``power.scenario.Scenario``, rack
  counts and fault soups may differ) with their POI weights, the POI
  coupling constants and the wide-area oscillation band table.
* ``condition_region`` — the region engine behind ``fleet.condition``:
  each campus through the scanned engine in turn (one CUDA graph per
  campus structure, so campuses of one shape replay one graph), the POI
  summed left to right in float32 with the region's weights, and the POI
  observers folded over the campus engines' own chunk partition.  With a
  ``mesh`` (``sharding.region_mesh``) it runs the sharded engine
  (``condition_region_sharded``): the campuses in parallel, one a rank of
  the mesh's ``"campus"`` axis, gathered over that axis, and the same POI
  on every rank, bit for bit the sequential engine's.
* ``poi_response`` — first-order grid coupling: a swing-equation style
  frequency deviation and a proportional voltage deviation at the POI.
  The swing recurrence is a T-step scalar chain, so it runs on the host in
  float32, in the reference's order, and its result goes to the device.
* Mode detection — a second ``compliance.SpectrumBank`` dense over the
  sub-Hz wide-area bands; per-band verdicts fold into the POI report
  (``compliance.with_mode_verdicts``).  Campuses that checkpoint in
  lockstep ring the inter-area band; staggering the same schedule cancels
  it (``checkpoint_region``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import compliance, fleet, pdu, profiling as _prof
from repro_torch.sharding import rules
from repro_torch.utils.devices import resolve_device
from repro_torch.utils.structures import Struct

F32 = torch.float32


# ------------------------------------------------------------ POI coupling


@dataclasses.dataclass(frozen=True)
class POIConfig:
    """First-order coupling constants at the interconnection node (static
    host config, as ``compliance.SpectrumBank``)."""

    inertia_s: float = 8.0  # M: effective inertia constant [s]
    damping: float = 1.5  # D: load-frequency damping [pu power / pu freq]
    f0_hz: float = 60.0  # nominal system frequency
    v_sens: float = 0.05  # |dV| / dP voltage sensitivity [pu/pu, local bus]
    # The region's rated power as a fraction of the interconnection's
    # frequency-responsive capacity: the region's per-unit excursion is
    # scaled by this before it forces the swing dynamics.
    region_fraction: float = 0.01

    @staticmethod
    def create(**kw) -> "POIConfig":
        return POIConfig(**kw)


class POIResponse(NamedTuple):
    freq_dev_hz: torch.Tensor  # (T,) frequency deviation at the POI [Hz]
    volt_dev: torch.Tensor  # (T,) voltage deviation at the POI [pu]
    max_freq_dev_hz: torch.Tensor  # () worst |freq_dev|
    max_volt_dev: torch.Tensor  # () worst |volt_dev|


def _swing(dp_sys: np.ndarray, a: np.float32, damp: np.float32) -> np.ndarray:
    """Forward-Euler ``f <- f + a (-d - damp f)`` over a float32 trace, each
    operation rounded to float32 in the reference's order."""
    out = np.empty_like(dp_sys)
    f = np.float32(0.0)
    for i, d in enumerate(dp_sys):
        f = f + a * (-d - damp * f)
        out[i] = f
    return out


def poi_response(
    poi_power: torch.Tensor,
    poi: POIConfig,
    dt: float,
    p_ref: torch.Tensor | float | None = None,
) -> POIResponse:
    """Swing-style POI sensitivity:  M df/dt = -(dP + D f),  dV = -k_v dP.

    ``poi_power`` is the per-unit POI trace; deviations are taken against
    ``p_ref`` (default: the trace mean).  Per-unit frequency integrates by
    forward Euler on the host and scales by ``f0_hz``; the results lie on
    ``poi_power``'s device."""
    p = torch.as_tensor(poi_power).to(F32)
    ref = torch.mean(p) if p_ref is None else torch.as_tensor(p_ref, dtype=F32, device=p.device)
    dp = p - ref
    dp_sys = float(np.float32(poi.region_fraction)) * dp
    f = _swing(dp_sys.detach().cpu().numpy(), np.float32(dt / poi.inertia_s),
               np.float32(poi.damping))
    freq = torch.from_numpy(f).to(p.device) * float(np.float32(poi.f0_hz))
    volt = -float(np.float32(poi.v_sens)) * dp
    return POIResponse(freq_dev_hz=freq, volt_dev=volt,
                       max_freq_dev_hz=torch.amax(torch.abs(freq)),
                       max_volt_dev=torch.amax(torch.abs(volt)))


# ----------------------------------------------------------- mode detector


@dataclasses.dataclass(frozen=True)
class ModeBand:
    """One wide-area oscillation band: flag when any monitored line inside
    [lo_hz, hi_hz) exceeds ``threshold`` (normalized one-sided magnitude,
    the units of ``compliance.normalized_spectrum``)."""

    name: str
    lo_hz: float
    hi_hz: float
    threshold: float


# Inter-area modes live well below 1 Hz, local / intra-plant modes up to a
# few Hz; the thresholds are the reference's (calibrated on the
# synchronized-checkpoint region).
DEFAULT_MODE_BANDS = (
    ModeBand("inter_area", 0.1, 1.0, 0.005),
    ModeBand("local_plant", 1.0, 3.0, 0.005),
)


def mode_bank(
    n_total: int,
    dt: float,
    bands: tuple[ModeBand, ...] = DEFAULT_MODE_BANDS,
    *,
    max_lines_per_band: int = 96,
) -> compliance.SpectrumBank:
    """A line bank dense over the mode bands of a length-``n_total`` trace:
    every DFT bin inside each band (evenly strided down to
    ``max_lines_per_band`` lines when a band spans more), Hann windowed so
    finalized magnitudes match ``normalized_spectrum``."""
    bins: set[int] = set()
    for b in bands:
        k_lo = max(int(np.ceil(b.lo_hz * n_total * dt)), 1)
        k_hi = min(int(np.floor(b.hi_hz * n_total * dt)), n_total // 2)
        if k_hi < k_lo:
            continue
        ks = np.arange(k_lo, k_hi + 1, dtype=np.int64)
        if ks.size > max_lines_per_band:
            ks = np.unique(np.round(np.linspace(k_lo, k_hi, max_lines_per_band)).astype(np.int64))
        bins.update(int(x) for x in ks)
    return compliance.SpectrumBank(bins=tuple(sorted(bins)), modulus=int(n_total), dt=float(dt),
                                   window="hann")


def mode_verdicts(
    bank: compliance.SpectrumBank,
    obs: compliance.SpectrumObserver,
    bands: tuple[ModeBand, ...],
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mags, ok) per band: the worst monitored-line magnitude inside each
    band and its threshold verdict.  A band with no line on this trace's
    grid reports magnitude 0 and passes."""
    freqs, mags = compliance.spectrum_observer_finalize(bank, obs)
    dev = obs.acc_re.device
    out_m, out_ok = [], []
    for b in bands:
        sel = (freqs >= b.lo_hz) & (freqs < b.hi_hz)
        if not np.any(sel):
            out_m.append(torch.zeros((), dtype=F32, device=dev))
            out_ok.append(torch.ones((), dtype=torch.bool, device=dev))
            continue
        m = torch.amax(torch.where(torch.as_tensor(sel, device=dev), mags, 0.0))
        out_m.append(m)
        out_ok.append(m <= b.threshold)
    return torch.stack(out_m), torch.stack(out_ok)


# -------------------------------------------------------------- GridRegion


@dataclasses.dataclass(frozen=True)
class GridRegion(Struct):
    """N campuses aggregated at a point of interconnection.

    ``campuses`` is a tuple of per-campus ``Scenario``s (rack counts and
    fault soups may differ); ``weights`` the (C,) float32 per-unit POI
    share of each campus (the POI trace is ``sum_c w_c campus_c``); POI
    coupling and the mode-band table are static config.  Build with
    ``region(...)``."""

    campuses: tuple
    weights: torch.Tensor
    names: tuple = ()
    poi: POIConfig = POIConfig()
    bands: tuple = DEFAULT_MODE_BANDS

    @property
    def n_campuses(self) -> int:
        return len(self.campuses)

    @property
    def sample_hz(self) -> float:
        return self.campuses[0].sample_hz

    @property
    def total_samples(self) -> int:
        return self.campuses[0].total_samples

    @property
    def n_racks(self) -> tuple:
        return tuple(c.n_racks or 1 for c in self.campuses)


def region(
    campuses,
    *,
    weights=None,
    names=None,
    poi: POIConfig | None = None,
    bands: tuple[ModeBand, ...] = DEFAULT_MODE_BANDS,
    salt_noise: bool = True,
) -> GridRegion:
    """Build a ``GridRegion`` from per-campus scenarios (on the campuses'
    device).

    Campuses must share the sample rate and trace length (one POI clock).
    ``weights`` defaults to the rack-count share, so the POI trace is the
    per-unit mean over the region's racks.  ``salt_noise`` salts campus
    ``i`` with ``i`` (``scenario.with_noise_salt``) where it has noise and
    no salt yet, so campuses built from one workload spec draw decorrelated
    noise."""
    from repro_torch.power import scenario as SC

    campuses = tuple(campuses)
    if not campuses:
        raise ValueError("a region needs at least one campus")
    hz, total = campuses[0].sample_hz, campuses[0].total_samples
    for i, c in enumerate(campuses[1:], 1):
        if c.sample_hz != hz or c.total_samples != total:
            raise ValueError(
                f"campus {i} runs {c.sample_hz} Hz x {c.total_samples} samples but campus 0 "
                f"runs {hz} Hz x {total}; one POI clock requires a shared rate and length")
    if salt_noise:
        campuses = tuple(
            c if (c.noise_seed is None or c.noise_salt is not None) else SC.with_noise_salt(c, i)
            for i, c in enumerate(campuses))
    dev = campuses[0].device
    if weights is None:
        w = np.asarray([c.n_racks or 1 for c in campuses], np.float32)
        weights = w / w.sum()
    if isinstance(weights, torch.Tensor):
        weights = weights.to(device=dev, dtype=F32)
    else:
        weights = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
    if tuple(weights.shape) != (len(campuses),):
        raise ValueError(f"weights shape {tuple(weights.shape)} != ({len(campuses)},)")
    names = tuple(names) if names else tuple(f"campus{i}" for i in range(len(campuses)))
    if len(names) != len(campuses):
        raise ValueError(f"{len(names)} names for {len(campuses)} campuses")
    return GridRegion(campuses=campuses, weights=weights, names=names,
                      poi=poi if poi is not None else POIConfig(), bands=tuple(bands))


def checkpoint_region(
    n_campuses: int = 4,
    n_racks: int = 64,
    *,
    duration_s: float = 200.0,
    sample_hz: float = 50.0,
    dip_period_s: float = 8.0,
    dip_duration_s: float = 2.0,
    p_dip: float = 0.12,
    stagger: bool = False,
    noise_seed: int | None = 0,
    poi: POIConfig | None = None,
    bands: tuple[ModeBand, ...] = DEFAULT_MODE_BANDS,
    device="cuda",
) -> GridRegion:
    """The wide-area oscillation testbench: N identical campuses whose only
    periodic structure is the checkpoint stall (compute plateau, no comm
    wave), every ``dip_period_s``.  ``stagger=False`` checkpoints every
    campus in lockstep (the POI rings the dip fundamental, inside the
    inter-area band at the defaults); ``stagger=True`` offsets campus c by
    ``c/N`` of the period, cancelling every harmonic that is not a multiple
    of N (the mode detector passes)."""
    from repro_torch.power import scenario as SC

    dev = resolve_device(device)
    campuses = []
    for c in range(n_campuses):
        off = (c * dip_period_s / n_campuses) if stagger else 0.0
        w = SC.workload(comm_fraction=0.0, p_comm=0.92, dip_period_s=dip_period_s,
                        dip_duration_s=dip_duration_s, p_dip=p_dip, warmup_s=2.0,
                        t_start_s=np.full((n_racks,), off, np.float32), device=dev)
        campuses.append(SC.make_scenario(w, duration_s=duration_s, sample_hz=sample_hz,
                                         edge_pad="clamp", noise_seed=noise_seed))
    return region(campuses, poi=poi, bands=bands)


def synchronized_region(**kw) -> GridRegion:
    """``checkpoint_region`` with lockstep campus checkpoints (rings the
    inter-area mode band)."""
    return checkpoint_region(stagger=False, **kw)


def staggered_region(**kw) -> GridRegion:
    """``checkpoint_region`` with campus checkpoints staggered across the
    dip period (the mode cancels at the POI)."""
    return checkpoint_region(stagger=True, **kw)


# ---------------------------------------------------------- POI observers


class _POIObservers(NamedTuple):
    """Streaming compliance state of the POI traces: ramp and spec-line
    observers on the unconditioned and conditioned POI, and the mode-band
    fold on the conditioned POI."""

    ramp_rack: compliance.RampObserver
    ramp_grid: compliance.RampObserver
    spec_rack: compliance.SpectrumObserver
    spec_grid: compliance.SpectrumObserver
    modes: compliance.SpectrumObserver


def _poi_observers_init(bank, mbank, device) -> _POIObservers:
    return _POIObservers(
        ramp_rack=compliance.ramp_observer_init(device=device),
        ramp_grid=compliance.ramp_observer_init(device=device),
        spec_rack=compliance.spectrum_observer_init(bank, device=device),
        spec_grid=compliance.spectrum_observer_init(bank, device=device),
        modes=compliance.spectrum_observer_init(mbank, device=device),
    )


def _poi_observers_update(po, bank, mbank, pr, pg, dt) -> _POIObservers:
    return _POIObservers(
        ramp_rack=compliance.ramp_observer_update(po.ramp_rack, pr, dt),
        ramp_grid=compliance.ramp_observer_update(po.ramp_grid, pg, dt),
        spec_rack=compliance.spectrum_observer_update(bank, po.spec_rack, pr),
        spec_grid=compliance.spectrum_observer_update(bank, po.spec_grid, pg),
        modes=compliance.spectrum_observer_update(mbank, po.modes, pg),
    )


def _poi_fold(bank, mbank, chunk: int, n_full: int, rem: int, dt: float, pr, pg):
    """The POI observers folded over materialised POI traces with the
    campus engines' chunk partition (``n_full`` chunks of ``chunk`` samples,
    then the ``rem``-sample tail), as the reference's ``_poi_fold``: the
    observers' float32 accumulation depends on the partition."""
    t = n_full * chunk + rem
    return fleet._fold_chunks(
        _poi_observers_init(bank, mbank, pr.device),
        lambda po, r, g: _poi_observers_update(po, bank, mbank, r, g, dt), chunk, pr[:t], pg[:t])


# -------------------------------------------------------------- engine


def _weighted_sum(weights: torch.Tensor, traces: list[torch.Tensor]) -> torch.Tensor:
    """``w[0] * a[0] + w[1] * a[1] + ...`` in float32, left to right."""
    return functools.reduce(lambda a, b: a + b, [weights[c] * x for c, x in enumerate(traces)])


def _assemble_region_result(cfg, reg, grid_spec, per, poi_rack, poi_grid, po, bank, mbank):
    rep_rack = compliance.report_from_observers(grid_spec, po.ramp_rack, bank, po.spec_rack)
    rep_grid = compliance.report_from_observers(grid_spec, po.ramp_grid, bank, po.spec_grid)
    mags, ok = mode_verdicts(mbank, po.modes, reg.bands)
    rep_poi = compliance.with_mode_verdicts(rep_grid, mags, ok)
    resp = poi_response(poi_grid, reg.poi, cfg.sample_dt)
    stack = lambda name: torch.stack([getattr(p, name) for p in per])
    return fleet.ConditioningResult(
        campus_rack=stack("campus_rack"),
        campus_grid=stack("campus_grid"),
        report_rack=rep_rack,
        report_grid=rep_poi,
        soc_mean=stack("soc_mean"),
        state=tuple(p.state for p in per),
        max_qp_residual=functools.reduce(torch.maximum, [p.max_qp_residual for p in per]),
        health_trace=stack("health_trace"),
        ess_online_frac=stack("ess_online_frac"),
        safemode_trace=stack("safemode_trace"),
        poi_rack=poi_rack,
        poi_grid=poi_grid,
        report_poi=rep_poi,
        poi_freq_dev=resp.freq_dev_hz,
        poi_volt_dev=resp.volt_dev,
        per_campus=tuple(per),
        weights=reg.weights,
        grid_spec=grid_spec,
        bank=bank,
        observers=fleet._Observers(po.ramp_rack, po.ramp_grid, po.spec_rack, po.spec_grid),
    )


def condition_region_sequential(
    cfg: pdu.PDUConfig,
    reg: GridRegion,
    grid_spec: compliance.GridSpec,
    *,
    soc0: float = 0.5,
    qp_iters: int = 30,
    chunk_intervals: int = 16,
    states=None,
    start_sample: int = 0,
    stop_sample: int | None = None,
) -> fleet.ConditioningResult:
    """The region engine: each campus through the scanned engine in turn
    with its own state (``states``, a tuple of per-campus ``PDUState``s,
    resumes a window; each is copied, never written), the POI summed left
    to right with the region's weights, the POI observers folded with the
    campus engines' chunk partition.  Heterogeneous rack counts are fine;
    the wall grows with N campuses.  Campuses of one structure (salted
    campuses of one spec, a region and its staggered twin) replay one
    graph."""
    C = reg.n_campuses
    states = (None,) * C if states is None else tuple(states)
    if len(states) != C:
        raise ValueError(f"{len(states)} states for {C} campuses")
    k, chunk, start, stop, t_total, n_full, rem = fleet._window_geometry(
        cfg, reg.total_samples, chunk_intervals, start_sample, stop_sample, what="region")
    per = [
        fleet._condition_scenario_scanned_impl(
            cfg, scen, grid_spec, soc0=soc0, qp_iters=qp_iters, chunk_intervals=chunk_intervals,
            state=states[c], start_sample=start, stop_sample=stop)
        for c, scen in enumerate(reg.campuses)
    ]
    return _region_result(cfg, reg, grid_spec, per, chunk, n_full, rem, t_total)


def _region_result(cfg, reg, grid_spec, per, chunk, n_full, rem, t_total):
    """The region's result from its campuses' results: the POI summed left
    to right, its observers folded with the campus engines' chunk
    partition, the reports and ``poi_response``."""
    poi_rack = _weighted_sum(reg.weights, [p.campus_rack for p in per])
    poi_grid = _weighted_sum(reg.weights, [p.campus_grid for p in per])
    bank = fleet._make_bank(grid_spec, cfg, t_total)
    mbank = mode_bank(t_total, cfg.sample_dt, reg.bands)
    po = _poi_fold(bank, mbank, chunk, n_full, rem, cfg.sample_dt, poi_rack, poi_grid)
    return _assemble_region_result(cfg, reg, grid_spec, per, poi_rack, poi_grid, po, bank, mbank)


def condition_region_sharded(
    cfg: pdu.PDUConfig,
    reg: GridRegion,
    grid_spec: compliance.GridSpec,
    mesh,
    *,
    soc0: float = 0.5,
    qp_iters: int = 30,
    chunk_intervals: int = 16,
    states=None,
    start_sample: int = 0,
    stop_sample: int | None = None,
) -> fleet.ConditioningResult:
    """The region's campuses in parallel: every rank of ``mesh``'s world
    makes the call; the rank at coordinate ``c`` of the ``"campus"`` axis
    runs campus ``c`` through the scanned engine (ranks along the other
    axes repeat it: a campus's racks stay whole), the campus results are
    gathered over the campus axis, and every rank forms the POI, folds its
    observers and runs ``poi_response`` as ``condition_region_sequential``
    does, so every rank returns that engine's result bit for bit.  Requires
    a ``"campus"`` axis of exactly ``n_campuses`` ranks
    (``sharding.region_mesh``); campuses may differ in structure and rack
    count.  ``states`` resumes as in the sequential engine, all of them or
    none."""
    rules.check_mesh(mesh, device_type=cfg.device.type)
    C, axis = reg.n_campuses, rules.CAMPUS_AXIS
    sizes = rules.axis_sizes(mesh)
    if axis not in sizes:
        raise ValueError(f"mesh axes {tuple(sizes)} lack the {axis!r} axis; build the region "
                         "mesh with sharding.region_mesh(n_campuses)")
    if sizes[axis] != C:
        raise ValueError(
            f"mesh has {sizes[axis]} campus shards for {C} campuses; exactly one campus per "
            "shard keeps the POI sum in the sequential engine's left-to-right order (the "
            "bitwise-parity contract)")
    for scen in reg.campuses:  # on every rank, before any collective
        fleet._check_scenario_rate(scen, cfg)
        fleet._check_scenario_faults(scen, cfg)
    k, chunk, start, stop, t_total, n_full, rem = fleet._window_geometry(
        cfg, reg.total_samples, chunk_intervals, start_sample, stop_sample, what="region")
    states = (None,) * C if states is None else tuple(states)
    if len(states) != C:
        raise ValueError(f"{len(states)} states for {C} campuses")
    if any(s is None for s in states) and not all(s is None for s in states):
        raise ValueError("per-campus resume states must be all-None (fresh start) or all present")
    c = rules.axis_index(mesh, axis)
    st, out, bank = fleet._scanned_window(
        cfg, reg.campuses[c], grid_spec, soc0=soc0, qp_iters=qp_iters,
        chunk_intervals=chunk_intervals, state=states[c], start_sample=start, stop_sample=stop)
    with _prof.span("gather") as sync:
        parts = rules.all_gather_tree((st, out), mesh, axis)
        sync(parts[-1][1].campus_grid)
    per = [fleet._finish_streaming(cfg, grid_spec, s, o, bank) for s, o in parts]
    return _region_result(cfg, reg, grid_spec, per, chunk, n_full, rem, t_total)


def condition_region(
    cfg: pdu.PDUConfig,
    reg: GridRegion,
    grid_spec: compliance.GridSpec,
    *,
    mesh=None,
    **kwargs,
) -> fleet.ConditioningResult:
    """Region dispatch behind ``fleet.condition``: a mesh selects the
    sharded engine, ``mesh=None`` the sequential one."""
    if mesh is not None:
        return condition_region_sharded(cfg, reg, grid_spec, mesh, **kwargs)
    return condition_region_sequential(cfg, reg, grid_spec, **kwargs)
