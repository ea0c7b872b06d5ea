"""Fleet-scale conditioning engines and the ``condition`` facade.

Port of ``repro.core.fleet`` for ``Scenario`` and ``(T, R)`` tensor
targets.  Every rack gets its own PDU state; the rack axis rides in the
trailing dimension of every tensor and of the kernels' launches.

Engines:

  * ``"scanned"`` (the default, as in the reference): a ``Scenario``
    window rendered and conditioned chunk by chunk — every full chunk,
    the ragged tail at its natural length, the compliance observers'
    folds and the stacking of the campus aggregates — as ONE CUDA graph,
    captured once per key (config, chunk geometry, window length, the
    scenario's structure) and replayed; the reference's one ``lax.scan``
    jit.  ``StreamOptions.start_sample`` / ``stop_sample`` window it and
    ``state`` resumes it; the start is read on the card, so every window
    of one length replays one graph.  Its numbers are the host engine's
    bit for bit.  On the CPU (``device="cpu"``, which only a caller that
    asks for it gets) the same chunk loop runs eagerly, with no graph and
    no cache: the CPU path, as the kernels' plain versions are.
  * ``"host"``: walk the trace in chunks of ``chunk_intervals`` controller
    intervals from Python — render each chunk on the card, condition it
    (``pdu.condition_campus``), fold the streaming compliance observers —
    so live memory stays O(chunk x R); takes raw traces and chunk
    providers too, and the stream can resume from a result's ``state``.
    ``profiling`` spans time its phases.
  * ``"oneshot"``: materialize the whole ``(T, R)`` trace and grid
    waveform and check compliance on the whole campus means; the one
    engine that takes ``use_plan=False`` (the per-step controller oracle).

Under a degraded-mode config a ``Scenario`` carrying a fault schedule runs
degraded: the scanned and host engines hand the schedule to
``pdu.condition`` (the fast path), the one-shot engine the streamed mask
and weight derived from it, and all return ``ess_online_frac``.  Under a
safe-mode config every engine returns ``safemode_trace`` and the streaming
ones ``safemode_summary()``.  The reference's four deprecated entry points
(``condition_fleet``, ``condition_fleet_streaming``,
``condition_scenario_scanned``, ``condition_scenario_streaming``) are thin
aliases of the facade.  A ``core.grid.GridRegion`` target runs the region
engine (``grid.condition_region``: each campus through the scanned engine,
the POI summed and observed).

``mesh=`` (a ``torch.distributed`` ``DeviceMesh``, ``sharding.make_mesh``)
shards a campus's racks over the mesh axis ``"data"`` on the scanned
and host engines: every rank of the world makes the same call, renders
the whole chunk, conditions its contiguous block of racks
(``sharding.rack_block``) as a fleet of its own, and at the window's end
gathers the blocks (``sharding.all_gather_tree``), so every rank returns
the whole result.  Racks are independent in the controller and in
``pdu_health``, so every per-rack quantity (the state, the wear report)
is bit for bit the one-rank run's; the campus means combine the ranks'
block means in rank order, weighted by rack share (within float32
rounding of the one-rank means), and counts (the ESS online fraction, the
safe-mode snapshot) combine exactly.  The compliance observers then fold
over the combined campus traces on the engine's chunk partition.  A grid
region with a mesh runs the sharded region engine
(``grid.condition_region_sharded``); the one-shot engine takes no mesh.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import traceback
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import compliance, controller as ctrl, health as hlt, pdu, \
    profiling as _prof, safemode as smode
from repro_torch.sharding import rules
from repro_torch.utils.devices import resolve_device
from repro_torch.utils.trees import tree_leaves as _tree_leaves, tree_map as _tree_map

F32 = torch.float32


class ConditioningResult(NamedTuple):
    """The one result type every conditioning engine returns; fields an
    engine does not track are ``None``."""

    campus_rack: torch.Tensor = None  # (T,) mean per-unit unconditioned load
    campus_grid: torch.Tensor = None  # (T,) mean per-unit conditioned load
    report_rack: compliance.ComplianceReport = None
    report_grid: compliance.ComplianceReport = None
    health: hlt.HealthReport = None  # per-rack wear report
    grid_traces: torch.Tensor = None  # (T, R) conditioned per-rack (oneshot)
    soc_mean: torch.Tensor = None  # (n_ctrl,) fleet-mean SoC per interval
    # Final PDU state (the stream can resume); a grid region carries the
    # tuple of per-campus states.
    state: pdu.PDUState = None
    max_qp_residual: torch.Tensor = None  # worst QP primal residual seen
    health_trace: torch.Tensor = None  # (n_chunks, 3) [mean EFC, max fade, max DoD]
    # (n_ctrl,) fraction of ESS units online per interval (ones unless the
    # cfg runs degraded_mode).
    ess_online_frac: torch.Tensor = None
    # (n_chunks, 6) supervisor snapshot per chunk (``pdu.CampusChunk.
    # safemode``; zeros unless the cfg runs safemode; (1, 6) one-shot; a
    # grid region stacks a leading campus axis).
    safemode_trace: torch.Tensor = None
    # Grid-region fields (``core.grid``); a region's campus arrays above
    # carry a leading campus axis.
    poi_rack: torch.Tensor = None  # (T,) POI unconditioned (weighted campus sum)
    poi_grid: torch.Tensor = None  # (T,) POI conditioned
    report_poi: compliance.ComplianceReport = None  # POI report + mode verdicts
    poi_freq_dev: torch.Tensor = None  # (T,) swing-model frequency deviation [Hz]
    poi_volt_dev: torch.Tensor = None  # (T,) first-order voltage deviation [pu]
    per_campus: tuple = None  # per-campus ConditioningResults
    weights: torch.Tensor = None  # (C,) campus POI weights
    grid_spec: compliance.GridSpec = None
    bank: compliance.SpectrumBank = None
    observers: "_Observers" = None

    def report(self, which: str = "grid") -> compliance.ComplianceReport:
        """Compliance report of ``"rack"``, ``"grid"`` or ``"poi"`` (grid
        regions: the conditioned POI with the mode-band verdicts folded
        in), re-derived from the streaming observers when the engine
        carried them."""
        stored = {"rack": self.report_rack, "grid": self.report_grid, "poi": self.report_poi}
        if which not in stored:
            raise ValueError(f"which={which!r} (expected 'rack', 'grid' or 'poi')")
        pre = stored[which]
        if self.observers is None or self.bank is None or self.grid_spec is None:
            return pre
        key = "grid" if which == "poi" else which
        rep = compliance.report_from_observers(
            self.grid_spec,
            getattr(self.observers, f"ramp_{key}"),
            self.bank,
            getattr(self.observers, f"spec_{key}"),
        )
        if pre is not None and pre.mode_mags is not None:
            rep = compliance.with_mode_verdicts(rep, pre.mode_mags, pre.mode_ok)
        return rep

    def safemode_summary(self) -> dict | None:
        """Host summary of the supervisor's final state (``safemode.
        summary``); None when the engine carried no state (one-shot).  A
        grid region sums its campuses' counts and keys the rack lists by
        campus index."""
        if self.state is None:
            return None
        # PDUState is a NamedTuple too: only a plain tuple is a region's.
        states = (self.state,) if isinstance(self.state, pdu.PDUState) else tuple(self.state)
        if any(st.safemode is None for st in states):
            return None
        parts = [smode.summary(st.safemode) for st in states]
        out = dict(parts[0])
        if len(parts) > 1:
            for key in ("n_normal", "n_passthrough", "n_quarantined", "passthrough_entries",
                        "quarantine_entries", "readmissions"):
                out[key] = sum(p[key] for p in parts)
            out["worst_resid_streak"] = max(p["worst_resid_streak"] for p in parts)
            out["passthrough_racks"] = {c: p["passthrough_racks"] for c, p in enumerate(parts)}
            out["quarantined_racks"] = {c: p["quarantined_racks"] for c, p in enumerate(parts)}
        return out



def synchronous_aggregate(rack_power: torch.Tensor, n_racks: int) -> torch.Tensor:
    """Eq. 19: ``P_IT = N P_i`` for lockstep racks; per-unit traces are
    scale-invariant (Eq. 20), so the per-unit campus trace is the rack's."""
    return rack_power


def staggered_fleet(
    rack_trace: torch.Tensor,  # (T,)
    n_racks: int,
    generator: torch.Generator | None = None,
    *,
    max_offset_samples: int = 0,
    scale_jitter: float = 0.0,
    device="cuda",
) -> torch.Tensor:
    """``(T, n_racks)`` traces: copies of ``rack_trace`` rolled by offsets
    drawn uniformly from ``[0, max_offset_samples)`` and scaled by ``1 +
    scale_jitter u`` with ``u`` uniform in ``[-1, 1)``, both drawn from
    ``generator`` on ``device`` (torch's default generator if None).  The
    port cannot reproduce ``jax.random``'s threefry bits, so one seed gives
    other offsets and scales than the reference's key; ``_stagger`` takes
    drawn ones, e.g. the reference's."""
    dev = resolve_device(device)
    if max_offset_samples > 0:
        offsets = torch.randint(0, max_offset_samples, (n_racks,), generator=generator,
                                device=dev)
    else:
        offsets = torch.zeros(n_racks, dtype=torch.int64, device=dev)
    u = torch.rand(n_racks, generator=generator, dtype=F32, device=dev) * 2.0 - 1.0
    return _stagger(rack_trace.to(device=dev, dtype=F32), offsets, 1.0 + scale_jitter * u)


def _stagger(rack_trace: torch.Tensor, offsets: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Column r is ``roll(rack_trace, offsets[r]) * scales[r]``."""
    t = rack_trace.shape[0]
    idx = torch.remainder(
        torch.arange(t, device=rack_trace.device)[:, None] - offsets.to(torch.int64)[None, :], t)
    return rack_trace[idx] * scales.to(rack_trace.dtype)[None, :]


def apply_failures(traces: torch.Tensor, fail_times, p_idle: float = 0.1) -> torch.Tensor:
    """Racks drop to ``p_idle`` from their failure sample on (-1 = never),
    through a one-episode fault schedule (``power.faults``), as the
    reference's compatibility shim does.  Prefer ``scenario.attach_faults``
    for anything new."""
    from repro_torch.power import faults as FLT

    t, r = traces.shape
    ft = fail_times.detach().cpu().numpy() if isinstance(fail_times, torch.Tensor) \
        else np.asarray(fail_times)
    sched = FLT.schedule_from_episodes(
        r, rack=[(i, int(ft[i]), t) for i in range(r) if ft[i] >= 0],
        p_fault=p_idle, device=traces.device,
    )
    return torch.where(FLT.rack_down(sched, 0, t), float(np.float32(p_idle)), traces)


def _health_params(cfg: pdu.PDUConfig) -> hlt.HealthParams:
    return cfg.health if cfg.health is not None else hlt.HealthParams.create(device=cfg.device)


def _condition_fleet_impl(
    cfg: pdu.PDUConfig,
    traces: torch.Tensor,  # (T, R)
    grid_spec: compliance.GridSpec,
    *,
    soc0: float = 0.5,
    qp_iters: int = 60,
    use_plan: bool = True,
    ess_online=None,
    ess_weight=None,
    plan=None,
) -> ConditioningResult:
    """One-shot: condition every rack over the whole trace; check campus
    compliance on the whole campus means.  ``use_plan`` and
    ``ess_online``/``ess_weight`` (degraded mode) as in ``pdu.condition``."""
    traces = traces.to(device=cfg.device, dtype=F32)
    state = pdu.init_state(cfg, traces[0], soc0=soc0)
    grid, state_f, telem = pdu.condition(
        cfg, state, traces, qp_iters=qp_iters, use_plan=use_plan,
        ess_online=ess_online, ess_weight=ess_weight, plan=plan,
    )
    on_frac = (torch.mean(telem.ess_online, dim=1) if cfg.degraded_mode
               else torch.ones(telem.soc.shape[0], dtype=F32, device=cfg.device))
    # The campus means from inside the conditioning loop: the same
    # per-interval reductions the host engine folds, so the two engines
    # agree bit for bit.
    campus_rack, campus_grid = telem.rack_mean, telem.grid_mean
    return ConditioningResult(
        grid_traces=grid,
        campus_rack=campus_rack,
        campus_grid=campus_grid,
        report_rack=compliance.check(campus_rack, cfg.sample_dt, grid_spec),
        report_grid=compliance.check(campus_grid, cfg.sample_dt, grid_spec),
        health=hlt.report(_health_params(cfg), cfg.ess_params, state_f.health, cfg.sample_dt),
        ess_online_frac=on_frac,
        safemode_trace=(smode.chunk_snapshot(state_f.safemode)[None] if cfg.safemode
                        else torch.zeros((1, 6), dtype=F32, device=cfg.device)),
    )


class _Observers(NamedTuple):
    """Streaming compliance state folded chunk by chunk."""

    ramp_rack: compliance.RampObserver
    ramp_grid: compliance.RampObserver
    spec_rack: compliance.SpectrumObserver
    spec_grid: compliance.SpectrumObserver


def _observers_init(bank: compliance.SpectrumBank, device) -> _Observers:
    return _Observers(
        ramp_rack=compliance.ramp_observer_init(device=device),
        ramp_grid=compliance.ramp_observer_init(device=device),
        spec_rack=compliance.spectrum_observer_init(bank, device=device),
        spec_grid=compliance.spectrum_observer_init(bank, device=device),
    )


def _observers_update(
    obs: _Observers, bank: compliance.SpectrumBank, rack: torch.Tensor, grid: torch.Tensor,
    dt: float,
) -> _Observers:
    """Fold one chunk of the campus traces (``rack``, ``grid``)."""
    return _Observers(
        ramp_rack=compliance.ramp_observer_update(obs.ramp_rack, rack, dt),
        ramp_grid=compliance.ramp_observer_update(obs.ramp_grid, grid, dt),
        spec_rack=compliance.spectrum_observer_update(bank, obs.spec_rack, rack),
        spec_grid=compliance.spectrum_observer_update(bank, obs.spec_grid, grid),
    )


def _make_bank(grid_spec: compliance.GridSpec, cfg: pdu.PDUConfig, n_total: int):
    return compliance.make_bank(n_total, cfg.sample_dt, float(grid_spec.f_c))


class _Stream(NamedTuple):
    """What a streaming run accumulates besides the state."""

    campus_rack: torch.Tensor  # (T,)
    campus_grid: torch.Tensor  # (T,)
    soc_mean: torch.Tensor  # (n_ctrl,)
    worst: torch.Tensor  # () running max QP primal residual
    health_trace: torch.Tensor  # (n_chunks, 3) fleet wear snapshot per chunk
    ess_frac: torch.Tensor  # (n_ctrl,) online fraction
    sm_trace: torch.Tensor  # (n_chunks, 6) supervisor snapshot per chunk
    obs: _Observers  # streaming compliance state


class _CampusAccum:
    """Preallocated campus outputs of a streaming run, written chunk by
    chunk at the *full* chunk geometry (``chunk`` samples, ``n_int``
    intervals), so a ragged tail lands at its place; the worst QP residual
    is a running max and the observers fold each chunk (unless ``observe``
    is off: a rack block's run, whose observers fold after the join).
    Both streaming engines write through it, so they run the same ops."""

    def __init__(self, cfg: pdu.PDUConfig, bank, t_total: int, chunk: int, n_int: int,
                 observe: bool = True):
        dev = cfg.device
        n_chunks = -(-t_total // chunk)
        self.dt, self.bank, self.n_int, self.safemode = cfg.sample_dt, bank, n_int, cfg.safemode
        self.t_total, self.n_ctrl = t_total, -(-t_total // (chunk // n_int))
        self.campus_rack = torch.zeros(n_chunks * chunk, dtype=F32, device=dev)
        self.campus_grid = torch.zeros(n_chunks * chunk, dtype=F32, device=dev)
        self.soc_mean = torch.zeros(n_chunks * n_int, dtype=F32, device=dev)
        self.worst = torch.zeros((), dtype=F32, device=dev)
        self.health_trace = torch.zeros((n_chunks, 3), dtype=F32, device=dev)
        self.ess_frac = torch.ones(n_chunks * n_int, dtype=F32, device=dev)
        self.sm_trace = torch.zeros((n_chunks, 6), dtype=F32, device=dev)
        self.obs = _observers_init(bank, dev) if observe else None

    def add(self, c_idx: int, t0: int, ch: pdu.CampusChunk) -> None:
        n, m = ch.campus_rack.shape[0], ch.soc_mean.shape[0]
        i0 = c_idx * self.n_int
        self.campus_rack[t0 : t0 + n] = ch.campus_rack
        self.campus_grid[t0 : t0 + n] = ch.campus_grid
        self.soc_mean[i0 : i0 + m] = ch.soc_mean
        self.ess_frac[i0 : i0 + m] = ch.ess_online_frac
        self.worst = torch.maximum(self.worst, ch.max_qp_residual)
        self.health_trace[c_idx] = ch.health
        if self.safemode:  # (zeros otherwise, as allocated)
            self.sm_trace[c_idx] = ch.safemode
        if self.obs is not None:
            self.obs = _observers_update(self.obs, self.bank, ch.campus_rack, ch.campus_grid,
                                         self.dt)

    def result(self) -> _Stream:
        return _Stream(
            self.campus_rack[: self.t_total], self.campus_grid[: self.t_total],
            self.soc_mean[: self.n_ctrl], self.worst, self.health_trace,
            self.ess_frac[: self.n_ctrl], self.sm_trace, self.obs,
        )


def _finish_streaming(cfg, grid_spec, state, out: _Stream, bank) -> ConditioningResult:
    """Assemble the result from streaming state: the compliance reports
    come from the cross-chunk observers (exact ramp, spec lines)."""
    obs = out.obs
    return ConditioningResult(
        campus_rack=out.campus_rack,
        campus_grid=out.campus_grid,
        soc_mean=out.soc_mean,
        report_rack=compliance.report_from_observers(grid_spec, obs.ramp_rack, bank, obs.spec_rack),
        report_grid=compliance.report_from_observers(grid_spec, obs.ramp_grid, bank, obs.spec_grid),
        state=state,
        max_qp_residual=out.worst,
        health_trace=out.health_trace,
        health=hlt.report(_health_params(cfg), cfg.ess_params, state.health, cfg.sample_dt),
        ess_online_frac=out.ess_frac,
        safemode_trace=out.sm_trace,
        grid_spec=grid_spec,
        bank=bank,
        observers=obs,
    )


def _fold_chunks(obs, update, chunk: int, *traces):
    """``obs`` folded by ``update(obs, *pieces)`` over whole traces on the
    engines' chunk partition (``chunk`` samples, then the ragged tail), as
    the engines fold their observers chunk by chunk: the observers' float32
    accumulation depends on the partition."""
    for t0 in range(0, traces[0].shape[0], chunk):
        obs = update(obs, *(x[t0:t0 + chunk] for x in traces))
    return obs


def _map_state_racks(state: pdu.PDUState, fn) -> pdu.PDUState:
    """``state`` with ``fn(leaf, axis)`` applied to every per-rack leaf, in
    ``_tree_leaves`` order, ``axis`` the leaf's rack axis: the last for the
    QP iterates ``(2h | 3h, R)``, the first for the rest (``filter_state``
    is ``(R, 3)``).  The filter, a config constant, stays as it is."""
    return state._replace(**{
        f: _tree_map(lambda t, ax=(-1 if f == "qp_warm" else 0): fn(t, ax), getattr(state, f))
        for f in state._fields if f != "filter_obj"})


class _RackShard:
    """This rank's block ``[lo, hi)`` of a campus's ``n_racks`` racks along
    the mesh's rack axis (``sharding.rack_block``).  The rank conditions
    its block as a fleet of its own; ``join`` puts the whole campus back on
    every rank."""

    def __init__(self, mesh, n_racks: int):
        self.mesh, self.n_racks = mesh, int(n_racks)
        self.lo, self.hi = rules.rack_block(self.n_racks, mesh)

    def traces(self, tr: torch.Tensor) -> torch.Tensor:
        return rules.shard_racks(tr, self.mesh)

    def state(self, st: pdu.PDUState) -> pdu.PDUState:
        n = self.hi - self.lo
        return _map_state_racks(st, lambda t, ax: t.narrow(ax, self.lo, n).contiguous())

    def join(self, cfg, st: pdu.PDUState, out: _Stream, bank,
             chunk: int) -> tuple[pdu.PDUState, _Stream]:
        """The whole campus from every rank's block run, in one gather: the
        final states concatenated along each leaf's rack axis in rank order
        (bit for bit the one-rank state); the campus, SoC and mean-EFC
        means as the ranks' block means weighted by rack share, summed in
        rank order; maxima as maxima; the ESS online fraction and the
        safe-mode snapshot from exact integer counts, finished as the
        one-rank reductions finish them; the observers folded over the
        combined traces."""
        with _prof.span("gather") as sync:
            parts = rules.all_gather_tree((st._replace(filter_obj=None), out._replace(obs=None)),
                                          self.mesh, rules.RACK_AXIS)
            sync(parts[-1][1].campus_grid)
        states, outs = zip(*parts)
        blocks = iter(zip(*(_tree_leaves(s) for s in states)))  # a leaf's blocks, rank order
        whole = _map_state_racks(states[0], lambda t, ax: torch.cat(next(blocks), dim=ax))
        whole = whole._replace(filter_obj=st.filter_obj)
        sizes = [s.u_prev.shape[0] for s in states]
        w = [float(np.float32(n / self.n_racks)) for n in sizes]
        wsum = lambda xs: functools.reduce(torch.add, [wb * x for wb, x in zip(w, xs)])
        total = lambda xs: functools.reduce(torch.add, xs)
        count = lambda fracs: total([torch.round(f * n) for f, n in zip(fracs, sizes)])
        top = lambda xs: torch.amax(torch.stack(xs), dim=0)
        dev = outs[0].campus_rack.device
        on = count([o.ess_frac for o in outs])
        ess_frac = (torch.arange(self.n_racks, device=dev) < on[:, None]).to(F32).mean(dim=1)
        sm = [o.sm_trace for o in outs]
        inv_n = float(np.float32(1.0 / self.n_racks))  # as smode.chunk_snapshot
        sm_trace = torch.cat([count([s[:, :1] for s in sm]) * inv_n,
                              total([s[:, 1:5] for s in sm]), top([s[:, 5:] for s in sm])], 1)
        health = torch.cat([wsum([o.health_trace[:, :1] for o in outs]),
                            top([o.health_trace[:, 1:] for o in outs])], 1)
        rack, grid = wsum([o.campus_rack for o in outs]), wsum([o.campus_grid for o in outs])
        return whole, _Stream(
            campus_rack=rack, campus_grid=grid, soc_mean=wsum([o.soc_mean for o in outs]),
            worst=top([o.worst for o in outs]), health_trace=health, ess_frac=ess_frac,
            sm_trace=sm_trace, obs=_fold_chunks(
                _observers_init(bank, dev), lambda o, r, g: _observers_update(
                    o, bank, r, g, cfg.sample_dt), chunk, rack, grid))


def _condition_fleet_streaming_impl(
    cfg: pdu.PDUConfig,
    traces: torch.Tensor | Callable[[int, int], torch.Tensor],
    grid_spec: compliance.GridSpec,
    *,
    soc0: float = 0.5,
    qp_iters: int = 30,
    chunk_intervals: int = 16,
    total_samples: int | None = None,
    state: pdu.PDUState | None = None,
    ess_online=None,
    ess_weight=None,
    faults=None,
    fault_edge: int = 1,
    plan=None,
    mesh=None,
) -> ConditioningResult:
    """The host engine: campus conditioning in chunks of whole controller
    intervals with the PDU state (and the warm-started QP iterates) carried
    across chunks, so at equal ``qp_iters`` it computes what the one-shot
    engine computes.  ``traces`` is a (T, R) tensor or a chunk provider
    ``f(start, length) -> (length, R)`` with ``total_samples``.  ``state``
    resumes a previous stream at a controller-interval boundary (``soc0``
    is then ignored); the engine never writes into it.  With
    ``profiling.enable()`` it times ``render`` and ``solve`` per chunk and
    ``host-sync`` around the result.

    Degraded mode: ``ess_online`` is the availability of the whole stream,
    ``(n_ctrl_total, R)`` rows (sliced per chunk) or one ``(R,)`` mask;
    ``ess_weight`` the per-sample ``(T, R)`` hardware weight (sliced by
    sample).  ``faults`` (exclusive with both) is the stream's
    ``FaultSchedule``, handed to every chunk with its absolute start.

    ``mesh`` shards the racks over its ``"data"`` axis (module docstring):
    each rank takes its block of every chunk, of ``state`` (the whole
    campus's), of the masks and of the schedule's tables, and the blocks
    join at the end.  ``ess_online`` must then be a 0/1 mask: its online
    fraction combines as exact counts."""
    if ess_online is not None or ess_weight is not None:
        if not cfg.degraded_mode:
            raise ValueError(
                "ess_online/ess_weight require a degraded-mode config "
                "(make_pdu(..., degraded_mode=True))")
        if faults is not None:
            raise ValueError("faults is mutually exclusive with ess_online/ess_weight")
    if faults is not None and not cfg.degraded_mode:
        raise ValueError("faults requires a degraded-mode config (make_pdu(..., degraded_mode=True))")
    dev = cfg.device
    if ess_online is not None:
        ess_online = torch.as_tensor(ess_online, dtype=F32, device=dev)
    if ess_weight is not None:
        ess_weight = torch.as_tensor(ess_weight, dtype=F32, device=dev)
    k = max(int(round(float(cfg.controller.dt) / cfg.sample_dt)), 1)
    n_int = max(int(chunk_intervals), 1)
    chunk = n_int * k
    if callable(traces):
        if total_samples is None:
            raise ValueError("total_samples is required with a chunk provider")
        provider, t_total = traces, int(total_samples)
    else:
        provider, t_total = (lambda t0, n: traces[t0 : t0 + n]), traces.shape[0]
    shard = None
    if mesh is not None:
        r0 = provider(0, 1)[0]
        if state is None:  # the whole campus's: NaN racks seed from the fleet mean
            state = pdu.init_state(cfg, r0 if r0.ndim else r0[None], soc0=soc0)
        shard = _RackShard(mesh, state.u_prev.shape[0])
        if ess_online is not None and not bool(torch.all((ess_online == 0) | (ess_online == 1))):
            raise ValueError("rack sharding combines the ESS online fraction as exact counts: "
                             "ess_online must be a 0/1 mask")
        from repro_torch.power import faults as FLT

        state = shard.state(state)
        faults = None if faults is None else FLT.select_racks(faults, shard.lo, shard.hi)
        take = lambda x: None if x is None else x[..., shard.lo:shard.hi]
        ess_online, ess_weight = take(ess_online), take(ess_weight)
    elif state is None:
        state = pdu.init_state(cfg, provider(0, 1)[0], soc0=soc0)

    bank = _make_bank(grid_spec, cfg, t_total)
    acc = _CampusAccum(cfg, bank, t_total, chunk, n_int, observe=shard is None)
    for c_idx, t0 in enumerate(range(0, t_total, chunk)):
        # The trailing partial chunk runs at its natural length;
        # pdu.condition ZOH-pads its trailing partial interval internally.
        n = min(chunk, t_total - t0)
        with _prof.span("render") as sync:
            tr = sync(provider(t0, n).to(device=dev, dtype=F32))
        if tr.ndim == 1:  # unbatched trace: a 1-rack fleet
            tr = tr[:, None]
        if shard is not None:
            tr = shard.traces(tr)
        deg = {}
        if faults is not None:
            deg = dict(faults=faults, chunk_start=t0, fault_edge=fault_edge)
        elif cfg.degraded_mode:
            on = ess_online
            if on is not None and on.ndim >= 2:
                on = on[c_idx * n_int : c_idx * n_int + -(-n // k)]
            deg = dict(ess_online=on,
                       ess_weight=None if ess_weight is None else ess_weight[t0 : t0 + n])
        if shard is not None:
            deg["rack_span"] = (shard.lo, shard.n_racks)
        with _prof.span("solve") as sync:
            state, ch = pdu.condition_campus(cfg, state, tr, qp_iters=qp_iters, plan=plan, **deg)
            acc.add(c_idx, t0, ch)
            sync(acc.worst)
    out = acc.result()
    if shard is not None:
        state, out = shard.join(cfg, state, out, bank, chunk)
    with _prof.span("host-sync") as sync:
        res = _finish_streaming(cfg, grid_spec, state, out, bank)
        sync((res.campus_grid, res.report_grid))
    return res


def _condition_chunk(cfg, scen, st, t0, n, *, k, qp_iters, plan=None, consts=None, racks=None):
    """Render + condition one ``n``-sample chunk at absolute sample ``t0``.

    The per-chunk building block of the scanned engine (and so of every
    campus of a grid region).  An unbatched scenario is lifted
    to a 1-rack fleet.  With a fault schedule attached to the scenario and
    a degraded-mode config the schedule itself is handed to
    ``pdu.condition`` with the chunk's absolute start (the fast path):
    every rendered quantity is pure in the absolute sample index, so the
    result is chunk- and resume-invariant.  ``plan`` and ``consts``
    (``pdu.host_consts``) pass through to ``pdu.condition``.  ``racks =
    (lo, hi)`` conditions that block of the rendered chunk, with the
    schedule's rows of those racks and the wear sums' campus columns
    (``rack_span``, ``ref.block_sums``): a rank of a rack-sharded run.
    """
    from repro_torch.power import faults as FLT, scenario as SC

    faulty = cfg.degraded_mode and scen.faults is not None
    tr = SC.render(scen, t0, n)
    if tr.ndim == 1:  # unbatched scenario: lift to a 1-rack fleet
        tr = tr[:, None]
    sched = scen.faults if faulty else None
    span = None
    if racks is not None:
        span = (racks[0], tr.shape[1])
        tr = tr[:, racks[0]:racks[1]].contiguous()
        sched = None if sched is None else FLT.select_racks(sched, *racks)
    return pdu.condition_campus(
        cfg, st, tr, qp_iters=qp_iters,
        faults=sched,
        chunk_start=t0,
        fault_edge=scen.edge_width if faulty else 1,
        plan=plan, consts=consts, rack_span=span,
    )


def _scanned_run(cfg, scen, st, plan, consts, *, start, chunk, k, n_full, rem, qp_iters, bank,
                 racks=None):
    """The scanned engine's window from ``start`` (a 0-d int32 tensor on the
    device): every full chunk, then the ``rem``-sample ragged tail at its
    natural length (``pdu.condition`` ZOH-pads its trailing partial
    interval, as a one-shot call would, so the state, ``soc_mean`` and the
    QP residual never see pad intervals), the observer folds and the
    stacked campus aggregates.  On the card this is what the CUDA graph
    captures; on the CPU it runs as it is.  ``racks`` runs a rank's block
    (``_condition_chunk``), without the observers, which fold after the
    join."""
    acc = _CampusAccum(cfg, bank, n_full * chunk + rem, chunk, chunk // k,
                       observe=racks is None)
    for c_idx in range(n_full + (rem > 0)):
        t0 = c_idx * chunk
        st, ch = _condition_chunk(cfg, scen, st, start + t0, chunk if c_idx < n_full else rem,
                                  k=k, qp_iters=qp_iters, plan=plan, consts=consts, racks=racks)
        acc.add(c_idx, t0, ch)
    return st, acc.result()


# --------------------------------------------------- the scanned engine's cache


def _tree_spec(x):
    """A hashable description of ``x``'s structure: each tensor's shape,
    dtype and device, and every other leaf by value."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__qualname__,) + tuple(_tree_spec(v) for v in x)
    if isinstance(x, (tuple, list)):
        return (type(x).__name__,) + tuple(_tree_spec(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__qualname__,) + tuple(
            (f.name, _tree_spec(getattr(x, f.name))) for f in dataclasses.fields(x))
    return x


def _values_key(x) -> bytes:
    """The values of every tensor leaf of ``x``, read back in one copy."""
    leaves = _tree_leaves(x)
    if not leaves:
        return b""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in leaves])
    return flat.cpu().numpy().tobytes()


# The scanned engine's captured graphs, one per key, as the reference
# caches its jitted engine, the most recently used last.  A graph holds its
# memory pool while it stays here, so the cache keeps at most
# ``_ENGINE_CACHE_MAX``: the start sample is not in the key (a window's
# start lives on the card), but each scenario structure, noise seed or
# window length is, as each is static in the reference's jit.  An evicted
# graph's pool goes back to the allocator, which frees it under pressure.
_ENGINE_CACHE: collections.OrderedDict = collections.OrderedDict()
_ENGINE_CACHE_MAX = 4


def _cached_engine(key, build):
    engine = _ENGINE_CACHE.get(key)
    if engine is None:
        engine = _ENGINE_CACHE[key] = build()
        while len(_ENGINE_CACHE) > _ENGINE_CACHE_MAX:
            _ENGINE_CACHE.popitem(last=False)
    else:
        _ENGINE_CACHE.move_to_end(key)
    return engine


def _scanned_key(cfg, scenario, state, plan, geometry: dict) -> tuple:
    """What a scanned engine's graph bakes in: the config (with its
    values), the chunk geometry and the window's length (``geometry``), the
    scenario's structure (its non-tensor fields by value), the state's
    shapes and filter, and whether a plan is given.  Not the start."""
    return ("scanned", _tree_spec(cfg), _values_key(cfg), tuple(geometry.items()),
            _tree_spec(scenario), _tree_spec(state), _values_key(state.filter_obj),
            None if plan is None else _tree_spec(plan))


def _launch_counts() -> tuple:
    from repro_torch.kernels import admm_step, pdu_health

    return (pdu_health.pdu_health_sim.launches, tuple(pdu_health.pdu_health_sim.launches_by_mask),
            admm_step.admm_iterate.launches)


class _ScannedEngine:
    """One key of the scanned engine on the card: static buffers for the
    start sample (a 0-d int32 tensor), the scenario's tensor leaves, the
    ``PDUState`` (and a caller's controller plan), and the CUDA graph of
    ``_scanned_run`` over them.

    A call fills the start and copies its scenario, state and plan into the
    buffers, replays the graph and clones the outputs, so a later call
    cannot overwrite a returned result and the caller's state is never
    written.  The graph bakes in the config (kept alive here: the graph
    reads its tensors), the host scalars (``pdu.host_consts``), the chunk
    geometry and the scenario's structure; all of these are in the key.

    Capture: one eager warm-up on throwaway copies, on a side stream (it
    builds and loads the kernels, makes their ``cudaFuncSetAttribute``
    calls and creates the side stream's cuBLAS handle), of the first full
    chunk and of the ragged tail, then the capture on that stream.
    ``launches_at_capture`` holds the kernels' launches in the capture: the
    Python counters tick at capture, not on replay.  A capture that fails
    raises, naming the call that broke it; there is no eager fallback.
    """

    def __init__(self, cfg, scenario, state, plan, *, chunk, k, n_full, rem, qp_iters, bank,
                 racks=None):
        self.cfg = cfg
        self.own_plan = plan is None
        if plan is None:
            plan = ctrl.make_plan(cfg.controller, cfg.ess_params) if cfg.software_enabled else None
        else:
            plan = _tree_map(torch.clone, plan)
        self.plan = plan
        self.consts = pdu.host_consts(cfg, state.filter_obj)
        self.start = torch.zeros((), dtype=torch.int32, device=cfg.device)
        self.scenario = _tree_map(torch.clone, scenario)
        self.state = _tree_map(torch.clone, state)
        self.geometry = dict(chunk=chunk, k=k, n_full=n_full, rem=rem, qp_iters=qp_iters,
                             bank=bank, racks=racks)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept, to count its nodes
        self.out = None
        self.launches_at_capture = None
        self._capture()

    def _capture(self) -> None:
        dev = self.cfg.device
        g = self.geometry
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        warm = [(0, g["chunk"])] if g["n_full"] else []
        if g["rem"]:
            warm.append((g["n_full"] * g["chunk"], g["rem"]))
        with torch.cuda.stream(side):
            for t0, n in warm:
                _, ch = _condition_chunk(
                    self.cfg, self.scenario, _tree_map(torch.clone, self.state), self.start + t0,
                    n, k=g["k"], qp_iters=g["qp_iters"], plan=self.plan, consts=self.consts,
                    racks=g["racks"])
                _observers_update(_observers_init(g["bank"], dev), g["bank"], ch.campus_rack,
                                  ch.campus_grid, self.cfg.sample_dt)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _launch_counts()
        try:
            with torch.cuda.graph(self.graph, stream=side):
                self.out = _scanned_run(self.cfg, self.scenario, self.state, self.plan,
                                        self.consts, start=self.start, **g)
        except Exception as exc:
            ours = [f for f in traceback.extract_tb(exc.__traceback__) if "repro_torch" in f.filename]
            where = f"{Path(ours[-1].filename).name}:{ours[-1].lineno} ({ours[-1].line})" if ours \
                else "an unknown call"
            raise RuntimeError(
                f"the scanned engine's CUDA graph capture failed at {where}: {exc}") from exc
        after = _launch_counts()
        self.launches_at_capture = dict(
            pdu_health=after[0] - before[0],
            pdu_health_by_mask=[a - b for a, b in zip(after[1], before[1])],
            admm_step=after[2] - before[2])
        self.graph.instantiate()

    def __call__(self, scenario, state, plan, start: int):
        pairs = [(self.scenario, scenario), (self.state, state)]
        if not self.own_plan:
            pairs.append((self.plan, plan))
        with torch.no_grad():
            self.start.fill_(start)
            for static, given in pairs:
                for dst, src in zip(_tree_leaves(static), _tree_leaves(given)):
                    dst.copy_(src)
            self.graph.replay()
            return _tree_map(torch.clone, self.out)


def _condition_scenario_scanned_impl(
    cfg: pdu.PDUConfig,
    scenario,
    grid_spec: compliance.GridSpec,
    *,
    soc0: float = 0.5,
    qp_iters: int = 30,
    chunk_intervals: int = 16,
    state: pdu.PDUState | None = None,
    start_sample: int = 0,
    stop_sample: int | None = None,
    plan=None,
    mesh=None,
) -> ConditioningResult:
    """The scanned engine: render + condition a scenario window as one CUDA
    graph (``_ScannedEngine``), bit for bit the host engine's numbers.

    ``state`` + ``start_sample`` / ``stop_sample`` window the stream: pass
    a previous call's returned state and the absolute sample index to
    resume at (a multiple of the controller interval; any multiple of the
    chunk size qualifies); aggregates cover ``[start_sample, stop_sample)``
    of the *unmodified* scenario, so a split-and-resume run reproduces the
    one-call run.  The start is read on the card, so windows of one length
    share one graph.  A caller-supplied ``state`` is copied, never written,
    so the same checkpoint can seed several continuations.  ``plan``
    overrides the controller plan the engine factors once.  On the CPU the
    same ``_scanned_run`` runs eagerly on the caller's scenario and a copy
    of the state, with no graph and no cache.  ``mesh`` shards the racks
    over its ``"data"`` axis (module docstring): each rank's graph conditions its
    block of every rendered chunk, and the blocks join after the replay.
    """
    state_f, out, bank = _scanned_window(
        cfg, scenario, grid_spec, soc0=soc0, qp_iters=qp_iters, chunk_intervals=chunk_intervals,
        state=state, start_sample=start_sample, stop_sample=stop_sample, plan=plan, mesh=mesh)
    return _finish_streaming(cfg, grid_spec, state_f, out, bank)


def _scanned_window(cfg, scenario, grid_spec, *, soc0, qp_iters, chunk_intervals, state,
                    start_sample, stop_sample, plan=None, mesh=None):
    """``_condition_scenario_scanned_impl`` up to its result: the final
    state, the window's ``_Stream`` and the spectrum bank."""
    from repro_torch.power import scenario as SC

    _check_scenario_rate(scenario, cfg)
    _check_scenario_faults(scenario, cfg)
    k, chunk, start, stop, t_total, n_full, rem = _window_geometry(
        cfg, scenario.total_samples, chunk_intervals, start_sample, stop_sample)

    if state is None:
        r0 = SC.render(scenario, start, 1)[0]
        if r0.ndim == 0:
            r0 = r0[None]  # unbatched scenario: the engine lifts to 1 rack
        state = pdu.init_state(cfg, r0, soc0=soc0)
    shard = None if mesh is None else _RackShard(mesh, state.u_prev.shape[0])
    if shard is not None:
        state = shard.state(state)

    bank = _make_bank(grid_spec, cfg, t_total)
    geometry = dict(chunk=chunk, k=k, n_full=n_full, rem=rem, qp_iters=qp_iters, bank=bank,
                    racks=None if shard is None else (shard.lo, shard.hi))
    if cfg.device.type != "cuda":  # the CPU path
        if plan is None and cfg.software_enabled:
            plan = ctrl.make_plan(cfg.controller, cfg.ess_params)
        state_f, out = _scanned_run(
            cfg, scenario, _tree_map(torch.clone, state), plan,
            pdu.host_consts(cfg, state.filter_obj),
            start=torch.full((), start, dtype=torch.int32, device=cfg.device), **geometry)
    else:
        engine = _cached_engine(_scanned_key(cfg, scenario, state, plan, geometry),
                                lambda: _ScannedEngine(cfg, scenario, state, plan, **geometry))
        with _prof.span("replay") as sync:
            state_f, out = engine(scenario, state, plan, start)
            sync(out.campus_grid)
    if shard is not None:
        state_f, out = shard.join(cfg, state_f, out, bank, chunk)
    return state_f, out, bank


def _window_geometry(cfg, total_samples, chunk_intervals, start, stop, what="scenario"):
    """Validate the window ``[start, stop)`` of a ``total_samples`` stream
    and split it into chunks: ``(k, chunk, start, stop, t_total, n_full,
    rem)``, ``k`` samples a controller interval, ``n_full`` chunks of
    ``chunk`` samples and a remainder of ``rem``.  The scanned engine, the
    region engine and the service share it."""
    k = max(int(round(float(cfg.controller.dt) / cfg.sample_dt)), 1)
    chunk = max(int(chunk_intervals), 1) * k
    total = int(total_samples)
    start = int(start)
    stop = total if stop is None else int(stop)
    if not 0 <= stop <= total:
        raise ValueError(f"stop_sample {stop} outside the {what} ({total} samples)")
    if start < 0 or start % k:
        raise ValueError(
            f"start_sample {start} must be a non-negative multiple of the controller "
            f"interval ({k} samples) so the resumed state stays interval-aligned")
    t_total = stop - start
    if t_total <= 0:
        raise ValueError(f"start_sample {start} is past the {what} end (stop at {stop} samples)")
    n_full, rem = divmod(t_total, chunk)
    return k, chunk, start, stop, t_total, n_full, rem


def _check_scenario_rate(scenario, cfg: pdu.PDUConfig) -> None:
    if abs(1.0 / scenario.sample_hz - cfg.sample_dt) > 1e-9:
        raise ValueError(
            f"scenario sample rate {scenario.sample_hz} Hz != PDU sample_dt "
            f"{cfg.sample_dt} s; build the PDU with sample_dt=1/sample_hz"
        )


def _check_scenario_faults(scenario, cfg: pdu.PDUConfig) -> None:
    if scenario.faults is not None and not cfg.degraded_mode:
        raise ValueError(
            "the scenario has a fault schedule attached; conditioning it requires a "
            "degraded-mode config (make_pdu(..., degraded_mode=True)) so ESS trips are "
            "masked and sensor-dropout NaN samples are bridged"
        )


def _scenario_fault_data(cfg: pdu.PDUConfig, scenario) -> dict:
    """The streamed availability mask and hardware weight of a scenario's
    fault schedule, for the engines that take them as data: the same
    functions the fast path renders from the episode tables, so every
    engine gives the same numbers."""
    from repro_torch.power import faults as FLT

    if not (cfg.degraded_mode and scenario.faults is not None):
        return {}
    k = max(int(round(float(cfg.controller.dt) / cfg.sample_dt)), 1)
    n_ctrl = -(-scenario.total_samples // k)
    return {
        "ess_online": FLT.interval_online(scenario.faults, 0, n_ctrl, k),
        "ess_weight": FLT.ess_weight(scenario.faults, 0, scenario.total_samples,
                                     scenario.edge_width),
    }


@dataclasses.dataclass(frozen=True)
class StreamOptions:
    """Streaming window options for the ``condition`` facade.

    ``chunk_intervals`` sizes the streaming chunk (controller intervals per
    chunk); ``state`` resumes a previous stream (a prior result's
    ``.state``); ``start_sample`` / ``stop_sample`` window the scanned
    engine over ``[start, stop)`` of the unmodified scenario;
    ``total_samples`` is required (and only meaningful) for raw chunk
    providers.
    """

    chunk_intervals: int = 16
    state: object = None
    start_sample: int = 0
    stop_sample: int | None = None
    total_samples: int | None = None


def _as_stream_options(stream) -> StreamOptions:
    if stream is None:
        return StreamOptions()
    if isinstance(stream, StreamOptions):
        return stream
    if isinstance(stream, dict):
        return StreamOptions(**stream)
    raise TypeError(f"stream must be a StreamOptions, dict or None, got {type(stream)!r}")


def _reject_stream_options(so: StreamOptions, engine: str, *fields: str) -> None:
    defaults = StreamOptions()
    for f in fields:
        if getattr(so, f) != getattr(defaults, f):
            raise ValueError(f"stream option {f!r} is not supported by the {engine!r} engine")


def condition(
    target,
    cfg: pdu.PDUConfig,
    grid_spec: compliance.GridSpec | None = None,
    *,
    engine: str = "scanned",
    mesh=None,
    stream: StreamOptions | dict | None = None,
    device="cuda",
    **kwargs,
) -> ConditioningResult:
    """THE conditioning entry point: one facade over the engines.

    ``target`` is a ``power.scenario.Scenario`` (rendered chunk by chunk
    on the device), a ``core.grid.GridRegion`` (N campuses at a point of
    interconnection, on the scanned engine only; ``stream.state`` is then
    the tuple of per-campus states), a materialized ``(T, R)`` tensor, or
    a chunk provider ``f(start, length) -> (length, R)`` (with
    ``stream.total_samples``).
    ``engine`` is ``"scanned"`` (default; scenarios and regions), ``"host"`` or
    ``"oneshot"`` (see the module docstring).  ``mesh`` (a ``DeviceMesh``;
    every rank of its world makes the same call) shards a campus's racks
    over its ``"data"`` axis on the scanned and host engines, or runs a grid
    region's campuses in parallel over its ``"campus"`` axis
    (``grid.condition_region_sharded``); its device type must be the
    config's.  ``stream`` bundles the windowing and resume options
    (``StreamOptions``).  ``device`` is where
    every tensor of the run lives; it defaults to ``"cuda"`` (raising
    without a card) and must be the config's device (``make_pdu(device=
    ...)``).  Remaining keywords pass through to the engine: ``soc0``
    and ``qp_iters`` to every engine; ``plan`` to every engine but the
    region's (which, as the reference's, has none); ``use_plan`` to the
    one-shot engine only (the scanned and host engines refuse it, as the
    reference's do); under a degraded-mode config ``ess_online`` /
    ``ess_weight`` to the host and one-shot engines.
    """
    dev = resolve_device(device)
    if dev != cfg.device:
        raise ValueError(f"device {dev} does not match the config's device {cfg.device}")
    if mesh is not None:
        rules.check_mesh(mesh, device_type=dev.type)
        if engine == "oneshot":
            raise ValueError("the one-shot engine runs in one process; rack sharding (mesh=) "
                             "runs on the 'scanned' and 'host' engines")
    spec = compliance.GridSpec.create(device=dev) if grid_spec is None else grid_spec
    so = _as_stream_options(stream)

    if hasattr(target, "campuses"):  # a grid region (duck-typed: grid imports us)
        from repro_torch.core import grid as _grid

        if engine != "scanned":
            raise ValueError(f"grid regions run the scanned engine only (got {engine!r})")
        _reject_stream_options(so, "grid-region", "total_samples")
        return _grid.condition_region(
            cfg, target, spec, mesh=mesh, chunk_intervals=so.chunk_intervals, states=so.state,
            start_sample=so.start_sample, stop_sample=so.stop_sample, **kwargs,
        )

    is_scenario = hasattr(target, "total_samples") and not callable(target)
    if is_scenario:
        from repro_torch.power import scenario as SC

        if engine == "scanned":
            _reject_stream_options(so, "scanned", "total_samples")
            return _condition_scenario_scanned_impl(
                cfg, target, spec, chunk_intervals=so.chunk_intervals, state=so.state,
                start_sample=so.start_sample, stop_sample=so.stop_sample, mesh=mesh, **kwargs,
            )
        if engine == "host":
            _reject_stream_options(so, "host", "start_sample", "stop_sample", "total_samples")
            _check_scenario_rate(target, cfg)
            _check_scenario_faults(target, cfg)
            faulty = cfg.degraded_mode and target.faults is not None
            if faulty and ("ess_online" in kwargs or "ess_weight" in kwargs):
                # Caller overrides win; the missing half is derived the
                # streamed way, so overriding one does not change the other.
                for key, val in _scenario_fault_data(cfg, target).items():
                    if kwargs.get(key) is None:
                        kwargs[key] = val
                faulty = False
            if faulty:
                kwargs.update(faults=target.faults, fault_edge=target.edge_width)
            return _condition_fleet_streaming_impl(
                cfg, SC.chunk_provider(target), spec,
                total_samples=target.total_samples,
                chunk_intervals=so.chunk_intervals, state=so.state, mesh=mesh, **kwargs,
            )
        if engine == "oneshot":
            _reject_stream_options(
                so, "oneshot", "state", "start_sample", "stop_sample", "total_samples")
            _check_scenario_rate(target, cfg)
            _check_scenario_faults(target, cfg)
            for key, val in _scenario_fault_data(cfg, target).items():
                kwargs.setdefault(key, val)
            tr = SC.render(target, 0, target.total_samples)
            if tr.ndim == 1:
                tr = tr[:, None]
            return _condition_fleet_impl(cfg, tr, spec, **kwargs)
        raise ValueError(f"unknown engine {engine!r} (expected 'scanned', 'host' or 'oneshot')")

    # Raw (T, R) tensor or chunk provider.
    if engine == "oneshot":
        if callable(target):
            raise ValueError(
                "engine='oneshot' needs a materialized (T, R) tensor "
                "(chunk providers stream via engine='host')")
        _reject_stream_options(
            so, "oneshot", "state", "start_sample", "stop_sample", "total_samples")
        return _condition_fleet_impl(cfg, target, spec, **kwargs)
    if engine == "host":
        _reject_stream_options(so, "host", "start_sample", "stop_sample")
        return _condition_fleet_streaming_impl(
            cfg, target, spec, chunk_intervals=so.chunk_intervals, state=so.state,
            total_samples=so.total_samples, mesh=mesh, **kwargs,
        )
    if engine == "scanned":
        raise ValueError(
            "engine='scanned' renders a declarative Scenario on the device; raw trace "
            "tensors and chunk providers stream via engine='host' (or engine='oneshot' "
            "for materialized tensors)")
    raise ValueError(f"unknown engine {engine!r} (expected 'scanned', 'host' or 'oneshot')")


def make_condition_step(cfg: pdu.PDUConfig, *, qp_iters: int = 30) -> Callable:
    """A ``(state, trace) -> (grid, state, telemetry)`` step through
    ``pdu.condition``: the single-chunk building block of the streaming
    engines, for callers that condition a stream of chunks
    (``power.integration.PowerSim``).  The reference caches a jitted step
    per config; here nothing is compiled, and what the step keeps is the
    controller plan, factored once instead of on every chunk."""
    plan = ctrl.make_plan(cfg.controller, cfg.ess_params) if cfg.software_enabled else None

    def step(state: pdu.PDUState, trace: torch.Tensor):
        return pdu.condition(cfg, state, trace, qp_iters=qp_iters, plan=plan)

    return step


# ---------------------------------------------------- deprecated entry points
# The reference's thin wrappers over ``condition``, kept for its call sites
# (its safe-mode bench enters through ``condition_scenario_streaming``).
# Each runs on the config's device.  Prefer the facade in new code.


def condition_fleet(cfg: pdu.PDUConfig, traces: torch.Tensor, grid_spec, *, soc0: float = 0.5,
                    qp_iters: int = 60, use_plan: bool = True, ess_online=None,
                    ess_weight=None) -> ConditioningResult:
    """One-shot conditioning of a (T, R) trace: ``condition(traces, cfg,
    spec, engine="oneshot")``."""
    return condition(traces, cfg, grid_spec, engine="oneshot", device=cfg.device, soc0=soc0,
                     qp_iters=qp_iters, use_plan=use_plan, ess_online=ess_online,
                     ess_weight=ess_weight)


def condition_fleet_streaming(cfg: pdu.PDUConfig, traces, grid_spec, *, soc0: float = 0.5,
                              qp_iters: int = 30, chunk_intervals: int = 16,
                              total_samples: int | None = None, mesh=None, state=None,
                              ess_online=None, ess_weight=None) -> ConditioningResult:
    """The host engine over a (T, R) trace or a chunk provider:
    ``condition(traces, cfg, spec, engine="host", stream=...)``."""
    return condition(traces, cfg, grid_spec, engine="host", mesh=mesh, device=cfg.device,
                     stream=StreamOptions(chunk_intervals=chunk_intervals, state=state,
                                          total_samples=total_samples),
                     soc0=soc0, qp_iters=qp_iters, ess_online=ess_online,
                     ess_weight=ess_weight)


def condition_scenario_scanned(cfg: pdu.PDUConfig, scenario, grid_spec, *, soc0: float = 0.5,
                               qp_iters: int = 30, chunk_intervals: int = 16, mesh=None,
                               state=None, start_sample: int = 0,
                               stop_sample: int | None = None) -> ConditioningResult:
    """A scenario through the scanned engine: ``condition(scenario, cfg,
    spec)``."""
    return condition(scenario, cfg, grid_spec, engine="scanned", mesh=mesh, device=cfg.device,
                     stream=StreamOptions(chunk_intervals=chunk_intervals, state=state,
                                          start_sample=start_sample, stop_sample=stop_sample),
                     soc0=soc0, qp_iters=qp_iters)


def condition_scenario_streaming(cfg: pdu.PDUConfig, scenario, grid_spec, *,
                                 engine: str = "scanned", **kwargs) -> ConditioningResult:
    """A scenario through the scanned or host engine: ``condition(scenario,
    cfg, spec, engine=engine, stream=...)``, the stream options taken from
    ``kwargs``."""
    if engine not in ("scanned", "host"):
        raise ValueError(f"unknown engine {engine!r} (expected 'scanned' or 'host')")
    stream = StreamOptions(
        chunk_intervals=kwargs.pop("chunk_intervals", 16),
        state=kwargs.pop("state", None),
        start_sample=kwargs.pop("start_sample", 0),
        stop_sample=kwargs.pop("stop_sample", None),
    )
    return condition(scenario, cfg, grid_spec, engine=engine, mesh=kwargs.pop("mesh", None),
                     device=cfg.device, stream=stream, **kwargs)
