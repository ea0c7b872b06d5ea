"""Fleet-scale conditioning engines and the ``condition`` facade.

Port of ``repro.core.fleet`` for ``Scenario`` and ``(T, R)`` tensor
targets.  Every rack gets its own PDU state; the rack axis rides in the
trailing dimension of every tensor and of the kernels' launches.

Engines:

  * ``"host"`` (the port's default): walk the trace in chunks of
    ``chunk_intervals`` controller intervals — render each chunk on the
    card, condition it (``pdu.condition_campus``), fold the streaming
    compliance observers — so live memory stays O(chunk x R); the stream
    can resume from a result's ``state``.
  * ``"oneshot"``: materialize the whole ``(T, R)`` trace and grid
    waveform and check compliance on the whole campus means.

Under a degraded-mode config a ``Scenario`` carrying a fault schedule runs
degraded: the host engine hands the schedule to ``pdu.condition`` (the
fast path), the one-shot engine the streamed mask and weight derived from
it, and both return ``ess_online_frac``.

The reference defaults to its ``"scanned"`` engine, one ``lax.scan`` jit
over the chunk loop.  Its counterpart here, the chunk loop captured in a
CUDA graph, is a later item of ROADMAP.md (queue 1 item 3), so
``engine="scanned"`` raises and the facade defaults to ``"host"``.
Multi-GPU rack sharding (``mesh=``) comes with ROADMAP.md queue 1 item 9.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import compliance, controller as ctrl, health as hlt, pdu
from repro_torch.utils.devices import resolve_device

F32 = torch.float32


class ConditioningResult(NamedTuple):
    """The one result type every conditioning engine returns; fields an
    engine does not track are ``None``.  The reference's safe-mode and
    grid-region fields come with those slices."""

    campus_rack: torch.Tensor = None  # (T,) mean per-unit unconditioned load
    campus_grid: torch.Tensor = None  # (T,) mean per-unit conditioned load
    report_rack: compliance.ComplianceReport = None
    report_grid: compliance.ComplianceReport = None
    health: hlt.HealthReport = None  # per-rack wear report
    grid_traces: torch.Tensor = None  # (T, R) conditioned per-rack (oneshot)
    soc_mean: torch.Tensor = None  # (n_ctrl,) fleet-mean SoC per interval
    state: pdu.PDUState = None  # final PDU state (the stream can resume)
    max_qp_residual: torch.Tensor = None  # worst QP primal residual seen
    health_trace: torch.Tensor = None  # (n_chunks, 3) [mean EFC, max fade, max DoD]
    # (n_ctrl,) fraction of ESS units online per interval (ones unless the
    # cfg runs degraded_mode).
    ess_online_frac: torch.Tensor = None
    grid_spec: compliance.GridSpec = None
    bank: compliance.SpectrumBank = None
    observers: "_Observers" = None

    def report(self, which: str = "grid") -> compliance.ComplianceReport:
        """Compliance report of ``"rack"`` or ``"grid"``, re-derived from
        the streaming observers when the engine carried them."""
        stored = {"rack": self.report_rack, "grid": self.report_grid}
        if which not in stored:
            raise ValueError(f"which={which!r} (expected 'rack' or 'grid')")
        if self.observers is None or self.bank is None or self.grid_spec is None:
            return stored[which]
        return compliance.report_from_observers(
            self.grid_spec,
            getattr(self.observers, f"ramp_{which}"),
            self.bank,
            getattr(self.observers, f"spec_{which}"),
        )


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
    compliance on the whole campus means.  ``ess_online``/``ess_weight``
    (degraded mode) as in ``pdu.condition``."""
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
    obs: _Observers, bank: compliance.SpectrumBank, ch: pdu.CampusChunk, dt: float
) -> _Observers:
    return _Observers(
        ramp_rack=compliance.ramp_observer_update(obs.ramp_rack, ch.campus_rack, dt),
        ramp_grid=compliance.ramp_observer_update(obs.ramp_grid, ch.campus_grid, dt),
        spec_rack=compliance.spectrum_observer_update(bank, obs.spec_rack, ch.campus_rack),
        spec_grid=compliance.spectrum_observer_update(bank, obs.spec_grid, ch.campus_grid),
    )


def _make_bank(grid_spec: compliance.GridSpec, cfg: pdu.PDUConfig, n_total: int):
    return compliance.make_bank(n_total, cfg.sample_dt, float(grid_spec.f_c))


def _finish_streaming(
    cfg, grid_spec, state, campus_rack, campus_grid, soc_mean, worst, bank, obs, health_trace,
    ess_frac,
) -> ConditioningResult:
    """Assemble the result from streaming state: the compliance reports
    come from the cross-chunk observers (exact ramp, spec lines)."""
    return ConditioningResult(
        campus_rack=campus_rack,
        campus_grid=campus_grid,
        soc_mean=soc_mean,
        report_rack=compliance.report_from_observers(grid_spec, obs.ramp_rack, bank, obs.spec_rack),
        report_grid=compliance.report_from_observers(grid_spec, obs.ramp_grid, bank, obs.spec_grid),
        state=state,
        max_qp_residual=worst,
        health_trace=health_trace,
        health=hlt.report(_health_params(cfg), cfg.ess_params, state.health, cfg.sample_dt),
        ess_online_frac=ess_frac,
        grid_spec=grid_spec,
        bank=bank,
        observers=obs,
    )


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
) -> ConditioningResult:
    """The host engine: campus conditioning in chunks of whole controller
    intervals with the PDU state (and the warm-started QP iterates) carried
    across chunks, so at equal ``qp_iters`` it computes what the one-shot
    engine computes.  ``traces`` is a (T, R) tensor or a chunk provider
    ``f(start, length) -> (length, R)`` with ``total_samples``.  ``state``
    resumes a previous stream at a controller-interval boundary (``soc0``
    is then ignored); the engine never writes into it.

    Degraded mode: ``ess_online`` is the availability of the whole stream,
    ``(n_ctrl_total, R)`` rows (sliced per chunk) or one ``(R,)`` mask;
    ``ess_weight`` the per-sample ``(T, R)`` hardware weight (sliced by
    sample).  ``faults`` (exclusive with both) is the stream's
    ``FaultSchedule``, handed to every chunk with its absolute start."""
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
    n_chunks = -(-t_total // chunk)
    n_ctrl = -(-t_total // k)
    if state is None:
        state = pdu.init_state(cfg, provider(0, 1)[0], soc0=soc0)

    bank = _make_bank(grid_spec, cfg, t_total)
    campus_rack = torch.zeros(n_chunks * chunk, dtype=F32, device=dev)
    campus_grid = torch.zeros(n_chunks * chunk, dtype=F32, device=dev)
    soc_mean = torch.zeros(n_chunks * n_int, dtype=F32, device=dev)
    worst = torch.zeros((), dtype=F32, device=dev)
    health_trace = torch.zeros((n_chunks, 3), dtype=F32, device=dev)
    ess_frac = torch.ones(n_chunks * n_int, dtype=F32, device=dev)
    obs = _observers_init(bank, dev)
    for c_idx, t0 in enumerate(range(0, t_total, chunk)):
        # The trailing partial chunk runs at its natural length;
        # pdu.condition ZOH-pads its trailing partial interval internally.
        n = min(chunk, t_total - t0)
        tr = provider(t0, n).to(device=dev, dtype=F32)
        if tr.ndim == 1:  # unbatched trace: a 1-rack fleet
            tr = tr[:, None]
        deg = {}
        if faults is not None:
            deg = dict(faults=faults, chunk_start=t0, fault_edge=fault_edge)
        elif cfg.degraded_mode:
            on = ess_online
            if on is not None and on.ndim >= 2:
                on = on[c_idx * n_int : c_idx * n_int + -(-n // k)]
            deg = dict(ess_online=on,
                       ess_weight=None if ess_weight is None else ess_weight[t0 : t0 + n])
        state, ch = pdu.condition_campus(cfg, state, tr, qp_iters=qp_iters, plan=plan, **deg)
        campus_rack[t0 : t0 + n] = ch.campus_rack
        campus_grid[t0 : t0 + n] = ch.campus_grid
        m = ch.soc_mean.shape[0]
        soc_mean[c_idx * n_int : c_idx * n_int + m] = ch.soc_mean
        ess_frac[c_idx * n_int : c_idx * n_int + m] = ch.ess_online_frac
        worst = torch.maximum(worst, ch.max_qp_residual)
        health_trace[c_idx] = ch.health
        obs = _observers_update(obs, bank, ch, cfg.sample_dt)
    return _finish_streaming(
        cfg, grid_spec, state, campus_rack[:t_total], campus_grid[:t_total],
        soc_mean[:n_ctrl], worst, bank, obs, health_trace, ess_frac[:n_ctrl],
    )


def _check_scenario_rate(scenario, cfg: pdu.PDUConfig) -> None:
    if abs(1.0 / scenario.sample_hz - cfg.sample_dt) > 1e-9:
        raise ValueError(
            f"scenario sample rate {scenario.sample_hz} Hz != PDU sample_dt "
            f"{cfg.sample_dt} s; build the PDU with sample_dt=1/sample_hz"
        )
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
    """Streaming window options for the ``condition`` facade:
    ``chunk_intervals`` (controller intervals per chunk), ``state`` (resume
    a previous stream; host engine only) and ``total_samples`` (raw chunk
    providers only)."""

    chunk_intervals: int = 16
    state: object = None
    total_samples: int | None = None


def _as_stream_options(stream) -> StreamOptions:
    if stream is None:
        return StreamOptions()
    if isinstance(stream, StreamOptions):
        return stream
    if isinstance(stream, dict):
        return StreamOptions(**stream)
    raise TypeError(f"stream must be a StreamOptions, dict or None, got {type(stream)!r}")


def condition(
    target,
    cfg: pdu.PDUConfig,
    grid_spec: compliance.GridSpec | None = None,
    *,
    engine: str = "host",
    mesh=None,
    stream: StreamOptions | dict | None = None,
    device="cuda",
    **kwargs,
) -> ConditioningResult:
    """THE conditioning entry point: one facade over the engines.

    ``target`` is a ``power.scenario.Scenario`` (rendered chunk by chunk
    on the device), a materialized ``(T, R)`` tensor, or a chunk provider
    ``f(start, length) -> (length, R)`` (with ``stream.total_samples``).
    ``engine`` is ``"host"`` (default, see the module docstring) or
    ``"oneshot"``.  ``device`` is where every tensor of the run lives; it
    defaults to ``"cuda"`` (raising without a card) and must be the
    config's device (``make_pdu(device=...)``).  Remaining keywords
    (``soc0``, ``qp_iters``, ``use_plan``, ``plan``, and under a
    degraded-mode config ``ess_online``/``ess_weight``) pass through.
    """
    dev = resolve_device(device)
    if dev != cfg.device:
        raise ValueError(f"device {dev} does not match the config's device {cfg.device}")
    if mesh is not None:
        raise NotImplementedError(
            "multi-GPU rack sharding (mesh=) is not ported yet (ROADMAP.md queue 1 item 9)"
        )
    if hasattr(target, "campuses"):
        raise NotImplementedError("grid regions are not ported yet (ROADMAP.md queue 1 item 5)")
    if engine == "scanned":
        raise NotImplementedError(
            "engine='scanned' (the chunk loop captured in a CUDA graph) is not "
            "ported yet (ROADMAP.md queue 1 item 3); use engine='host'"
        )
    spec = compliance.GridSpec.create(device=dev) if grid_spec is None else grid_spec
    so = _as_stream_options(stream)
    if engine == "oneshot" and so.state is not None:
        raise ValueError("stream state resumes the 'host' engine only")

    is_scenario = hasattr(target, "total_samples") and not callable(target)
    if is_scenario:
        from repro_torch.power import scenario as SC

        _check_scenario_rate(target, cfg)
        if so.total_samples is not None:
            raise ValueError("stream total_samples is for chunk providers; a Scenario has its own")
        if engine == "host":
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
                chunk_intervals=so.chunk_intervals, state=so.state, **kwargs,
            )
        if engine == "oneshot":
            for key, val in _scenario_fault_data(cfg, target).items():
                kwargs.setdefault(key, val)
            tr = SC.render(target, 0, target.total_samples)
            if tr.ndim == 1:
                tr = tr[:, None]
            return _condition_fleet_impl(cfg, tr, spec, **kwargs)
        raise ValueError(f"unknown engine {engine!r} (expected 'host' or 'oneshot')")

    if engine == "oneshot":
        if callable(target):
            raise ValueError(
                "engine='oneshot' needs a materialized (T, R) tensor "
                "(chunk providers stream via engine='host')")
        return _condition_fleet_impl(cfg, target, spec, **kwargs)
    if engine == "host":
        return _condition_fleet_streaming_impl(
            cfg, target, spec, chunk_intervals=so.chunk_intervals, state=so.state,
            total_samples=so.total_samples, **kwargs,
        )
    raise ValueError(f"unknown engine {engine!r} (expected 'host' or 'oneshot')")


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
