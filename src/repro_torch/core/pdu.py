"""The composed EasyRider PDU (paper §4-§6): filter + ESS + controller.

Port of ``repro.core.pdu`` with degraded and safe mode.  Signal chain
(per-unit, powers as fractions of rated rack power):

    rack power --(ESS ramp control, Eq. 2)--> node power g
               --(passive LC + damping)-----> grid power

The software controller runs every ``cfg.controller.dt`` (5 s) and issues
milliamp-scale corrective currents that steer the battery SoC toward the
outer-loop target.  ``condition`` walks the trace one controller interval
at a time: one ``pdu_health`` kernel launch simulates the interval's
hardware path (with the command slew and, when tracked, the wear fold),
then one batched ADMM solve (the ``admm_step`` kernel) produces the next
command.  JAX scanned this loop with ``lax.scan``; here it is a Python
loop of launches.

Degraded mode (``make_pdu(degraded_mode=True)``) honours ESS availability
(offline units run in LC passthrough with zeroed commands), bridges NaN
sensor dropouts with a last-good-sample hold and forces a rack that is
dark for a whole interval into passthrough; ``condition`` takes the
availability as streamed arrays (``ess_online``, ``ess_weight``) or, the
fast path, as the fault schedule itself (``faults``), whose per-sample ESS
weight the ``pdu_health`` kernel renders from the episode tables.
``use_plan=False`` swaps the controller step for the reference's per-step
oracle (the QP built, factored and solved cold for every rack each
interval in ``torch.linalg``; no ``admm_step`` launch).  Safe mode
(``make_pdu(safemode=True)``) supervises the conditioner's own failures
with ``core.safemode``: each interval starts with a sanitizer that
quarantines racks whose carried state went non-finite, and a watchdog
after the solve trips racks whose QP diverged (see ``condition``).
``PDUState`` keeps the reference's field names.

``condition`` runs inside the scanned engine's CUDA graph
(``fleet.condition``'s default): given its ``plan`` and its host scalars
(``host_consts``), it reads nothing back from the card and copies nothing
from host memory, and every choice it makes depends on shapes and host
values only.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import compliance, controller as ctrl, ess, filters, \
    health as hlt, safemode as smode, sizing
from repro_torch.kernels import ops
from repro_torch.power import faults as flt
from repro_torch.utils.devices import resolve_device
from repro_torch.utils.structures import Struct

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class PDUConfig(Struct):
    filter_params: filters.LCFilterParams  # per-unit
    ess_params: ess.ESSParams
    controller: ctrl.ControllerConfig
    health: hlt.HealthParams = None  # aging model (used when track_health)
    safemode_params: smode.SafeModeConfig = None  # watchdog knobs (when safemode)
    sample_dt: float = 1e-3  # trace sample period [s]
    software_enabled: bool = True
    # Fold per-sample battery wear telemetry into the conditioning loop
    # (pure observation: grid/SoC outputs are unchanged).
    track_health: bool = False
    # Honour ESS availability, bridge NaN sensor dropouts and trip
    # measurement-blind racks into passthrough (see ``condition``).
    degraded_mode: bool = False
    # Supervise the conditioner's own failures (``core.safemode``); off, the
    # loop runs exactly the unsupervised ops.
    safemode: bool = False

    @property
    def device(self) -> torch.device:
        return self.ess_params.beta.device


def per_unit_filter(
    s: sizing.SizingResult, rack: sizing.RackRating, *, device="cuda"
) -> filters.LCFilterParams:
    """Convert physical component values to the per-unit system."""
    z = rack.v_dc**2 / rack.p_rated_w
    return filters.LCFilterParams.create(
        l_f=s.l_f / z, c_f=s.c_f * z, r_da=s.r_da / z, l_da=s.l_da * (1.0 / z),
        device=device,
    )


def make_pdu(
    rack: sizing.RackRating | None = None,
    grid: compliance.GridSpec | None = None,
    *,
    sample_dt: float = 1e-3,
    f_f_hz: float = 4.0,
    soc_window: tuple[float, float] = (0.1, 0.9),
    capacity_margin: float = 4.0,
    ramp_margin: float = 1.6,
    software_enabled: bool = True,
    controller_cfg: ctrl.ControllerConfig | None = None,
    health_params: hlt.HealthParams | None = None,
    track_health: bool = False,
    degraded_mode: bool = False,
    safemode: bool = False,
    safemode_params: smode.SafeModeConfig | None = None,
    device="cuda",
) -> PDUConfig:
    """Size and assemble an EasyRider PDU for a rack + grid spec (see
    ``repro.core.pdu.make_pdu``: Appendix A.1 Eq. 8 capacity with
    ``capacity_margin``, the ESS designed to ``beta / ramp_margin``).
    The sizing runs in float64 on the host; the config's tensors land on
    ``device``.  ``safemode`` takes ``safemode_params`` or the default
    ``SafeModeConfig``."""
    dev = resolve_device(device)
    rack = rack or sizing.prototype_rack()
    grid = grid or compliance.GridSpec.create(device=dev)
    beta = float(grid.beta) / ramp_margin
    gamma = soc_window[1] - soc_window[0]
    s = sizing.size_system(rack, beta=beta, f_f_hz=f_f_hz, gamma=gamma)
    q_max_seconds = capacity_margin * s.battery_energy_j / rack.p_rated_w
    ess_params = ess.ESSParams.create(
        beta=beta,
        q_max_seconds=q_max_seconds,
        p_max=max(rack.epsilon * 1.25, 1.0),
        soc_safe_min=soc_window[0],
        soc_safe_max=soc_window[1],
        device=dev,
    )
    return PDUConfig(
        filter_params=per_unit_filter(s, rack, device=dev),
        ess_params=ess_params,
        controller=controller_cfg or ctrl.ControllerConfig.create(device=dev),
        health=health_params or hlt.HealthParams.create(device=dev),
        safemode_params=(safemode_params or smode.SafeModeConfig.create(device=dev))
        if safemode else None,
        sample_dt=sample_dt,
        software_enabled=software_enabled,
        track_health=track_health,
        degraded_mode=degraded_mode,
        safemode=safemode,
    )


class PDUState(NamedTuple):
    filter_state: torch.Tensor  # (..., 3)
    filter_obj: filters.DiscreteFilter
    ess_state: ess.ESSState
    u_prev: torch.Tensor  # last normalized controller command
    cmd_applied: torch.Tensor  # corrective power applied at the last sample
    cmd_target: torch.Tensor  # corrective power to slew toward this interval
    soc_ema: torch.Tensor  # BMS measurement filter (slow SoC estimate)
    qp_warm: ctrl.QPWarmState  # ADMM iterates carried across intervals/chunks
    health: hlt.HealthState  # battery wear telemetry (zeros unless tracked)
    # Degraded-mode state: the operator's ESS availability override (1 =
    # available) and the last finite sample per rack (seeds the sensor
    # bridge).  Then the safe-mode supervisor (all NORMAL unless the config
    # supervises).  Every state carries them, so its structure does not
    # depend on the config.
    ess_online: torch.Tensor = None
    last_good: torch.Tensor = None
    safemode: smode.SafeModeState = None


def init_state(cfg: PDUConfig, rack_power0: torch.Tensor, soc0: float = 0.5) -> PDUState:
    """Steady-state initialization at a constant starting power, on the
    config's device.  NaN entries seed from the fleet's finite mean (0.5 if
    none), as in the reference."""
    dev = cfg.device
    filt = filters.make_discrete_filter(cfg.filter_params, cfg.sample_dt)
    r0 = torch.as_tensor(rack_power0, dtype=F32, device=dev)
    finite = torch.isfinite(r0)
    fill = torch.nan_to_num(torch.nanmean(r0), nan=0.5)
    r0 = torch.where(finite, r0, fill)
    u0 = torch.stack([torch.ones_like(r0), r0], dim=-1)  # [v_in=1, i_load=r0]
    x0 = filters.steady_state(filt, u0)
    soc = torch.full_like(r0, soc0)
    return PDUState(
        filter_state=x0,
        filter_obj=filt,
        ess_state=ess.ESSState(g_filter=r0, soc=soc),
        u_prev=torch.zeros_like(r0),
        cmd_applied=torch.zeros_like(r0),
        cmd_target=torch.zeros_like(r0),
        soc_ema=torch.full_like(r0, soc0),
        qp_warm=ctrl.init_warm(cfg.controller.horizon, tuple(r0.shape), device=dev),
        health=hlt.init_state(torch.full_like(r0, soc0)),
        ess_online=torch.ones_like(r0),
        last_good=r0.clone(),
        safemode=smode.init_state(tuple(r0.shape), device=dev),
    )


class Telemetry(NamedTuple):
    soc: torch.Tensor  # (n_ctrl, ...) SoC at each control interval
    command: torch.Tensor  # corrective power commanded per interval
    target: torch.Tensor  # outer-loop SoC target per interval
    qp_residual: torch.Tensor  # QP primal residual per interval (0 if sw off)
    rack_mean: torch.Tensor = None  # (T,) campus mean of the (bridged) input trace
    grid_mean: torch.Tensor = None  # (T,) campus mean of the grid trace
    ess_online: torch.Tensor = None  # (n_ctrl, ...) applied availability (degraded mode)
    # (n_ctrl, ...) int32 supervisor mode after the watchdog (safe mode).
    safemode_mode: torch.Tensor = None


def bridge_sensors(last_good: torch.Tensor, rack_power: torch.Tensor):
    """Replace NaN (sensor-dropout) samples with the most recent finite
    sample per rack; ``last_good`` seeds racks whose first samples are dark.
    Returns ``(bridged, new_last_good)``.  A gather of the last finite
    sample at or before each index, so chunked bridging with the carried
    ``last_good`` equals whole-trace bridging bit for bit."""
    t = rack_power.shape[0]
    finite = torch.isfinite(rack_power)
    idx = torch.arange(t, device=rack_power.device).reshape((t,) + (1,) * (rack_power.ndim - 1))
    last_pos = torch.cummax(torch.where(finite, idx, -1), dim=0).values
    vals = torch.where(finite, rack_power, 0.0)
    held = torch.gather(vals, 0, torch.clamp(last_pos, min=0))
    bridged = torch.where(last_pos >= 0, held, last_good)
    return bridged, bridged[-1]


def hw_kwargs(cfg: PDUConfig) -> dict:
    """The host scalars of the hardware path, as ``ops.pdu_health_sim``
    takes them (each is the float32 config value read as a double)."""
    ep = cfg.ess_params
    return dict(
        beta=float(ep.beta), dt=cfg.sample_dt, q_max=float(ep.q_max),
        eta_c=float(ep.eta_c), eta_d=float(ep.eta_d), p_max=float(ep.p_max),
        soc_min=float(ep.soc_safe_min), soc_max=float(ep.soc_safe_max),
    )


class HostConsts(NamedTuple):
    """The host scalars ``condition`` hands its launches, read from the
    config and the state's filter once (``host_consts``): samples per
    controller interval, the SoC measurement weight, the hardware path's
    constants, host copies of the filter matrices (launch arguments of
    ``pdu_health``), the wear fold's step constants (None unless
    ``track_health``) and the supervisor's (None unless ``safemode``)."""

    k: int
    meas_w: float
    hw: dict
    lc: tuple
    health: tuple | None
    safemode: "SupervisorConsts | None" = None


class SupervisorConsts(NamedTuple):
    """What safe mode's sanitizer and converter ramp need, made before a
    capture: the LC steady-state map ``(I - Ad)^-1 Bd`` as its two float64
    columns ``ss`` (the filter restarts at ``ss[0] + r0 ss[1]``, one
    rounding), the SoC it restarts at (``s_mid``, the float32 value), the
    reinit value of each row the sanitizer resets for a whole rack
    (``fill``: ``u_prev``, the command target, the ten float wear leaves,
    the warm iterates) and the converter's slew ``(1..k) / k``
    (``ramp``)."""

    ss: torch.Tensor
    s_mid: float
    fill: torch.Tensor
    ramp: torch.Tensor


def host_consts(cfg: PDUConfig, filt: filters.DiscreteFilter) -> HostConsts:
    """``condition``'s host scalars for ``cfg`` and the filter ``filt`` (a
    state's ``filter_obj``).  Reading them synchronizes with the card, so a
    caller that conditions many chunks (the scanned engine) reads them once
    and passes them in."""
    k = max(int(round(float(cfg.controller.dt) / cfg.sample_dt)), 1)
    return HostConsts(
        k=k,
        meas_w=min(float(cfg.controller.dt) / float(cfg.controller.meas_tau), 1.0),
        hw=hw_kwargs(cfg),
        lc=tuple(m.detach().cpu().numpy() for m in (filt.ad, filt.bd, filt.c[0])),
        health=hlt.step_consts(cfg.health) if cfg.track_health else None,
        safemode=_supervisor_consts(cfg, filt, k) if cfg.safemode else None,
    )


def _supervisor_consts(cfg: PDUConfig, filt: filters.DiscreteFilter, k: int) -> SupervisorConsts:
    """The steady-state map is solved on the host in float32 (on the card
    ``torch.linalg.solve`` reads its status back); the ramp is ``(1..k)``
    times float32(1 / k), as the reference's compiled program evaluates the
    division."""
    dev = cfg.device
    ad, bd = filt.ad.detach().cpu(), filt.bd.detach().cpu()
    ss = torch.linalg.solve(torch.eye(ad.shape[0], dtype=ad.dtype) - ad, bd)
    s_mid = float(cfg.controller.s_mid)
    n_warm = sum(w.shape[0] for w in ctrl.init_warm(cfg.controller.horizon, (), device="cpu"))
    # u_prev, cmd_target, then the wear leaves: prev_soc and last_ext
    # restart at s_mid, the accumulators at 0; the warm iterates at 0.
    fill = [0.0, 0.0, s_mid, s_mid] + [0.0] * (8 + n_warm)
    ramp = torch.arange(1, k + 1, dtype=F32) * float(np.float32(1.0 / k))
    return SupervisorConsts(
        ss=ss.T.to(device=dev, dtype=torch.float64), s_mid=s_mid,
        fill=torch.tensor(fill, dtype=F32, device=dev), ramp=ramp.to(dev))


def _zoh_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` with its last row repeated ``pad`` more times."""
    return torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])], dim=0) if pad else x


def condition(
    cfg: PDUConfig,
    state: PDUState,
    rack_power: torch.Tensor,  # (T,) or (T, R) per-unit rack power
    *,
    idle_remaining_s: torch.Tensor | float = 0.0,
    qp_iters: int = 120,
    use_plan: bool = True,
    ess_online=None,
    ess_weight=None,
    faults: flt.FaultSchedule | None = None,
    chunk_start: int | torch.Tensor = 0,
    fault_edge: int = 1,
    plan: ctrl.ControllerPlan | None = None,
    consts: HostConsts | None = None,
    rack_span: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, PDUState, Telemetry]:
    """Condition a trace chunk; carries state across calls (streaming).

    Each controller interval (``k = dt_ctrl / sample_dt`` samples) runs the
    hardware path for ``k`` samples while the corrective command slews
    linearly from the applied value toward the latest controller output,
    then one warm-started QP solve on the EMA-filtered SoC produces the
    next target.  A ragged trace is zero-order-hold padded to whole
    intervals and the pad discarded.  ``plan`` overrides the factor-once
    controller plan (``ctrl.make_plan``), e.g. with one carried from the
    JAX package (``convert.plan_from_numpy``).  ``use_plan=False`` builds
    no plan (and refuses ``plan=``): each interval runs the per-step oracle
    ``ctrl.inner_loop_step`` cold on every rack with ``qp_iters``
    iterations, the warm iterates carried through unchanged; it reads the
    factorizations' status back from the card once an interval, so it is
    not for a CUDA graph.  ``rack_span=(lo, n)`` says the racks are columns
    ``[lo, lo + R)`` of a campus of ``n``, for the wear fold's block sums
    (``ref.block_sums``).

    Degraded mode (``cfg.degraded_mode``), as the reference's:
    ``ess_online`` is the per-interval availability (``(n_ctrl, ...)`` rows
    or one ``(...)`` mask for every interval); offline racks run in LC
    passthrough with zeroed commands (and residuals) and, on the plan's
    path, reset warm iterates.  NaN samples
    are bridged (``bridge_sensors`` from ``state.last_good``), and a rack
    with no finite sample in an interval is forced into passthrough for it.
    ``ess_weight`` (shaped like ``rack_power``) is the per-sample hardware
    weight (``faults.ess_weight``); ``ess_online`` then still governs the
    software plane.  ``faults`` (exclusive with both) is the fast path for
    the same semantics: the chunk's absolute ``chunk_start`` (an int, or a
    0-d int32 tensor on the card: ``faults.start_index``) and the
    schedule's ``fault_edge`` let the interval masks, the sensor bridge and
    the per-sample weight come from the episode tables, the last rendered
    inside the ``pdu_health`` kernel (``ess_events``).  Its outputs equal
    the streamed arrays' bit for bit at any chunk split.

    Safe mode (``cfg.safemode``), as the reference's: each interval starts
    with the sanitizer, which quarantines every rack holding a non-finite
    leaf of the carried state (``safemode.quarantine``) and reinitializes
    it: the leaves that shape the waveform (SoC, ESS filter, LC state,
    applied command, SoC EMA) where they went non-finite, the supervisor's
    own (``u_prev``, the command target, the warm iterates, the wear
    history) for the whole rack.  A quarantined rack winds its converter
    down to LC passthrough over one interval once its command has slewed to
    zero (the supervised weight ``hw + (gate - hw) (1..k) / k`` goes to
    ``pdu_health`` as its ``(k, R)`` series, times the degraded weight),
    and the kernel's output guard swaps non-finite grid samples for the
    rack's.  After the solve a command whose residual is over
    ``safemode_params.resid_threshold`` (or non-finite) is vetoed, the
    watchdog folds the raw residual (``safemode.residual_update``), and
    racks that are not NORMAL get zero command and residual and cold warm
    iterates.  ``Telemetry.safemode_mode`` carries the modes.  With
    ``faults`` a supervised call takes the streamed arrays derived from the
    schedule (``faults.interval_online`` and ``faults.ess_weight`` at
    ``chunk_start``), not the events mode.  A clean supervised run equals
    the unsupervised one bit for bit (a weight of ones is exact in the
    kernel).

    ``consts`` (``host_consts(cfg, state.filter_obj)``) and ``plan`` are
    read from the card when not given; with both given (and
    ``idle_remaining_s`` a tensor or a Python number) the call can be
    captured in a CUDA graph.
    """
    degraded = cfg.degraded_mode
    safemode = cfg.safemode
    if safemode and state.safemode is None:
        raise ValueError("a safe-mode config needs a state with its supervisor (init_state)")
    if plan is not None and not use_plan:
        raise ValueError("plan= is the factor-once controller's: it needs use_plan=True")
    if (ess_online is not None or ess_weight is not None) and not degraded:
        raise ValueError("ess_online/ess_weight require a cfg with degraded_mode=True")
    fast = faults is not None
    if fast:
        if not degraded:
            raise ValueError("faults requires a cfg with degraded_mode=True")
        if ess_online is not None or ess_weight is not None:
            raise ValueError(
                "pass either a FaultSchedule or explicit ess_online/ess_weight arrays, not both")
        if rack_power.ndim < 2:
            raise ValueError("the fault fast path needs a batched (T, R) trace")
    if rack_power.ndim > 2:
        raise ValueError("rack_power must be (T,) or (T, R)")
    dev = cfg.device
    dt = cfg.sample_dt
    if consts is None:
        consts = host_consts(cfg, state.filter_obj)
    k = consts.k
    t = rack_power.shape[0]
    n_ctrl = -(-t // k)
    pad = n_ctrl * k - t
    if fast and safemode:
        # The supervisor composes its own per-sample weight with the
        # schedule's, so a supervised call takes the streamed arrays (the
        # same values, by the fast path's contract).
        ess_online = flt.interval_online(faults, chunk_start, n_ctrl, k)
        ess_weight = flt.ess_weight(faults, chunk_start, t, fault_edge)
        faults, fast = None, False
    batched = rack_power.ndim == 2
    rc_all = (rack_power if batched else rack_power[:, None]).to(device=dev, dtype=F32)
    n_r = rc_all.shape[1]
    lift = (lambda x: x) if batched else (lambda x: x[None])
    drop = (lambda x: x) if batched else (lambda x: x[0])
    last_good = state.last_good

    # --- degraded mode: the interval masks and the hardware weight ---------
    if degraded:
        ess_base = lift(state.ess_online).to(F32).expand(n_r)
    if fast:
        cs = flt.start_index(chunk_start)
        t_last = cs + t - 1
        sensed = flt.interval_sensed(faults, cs, n_ctrl, k, stop=cs + t)
        arg_rows = flt.interval_online(faults, cs, n_ctrl, k)
        hw_base = ess_base * sensed.to(F32)
        on_rows = arg_rows * hw_base
        # The kernel reads the ESS tables in the chunk's frame (sample 0 =
        # chunk_start), so its index arguments are host ints even when the
        # start is a tensor on the card (the scanned engine's graph); its
        # compares and differences are the same integers in either frame.
        ev_st = (faults.ess_start - cs).T.contiguous()
        ev_en = (faults.ess_end - cs).T.contiguous()
        lg = lift(last_good).to(F32)
    elif degraded:
        finite = _zoh_pad(torch.isfinite(rc_all), pad)
        sensed = torch.any(finite.reshape(n_ctrl, k, n_r), dim=1)
        rc_all, lg_new = bridge_sensors(lift(last_good).to(F32), rc_all)
        last_good = drop(lg_new)
        if ess_online is None:
            arg_rows = torch.ones((n_ctrl, n_r), dtype=F32, device=dev)
        else:
            on = torch.as_tensor(ess_online, dtype=F32, device=dev)
            arg_rows = (on if batched else on[..., None]).expand(n_ctrl, n_r)
        hw_base = ess_base * sensed.to(F32)
        on_rows = arg_rows * hw_base
        if ess_weight is not None:
            wt = torch.as_tensor(ess_weight, dtype=F32, device=dev)
            wt = _zoh_pad(wt if batched else wt[:, None], pad)
            hw_chunks = wt.reshape(n_ctrl, k, n_r) * hw_base[:, None]
    chunks = _zoh_pad(rc_all, pad).contiguous().reshape(n_ctrl, k, n_r)

    meas_w = consts.meas_w
    if cfg.software_enabled and use_plan and plan is None:
        plan = ctrl.make_plan(cfg.controller, cfg.ess_params)
    hw_kw = consts.hw
    # Host copies of the filter matrices: the kernel takes them as launch
    # arguments (no device read per interval).
    lc = consts.lc
    hconsts = consts.health
    # A Python number is filled on the card (a fill kernel; a copy from
    # host memory could not be captured in a CUDA graph).
    idle = (idle_remaining_s.to(device=dev, dtype=F32) if isinstance(idle_remaining_s, torch.Tensor)
            else torch.full((), float(idle_remaining_s), dtype=F32, device=dev))
    if safemode:
        sm_cfg, sm, sc = cfg.safemode_params, state.safemode, consts.safemode
        modes = []

    x_f, es = state.filter_state, state.ess_state
    cmd_applied, cmd_target = state.cmd_applied, state.cmd_target
    u_prev, soc_ema, warm, hstate = state.u_prev, state.soc_ema, state.qp_warm, state.health
    grids, socs, cmds, tgts, resids, rack_means, grid_means = ([] for _ in range(7))
    for i in range(n_ctrl):
        rc = chunks[i]
        mask_kw, on_row, sm_w = {}, None, None
        if safemode:
            (es, x_f, u_prev, cmd_applied, cmd_target, soc_ema, warm, hstate, sm,
             sm_w) = _sanitize(sc, sm, drop(rc[0]), es, x_f, u_prev, cmd_applied, cmd_target,
                               soc_ema, warm, hstate)
            sm_w_lifted = sm_w if batched else sm_w[:, None]
        if fast:
            # --- sensor bridge from the schedule --------------------------
            # Dark samples take the raw value at the covering episode's
            # start - 1 (always finite: episodes are coalesced), or the
            # carried last-good row when that index precedes this interval;
            # indices clamp to the last real sample, so ZOH pad rows repeat
            # its bridge.  Equal to bridge_sensors over the whole chunk.
            i0 = cs + i * k
            idx = torch.clamp(i0 + torch.arange(k, dtype=torch.int32, device=dev), max=t_last)
            dark, hold = flt.sensor_dark_hold(faults, idx)
            loc = (hold - i0).to(torch.int64)
            held = torch.gather(torch.where(dark, 0.0, rc), 0, torch.clamp(loc, 0, k - 1))
            # (The schedule's signals are transposed views: without the copy
            # the result would be column-major, and the campus mean below
            # would sum in another order than the streamed path's.)
            rc = torch.where(dark, torch.where(loc >= 0, held, lg), rc).contiguous()
            lg = rc[-1]
            on_row = on_rows[i]
            mask_kw = dict(ess_events=(ev_st, ev_en, hw_base[i], i * k, t - 1),
                           ess_edge=int(fault_edge))
        elif degraded:
            on_row = on_rows[i]
            hw = on_row if ess_weight is None else hw_chunks[i]
            mask_kw = dict(ess_on=hw if sm_w is None else hw * sm_w_lifted)
        elif safemode:
            mask_kw = dict(ess_on=sm_w_lifted)

        # --- hardware path: one pdu_health launch per interval -----------
        health_in = (hconsts, tuple(lift(leaf) for leaf in hstate)) if cfg.track_health else None
        grid, _soc_path, (g_f, soc_f, x_new), h_leaves = ops.pdu_health_sim(
            rc, lift(es.g_filter), lift(es.soc), lift(x_f), *lc,
            slew=(lift(cmd_applied), lift(cmd_target)), health=health_in, rack_span=rack_span,
            guard=safemode,
            **mask_kw, **hw_kw,
        )
        rack_means.append(torch.mean(rc, dim=1))
        grid_means.append(torch.mean(grid, dim=1))
        grids.append(grid)
        es2 = ess.ESSState(g_filter=drop(g_f), soc=drop(soc_f))
        x_f = drop(x_new)
        if cfg.track_health:
            hstate2 = hlt.HealthState(*(drop(leaf) for leaf in h_leaves))
            # Wear feedback reads the pre-interval state (one interval of
            # staleness, off the controller's critical path).
            wear = hlt.cycle_life_fraction(cfg.health, hstate)
        else:
            hstate2 = hstate
            wear = 0.0

        # --- software path: one controller step --------------------------
        # float32 (i k) dt as the reference computes it, on the host.
        elapsed = float(np.float32(np.float32(i * k) * np.float32(dt)))
        idle_left = torch.clamp(idle - elapsed, min=0.0)
        s_target = ctrl.select_target(cfg.controller, cfg.ess_params, idle_left, wear)
        soc_meas = soc_ema + meas_w * (es2.soc - soc_ema)
        if cfg.software_enabled and use_plan:
            out, warm = ctrl.inner_loop_step_plan(
                cfg.controller, cfg.ess_params, plan, soc_meas, s_target,
                u_prev, warm, qp_iters=qp_iters,
                active=None if on_row is None else drop(on_row),
            )
            new_cmd, resid = out.corrective_power, out.qp_primal_residual
        elif cfg.software_enabled:
            # The per-step oracle: every rack's QP built, factored and
            # solved cold; the warm iterates ride through untouched.
            out = ctrl.inner_loop_step(
                cfg.controller, cfg.ess_params, soc_meas, s_target.expand(soc_meas.shape),
                u_prev.expand(soc_meas.shape), qp_iters=qp_iters,
            )
            new_cmd, resid = out.corrective_power, out.qp_primal_residual
            if on_row is not None:
                act = drop(on_row) > 0
                new_cmd = torch.where(act, new_cmd, 0.0)
                resid = torch.where(act, resid, 0.0)
        else:
            new_cmd = torch.zeros_like(soc_meas)
            resid = torch.zeros_like(soc_meas)
        soc_row = es2.soc
        if safemode:
            # The watchdog: an over-threshold (or non-finite) solve's
            # command is vetoed (the rack holds its target), the raw
            # residual is folded, and no rack outside NORMAL commands its
            # battery; its warm iterates reset for a cold probe.  A SoC the
            # interval drove non-finite stays in the carry (the sanitizer
            # takes it next interval) but not in the telemetry.
            bad = smode.over_threshold(sm_cfg, resid)
            new_cmd = torch.where(bad, cmd_target, new_cmd)
            sm = smode.residual_update(sm_cfg, sm, resid, bad=bad)
            held = sm.mode != smode.NORMAL
            new_cmd = torch.where(held, 0.0, new_cmd)
            resid = torch.where(held, 0.0, resid)
            warm = ctrl.QPWarmState(*(torch.where(held, 0.0, w) for w in warm))
            soc_row = _fin(soc_row, sc.s_mid)
            modes.append(sm.mode)
        socs.append(soc_row)
        cmds.append(new_cmd)
        tgts.append(s_target.expand(soc_meas.shape))
        resids.append(resid)
        u_prev = new_cmd / cfg.controller.i_max
        cmd_applied, cmd_target = cmd_target, new_cmd
        soc_ema, es, hstate = soc_meas, es2, hstate2

    if fast:
        last_good = drop(lg)
    grid = torch.cat(grids, dim=0)[:t]
    grid = grid if batched else grid[:, 0]
    new_state = state._replace(
        filter_state=x_f, ess_state=es, u_prev=u_prev, cmd_applied=cmd_applied,
        cmd_target=cmd_target, soc_ema=soc_ema, qp_warm=warm, health=hstate,
        last_good=last_good, safemode=sm if safemode else state.safemode,
    )
    return grid, new_state, Telemetry(
        soc=torch.stack(socs), command=torch.stack(cmds), target=torch.stack(tgts),
        qp_residual=torch.stack(resids),
        rack_mean=torch.cat(rack_means)[:t], grid_mean=torch.cat(grid_means)[:t],
        ess_online=None if not degraded else (on_rows if batched else on_rows[:, 0]),
        safemode_mode=torch.stack(modes) if safemode else None,
    )


def _fin(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x`` with its non-finite entries replaced by ``v``: ``where(isfinite(x),
    x, v)`` in one launch."""
    return torch.nan_to_num(x, nan=v, posinf=v, neginf=v)


def _sanitize(sc: SupervisorConsts, sm, r0, es, x_f, u_prev, cmd_applied, cmd_target, soc_ema,
              warm, hstate):
    """Safe mode's start of an interval: quarantine every rack holding a
    non-finite carried leaf and reinitialize it, then gate its hardware
    plane.  ``r0`` is the interval's first rack sample (the steady state
    the filters restart at).  One finite test covers every float leaf at
    once.  The leaves that shape the waveform (ESS filter, LC state, SoC,
    applied command, SoC EMA) keep their finite values, so containment
    never steps the grid; the supervisor's own (``u_prev``, the command
    target, the wear history, the warm iterates) reset for the whole rack,
    in one select, so the next probe is a deterministic cold start.  The
    hardware plane reads the pre-watchdog mode: only a QUARANTINE rack
    whose command has slewed to zero winds its converter down, slewing the
    applied weight across the interval.  Returns the repaired leaves, the
    supervisor state and the ``(k, ...)`` weight."""
    row = lambda leaf: leaf[None]
    wear = [row(leaf) for leaf in hstate if leaf.is_floating_point()]
    # Rows 0-6 are repaired where they went non-finite, the rest (from 7)
    # for the whole rack.
    # (Contiguous pieces: one batched copy; a strided one makes the
    # concatenation copy piece by piece.)
    carried = torch.cat([row(es.g_filter), x_f.movedim(-1, 0).contiguous(), row(es.soc),
                         row(cmd_applied), row(soc_ema), row(u_prev), row(cmd_target), *wear,
                         *warm])
    ok = smode.finite(carried)
    corrupt = ~ok.all(0)
    r0 = _fin(r0, 0.5)
    x_ss = torch.addcmul(sc.ss[0], r0.double()[..., None], sc.ss[1]).float()  # one rounding
    g = torch.where(ok[0], es.g_filter, r0)
    x_f = torch.where(ok[1:4].movedim(0, -1), x_f, x_ss)
    reset = torch.where(corrupt, sc.fill.reshape((-1,) + (1,) * r0.ndim), carried[7:])
    u_prev, cmd_target = reset[0], reset[1]
    wear = iter(reset[2 : 2 + len(wear)])
    hstate = hlt.HealthState(*(next(wear) if leaf.is_floating_point()
                               else torch.where(corrupt, 0, leaf) for leaf in hstate))
    ends = np.cumsum([2 + len(hlt.HealthState._fields) - 1] + [w.shape[0] for w in warm])
    warm = ctrl.QPWarmState(*(reset[a:b] for a, b in zip(ends[:-1], ends[1:])))
    cmd_applied = _fin(cmd_applied, 0.0)
    sm = smode.quarantine(sm, corrupt)
    gate = ((sm.mode != smode.QUARANTINE) | (cmd_applied != 0.0) | (cmd_target != 0.0)).to(F32)
    # hw + (gate - hw) ramp: XLA fuses it into one rounding, and so does
    # float32 here, since hw holds a gate (0 or 1) and (gate - hw) ramp is
    # exact.  A clean rack computes 1 + 0 ramp = 1 exactly.
    w = sm.hw_weight + (gate - sm.hw_weight) * sc.ramp.reshape((-1,) + (1,) * gate.ndim)
    es = ess.ESSState(g_filter=g, soc=_fin(es.soc, sc.s_mid))
    return (es, x_f, u_prev, cmd_applied, cmd_target, _fin(soc_ema, sc.s_mid), warm, hstate,
            sm._replace(hw_weight=gate), w)


class CampusChunk(NamedTuple):
    """Campus aggregates of one conditioned (T, R) chunk (per-unit means)."""

    campus_rack: torch.Tensor  # (T,) mean unconditioned campus load
    campus_grid: torch.Tensor  # (T,) mean conditioned campus load
    soc_mean: torch.Tensor  # (n_ctrl,) fleet-mean SoC per control interval
    max_qp_residual: torch.Tensor  # () worst QP primal residual in the chunk
    health: torch.Tensor  # (3,) [mean EFC, max fade, max DoD] at chunk end
    # (n_ctrl,) fraction of ESS units online per interval (ones unless the
    # cfg runs degraded_mode).
    ess_online_frac: torch.Tensor = None
    # (6,) supervisor snapshot at the chunk's end (zeros unless the cfg
    # runs safemode): [frac_normal, n_passthrough, n_quarantined,
    # entries_total, readmissions_total, worst_resid_streak].
    safemode: torch.Tensor = None


def condition_campus(
    cfg: PDUConfig,
    state: PDUState,
    rack_power: torch.Tensor,  # (T, R)
    *,
    qp_iters: int = 30,
    use_plan: bool = True,
    ess_online=None,
    ess_weight=None,
    faults=None,
    chunk_start: int | torch.Tensor = 0,
    fault_edge: int = 1,
    plan: ctrl.ControllerPlan | None = None,
    consts: HostConsts | None = None,
    rack_span: tuple[int, int] | None = None,
) -> tuple[PDUState, CampusChunk]:
    """One streaming-campus step: condition a chunk and reduce it to campus
    aggregates (the per-rack grid block never leaves the step).
    ``rack_span=(lo, n)``: the racks are columns ``[lo, lo + R)`` of a
    campus of ``n`` (a rank's block of a rack-sharded run; the wear fold's
    block sums, ``ref.block_sums``)."""
    _, state2, telem = condition(
        cfg, state, rack_power, qp_iters=qp_iters, use_plan=use_plan,
        ess_online=ess_online, ess_weight=ess_weight, faults=faults,
        chunk_start=chunk_start, fault_edge=fault_edge, plan=plan, consts=consts,
        rack_span=rack_span,
    )
    if cfg.track_health:
        hsnap = hlt.chunk_aggregates(cfg.health, state2.health, cfg.sample_dt)
    else:
        hsnap = torch.zeros(3, dtype=F32, device=cfg.device)
    return state2, CampusChunk(
        campus_rack=telem.rack_mean,
        campus_grid=telem.grid_mean,
        soc_mean=torch.mean(telem.soc, dim=1),
        max_qp_residual=torch.amax(telem.qp_residual),
        health=hsnap,
        ess_online_frac=(torch.mean(telem.ess_online, dim=1) if cfg.degraded_mode
                         else torch.ones(telem.soc.shape[0], dtype=F32, device=cfg.device)),
        safemode=(smode.chunk_snapshot(state2.safemode) if cfg.safemode
                  else torch.zeros(6, dtype=F32, device=cfg.device)),
    )


def combined_transfer_function(cfg: PDUConfig, f_hz: torch.Tensor) -> torch.Tensor:
    """``|H_total| = |H_ESS| |H_LC|`` from rack to grid current (paper Fig. 7)."""
    return ess.transfer_function(cfg.ess_params, f_hz) * filters.transfer_function_rack_to_grid(
        cfg.filter_params, f_hz)
