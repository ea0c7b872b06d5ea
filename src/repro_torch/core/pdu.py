"""The composed EasyRider PDU (paper §4-§6): filter + ESS + controller.

Port of ``repro.core.pdu`` on the clean path.  Signal chain (per-unit,
powers as fractions of rated rack power):

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

Degraded mode, safe mode, fault schedules and the build-per-step
(``use_plan=False``) controller are later slices of the port (ROADMAP.md,
queue 1 item 8); asking for them raises ``NotImplementedError``.
``PDUState`` keeps the reference's field names so they extend it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import compliance, controller as ctrl, ess, filters, \
    health as hlt, sizing
from repro_torch.kernels import ops
from repro_torch.utils.devices import resolve_device
from repro_torch.utils.structures import Struct

F32 = torch.float32
_LATER = "is not ported yet: it comes with ROADMAP.md queue 1 item 8 (degraded and safe mode)"


@dataclasses.dataclass(frozen=True)
class PDUConfig(Struct):
    filter_params: filters.LCFilterParams  # per-unit
    ess_params: ess.ESSParams
    controller: ctrl.ControllerConfig
    health: hlt.HealthParams = None  # aging model (used when track_health)
    sample_dt: float = 1e-3  # trace sample period [s]
    software_enabled: bool = True
    # Fold per-sample battery wear telemetry into the conditioning loop
    # (pure observation: grid/SoC outputs are unchanged).
    track_health: bool = False
    degraded_mode: bool = False
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
    device="cuda",
) -> PDUConfig:
    """Size and assemble an EasyRider PDU for a rack + grid spec (see
    ``repro.core.pdu.make_pdu``: Appendix A.1 Eq. 8 capacity with
    ``capacity_margin``, the ESS designed to ``beta / ramp_margin``).
    The sizing runs in float64 on the host; the config's tensors land on
    ``device``."""
    if degraded_mode or safemode:
        raise NotImplementedError(f"degraded_mode/safemode {_LATER}")
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
        sample_dt=sample_dt,
        software_enabled=software_enabled,
        track_health=track_health,
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
    # Degraded-mode state (manual ESS override, last finite sample) and the
    # safe-mode supervisor: carried for the later slices that use them.
    ess_online: torch.Tensor = None
    last_good: torch.Tensor = None
    safemode: object = None


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
    )


class Telemetry(NamedTuple):
    soc: torch.Tensor  # (n_ctrl, ...) SoC at each control interval
    command: torch.Tensor  # corrective power commanded per interval
    target: torch.Tensor  # outer-loop SoC target per interval
    qp_residual: torch.Tensor  # QP primal residual per interval (0 if sw off)
    rack_mean: torch.Tensor = None  # (T,) campus mean of the input trace
    grid_mean: torch.Tensor = None  # (T,) campus mean of the grid trace


def hw_kwargs(cfg: PDUConfig) -> dict:
    """The host scalars of the hardware path, as ``ops.pdu_health_sim``
    takes them (each is the float32 config value read as a double)."""
    ep = cfg.ess_params
    return dict(
        beta=float(ep.beta), dt=cfg.sample_dt, q_max=float(ep.q_max),
        eta_c=float(ep.eta_c), eta_d=float(ep.eta_d), p_max=float(ep.p_max),
        soc_min=float(ep.soc_safe_min), soc_max=float(ep.soc_safe_max),
    )


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
    faults=None,
    plan: ctrl.ControllerPlan | None = None,
) -> tuple[torch.Tensor, PDUState, Telemetry]:
    """Condition a trace chunk; carries state across calls (streaming).

    Each controller interval (``k = dt_ctrl / sample_dt`` samples) runs the
    hardware path for ``k`` samples while the corrective command slews
    linearly from the applied value toward the latest controller output,
    then one warm-started QP solve on the EMA-filtered SoC produces the
    next target.  A ragged trace is zero-order-hold padded to whole
    intervals and the pad discarded.  ``plan`` overrides the factor-once
    controller plan (``ctrl.make_plan``), e.g. with one carried from the
    JAX package (``convert.plan_from_numpy``).
    """
    if cfg.degraded_mode or cfg.safemode:
        raise NotImplementedError(f"degraded_mode/safemode {_LATER}")
    if ess_online is not None or ess_weight is not None or faults is not None:
        raise NotImplementedError(f"ess_online/ess_weight/faults {_LATER}")
    if not use_plan:
        raise NotImplementedError(f"use_plan=False {_LATER}")
    if rack_power.ndim > 2:
        raise ValueError("rack_power must be (T,) or (T, R)")
    dev = cfg.device
    dt = cfg.sample_dt
    k = max(int(round(float(cfg.controller.dt) / dt)), 1)
    t = rack_power.shape[0]
    n_ctrl = -(-t // k)
    pad = n_ctrl * k - t
    batched = rack_power.ndim == 2
    rc_all = (rack_power if batched else rack_power[:, None]).to(device=dev, dtype=F32)
    if pad:
        rc_all = torch.cat([rc_all, rc_all[-1:].expand(pad, -1)], dim=0)
    chunks = rc_all.contiguous().reshape(n_ctrl, k, rc_all.shape[1])

    lift = (lambda x: x) if batched else (lambda x: x[None])
    drop = (lambda x: x) if batched else (lambda x: x[0])
    filt = state.filter_obj
    meas_w = min(float(cfg.controller.dt) / float(cfg.controller.meas_tau), 1.0)
    if cfg.software_enabled and plan is None:
        plan = ctrl.make_plan(cfg.controller, cfg.ess_params)
    hw_kw = hw_kwargs(cfg)
    # Host copies of the filter matrices, read once per call: the kernel
    # takes them as launch arguments (no device read per interval).
    lc = tuple(filt_m.detach().cpu().numpy() for filt_m in (filt.ad, filt.bd, filt.c[0]))
    hconsts = hlt.step_consts(cfg.health) if cfg.track_health else None
    idle = torch.as_tensor(idle_remaining_s, dtype=F32, device=dev)

    x_f, es = state.filter_state, state.ess_state
    cmd_applied, cmd_target = state.cmd_applied, state.cmd_target
    u_prev, soc_ema, warm, hstate = state.u_prev, state.soc_ema, state.qp_warm, state.health
    grids, socs, cmds, tgts, resids, rack_means, grid_means = ([] for _ in range(7))
    for i in range(n_ctrl):
        # --- hardware path: one pdu_health launch per interval -----------
        rc = chunks[i]
        health_in = (hconsts, tuple(lift(leaf) for leaf in hstate)) if cfg.track_health else None
        grid, _soc_path, (g_f, soc_f, x_new), h_leaves = ops.pdu_health_sim(
            rc, lift(es.g_filter), lift(es.soc), lift(x_f), *lc,
            slew=(lift(cmd_applied), lift(cmd_target)), health=health_in, **hw_kw,
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
        if cfg.software_enabled:
            out, warm = ctrl.inner_loop_step_plan(
                cfg.controller, cfg.ess_params, plan, soc_meas, s_target,
                u_prev, warm, qp_iters=qp_iters,
            )
            new_cmd, resid = out.corrective_power, out.qp_primal_residual
        else:
            new_cmd = torch.zeros_like(soc_meas)
            resid = torch.zeros_like(soc_meas)
        socs.append(es2.soc)
        cmds.append(new_cmd)
        tgts.append(s_target.expand(soc_meas.shape))
        resids.append(resid)
        u_prev = new_cmd / cfg.controller.i_max
        cmd_applied, cmd_target = cmd_target, new_cmd
        soc_ema, es, hstate = soc_meas, es2, hstate2

    grid = torch.cat(grids, dim=0)[:t]
    grid = grid if batched else grid[:, 0]
    new_state = state._replace(
        filter_state=x_f, ess_state=es, u_prev=u_prev, cmd_applied=cmd_applied,
        cmd_target=cmd_target, soc_ema=soc_ema, qp_warm=warm, health=hstate,
    )
    return grid, new_state, Telemetry(
        soc=torch.stack(socs), command=torch.stack(cmds), target=torch.stack(tgts),
        qp_residual=torch.stack(resids),
        rack_mean=torch.cat(rack_means)[:t], grid_mean=torch.cat(grid_means)[:t],
    )


class CampusChunk(NamedTuple):
    """Campus aggregates of one conditioned (T, R) chunk (per-unit means)."""

    campus_rack: torch.Tensor  # (T,) mean unconditioned campus load
    campus_grid: torch.Tensor  # (T,) mean conditioned campus load
    soc_mean: torch.Tensor  # (n_ctrl,) fleet-mean SoC per control interval
    max_qp_residual: torch.Tensor  # () worst QP primal residual in the chunk
    health: torch.Tensor  # (3,) [mean EFC, max fade, max DoD] at chunk end


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
    plan: ctrl.ControllerPlan | None = None,
) -> tuple[PDUState, CampusChunk]:
    """One streaming-campus step: condition a chunk and reduce it to campus
    aggregates (the per-rack grid block never leaves the step)."""
    _, state2, telem = condition(
        cfg, state, rack_power, qp_iters=qp_iters, use_plan=use_plan,
        ess_online=ess_online, ess_weight=ess_weight, faults=faults, plan=plan,
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
    )
