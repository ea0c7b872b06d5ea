"""Battery lifetime management controller (paper §6, Appendix B).

Port of the plan-based path of ``repro.core.controller``:

  * **Outer loop** (``select_target``): the SoC target S* — S_mid while
    training, dropping toward S_idle in long idle windows, bounded by the
    usable idle budget and scaled by consumed cycle life (``wear_gain``).
  * **Inner loop** (every 5 s): the receding-horizon QP (paper Eq. 13-17)
    over H intervals with the corrective current split ``i = c - d``,
    factored once per configuration (``make_plan``) and solved for every
    rack at once by a fixed number of warm-started OSQP-style ADMM
    iterations (``solve_qp_admm_plan``), whose iteration loop is the
    ``admm_step`` kernel (``kernels.ops.admm_iterate``).

Everything is float32 with currents as fractions of rated rack power.  The
per-step QP assembly and cold-start solver of the reference
(``_build_qp``, ``solve_qp_admm``, ``inner_loop_step``) come with the
``use_plan=False`` path in a later slice (ROADMAP.md, queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.ess import ESSParams
from repro_torch.kernels import ops
from repro_torch.utils.devices import resolve_device
from repro_torch.utils.structures import Struct

F32 = torch.float32


class QPSolution(NamedTuple):
    x: torch.Tensor
    primal_residual: torch.Tensor
    dual_residual: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ControllerConfig(Struct):
    # Outer loop policy.
    s_mid: torch.Tensor  # mid-band target during training
    s_idle: torch.Tensor  # storage-mode target during long idle
    t_enter: torch.Tensor  # [s] minimum predicted idle to enter storage mode
    delta_s_min: torch.Tensor  # minimum useful SoC shift to bother
    delta_s_max: torch.Tensor  # max allowed downward shift
    # Inner loop.
    horizon: int = 12
    dt: torch.Tensor = None  # control interval [s]
    i_max: torch.Tensor = None  # max corrective current (fraction of rated power)
    deadband: torch.Tensor = None  # |S - S*| below which the current is 0
    lam_i: torch.Tensor = None  # maintenance-current magnitude weight
    lam_delta: torch.Tensor = None  # command smoothness weight
    lam_term: torch.Tensor = None  # terminal tracking weight
    meas_tau: torch.Tensor = None  # BMS SoC measurement EMA time constant [s]
    wear_gain: torch.Tensor = None  # storage excursion vs consumed cycle life

    @staticmethod
    def create(
        s_mid: float = 0.5,
        s_idle: float = 0.3,
        t_enter: float = 1800.0,
        delta_s_min: float = 0.05,
        delta_s_max: float = 0.25,
        horizon: int = 12,
        dt: float = 5.0,
        i_max: float = 5e-3,
        deadband: float = 5e-3,
        lam_i: float = 1e-2,
        lam_delta: float = 1e-1,
        lam_term: float = 4.0,
        meas_tau: float = 60.0,
        wear_gain: float = 0.0,
        *,
        device="cuda",
    ) -> "ControllerConfig":
        dev = resolve_device(device)
        f = lambda v: torch.tensor(v, dtype=F32, device=dev)
        return ControllerConfig(
            s_mid=f(s_mid), s_idle=f(s_idle), t_enter=f(t_enter),
            delta_s_min=f(delta_s_min), delta_s_max=f(delta_s_max),
            horizon=int(horizon), dt=f(dt), i_max=f(i_max), deadband=f(deadband),
            lam_i=f(lam_i), lam_delta=f(lam_delta), lam_term=f(lam_term),
            meas_tau=f(meas_tau), wear_gain=f(wear_gain),
        )


# --------------------------------------------------------------------------
# Outer loop: SoC target selection (paper §6, Eq. 11)
# --------------------------------------------------------------------------


def select_target(
    cfg: ControllerConfig,
    ess: ESSParams,
    idle_remaining_s: torch.Tensor,
    wear: torch.Tensor | float = 0.0,
) -> torch.Tensor:
    """Target S* given the predicted remaining idle time (see
    ``repro.core.controller.select_target``).  ``wear_gain = 0`` multiplies
    the excursion by exactly 1, reproducing the wear-blind policy."""
    charge_rate = cfg.i_max * ess.eta_c / ess.q_max
    discharge_rate = cfg.i_max / (ess.eta_d * ess.q_max)
    delta_s_eff = cfg.delta_s_max * torch.clamp(1.0 - cfg.wear_gain * wear, min=0.0)
    s_floor = torch.maximum(
        torch.maximum(cfg.s_idle, cfg.s_mid - delta_s_eff), ess.soc_safe_min
    )
    delta_budget = idle_remaining_s / (1.0 / discharge_rate + 1.0 / charge_rate)
    s_budget = cfg.s_mid - delta_budget
    target = torch.maximum(s_floor, s_budget)
    useful = (cfg.s_mid - target) >= cfg.delta_s_min
    in_storage = (idle_remaining_s >= cfg.t_enter) & useful
    return torch.where(in_storage, target, cfg.s_mid)


# --------------------------------------------------------------------------
# Factor-once plan + batched warm-started ADMM
# --------------------------------------------------------------------------


class QPWarmState(NamedTuple):
    """ADMM iterates carried across control intervals (warm start).
    Shapes: ``x`` (2h, *batch), ``z``/``y`` (3h, *batch)."""

    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ControllerPlan(Struct):
    """Config-only precomputation of the inner-loop QP (factor once):
    ``q = q_e0 e0 + q_du u_prev`` with ``e0 = (soc - S*) / ds_ref`` and
    ``lo/hi = {lo,hi}_base - soc_rows soc`` are the only state-dependent
    pieces; the KKT inverse is shared by every rack and interval."""

    p_mat: torch.Tensor  # (2h, 2h) quadratic cost
    a_mat: torch.Tensor  # (3h, 2h) stacked box + SoC constraints
    kkt_chol: torch.Tensor  # (2h, 2h) lower Cholesky of P + sigma I + rho A'A
    kkt_inv_sigma: torch.Tensor  # (2h, 2h) sigma K^-1
    kkt_inv_at: torch.Tensor  # (2h, 3h) K^-1 A'
    kkt_inv: torch.Tensor  # (2h, 2h) K^-1
    q_e0: torch.Tensor  # (2h,) dq / d e0
    q_du: torch.Tensor  # (2h,) dq / d u_prev
    lo_base: torch.Tensor  # (3h,)
    hi_base: torch.Tensor  # (3h,)
    soc_rows: torch.Tensor  # (3h,) 1.0 on the SoC-constraint rows
    ds_ref: torch.Tensor  # scalar error normalization (Eq. 12)
    horizon: int = 12
    rho: float = 1.0
    sigma: float = 1e-6


def make_plan(
    cfg: ControllerConfig, ess: ESSParams, *, rho: float = 1.0, sigma: float = 1e-6
) -> ControllerPlan:
    """Precompute the config-only QP pieces (float32, on the config's
    device).  The Cholesky factor and ``K^-1`` differ from XLA's by a few
    ulp; ``convert.plan_from_numpy`` carries the reference's plan across
    where bits matter."""
    h = cfg.horizon
    dev = cfg.dt.device
    eye = lambda n: torch.eye(n, dtype=F32, device=dev)
    ds_ref = torch.clamp(torch.abs(cfg.s_mid - cfg.s_idle), min=0.05)
    ltri = torch.tril(torch.ones((h, h), dtype=F32, device=dev))
    g_c = (cfg.dt / ess.q_max) * ess.eta_c * ltri
    g_d = -(cfg.dt / ess.q_max) / ess.eta_d * ltri
    g = torch.cat([g_c, g_d], dim=1)  # (h, 2h)
    w = torch.ones(h, dtype=F32, device=dev)
    w[h - 1] += cfg.lam_term
    ge = g / ds_ref
    p_track = 2.0 * (ge.T * w) @ ge
    p_mag = 2.0 * cfg.lam_i / (cfg.i_max**2) * eye(2 * h)
    diff = eye(h) - torch.diag(torch.ones(h - 1, dtype=F32, device=dev), -1)
    sel = torch.cat([eye(h), -eye(h)], dim=1) / cfg.i_max
    dmat = diff @ sel
    p_smooth = 2.0 * cfg.lam_delta * dmat.T @ dmat
    p_mat = p_track + p_mag + p_smooth
    q_e0 = 2.0 * ge.T @ w
    q_du = -2.0 * cfg.lam_delta * dmat[0]
    a_mat = torch.cat([eye(2 * h), g], dim=0)  # (3h, 2h)
    zeros = torch.zeros(2 * h, dtype=F32, device=dev)
    lo_base = torch.cat([zeros, ess.soc_safe_min.expand(h)])
    hi_base = torch.cat([cfg.i_max.expand(2 * h), ess.soc_safe_max.expand(h)])
    soc_rows = torch.cat([zeros, torch.ones(h, dtype=F32, device=dev)])
    kkt = p_mat + sigma * eye(2 * h) + rho * (a_mat.T @ a_mat)
    kkt_chol = torch.linalg.cholesky(kkt)
    kkt_inv = torch.cholesky_solve(eye(2 * h), kkt_chol)
    return ControllerPlan(
        p_mat=p_mat, a_mat=a_mat, kkt_chol=kkt_chol,
        kkt_inv_sigma=sigma * kkt_inv, kkt_inv_at=kkt_inv @ a_mat.T,
        kkt_inv=kkt_inv, q_e0=q_e0, q_du=q_du, lo_base=lo_base,
        hi_base=hi_base, soc_rows=soc_rows, ds_ref=ds_ref,
        horizon=int(h), rho=float(rho), sigma=float(sigma),
    )


def _qp_state_terms(
    plan: ControllerPlan,
    soc_now: torch.Tensor,  # () or (R,)
    s_target: torch.Tensor,
    u_prev: torch.Tensor,
):
    """(q, lo, hi) from the state: rank-1 updates of the plan's bases."""
    e0 = (soc_now - s_target) / plan.ds_ref
    if e0.ndim > 0:
        soc = soc_now.expand(e0.shape)
        u = torch.as_tensor(u_prev, dtype=F32, device=e0.device).expand(e0.shape)
        q = plan.q_e0[:, None] * e0[None, :] + plan.q_du[:, None] * u[None, :]
        lo = plan.lo_base[:, None] - plan.soc_rows[:, None] * soc[None, :]
        hi = plan.hi_base[:, None] - plan.soc_rows[:, None] * soc[None, :]
    else:
        q = plan.q_e0 * e0 + plan.q_du * u_prev
        lo = plan.lo_base - plan.soc_rows * soc_now
        hi = plan.hi_base - plan.soc_rows * soc_now
    return q, lo, hi


def solve_qp_admm_plan(
    plan: ControllerPlan,
    q: torch.Tensor,  # (2h,) or (2h, R)
    lo: torch.Tensor,  # (3h,) or (3h, R)
    hi: torch.Tensor,
    warm: QPWarmState | None = None,
    *,
    iters: int = 30,
) -> tuple[QPSolution, QPWarmState]:
    """Batched ADMM against a prefactorized plan; the rack batch rides in
    the trailing axis.  ``kq = K^-1 q`` and the residuals stay
    ``torch.matmul`` (the reference also computes them outside its
    kernel); the iteration loop is the ``admm_step`` kernel."""
    a_mat = plan.a_mat
    if warm is None:
        x0 = torch.zeros_like(q)
        z0 = torch.clamp(a_mat @ x0, lo, hi)
        y0 = torch.zeros_like(z0)
    else:
        x0, z0, y0 = warm.x, warm.z, warm.y
    kq = plan.kkt_inv @ q
    kkt_stack = torch.cat([plan.kkt_inv_sigma, plan.kkt_inv_at], dim=1)
    x, z, y = ops.admm_iterate(
        kkt_stack, a_mat[2 * plan.horizon :], kq, lo, hi, x0, z0, y0,
        rho=plan.rho, iters=iters,
    )
    ax = a_mat @ x
    primal = torch.amax(torch.abs(ax - torch.clamp(ax, lo, hi)), dim=0)
    dual = torch.amax(torch.abs(plan.p_mat @ x + q + a_mat.T @ y), dim=0)
    return (
        QPSolution(x=x, primal_residual=primal, dual_residual=dual),
        QPWarmState(x=x, z=z, y=y),
    )


def init_warm(
    plan: ControllerPlan | int,
    batch_shape: tuple[int, ...] = (),
    *,
    device="cuda",
) -> QPWarmState:
    """Zero warm state (== cold start while the SoC is inside the band).
    Accepts a plan or a bare horizon."""
    h = plan if isinstance(plan, int) else plan.horizon
    dev = resolve_device(device)
    z = lambda n: torch.zeros((n,) + tuple(batch_shape), dtype=F32, device=dev)
    return QPWarmState(x=z(2 * h), z=z(3 * h), y=z(3 * h))


def reset_warm_where(warm: QPWarmState, reset: torch.Tensor) -> QPWarmState:
    """Zero the ADMM iterates of the masked entries (cold start); an
    all-false mask is the identity."""
    keep = ~reset.to(torch.bool)
    return QPWarmState(
        x=torch.where(keep, warm.x, 0.0),
        z=torch.where(keep, warm.z, 0.0),
        y=torch.where(keep, warm.y, 0.0),
    )


class ControllerOutput(NamedTuple):
    corrective_power: torch.Tensor  # applied first action (fraction of rated)
    s_target: torch.Tensor
    in_deadband: torch.Tensor
    qp_primal_residual: torch.Tensor


def inner_loop_step_plan(
    cfg: ControllerConfig,
    ess: ESSParams,
    plan: ControllerPlan,
    soc_now: torch.Tensor,  # () or (R,)
    s_target: torch.Tensor,
    u_prev: torch.Tensor,
    warm: QPWarmState | None = None,
    *,
    qp_iters: int = 30,
    active: torch.Tensor | None = None,
) -> tuple[ControllerOutput, QPWarmState]:
    """Factor-free batched control step against a precomputed plan: the
    first action of the solved QP, clipped to the current limit and zeroed
    inside the deadband.  ``active`` masks racks whose ESS is offline
    (command and residual zeroed, warm iterates reset)."""
    h = plan.horizon
    tgt = torch.as_tensor(s_target, dtype=F32, device=soc_now.device).expand(soc_now.shape)
    up = torch.as_tensor(u_prev, dtype=F32, device=soc_now.device).expand(soc_now.shape)
    q, lo, hi = _qp_state_terms(plan, soc_now, tgt, up)
    sol, w2 = solve_qp_admm_plan(plan, q, lo, hi, warm, iters=qp_iters)
    i0 = torch.clamp(sol.x[0] - sol.x[h], -cfg.i_max, cfg.i_max)
    in_deadband = torch.abs(soc_now - tgt) <= cfg.deadband
    i0 = torch.where(in_deadband, 0.0, i0)
    resid = sol.primal_residual
    if active is not None:
        act = active.expand(soc_now.shape) > 0
        i0 = torch.where(act, i0, 0.0)
        resid = torch.where(act, resid, 0.0)
        w2 = reset_warm_where(w2, ~act)
    out = ControllerOutput(
        corrective_power=i0,
        s_target=tgt if soc_now.ndim else s_target,
        in_deadband=in_deadband,
        qp_primal_residual=resid,
    )
    return out, w2
