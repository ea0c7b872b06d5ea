"""Battery lifetime management controller (paper §6, Appendix B).

Port of ``repro.core.controller``:

  * **Outer loop** (``select_target``): the SoC target S* — S_mid while
    training, dropping toward S_idle in long idle windows, bounded by the
    usable idle budget and scaled by consumed cycle life (``wear_gain``).
  * **Inner loop** (every 5 s): the receding-horizon QP (paper Eq. 13-17)
    over H intervals with the corrective current split ``i = c - d``,
    solved by a fixed number of OSQP-style ADMM iterations.  Two paths
    compute it:

    - the factor-once plan (``make_plan``), solved for every rack at once
      by warm-started iterations (``solve_qp_admm_plan``,
      ``inner_loop_step_plan``) whose loop is the ``admm_step`` kernel
      (``kernels.ops.admm_iterate``): what ``pdu.condition`` runs by
      default;
    - the per-step oracle: the QP assembled per rack and step
      (``_build_qp``), its KKT matrix factored per rack and solved cold
      (``solve_qp_admm``, ``inner_loop_step``) in ``torch.linalg``, as the
      reference does it in ``jax.scipy.linalg`` (no TPU kernel): the
      baseline ``pdu.condition(use_plan=False)`` runs, and the oracle the
      plan is held against.

    ``simulate_soc_management`` closes the loop over one battery (paper
    Fig. 12) through the plan.

Everything is float32 with currents as fractions of rated rack power.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
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


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``(..., m, n) x (..., n) -> (..., m)``."""
    return (m @ v[..., None])[..., 0]


def solve_qp_admm(
    p_mat: torch.Tensor,  # (..., n, n)
    q: torch.Tensor,  # (..., n)
    a_mat: torch.Tensor,  # (..., m, n)
    lo: torch.Tensor,  # (..., m)
    hi: torch.Tensor,
    *,
    rho: float = 1.0,
    sigma: float = 1e-6,
    iters: int = 250,
) -> QPSolution:
    """OSQP-style ADMM for ``min 1/2 x'Px + q'x  s.t.  lo <= Ax <= hi``,
    cold-started, with the KKT matrix ``P + sigma I + rho A'A`` Cholesky-
    factored once per call and per batch entry (leading axes are a batch,
    as the reference's ``jax.vmap``), then ``iters`` fixed steps.  The
    residuals are maxima over the constraint (primal) and variable (dual)
    axes.  A factorization that fails raises ``torch.linalg.LinAlgError``
    naming the batch entry; its ``info`` is read once, after the loop."""
    n = q.shape[-1]
    eye = torch.eye(n, dtype=q.dtype, device=q.device)
    a_mat = a_mat.contiguous()  # a batch expanded from one matrix: copied once, not per product
    a_t = a_mat.transpose(-1, -2)
    kkt = p_mat + sigma * eye + rho * (a_t @ a_mat)
    chol, info = torch.linalg.cholesky_ex(kkt)
    x = torch.zeros_like(q)
    z = torch.clamp(_mv(a_mat, x), lo, hi)
    y = torch.zeros_like(z)
    for _ in range(iters):
        rhs = sigma * x - q + _mv(a_t, rho * z - y)
        x = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
        ax = _mv(a_mat, x)
        z_new = torch.clamp(ax + y / rho, lo, hi)
        y = y + rho * (ax - z_new)
        z = z_new
    bad = torch.nonzero(info.reshape(-1)).reshape(-1).tolist()
    if bad:
        where = np.unravel_index(bad[0], info.shape) if info.ndim else ()
        raise torch.linalg.LinAlgError(
            f"solve_qp_admm: the KKT matrix of batch entry {tuple(map(int, where))} is not "
            f"positive definite ({len(bad)} of {info.numel()} entries failed)")
    ax = _mv(a_mat, x)
    primal = torch.amax(torch.abs(ax - torch.clamp(ax, lo, hi)), dim=-1)
    dual = torch.amax(torch.abs(_mv(p_mat, x) + q + _mv(a_t, y)), dim=-1)
    return QPSolution(x=x, primal_residual=primal, dual_residual=dual)


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
# Inner loop: the per-step QP (paper Eq. 13-17)
# --------------------------------------------------------------------------


def _build_qp(
    cfg: ControllerConfig,
    ess: ESSParams,
    soc_now: torch.Tensor,
    s_target: torch.Tensor,
    u_prev: torch.Tensor,
):
    """Assemble ``(P, q, A, lo, hi)`` for ``x = [c_0..c_{H-1}, d_0..d_{H-1}]``
    (see ``repro.core.controller._build_qp``).

    SoC trajectory ``S_k = S_0 + (dt/Q)(eta_c cumsum(c) - cumsum(d)/eta_d)``,
    error ``e_k = (S_k - S*) / dS_ref``, command ``u_k = (c_k - d_k)/imax``;
    objective ``sum_k e_{k+1}^2 + lam_i (c_k^2 + d_k^2)/imax^2 +
    lam_delta (u_k - u_{k-1})^2 + lam_term e_H^2``; constraints ``0 <= c, d
    <= imax`` and the SoC safe band.  The leading shape of ``soc_now``,
    ``s_target`` and ``u_prev`` (broadcast together) is a batch of racks:
    ``P (..., 2h, 2h)``, ``q (..., 2h)``, ``A (..., 3h, 2h)``, ``lo``/``hi
    (..., 3h)``, the config-only ``P`` and ``A`` expanded over it.  Kept
    independent of ``make_plan``, which the tests hold against it."""
    h = cfg.horizon
    dt = cfg.dt
    dev = dt.device
    as32 = lambda v: torch.as_tensor(v, dtype=F32, device=dev)
    soc_now, s_target, u_prev = as32(soc_now), as32(s_target), as32(u_prev)
    batch = torch.broadcast_shapes(soc_now.shape, s_target.shape, u_prev.shape)
    eye = lambda n: torch.eye(n, dtype=F32, device=dev)
    ds_ref = torch.clamp(torch.abs(cfg.s_mid - cfg.s_idle), min=0.05)

    # S_{k+1} = S_0 + rows of L @ (eta_c c - d / eta_d) dt / Q.
    ltri = torch.tril(torch.ones((h, h), dtype=F32, device=dev))
    g_c = (dt / ess.q_max) * ess.eta_c * ltri
    g_d = -(dt / ess.q_max) / ess.eta_d * ltri
    g = torch.cat([g_c, g_d], dim=1)  # (h, 2h): S_{1..H} = S_0 + G x

    e0 = (soc_now - s_target) / ds_ref
    w = torch.ones(h, dtype=F32, device=dev)
    w[h - 1] += cfg.lam_term  # stage + terminal weight
    ge = g / ds_ref
    p_track = 2.0 * (ge.T * w) @ ge
    q_track = _mv(2.0 * ge.T, w * e0[..., None])

    p_mag = 2.0 * cfg.lam_i / (cfg.i_max**2) * eye(2 * h)

    # Smoothness on u = (c - d) / imax, the first row against u_prev.
    diff = eye(h) - torch.diag(torch.ones(h - 1, dtype=F32, device=dev), -1)
    sel = torch.cat([eye(h), -eye(h)], dim=1) / cfg.i_max
    dmat = diff @ sel  # (h, 2h)
    p_smooth = 2.0 * cfg.lam_delta * dmat.T @ dmat
    q_smooth = _mv(-2.0 * cfg.lam_delta * dmat.T, eye(h)[:, 0] * u_prev[..., None])

    p_mat = p_track + p_mag + p_smooth
    q_vec = q_track + q_smooth

    a_mat = torch.cat([eye(2 * h), g], dim=0)
    lo_box = torch.zeros(2 * h, dtype=F32, device=dev)
    hi_box = cfg.i_max.expand(2 * h)
    lo_soc = ess.soc_safe_min.expand(h) - soc_now[..., None]
    hi_soc = ess.soc_safe_max.expand(h) - soc_now[..., None]
    lo = torch.cat([lo_box.expand(batch + (2 * h,)), lo_soc.expand(batch + (h,))], dim=-1)
    hi = torch.cat([hi_box.expand(batch + (2 * h,)), hi_soc.expand(batch + (h,))], dim=-1)
    return (
        p_mat.expand(batch + p_mat.shape),
        q_vec.expand(batch + (2 * h,)),
        a_mat.expand(batch + a_mat.shape),
        lo,
        hi,
    )


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


def inner_loop_step(
    cfg: ControllerConfig,
    ess: ESSParams,
    soc_now: torch.Tensor,
    s_target: torch.Tensor,
    u_prev: torch.Tensor,
    *,
    qp_iters: int = 250,
) -> ControllerOutput:
    """One 5-second control step on the per-step oracle: build the QP
    (``_build_qp``), solve it cold (``solve_qp_admm``), apply the first
    action ``c_0 - d_0``, clipped to the current limit and zeroed inside the
    deadband ``|S - S*| <= eps``.  Any batch shape of ``soc_now`` /
    ``s_target`` / ``u_prev`` (broadcast together) is a batch of racks, each
    with its own factorization, as the reference's ``jax.vmap`` of it."""
    soc_now = torch.as_tensor(soc_now, dtype=F32, device=cfg.dt.device)
    s_target = torch.as_tensor(s_target, dtype=F32, device=cfg.dt.device)
    p_mat, q_vec, a_mat, lo, hi = _build_qp(cfg, ess, soc_now, s_target, u_prev)
    sol = solve_qp_admm(p_mat, q_vec, a_mat, lo, hi, iters=qp_iters)
    h = cfg.horizon
    # The command is a current limit; ADMM's iterate may sit slightly
    # outside the box before full convergence.
    i0 = torch.clamp(sol.x[..., 0] - sol.x[..., h], -cfg.i_max, cfg.i_max)
    in_deadband = torch.abs(soc_now - s_target) <= cfg.deadband
    i0 = torch.where(in_deadband, 0.0, i0)
    return ControllerOutput(
        corrective_power=i0,
        s_target=s_target.expand(i0.shape),
        in_deadband=in_deadband.expand(i0.shape),
        qp_primal_residual=sol.primal_residual,
    )


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


def simulate_soc_management(
    cfg: ControllerConfig,
    ess: ESSParams,
    soc0: torch.Tensor | float,
    n_steps: int,
    *,
    idle_remaining_s: torch.Tensor | float = 0.0,
    drift_power: torch.Tensor | float = 0.0,
    qp_iters: int = 120,
    warm_start: bool = False,
) -> dict:
    """Closed-loop SoC trajectory of one battery under the controller
    (paper Fig. 12), a Python loop of ``n_steps`` control steps on the
    config's device.

    The plan is factored once (``make_plan``); each step runs
    ``inner_loop_step_plan`` (its unbatched solve lifted to one column of
    the ``admm_step`` kernel on the card), cold-started by default as the
    reference's Fig. 12 is (a fixed-iteration cold solve lands slightly
    above the optimum's command magnitude near the target, the regime the
    paper's ~20 min matches), warm-started with ``warm_start=True``.
    ``drift_power`` is a constant parasitic charge (+) / discharge (-)
    power.  The SoC is clipped to the safe band and ``u_prev`` is the
    command over ``i_max``.  Returns ``{"soc", "command", "target"}``, each
    of shape ``(n_steps,)``."""
    dev = cfg.dt.device
    idle = torch.as_tensor(idle_remaining_s, dtype=F32, device=dev)
    drift = torch.as_tensor(drift_power, dtype=F32, device=dev)
    plan = make_plan(cfg, ess)
    soc = torch.as_tensor(soc0, dtype=F32, device=dev)
    u_prev = torch.zeros((), dtype=F32, device=dev)
    warm = init_warm(plan, device=dev)
    socs, cmds, tgts = [], [], []
    for k in range(n_steps):
        idle_left = torch.clamp(idle - float(k) * cfg.dt, min=0.0)
        s_target = select_target(cfg, ess, idle_left)
        out, warm2 = inner_loop_step_plan(
            cfg, ess, plan, soc, s_target, u_prev,
            warm if warm_start else None, qp_iters=qp_iters,
        )
        p_batt = out.corrective_power + drift
        charge = torch.clamp(p_batt, min=0.0)
        discharge = torch.clamp(-p_batt, min=0.0)
        soc = soc + (cfg.dt / ess.q_max) * (ess.eta_c * charge - discharge / ess.eta_d)
        soc = torch.clamp(soc, ess.soc_safe_min, ess.soc_safe_max)
        u_prev = out.corrective_power / cfg.i_max
        warm = warm2
        socs.append(soc)
        cmds.append(out.corrective_power)
        tgts.append(s_target)
    return {"soc": torch.stack(socs), "command": torch.stack(cmds), "target": torch.stack(tgts)}
