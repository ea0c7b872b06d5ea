"""Plain PyTorch versions of the port's CUDA kernels.

These are the functions the CUDA kernels are held against on the card
(``chip_smoke.py``) and what ``ops`` runs for tensors on the CPU.  They are
also the port's bridge to the JAX reference: on identical inputs they
reproduce ``repro.kernels.ref`` as XLA:CPU evaluates it (tests).

Evaluation order.  XLA does two things to the reference's expressions
that an eager framework does not: its algebraic simplifier turns every
division by a compile-time constant into a multiply by the float32
reciprocal (folding constant chains such as ``q_max / (eta_c * dt)`` into
one constant), and LLVM contracts each multiply feeding an add into a
fused multiply-add.  ``hw_consts`` computes the folded constants and
``fma`` reproduces a single-rounding fused multiply-add (float64 product
and sum, one rounding to float32 — exact for the products, and equal to a
true FMA except in double-rounding ties, which occur with probability
~2^-29 per operation).  The CUDA kernel evaluates the same expression tree
with ``__fmaf_rn`` at the same places and ``-fmad=false`` everywhere else,
so kernel and plain version agree bit for bit on the card.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

F32 = torch.float32


def fma(a, b, c) -> torch.Tensor:
    """``round_f32(a * b + c)`` with one rounding (see module docstring).
    Operands are float32 (or their exact float64 copies) tensors or Python
    floats holding float32 values."""
    d = lambda v: v.to(torch.float64) if isinstance(v, torch.Tensor) else float(v)
    return (d(a) * d(b) + d(c)).to(F32)


def _f(v) -> float:
    """Round a host number to float32 and return it as a Python float."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class HwConsts:
    """Float32 scalars of one ``pdu_health_sim`` step, as the reference's
    compiled program holds them (every value is exactly a float32)."""

    alpha: float  # 1 - exp(-beta dt), the ESS ramp-filter gain
    k_soc: float  # dt / q_max, rounded once from the host double
    eta_c: float
    inv_eta_d: float  # 1 / eta_d in float32
    p_max: float
    soc_min: float
    soc_max: float
    bo_hi: float  # q_max / (eta_c dt): SoC overshoot -> battery power back-off
    bo_lo: float  # q_max eta_d / dt: SoC undershoot -> battery power back-off


def hw_consts(*, beta, dt, q_max, eta_c, eta_d, p_max, soc_min, soc_max) -> HwConsts:
    f32 = np.float32
    # alpha: float32 product, exp, float32 subtract — the reference's own
    # expression (``1 - exp(-f32(beta) * dt)``); one ulp of alpha drifts
    # the whole grid/LC path, so both the kernel and this plain version
    # take this one value.
    x = f32(-f32(beta) * f32(dt))
    alpha = f32(f32(1.0) - f32(math.exp(float(x))))
    inv_ecdt = f32(1.0) / f32(eta_c * dt)
    inv_dt = f32(1.0) / f32(dt)
    return HwConsts(
        alpha=float(alpha),
        k_soc=_f(dt / q_max),
        eta_c=_f(eta_c),
        inv_eta_d=float(f32(1.0) / f32(eta_d)),
        p_max=_f(p_max),
        soc_min=_f(soc_min),
        soc_max=_f(soc_max),
        bo_hi=float(f32(q_max) * inv_ecdt),
        bo_lo=float(f32(f32(q_max) * f32(eta_d)) * inv_dt),
    )


def host(x) -> np.ndarray:
    """A tensor or array as a float32 host array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def lc_consts(ad, bd, c_row) -> tuple[tuple[float, ...], ...]:
    """``(a (9,), b_load (3,), b_vin (3,), c (3,))`` as host floats, from
    tensors or host arrays."""
    ad, bd, c_row = host(ad), host(bd), host(c_row)
    a = tuple(float(v) for v in ad.reshape(-1))
    bl = tuple(float(v) for v in bd[:, 1])
    bv = tuple(float(v) for v in bd[:, 0])
    c = tuple(float(v) for v in c_row.reshape(-1))
    return a, bl, bv, c


def health_step_consts(consts) -> tuple[float, float, float, float]:
    """``(c0, c1, eps, kappa)`` of ``health.step_consts`` with the first
    three rounded to the float32 the step arithmetic uses."""
    c0, c1, eps, kappa = consts
    return _f(c0), _f(c1), _f(eps), float(kappa)


def pow_depth(depth: torch.Tensor, kappa: float) -> torch.Tensor:
    """``depth ** kappa``, by repeated multiplication for integer kappa in
    [2, 4] exactly as the reference evaluates it."""
    if kappa == 1.0:
        return depth
    if kappa.is_integer() and 2 <= int(kappa) <= 4:
        out = depth
        for _ in range(int(kappa) - 1):
            out = out * depth
        return out
    return torch.pow(depth, kappa)


# ------------------------------------------------------------- pdu_health_sim


def pdu_health_sim(
    rack_power: torch.Tensor,  # (T, R)
    g0: torch.Tensor,  # (R,)
    soc0: torch.Tensor,  # (R,)
    x0: torch.Tensor,  # (R, 3)
    ad,  # (3, 3) LC state matrix (tensor or host array)
    bd,  # (3, 2)
    c_row,  # (3,)
    *,
    beta: float,
    dt: float,
    q_max: float,
    eta_c: float,
    eta_d: float,
    p_max: float,
    soc_min: float,
    soc_max: float,
    corrective: torch.Tensor | float = 0.0,
    slew: tuple[torch.Tensor, torch.Tensor] | None = None,
    health: tuple | None = None,
):
    """One controller interval of the rack hardware path, per rack, time
    sequential: ESS ramp filter, battery power, SoC integration with the
    window clamp and its power back-off, the 3-state LC filter, the command
    slew ``applied + (target - applied) (t+1)/T`` (``slew``) or a dense
    ``(T, R)`` corrective profile, and with ``health=(step_consts,
    state_leaves)`` the battery-wear turning-point machine plus the block
    throughput/stress sums.  Same contract as ``repro.kernels.ref.
    pdu_health_sim``.  Returns ``(grid, soc_t, (g_f, soc_f, x_f),
    health_leaves_or_None)``."""
    k = hw_consts(
        beta=beta, dt=dt, q_max=q_max, eta_c=eta_c, eta_d=eta_d,
        p_max=p_max, soc_min=soc_min, soc_max=soc_max,
    )
    a, bl, bv, c = lc_consts(ad, bd, c_row)
    t_len, r = rack_power.shape
    rack_power = rack_power.to(F32)
    f64 = torch.float64
    if slew is not None:
        applied = slew[0].to(F32).expand(r)
        diff = slew[1].to(F32).expand(r) - applied
        # The slewed command of every sample, rendered at once: elementwise
        # the same fused expression the kernel evaluates per step.
        inv_t = float(np.float32(1.0) / np.float32(t_len))
        ramp = torch.tensor([_ramp(t, inv_t) for t in range(t_len)], dtype=F32,
                            device=rack_power.device)
        corr = fma(diff[None, :], ramp[:, None], applied[None, :])
    else:
        corr = torch.as_tensor(corrective, dtype=F32, device=rack_power.device)
        corr = corr.expand(t_len, r)
    grid = torch.empty_like(rack_power)
    soc_t = torch.empty_like(rack_power)
    g, soc = g0.to(F32).expand(r), soc0.to(F32).expand(r)
    s0, s1, s2 = (x0[:, i].to(F32) for i in range(3))
    if health is not None:
        c0, c1, eps, kappa = health_step_consts(health[0])
        prev, last_ext, dirn, half, dmg, mdod = (
            leaf.to(F32).expand(r) for leaf in health[1][:6]
        )
    for t in range(t_len):
        r_t = rack_power[t]
        c_t = corr[t]
        g_new = fma(k.alpha, r_t - g, g)
        p = torch.clamp(g_new - r_t + c_t, -k.p_max, k.p_max)
        charge = torch.clamp(p, min=0.0)
        discharge = torch.clamp(-p, min=0.0)
        soc_new = fma(k.k_soc, fma(k.eta_c, charge, -(discharge * k.inv_eta_d)), soc)
        over_hi = torch.clamp(soc_new - k.soc_max, min=0.0)
        over_lo = torch.clamp(k.soc_min - soc_new, min=0.0)
        p = fma(over_lo, k.bo_lo, fma(-over_hi, k.bo_hi, p))
        soc_new = torch.clamp(soc_new, k.soc_min, k.soc_max)
        node = (r_t + p).to(f64)
        d0, d2 = s0.to(f64), s2.to(f64)
        grid[t] = fma(c[2], d2, fma(c[0], d0, c[1] * s1))
        soc_t[t] = soc_new
        n0 = fma(bl[0], node, fma(a[2], d2, fma(a[0], d0, a[1] * s1))) + bv[0]
        n1 = fma(bl[1], node, fma(a[5], d2, fma(a[3], d0, a[4] * s1))) + bv[1]
        n2 = fma(bl[2], node, fma(a[8], d2, fma(a[6], d0, a[7] * s1))) + bv[2]
        if health is not None:
            delta = soc_new - prev
            sd = torch.where(delta > eps, 1.0, torch.where(delta < -eps, -1.0, 0.0))
            rev = (sd * dirn) < 0.0
            revf = rev.to(F32)
            depth = torch.abs(prev - last_ext)
            half_w = torch.clamp(fma(c1, prev + last_ext, c0), min=0.0)
            dmg = dmg + revf * (half_w * pow_depth(depth, kappa))
            mdod = torch.maximum(mdod, revf * depth)
            last_ext = torch.where(rev, prev, last_ext)
            dirn = torch.where(sd != 0.0, sd, dirn)
            half = half + revf
            prev = soc_new
        g, soc, s0, s1, s2 = g_new, soc_new, n0, n1, n2
    finals = (g, soc, torch.stack([s0, s1, s2], dim=-1))
    if health is None:
        return grid, soc_t, finals, None
    return grid, soc_t, finals, (prev, last_ext, dirn, half, dmg, mdod) + block_sums(
        soc_t, health[1]
    )


def _ramp(t: int, inv_t: float) -> float:
    """Slew fraction of sample ``t``: ``f32(t + 1) * f32(1 / T)`` (the
    reference's ``(t + 1) / T`` after constant-division folding)."""
    return float(np.float32(np.float32(t + 1) * np.float32(inv_t)))


def block_sums(soc_t: torch.Tensor, state) -> tuple:
    """The health fold's whole-interval block reductions (charge/discharge
    throughput, SoC and SoC^2 sums, sample count) over one interval's SoC
    path, at the reference's (t, r) reduce shape.  Shared by the kernel
    wrapper's epilogue and the plain version."""
    t_len, r = soc_t.shape
    prev_t = torch.cat([state[0].to(F32).expand(r)[None], soc_t[:-1]], dim=0)
    delta = soc_t - prev_t
    return (
        state[6] + torch.sum(torch.clamp(delta, min=0.0), dim=0),
        state[7] + torch.sum(torch.clamp(-delta, min=0.0), dim=0),
        state[8] + torch.sum(soc_t, dim=0),
        state[9] + torch.sum(soc_t * soc_t, dim=0),
        state[10].expand(r) + t_len,
    )


# -------------------------------------------------------------- admm_iterate


def admm_iterate(
    kkt_stack: torch.Tensor,  # (2h, 5h) [sigma K^-1 | K^-1 A'] stacked
    g_blk: torch.Tensor,  # (h, 2h) SoC-constraint rows of A (A = [I; G])
    kq: torch.Tensor,  # (2h, R) hoisted K^-1 q
    lo: torch.Tensor,  # (3h, R)
    hi: torch.Tensor,
    x0: torch.Tensor,  # (2h, R)
    z0: torch.Tensor,  # (3h, R)
    y0: torch.Tensor,  # (3h, R)
    *,
    rho: float,
    iters: int,
):
    """``iters`` fused OSQP-style ADMM steps on the rack-batched controller
    QP (see ``repro.kernels.ref.admm_iterate``):
    ``x = kkt_stack [x; rho z - y] - kq``, ``Ax = [x; G x]``,
    ``z = clip(Ax + y / rho, lo, hi)``, ``y += rho (Ax - z)``."""
    rho_t = torch.tensor(rho, dtype=F32, device=kq.device)
    x, z, y = x0, z0, y0
    for _ in range(iters):
        x_new = kkt_stack @ torch.cat([x, rho_t * z - y], dim=0) - kq
        ax = torch.cat([x_new, g_blk @ x_new], dim=0)
        # y / rho as a tensor division (not a reciprocal multiply): the
        # clip boundaries amplify the ulp over the loop.
        z_new = torch.clamp(ax + torch.div(y, rho_t), lo, hi)
        y = y + rho_t * (ax - z_new)
        x, z = x_new, z_new
    return x, z, y


# ------------------------------------------------------------------- rmsnorm


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, ``x * w / rms(x)`` (see
    ``repro.kernels.ref.rmsnorm``): statistics in float32, the result cast
    back to ``x.dtype`` once."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.to(F32)).to(x.dtype)


# ----------------------------------------------------- flash attention (fwd)

NEG_INF = -1e30  # the reference's mask value (not -inf: masked rows stay finite)


def attention(
    q: torch.Tensor,  # (B, H, Tq, D)
    k: torch.Tensor,  # (B, Hkv, Tk, D)
    v: torch.Tensor,  # (B, Hkv, Tk, D)
    *,
    causal: bool = True,
    scale: float | None = None,
    with_lse: bool = False,
):
    """Softmax attention with GQA (see ``repro.kernels.ref.attention``):
    query head ``h`` uses KV head ``h // (H // Hkv)``; with ``causal`` the
    query ``i`` sits at absolute position ``i + Tk - Tq`` (aligned to the
    end of the KV sequence) and masked logits are set to -1e30.  The
    products run in the input type, as the reference's einsums do (a bf16
    input rounds the logits to bf16 before the float32 softmax, and the
    probabilities to bf16 before the second product).

    ``with_lse=True`` also returns the row log-sum-exp of the scaled,
    masked float32 logits, ``(B, H, Tq)``: the flash kernel's second
    output."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d**0.5)
    groups = h // hkv
    kx = k.repeat_interleave(groups, dim=1)
    vx = v.repeat_interleave(groups, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kx).to(F32) * scale
    if causal:
        rows = torch.arange(tq, device=q.device) + (tk - tq)
        mask = torch.arange(tk, device=q.device)[None, :] <= rows[:, None]
        logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), vx)
    if with_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


# ---------------------------------------------------- flash attention (bwd)


def flash_attention_bwd(
    q: torch.Tensor,  # (B, H, Tq, D)
    k: torch.Tensor,  # (B, Hkv, Tk, D)
    v: torch.Tensor,  # (B, Hkv, Tk, D)
    o: torch.Tensor,  # (B, H, Tq, D)
    lse: torch.Tensor,  # (B, H, Tq) float32
    do: torch.Tensor,  # (B, H, Tq, D)
    *,
    causal: bool = True,
    scale: float | None = None,
    delta: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense log-sum-exp backward of flash attention, ``(dq, dk, dv)``: the
    math the two backward kernels evaluate, as in
    ``repro.kernels.flash_attention._bwd_reference`` (``p`` recomputed from
    the saved ``lse``, ``delta = sum(do * o)`` in float32, everything in
    float32, each gradient rounded once to its input's type).  It also
    takes the GQA head-group sum that the reference gets from the VJP of
    ``jnp.repeat`` outside its custom-vjp: here the group's dK/dV are
    summed in float32 before the one rounding, as the kernel does (the
    reference rounds each query head's share first).  A given ``delta``
    (B, H, Tq) stands in for ``sum(do * o)``, as the kernels take it."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d**0.5)
    groups = h // hkv
    kx = k.to(F32).repeat_interleave(groups, dim=1)
    vx = v.to(F32).repeat_interleave(groups, dim=1)
    qf, dof = q.to(F32), do.to(F32)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kx) * scale
    if causal:
        rows = torch.arange(tq, device=q.device) + (tk - tq)
        mask = torch.arange(tk, device=q.device)[None, :] <= rows[:, None]
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vx)
    if delta is None:
        delta = torch.sum(dof * o.to(F32), dim=-1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    group_sum = lambda t: t.reshape(b, hkv, groups, tk, d).sum(dim=2)
    return dq.to(q.dtype), group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


# ----------------------------------------------------------------- rwkv6 scan


def rwkv6_scan(
    r: torch.Tensor,  # (B, H, T, D) receptance
    k: torch.Tensor,  # (B, H, T, D) key
    v: torch.Tensor,  # (B, H, T, D) value
    w: torch.Tensor,  # (B, H, T, D) per-channel decay in (0, 1)
    u: torch.Tensor,  # (H, D) bonus of the current token
    state0: torch.Tensor | None = None,  # (B, H, D, D) float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 (Finch) time-mix recurrence, step by step (see
    ``repro.kernels.ref.rwkv6_scan``):

        o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(w_t) S_{t-1} + k_t^T v_t

    Inputs are widened to float32 and the state stays float32; returns
    ``(o (B, H, T, D) in r's type, S_T (B, H, D, D) float32)``.  The
    reference's chunked remat stores fewer states for autodiff and changes
    no number, so it is not carried over."""
    b, h, t, d = r.shape
    s = (torch.zeros((b, h, d, d), dtype=F32, device=r.device) if state0 is None
         else state0.to(F32))
    rf, kf, vf, wf = (a.to(F32) for a in (r, k, v, w))
    uf = u.to(F32)[None, :, :, None]
    outs = []
    for i in range(t):
        kv = kf[:, :, i, :, None] * vf[:, :, i, None, :]  # (B, H, D, D)
        outs.append(torch.einsum("bhd,bhde->bhe", rf[:, :, i], s + uf * kv))
        s = wf[:, :, i, :, None] * s + kv
    out = torch.stack(outs, dim=2) if outs else rf.new_zeros((b, h, 0, d))
    return out.to(r.dtype), s


def rwkv6_chunked(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state0: torch.Tensor | None = None,
    *,
    chunk: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunk-parallel form of ``rwkv6_scan`` (see
    ``repro.kernels.ref.rwkv6_chunked``): within a chunk of ``chunk``
    tokens, with ``W_t`` the running product of the decays,

        A[t, s] = (r_t W_{t-1}) . (k_s / W_s)   for s < t
        o_t     = tril(A, -1) v + (r_t u k_t) v_t + (r_t W_{t-1}) S_in
        S_out   = diag(W_L) S_in + (k_s W_L / W_s)^T v

    with the log-decay exponents clamped to +-40 (the reference's guard
    against float32 overflow under extreme decays, which makes the result
    inexact once a chunk's total decay falls below e^-40).  Falls back to
    the sequential scan when ``T`` is not a multiple of ``chunk`` or is at
    most one chunk, as the reference does."""
    b, h, t, d = r.shape
    if state0 is None:
        state0 = torch.zeros((b, h, d, d), dtype=F32, device=r.device)
    if t % chunk != 0 or t <= chunk:
        return rwkv6_scan(r, k, v, w, u, state0)
    nc = t // chunk
    shp = (b, h, nc, chunk, d)
    rc, kc, vc = (a.to(F32).reshape(shp) for a in (r, k, v))
    lw = torch.log(torch.clamp(w.to(F32), min=1e-30)).reshape(shp)
    cum = torch.cumsum(lw, dim=3)  # inclusive
    cum_prev = cum - lw  # exclusive: W_{t-1}
    total = cum[:, :, :, -1:, :]  # log W_L
    clamp = 40.0
    r_tilde = rc * torch.exp(torch.clamp(cum_prev, -clamp, clamp))
    k_tilde = kc * torch.exp(torch.clamp(-cum, -clamp, clamp))
    k_tail = kc * torch.exp(torch.clamp(total - cum, -clamp, clamp))
    a_mat = torch.einsum("bhctd,bhcsd->bhcts", r_tilde, k_tilde)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)
    a_mat = torch.where(mask, a_mat, 0.0)
    o_intra = torch.einsum("bhcts,bhcsd->bhctd", a_mat, vc)
    o_diag = torch.einsum("bhctd,bhctd->bhct", rc * u.to(F32)[None, :, None, None, :],
                          kc)[..., None] * vc
    s_add = torch.einsum("bhcsd,bhcse->bhcde", k_tail, vc)  # (B, H, nc, D, D)
    w_chunk = torch.exp(total[:, :, :, 0, :])  # (B, H, nc, D)
    s = state0.to(F32)
    o_inter = []
    for c in range(nc):
        o_inter.append(torch.einsum("bhtd,bhde->bhte", r_tilde[:, :, c], s))
        s = w_chunk[:, :, c, :, None] * s + s_add[:, :, c]
    out = (o_intra + o_diag + torch.stack(o_inter, dim=2)).reshape(b, h, t, d)
    return out.to(r.dtype), s
