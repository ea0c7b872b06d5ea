"""Parity of the port's kernel plain versions with the JAX package.

Same numpy inputs (seeded) go through ``repro.kernels.ops`` — both its jnp
reference (``force="ref"``) and the Pallas kernel in interpret mode
(``force="pallas"``) — and through ``repro_torch.kernels.ops`` on the CPU,
which runs the plain PyTorch versions the CUDA kernels are held against
on the card.  Tolerances and their reasons:

* pdu_health_sim: SoC path, ESS filter value, SoC final, the six wear
  carries and the charge/discharge throughput sums are bitwise (the plain
  version evaluates the expression tree XLA compiles, fused multiply-adds
  included).  Grid and LC state are bitwise against the Pallas kernel and
  within 1e-6 of the jnp reference, whose scan contracts a few LC
  mul-adds differently.  The SoC and SoC^2 block sums are torch
  reductions in another summation order than XLA's: within 8 ulp of the
  sum.
* admm_iterate: the products are summed in another order than XLA's
  dot, so the iterates agree to 2e-5 after 30 iterations — the
  reference's own Pallas-vs-ref envelope (EXPERIMENTS §Perf-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as jctrl, health as jhlt, pdu as jpdu
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)
HZ = 200.0


def _bitwise(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    assert np.array_equal(a, b), f"{what} must be bitwise ({np.sum(a != b)} differ)"


def _ulps(a, b, n, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    tol = n * np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert np.all(np.abs(a.astype(np.float64) - b) <= tol), what


def _inputs(t, r, seed):
    """Seeded numpy inputs of one controller interval."""
    rng = np.random.default_rng(seed)
    steps = rng.choice([0.15, 0.6, 0.95], size=(t // 20 + 2, r))
    rack = np.repeat(steps, 20, axis=0)[:t] + 0.01 * rng.standard_normal((t, r))
    rack = np.clip(rack, 0.0, 1.0).astype(np.float32)
    cfg = jpdu.make_pdu(sample_dt=1.0 / HZ, track_health=True)
    st = jpdu.init_state(cfg, jnp.asarray(rack[0]))
    filt = st.filter_obj
    soc0 = rng.uniform(0.2, 0.8, r).astype(np.float32)
    # Near the window edges for a few racks, so the clamp and back-off run.
    soc0[: max(r // 8, 1)] = np.float32(0.89995)
    g0 = (rack[0] + 0.05 * rng.standard_normal(r)).astype(np.float32)
    health = {
        "prev_soc": soc0,
        "last_ext": (soc0 + rng.uniform(-0.05, 0.05, r)).astype(np.float32),
        "direction": rng.choice([-1.0, 0.0, 1.0], r).astype(np.float32),
        "half_cycles": rng.integers(0, 9, r).astype(np.float32),
        "cycle_damage": rng.uniform(0, 1e-3, r).astype(np.float32),
        "max_dod": rng.uniform(0, 0.1, r).astype(np.float32),
        "charge_soc": rng.uniform(0, 0.1, r).astype(np.float32),
        "discharge_soc": rng.uniform(0, 0.1, r).astype(np.float32),
        "soc_sum": rng.uniform(0, 50, r).astype(np.float32),
        "soc_sq_sum": rng.uniform(0, 20, r).astype(np.float32),
        "samples": rng.integers(0, 500, r).astype(np.int32),
    }
    ep = cfg.ess_params
    kw = dict(
        beta=float(ep.beta), dt=1.0 / HZ, q_max=float(ep.q_max),
        eta_c=float(ep.eta_c), eta_d=float(ep.eta_d), p_max=float(ep.p_max),
        soc_min=float(ep.soc_safe_min), soc_max=float(ep.soc_safe_max),
    )
    args = (rack, g0, soc0, np.asarray(st.filter_state), np.asarray(filt.ad),
            np.asarray(filt.bd), np.asarray(filt.c[0]))
    slew = (rng.uniform(-5e-3, 5e-3, r).astype(np.float32),
            rng.uniform(-5e-3, 5e-3, r).astype(np.float32))
    corrective = rng.uniform(-5e-3, 5e-3, (t, r)).astype(np.float32)
    return args, kw, slew, corrective, jhlt.step_consts(cfg.health), health


# (T, R, health, slew): both interval lengths (203 is ragged for the Pallas
# sublane tiling), one rack / a narrow / a multi-tile batch, both command
# forms, with and without the wear fold.
CASES = [
    (200, 40, True, True),
    (203, 130, True, True),
    (200, 1, False, True),
    (203, 40, True, False),
    (200, 130, False, False),
    (203, 1, True, False),
]


@pytest.mark.parametrize("t,r,with_health,with_slew", CASES)
def test_pdu_health_sim_matches_jax(t, r, with_health, with_slew):
    args, kw, slew, corrective, hconsts, hstate = _inputs(t, r, seed=t * 1000 + r)
    leaves = tuple(hstate[f] for f in jhlt.HealthState._fields)
    cmd = dict(slew=slew) if with_slew else dict(corrective=corrective)
    port = tops.pdu_health_sim(
        *(torch.from_numpy(np.array(a)) for a in args),
        health=(hconsts, tuple(torch.from_numpy(l) for l in leaves)) if with_health else None,
        **{k: (tuple(torch.from_numpy(x) for x in v) if isinstance(v, tuple)
               else torch.from_numpy(v)) for k, v in cmd.items()},
        **kw,
    )
    for force in ("ref", "pallas"):
        ref = jops.pdu_health_sim(
            *(jnp.asarray(a) for a in args),
            health=(hconsts, tuple(jnp.asarray(l) for l in leaves)) if with_health else None,
            **{k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
                   else jnp.asarray(v)) for k, v in cmd.items()},
            force=force, **kw,
        )
        grid_r, soc_r, (g_r, socf_r, x_r), h_r = ref
        grid_p, soc_p, (g_p, socf_p, x_p), h_p = port
        _bitwise(soc_r, soc_p, f"{force}: SoC path")
        _bitwise(g_r, g_p, f"{force}: ESS filter final")
        _bitwise(socf_r, socf_p, f"{force}: SoC final")
        if force == "pallas":
            _bitwise(grid_r, grid_p, "pallas: grid")
            _bitwise(x_r, x_p, "pallas: LC state")
        else:
            np.testing.assert_allclose(np.asarray(grid_p), np.asarray(grid_r), rtol=0, atol=1e-6)
            np.testing.assert_allclose(np.asarray(x_p), np.asarray(x_r), rtol=0, atol=1e-6)
        if not with_health:
            assert h_r is None and h_p is None
            continue
        for i, name in enumerate(jhlt.HealthState._fields):
            if name in ("soc_sum", "soc_sq_sum"):
                _ulps(h_r[i], h_p[i], 8, f"{force}: {name}")
            else:
                _bitwise(h_r[i], h_p[i], f"{force}: health leaf {name}")


def _admm_inputs(r, seed):
    """A JAX plan carried across plus seeded state-dependent QP terms."""
    rng = np.random.default_rng(seed)
    cfg = jpdu.make_pdu(sample_dt=1.0 / HZ)
    plan = jctrl.make_plan(cfg.controller, cfg.ess_params)
    shape = (r,) if r else ()
    soc = jnp.asarray(rng.uniform(0.2, 0.85, shape).astype(np.float32))
    tgt = jnp.asarray(np.float32(0.5))
    up = jnp.asarray(rng.uniform(-1, 1, shape).astype(np.float32))
    q, lo, hi = jctrl._qp_state_terms(plan, soc, tgt, up)
    h = plan.horizon
    kq = plan.kkt_inv @ q
    kkt_stack = jnp.concatenate([plan.kkt_inv_sigma, plan.kkt_inv_at], axis=1)
    lead = lambda n: (n,) + shape
    x0 = rng.uniform(0, 5e-3, lead(2 * h)).astype(np.float32)
    z0 = rng.uniform(-1e-2, 1e-2, lead(3 * h)).astype(np.float32)
    y0 = rng.uniform(-0.1, 0.1, lead(3 * h)).astype(np.float32)
    return [np.asarray(a) for a in (kkt_stack, plan.a_mat[2 * h:], kq, lo, hi, x0, z0, y0)], plan.rho


@pytest.mark.parametrize("iters", [1, 30])
@pytest.mark.parametrize("r", [40, 0])  # 0: an unbatched (1-D) solve
def test_admm_iterate_matches_jax(iters, r):
    args, rho = _admm_inputs(r, seed=iters + r)
    port = tops.admm_iterate(*(torch.from_numpy(np.array(a)) for a in args), rho=rho, iters=iters)
    for force in ("ref", "pallas"):
        ref = jops.admm_iterate(*(jnp.asarray(a) for a in args), rho=rho, iters=iters, force=force)
        for name, a, b in zip("xzy", ref, port):
            assert b.shape == a.shape, name
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("kappa,eps", [(1.0, 0.0), (3.0, 1e-6), (2.5, 1e-6)])
def test_pdu_health_wear_model_variants(kappa, eps):
    """Other Wöhler exponents and a rest hysteresis: integer kappa folds by
    repeated multiplication (bitwise); a fractional kappa goes through
    ``pow``, whose float32 rounding differs between XLA and PyTorch
    (cycle damage to 1e-6 relative)."""
    args, kw, slew, _, (c0, c1, _, _), hstate = _inputs(200, 40, seed=7)
    hconsts = (c0, c1, eps, kappa)
    leaves = tuple(hstate[f] for f in jhlt.HealthState._fields)
    port = tops.pdu_health_sim(
        *(torch.from_numpy(np.array(a)) for a in args),
        slew=tuple(torch.from_numpy(x) for x in slew),
        health=(hconsts, tuple(torch.from_numpy(l) for l in leaves)), **kw)
    ref = jops.pdu_health_sim(
        *(jnp.asarray(a) for a in args), slew=tuple(jnp.asarray(x) for x in slew),
        health=(hconsts, tuple(jnp.asarray(l) for l in leaves)), force="ref", **kw)
    for i, name in enumerate(jhlt.HealthState._fields[:8]):
        if name == "cycle_damage" and not kappa.is_integer():
            np.testing.assert_allclose(port[3][i].numpy(), np.asarray(ref[3][i]), rtol=1e-6)
        else:
            _bitwise(ref[3][i], port[3][i], f"kappa={kappa}: {name}")
