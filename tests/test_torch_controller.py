"""Parity of the port's per-step controller oracle and the paper-figure
helpers with the JAX package: ``_build_qp``, ``solve_qp_admm``,
``inner_loop_step``, ``simulate_soc_management`` (Fig. 12),
``pdu.condition(use_plan=False)`` (clean, batched and degraded),
``fleet.condition(engine="oneshot", use_plan=False)``, ``staggered_fleet``,
``synchronous_aggregate``, ``violation_fraction``, the trace helpers and
their golden oracles, and ``scenario_from_model``.  The port's own plan is
pinned against its own oracle as the reference pins its plan.

Tolerances and their reasons:

* ``_build_qp``: P, A, lo and hi bitwise (the same float32 expression
  tree); q within 1e-6 of its largest entry (a matrix-vector sum in
  another order; measured 7.7e-8, one ulp).
* ``solve_qp_admm`` after 120 iterations (LAPACK's float32 Cholesky and
  triangular solves through PyTorch against XLA's): x within 1e-6
  (measured 3.6e-8; the reference's own oracle-vs-plan bound is 1e-5),
  the primal residual within 1e-6 (measured 1.3e-8).  The dual residual
  ``|P x + q + A'y|`` is float32 noise: terms of ~85 (P's entries reach
  1.7e4) cancel to ~3e-5, a few ulps of the terms: within 1e-4 (measured
  2.2e-5).
* ``inner_loop_step`` commands: 1e-7 (x's differences; measured ~3e-8).
* The port's plan against its own oracle: the reference's bounds
  (``tests/test_controller_plan.py``): P 1e-6, A/lo/hi 1e-7, q 1e-5, x and
  the primal residual 1e-5.
* Fig. 12: ``chip_smoke.FIG12_SOC_TOL`` on the SoC trajectory (the same
  bound the card holds the admm_step kernel to against its plain version),
  commands 1e-7, targets exactly, and the convergence step exactly.
* ``pdu.condition(use_plan=False)`` and the one-shot engine: the grid at
  the reference's 1e-5 envelope for LC outputs on ragged intervals (XLA's
  scan contracts LC multiply-adds differently; measured 2.9e-6), SoC 1e-6
  (measured 0), commands and residuals 1e-7 (measured ~3e-9 and ~5e-9);
  ``use_plan=False`` against the plan's path within 1e-3, the reference's
  own cold/warm bound.
* ``staggered_fleet``'s roll and scale at JAX's drawn offsets and scales,
  ``synchronous_aggregate`` and the numpy phase timeline oracle: bitwise.
  ``violation_fraction``: the same violating steps; XLA divides their
  count by a reciprocal multiply, so the fraction is within one ulp.  ``phase_timeline_trace`` and
  ``scenario_from_model``: the scenario renderer's 1e-6
  (``test_torch_scenario``).  ``testbench_trace_reference``: its boxcar
  edges sum a window in another order than XLA's convolution, 1e-6
  (measured 1.2e-7).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compliance as jcomp, controller as jctrl, ess as jess, fleet as jfleet, \
    pdu as jpdu
from repro.power import scenario as JSC, trace as JTR
from repro_torch import convert
from repro_torch.core import compliance as tcomp, controller as tctrl, ess as tess, \
    fleet as tfleet, pdu as tpdu
from repro_torch.power import scenario as TSC, trace as TTR

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
CASES = [(0.62, 0.5, 0.0), (0.35, 0.5, 0.4), (0.88, 0.45, -1.0)]


def _close(a, b, atol, what, rtol=0.0):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=what)


def _equal(a, b, what):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=what)


@pytest.fixture(scope="module")
def ctrl_cfgs():
    """The controller and ESS of ``tests/test_controller_plan.py`` in both
    packages (their float32 leaves are equal bit for bit)."""
    jc, je = jctrl.ControllerConfig.create(), jess.ESSParams.create(q_max_seconds=40.0)
    tc = tctrl.ControllerConfig.create(device="cpu")
    te = tess.ESSParams.create(q_max_seconds=40.0, device="cpu")
    return jc, je, tc, te


def _qp_both(ctrl_cfgs, soc, tgt, up):
    jc, je, tc, te = ctrl_cfgs
    j = jctrl._build_qp(jc, je, jnp.asarray(soc, jnp.float32), jnp.asarray(tgt, jnp.float32),
                        jnp.asarray(up, jnp.float32))
    t = tctrl._build_qp(tc, te, torch.as_tensor(soc, dtype=torch.float32),
                        torch.as_tensor(tgt, dtype=torch.float32),
                        torch.as_tensor(up, dtype=torch.float32))
    return j, t


def _assert_qp(j, t):
    for name, a, b in zip(("P", "q", "A", "lo", "hi"), t, j):
        assert tuple(a.shape) == np.shape(b), name
        if name == "q":
            _close(a, b, 1e-6 * float(np.max(np.abs(np.asarray(b)))), name)
        else:
            _equal(a, b, name)


# ----------------------------------------------------------- the oracle


@pytest.mark.parametrize("soc,tgt,up", CASES)
def test_build_qp_matches_jax(ctrl_cfgs, soc, tgt, up):
    _assert_qp(*_qp_both(ctrl_cfgs, soc, tgt, up))


def test_build_qp_batched_matches_vmapped_jax(ctrl_cfgs):
    """A (2, 3) batch of states (the target broadcast along the first axis)
    against the reference's doubly vmapped assembly."""
    jc, je, tc, te = ctrl_cfgs
    socs = np.array([[0.62, 0.35, 0.88], [0.2, 0.5, 0.7]], np.float32)
    tgts = np.array([0.5, 0.5, 0.45], np.float32)
    ups = np.array([[0.0, 0.4, -1.0], [0.3, 0.0, 0.1]], np.float32)
    build = jax.vmap(jax.vmap(lambda s, g, u: jctrl._build_qp(jc, je, s, g, u)),
                     in_axes=(0, None, 0))
    j = build(jnp.asarray(socs), jnp.asarray(tgts), jnp.asarray(ups))
    t = tctrl._build_qp(tc, te, torch.from_numpy(socs), torch.from_numpy(tgts),
                        torch.from_numpy(ups))
    _assert_qp(j, t)


@pytest.mark.parametrize("soc,tgt,up", CASES)
def test_solve_qp_admm_matches_jax(ctrl_cfgs, soc, tgt, up):
    j, t = _qp_both(ctrl_cfgs, soc, tgt, up)
    js = jctrl.solve_qp_admm(*j, iters=120)
    ts = tctrl.solve_qp_admm(*t, iters=120)
    _close(ts.x, js.x, 1e-6, "x")
    _close(ts.primal_residual, js.primal_residual, 1e-6, "primal residual")
    _close(ts.dual_residual, js.dual_residual, 1e-4, "dual residual")


def test_solve_qp_admm_batch_entries_equal_single_solves(ctrl_cfgs):
    """Each rack is factored and solved on its own: a batch entry's x and
    primal residual equal the unbatched solve of its QP bit for bit.  The
    dual residual's ``P x`` is a batched product in one case and a
    matrix-vector product in the other, summed in another order, and its
    terms (~85) cancel to ~3e-5, so ulps of them show: 1e-4, as above."""
    jc, je, tc, te = ctrl_cfgs
    socs = torch.tensor([c[0] for c in CASES])
    tgts = torch.tensor([c[1] for c in CASES])
    ups = torch.tensor([c[2] for c in CASES])
    qp = tctrl._build_qp(tc, te, socs, tgts, ups)
    batched = tctrl.solve_qp_admm(*qp, iters=120)
    for i in range(len(CASES)):
        one = tctrl.solve_qp_admm(*(a[i] for a in qp), iters=120)
        for name in ("x", "primal_residual"):
            assert torch.equal(getattr(batched, name)[i], getattr(one, name)), (i, name)
        _close(batched.dual_residual[i], one.dual_residual.numpy(), 1e-4, f"dual residual {i}")


def test_solve_qp_admm_raises_on_a_failed_factorization(ctrl_cfgs):
    jc, je, tc, te = ctrl_cfgs
    p, q, a, lo, hi = tctrl._build_qp(tc, te, torch.tensor([0.4, 0.5, 0.6]), torch.tensor(0.5),
                                      torch.zeros(3))
    p = p.clone()
    p[1] = -1e9 * torch.eye(p.shape[-1])  # not positive definite
    with pytest.raises(torch.linalg.LinAlgError, match=r"batch entry \(1,\)"):
        tctrl.solve_qp_admm(p, q, a, lo, hi, iters=5)


def test_inner_loop_step_matches_vmapped_jax(ctrl_cfgs):
    """Batched over racks, deadband and clip included (the 0.503 rack is
    inside the deadband, the 0.2 and 0.85 ones saturate), against the
    reference's ``jax.vmap(inner_loop_step)``."""
    jc, je, tc, te = ctrl_cfgs
    socs = np.array([0.2, 0.45, 0.503, 0.62, 0.85], np.float32)
    ups = np.array([0.0, 0.3, 0.0, -0.2, 0.9], np.float32)
    jout = jax.vmap(lambda s, u: jctrl.inner_loop_step(jc, je, s, jnp.float32(0.5), u,
                                                       qp_iters=120))(
        jnp.asarray(socs), jnp.asarray(ups))
    tout = tctrl.inner_loop_step(tc, te, torch.from_numpy(socs), torch.tensor(0.5),
                                 torch.from_numpy(ups), qp_iters=120)
    _close(tout.corrective_power, jout.corrective_power, 1e-7, "command")
    _equal(tout.in_deadband, jout.in_deadband, "deadband")
    _equal(tout.s_target, jout.s_target, "target")
    _close(tout.qp_primal_residual, jout.qp_primal_residual, 1e-6, "residual")
    assert bool(tout.in_deadband[2]) and float(tout.corrective_power[2]) == 0.0
    assert float(tout.corrective_power.abs().max()) == pytest.approx(float(tc.i_max))


# -------------------------------------------------- the port's plan vs oracle


@pytest.mark.parametrize("soc,tgt,up", CASES)
def test_port_plan_matches_port_build_qp(ctrl_cfgs, soc, tgt, up):
    """``make_plan`` + ``_qp_state_terms`` == ``_build_qp`` in the port."""
    _, _, tc, te = ctrl_cfgs
    plan = tctrl.make_plan(tc, te)
    s, g, u = (torch.tensor(v) for v in (soc, tgt, up))
    p, q, a, lo, hi = tctrl._build_qp(tc, te, s, g, u)
    q2, lo2, hi2 = tctrl._qp_state_terms(plan, s, g, u)
    _close(plan.p_mat, p.numpy(), 1e-6, "P")
    _close(plan.a_mat, a.numpy(), 1e-7, "A")
    _close(q2, q.numpy(), 1e-5, "q")
    _close(lo2, lo.numpy(), 1e-7, "lo")
    _close(hi2, hi.numpy(), 1e-7, "hi")


@pytest.mark.parametrize("soc,tgt,up", CASES)
def test_port_plan_solve_matches_port_oracle(ctrl_cfgs, soc, tgt, up):
    """The plan's solve (``admm_iterate``'s plain version here) == the
    per-step factor-and-solve, 120 iterations each."""
    _, _, tc, te = ctrl_cfgs
    plan = tctrl.make_plan(tc, te)
    s, g, u = (torch.tensor(v) for v in (soc, tgt, up))
    sol = tctrl.solve_qp_admm(*tctrl._build_qp(tc, te, s, g, u), iters=120)
    sol2, _ = tctrl.solve_qp_admm_plan(plan, *tctrl._qp_state_terms(plan, s, g, u), iters=120)
    _close(sol2.x, sol.x.numpy(), 1e-5, "x")
    _close(sol2.primal_residual, sol.primal_residual.numpy(), 1e-5, "primal residual")


def test_port_batched_plan_step_matches_port_oracle(ctrl_cfgs):
    """One (2h, R) plan solve == R per-rack oracle solves (the reference's
    ``test_batched_step_matches_vmapped_oracle``)."""
    _, _, tc, te = ctrl_cfgs
    plan = tctrl.make_plan(tc, te)
    socs = torch.tensor([0.2, 0.45, 0.62, 0.85])
    ups = torch.tensor([0.0, 0.3, -0.2, 0.9])
    want = tctrl.inner_loop_step(tc, te, socs, torch.tensor(0.5), ups, qp_iters=120)
    got, _ = tctrl.inner_loop_step_plan(tc, te, plan, socs, torch.tensor(0.5), ups, qp_iters=120)
    _close(got.corrective_power, want.corrective_power.numpy(), 1e-5, "command")


# ---------------------------------------------------------------- Fig. 12


@pytest.mark.parametrize("warm_start", [False, True])
def test_simulate_soc_management_fig12_matches_jax(warm_start):
    """Fig. 12's full configuration (``chip_smoke.FIG12``: 400 steps, 80
    iterations), cold as the paper's figure and warm-started."""
    f = chip_smoke.FIG12
    jc = jctrl.ControllerConfig.create(i_max=f["i_max"])
    je = jess.ESSParams.create(q_max_seconds=f["q_max_seconds"])
    tc = tctrl.ControllerConfig.create(i_max=f["i_max"], device="cpu")
    te = tess.ESSParams.create(q_max_seconds=f["q_max_seconds"], device="cpu")
    kw = dict(n_steps=f["n_steps"], qp_iters=f["qp_iters"], warm_start=warm_start)
    j = jctrl.simulate_soc_management(jc, je, f["soc0"], **kw)
    t = tctrl.simulate_soc_management(tc, te, f["soc0"], **kw)
    for name in ("soc", "command", "target"):
        assert tuple(t[name].shape) == (f["n_steps"],), name
    db = float(tc.deadband)
    js, ts = np.asarray(j["soc"]), t["soc"].numpy()
    hit_j, hit_t = chip_smoke.convergence_step(js, db), chip_smoke.convergence_step(ts, db)
    if hit_t != hit_j:
        k = min(i for i in (hit_t, hit_j) if i is not None)
        pytest.fail(f"convergence step {hit_t} vs JAX {hit_j}; margin |S - S*| - deadband at "
                    f"step {k}: port {abs(float(ts[k]) - 0.5) - db:.3e}, "
                    f"JAX {abs(float(js[k]) - 0.5) - db:.3e}")
    _close(ts, js, chip_smoke.FIG12_SOC_TOL, "soc")
    _close(t["command"], j["command"], 1e-7, "command")
    _equal(t["target"], j["target"], "target")
    if not warm_start:  # the paper's figure: into the deadband, inside the safe band
        assert hit_t is not None and abs(float(ts[-1]) - 0.5) <= db
        assert 0.1 <= ts.min() and ts.max() <= 0.9


# ------------------------------------------- pdu.condition(use_plan=False)


@pytest.fixture(scope="module")
def testbench():
    """The reference's 60 s x 250 Hz testbench (tests/test_controller_plan.py),
    rendered by JAX; and four racks of it staggered by JAX's draws."""
    sp = JTR.TestbenchSpec(duration_s=60.0, sample_hz=250.0, terminate_at_s=50.0)
    rack, dt = JTR.testbench_trace(sp, jax.random.key(11))
    racks = jfleet.staggered_fleet(rack, 4, jax.random.key(8), max_offset_samples=800,
                                   scale_jitter=0.05)
    return np.asarray(rack), np.asarray(racks), dt


def _condition_both(trace, dt, *, degraded=False, **kw):
    jcfg = jpdu.make_pdu(sample_dt=dt, degraded_mode=degraded)
    jst = jpdu.init_state(jcfg, jnp.asarray(trace[0]))
    j = jpdu.condition(jcfg, jst, jnp.asarray(trace), qp_iters=120, use_plan=False,
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    tcfg = convert.pdu_config_from_numpy(convert.numpy_tree(jcfg), device="cpu")
    tst = convert.pdu_state_from_numpy(convert.numpy_tree(jst), device="cpu")
    t = tpdu.condition(tcfg, tst, torch.from_numpy(np.array(trace)), qp_iters=120,
                       use_plan=False, **{k: torch.from_numpy(v) for k, v in kw.items()})
    return j, t, (tcfg, tst)


def _assert_condition(j, t):
    (jg, jst, jtel), (tg, tst, ttel) = j, t
    assert tuple(tg.shape) == jg.shape
    _close(tg, jg, 1e-5, "grid")
    _close(ttel.soc, jtel.soc, 1e-6, "soc")
    _close(ttel.command, jtel.command, 1e-7, "command")
    _equal(ttel.target, jtel.target, "target")
    _close(ttel.qp_residual, jtel.qp_residual, 1e-7, "qp residual")
    _close(tst.ess_state.soc, jst.ess_state.soc, 1e-6, "final SoC")
    _close(tst.filter_state, jst.filter_state, 1e-5, "LC state")
    for name in ("x", "z", "y"):  # carried through unchanged
        _equal(getattr(tst.qp_warm, name), getattr(jst.qp_warm, name), f"warm {name}")


@pytest.mark.parametrize("batched", [False, True])
def test_condition_per_step_matches_jax(testbench, batched):
    rack, racks, dt = testbench
    j, t, _ = _condition_both(racks if batched else rack, dt)
    _assert_condition(j, t)
    assert float(t[2].command.abs().max()) > 0.0


def test_condition_per_step_degraded_matches_jax(testbench):
    """Degraded mode with an ``ess_online`` mask: commands and residuals
    zeroed where a rack is offline, its hardware in LC passthrough."""
    _, racks, dt = testbench
    n_ctrl = -(-racks.shape[0] // int(round(5.0 / dt)))
    online = np.ones((n_ctrl, racks.shape[1]), np.float32)
    online[3:7, 1] = 0.0
    online[8:, 3] = 0.0
    j, t, _ = _condition_both(racks, dt, degraded=True, ess_online=online)
    _assert_condition(j, t)
    _equal(t[2].ess_online, j[2].ess_online, "applied availability")
    off = online == 0.0
    assert float(t[2].command.numpy()[off].max(initial=0.0)) == 0.0
    assert float(t[2].qp_residual.numpy()[off].max(initial=0.0)) == 0.0
    assert float(np.abs(t[2].command.numpy()[~off]).max()) > 0.0


def test_condition_per_step_vs_plan(testbench):
    """The per-step oracle against the factored, warm-started plan on the
    same trace: the reference's own 1e-3 bound on grid and SoC."""
    rack, _, dt = testbench
    cfg = tpdu.make_pdu(sample_dt=dt, device="cpu")
    tr = torch.from_numpy(rack.copy())
    st = tpdu.init_state(cfg, tr[0])
    g_cold, _, tel_cold = tpdu.condition(cfg, st, tr, qp_iters=120, use_plan=False)
    g_warm, _, tel_warm = tpdu.condition(cfg, st, tr, qp_iters=120)
    _close(g_warm, g_cold.numpy(), 1e-3, "grid")
    _close(tel_warm.soc, tel_cold.soc.numpy(), 1e-3, "soc")
    with pytest.raises(ValueError, match="use_plan=True"):
        tpdu.condition(cfg, st, tr[:100], use_plan=False,
                       plan=tctrl.make_plan(cfg.controller, cfg.ess_params))


def test_fleet_oneshot_per_step_matches_jax(testbench):
    _, racks, dt = testbench
    jcfg = jpdu.make_pdu(sample_dt=dt)
    jres = jfleet.condition(jnp.asarray(racks), jcfg, jcomp.GridSpec.create(), engine="oneshot",
                            qp_iters=120, use_plan=False)
    tcfg = convert.pdu_config_from_numpy(convert.numpy_tree(jcfg), device="cpu")
    tres = tfleet.condition(torch.from_numpy(racks.copy()), tcfg, engine="oneshot", device="cpu",
                            qp_iters=120, use_plan=False)
    # The port's own initial LC steady state (a float32 3x3 solve, 1e-6 off
    # the reference's) is inside the grid's 1e-5.
    _close(tres.campus_grid, jres.campus_grid, 1e-5, "campus grid")
    _close(tres.campus_rack, jres.campus_rack, 1e-6, "campus rack")
    _close(tres.grid_traces, jres.grid_traces, 1e-5, "grid traces")
    _close(tres.ess_online_frac, jres.ess_online_frac, 0.0, "online fraction")
    for name in ("ramp_ok", "spectrum_ok", "ok"):
        _equal(getattr(tres.report_grid, name), getattr(jres.report_grid, name), name)


@pytest.mark.parametrize("engine", ["host", "scanned"])
def test_streaming_engines_refuse_use_plan(engine):
    """As the reference's: only the one-shot engine takes ``use_plan``."""
    cfg = tpdu.make_pdu(sample_dt=1.0 / 200.0, device="cpu")
    s = TSC.scenario_from_model("llama3_2_1b", duration_s=10.0, device="cpu")
    with pytest.raises(TypeError, match="use_plan"):
        tfleet.condition(s, cfg, engine=engine, device="cpu", use_plan=False)


# ------------------------------------------------------------ the helpers


def test_staggered_fleet_roll_and_scale_at_jax_draws():
    sp = JTR.TestbenchSpec(duration_s=30.0, sample_hz=200.0, terminate_at_s=25.0)
    tr = np.array(JTR.testbench_trace(sp)[0])
    key = jax.random.key(8)
    want = np.asarray(jfleet.staggered_fleet(jnp.asarray(tr), 6, key, max_offset_samples=800,
                                             scale_jitter=0.1))
    k1, k2 = jax.random.split(key)  # the reference's own draws
    offsets = np.array(jax.random.randint(k1, (6,), 0, 800))
    scales = np.array(1.0 + 0.1 * jax.random.uniform(k2, (6,), minval=-1.0, maxval=1.0))
    got = tfleet._stagger(torch.from_numpy(tr), torch.from_numpy(offsets),
                          torch.from_numpy(scales))
    _equal(got, want, "staggered fleet")


def test_staggered_fleet_draws():
    """Seeded draws: reproducible, offsets in range, unit scales without
    jitter, every column a roll of the trace."""
    tr = torch.linspace(0.1, 0.9, 500)
    gen = lambda: torch.Generator().manual_seed(8)
    a = tfleet.staggered_fleet(tr, 16, gen(), max_offset_samples=100, device="cpu")
    b = tfleet.staggered_fleet(tr, 16, gen(), max_offset_samples=100, device="cpu")
    assert tuple(a.shape) == (500, 16) and torch.equal(a, b)
    for r in range(16):
        off = int(torch.argmin(torch.abs(a[:, r] - tr[0])))
        assert 0 <= off < 100 and torch.equal(a[:, r], torch.roll(tr, off))
    c = tfleet.staggered_fleet(tr, 4, gen(), scale_jitter=0.2, device="cpu")
    ratio = c / tr[:, None]
    assert torch.allclose(ratio, ratio[0].expand_as(ratio)) and float((ratio[0] - 1).abs().max()) <= 0.2
    assert torch.equal(tfleet.staggered_fleet(tr, 3, device="cpu"), tr[:, None].expand(500, 3))


def test_synchronous_aggregate_and_violation_fraction(testbench):
    _, racks, dt = testbench
    _equal(tfleet.synchronous_aggregate(torch.from_numpy(racks.copy()), 4),
           jfleet.synchronous_aggregate(jnp.asarray(racks), 4), "synchronous aggregate")
    j = jcomp.violation_fraction(jnp.asarray(racks), dt, jcomp.GridSpec.create())
    t = tcomp.violation_fraction(torch.from_numpy(racks.copy()), dt,
                                 tcomp.GridSpec.create(device="cpu"))
    assert tuple(t.shape) == (4,) and float(t.min()) > 0.0
    n = racks.shape[0] - 1
    _equal(torch.round(t * n), np.round(np.asarray(j) * n), "violating steps")
    _close(t, j, 0.0, "violation fraction", rtol=1.2e-7)


PHASES = ([1.0, 2.5, 0.3, 4.0, 0.004], [0.1, 0.9, 0.3, 0.7, 0.5])


def test_phase_timeline_trace_matches_jax():
    j, jdt = JTR.phase_timeline_trace(*PHASES, 200.0, edge_time_s=0.1)
    t, tdt = TTR.phase_timeline_trace(*PHASES, 200.0, edge_time_s=0.1, device="cpu")
    assert tdt == jdt and tuple(t.shape) == j.shape
    _close(t, j, 1e-6, "phase timeline")


def test_phase_timeline_trace_reference_bitwise():
    for edge in (0.1, 0.0):
        j, jdt = JTR.phase_timeline_trace_reference(*PHASES, 250.0, edge_time_s=edge)
        t, tdt = TTR.phase_timeline_trace_reference(*PHASES, 250.0, edge_time_s=edge,
                                                     device="cpu")
        assert tdt == jdt
        _equal(t, j, f"phase timeline oracle, edge {edge}")


@pytest.mark.parametrize("spec", [
    dict(duration_s=30.0, sample_hz=200.0, terminate_at_s=25.0),
    dict(duration_s=60.0, sample_hz=250.0, edge_time_s=0.2, fault_at_s=20.0,
         fault_duration_s=3.0, warmup_s=5.0, dip_period_s=17.0),
])
def test_testbench_trace_reference_matches_jax(spec):
    j, jdt = JTR.testbench_trace_reference(JTR.TestbenchSpec(**spec))
    t, tdt = TTR.testbench_trace_reference(TTR.TestbenchSpec(**spec), device="cpu")
    assert tdt == jdt and tuple(t.shape) == j.shape and t.dtype == torch.float32
    _close(t, j, 1e-6, "testbench oracle")
    # ... and the oracle pins the port's scenario-engine trace, as in the reference.
    _close(TTR.testbench_trace(TTR.TestbenchSpec(**spec), device="cpu")[0], t.numpy(), 1e-6,
           "testbench_trace vs its oracle")
    noisy, _ = TTR.testbench_trace_reference(TTR.TestbenchSpec(**spec), torch.Generator(),
                                              device="cpu")
    assert 0.0 < float((noisy - t).abs().max()) and float(noisy.min()) >= 0.0


@pytest.mark.parametrize("arch", ["llama3_2_1b", "rwkv6_7b"])
def test_scenario_from_model_matches_jax(arch):
    kw = dict(duration_s=60.0, noise_seed=3)
    js = JSC.scenario_from_model(arch, **kw)
    ts = TSC.scenario_from_model(arch, device="cpu", **kw)
    for f in dataclasses.fields(JSC.WorkloadParams):
        _equal(getattr(ts.params, f.name), getattr(js.params, f.name), f.name)
    j, jdt = JSC.render_trace(js)
    t, tdt = TSC.render_trace(ts)
    assert tdt == jdt and tuple(t.shape) == j.shape
    _close(t, j, 1e-6, arch)
