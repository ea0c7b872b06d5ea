"""Degraded-mode conditioning in the port against the JAX package, on the CPU.

* ``pdu_health_sim`` with each ESS availability operand (an ``(R,)`` row, a
  fractional ``(T, R)`` series, the ``ess_events`` tables at edges 1 and 7
  and window starts 0, 2000 and 4391): the port's plain version against
  JAX's ``ref.pdu_health_sim`` and its interpret-mode Pallas kernel, with
  ``tests/test_torch_kernels.py``'s contract: SoC path, ESS state and SoC
  final bitwise against both; grid and LC state bitwise against the Pallas
  kernel and within 1e-6 of the jnp scan, which contracts a few LC
  multiply-adds differently; wear carries bitwise.  Inside the port the
  events operand equals the streamed weight bit for bit.
* ``pdu.condition`` in degraded mode, streamed and fast, against JAX's on
  a faulty campus JAX rendered, from carried configs, plans, states and
  schedules: SoC, commands and the masks as ``tests/test_torch_pdu.py``
  holds the clean path (1e-6, 1e-7, exact), the grid within 1e-6 (3000
  samples; the LC contraction above drifts ~1.6e-6 only past ~6500).
* Inside the port: fast equal to streamed, chunked equal to whole, a
  {0, 1} weight equal to the unmasked path, all bitwise; offline racks in
  LC passthrough; NaN bridging and blind intervals; the engines under a
  schedule, a fault on a chunk boundary and a resume mid-outage.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as jctrl, health as jhlt, pdu as jpdu
from repro.kernels import ops as jops
from repro.power import faults as JF, scenario as JSC
from repro_torch import convert
from repro_torch.core import compliance as tcomp, fleet as tfleet, pdu as tpdu
from repro_torch.kernels import ops as tops, ref as tref
from repro_torch.power import faults as TF, scenario as TSC

torch.set_num_threads(1)
HZ = 100.0
T_ = lambda a: torch.from_numpy(np.array(a))


def _bitwise(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    assert np.array_equal(a, b), f"{what} must be bitwise ({np.sum(a != b)} differ)"


def _jax_schedule():
    proc = JF.FaultProcess.create(rack_mtbf_s=50.0, rack_mttr_s=15.0, ess_mtbf_s=40.0,
                                  ess_mttr_s=10.0, sensor_mtbf_s=30.0, sensor_mttr_s=5.0)
    s = JF.sample_schedule(proc, 6, 9000, HZ, seed=5)
    return JF.inject_episodes(s, rack=[(i, 4000 + i * 37, 4600 + i * 41) for i in range(6)],
                              sensor=[(2, 8000, 8999)], ess=[(1, 2050, 2300)])


# ------------------------------------------------------ the kernel's modes


def _interval_inputs(t, r, seed):
    rng = np.random.default_rng(seed)
    steps = rng.choice([0.15, 0.6, 0.95], size=(t // 20 + 2, r))
    rack = np.clip(np.repeat(steps, 20, axis=0)[:t] + 0.01 * rng.standard_normal((t, r)),
                   0.0, 1.0).astype(np.float32)
    cfg = jpdu.make_pdu(sample_dt=1.0 / HZ, track_health=True, degraded_mode=True)
    st = jpdu.init_state(cfg, jnp.asarray(rack[0]))
    soc0 = rng.uniform(0.2, 0.8, r).astype(np.float32)
    soc0[: max(r // 3, 1)] = np.float32(0.89995)  # the clamp and back-off run
    g0 = (rack[0] + 0.05 * rng.standard_normal(r)).astype(np.float32)
    filt = st.filter_obj
    args = (rack, g0, soc0, np.asarray(st.filter_state), np.asarray(filt.ad),
            np.asarray(filt.bd), np.asarray(filt.c[0]))
    ep = cfg.ess_params
    kw = dict(beta=float(ep.beta), dt=1.0 / HZ, q_max=float(ep.q_max), eta_c=float(ep.eta_c),
              eta_d=float(ep.eta_d), p_max=float(ep.p_max), soc_min=float(ep.soc_safe_min),
              soc_max=float(ep.soc_safe_max))
    slew = (rng.uniform(-5e-3, 5e-3, r).astype(np.float32),
            rng.uniform(-5e-3, 5e-3, r).astype(np.float32))
    hs = jhlt.init_state(jnp.asarray(soc0))
    return args, kw, slew, (jhlt.step_consts(cfg.health), tuple(np.asarray(l) for l in hs))


def _weights(mode, t, r, rng):
    """The mode's operand as (numpy kwargs for JAX, torch kwargs for the port)."""
    if mode == "row":
        w = (rng.uniform(0, 1, r) > 0.4).astype(np.float32)
        return dict(ess_on=jnp.asarray(w)), dict(ess_on=T_(w))
    if mode == "series":
        w = np.clip(np.linspace(1.2, -0.3, t)[:, None] + rng.uniform(-0.2, 0.2, (1, r)),
                    0.0, 1.0).astype(np.float32)
        return dict(ess_on=jnp.asarray(w)), dict(ess_on=T_(w))
    _, t0, edge = mode
    s = _jax_schedule()
    base = (0.5 + np.arange(r) / 8.0).astype(np.float32)
    base[0] = 0.0
    st, en = np.asarray(s.ess_start.T), np.asarray(s.ess_end.T)
    jev = (jnp.asarray(st), jnp.asarray(en), jnp.asarray(base), jnp.asarray(t0, jnp.int32),
           jnp.asarray(t0 + t - 1, jnp.int32))
    tev = (T_(st), T_(en), T_(base), t0, t0 + t - 1)
    return dict(ess_events=jev, ess_edge=edge), dict(ess_events=tev, ess_edge=edge)


MODES = ["row", "series", ("events", 0, 1), ("events", 2000, 7), ("events", 4391, 7),
         ("events", 2000, 50)]


@pytest.mark.parametrize("mode", MODES, ids=str)
@pytest.mark.parametrize("with_health", [True, False])
def test_pdu_health_weight_modes_match_jax(mode, with_health):
    t, r = 300, 6
    args, kw, slew, health = _interval_inputs(t, r, seed=7)
    jw, tw = _weights(mode, t, r, np.random.default_rng(3))
    port = tops.pdu_health_sim(
        *(T_(a) for a in args), slew=tuple(T_(x) for x in slew),
        health=(health[0], tuple(T_(l) for l in health[1])) if with_health else None,
        **tw, **kw)
    for force in ("ref", "pallas"):
        ref = jops.pdu_health_sim(
            *(jnp.asarray(a) for a in args), slew=tuple(jnp.asarray(x) for x in slew),
            health=(health[0], tuple(jnp.asarray(l) for l in health[1])) if with_health else None,
            force=force, **jw, **kw)
        (grid_r, soc_r, (g_r, sf_r, x_r), h_r), (grid_p, soc_p, (g_p, sf_p, x_p), h_p) = ref, port
        _bitwise(soc_r, soc_p, f"{force}: SoC path")
        _bitwise(g_r, g_p, f"{force}: ESS filter final")
        _bitwise(sf_r, sf_p, f"{force}: SoC final")
        if force == "pallas":
            _bitwise(grid_r, grid_p, "pallas: grid")
            _bitwise(x_r, x_p, "pallas: LC state")
        else:
            np.testing.assert_allclose(grid_p.numpy(), np.asarray(grid_r), rtol=0, atol=1e-6)
            np.testing.assert_allclose(x_p.numpy(), np.asarray(x_r), rtol=0, atol=1e-6)
        if with_health:
            for i in range(8):  # the wear carries and the throughput sums
                _bitwise(h_r[i], h_p[i], f"{force}: health leaf {i}")
    # The weight really bit: some SoC froze, some moved.
    frozen = (soc_p.numpy() == np.asarray(args[2])[None, :]).all(axis=0)
    assert frozen.any() or mode == "series"


@pytest.mark.parametrize("t0,edge", [(0, 1), (2000, 7), (4391, 7), (8700, 50)])
def test_events_equal_streamed_weight_in_port(t0, edge):
    t, r = 1000, 6
    args, kw, slew, _ = _interval_inputs(t, r, seed=1)
    sched = convert.fault_schedule_from_numpy(convert.numpy_tree(_jax_schedule()), device="cpu")
    base = torch.linspace(0.5, 1.0, r)
    streamed = TF.ess_weight(sched, t0, t, edge) * base[None, :]
    events = (sched.ess_start.T.contiguous(), sched.ess_end.T.contiguous(), base, t0,
              min(t0 + t - 1, 8999))
    rendered = tref.events_weight(events, t, edge)
    clamp = (torch.arange(t) + t0).clamp(max=8999) - t0
    assert torch.equal(rendered, streamed[clamp])
    a = tref.pdu_health_sim(*(T_(x) for x in args), slew=tuple(T_(x) for x in slew),
                            ess_on=streamed[clamp], **kw)
    b = tref.pdu_health_sim(*(T_(x) for x in args), slew=tuple(T_(x) for x in slew),
                            ess_events=events, ess_edge=edge, **kw)
    for x, y in zip((a[0], a[1], *a[2]), (b[0], b[1], *b[2])):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        tref.pdu_health_sim(*(T_(x) for x in args), ess_on=streamed, ess_events=events, **kw)


def test_unit_weight_equals_unmasked():
    t, r = 250, 5
    args, kw, slew, health = _interval_inputs(t, r, seed=2)
    plain = tops.pdu_health_sim(*(T_(a) for a in args), slew=tuple(T_(x) for x in slew), **kw)
    for w in (torch.ones(r), torch.ones(t, r)):
        masked = tops.pdu_health_sim(*(T_(a) for a in args), slew=tuple(T_(x) for x in slew),
                                     ess_on=w, **kw)
        for x, y in zip((plain[0], plain[1], *plain[2]), (masked[0], masked[1], *masked[2])):
            assert torch.equal(x, y)


# ------------------------------------------------------- pdu.condition


def _faulty_scenario(n_racks=8, duration_s=30.0):
    s = JSC.mixed_campus(n_racks, ("llama3_2_1b", "qwen1_5_4b"), duration_s=duration_s,
                         sample_hz=HZ, seed=2)
    proc = JF.FaultProcess.create(rack_mtbf_s=20.0, rack_mttr_s=6.0, ess_mtbf_s=12.0,
                                  ess_mttr_s=6.0, sensor_mtbf_s=10.0, sensor_mttr_s=3.0)
    return JSC.attach_faults(s, proc, seed=11)


@pytest.fixture(scope="module")
def faulty():
    """A JAX-rendered faulty campus and both packages' degraded configs,
    initial states, plans and schedules."""
    js = _faulty_scenario()
    tr = np.asarray(JSC.render(js, 0, js.total_samples))
    assert np.isnan(tr).any()
    jcfg = jpdu.make_pdu(sample_dt=1.0 / HZ, degraded_mode=True)
    jst = jpdu.init_state(jcfg, jnp.asarray(tr[0]))
    jplan = jctrl.make_plan(jcfg.controller, jcfg.ess_params)
    tcfg = convert.pdu_config_from_numpy(convert.numpy_tree(jcfg), device="cpu")
    assert tcfg.degraded_mode
    return dict(
        js=js, tr=tr, jcfg=jcfg, jst=jst, tcfg=tcfg,
        tst=convert.pdu_state_from_numpy(convert.numpy_tree(jst), device="cpu"),
        tplan=convert.plan_from_numpy(convert.numpy_tree(jplan), device="cpu"),
        tsched=convert.fault_schedule_from_numpy(convert.numpy_tree(js.faults), device="cpu"),
        k=int(round(float(jcfg.controller.dt) * HZ)),
    )


def _close(a, b, atol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol, err_msg=what)


def _assert_close_to_jax(t_out, j_out):
    (tg, tst, ttel), (jg, jst, jtel) = t_out, j_out
    _close(tg, jg, 1e-6, "grid")
    _close(ttel.soc, jtel.soc, 1e-6, "telemetry soc")
    _close(ttel.command, jtel.command, 1e-7, "command")
    _close(ttel.qp_residual, jtel.qp_residual, 1e-7, "qp residual")
    _bitwise(jtel.ess_online, ttel.ess_online, "applied availability")
    _close(ttel.rack_mean, jtel.rack_mean, 1e-6, "rack mean")
    _close(ttel.grid_mean, jtel.grid_mean, 1e-6, "grid mean")
    _close(tst.ess_state.soc, jst.ess_state.soc, 1e-6, "SoC")
    _close(tst.ess_state.g_filter, jst.ess_state.g_filter, 1e-6, "ESS filter")
    _close(tst.filter_state, jst.filter_state, 1e-6, "LC state")
    _bitwise(jst.last_good, tst.last_good, "last good")
    for name in ("x", "z", "y"):
        _close(getattr(tst.qp_warm, name), getattr(jst.qp_warm, name), 2e-5, name)


@pytest.mark.parametrize("path", ["streamed", "fast"])
def test_degraded_condition_matches_jax(faulty, path):
    f = faulty
    js, k = f["js"], f["k"]
    n_ctrl = -(-js.total_samples // k)
    edge = js.edge_width
    if path == "fast":
        jkw = dict(faults=js.faults, chunk_start=0, fault_edge=edge)
        tkw = dict(faults=f["tsched"], chunk_start=0, fault_edge=edge)
    else:
        on = JF.interval_online(js.faults, 0, n_ctrl, k)
        wt = JF.ess_weight(js.faults, 0, js.total_samples, edge)
        jkw = dict(ess_online=on, ess_weight=wt)
        tkw = dict(ess_online=T_(on), ess_weight=T_(wt))
    j_out = jpdu.condition(f["jcfg"], f["jst"], jnp.asarray(f["tr"]), qp_iters=20, **jkw)
    t_out = tpdu.condition(f["tcfg"], f["tst"], T_(f["tr"]), qp_iters=20, plan=f["tplan"], **tkw)
    _assert_close_to_jax(t_out, j_out)
    assert float(t_out[2].ess_online.mean()) < 1.0
    assert torch.isfinite(t_out[0]).all()


def test_fast_equals_streamed_and_chunked_equals_whole(faulty):
    f = faulty
    cfg, st0, plan, sched, k = f["tcfg"], f["tst"], f["tplan"], f["tsched"], f["k"]
    tr = T_(f["tr"])
    n, edge = tr.shape[0], f["js"].edge_width
    n_ctrl = -(-n // k)
    on = TF.interval_online(sched, 0, n_ctrl, k)
    wt = TF.ess_weight(sched, 0, n, edge)
    ref = tpdu.condition(cfg, st0, tr, qp_iters=20, plan=plan, ess_online=on, ess_weight=wt)
    fast = tpdu.condition(cfg, st0, tr, qp_iters=20, plan=plan, faults=sched, fault_edge=edge)
    _assert_same(ref, fast)
    # Chunked (a ragged cut inside the soup) against whole, both paths.
    for cut in (2 * k, 3 * k):
        st = st0
        g1, st, t1 = tpdu.condition(cfg, st, tr[:cut], qp_iters=20, plan=plan, faults=sched,
                                    fault_edge=edge)
        g2, st, t2 = tpdu.condition(cfg, st, tr[cut:], qp_iters=20, plan=plan, faults=sched,
                                    chunk_start=cut, fault_edge=edge)
        assert torch.equal(torch.cat([g1, g2]), fast[0])
        assert torch.equal(torch.cat([t1.ess_online, t2.ess_online]), fast[2].ess_online)
        _assert_same_state(st, fast[1])
        st = st0
        g1, st, _ = tpdu.condition(cfg, st, tr[:cut], qp_iters=20, plan=plan,
                                   ess_online=on[: cut // k], ess_weight=wt[:cut])
        g2, st, _ = tpdu.condition(cfg, st, tr[cut:], qp_iters=20, plan=plan,
                                   ess_online=on[cut // k:], ess_weight=wt[cut:])
        assert torch.equal(torch.cat([g1, g2]), ref[0])
        _assert_same_state(st, ref[1])


def _assert_same_state(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)


def _leaves(st):
    out = [st.filter_state, *st.ess_state, st.u_prev, st.cmd_applied, st.cmd_target,
           st.soc_ema, *st.qp_warm, *st.health, st.ess_online, st.last_good]
    return out


def _assert_same(a, b):
    assert torch.equal(a[0], b[0])
    _assert_same_state(a[1], b[1])
    for x, y in zip(a[2], b[2]):
        assert (x is None and y is None) or torch.equal(x, y)


def test_degraded_clean_trace_equals_plain(faulty):
    """degraded_mode with no faults and no mask (a {0,1} weight of ones) is
    the unmasked path bit for bit."""
    ts = TSC.mixed_campus(4, ("llama3_2_1b", "qwen1_5_4b"), duration_s=20.0, sample_hz=HZ,
                          seed=2, device="cpu")
    tr = TSC.render(ts, 0, ts.total_samples)
    plain = tpdu.make_pdu(sample_dt=1.0 / HZ, device="cpu")
    deg = tpdu.make_pdu(sample_dt=1.0 / HZ, degraded_mode=True, device="cpu")
    a = tpdu.condition(plain, tpdu.init_state(plain, tr[0]), tr, qp_iters=20)
    b = tpdu.condition(deg, tpdu.init_state(deg, tr[0]), tr, qp_iters=20)
    assert torch.equal(a[0], b[0])
    # Every leaf but the sensor bridge's seed, which only degraded mode moves.
    for x, y in zip(_leaves(a[1])[:-1], _leaves(b[1])[:-1]):
        assert torch.equal(x, y)
    assert torch.equal(b[1].last_good, tr[-1])
    assert torch.equal(b[2].ess_online, torch.ones_like(b[2].ess_online))
    with pytest.raises(ValueError):
        tpdu.condition(plain, tpdu.init_state(plain, tr[0]), tr, ess_online=torch.ones(4))


def test_offline_rack_is_lc_passthrough():
    ts = TSC.mixed_campus(4, ("llama3_2_1b", "qwen1_5_4b"), duration_s=20.0, sample_hz=HZ,
                          seed=2, device="cpu")
    tr = TSC.render(ts, 0, ts.total_samples)
    deg = tpdu.make_pdu(sample_dt=1.0 / HZ, degraded_mode=True, device="cpu")
    st = tpdu.init_state(deg, tr[0])
    _, st_f, te = tpdu.condition(deg, st, tr, qp_iters=20,
                                 ess_online=torch.tensor([0.0, 1.0, 1.0, 1.0]))
    assert torch.equal(st_f.ess_state.soc[0], st.ess_state.soc[0])
    assert torch.all(te.command[:, 0] == 0.0)
    assert torch.any(te.command[:, 1:] != 0.0)
    # The rack's grid is the raw rack through the LC filter alone.
    lc_only = tops.lc_filter(st.filter_obj.ad, st.filter_obj.bd, st.filter_obj.c[0],
                             st.filter_state[:1], tr[:, :1])[0]
    g, _, _ = tpdu.condition(deg, st, tr, qp_iters=20,
                             ess_online=torch.tensor([0.0, 1.0, 1.0, 1.0]))
    np.testing.assert_allclose(g[:, :1].numpy(), lc_only.numpy(), rtol=0, atol=1e-6)


def test_bridges_nan_and_trips_blind_intervals(faulty):
    f = faulty
    tr = T_(f["tr"])
    cfg, k = f["tcfg"], f["k"]
    grid, _, te = tpdu.condition(cfg, f["tst"], tr, qp_iters=20, plan=f["tplan"])
    assert torch.isfinite(grid).all() and torch.isfinite(te.rack_mean).all()
    dead = TF.sensor_down(f["tsched"], 0, tr.shape[0]).numpy()
    n_ctrl = te.ess_online.shape[0]
    pad = n_ctrl * k - dead.shape[0]
    dead = np.concatenate([dead, np.repeat(dead[-1:], pad, 0)])
    blind = dead.reshape(n_ctrl, k, -1).all(axis=1)
    assert blind.any(), "the schedule produced no fully blind interval"
    assert (te.ess_online.numpy()[blind] == 0.0).all()
    bridged, lg = tpdu.bridge_sensors(f["tst"].last_good, tr)
    jb, jlg = jpdu.bridge_sensors(jnp.asarray(np.asarray(f["jst"].last_good)),
                                  jnp.asarray(f["tr"]))
    _bitwise(jb, bridged, "bridged trace")
    _bitwise(jlg, lg, "last good")


def test_unbatched_degraded_trace():
    tr = torch.full((1200,), 0.6)
    tr[450:1050] = float("nan")
    cfg = tpdu.make_pdu(sample_dt=1.0 / HZ, degraded_mode=True, device="cpu")
    g, st, te = tpdu.condition(cfg, tpdu.init_state(cfg, tr[0]), tr, qp_iters=10,
                               ess_online=torch.tensor(1.0))
    assert g.shape == (1200,) and torch.isfinite(g).all()
    assert te.ess_online.shape == (3,) and te.ess_online[1] == 0.0


# ------------------------------------------------------------ the engines


def _engine_campus(n_racks=5, duration_s=40.0):
    ts = TSC.mixed_campus(n_racks, ("llama3_2_1b", "qwen1_5_4b"), duration_s=duration_s,
                          sample_hz=HZ, seed=2, device="cpu")
    proc = TF.FaultProcess.create(rack_mtbf_s=30.0, rack_mttr_s=10.0, ess_mtbf_s=25.0,
                                  ess_mttr_s=8.0, sensor_mtbf_s=20.0, sensor_mttr_s=4.0)
    return TSC.attach_faults(ts, proc, seed=13)


def _deg_cfg():
    return tpdu.make_pdu(sample_dt=1.0 / HZ, degraded_mode=True, device="cpu")


def test_engines_agree_under_a_schedule():
    s = _engine_campus()
    cfg = _deg_cfg()
    spec = tcomp.GridSpec.create(device="cpu")
    with pytest.raises(ValueError):
        tfleet.condition(s, tpdu.make_pdu(sample_dt=1.0 / HZ, device="cpu"), spec, device="cpu")
    host = tfleet.condition(s, cfg, spec, engine="host", qp_iters=20,
                            stream={"chunk_intervals": 2}, device="cpu")
    one = tfleet.condition(s, cfg, spec, engine="oneshot", qp_iters=20, device="cpu")
    assert torch.equal(host.campus_rack, one.campus_rack)
    assert torch.equal(host.campus_grid, one.campus_grid)
    assert torch.equal(host.ess_online_frac, one.ess_online_frac)
    assert float(host.ess_online_frac.min()) < 1.0
    assert torch.isfinite(host.campus_grid).all()
    # A caller override of one half keeps the other half derived.
    k = 500
    n_ctrl = -(-s.total_samples // k)
    on = TF.interval_online(s.faults, 0, n_ctrl, k)
    over = tfleet.condition(s, cfg, spec, engine="host", qp_iters=20, ess_online=on,
                            stream={"chunk_intervals": 2}, device="cpu")
    assert torch.equal(over.campus_grid, host.campus_grid)


def test_fault_on_chunk_boundary():
    ts = TSC.mixed_campus(4, ("llama3_2_1b", "qwen1_5_4b"), duration_s=24.0, sample_hz=HZ,
                          seed=2, device="cpu")
    k = int(round(5.0 * HZ))
    chunk = 2 * k
    sched = TF.schedule_from_episodes(
        4, ess=[(1, chunk, 2 * chunk), (2, 2 * chunk, 3 * chunk)],
        sensor=[(3, chunk, chunk + k)], device="cpu")
    s = TSC.attach_faults(ts, sched)
    cfg = _deg_cfg()
    spec = tcomp.GridSpec.create(device="cpu")
    a = tfleet.condition(s, cfg, spec, qp_iters=15, stream={"chunk_intervals": 2}, device="cpu")
    b = tfleet.condition(s, cfg, spec, qp_iters=15, stream={"chunk_intervals": 4}, device="cpu")
    assert torch.equal(a.campus_grid, b.campus_grid)
    assert torch.equal(a.ess_online_frac, b.ess_online_frac)
    np.testing.assert_array_equal(a.ess_online_frac.numpy(), [1.0, 1.0, 0.5, 0.75, 0.75])


def test_resume_mid_outage():
    s = _engine_campus()
    cfg = _deg_cfg()
    k = 500
    tr = TSC.render(s, 0, s.total_samples)
    st0 = tpdu.init_state(cfg, tr[0])
    full_st, full = tpdu.condition_campus(cfg, st0, tr, qp_iters=20, faults=s.faults,
                                          fault_edge=s.edge_width)
    cut = 4 * k
    st, a = tpdu.condition_campus(cfg, st0, tr[:cut], qp_iters=20, faults=s.faults,
                                  fault_edge=s.edge_width)
    st, b = tpdu.condition_campus(cfg, st, tr[cut:], qp_iters=20, faults=s.faults,
                                  chunk_start=cut, fault_edge=s.edge_width)
    for name in ("campus_rack", "campus_grid", "soc_mean", "ess_online_frac"):
        assert torch.equal(torch.cat([getattr(a, name), getattr(b, name)]),
                           getattr(full, name)), name
    _assert_same_state(st, full_st)
    dark = TF.sensor_down(s.faults, cut - 1, 2)
    ess = TF.ess_weight(s.faults, cut - 1, 2, 1)
    assert bool(dark.any()) or bool((ess < 1).any()), "the cut is inside no outage"
