"""The supervised ``pdu.condition`` against the JAX package on the CPU (the
engines under safe mode: ``tests/test_torch_safemode_engines.py``).

Configs, initial states and controller plans are carried across
(``repro_torch.convert``), so both packages start from identical bits; the
traces are constant or JAX-rendered.  What is held, and to what:

* the supervisor exactly: per-interval modes, every ``SafeModeState`` leaf
  (counters, streaks, the applied hardware weight), the final summary, and
  the zero commands of every contained rack;
* grid and SoC within 1e-6, residuals within 2e-5, commands within 1e-7
  (``tests/test_torch_pdu.py``'s reasons: the ADMM products sum in another
  order);
* the transparency contract inside the port: a clean supervised run equals
  the unsupervised one bit for bit (grid, every telemetry row but
  ``safemode_mode``, every state leaf but ``safemode``), on each engine.

The reference's engine tests (``tests/test_safemode.py``) are mirrored (its
fleet-level one in the engines file), then: corruption of each kind of
leaf, ``faults=`` under safe mode (the streamed arrays, not the events
mode, also chunked with a tensor start) and ``use_plan=False``.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as jctrl, pdu as jpdu, safemode as jsm
from repro.power import faults as JF, scenario as JSC
from repro_torch import convert
from repro_torch.core import fleet as tfleet, pdu as tpdu, safemode as tsm
from repro_torch.power import faults as TF

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
DT = 1e-2  # the controller's 5 s is 500 samples
K = 500
T_ = lambda a: torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bitwise(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, what
    assert np.array_equal(a, b, equal_nan=True), f"{what}: {np.sum(a != b)} differ"


def _close(a, b, atol, what):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol, err_msg=what)


def _const_trace(n_intervals, n_racks, level=0.6):
    return np.full((n_intervals * K, n_racks), level, np.float32)


def _wavy_trace(n_intervals, n_racks):
    t = np.arange(n_intervals * K)[:, None]
    return (0.6 + 0.2 * np.sin(t / 40.0) * np.linspace(0.5, 1.0, n_racks)[None, :]).astype(
        np.float32)


def _jcfg(**kw):
    return jpdu.make_pdu(sample_dt=DT, **kw)


def _carry(jcfg, jst):
    """The port's config, state and plan, from the JAX package's."""
    jplan = jctrl.make_plan(jcfg.controller, jcfg.ess_params)
    return (convert.pdu_config_from_numpy(convert.numpy_tree(jcfg), device="cpu"),
            convert.pdu_state_from_numpy(convert.numpy_tree(jst), device="cpu"),
            convert.plan_from_numpy(convert.numpy_tree(jplan), device="cpu"))


def _torch_kw(kw):
    return {k: T_(v) if isinstance(v, (np.ndarray, jax.Array)) else v for k, v in kw.items()}


def _run_both(jcfg, jst, trace, *, qp_iters=30, **kw):
    """``pdu.condition`` in both packages from the same bits; returns the
    two ``(grid, state, telemetry)`` triples and the port's config, state
    and plan."""
    j = jpdu.condition(jcfg, jst, jnp.asarray(trace), qp_iters=qp_iters, **kw)
    tcfg, tst, tplan = _carry(jcfg, jst)
    plan = tplan if kw.get("use_plan", True) else None
    t = tpdu.condition(tcfg, tst, T_(trace), qp_iters=qp_iters, plan=plan, **_torch_kw(kw))
    return j, t, (tcfg, tst, tplan)


def _assert_parity(j, t):
    (jg, jst, jtel), (tg, tst, ttel) = j, t
    _bitwise(jtel.safemode_mode, ttel.safemode_mode, "modes")
    for name, a, b in zip(jst.safemode._fields, jst.safemode, tst.safemode):
        _bitwise(a, b, f"safemode.{name}")
    assert jsm.summary(jst.safemode) == tsm.summary(tst.safemode)
    contained = _np(ttel.safemode_mode) != tsm.NORMAL
    assert (_np(ttel.command)[contained] == 0.0).all()
    assert (_np(jtel.command)[contained] == 0.0).all()
    _close(tg, jg, 1e-6, "grid")
    _close(ttel.soc, jtel.soc, 1e-6, "telemetry soc")
    _close(ttel.command, jtel.command, 1e-7, "command")
    _close(ttel.qp_residual, jtel.qp_residual, 2e-5, "qp residual")
    _close(tst.ess_state.soc, jst.ess_state.soc, 1e-6, "SoC")
    _close(tst.filter_state, jst.filter_state, 1e-6, "LC state")
    for name in ("x", "z", "y"):
        _close(getattr(tst.qp_warm, name), getattr(jst.qp_warm, name), 2e-5, f"warm {name}")
    for name in jst.health._fields:
        a, b = _np(getattr(jst.health, name)), _np(getattr(tst.health, name))
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)


def _poison_warm(st, racks, value=1e12):
    x = st.qp_warm.x.at[:, jnp.asarray(racks)].set(value)
    return st._replace(qp_warm=st.qp_warm._replace(x=x))


def _state_leaves(st):
    """Every tensor leaf of a port state but the supervisor's."""
    return tfleet._tree_leaves(st._replace(safemode=None))


# ------------------------------------------------ the reference's engine tests


def test_safemode_off_is_bitwise_identical():
    """The transparency contract: supervising a clean run changes nothing
    (in the port, bit for bit; against JAX within the tolerances)."""
    trace = _wavy_trace(6, 4)
    base, sup = _jcfg(track_health=True), _jcfg(track_health=True, safemode=True)
    j, t, (tcfg, tst, tplan) = _run_both(sup, jpdu.init_state(sup, jnp.asarray(trace[0])), trace)
    _assert_parity(j, t)
    bcfg, bst, _ = _carry(base, jpdu.init_state(base, jnp.asarray(trace[0])))
    g0, st0, tel0 = tpdu.condition(bcfg, bst, T_(trace), qp_iters=30, plan=tplan)
    g1, st1, tel1 = t
    assert torch.equal(g0, g1)
    for x, y in zip(_state_leaves(st0), _state_leaves(st1), strict=True):
        assert torch.equal(x, y)
    for name in tel0._fields:
        if name not in ("safemode_mode", "ess_online"):
            assert torch.equal(getattr(tel0, name), getattr(tel1, name)), name
    assert tel0.safemode_mode is None and (tel1.safemode_mode == tsm.NORMAL).all()
    for x, y in zip(st0.safemode, st1.safemode):  # the supervisor never moved
        assert torch.equal(x, y)


def test_divergence_trips_and_readmits():
    cfg = _jcfg(safemode=True, safemode_params=jsm.SafeModeConfig.create(
        resid_threshold=0.05, trip_intervals=2, readmit_intervals=3))
    trace = _const_trace(10, 6)
    st = _poison_warm(jpdu.init_state(cfg, jnp.asarray(trace[0])), [1, 4])
    j, t, _ = _run_both(cfg, st, trace)
    _assert_parity(j, t)
    grid, st2, telem = t
    mode = telem.safemode_mode.numpy()
    for r in (1, 4):
        assert mode[0, r] == tsm.NORMAL and mode[1, r] == tsm.PASSTHROUGH
        assert mode[-1, r] == tsm.NORMAL
        first_normal = int(np.argmax(mode[1:, r] == tsm.NORMAL)) + 1
        assert (mode[1:first_normal, r] == tsm.PASSTHROUGH).all()
    assert (mode[:, [0, 2, 3, 5]] == tsm.NORMAL).all()
    assert torch.isfinite(grid).all()
    assert st2.safemode.passthrough_entries.tolist() == [0, 1, 0, 0, 1, 0]
    assert st2.safemode.readmissions.tolist() == [0, 1, 0, 0, 1, 0]
    assert int(st2.safemode.worst_streak.max()) >= 2


def test_nan_corruption_quarantines_and_reinitializes():
    cfg = _jcfg(safemode=True, track_health=True)
    trace = _const_trace(4, 5)
    st = jpdu.init_state(cfg, jnp.asarray(trace[0]))
    st = st._replace(ess_state=st.ess_state._replace(soc=st.ess_state.soc.at[2].set(jnp.nan)))
    j, t, _ = _run_both(cfg, st, trace)
    _assert_parity(j, t)
    grid, st2, telem = t
    assert st2.safemode.quarantine_entries.tolist() == [0, 0, 1, 0, 0]
    assert int(telem.safemode_mode[0, 2]) == tsm.QUARANTINE
    for leaf in tfleet._tree_leaves(st2):
        assert torch.isfinite(leaf.double()).all()
    assert torch.isfinite(grid).all()


def test_unsupervised_corruption_propagates():
    """Without safe mode the same NaN poisons the stream: the failure the
    sanitizer exists for."""
    cfg = tpdu.make_pdu(sample_dt=DT, device="cpu")
    trace = torch.full((2 * K, 3), 0.6)
    st = tpdu.init_state(cfg, trace[0])
    st = st._replace(ess_state=st.ess_state._replace(soc=torch.tensor([float("nan"), 0.5, 0.5])))
    _, st2, _ = tpdu.condition(cfg, st, trace, qp_iters=30)
    assert not torch.isfinite(st2.ess_state.soc).all()


def test_offline_and_diverged_is_exactly_one_passthrough_path():
    """A rack both ESS-offline and QP-diverged resolves to the availability
    plane alone: its residual arrives masked to zero, so offline + poisoned
    is bit for bit the plain offline run."""
    cfg = _jcfg(degraded_mode=True, safemode=True)
    trace = _const_trace(5, 4)
    offline = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    st_a = jpdu.init_state(cfg, jnp.asarray(trace[0]))
    st_b = _poison_warm(st_a, [1])
    ja, ta, _ = _run_both(cfg, st_a, trace, ess_online=offline)
    jb, tb, _ = _run_both(cfg, st_b, trace, ess_online=offline)
    _assert_parity(ja, ta)
    _assert_parity(jb, tb)
    assert torch.equal(ta[0], tb[0])
    assert torch.equal(ta[2].safemode_mode, tb[2].safemode_mode)
    assert (tb[2].safemode_mode == tsm.NORMAL).all()
    assert int(tb[1].safemode.passthrough_entries.sum()) == 0
    for x, y in zip(tfleet._tree_leaves(ta[1]), tfleet._tree_leaves(tb[1]), strict=True):
        assert torch.equal(x, y)


def test_trip_then_offline_then_readmit_at_interval_boundaries():
    """A rack trips, goes ESS-offline while contained, comes back and
    re-admits over three calls: one passthrough entry, zero commands
    throughout its containment, as one supervisor would count it."""
    params = dict(resid_threshold=0.05, trip_intervals=1, readmit_intervals=2)
    jcfg = _jcfg(degraded_mode=True, safemode=True,
                 safemode_params=jsm.SafeModeConfig.create(**params))
    jst = _poison_warm(jpdu.init_state(jcfg, jnp.asarray(_const_trace(1, 3)[0])), [0])
    tcfg, tst, tplan = _carry(jcfg, jst)
    on = np.ones(3, np.float32)
    off0 = on.copy()
    off0[0] = 0.0
    modes, cmds = [], []
    for n, mask in ((2, on), (1, off0), (3, on)):
        tr = _const_trace(n, 3)
        _, jst, jtel = jpdu.condition(jcfg, jst, jnp.asarray(tr), qp_iters=30,
                                      ess_online=jnp.asarray(mask))
        _, tst, ttel = tpdu.condition(tcfg, tst, T_(tr), qp_iters=30, plan=tplan,
                                      ess_online=T_(mask))
        _bitwise(jtel.safemode_mode, ttel.safemode_mode, "modes")
        modes.append(ttel.safemode_mode.numpy())
        cmds.append(ttel.command.numpy())
    for name, a, b in zip(jst.safemode._fields, jst.safemode, tst.safemode):
        _bitwise(a, b, name)
    mode, cmd = np.concatenate(modes), np.concatenate(cmds)
    assert modes[0][0, 0] == tsm.PASSTHROUGH and mode[-1, 0] == tsm.NORMAL
    sm = tst.safemode
    assert (int(sm.passthrough_entries[0]), int(sm.quarantine_entries[0]),
            int(sm.readmissions[0])) == (1, 0, 1)
    assert (cmd[mode != tsm.NORMAL] == 0.0).all()
    assert (mode[:, 1:] == tsm.NORMAL).all()


# ------------------------------------------------------------ beyond them


LEAVES = ["soc", "g_filter", "filter_state", "u_prev", "cmd_applied", "cmd_target", "soc_ema",
          "warm.x", "warm.z", "warm.y", "health.cycle_damage", "health.soc_sq_sum",
          "health.prev_soc"]


def _corrupt(st, leaf, rack, value):
    """``st`` with ``value`` written into rack ``rack`` of the JAX leaf named
    ``leaf``."""
    if leaf in ("soc", "g_filter"):
        es = st.ess_state
        return st._replace(ess_state=es._replace(**{leaf: getattr(es, leaf).at[rack].set(value)}))
    if leaf.startswith("warm."):
        w, name = st.qp_warm, leaf[5:]
        return st._replace(qp_warm=w._replace(**{name: getattr(w, name).at[:, rack].set(value)}))
    if leaf.startswith("health."):
        h, name = st.health, leaf[7:]
        return st._replace(health=h._replace(**{name: getattr(h, name).at[rack].set(value)}))
    return st._replace(**{leaf: getattr(st, leaf).at[rack].set(value)})


def test_each_leaf_kind_quarantines():
    """A non-finite value in any kind of carried leaf quarantines its rack
    and only it (rack i holds LEAVES[i], the last rack none), and the
    sanitizer repairs the state, as in JAX."""
    n = len(LEAVES) + 1
    cfg = _jcfg(safemode=True, track_health=True, safemode_params=jsm.SafeModeConfig.create(
        readmit_intervals=2))
    trace = _wavy_trace(4, n)
    st = jpdu.init_state(cfg, jnp.asarray(trace[0]))
    # Move the state off its initial values first, so that the repair has
    # something to keep.
    _, st, _ = jpdu.condition(cfg, st, jnp.asarray(trace[:K]), qp_iters=30)
    for rack, leaf in enumerate(LEAVES):
        st = _corrupt(st, leaf, rack, jnp.inf if leaf in ("u_prev", "warm.y") else jnp.nan)
    j, t, _ = _run_both(cfg, st, trace[K:])
    _assert_parity(j, t)
    mode = t[2].safemode_mode.numpy()
    assert mode[0].tolist() == [tsm.QUARANTINE] * (n - 1) + [tsm.NORMAL]
    assert mode[-1].tolist() == [tsm.NORMAL] * n  # two clean probes re-admit them
    assert t[1].safemode.quarantine_entries.tolist() == [1] * (n - 1) + [0]
    for x in tfleet._tree_leaves(t[1]):
        assert torch.isfinite(x.double()).all()


@pytest.fixture(scope="module")
def faulty():
    """A JAX-rendered faulty campus (8 racks, 30 s at 100 Hz: its NaN
    sensor dropouts and ESS trips) and its schedule in both packages."""
    js = JSC.mixed_campus(8, ("llama3_2_1b", "qwen1_5_4b"), duration_s=30.0, sample_hz=100.0,
                          seed=2)
    proc = JF.FaultProcess.create(rack_mtbf_s=20.0, rack_mttr_s=6.0, ess_mtbf_s=12.0,
                                  ess_mttr_s=6.0, sensor_mtbf_s=10.0, sensor_mttr_s=3.0)
    js = JSC.attach_faults(js, proc, seed=11)
    tr = np.asarray(JSC.render(js, 0, js.total_samples))
    assert np.isnan(tr).any()
    return dict(js=js, tr=tr, tsched=convert.fault_schedule_from_numpy(
        convert.numpy_tree(js.faults), device="cpu"))


def test_faults_under_safemode_take_the_streamed_arrays(faulty):
    """With ``faults=`` a supervised call derives the streamed mask and
    weight at ``chunk_start``: bit for bit the call given those arrays,
    chunked or whole, and close to JAX's."""
    js, tr, sched = faulty["js"], faulty["tr"], faulty["tsched"]
    jcfg = _jcfg(degraded_mode=True, safemode=True)
    # A rack the schedule keeps online while its poisoned solves trip it
    # (an offline interval would reset its warm iterates first).
    rack = chip_smoke.drill_online_racks(sched, 3, K)[0]
    jst = _poison_warm(jpdu.init_state(jcfg, jnp.asarray(tr[0])), [rack])
    edge = js.edge_width
    tcfg, tst, tplan = _carry(jcfg, jst)
    jt = jpdu.condition(jcfg, jst, jnp.asarray(tr), qp_iters=30, faults=js.faults,
                        fault_edge=edge)
    t = tpdu.condition(tcfg, tst, T_(tr), qp_iters=30, plan=tplan, faults=sched,
                       fault_edge=edge)
    _assert_parity(jt, t)
    _bitwise(jt[2].ess_online, t[2].ess_online, "applied availability")
    n = tr.shape[0]
    on = TF.interval_online(sched, 0, -(-n // K), K)
    wt = TF.ess_weight(sched, 0, n, edge)
    streamed = tpdu.condition(tcfg, tst, T_(tr), qp_iters=30, plan=tplan, ess_online=on,
                              ess_weight=wt)
    assert torch.equal(streamed[0], t[0])
    for x, y in zip(tfleet._tree_leaves(streamed[1]), tfleet._tree_leaves(t[1]), strict=True):
        assert torch.equal(x, y)
    # Chunked at an interval boundary inside the soup, the start a tensor
    # (as the scanned engine's graph reads it).
    cut = 2 * K
    g1, st1, t1 = tpdu.condition(tcfg, tst, T_(tr[:cut]), qp_iters=30, plan=tplan, faults=sched,
                                 fault_edge=edge)
    g2, st2, t2 = tpdu.condition(tcfg, st1, T_(tr[cut:]), qp_iters=30, plan=tplan, faults=sched,
                                 chunk_start=torch.tensor(cut, dtype=torch.int32),
                                 fault_edge=edge)
    assert torch.equal(torch.cat([g1, g2]), t[0])
    assert torch.equal(torch.cat([t1.safemode_mode, t2.safemode_mode]), t[2].safemode_mode)
    for x, y in zip(tfleet._tree_leaves(st2), tfleet._tree_leaves(t[1]), strict=True):
        assert torch.equal(x, y)
    assert int(t[1].safemode.passthrough_entries[rack]) == 1


def test_use_plan_false_under_safemode():
    """The per-step oracle supervised: its warm iterates ride through, the
    sanitizer and the watchdog act as on the plan's path."""
    cfg = _jcfg(safemode=True, track_health=True, safemode_params=jsm.SafeModeConfig.create(
        readmit_intervals=2))
    trace = _wavy_trace(4, 3)
    st = jpdu.init_state(cfg, jnp.asarray(trace[0]))
    st = _corrupt(st, "soc_ema", 2, jnp.nan)
    j, t, _ = _run_both(cfg, st, trace, use_plan=False)
    _assert_parity(j, t)
    assert t[2].safemode_mode[0].tolist() == [0, 0, tsm.QUARANTINE]
    assert t[2].safemode_mode[-1].tolist() == [0, 0, 0]
