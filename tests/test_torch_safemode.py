"""The port's safe-mode supervisor (``core.safemode``), the wear fold outside
the kernel (``health.update`` / ``update_consts`` / ``reinit_where``) and
``ops.pdu_health_sim``'s ``guard=`` epilogue, against the JAX package on the
CPU.

* The state machine: the reference's six unit tests mirrored, and every
  function (``gate``, ``quarantine``, ``residual_update``,
  ``chunk_snapshot``, ``summary``) bit for bit against JAX's on seeded
  residual and corruption sequences (int32 counters and float32 snapshots
  of counts: exact arithmetic in both).
* The wear fold: the turning-point machine's leaves bitwise (the same
  float32 operations and fused multiply-add as XLA's scan), at kappa 2 (the
  default), 1, 3 and 2.5; the block reductions (charge / discharge, SoC and
  SoC^2 sums) within 1e-6 relative (reduction order, as ROADMAP.md says of
  ``soc_sq_sum``).  ``update_consts`` equals the plain ``pdu_health_sim``'s
  own fold bit for bit, since both run ``ref.wear_step``.
* The guard: non-finite grid samples become the rack samples, finite ones
  stay bit for bit, on the plain route and on the kernel route (the launch
  replaced by a stand-in on the CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import health as jhlt, safemode as jsm
from repro.kernels import ops as jops
from repro_torch.core import health as thlt, safemode as tsm
from repro_torch.kernels import ops as tops, pdu_health as tph, ref as tref

torch.set_num_threads(1)
T_ = lambda a: torch.from_numpy(np.array(a))


def _bitwise(a, b, what=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), f"{what}: {np.sum(a != b)} differ"


def _cfg(**kw):
    return tsm.SafeModeConfig.create(device="cpu", **kw)


# ----------------------------------------------------------- state machine


def test_trip_requires_consecutive_intervals():
    cfg = _cfg(resid_threshold=0.1, trip_intervals=3)
    st = tsm.init_state((2,), device="cpu")
    bad = torch.tensor([1.0, 0.0])
    for i in range(2):
        st = tsm.residual_update(cfg, st, bad)
        assert int(st.mode[0]) == tsm.NORMAL, f"tripped early at {i}"
    st = tsm.residual_update(cfg, st, bad)
    assert int(st.mode[0]) == tsm.PASSTHROUGH and int(st.mode[1]) == tsm.NORMAL
    assert int(st.passthrough_entries[0]) == 1 and int(st.worst_streak[0]) == 3


def test_nonconsecutive_residuals_do_not_trip():
    cfg = _cfg(resid_threshold=0.1, trip_intervals=2)
    st = tsm.init_state((), device="cpu")
    for r in (1.0, 0.0, 1.0, 0.0, 1.0, 0.0):
        st = tsm.residual_update(cfg, st, torch.tensor(r))
    assert int(st.mode) == tsm.NORMAL
    assert int(st.passthrough_entries) == 0 and int(st.worst_streak) == 1


def test_nan_residual_counts_as_bad():
    cfg = _cfg(resid_threshold=0.1, trip_intervals=2)
    st = tsm.init_state((), device="cpu")
    for _ in range(2):
        st = tsm.residual_update(cfg, st, torch.tensor(float("nan")))
    assert int(st.mode) == tsm.PASSTHROUGH


def test_hysteretic_readmission():
    cfg = _cfg(resid_threshold=0.1, trip_intervals=1, readmit_intervals=3)
    st = tsm.init_state((), device="cpu")
    st = tsm.residual_update(cfg, st, torch.tensor(1.0))
    assert int(st.mode) == tsm.PASSTHROUGH
    for r in (0.0, 1.0, 0.0, 0.0):  # an interrupted run of clean probes restarts
        st = tsm.residual_update(cfg, st, torch.tensor(r))
    assert int(st.mode) == tsm.PASSTHROUGH
    st = tsm.residual_update(cfg, st, torch.tensor(0.0))
    assert int(st.mode) == tsm.NORMAL
    assert int(st.readmissions) == 1 and int(st.clean_streak) == 0


def test_quarantine_counts_every_event_and_gates():
    st = tsm.init_state((3,), device="cpu")
    corrupt = torch.tensor([True, False, False])
    st = tsm.quarantine(tsm.quarantine(st, corrupt), corrupt)
    assert int(st.mode[0]) == tsm.QUARANTINE and int(st.quarantine_entries[0]) == 2
    assert torch.equal(tsm.gate(st), torch.tensor([0.0, 1.0, 1.0]))


def test_quarantined_rack_readmits_on_clean_probes():
    cfg = _cfg(trip_intervals=1, readmit_intervals=2)
    st = tsm.quarantine(tsm.init_state((), device="cpu"), torch.tensor(True))
    for _ in range(2):
        st = tsm.residual_update(cfg, st, torch.tensor(0.0))
    assert int(st.mode) == tsm.NORMAL and int(st.readmissions) == 1


def test_config_validation_and_state_buffers():
    with pytest.raises(ValueError, match="trip_intervals"):
        _cfg(trip_intervals=0)
    with pytest.raises(ValueError, match="readmit_intervals"):
        _cfg(readmit_intervals=0)
    st = tsm.init_state((4,), device="cpu")
    assert [t.dtype for t in st] == [torch.int32] * 7 + [torch.float32]
    assert len({t.data_ptr() for t in st}) == 8  # one buffer per leaf


@pytest.mark.parametrize("n_racks", [1, 6, 8])
@pytest.mark.parametrize("trip,readmit", [(1, 1), (2, 3), (3, 8)])
def test_state_machine_matches_jax_bitwise(n_racks, trip, readmit):
    """A seeded sequence of residuals (over and under the threshold, NaN,
    inf) and corruption events through both packages' supervisors, every
    leaf, gate, snapshot and summary compared after each step."""
    rng = np.random.default_rng(100 * trip + n_racks)
    jcfg = jsm.SafeModeConfig.create(resid_threshold=0.05, trip_intervals=trip,
                                     readmit_intervals=readmit)
    tcfg = _cfg(resid_threshold=0.05, trip_intervals=trip, readmit_intervals=readmit)
    js, ts = jsm.init_state((n_racks,)), tsm.init_state((n_racks,), device="cpu")
    for step in range(40):
        resid = rng.choice([0.01, 0.049, 0.05, 0.0501, 0.3, np.nan, np.inf], n_racks,
                           p=[0.4, 0.1, 0.05, 0.05, 0.3, 0.05, 0.05]).astype(np.float32)
        if step < 3:
            resid[0] = 1.0  # a divergence long enough to trip rack 0
        if step % 7 == 3:
            corrupt = rng.uniform(size=n_racks) < 0.3
            corrupt[step % n_racks] = True
            js, ts = jsm.quarantine(js, jnp.asarray(corrupt)), tsm.quarantine(ts, T_(corrupt))
        js = jsm.residual_update(jcfg, js, jnp.asarray(resid))
        ts = tsm.residual_update(tcfg, ts, T_(resid))
        for name, a, b in zip(js._fields, js, ts):
            _bitwise(a, b, f"step {step}: {name}")
        _bitwise(jsm.gate(js), tsm.gate(ts), "gate")
        _bitwise(jsm.chunk_snapshot(js), tsm.chunk_snapshot(ts), "snapshot")
        assert jsm.summary(js) == tsm.summary(ts)
    assert int(ts.passthrough_entries.sum()) > 0 and int(ts.quarantine_entries.sum()) > 0


def test_unbatched_summary_and_snapshot():
    st = tsm.quarantine(tsm.init_state((), device="cpu"), torch.tensor(True))
    js = jsm.quarantine(jsm.init_state(()), jnp.asarray(True))
    assert tsm.summary(st) == jsm.summary(js)
    _bitwise(jsm.chunk_snapshot(js), tsm.chunk_snapshot(st))


# --------------------------------------------------------------- wear fold


def _soc_blocks(t, r, seed):
    """SoC paths that reverse often (a sawtooth with noise and flat runs)."""
    rng = np.random.default_rng(seed)
    base = 0.5 + 0.2 * np.sin(np.arange(t)[:, None] / rng.uniform(3, 30, r)[None, :])
    soc = base + 1e-3 * rng.standard_normal((t, r))
    soc[t // 3 : t // 3 + 20] = soc[t // 3]  # a rest
    return soc.astype(np.float32)


def _close_sums(j, t, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=0.0, err_msg=what)


@pytest.mark.parametrize("kappa", [2.0, 1.0, 3.0, 2.5])
def test_update_matches_jax(kappa):
    soc = _soc_blocks(300, 5, seed=int(kappa * 10))
    jp = jhlt.HealthParams.create(kappa=kappa, rest_eps=1e-4)
    tp = thlt.HealthParams.create(kappa=kappa, rest_eps=1e-4, device="cpu")
    js = jhlt.init_state(jnp.asarray(soc[0]))
    ts = thlt.init_state(T_(soc[0]))
    # Three blocks, the state carried: one interval a block, as the engines fold.
    for lo, hi in ((0, 100), (100, 250), (250, 300)):
        js = jhlt.update(jp, js, jnp.asarray(soc[lo:hi]), 1e-2)
        ts = thlt.update(tp, ts, T_(soc[lo:hi]), 1e-2)
        for name, a, b in zip(js._fields, js, ts):
            if name in ("charge_soc", "discharge_soc", "soc_sum", "soc_sq_sum"):
                _close_sums(a, b, name)
            elif kappa == 2.5 and name == "cycle_damage":
                # torch.pow and XLA's pow may round differently.
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=0)
            else:
                _bitwise(a, b, f"kappa {kappa}: {name}")
    assert float(ts.half_cycles.min()) > 2


@pytest.mark.parametrize("kappa", [1.0, 3.0, 2.5])
def test_update_consts_is_the_kernel_fold(kappa):
    """``update_consts`` on a SoC path equals the plain ``pdu_health_sim``'s
    fold of the same path bit for bit (one code: ``ref.wear_step``)."""
    t, r = 200, 4
    rng = np.random.default_rng(3)
    rack = (0.5 + 0.4 * (rng.uniform(size=(t // 10, r)) > 0.5)).repeat(10, 0).astype(np.float32)
    tp = thlt.HealthParams.create(kappa=kappa, device="cpu")
    consts = thlt.step_consts(tp)
    soc0 = torch.full((r,), 0.5)
    hs = thlt.init_state(soc0)
    ad = torch.tensor([[0.9, 0.01, 0.0], [0.0, 0.95, 0.02], [0.01, 0.0, 0.97]])
    bd = torch.tensor([[0.0, 0.01], [0.0, 0.02], [0.0, 0.0]])
    kw = dict(beta=0.0625, dt=1e-2, q_max=40.0, eta_c=0.97, eta_d=0.97, p_max=1.0, soc_min=0.1,
              soc_max=0.9)
    _, soc_t, _, h = tref.pdu_health_sim(T_(rack), T_(rack[0]), soc0, torch.zeros(r, 3), ad, bd,
                                         torch.tensor([1.0, 0.0, 0.0]), health=(consts, tuple(hs)),
                                         **kw)
    folded = thlt.update_consts(consts, hs, soc_t)
    for name, a, b in zip(thlt.HealthState._fields, h, folded):
        _bitwise(a, b, name)


def test_update_unbatched_and_nd():
    """Any batch shape folds rack by rack: the machine's leaves bitwise, the
    block sums to their reduction order (a (T, 1) sum rounds otherwise
    than a column of a (T, 6) one)."""
    soc = _soc_blocks(120, 6, seed=9)
    p = thlt.HealthParams.create(device="cpu")
    whole = thlt.update(p, thlt.init_state(T_(soc[0])), T_(soc), 1e-2)
    nd = thlt.update(p, thlt.init_state(T_(soc[0]).reshape(2, 3)), T_(soc).reshape(120, 2, 3), 1e-2)
    one = thlt.update(p, thlt.init_state(T_(soc[0, 2])), T_(soc[:, 2]), 1e-2)
    for name, a, b, c in zip(thlt.HealthState._fields, whole, nd, one):
        assert b.shape == (2, 3) and c.shape == ()
        if name in ("charge_soc", "discharge_soc", "soc_sum", "soc_sq_sum"):
            _close_sums(a.reshape(2, 3), b, name)
            _close_sums(a[2], c, name)
        else:
            assert torch.equal(a.reshape(2, 3), b) and torch.equal(a[2], c), name


def test_reinit_where_matches_jax():
    soc = _soc_blocks(100, 5, seed=4)
    jp, tp = jhlt.HealthParams.create(), thlt.HealthParams.create(device="cpu")
    js = jhlt.update(jp, jhlt.init_state(jnp.asarray(soc[0])), jnp.asarray(soc), 1e-2)
    ts = thlt.update(tp, thlt.init_state(T_(soc[0])), T_(soc), 1e-2)
    mask = np.array([False, True, False, True, False])
    ts = ts._replace(cycle_damage=torch.where(T_(mask), float("nan"), ts.cycle_damage))
    js = js._replace(cycle_damage=jnp.where(jnp.asarray(mask), jnp.nan, js.cycle_damage))
    for soc0 in (0.5, torch.tensor(0.62)):
        j2 = jhlt.reinit_where(js, jnp.asarray(mask), float(soc0))
        t2 = thlt.reinit_where(ts, T_(mask), soc0)
        for name, a, b in zip(js._fields, j2, t2):
            if name in ("charge_soc", "discharge_soc", "soc_sum", "soc_sq_sum"):
                _close_sums(a, b, name)
            else:
                _bitwise(a, b, name)
        assert all(torch.isfinite(leaf.float()).all() for leaf in t2)
    # An all-false mask is the identity.
    same = thlt.reinit_where(ts, torch.zeros(5, dtype=torch.bool), 0.5)
    for a, b in zip(ts, same):
        assert torch.equal(a, b) or (torch.isnan(a) == torch.isnan(b)).all()


# ------------------------------------------------------------------ guard


def _interval(t=120, r=5, seed=0):
    rng = np.random.default_rng(seed)
    rack = np.clip(0.6 + 0.2 * rng.standard_normal((t, r)), 0, 1).astype(np.float32)
    ad = np.array([[0.9, 0.01, 0.0], [0.0, 0.95, 0.02], [0.01, 0.0, 0.97]], np.float32)
    bd = np.array([[0.0, 0.01], [0.0, 0.02], [0.0, 0.0]], np.float32)
    args = (rack, rack[0].copy(), np.full(r, 0.5, np.float32), np.zeros((r, 3), np.float32),
            ad, bd, np.array([1.0, 0.0, 0.0], np.float32))
    kw = dict(beta=0.0625, dt=1e-2, q_max=40.0, eta_c=0.97, eta_d=0.97, p_max=1.0, soc_min=0.1,
              soc_max=0.9)
    return args, kw


def test_guard_on_the_plain_route_matches_jax():
    args, kw = _interval()
    x0 = args[3].copy()
    x0[2, 1] = np.nan  # rack 2's LC state poisoned: its grid goes NaN
    args = args[:3] + (x0,) + args[4:]
    for guard in (False, True):
        j = jops.pdu_health_sim(*(jnp.asarray(a) for a in args), guard=guard, force="ref", **kw)
        t = tops.pdu_health_sim(*(T_(a) for a in args), guard=guard, **kw)
        grid_j, grid_t = np.asarray(j[0]), t[0].numpy()
        assert np.array_equal(np.isnan(grid_j), np.isnan(grid_t))
        np.testing.assert_allclose(grid_t, grid_j, rtol=0, atol=1e-6)
        assert np.isnan(grid_t).any() != guard
    plain = tops.pdu_health_sim(*(T_(a) for a in args), **kw)
    guarded = tops.pdu_health_sim(*(T_(a) for a in args), guard=True, **kw)
    bad = torch.isnan(plain[0])
    assert bad[:, 2].all() and not bad[:, [0, 1, 3, 4]].any()
    assert torch.equal(guarded[0][bad], T_(args[0])[bad])
    assert torch.equal(guarded[0][~bad], plain[0][~bad])
    # The carried machine state is not guarded.
    assert torch.isnan(guarded[2][2][2]).any()
    for a, b in zip((plain[1], *plain[2]), (guarded[1], *guarded[2])):
        assert torch.equal(torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0))


def test_guard_on_the_kernel_route(monkeypatch):
    """The kernel route runs the same epilogue after its launch (a stand-in
    on the CPU that returns the plain outputs with NaN and inf written into
    the grid)."""
    args, kw = _interval(seed=1)
    targs = tuple(T_(a) for a in args)
    calls = []

    def launch(*a, **k):
        calls.append(1)
        grid, soc_t, finals, h = tref.pdu_health_sim(*a, **k)
        grid = grid.clone()
        grid[5:9, 1] = float("nan")
        grid[40, 3] = float("inf")
        return grid, soc_t, finals, h

    monkeypatch.setattr(tops, "_use_kernel", lambda t, force: True)
    monkeypatch.setattr(tph, "pdu_health_sim", launch)
    raw = tops.pdu_health_sim(*targs, **kw)
    guarded = tops.pdu_health_sim(*targs, guard=True, **kw)
    assert len(calls) == 2
    bad = ~torch.isfinite(raw[0])
    assert int(bad.sum()) == 5
    assert torch.equal(guarded[0][bad], targs[0][bad])
    assert torch.equal(guarded[0][~bad], raw[0][~bad])
    assert torch.isfinite(guarded[0]).all()
