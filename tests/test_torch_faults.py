"""Parity of the port's fault engine (``repro_torch.power.faults``) and its
faulty render with the JAX package, on the CPU.

* The numpy threefry-2x32 ``uniform``: bitwise against ``jax.random``.
* ``sample_schedule``, ``schedule_from_episodes``, ``inject_episodes``:
  the integer tables and ``p_fault`` bitwise.
* Every signal (``rack_down``, ``fault_weight``, ``ess_weight``,
  ``sensor_down``, ``interval_online``, ``interval_sensed``,
  ``sensor_dark_hold``): bitwise under both membership backends, at
  several window starts and edges, and chunk-invariant.
* The faulty render: NaN positions equal; finite samples within the
  renderer's 1e-6 absolute tolerance (``tests/test_torch_scenario.py``:
  the base waveform's cos and noise rounding), and bitwise chunk-invariant.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet as JFL
from repro.power import faults as JF, scenario as JSC
from repro_torch.core import fleet as TFL
from repro_torch.power import faults as TF, scenario as TSC

torch.set_num_threads(1)
_HZ = 100.0
_FIELDS = ("rack_start", "rack_end", "ess_start", "ess_end", "sensor_start", "sensor_end",
           "p_fault")


def _rates(**kw):
    base = dict(rack_mtbf_s=50.0, rack_mttr_s=15.0, ess_mtbf_s=40.0, ess_mttr_s=10.0,
                sensor_mtbf_s=30.0, sensor_mttr_s=5.0)
    base.update(kw)
    return base


def _assert_schedules_equal(t, j):
    for name in _FIELDS:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
        assert getattr(t, name).numpy().dtype == np.asarray(getattr(j, name)).dtype, name


def _schedules():
    """(port, JAX) pairs over both padding conventions: stochastic
    (trace-end clamped empty slots), a cascade injected on top, and a
    scripted table with mixed episode counts (int32-max padding)."""
    js = JF.sample_schedule(JF.FaultProcess.create(**_rates()), 6, 9000, _HZ, seed=5)
    ts = TF.sample_schedule(TF.FaultProcess.create(**_rates()), 6, 9000, _HZ, seed=5,
                            device="cpu")
    inj = dict(rack=[(i, 4000 + i * 37, 4600 + i * 41) for i in range(6)],
               sensor=[(2, 8000, 8999)])
    scripted = dict(
        rack=[(0, 100, 200), (0, 300, 400), (0, 450, 470), (1, 50, 60)],
        ess=[(2, 10, 900), (2, 2000, 2400), (4, 8990, 9000)],
        sensor=[(3, 120, 180)],
    )
    return {
        "stochastic": (ts, js),
        "cascade": (TF.inject_episodes(ts, **inj), JF.inject_episodes(js, **inj)),
        "scripted": (TF.schedule_from_episodes(6, device="cpu", **scripted),
                     JF.schedule_from_episodes(6, **scripted)),
    }


@pytest.fixture(scope="module")
def schedules():
    return _schedules()


# ------------------------------------------------------------ random bits


@pytest.mark.parametrize("seed", [0, 3, 6, -7, 2**31 - 1])
def test_threefry_uniform_bitwise_vs_jax(seed):
    for tag in (0, 1, 2):
        for n_racks, k in ((1, 1), (5, 3), (17, 9)):
            ck = jax.random.fold_in(jax.random.key(seed), tag)
            want = np.asarray(jax.vmap(lambda r: jax.random.uniform(
                jax.random.fold_in(ck, r), (k, 2), jnp.float32, minval=1e-7, maxval=1.0
            ))(jnp.arange(n_racks, dtype=jnp.int32)))
            tk = TF._fold_in(TF._key(seed), np.uint32(tag))
            rk = TF._fold_in((np.full(n_racks, tk[0]), np.full(n_racks, tk[1])),
                             np.arange(n_racks, dtype=np.uint32))
            got = TF._uniform(rk, 2 * k, 1e-7, 1.0).reshape(n_racks, k, 2)
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_key_rejects_seeds_outside_int32():
    with pytest.raises(ValueError):
        TF._key(2**31)


# ----------------------------------------------------------- construction


@pytest.mark.parametrize("seed", [1, 6])
@pytest.mark.parametrize("geometry", [(8, 12000, 100.0, None), (33, 17600, 200.0, None),
                                      (4, 9000, 100.0, 40)])
def test_sample_schedule_bitwise_vs_jax(seed, geometry):
    n, total, hz, max_ep = geometry
    rates = _rates(rack_mtbf_s=np.linspace(40.0, 90.0, n, dtype=np.float32))
    j = JF.sample_schedule(JF.FaultProcess.create(**rates), n, total, hz, seed=seed,
                           max_episodes=max_ep)
    t = TF.sample_schedule(TF.FaultProcess.create(**rates), n, total, hz, seed=seed,
                           max_episodes=max_ep, device="cpu")
    _assert_schedules_equal(t, j)
    assert np.any(t.ess_end.numpy() > t.ess_start.numpy())


def test_sample_schedule_is_deterministic_and_seeded():
    p = TF.FaultProcess.create(**_rates())
    a = TF.sample_schedule(p, 8, 12000, _HZ, seed=3, device="cpu")
    b = TF.sample_schedule(p, 8, 12000, _HZ, seed=3, device="cpu")
    c = TF.sample_schedule(p, 8, 12000, _HZ, seed=4, device="cpu")
    _assert_schedules_equal(a, b)
    assert not torch.equal(a.ess_start, c.ess_start)


def test_construction_errors_match_jax():
    for bad in (dict(ess_mtbf_s=0.0), dict(sensor_mttr_s=-1.0)):
        with pytest.raises(ValueError):
            JF.FaultProcess.create(**_rates(**bad))
        with pytest.raises(ValueError):
            TF.FaultProcess.create(**_rates(**bad))
    p = TF.FaultProcess.create(**_rates())
    for args in ((p, 0, 100, _HZ), (p, 4, 0, _HZ)):
        with pytest.raises(ValueError):
            TF.sample_schedule(*args, seed=0, device="cpu")
    for eps in ([(4, 0, 10)], [(0, 10, 5)], [(0, -1, 5)]):
        with pytest.raises(ValueError):
            JF.schedule_from_episodes(4, rack=eps)
        with pytest.raises(ValueError):
            TF.schedule_from_episodes(4, rack=eps, device="cpu")
        s = TF.schedule_from_episodes(4, device="cpu")
        with pytest.raises(ValueError):
            TF.inject_episodes(s, ess=eps)


def test_scripted_and_injected_tables_bitwise(schedules):
    for name, (t, j) in schedules.items():
        _assert_schedules_equal(t, j)
        TF.validate_tables(t)
    # Overlapping and adjacent episodes coalesce, as the reference's.
    eps = dict(rack=[(1, 10, 20), (1, 15, 30), (1, 30, 40), (2, 5, 6)])
    _assert_schedules_equal(TF.schedule_from_episodes(3, device="cpu", **eps),
                            JF.schedule_from_episodes(3, **eps))


def test_validate_tables_errors():
    good = TF.schedule_from_episodes(
        3, ess=[(2, 10, 900), (2, 2000, 2400)], device="cpu")
    cases = {
        "inverted": dict(ess_end=good.ess_end.clone().index_put_(
            (torch.tensor([2]), torch.tensor([0])), torch.tensor([5], dtype=torch.int32))),
        "unsorted": dict(ess_start=good.ess_start.clone().index_put_(
            (torch.tensor([2]), torch.tensor([1])), torch.tensor([5], dtype=torch.int32))),
        "overlap": dict(ess_start=good.ess_start.clone().index_put_(
            (torch.tensor([2]), torch.tensor([1])), torch.tensor([900], dtype=torch.int32))),
        "shape": dict(ess_end=good.ess_end[:, :1]),
    }
    for name, change in cases.items():
        with pytest.raises(ValueError):
            TF.validate_tables(dataclasses.replace(good, **change))
    pad_first = torch.tensor([[2**31 - 1, 5]], dtype=torch.int32)
    with pytest.raises(ValueError):
        TF.validate_tables(dataclasses.replace(
            TF.schedule_from_episodes(1, device="cpu"),
            **{f"{c}_{e}": pad_first if e == "start" else torch.tensor(
                [[2**31 - 1, 9]], dtype=torch.int32) for c in ("rack", "ess", "sensor")
               for e in ("start", "end")}))


# ---------------------------------------------------------------- signals

_WINDOWS = ((0, 9000), (123, 2000), (4391, 777), (8800, 200))
_SIGNALS = {
    "rack_down": lambda m, s, t0, n, meth: m.rack_down(s, t0, n, method=meth),
    "sensor_down": lambda m, s, t0, n, meth: m.sensor_down(s, t0, n, method=meth),
    "fault_weight_e7": lambda m, s, t0, n, meth: m.fault_weight(s, t0, n, 7, method=meth),
    "fault_weight_e1": lambda m, s, t0, n, meth: m.fault_weight(s, t0, n, 1, method=meth),
    "ess_weight_e7": lambda m, s, t0, n, meth: m.ess_weight(s, t0, n, 7, method=meth),
    "ess_weight_e50": lambda m, s, t0, n, meth: m.ess_weight(s, t0, n, 50, method=meth),
    "ess_weight_e0": lambda m, s, t0, n, meth: m.ess_weight(s, t0, n, 0, method=meth),
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("method", ["legacy", "compiled"])
@pytest.mark.parametrize("fn_name", sorted(_SIGNALS))
def test_signals_bitwise_vs_jax(schedules, fn_name, method):
    fn = _SIGNALS[fn_name]
    for t, j in schedules.values():
        for t0, n in _WINDOWS:
            got = _np(fn(TF, t, t0, n, method))
            want = _np(fn(JF, j, t0, n, method))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f"{fn_name} {t0}")


@pytest.mark.parametrize("chunk", [700, 1500])
def test_signals_chunk_invariant(schedules, chunk):
    for t, _ in schedules.values():
        for edge in (1, 7):
            for fn in (TF.fault_weight, TF.ess_weight):
                whole = fn(t, 0, 9000, edge)
                parts = torch.cat([fn(t, t0, min(chunk, 9000 - t0), edge)
                                   for t0 in range(0, 9000, chunk)])
                assert torch.equal(whole, parts)


@pytest.mark.parametrize("method", ["legacy", "compiled"])
def test_interval_masks_bitwise_vs_jax(schedules, method):
    k = 500
    for t, j in schedules.values():
        for t0, n_int, stop in ((0, 12, None), (3 * k, 12, None), (1000, 4, 1000 + 3 * k + 137)):
            np.testing.assert_array_equal(
                TF.interval_online(t, t0, n_int, k, method=method).numpy(),
                np.asarray(JF.interval_online(j, t0, n_int, k, method=method)))
            np.testing.assert_array_equal(
                TF.interval_sensed(t, t0, n_int, k, stop=stop, method=method).numpy(),
                np.asarray(JF.interval_sensed(j, t0, n_int, k, stop=stop, method=method)))


@pytest.mark.parametrize("method", ["legacy", "compiled"])
def test_sensor_dark_hold_bitwise_vs_jax(schedules, method):
    for t, j in schedules.values():
        for lo, hi in ((0, 9000), (1000, 3000)):
            d_t, h_t = TF.sensor_dark_hold(t, torch.arange(lo, hi, dtype=torch.int32),
                                           method=method)
            d_j, h_j = JF.sensor_dark_hold(j, jnp.arange(lo, hi, dtype=jnp.int32),
                                           method=method)
            np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
            dark = d_t.numpy()
            np.testing.assert_array_equal(h_t.numpy()[dark], np.asarray(h_j)[dark])


def test_auto_method_falls_back_past_unroll_limit():
    wide = TF.sample_schedule(TF.FaultProcess.create(**_rates()), 4, 9000, _HZ, seed=5,
                              max_episodes=TF._UNROLL_MAX + 8, device="cpu")
    assert wide.rack_start.shape[1] > TF._UNROLL_MAX
    assert TF._resolve_method("auto", wide.rack_start.shape[1]) == "legacy"
    assert TF._resolve_method("auto", 4) == "compiled"
    assert torch.equal(TF.rack_down(wide, 0, 9000, method="legacy"),
                       TF.rack_down(wide, 0, 9000, method="compiled"))
    with pytest.raises(ValueError):
        TF._resolve_method("fast", 4)


def test_episodes_in_window_equals_jax(schedules):
    for t, j in schedules.values():
        for lo, hi in ((0, 9000), (2500, 6000)):
            assert TF.episodes_in_window(t, lo, hi) == JF.episodes_in_window(j, lo, hi)


# ----------------------------------------------------------- faulty render


@pytest.fixture(scope="module")
def faulty_campuses():
    kw = dict(duration_s=30.0, sample_hz=_HZ, seed=3, fault_rack_fraction=0.0,
              edge_pad="clamp", noise_seed=2)
    archs = ("llama3_2_1b", "deepseek_v3_671b", "chatglm3_6b", "whisper_large_v3")
    js = JSC.mixed_campus(12, archs, **kw)
    ts = TSC.mixed_campus(12, archs, device="cpu", **kw)
    rates = _rates(rack_mtbf_s=12.0, rack_mttr_s=4.0, sensor_mtbf_s=10.0, sensor_mttr_s=1.5)
    js = JSC.attach_faults(js, JF.FaultProcess.create(**rates), seed=6)
    ts = TSC.attach_faults(ts, TF.FaultProcess.create(**rates), seed=6)
    return ts, js


def test_attach_faults_bitwise_and_checks(faulty_campuses):
    ts, js = faulty_campuses
    _assert_schedules_equal(ts.faults, js.faults)
    sched = TF.schedule_from_episodes(5, rack=[(0, 1, 2)], device="cpu")
    with pytest.raises(ValueError):
        TSC.attach_faults(ts.replace(faults=None), sched)
    bad = dataclasses.replace(ts.faults, ess_end=ts.faults.ess_start - 1)
    with pytest.raises(ValueError):
        TSC.attach_faults(ts.replace(faults=None), bad)
    # A schedule is also accepted directly, and lands on the scenario's device.
    again = TSC.attach_faults(ts.replace(faults=None), ts.faults)
    _assert_schedules_equal(again.faults, js.faults)


def test_faulty_render_matches_jax(faulty_campuses):
    ts, js = faulty_campuses
    got = TSC.render(ts, 0, ts.total_samples).numpy()
    want = np.asarray(JSC.render(js, 0, js.total_samples))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any(), "the schedule produced no sensor dropout"
    down = TF.fault_weight(ts.faults, 0, ts.total_samples, ts.edge_width).numpy()
    assert (down == 1.0).any() and ((down > 0) & (down < 1)).any()
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)


def test_faulty_render_chunk_bitwise(faulty_campuses):
    ts, _ = faulty_campuses
    whole = TSC.render(ts, 0, ts.total_samples)
    parts = torch.cat([TSC.render(ts, t0, min(700, ts.total_samples - t0))
                       for t0 in range(0, ts.total_samples, 700)])
    assert torch.equal(torch.isnan(whole), torch.isnan(parts))
    assert torch.equal(torch.nan_to_num(whole, nan=-1.0), torch.nan_to_num(parts, nan=-1.0))


def test_apply_failures_matches_jax():
    rng = np.random.default_rng(0)
    traces = rng.uniform(0.2, 0.9, (100, 4)).astype(np.float32)
    fail = np.asarray([-1, 40, 70, 0])
    want = np.asarray(JFL.apply_failures(jnp.asarray(traces), jnp.asarray(fail), p_idle=0.1))
    got = TFL.apply_failures(torch.as_tensor(traces), torch.as_tensor(fail), p_idle=0.1)
    np.testing.assert_array_equal(got.numpy(), want)
