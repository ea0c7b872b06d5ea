"""Parity of the port's leaf math with the JAX package: PDU sizing
(``make_pdu``), the LC filter discretization, the controller plan
(``make_plan``), ``compliance.check`` and both streaming observers.

Tolerances and their reasons:

* ``make_pdu`` and the ZOH discretization run on the host in float64 and
  round to float32 in both packages: bitwise.
* ``make_plan``: float32 Cholesky / triangular solves in LAPACK order
  (PyTorch) versus XLA's: the KKT inverse agrees to 1e-5 relative to its
  largest entry; the assembled matrices that involve no factorization are
  bitwise or within a float32 ulp.
* ``steady_state``: a float32 3x3 solve, 1e-6 absolute.
* Spectra: FFT libraries and window rounding differ, 1e-6 absolute on
  per-unit magnitudes; the ramp observer is exact in the port (chunked
  fold == whole-trace ``max_abs_ramp`` bitwise) and matches the reference
  to float32 rounding of the differences (1e-5 relative); the port's
  spectrum observer (a cosine/sine product per chunk instead of the
  reference's Goertzel recurrence) holds the reference's own contract of
  1e-5 against ``normalized_spectrum`` at the bank lines.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compliance as jcomp, controller as jctrl, filters as jfilt, pdu as jpdu
from repro.power import scenario as JSC
from repro_torch import convert
from repro_torch.core import compliance as tcomp, controller as tctrl, filters as tfilt, \
    pdu as tpdu

torch.set_num_threads(1)
HZ = 200.0


@pytest.fixture(scope="module")
def configs():
    jcfg = jpdu.make_pdu(sample_dt=1.0 / HZ, track_health=True)
    tcfg = tpdu.make_pdu(sample_dt=1.0 / HZ, track_health=True, device="cpu")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def campus_trace():
    """(T, 24) rack traces the JAX package rendered, 30 s at 200 Hz."""
    s = JSC.mixed_campus(24, ("llama3_2_1b", "chatglm3_6b"), duration_s=30.0,
                         sample_hz=HZ, seed=5, noise_seed=1)
    return np.asarray(JSC.render(s, 0, s.total_samples))


def test_make_pdu_matches_jax_bitwise(configs):
    jcfg, tcfg = configs
    j = convert.numpy_tree(jcfg)
    t = convert.numpy_tree(tcfg)
    for group in ("filter_params", "ess_params", "controller", "health"):
        for name, val in j[group].items():
            np.testing.assert_array_equal(np.asarray(t[group][name]), np.asarray(val), err_msg=f"{group}.{name}")
    assert t["sample_dt"] == j["sample_dt"] and t["track_health"] == j["track_health"]


def test_supervised_config_and_state_round_trip():
    """A safe-mode config and a state with a moved supervisor carry across
    from the JAX package (``resid_threshold`` a tensor, the interval counts
    host ints, the eight supervisor leaves), equal the port's own make_pdu
    and round-trip through ``numpy_tree``; a state tree without the
    supervisor carries None."""
    from repro.core import safemode as jsm
    from repro_torch.core import safemode as tsm

    params = dict(resid_threshold=0.07, trip_intervals=2, readmit_intervals=5)
    jcfg = jpdu.make_pdu(sample_dt=1.0 / HZ, degraded_mode=True, safemode=True,
                         safemode_params=jsm.SafeModeConfig.create(**params))
    tcfg = convert.pdu_config_from_numpy(convert.numpy_tree(jcfg), device="cpu")
    own = tpdu.make_pdu(sample_dt=1.0 / HZ, degraded_mode=True, safemode=True, device="cpu",
                        safemode_params=tsm.SafeModeConfig.create(**params, device="cpu"))
    assert tcfg.safemode and tcfg.degraded_mode
    for cfg in (tcfg, own):
        smp = cfg.safemode_params
        assert (smp.trip_intervals, smp.readmit_intervals) == (2, 5)
        assert smp.resid_threshold.dtype == torch.float32
        assert float(smp.resid_threshold) == float(np.float32(0.07))
    assert convert.numpy_tree(tcfg)["safemode_params"] == {**convert.numpy_tree(jcfg)[
        "safemode_params"], "resid_threshold": np.float32(0.07)}
    assert tpdu.make_pdu(sample_dt=1.0 / HZ, device="cpu").safemode_params is None
    jst = jpdu.init_state(jcfg, jnp.full((5,), 0.6, jnp.float32))
    jst = jst._replace(safemode=jst.safemode._replace(
        mode=jnp.asarray([0, 1, 2, 0, 1], jnp.int32),
        readmissions=jnp.asarray([0, 0, 3, 1, 0], jnp.int32),
        hw_weight=jnp.asarray([1.0, 1.0, 0.25, 1.0, 1.0], jnp.float32)))
    tree = convert.numpy_tree(jst)
    tst = convert.pdu_state_from_numpy(tree, device="cpu")
    for name, a, b in zip(jst.safemode._fields, jst.safemode, tst.safemode):
        assert b.dtype == (torch.float32 if name == "hw_weight" else torch.int32), name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    back = convert.numpy_tree(tst)["safemode"]
    for name, val in tree["safemode"].items():
        np.testing.assert_array_equal(back[name], val, err_msg=name)
    assert convert.pdu_state_from_numpy({**tree, "safemode": None}, device="cpu").safemode is None


def test_discrete_filter_bitwise_and_steady_state(configs):
    jcfg, tcfg = configs
    jf = jfilt.make_discrete_filter(jcfg.filter_params, 1.0 / HZ)
    tf = tfilt.make_discrete_filter(tcfg.filter_params, 1.0 / HZ)
    for name in ("ad", "bd", "c"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)))
    r0 = np.linspace(0.05, 1.0, 7).astype(np.float32)
    jst = jpdu.init_state(jcfg, jnp.asarray(r0))
    tst = tpdu.init_state(tcfg, torch.from_numpy(r0))
    np.testing.assert_allclose(tst.filter_state.numpy(), np.asarray(jst.filter_state), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tst.ess_state.g_filter.numpy(), r0)
    for name in jst.health._fields:
        np.testing.assert_array_equal(getattr(tst.health, name).numpy(), np.asarray(getattr(jst.health, name)))


def test_make_plan_matches_jax(configs):
    jcfg, tcfg = configs
    jp = convert.numpy_tree(jctrl.make_plan(jcfg.controller, jcfg.ess_params))
    tp = convert.numpy_tree(tctrl.make_plan(tcfg.controller, tcfg.ess_params))
    for name in ("a_mat", "lo_base", "hi_base", "soc_rows", "ds_ref"):
        np.testing.assert_array_equal(tp[name], jp[name], err_msg=name)
    for name in ("p_mat", "q_e0", "q_du"):
        np.testing.assert_allclose(tp[name], jp[name], rtol=2e-7, atol=0, err_msg=name)
    for name in ("kkt_chol", "kkt_inv", "kkt_inv_sigma", "kkt_inv_at"):
        scale = np.max(np.abs(jp[name]))
        np.testing.assert_allclose(tp[name], jp[name], rtol=0, atol=1e-5 * scale, err_msg=name)
    assert (tp["horizon"], tp["rho"], tp["sigma"]) == (jp["horizon"], jp["rho"], jp["sigma"])


def test_select_target_matches_jax(configs):
    jcfg, tcfg = configs
    idle = np.array([0.0, 1000.0, 1800.0, 5000.0, 20000.0], np.float32)
    wear = np.array([0.0, 0.1, 0.5, 0.9, 2.0], np.float32)
    for gain in (0.0, 1.0):
        jc = jcfg.controller.replace(wear_gain=jnp.float32(gain))
        tc = tcfg.controller.replace(wear_gain=torch.tensor(gain))
        j = jctrl.select_target(jc, jcfg.ess_params, jnp.asarray(idle), jnp.asarray(wear))
        t = tctrl.select_target(tc, tcfg.ess_params, torch.from_numpy(idle), torch.from_numpy(wear))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=0)


def test_compliance_check_matches_jax(campus_trace):
    jspec = jcomp.GridSpec.create()
    tspec = tcomp.GridSpec.create(device="cpu")
    for trace in (campus_trace, campus_trace.mean(axis=1).astype(np.float32)):
        j = jcomp.check(jnp.asarray(trace), 1.0 / HZ, jspec)
        t = tcomp.check(torch.from_numpy(np.array(trace)), 1.0 / HZ, tspec)
        np.testing.assert_allclose(t.max_ramp.numpy(), np.asarray(j.max_ramp), rtol=1e-5)
        np.testing.assert_allclose(
            t.worst_high_freq_mag.numpy(), np.asarray(j.worst_high_freq_mag), rtol=0, atol=1e-6)
        for name in ("ramp_ok", "spectrum_ok", "ok"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
        jf, js = jcomp.normalized_spectrum(jnp.asarray(trace), 1.0 / HZ)
        tf, ts = tcomp.normalized_spectrum(torch.from_numpy(np.array(trace)), 1.0 / HZ)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


@pytest.mark.parametrize("chunk", [1000, 1337])
def test_streaming_observers(campus_trace, chunk):
    x = campus_trace.mean(axis=1).astype(np.float32)
    n = x.shape[0]
    dt = 1.0 / HZ
    bank_t = tcomp.make_bank(n, dt, 2.0)
    bank_j = jcomp.make_bank(n, dt, 2.0)
    assert bank_t.bins == bank_j.bins
    ro_t, so_t = tcomp.ramp_observer_init(device="cpu"), tcomp.spectrum_observer_init(bank_t, device="cpu")
    ro_j, so_j = jcomp.ramp_observer_init(), jcomp.spectrum_observer_init(bank_j)
    for t0 in range(0, n, chunk):
        c = x[t0 : t0 + chunk]
        ro_t = tcomp.ramp_observer_update(ro_t, torch.from_numpy(c), dt)
        so_t = tcomp.spectrum_observer_update(bank_t, so_t, torch.from_numpy(c))
        ro_j = jcomp.ramp_observer_update(ro_j, jnp.asarray(c), dt)
        so_j = jcomp.spectrum_observer_update(bank_j, so_j, jnp.asarray(c))
    whole = tcomp.max_abs_ramp(torch.from_numpy(x), dt)
    assert torch.equal(ro_t.max_ramp, whole), "chunked ramp fold must equal the whole trace"
    np.testing.assert_allclose(ro_t.max_ramp.numpy(), np.asarray(ro_j.max_ramp), rtol=1e-5)
    assert int(so_t.n) == n and np.array_equal(so_t.phase.numpy(), np.asarray(so_j.phase))
    _, s_t = tcomp.spectrum_observer_finalize(bank_t, so_t)
    _, s_j = jcomp.spectrum_observer_finalize(bank_j, so_j)
    _, full = tcomp.normalized_spectrum(torch.from_numpy(x), dt)
    lines = full.numpy()[np.asarray(bank_t.bins)]
    np.testing.assert_allclose(s_t.numpy(), lines, rtol=0, atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0, atol=1e-5)
    spec_t, spec_j = tcomp.GridSpec.create(device="cpu"), jcomp.GridSpec.create()
    rep_t = tcomp.report_from_observers(spec_t, ro_t, bank_t, so_t)
    rep_j = jcomp.report_from_observers(spec_j, ro_j, bank_j, so_j)
    for name in ("ramp_ok", "spectrum_ok", "ok"):
        assert bool(getattr(rep_t, name)) == bool(getattr(rep_j, name)), name
