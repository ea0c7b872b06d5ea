"""The engines under safe mode (``fleet.condition``: scanned, host and
one-shot) against the JAX package's on the CPU, and against the port's
unsupervised runs.

Tolerances and helpers as ``tests/test_torch_safemode_pdu.py``: the
supervisor's traces, summaries and final states exactly; campus means
within 1e-6; a clean supervised run bit for bit the unsupervised one on
each engine.  Then a window split and resumed, the chaos drill at 16 racks
with the corruption injected between windows (both packages' scanned
engines), and the scanned engine's loop (what its CUDA graph captures)
under a supervised config reading nothing back to the host.
"""
import jax.numpy as jnp
import pytest
import torch
from test_torch_safemode_pdu import DT, K, _bitwise, _carry, _close, _corrupt, _jcfg, \
    _poison_warm, chip_smoke
from test_torch_scanned import _no_host_reads

from repro.core import compliance as jcomp, fleet as jfleet, pdu as jpdu, safemode as jsm
from repro.power import faults as JF, scenario as JSC
from repro_torch import convert
from repro_torch.core import compliance as tcomp, fleet as tfleet, pdu as tpdu
from repro_torch.power import faults as TF, scenario as TSC

torch.set_num_threads(1)

def test_fleet_safemode_trace_and_summary():
    kw = dict(duration_s=40.0, sample_hz=100.0, seed=7)
    archs = ("llama3_2_1b", "qwen1_5_4b")
    js = JSC.mixed_campus(4, archs, **kw)
    ts = TSC.mixed_campus(4, archs, device="cpu", **kw)
    jres = jfleet.condition(js, jpdu.make_pdu(sample_dt=DT, safemode=True), jcomp.GridSpec.create(),
                            stream=jfleet.StreamOptions(chunk_intervals=4), qp_iters=30)
    spec = tcomp.GridSpec.create(device="cpu")
    on = tfleet.condition(ts, tpdu.make_pdu(sample_dt=DT, safemode=True, device="cpu"), spec,
                          stream=tfleet.StreamOptions(chunk_intervals=4), qp_iters=30,
                          device="cpu")
    off = tfleet.condition(ts, tpdu.make_pdu(sample_dt=DT, device="cpu"), spec,
                           stream=tfleet.StreamOptions(chunk_intervals=4), qp_iters=30,
                           device="cpu")
    assert on.safemode_trace.shape == (2, 6)
    _bitwise(jres.safemode_trace, on.safemode_trace, "safemode trace")
    assert (on.safemode_trace[:, 0] == 1.0).all() and (on.safemode_trace[:, 1:5] == 0.0).all()
    assert on.safemode_summary() == jres.safemode_summary()
    assert on.safemode_summary()["n_normal"] == 4
    assert torch.equal(off.safemode_trace, torch.zeros(2, 6))
    assert torch.equal(on.campus_grid, off.campus_grid)
    _close(on.campus_grid, jres.campus_grid, 1e-6, "campus grid")



SCEN = dict(duration_s=42.5, sample_hz=100.0, seed=3, fault_at_s=20.0, noise_seed=2)
ARCHS = ("llama3_2_1b", "deepseek_v3_671b")


@pytest.fixture(scope="module")
def engines():
    """A 6-rack supervised campus (42.5 s at 100 Hz: chunks of two
    intervals, a ragged tail of 250 samples) with the wear fold, from a
    state with a poisoned warm start on rack 2, through the JAX package's
    host and one-shot engines."""
    js = JSC.mixed_campus(6, ARCHS, **SCEN)
    ts = TSC.mixed_campus(6, ARCHS, device="cpu", **SCEN)
    jcfg = _jcfg(track_health=True, safemode=True)
    jst = _poison_warm(jpdu.init_state(jcfg, JSC.render(js, 0, 1)[0]), [2])
    tcfg, tst, tplan = _carry(jcfg, jst)
    spec = jcomp.GridSpec.create()
    return dict(
        ts=ts, cfg=tcfg, state=tst, plan=tplan, spec=tcomp.GridSpec.create(device="cpu"),
        jhost=jfleet.condition(js, jcfg, spec, engine="host", qp_iters=30,
                               stream=jfleet.StreamOptions(chunk_intervals=2, state=jst)),
        joneshot=jfleet.condition(js, jcfg, spec, engine="oneshot", qp_iters=30),
    )


def _engine(e, engine, **window):
    stream = tfleet.StreamOptions(chunk_intervals=2, **window)
    return tfleet.condition(e["ts"], e["cfg"], e["spec"], engine=engine, stream=stream,
                            qp_iters=30, plan=e["plan"], device="cpu")


def test_engines_safemode_trace_and_summary(engines):
    e = engines
    host = _engine(e, "host", state=e["state"])
    scanned = _engine(e, "scanned", state=e["state"])
    one = _engine(e, "oneshot")
    assert host.safemode_trace.shape == (5, 6)
    for res in (host, scanned):
        _bitwise(e["jhost"].safemode_trace, res.safemode_trace, "streaming trace")
        assert res.safemode_summary() == e["jhost"].safemode_summary()
        _close(res.campus_grid, e["jhost"].campus_grid, 1e-6, "campus grid")
    assert host.safemode_summary()["passthrough_racks"] == [2]
    assert torch.equal(host.safemode_trace, scanned.safemode_trace)
    for x, y in zip(tfleet._tree_leaves(host.state), tfleet._tree_leaves(scanned.state),
                    strict=True):
        assert torch.equal(x, y)
    assert torch.equal(host.campus_grid, scanned.campus_grid)
    # The one-shot engine starts clean (it takes no state) and carries none.
    assert one.safemode_trace.shape == (1, 6)
    _bitwise(e["joneshot"].safemode_trace, one.safemode_trace, "one-shot trace")
    assert one.safemode_summary() is None and e["joneshot"].safemode_summary() is None
    _close(one.campus_grid, e["joneshot"].campus_grid, 1e-6, "one-shot campus grid")


def test_clean_supervised_engines_equal_unsupervised(engines):
    """The transparency contract on each engine."""
    e = engines
    base = tpdu.make_pdu(sample_dt=DT, track_health=True, device="cpu")
    sup = tpdu.make_pdu(sample_dt=DT, track_health=True, safemode=True, device="cpu")
    for engine in ("scanned", "host", "oneshot"):
        runs = [tfleet.condition(e["ts"], cfg, e["spec"], engine=engine, qp_iters=30,
                                 stream=tfleet.StreamOptions(chunk_intervals=2), device="cpu")
                for cfg in (base, sup)]
        a, b = runs
        for name in ("campus_rack", "campus_grid", "soc_mean", "max_qp_residual",
                     "health_trace", "ess_online_frac", "grid_traces"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None and y is None) or torch.equal(x, y), (engine, name)
        if a.state is not None:
            for x, y in zip(tfleet._tree_leaves(a.state), tfleet._tree_leaves(b.state),
                            strict=True):
                assert torch.equal(x, y), engine
        assert (b.safemode_trace[:, 0] == 1.0).all() and (b.safemode_trace[:, 1:] == 0).all()
        assert (a.safemode_trace == 0).all()


def test_window_split_and_resumed(engines):
    e = engines
    one = _engine(e, "scanned", state=e["state"])
    a = _engine(e, "scanned", state=e["state"], stop_sample=2000)
    b = _engine(e, "scanned", state=a.state, start_sample=2000)
    for name in ("campus_rack", "campus_grid", "soc_mean"):
        assert torch.equal(torch.cat([getattr(a, name), getattr(b, name)]), getattr(one, name))
    assert torch.equal(torch.cat([a.safemode_trace, b.safemode_trace]), one.safemode_trace)
    for x, y in zip(tfleet._tree_leaves(b.state), tfleet._tree_leaves(one.state), strict=True):
        assert torch.equal(x, y)


def test_drill_with_injections_between_windows():
    """The chaos drill at 16 racks: a supervised faulty campus in two
    windows, the state corrupted between them (a poisoned warm start, a NaN
    SoC, a NaN LC state), in both packages' scanned engines."""
    kw = dict(duration_s=40.0, sample_hz=100.0, seed=2)
    archs = ("llama3_2_1b", "qwen1_5_4b")
    proc = dict(rack_mtbf_s=60.0, rack_mttr_s=8.0, ess_mtbf_s=40.0, ess_mttr_s=10.0,
                sensor_mtbf_s=50.0, sensor_mttr_s=4.0)
    js = JSC.attach_faults(JSC.mixed_campus(16, archs, **kw), JF.FaultProcess.create(**proc),
                           seed=5)
    ts = TSC.attach_faults(TSC.mixed_campus(16, archs, device="cpu", **kw),
                           convert.fault_schedule_from_numpy(convert.numpy_tree(js.faults),
                                                             device="cpu"))
    jcfg = _jcfg(degraded_mode=True, safemode=True,
                 safemode_params=jsm.SafeModeConfig.create(readmit_intervals=2))
    jst0 = jpdu.init_state(jcfg, JSC.render(js, 0, 1)[0])
    tcfg, tst0, tplan = _carry(jcfg, jst0)
    jspec, tspec = jcomp.GridSpec.create(), tcomp.GridSpec.create(device="cpu")
    cut = 2000

    def jrun(state, **w):
        return jfleet.condition(js, jcfg, jspec, qp_iters=30, stream=jfleet.StreamOptions(
            chunk_intervals=2, state=state, **w))

    def trun(state, **w):
        return tfleet.condition(ts, tcfg, tspec, qp_iters=30, plan=tplan, device="cpu",
                                stream=tfleet.StreamOptions(chunk_intervals=2, state=state, **w))

    ja, ta = jrun(jst0, stop_sample=cut), trun(tst0, stop_sample=cut)
    online = chip_smoke.drill_online_racks(ts.faults, 8, K)
    assert online, "no rack stays online through the second window"
    jst = _poison_warm(ja.state, online[:1])
    jst = _corrupt(_corrupt(jst, "soc", 7, jnp.nan), "filter_state", 11, jnp.nan)
    tst = convert.pdu_state_from_numpy(convert.numpy_tree(jst), device="cpu")
    # The port's own state up to the cut is the JAX one within the
    # tolerances; carry JAX's corrupted state so both resume from one.
    _close(ta.state.ess_state.soc, ja.state.ess_state.soc, 1e-6, "SoC at the cut")
    jb, tb = jrun(jst, start_sample=cut), trun(tst, start_sample=cut)
    for jr, tr in ((ja, ta), (jb, tb)):
        _bitwise(jr.safemode_trace, tr.safemode_trace, "safemode trace")
        assert tr.safemode_summary() == jr.safemode_summary()
        _bitwise(jr.ess_online_frac, tr.ess_online_frac, "online fraction")
        _close(tr.campus_grid, jr.campus_grid, 1e-6, "campus grid")
        assert torch.isfinite(tr.campus_grid).all()
    summ = tb.safemode_summary()
    assert summ["quarantine_entries"] == 2 and summ["passthrough_entries"] == 1
    assert summ["readmissions"] >= 1
    for name, a, b in zip(jb.state.safemode._fields, jb.state.safemode, tb.state.safemode):
        _bitwise(a, b, name)


def test_scanned_loop_supervised_reads_nothing_back(engines):
    """What the scanned engine's CUDA graph captures, under a supervised
    config (and a degraded one with an attached schedule, whose supervised
    call renders the streamed arrays from a tensor start), reads nothing
    back to the host and copies nothing from host memory, and equals the
    engine's result."""
    e = engines
    cfg, ts, st = e["cfg"], e["ts"], e["state"]
    dcfg = tpdu.make_pdu(sample_dt=DT, degraded_mode=True, safemode=True, device="cpu")
    sched = TF.sample_schedule(TF.FaultProcess.create(ess_mtbf_s=20.0, ess_mttr_s=6.0,
                                                      sensor_mtbf_s=15.0, sensor_mttr_s=3.0),
                               6, ts.total_samples, 100.0, seed=3, device="cpu")
    dts = TSC.attach_faults(ts, sched)
    for cfg_, scen, state in ((cfg, ts, st), (dcfg, dts, tpdu.init_state(dcfg, TSC.render(
            dts, 0, 1)[0]))):
        ref = tfleet.condition(scen, cfg_, e["spec"], qp_iters=30, plan=e["plan"], device="cpu",
                               stream=tfleet.StreamOptions(chunk_intervals=2, state=state,
                                                           stop_sample=2 * K))
        consts = tpdu.host_consts(cfg_, state.filter_obj)
        bank = tfleet._make_bank(e["spec"], cfg_, 2 * K)
        tcomp._bins_tensor(bank.bins, cfg_.device)
        with _no_host_reads():
            st2, out = tfleet._scanned_run(cfg_, scen, state, e["plan"], consts,
                                           start=torch.zeros((), dtype=torch.int32),
                                           chunk=2 * K, k=K, n_full=1, rem=0, qp_iters=30,
                                           bank=bank)
        for x, y in zip(tfleet._tree_leaves((st2, out.campus_grid, out.sm_trace)),
                        tfleet._tree_leaves((ref.state, ref.campus_grid[:2 * K],
                                             ref.safemode_trace)), strict=True):
            assert torch.equal(x, y)


def test_deprecated_wrappers_are_the_facade(engines):
    """The reference's four deprecated entry points are the facade under
    another name, on the config's device (the safe-mode bench enters
    through ``condition_scenario_streaming``)."""
    e = engines
    cfg, spec = e["cfg"], e["spec"]
    tr = TSC.render(e["ts"], 0, 4 * K)
    kw = dict(qp_iters=30, device="cpu")
    pairs = [
        (tfleet.condition_scenario_streaming(cfg, e["ts"], spec, qp_iters=30, chunk_intervals=2,
                                             stop_sample=4 * K),
         tfleet.condition(e["ts"], cfg, spec, stream={"chunk_intervals": 2, "stop_sample": 4 * K},
                          **kw)),
        (tfleet.condition_scenario_streaming(cfg, e["ts"], spec, engine="host", qp_iters=30,
                                             chunk_intervals=2),
         tfleet.condition(e["ts"], cfg, spec, engine="host", stream={"chunk_intervals": 2}, **kw)),
        (tfleet.condition_scenario_scanned(cfg, e["ts"], spec, qp_iters=30, chunk_intervals=2,
                                           start_sample=2 * K, stop_sample=4 * K),
         tfleet.condition(e["ts"], cfg, spec, stream={"chunk_intervals": 2, "start_sample": 2 * K,
                                                      "stop_sample": 4 * K}, **kw)),
        (tfleet.condition_fleet(cfg, tr, spec, qp_iters=30),
         tfleet.condition(tr, cfg, spec, engine="oneshot", **kw)),
        (tfleet.condition_fleet_streaming(cfg, tr, spec, qp_iters=30, chunk_intervals=2),
         tfleet.condition(tr, cfg, spec, engine="host", stream={"chunk_intervals": 2}, **kw)),
    ]
    for a, b in pairs:
        for x, y in zip(tfleet._tree_leaves(a), tfleet._tree_leaves(b), strict=True):
            assert torch.equal(x, y)
        assert a.safemode_summary() == b.safemode_summary()
    with pytest.raises(ValueError, match="unknown engine"):
        tfleet.condition_scenario_streaming(cfg, e["ts"], spec, engine="oneshot")
