"""Parity of the port's fleet engines with the JAX package's host engine.

A 16-rack mixed campus, 22.5 s at 200 Hz, conditioned in chunks of two
controller intervals (2000 samples; the last chunk is a ragged 500), with
the health fold on.  The JAX side is ``engine="host"`` (its scanned
engine's ragged tail is a known 1-ulp fault of the reference, not a
target).  Both sides start from the JAX package's initial state, and the
port from its carried controller plan.

Tolerances and their reasons (see also ``test_torch_pdu``):

* Array target (both condition the trace JAX rendered): campus rack means
  1e-6 (rack reduction order), grid means and LC-driven values 1e-5 (the
  reference's ragged-interval LC envelope), SoC means 1e-6, worst QP
  residual 1e-6 relative, wear report leaves 1e-6 (1e-5 relative for the
  SoC-sum-derived ones, 1e-5 absolute for the SoC standard deviation,
  whose E[s^2] - E[s]^2 amplifies the sums' rounding).  Ramp maxima are differences of those means over
  dt = 5 ms: 1e-3 relative.  Spectrum line magnitudes: 1e-5 absolute,
  the reference's own contract for its float32 Goertzel recurrence
  against the exact DFT (measured ~3e-6 here; the port's float64 product
  is closer to the exact DFT).  Verdicts must agree.
* Scenario target (each package renders its own trace): the rendered
  racks differ by ~1e-6 (erfinv/cos rounding), so the rack means and
  everything downstream get 2x the array-target tolerances.
* Port host engine vs port one-shot engine, and a resumed stream vs one
  unsplit stream: bitwise (same per-interval arithmetic, chunk-invariant
  rendering).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compliance as jcomp, controller as jctrl, fleet as jfleet, pdu as jpdu
from repro.power import scenario as JSC
from repro_torch import convert
from repro_torch.core import compliance as tcomp, fleet as tfleet
from repro_torch.power import scenario as TSC

torch.set_num_threads(1)
HZ = 200.0
KW = dict(duration_s=22.5, sample_hz=HZ, seed=3, fault_at_s=12.0, noise_seed=2)
ARCHS = ("llama3_2_1b", "deepseek_v3_671b", "chatglm3_6b", "whisper_large_v3")


@pytest.fixture(scope="module")
def setup():
    js = JSC.mixed_campus(16, ARCHS, **KW)
    ts = TSC.mixed_campus(16, ARCHS, device="cpu", **KW)
    trace = np.asarray(JSC.render(js, 0, js.total_samples))
    jcfg = jpdu.make_pdu(sample_dt=1.0 / HZ, track_health=True)
    jst = jpdu.init_state(jcfg, jnp.asarray(trace[0]))
    jplan = jctrl.make_plan(jcfg.controller, jcfg.ess_params)
    jspec = jcomp.GridSpec.create()
    stream = jfleet.StreamOptions(chunk_intervals=2, state=jst)
    jres = {
        "scenario": jfleet.condition(js, jcfg, jspec, engine="host", stream=stream, qp_iters=30),
        "array": jfleet.condition(jnp.asarray(trace), jcfg, jspec, engine="host", stream=stream,
                                  qp_iters=30),
    }
    port = dict(
        cfg=convert.pdu_config_from_numpy(convert.numpy_tree(jcfg), device="cpu"),
        state=convert.pdu_state_from_numpy(convert.numpy_tree(jst), device="cpu"),
        plan=convert.plan_from_numpy(convert.numpy_tree(jplan), device="cpu"),
        spec=tcomp.GridSpec.create(device="cpu"),
    )
    return dict(js=js, ts=ts, trace=trace, jres=jres, port=port, runs={})


def _port_run(setup, target, *, engine="host", state="carried", chunk_intervals=2):
    p = setup["port"]
    stream = None
    if engine == "host":
        stream = tfleet.StreamOptions(
            chunk_intervals=chunk_intervals, state=p["state"] if state == "carried" else state)
    return tfleet.condition(target, p["cfg"], p["spec"], engine=engine, stream=stream,
                            device="cpu", qp_iters=30, plan=p["plan"])


def _close(a, b, atol, what, rtol=0.0):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=what)


def _host(setup, target):
    """The port's host-engine run of ``target`` from the carried state
    (computed once per module)."""
    if target not in setup["runs"]:
        tgt = torch.from_numpy(np.array(setup["trace"])) if target == "array" else setup["ts"]
        setup["runs"][target] = _port_run(setup, tgt)
    return setup["runs"][target]


@pytest.mark.parametrize("target", ["array", "scenario"])
def test_host_engine_matches_jax_host(setup, target):
    j = setup["jres"][target]
    t = _host(setup, target)
    f = 1.0 if target == "array" else 2.0
    assert t.campus_grid.shape == j.campus_grid.shape
    _close(t.campus_rack, j.campus_rack, f * 1e-6, "campus_rack")
    _close(t.campus_grid, j.campus_grid, f * 1e-5, "campus_grid")
    _close(t.soc_mean, j.soc_mean, f * 1e-6, "soc_mean")
    _close(t.max_qp_residual, j.max_qp_residual, 0.0, "max_qp_residual", rtol=f * 1e-6)
    _close(t.health_trace, j.health_trace, f * 1e-6, "health_trace", rtol=f * 1e-5)
    for which in ("rack", "grid"):
        rt, rj = t.report(which), j.report(which)
        _close(rt.max_ramp, rj.max_ramp, 0.0, f"{which} max_ramp", rtol=f * 1e-3)
        _close(rt.worst_high_freq_mag, rj.worst_high_freq_mag, f * 1e-5, f"{which} spectrum")
        for name in ("ramp_ok", "spectrum_ok", "ok"):
            assert bool(getattr(rt, name)) == bool(getattr(rj, name)), f"{which} {name}"
    for name in j.health._fields:
        rtol = f * 1e-5 if name in ("mean_soc", "calendar_life_frac",
                                     "capacity_fade", "projected_life_s") else 0.0
        # soc_std = sqrt(E[s^2] - E[s]^2) cancels: the sums' reduction-order
        # ulps grow by E[s]^2 / var (~1e4 here), so 1e-5 absolute.
        atol = f * (1e-5 if name == "soc_std" else 1e-6)
        _close(getattr(t.health, name), getattr(j.health, name), atol, name, rtol)


def test_host_equals_oneshot_bitwise(setup):
    tr = torch.from_numpy(np.array(setup["trace"][:2500]))
    host = _port_run(setup, tr, state=None)  # both engines initialize the state
    p = setup["port"]
    one = tfleet.condition(tr, p["cfg"], p["spec"], engine="oneshot", device="cpu",
                           qp_iters=30, plan=p["plan"])
    assert one.grid_traces.shape == tr.shape
    assert torch.equal(host.campus_rack, one.campus_rack)
    assert torch.equal(host.campus_grid, one.campus_grid)
    for a, b in zip(host.health, one.health):
        assert torch.equal(a, b)
    assert torch.equal(host.report_rack.max_ramp, one.report_rack.max_ramp)


def test_scenario_host_resume_is_bitwise(setup):
    """A stream resumed from a result's state reproduces the unsplit run;
    the scenario target renders chunk by chunk exactly as a whole trace."""
    ts = setup["ts"]
    whole = _host(setup, "scenario")
    tr = TSC.render(ts, 0, ts.total_samples)
    first = _port_run(setup, tr[:4000])
    second = _port_run(setup, tr[4000:], state=first.state)
    assert torch.equal(torch.cat([first.campus_rack, second.campus_rack]), whole.campus_rack)
    assert torch.equal(torch.cat([first.campus_grid, second.campus_grid]), whole.campus_grid)
    assert torch.equal(torch.cat([first.soc_mean, second.soc_mean]), whole.soc_mean)
    for a, b in zip(second.state.health, whole.state.health):
        assert torch.equal(a, b)
    for a, b in zip(second.state.qp_warm, whole.state.qp_warm):
        assert torch.equal(a, b)


def test_unported_engines_raise(setup):
    p = setup["port"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfleet.condition(setup["ts"], p["cfg"], p["spec"], engine="scanned", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfleet.condition(setup["ts"], p["cfg"], p["spec"], mesh=object(), device="cpu")
