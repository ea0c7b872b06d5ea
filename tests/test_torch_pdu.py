"""Parity of the port's ``pdu.condition`` with the JAX package on a trace
the JAX package rendered (a 16-rack mixed campus, 22.5 s at 200 Hz: four
whole 5 s controller intervals and a ragged last one of 500 samples,
zero-order-hold padded by both).  The controller plan and the initial
state are carried across (``repro_torch.convert``) so both sides start
from identical bits.

Tolerances and their reasons:

* SoC telemetry, ESS state and the wear machine: 1e-6.  The hardware path
  is bitwise to the reference per interval (``test_torch_kernels``), but
  from the second interval on it runs the controller's command, and the
  ADMM products are summed in another order than XLA's dot (commands
  agree to ~1e-9, 1e-7 asserted).
* Grid waveform and LC state: 1e-5 — the reference's own envelope for
  grid/LC outputs on ragged intervals.  XLA's scan contracts a few LC
  multiply-adds differently from the Pallas kernel the port follows, and
  the lightly damped LC filter carries those ulps forward (measured
  ~1.6e-6 over 6500 samples).
* Campus means: the rack reduction order differs, 1e-6 (rack) / 1e-5
  (grid).
* Health block sums (SoC, SoC^2): reduction order, 1e-6 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as jctrl, pdu as jpdu
from repro.power import scenario as JSC
from repro_torch import convert
from repro_torch.core import pdu as tpdu

torch.set_num_threads(1)
HZ = 200.0


@pytest.fixture(scope="module")
def trace():
    s = JSC.mixed_campus(16, ("llama3_2_1b", "deepseek_v3_671b"), duration_s=22.5,
                         sample_hz=HZ, seed=3, fault_at_s=12.0, noise_seed=2)
    return np.asarray(JSC.render(s, 0, s.total_samples))


def _run_both(trace, *, track_health=True, software_enabled=True, qp_iters=30):
    jcfg = jpdu.make_pdu(sample_dt=1.0 / HZ, track_health=track_health,
                         software_enabled=software_enabled)
    jst = jpdu.init_state(jcfg, jnp.asarray(trace[0]))
    jplan = jctrl.make_plan(jcfg.controller, jcfg.ess_params)
    jg, jst2, jtel = jpdu.condition(jcfg, jst, jnp.asarray(trace), qp_iters=qp_iters)
    tcfg = convert.pdu_config_from_numpy(convert.numpy_tree(jcfg), device="cpu")
    tst = convert.pdu_state_from_numpy(convert.numpy_tree(jst), device="cpu")
    tplan = convert.plan_from_numpy(convert.numpy_tree(jplan), device="cpu")
    tg, tst2, ttel = tpdu.condition(
        tcfg, tst, torch.from_numpy(np.array(trace)), qp_iters=qp_iters, plan=tplan)
    return (jg, jst2, jtel), (tg, tst2, ttel)


def _close(a, b, atol, what, rtol=0.0):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=what)


def _assert_parity(j, t, *, track_health):
    (jg, jst, jtel), (tg, tst, ttel) = j, t
    assert tg.shape == jg.shape
    _close(tg, jg, 1e-5, "grid")
    _close(ttel.soc, jtel.soc, 1e-6, "telemetry soc")
    _close(ttel.command, jtel.command, 1e-7, "command")
    _close(ttel.target, jtel.target, 0.0, "target")
    _close(ttel.qp_residual, jtel.qp_residual, 1e-7, "qp residual")
    _close(ttel.rack_mean, jtel.rack_mean, 1e-6, "rack mean")
    _close(ttel.grid_mean, jtel.grid_mean, 1e-5, "grid mean")
    _close(tst.filter_state, jst.filter_state, 1e-5, "LC state")
    _close(tst.ess_state.g_filter, jst.ess_state.g_filter, 1e-6, "ESS filter")
    _close(tst.ess_state.soc, jst.ess_state.soc, 1e-6, "SoC")
    _close(tst.soc_ema, jst.soc_ema, 1e-6, "SoC EMA")
    for name in ("cmd_applied", "cmd_target"):
        _close(getattr(tst, name), getattr(jst, name), 1e-7, name)
    for name in ("x", "z", "y"):
        _close(getattr(tst.qp_warm, name), getattr(jst.qp_warm, name), 2e-5, f"warm {name}")
    for name in jst.health._fields:
        rtol = 1e-6 if name in ("soc_sum", "soc_sq_sum") else 0.0
        _close(getattr(tst.health, name), getattr(jst.health, name), 1e-6, name, rtol)
    if not track_health:
        assert float(tst.health.samples.max()) == 0


@pytest.mark.parametrize(
    "track_health,software_enabled",
    [(True, True), (False, True), (True, False)],
)
def test_condition_matches_jax(trace, track_health, software_enabled):
    j, t = _run_both(trace, track_health=track_health, software_enabled=software_enabled)
    _assert_parity(j, t, track_health=track_health)
    if not software_enabled:
        assert float(torch.abs(t[2].command).max()) == 0.0


def test_condition_unbatched_matches_jax(trace):
    """A single (T,) rack trace: the port lifts it to one kernel column."""
    j, t = _run_both(trace[:, 5].copy())
    assert t[0].ndim == 1 and t[2].soc.ndim == 1
    _assert_parity(j, t, track_health=True)


def test_condition_streaming_split_is_bitwise(trace):
    """Conditioning in two calls at an interval boundary equals one call."""
    cfg = tpdu.make_pdu(sample_dt=1.0 / HZ, track_health=True, device="cpu")
    tr = torch.from_numpy(np.array(trace))
    st0 = tpdu.init_state(cfg, tr[0])
    tr = tr[:2400]
    g_all, st_all, tel_all = tpdu.condition(cfg, st0, tr, qp_iters=30)
    g1, st1, tel1 = tpdu.condition(cfg, st0, tr[:1000], qp_iters=30)
    g2, st2, tel2 = tpdu.condition(cfg, st1, tr[1000:], qp_iters=30)
    assert torch.equal(torch.cat([g1, g2]), g_all)
    assert torch.equal(torch.cat([tel1.soc, tel2.soc]), tel_all.soc)
    for a, b in zip(st2.health, st_all.health):
        assert torch.equal(a, b)


def test_unported_paths_raise():
    """The facade's ``mesh=`` (rack sharding of a campus, the sharded region
    engine) takes a ``DeviceMesh``; anything else is refused by name before
    a run starts, for a grid region as for a campus (the sharded runs:
    ``tests/test_torch_distributed.py``)."""
    from repro_torch.core import fleet as tfleet, grid as tgrid

    cfg = tpdu.make_pdu(sample_dt=1.0 / HZ, device="cpu")
    region = tgrid.checkpoint_region(2, 2, duration_s=20.0, sample_hz=HZ, device="cpu")
    for target in (region, region.campuses[0]):
        with pytest.raises(TypeError, match="mesh must be a torch.distributed DeviceMesh with "
                                            "named axes .* got object"):
            tfleet.condition(target, cfg, device="cpu", mesh=object())
