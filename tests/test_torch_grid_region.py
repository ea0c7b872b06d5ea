"""The port's region engine (``fleet.condition`` on a ``grid.GridRegion``)
on the CPU: against the JAX package's region composed from the pieces that
run on jax 0.9.0 (``test_torch_grid_region_reference.jax_region``), the
reference's region-result contracts mirrored on the port
(``tests/test_grid_region.py:292-373``), the facade's refusals,
``report("poi")`` and ``safemode_summary()`` on a supervised region, and
the paper's grid-side finding at the reference test's size.

Tolerances against JAX are ``tests/test_torch_scanned.py``'s envelopes: the
campus and POI means of the unconditioned load 2e-6, of the conditioned
load 2e-5 (the LC chain and 30 ADMM iterations), ``soc_mean`` 2e-6; the
online fraction and every verdict exactly.  The mode lines are held to the
exact float64 DFT of the JAX POI (``chip_smoke.MODE_JAX_EXACT_TOL``): the
reference's float32 Goertzel bank drifts from it by up to ~1e-4 at these
sub-Hz lines, the port's does not.  ``poi_freq_dev`` is held to 1e-6 Hz,
1e-5 of its ~0.1 Hz peak (measured: 2.6e-8 Hz; the POIs differ by
~3.6e-7), ``poi_volt_dev`` to 1e-6 pu.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import compliance as jcomp, grid as jgrid, pdu as jpdu
from repro.power import scenario as JSC
from repro_torch.core import compliance as tcomp, fleet as tfleet, grid as tgrid, pdu as tpdu
from repro_torch.power import scenario as TSC

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from test_torch_grid_region_reference import jax_region  # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.grid

_HZ = 50.0
_DEV = "cpu"
_RACK_TOL, _GRID_TOL, _SOC_TOL, _FREQ_TOL = 2e-6, 2e-5, 2e-6, 1e-6


def _cfgs(**kw):
    return (tpdu.make_pdu(sample_dt=1.0 / _HZ, device=_DEV, **kw),
            jpdu.make_pdu(sample_dt=1.0 / _HZ, **kw))


_TSPEC = tcomp.GridSpec.create(device=_DEV)
_JSPEC = jcomp.GridSpec.create()


def _small_region(grid=tgrid, n_campuses=3, n_racks=4, duration_s=60.0, **kw):
    if grid is tgrid:
        kw["device"] = _DEV
    return grid.checkpoint_region(n_campuses, n_racks, duration_s=duration_s, sample_hz=_HZ,
                                  **kw)


def _hetero_region(grid=tgrid, sc=TSC):
    kw = {"device": _DEV} if sc is TSC else {}
    camp = lambda n, seed: sc.mixed_campus(n, ("llama3_2_1b", "whisper_large_v3"),
                                           duration_s=60.0, sample_hz=_HZ, seed=seed,
                                           noise_seed=7, **kw)
    return grid.region([camp(3, 2), camp(5, 4)])


@pytest.fixture(scope="module")
def region_result():
    cfg, _ = _cfgs()
    reg = _small_region(noise_seed=3)
    return reg, cfg, tfleet.condition(reg, cfg, _TSPEC, device=_DEV)


@pytest.fixture(scope="module")
def hetero_result():
    cfg, _ = _cfgs()
    reg = _hetero_region()
    return reg, tfleet.condition(reg, cfg, _TSPEC, device=_DEV)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(t, j, atol, what):
    np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=atol, err_msg=what)


def _assert_matches_jax(t, j, jreg, cfg_dt):
    assert t.campus_rack.shape == tuple(np.asarray(j.campus_rack).shape)
    for f, tol in (("campus_rack", _RACK_TOL), ("campus_grid", _GRID_TOL),
                   ("soc_mean", _SOC_TOL), ("poi_rack", _RACK_TOL), ("poi_grid", _GRID_TOL),
                   ("poi_freq_dev", _FREQ_TOL), ("poi_volt_dev", 1e-6)):
        _close(getattr(t, f), getattr(j, f), tol, f)
    np.testing.assert_array_equal(_np(t.ess_online_frac), _np(j.ess_online_frac))
    np.testing.assert_array_equal(_np(t.weights), _np(j.weights))
    np.testing.assert_allclose(float(t.max_qp_residual), float(j.max_qp_residual), rtol=1e-3)
    for which in ("report_rack", "report_poi"):
        rt, rj = getattr(t, which), getattr(j, which)
        for v in ("ramp_ok", "spectrum_ok", "ok"):
            assert bool(getattr(rt, v)) == bool(getattr(rj, v)), (which, v)
        np.testing.assert_allclose(float(rt.max_ramp), float(rj.max_ramp), rtol=2e-3)
    rt, rj = t.report_poi, j.report_poi
    assert _np(rt.mode_ok).tolist() == _np(rj.mode_ok).tolist()
    assert bool(rt.modes_ok) == bool(rj.modes_ok)
    mbank = jgrid.mode_bank(jreg.total_samples, cfg_dt, jreg.bands)
    exact = chip_smoke.exact_band_lines(_np(j.poi_grid), mbank, jreg.bands)
    rel, ab = chip_smoke.MODE_JAX_EXACT_TOL
    np.testing.assert_allclose(_np(rt.mode_mags), exact, rtol=rel, atol=ab)
    for c, (pt, pj) in enumerate(zip(t.per_campus, j.per_campus, strict=True)):
        for v in ("ramp_ok", "spectrum_ok", "ok"):
            assert bool(getattr(pt.report_grid, v)) == bool(getattr(pj.report_grid, v)), (c, v)


@pytest.mark.parametrize("name", ["small", "heterogeneous"])
def test_region_matches_the_composed_jax_reference(region_result, hetero_result, name):
    tcfg, jcfg = _cfgs()
    if name == "small":
        _, _, t = region_result
        jreg = _small_region(jgrid, noise_seed=3)
    else:
        _, t = hetero_result
        jreg = _hetero_region(jgrid, JSC)
    j = jax_region(jreg, jcfg, _JSPEC)
    _assert_matches_jax(t, j, jreg, jcfg.sample_dt)


# -------------------------------------- the reference's region contracts


def test_region_result_shapes(region_result):
    reg, _, res = region_result
    c, t = reg.n_campuses, int(reg.total_samples)
    assert tuple(res.campus_rack.shape) == tuple(res.campus_grid.shape) == (c, t)
    for f in ("poi_rack", "poi_grid", "poi_freq_dev", "poi_volt_dev"):
        assert tuple(getattr(res, f).shape) == (t,), f
    assert len(res.per_campus) == c and len(res.state) == c
    assert res.report_grid is res.report_poi
    assert res.health is None  # each campus's wear report lives in per_campus
    assert all(r.health is not None for r in res.per_campus)
    assert tuple(res.soc_mean.shape) == (c, t // 250)
    assert tuple(res.safemode_trace.shape) == (c, 1, 6)


def test_region_poi_is_left_to_right_weighted_sum(region_result):
    reg, _, res = region_result
    for name, poi in (("campus_rack", res.poi_rack), ("campus_grid", res.poi_grid)):
        per = [getattr(r, name) for r in res.per_campus]
        acc = res.weights[0] * per[0]
        for c in range(1, reg.n_campuses):
            acc = acc + res.weights[c] * per[c]
        assert torch.equal(acc, poi), name


def test_region_per_campus_matches_stacked_aggregates(region_result):
    reg, cfg, res = region_result
    for c in range(reg.n_campuses):
        for f in ("campus_rack", "campus_grid", "soc_mean", "ess_online_frac", "health_trace"):
            assert torch.equal(getattr(res.per_campus[c], f), getattr(res, f)[c]), (c, f)
    # Each campus's result is the scanned engine's on that salted campus.
    alone = tfleet.condition(reg.campuses[1], cfg, _TSPEC, device=_DEV)
    for f in ("campus_rack", "campus_grid", "soc_mean", "max_qp_residual"):
        assert torch.equal(getattr(alone, f), getattr(res.per_campus[1], f)), f


def test_region_poi_freq_matches_direct_poi_response(region_result):
    reg, _, res = region_result
    r = tgrid.poi_response(res.poi_grid, reg.poi, 1.0 / reg.sample_hz)
    assert torch.equal(r.freq_dev_hz, res.poi_freq_dev)
    assert torch.equal(r.volt_dev, res.poi_volt_dev)


def test_region_heterogeneous_rack_counts(hetero_result):
    reg, res = hetero_result
    assert res.campus_rack.shape[0] == 2 and reg.n_racks == (3, 5)
    np.testing.assert_allclose(res.weights.numpy(), [3 / 8, 5 / 8], atol=1e-7)
    assert [tuple(s.ess_online.shape) for s in res.state] == [(3,), (5,)]


def test_region_windowed_resume_is_bitwise(region_result):
    reg, cfg, full = region_result
    k = int(round(float(cfg.controller.dt) * _HZ))
    cut = 4 * k
    a = tfleet.condition(reg, cfg, _TSPEC, device=_DEV, stream=dict(stop_sample=cut))
    b = tfleet.condition(reg, cfg, _TSPEC, device=_DEV,
                         stream=dict(state=a.state, start_sample=cut))
    for f in ("campus_rack", "campus_grid", "poi_rack", "poi_grid"):
        assert torch.equal(torch.cat([getattr(a, f), getattr(b, f)], dim=-1),
                           getattr(full, f)), f
    for x, y in zip(tfleet._tree_leaves(b.state), tfleet._tree_leaves(full.state), strict=True):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="multiple of"):
        tfleet.condition(reg, cfg, _TSPEC, device=_DEV, stream=dict(start_sample=7))
    with pytest.raises(ValueError, match="states for"):
        tfleet.condition(reg, cfg, _TSPEC, device=_DEV, stream=dict(state=a.state[:2]))


def test_region_resume_never_writes_the_callers_states(region_result):
    reg, cfg, _ = region_result
    a = tfleet.condition(reg, cfg, _TSPEC, device=_DEV, stream=dict(stop_sample=500))
    before = [x.clone() for x in tfleet._tree_leaves(a.state)]
    r1 = tfleet.condition(reg, cfg, _TSPEC, device=_DEV,
                          stream=dict(state=a.state, start_sample=500, stop_sample=1000))
    r2 = tfleet.condition(reg, cfg, _TSPEC, device=_DEV,
                          stream=dict(state=a.state, start_sample=500, stop_sample=1000))
    for x, y in zip(before, tfleet._tree_leaves(a.state), strict=True):
        assert torch.equal(x, y)
    assert torch.equal(r1.poi_grid, r2.poi_grid)


def test_facade_refuses_other_engines_stream_options_and_a_mesh():
    cfg, _ = _cfgs()
    reg = _small_region(duration_s=20.0)
    with pytest.raises(ValueError, match="scanned engine only"):
        tfleet.condition(reg, cfg, _TSPEC, engine="host", device=_DEV)
    with pytest.raises(ValueError, match="total_samples"):
        tfleet.condition(reg, cfg, _TSPEC, device=_DEV, stream=dict(total_samples=100))
    # A mesh must be a DeviceMesh (the sharded engine itself:
    # tests/test_torch_distributed.py).
    with pytest.raises(TypeError, match="mesh must be a torch.distributed DeviceMesh"):
        tfleet.condition(reg, cfg, _TSPEC, device=_DEV, mesh=object())
    with pytest.raises(TypeError, match="mesh must be a torch.distributed DeviceMesh"):
        tgrid.condition_region(cfg, reg, _TSPEC, mesh=object())
    # As the reference's region engine, this one takes no controller plan.
    with pytest.raises(TypeError, match="plan"):
        tfleet.condition(reg, cfg, _TSPEC, device=_DEV, plan=None)
    with pytest.raises(ValueError, match="outside the region"):
        tfleet.condition(reg, cfg, _TSPEC, device=_DEV,
                         stream=dict(stop_sample=reg.total_samples + 1))
    with pytest.raises(ValueError, match="past the region end"):
        tfleet.condition(reg, cfg, _TSPEC, device=_DEV,
                         stream=dict(start_sample=reg.total_samples))


def test_report_poi_and_safemode_summary_on_a_supervised_region():
    cfg, _ = _cfgs(safemode=True)
    reg = _small_region(n_campuses=2, n_racks=3, duration_s=30.0)
    res = tfleet.condition(reg, cfg, _TSPEC, device=_DEV)
    rep = res.report("poi")
    for f in ("max_ramp", "ramp_ok", "worst_high_freq_mag", "spectrum_ok", "ok", "mode_mags",
              "mode_ok", "modes_ok"):
        assert torch.equal(getattr(rep, f), getattr(res.report_poi, f)), f
    assert res.report("grid").mode_mags is not None  # report_grid is the POI report
    assert res.report("rack").mode_mags is None
    with pytest.raises(ValueError, match="poi"):
        res.report("nope")
    sm = res.safemode_summary()
    assert sm["n_normal"] == 6 and sm["n_passthrough"] == sm["n_quarantined"] == 0
    assert sm["passthrough_racks"] == {0: [], 1: []}
    assert sm["quarantined_racks"] == {0: [], 1: []}
    assert res.per_campus[0].safemode_summary()["n_normal"] == 3
    assert tuple(res.safemode_trace.shape) == (2, 1, 6)
    np.testing.assert_array_equal(res.safemode_trace[:, 0, 0].numpy(), 1.0)


def test_synchronized_checkpoints_ring_staggered_cancel():
    """The paper's grid-side finding at the reference test's size: lockstep
    checkpoint stalls across campuses ring the sub-Hz inter-area band at
    the POI; staggering the same schedule cancels it."""
    cfg, _ = _cfgs()
    kw = dict(n_campuses=4, n_racks=6, duration_s=100.0, sample_hz=_HZ, device=_DEV)
    rs = tfleet.condition(tgrid.synchronized_region(**kw), cfg, _TSPEC, device=_DEV)
    rt = tfleet.condition(tgrid.staggered_region(**kw), cfg, _TSPEC, device=_DEV)
    assert not bool(rs.report_poi.modes_ok)
    assert not bool(rs.report_poi.mode_ok[0])  # the inter-area band
    assert bool(rt.report_poi.modes_ok)
    assert float(rs.report_poi.mode_mags[0]) > 10 * float(rt.report_poi.mode_mags[0])
    assert not bool(rs.report_grid.ok)
    assert not bool(rs.report("poi").modes_ok)
    assert float(torch.amax(torch.abs(rs.poi_freq_dev))) < 1.0
    assert bool(rs.report_poi.ramp_ok) and bool(rt.report_poi.ramp_ok)
