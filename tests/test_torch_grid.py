"""``repro_torch.core.grid``'s pieces against the JAX package's on the CPU:
the region builders, the salted noise, ``poi_response``, the mode bank and
its verdicts, ``compliance.with_mode_verdicts`` and the POI observers'
fold (``tests/test_grid_region.py:61-187`` mirrored, each also held to the
JAX function on the same inputs).
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compliance as jcomp, grid as jgrid
from repro.power import scenario as JSC
from repro_torch.core import compliance as tcomp, fleet as tfleet, grid as tgrid, pdu as tpdu
from repro_torch.power import scenario as TSC

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from test_torch_scanned import _no_host_reads  # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.grid

_HZ = 50.0
_DEV = "cpu"


def _campus(sc=TSC, n_racks=4, duration_s=60.0, seed=2, noise_seed=7, **kw):
    return sc.mixed_campus(n_racks, ("llama3_2_1b", "whisper_large_v3"), duration_s=duration_s,
                           sample_hz=_HZ, seed=seed, noise_seed=noise_seed, **kw)


def _tcampus(**kw):
    return _campus(device=_DEV, **kw)


# ----------------------------------------------------------------- builders


def test_region_rejects_mismatched_clock():
    with pytest.raises(ValueError, match="one POI clock"):
        tgrid.region([_tcampus(duration_s=60.0), _tcampus(duration_s=40.0)])


def test_region_default_weights_follow_rack_share():
    reg = tgrid.region([_tcampus(n_racks=4), _tcampus(n_racks=6, seed=3)])
    jreg = jgrid.region([_campus(JSC, n_racks=4), _campus(JSC, n_racks=6, seed=3)])
    assert reg.weights.dtype == torch.float32 and reg.weights.device.type == _DEV
    np.testing.assert_array_equal(reg.weights.numpy(), np.asarray(jreg.weights))
    np.testing.assert_allclose(reg.weights.numpy(), [0.4, 0.6], atol=1e-7)
    assert reg.n_racks == (4, 6)
    assert reg.names == ("campus0", "campus1")
    assert reg.n_campuses == 2
    assert reg.sample_hz == _HZ and reg.total_samples == jreg.total_samples


def test_region_validates_weights_and_names():
    c = [_tcampus(), _tcampus(seed=3)]
    with pytest.raises(ValueError, match="weights shape"):
        tgrid.region(c, weights=np.ones((3,), np.float32))
    with pytest.raises(ValueError, match="names"):
        tgrid.region(c, names=("only-one",))
    with pytest.raises(ValueError, match="at least one campus"):
        tgrid.region([])
    reg = tgrid.region(c, weights=[0.25, 0.75], names=("a", "b"))
    assert reg.names == ("a", "b") and reg.weights.tolist() == [0.25, 0.75]


@pytest.mark.parametrize("stagger", [False, True])
def test_checkpoint_region_renders_as_jax(stagger):
    """Each campus of the testbench region, salted, renders the JAX
    package's trace: the workload columns and the salted noise hash are
    bitwise, cos and erfinv agree to ~1e-6."""
    kw = dict(n_campuses=3, n_racks=4, duration_s=20.0, sample_hz=_HZ, noise_seed=5,
              stagger=stagger)
    reg = tgrid.checkpoint_region(device=_DEV, **kw)
    jreg = jgrid.checkpoint_region(**kw)
    for t, j in zip(reg.campuses, jreg.campuses, strict=True):
        assert int(t.noise_salt) == int(np.asarray(j.noise_salt))
        np.testing.assert_allclose(TSC.render(t, 0, t.total_samples).numpy(),
                                   np.asarray(JSC.render(j, 0, j.total_samples)),
                                   rtol=0, atol=2e-6)


def test_region_salts_noise_per_campus():
    reg = tgrid.checkpoint_region(2, 4, duration_s=20.0, sample_hz=_HZ, noise_seed=5,
                                  device=_DEV)
    salts = [c.noise_salt for c in reg.campuses]
    assert all(isinstance(s, torch.Tensor) and s.shape == () and s.dtype == torch.int64
               for s in salts)
    assert int(salts[0]) != int(salts[1])
    assert not torch.equal(TSC.render(reg.campuses[0], 0, 200),
                           TSC.render(reg.campuses[1], 0, 200))
    # Without noise there is nothing to salt.
    clean = tgrid.checkpoint_region(2, 4, duration_s=20.0, sample_hz=_HZ, noise_seed=None,
                                    device=_DEV)
    assert all(c.noise_salt is None for c in clean.campuses)


@pytest.mark.parametrize("salt", [0, 7, 0x80000000, 0xDEADBEEF])
def test_salted_noise_bits_equal_jax(salt):
    """The salted stream's hash bits equal the JAX package's bit for bit,
    salt 0 is the unsalted stream, and the noise and the rendered trace
    agree as the unsalted ones do (tests/test_torch_scenario.py: erfinv and
    cos rounding)."""
    t = TSC.with_noise_salt(_tcampus(), salt)
    j = JSC.with_noise_salt(_campus(JSC), salt)
    assert int(t.noise_salt) == int(np.asarray(j.noise_salt)) == salt
    idx = np.arange(0, 3000, 7, dtype=np.int32)
    lane_seed = jnp.arange(4, dtype=jnp.uint32) * jnp.uint32(0x9E3779B9) ^ (
        jnp.uint32(7) * jnp.uint32(0x85EBCA6B) + jnp.uint32(0x2545F491))
    lane = JSC._fmix32(lane_seed ^ j.noise_salt)
    h = JSC._fmix32(jnp.asarray(idx).astype(jnp.uint32)[:, None] ^ lane[None, :])
    bits = TSC._hash_bits(7, torch.from_numpy(idx), 4, t.noise_salt)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(h >> jnp.uint32(8)).astype(np.int64))
    assert torch.equal(bits, TSC._hash_bits(7, torch.from_numpy(idx), 4, salt))
    if salt == 0:
        assert torch.equal(bits, TSC._hash_bits(7, torch.from_numpy(idx), 4))
    want = np.asarray(JSC._hash_normal(7, jnp.asarray(idx), (4,), j.noise_salt))
    got = TSC._hash_normal(7, torch.from_numpy(idx), (4,), t.noise_salt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(TSC.render(t, 0, 600).numpy(),
                               np.asarray(JSC.render(j, 0, 600)), rtol=0, atol=2e-6)


def test_with_noise_salt_leaves_a_silent_scenario_alone():
    s = _tcampus(noise_seed=None)
    assert TSC.with_noise_salt(s, 3) is s
    ts = TSC.with_noise_salt(_tcampus(), torch.tensor(5, dtype=torch.int32))
    assert ts.noise_salt.dtype == torch.int64 and int(ts.noise_salt) == 5


def test_salted_campuses_share_one_graph_key():
    """The salt is a tensor leaf: two salted campuses of one structure (and
    a staggered twin) give one scanned-engine key, where a salt held by
    value would give one each; the salted render reads nothing back to the
    host, which a capture refuses."""
    cfg = tpdu.make_pdu(sample_dt=1.0 / _HZ, device=_DEV)
    sync = tgrid.synchronized_region(n_campuses=3, n_racks=4, duration_s=20.0, sample_hz=_HZ,
                                     device=_DEV)
    stag = tgrid.staggered_region(n_campuses=3, n_racks=4, duration_s=20.0, sample_hz=_HZ,
                                  device=_DEV)
    st = tpdu.init_state(cfg, TSC.render(sync.campuses[0], 0, 1)[0])
    geometry = dict(chunk=1000, k=250, n_full=1, rem=0, qp_iters=30, bank=None)
    keys = {tfleet._scanned_key(cfg, c, st, None, geometry)
            for c in sync.campuses + stag.campuses}
    assert len(keys) == 1
    assert len({int(c.noise_salt) for c in sync.campuses}) == 3
    t0 = torch.tensor(250, dtype=torch.int32)
    with _no_host_reads():
        out = TSC.render(sync.campuses[2], t0, 500)
    assert torch.equal(out, TSC.render(sync.campuses[2], 250, 500))


# ---------------------------------------------------------------- POI model


def test_poi_response_flat_trace_is_quiet():
    r = tgrid.poi_response(torch.full((500,), 0.5), tgrid.POIConfig(), 1.0 / _HZ)
    assert torch.equal(r.freq_dev_hz, torch.zeros(500))
    assert torch.equal(r.volt_dev, torch.zeros(500))
    assert float(r.max_freq_dev_hz) == 0.0


def test_poi_response_step_signs_and_linearity():
    # A sustained load increase depresses frequency and voltage; 60 s after
    # the step (~11 swing time constants) the tail is at the steady state.
    p = torch.cat([torch.full((250,), 0.5), torch.full((3000,), 0.7)])
    poi = tgrid.POIConfig()
    r = tgrid.poi_response(p, poi, 1.0 / _HZ, p_ref=0.5)
    assert float(r.freq_dev_hz[-1]) < 0.0 and float(r.volt_dev[-1]) < 0.0
    np.testing.assert_allclose(float(r.volt_dev[-1]), -poi.v_sens * 0.2, rtol=1e-5)
    expect = -poi.region_fraction * 0.2 / poi.damping * poi.f0_hz
    np.testing.assert_allclose(float(r.freq_dev_hz[-1]), expect, rtol=1e-3)
    r2 = tgrid.poi_response(p, tgrid.POIConfig(region_fraction=2 * poi.region_fraction),
                            1.0 / _HZ, p_ref=0.5)
    np.testing.assert_allclose(r2.freq_dev_hz.numpy(), 2.0 * r.freq_dev_hz.numpy(), atol=1e-6)


# poi_response against JAX: XLA:CPU may contract the Euler step's multiply-add
# into an FMA, where the port rounds each operation; the deviation stays a
# float32 rounding of the step, 1e-6 of the largest |df| (and the voltage,
# one multiply, to 1 ulp).
_POI_FREQ_REL = 1e-6


@pytest.mark.parametrize("p_ref", [None, 0.6])
def test_poi_response_matches_jax_on_a_seeded_trace(p_ref):
    rng = np.random.default_rng(11)
    p = (0.6 + 0.1 * np.sin(2 * np.pi * 0.3 * np.arange(4000) / _HZ)
         + 0.02 * rng.standard_normal(4000)).astype(np.float32)
    poi = tgrid.POIConfig(region_fraction=0.02)
    t = tgrid.poi_response(torch.from_numpy(p), poi, 1.0 / _HZ, p_ref=p_ref)
    j = jgrid.poi_response(jnp.asarray(p), jgrid.POIConfig(region_fraction=0.02), 1.0 / _HZ,
                           p_ref=None if p_ref is None else jnp.float32(p_ref))
    scale = float(j.max_freq_dev_hz)
    assert scale > 0.01
    np.testing.assert_allclose(t.freq_dev_hz.numpy(), np.asarray(j.freq_dev_hz), rtol=0,
                               atol=_POI_FREQ_REL * scale)
    np.testing.assert_allclose(t.volt_dev.numpy(), np.asarray(j.volt_dev), rtol=1.2e-7,
                               atol=1e-9)
    np.testing.assert_allclose(float(t.max_freq_dev_hz), scale, rtol=_POI_FREQ_REL)


# ------------------------------------------------------------ mode detector


@pytest.mark.parametrize("seconds", [4.0, 60.0, 100.0, 200.0, 2000.0])
def test_mode_bank_bins_equal_jax(seconds):
    n = int(seconds * _HZ)
    t, j = tgrid.mode_bank(n, 1.0 / _HZ), jgrid.mode_bank(n, 1.0 / _HZ)
    assert (t.bins, t.modulus, t.dt, t.window) == (j.bins, j.modulus, j.dt, j.window)
    if seconds == 100.0:
        assert len(t.bins) == 186  # as the reference region's 100 s bank
        freqs = t.freqs
        for b in tgrid.DEFAULT_MODE_BANDS:
            assert np.any((freqs >= b.lo_hz) & (freqs < b.hi_hz)), b.name
        lo = min(b.lo_hz for b in tgrid.DEFAULT_MODE_BANDS)
        hi = max(b.hi_hz for b in tgrid.DEFAULT_MODE_BANDS)
        assert np.all((freqs >= lo) & (freqs <= hi))


def test_mode_verdicts_flag_injected_tone():
    n, dt = int(100.0 * _HZ), 1.0 / _HZ
    tone = (0.5 + 0.02 * np.sin(2 * np.pi * 0.5 * np.arange(n) * dt)).astype(np.float32)
    bank = tgrid.mode_bank(n, dt)
    obs = tcomp.spectrum_observer_update(bank, tcomp.spectrum_observer_init(bank, device=_DEV),
                                         torch.from_numpy(tone))
    mags, ok = tgrid.mode_verdicts(bank, obs, tgrid.DEFAULT_MODE_BANDS)
    assert ok.tolist() == [False, True]
    assert float(mags[0]) == pytest.approx(0.02, rel=0.05) and float(mags[1]) < 1e-3
    jbank = jgrid.mode_bank(n, dt)
    jobs = jcomp.spectrum_observer_update(jbank, jcomp.spectrum_observer_init(jbank),
                                          jnp.asarray(tone))
    jm, jok = jgrid.mode_verdicts(jbank, jobs, jgrid.DEFAULT_MODE_BANDS)
    assert ok.tolist() == np.asarray(jok).tolist()
    # The port's lines are an exact float64 product; the reference's float32
    # Goertzel drifts from it by up to ~1e-4 absolute at sub-Hz lines.
    np.testing.assert_allclose(mags.numpy(), np.asarray(jm), rtol=0, atol=2e-4)

    quiet = torch.full((n,), 0.5)
    obs_q = tcomp.spectrum_observer_update(bank, tcomp.spectrum_observer_init(bank, device=_DEV),
                                           quiet)
    assert tgrid.mode_verdicts(bank, obs_q, tgrid.DEFAULT_MODE_BANDS)[1].tolist() == [True, True]


def test_mode_verdicts_empty_band_passes():
    n = int(4.0 * _HZ)
    bank = tgrid.mode_bank(n, 1.0 / _HZ, bands=(tgrid.ModeBand("sub", 0.01, 0.2, 1e-9),))
    narrow = (tgrid.ModeBand("none", 0.0101, 0.0102, 1e-9),)
    obs = tcomp.spectrum_observer_update(bank, tcomp.spectrum_observer_init(bank, device=_DEV),
                                         torch.ones(n))
    mags, ok = tgrid.mode_verdicts(bank, obs, narrow)
    assert float(mags[0]) == 0.0 and bool(ok[0])


def test_with_mode_verdicts_folds_into_ok():
    rep = tcomp.check(torch.full((500,), 0.5), 1.0 / _HZ,
                      tcomp.GridSpec.create(device=_DEV))
    assert rep.mode_mags is None and rep.modes_ok is None and bool(rep.ok)
    for ok in ([True, True], [False, True]):
        m, o = torch.tensor([0.001, 0.002]), torch.tensor(ok)
        t = tcomp.with_mode_verdicts(rep, m, o)
        j = jcomp.with_mode_verdicts(jcomp.check(jnp.full((500,), 0.5), 1.0 / _HZ,
                                                 jcomp.GridSpec.create()),
                                     jnp.asarray(m.numpy()), jnp.asarray(o.numpy()))
        assert bool(t.modes_ok) == bool(j.modes_ok) == all(ok)
        assert bool(t.ok) == bool(j.ok) == all(ok)
        assert t.mode_mags is m and t.mode_ok is o
        assert torch.equal(t.max_ramp, rep.max_ramp)


# ---------------------------------------------------------------- POI fold


@pytest.mark.parametrize("chunk_intervals, seconds", [(16, 200.0), (4, 60.0), (3, 61.0)])
def test_poi_fold_matches_jax(chunk_intervals, seconds):
    """The POI observers folded over the campus engines' chunk partition:
    the ramps to an ulp (the reference divides by dt as a reciprocal
    multiply), the spec and mode lines within the reference's Goertzel
    drift, and the verdicts exactly."""
    dt = 1.0 / _HZ
    n = int(seconds * _HZ)
    rng = np.random.default_rng(3)
    t = np.arange(n) * dt
    pr = (0.7 + 0.1 * np.sign(np.sin(2 * np.pi * t / 8.0))
          + 0.01 * rng.standard_normal(n)).astype(np.float32)
    pg = (0.65 + 0.03 * np.sin(2 * np.pi * 0.125 * t)).astype(np.float32)
    k = 250
    chunk = chunk_intervals * k
    n_full, rem = divmod(n, chunk)
    spec = tcomp.GridSpec.create(device=_DEV)
    bank = tcomp.make_bank(n, dt, float(spec.f_c))
    mbank = tgrid.mode_bank(n, dt)
    po = tgrid._poi_fold(bank, mbank, chunk, n_full, rem, dt, torch.from_numpy(pr),
                         torch.from_numpy(pg))
    jbank = jcomp.make_bank(n, dt, 2.0)
    jpo = jgrid._poi_fold(jbank, jgrid.mode_bank(n, dt), chunk, n_full, rem, dt)(
        jnp.asarray(pr), jnp.asarray(pg))
    for name in ("ramp_rack", "ramp_grid"):
        for a, b in zip(getattr(po, name), getattr(jpo, name)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7, atol=0)
    for name, b_t, b_j in (("spec_rack", bank, jbank), ("spec_grid", bank, jbank),
                           ("modes", mbank, jgrid.mode_bank(n, dt))):
        _, mt = tcomp.spectrum_observer_finalize(b_t, getattr(po, name))
        _, mj = jcomp.spectrum_observer_finalize(b_j, getattr(jpo, name))
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=2e-4, err_msg=name)
        assert int(getattr(po, name).n) == int(np.asarray(getattr(jpo, name).n)) == n
    mags, ok = tgrid.mode_verdicts(mbank, po.modes, tgrid.DEFAULT_MODE_BANDS)
    jm, jok = jgrid.mode_verdicts(jgrid.mode_bank(n, dt), jpo.modes, jgrid.DEFAULT_MODE_BANDS)
    assert ok.tolist() == np.asarray(jok).tolist() == [False, True]
    # The fold equals one update over the whole trace up to float32
    # accumulation, and the exact DFT within chip_smoke.BANK_REL_TOL.
    whole = tcomp.spectrum_observer_update(mbank, tcomp.spectrum_observer_init(mbank, device=_DEV),
                                           torch.from_numpy(pg))
    _, mw = tcomp.spectrum_observer_finalize(mbank, whole)
    _, mf = tcomp.spectrum_observer_finalize(mbank, po.modes)
    np.testing.assert_allclose(mf.numpy(), mw.numpy(), rtol=1e-5, atol=1e-8)
    exact = chip_smoke.exact_band_lines(pg, mbank, tgrid.DEFAULT_MODE_BANDS)
    np.testing.assert_allclose(mags.numpy(), exact, rtol=chip_smoke.BANK_REL_TOL,
                               atol=chip_smoke.MODE_EXACT_ABS)
