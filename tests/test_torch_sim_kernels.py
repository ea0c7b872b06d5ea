"""Parity of the port's hardware-path kernels and physics with the JAX package.

The same seeded numpy inputs go through ``repro.kernels.ops`` (the Pallas
kernels in interpret mode, ``force="pallas"``, and the jnp oracles,
``force="ref"``), ``repro.core.ess``/``filters`` and through the port's
counterparts on the CPU, which run the plain PyTorch versions the CUDA
kernels are held against on the card.  Tolerances and their reasons:

* ``lc_filter`` and ``pdu_sim`` (every weight variant, ragged T, the
  SoC-saturation path) against the interpret-mode kernels: bitwise.  The
  plain versions evaluate the expression tree XLA compiles for the Pallas
  bodies, fused multiply-adds included, and ``pdu_sim`` takes the kernel's
  float64-rounded ramp gain (``ref.pdu_sim_consts``).
* The same against the jnp oracles: 2e-5, the JAX tests' own tolerance
  (tests/test_kernels.py).  The oracles' scans contract the LC mul-adds
  differently, and ``repro.kernels.ref.pdu_sim`` takes a float32 gain,
  4.4e-4 relative away from the kernel's at beta = 0.0625, dt = 1 ms.
* ``ess.step``/``simulate``: eager float32 ops against XLA's fused ones
  (one rounding per fused multiply-add), a few ulps per step: 2e-6 on the
  node power and SoC over hundreds of steps.  ``filters.simulate``: the
  3-term state products summed in another order, an ulp per step that
  the lightly damped LC resonance carries on (measured 5.2e-6 over 400
  steps): 2e-5, the JAX tests' tolerance, as for the unfused pipeline
  against the fused ``pdu_sim``.
* Transfer functions: complex64 arithmetic in another order: 1e-6
  relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ess as jess, filters as jfilters, pdu as jpdu, sizing as jsizing
from repro.kernels import ops as jops
from repro_torch.core import ess, filters, pdu, sizing
from repro_torch.kernels import gemm_burn, lc_filter, ops, pdu_sim

torch.set_num_threads(1)

PDU_KW = dict(beta=0.0625, dt=1e-3, q_max=40.0, eta_c=0.97, eta_d=0.97, p_max=1.0,
              soc_min=0.1, soc_max=0.9)


def _bitwise(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    assert np.array_equal(a, b), f"{what} must be bitwise ({np.sum(a != b)} differ)"


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(b, np.float32), np.asarray(a, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _proto(dt=1e-3):
    """The prototype-rack filter of tests/test_kernels.py, as numpy."""
    s = jsizing.size_system(jsizing.prototype_rack(), beta=0.0625)
    filt = jfilters.make_discrete_filter(jpdu.per_unit_filter(s, jsizing.prototype_rack()), dt)
    return filt, tuple(np.asarray(m) for m in (filt.ad, filt.bd, filt.c[0]))


def _x0(filt, r, load=0.5):
    return np.tile(np.asarray(jfilters.steady_state(filt, jnp.array([1.0, load]))), (r, 1))


T = torch.from_numpy
J = jnp.asarray


@pytest.mark.parametrize("t,r,block_t", [(1000, 8, 256), (513, 4, 128), (256, 128, 256),
                                         (100, 3, 512)])
def test_lc_filter_matches_jax(t, r, block_t):
    filt, lc = _proto()
    rng = np.random.default_rng(t + r)
    u = (0.5 + 0.3 * rng.random((t, r))).astype(np.float32)
    x0 = _x0(filt, r)
    got = ops.lc_filter(*lc, T(x0), T(u))
    want = jops.lc_filter(*map(J, lc), J(x0), J(u), force="pallas", block_t=block_t)
    _bitwise(want[0], got[0], "grid vs the interpret-mode kernel")
    _bitwise(want[1], got[1], "final state vs the interpret-mode kernel")
    oracle = jops.lc_filter(*map(J, lc), J(x0), J(u), force="ref")
    for w, g in zip(oracle, got):
        _close(w, g, 2e-5, "vs ref.lc_filter")


def _pdu_inputs(t, r, seed, weight):
    rng = np.random.default_rng(seed)
    u = (0.2 + 0.7 * rng.random((t, r))).astype(np.float32)
    corr = (1e-3 * rng.standard_normal((t, r))).astype(np.float32)
    soc0 = np.full(r, 0.5, np.float32)
    soc0[: max(r // 4, 1)] = 0.895  # near the top of the window: the clamp runs
    w = None
    if weight == "row":
        w = (rng.random(r) > 0.3).astype(np.float32)
        w[0] = 0.5
    elif weight == "series":
        w = np.clip(2 * rng.random((t, r)) - 0.5, 0, 1).astype(np.float32)
    return u, u[0].copy(), soc0, corr, w


def _compare_pdu(u, g0, soc0, x0, lc, corr, w, kw, block_t=256):
    got = ops.pdu_sim(T(u), T(g0), T(soc0), T(x0), *lc, T(corr),
                      ess_on=None if w is None else T(w), **kw)
    jw = {} if w is None else dict(ess_on=J(w))
    args = (J(u), J(g0), J(soc0), J(x0), *map(J, lc), J(corr))
    want = jops.pdu_sim(*args, force="pallas", block_t=block_t, **jw, **kw)
    oracle = jops.pdu_sim(*args, force="ref", **jw, **kw)
    names = ("grid", "soc")
    for n, a, b in zip(names, want, got):
        _bitwise(a, b, f"{n} vs the interpret-mode kernel")
    for n, a, b in zip(("g_f", "soc_f", "x_f"), want[2], got[2]):
        _bitwise(a, b, f"{n} vs the interpret-mode kernel")
    for n, a, b in zip(names, oracle, got):
        _close(a, b, 2e-5, f"{n} vs ref.pdu_sim")
    for n, a, b in zip(("g_f", "soc_f", "x_f"), oracle[2], got[2]):
        _close(a, b, 2e-5, f"{n} vs ref.pdu_sim")
    return got


@pytest.mark.parametrize("weight", [None, "row", "series"])
@pytest.mark.parametrize("t,r", [(700, 128), (513, 9), (100, 3)])
def test_pdu_sim_matches_jax(t, r, weight):
    filt, lc = _proto()
    u, g0, soc0, corr, w = _pdu_inputs(t, r, t * 7 + r, weight)
    _compare_pdu(u, g0, soc0, _x0(filt, r), lc, corr, w, dict(PDU_KW, q_max=5.0))


@pytest.mark.parametrize("weight", [None, "series"])
def test_pdu_sim_saturation_path(weight):
    """tests/test_kernels.py's shed path: a drop charges a nearly full
    battery into the window bound."""
    filt, lc = _proto()
    t, r = 2000, 4
    u = np.full((t, r), 0.9, np.float32)
    u[500:] = 0.1
    soc0 = np.full(r, 0.88, np.float32)
    w = None if weight is None else np.where(np.arange(t)[:, None] % 300 < 150, 1.0,
                                             0.25 * np.arange(r)).astype(np.float32)
    got = _compare_pdu(u, u[0].copy(), soc0, _x0(filt, r, 0.9), lc, np.zeros((t, r), np.float32),
                       w, dict(PDU_KW, q_max=5.0), block_t=512)
    soc = got[1].numpy()
    assert soc.max() <= 0.9 + 1e-6 and np.any(soc == np.float32(0.9))


def test_pdu_sim_scalar_corrective_equals_dense():
    filt, lc = _proto()
    u, g0, soc0, _, _ = _pdu_inputs(200, 5, 3, None)
    x0 = T(_x0(filt, 5))
    a = ops.pdu_sim(T(u), T(g0), T(soc0), x0, *lc, 2e-3, **PDU_KW)
    b = ops.pdu_sim(T(u), T(g0), T(soc0), x0, *lc, torch.full((200, 5), 2e-3), **PDU_KW)
    for x, y in zip(a[:2] + a[2], b[:2] + b[2]):
        assert torch.equal(x, y)


def _ess_pair(**kw):
    return jess.ESSParams.create(**kw), ess.ESSParams.create(**kw, device="cpu")


@pytest.mark.parametrize("online", [None, "const", "series"])
def test_ess_simulate_matches_jax(online):
    jp, tp = _ess_pair(beta=0.0625, q_max_seconds=5.0)
    t, r = 600, 6
    rng = np.random.default_rng(11)
    u = (0.2 + 0.7 * rng.random((t, r))).astype(np.float32)
    corr = (1e-3 * rng.standard_normal((t, r))).astype(np.float32)
    soc0 = np.array([0.5, 0.5, 0.895, 0.105, 0.3, 0.7], np.float32)
    w = {None: None, "const": np.array([1, 0, 0.5, 1, 0.25, 1], np.float32),
         "series": np.clip(2 * rng.random((t, r)) - 0.5, 0, 1).astype(np.float32)}[online]
    node_j, soc_j, fin_j = jess.simulate(jp, jess.ESSState(J(u[0]), J(soc0)), J(u), 1e-3, J(corr),
                                         online=None if w is None else J(w))
    node_t, soc_t, fin_t = ess.simulate(tp, ess.ESSState(T(u[0]), T(soc0)), T(u), 1e-3, T(corr),
                                        online=None if w is None else T(w))
    _close(node_j, node_t, 2e-6, "node power")
    _close(soc_j, soc_t, 2e-6, "soc")
    _close(fin_j.g_filter, fin_t.g_filter, 2e-6, "final filter")
    _close(fin_j.soc, fin_t.soc, 2e-6, "final soc")
    assert soc_t.max() <= 0.9 and soc_t.min() >= 0.1


def test_ess_step_and_helpers_match_jax():
    jp, tp = _ess_pair()
    rng = np.random.default_rng(12)
    r = rng.random(8).astype(np.float32)
    st_j = jess.init_state(jp, J(r), 0.4)
    st_t = ess.init_state(tp, T(r), 0.4)
    _bitwise(st_j.soc, st_t.soc, "init soc")
    w = np.array([1, 0, 0.5, 1, 1, 0, 1, 0.25], np.float32)
    rp = rng.random(8).astype(np.float32)
    for online in (None, w):
        jw, tw = (None, None) if online is None else (J(online), T(online))
        sj, gj = jess.step(jp, st_j, J(rp), 1e-3, 0.01, online=jw)
        stp, gt = ess.step(tp, st_t, T(rp), 1e-3, 0.01, online=tw)
        _close(gj, gt, 1e-6, "step node power")
        _close(sj.soc, stp.soc, 1e-6, "step soc")
        _close(sj.g_filter, stp.g_filter, 1e-6, "step filter")
    p = np.linspace(-1, 1, 11).astype(np.float32)
    _close(jess.soc_increment(jp, J(p), 0.005), ess.soc_increment(tp, T(p), 0.005), 1e-6,
           "soc_increment")
    d = np.linspace(-1e-3, 1e-3, 9).astype(np.float32)
    back = ess.battery_power_from_soc_delta(tp, T(d), 0.005)
    _close(jess.battery_power_from_soc_delta(jp, J(d), 0.005), back, 1e-6, "inverse")
    _close(d, ess.soc_increment(tp, back, 0.005), 1e-6, "inverse round trip")
    swing = float(jess.worst_case_energy_swing(jp, 0.9))
    assert float(ess.worst_case_energy_swing(tp, 0.9)) == swing
    cap = jess.required_capacity_seconds(0.1, 0.9, 0.8)
    assert ess.required_capacity_seconds(0.1, 0.9, 0.8) == cap
    assert ess.required_power_fraction(0.9) == jess.required_power_fraction(0.9)


def test_filters_simulate_matches_jax():
    filt, _ = _proto()
    tfilt = filters.make_discrete_filter(
        pdu.per_unit_filter(sizing.size_system(sizing.prototype_rack(), beta=0.0625),
                            sizing.prototype_rack(), device="cpu"), 1e-3)
    t, r = 400, 5
    rng = np.random.default_rng(13)
    u = (0.4 + 0.4 * rng.random((t, r))).astype(np.float32)
    uu = np.stack([np.ones_like(u), u], axis=-1)
    x0 = _x0(filt, r, 0.4)
    yj, xj = jfilters.simulate(filt, J(x0), J(uu))
    yt, xt = filters.simulate(tfilt, T(x0), T(uu))
    assert yt.shape == (t, r, 1)
    _close(yj, yt, 2e-5, "grid")
    _close(xj, xt, 2e-5, "final state")


@pytest.mark.parametrize("weight", [None, "const", "series"])
def test_unfused_pipeline_matches_pdu_sim(weight):
    """The fused plain ``pdu_sim`` == ``ess.simulate`` piped into
    ``filters.simulate`` (tests/test_kernels.py, with every weight form)."""
    filt, lc = _proto()
    tfilt = filters.DiscreteFilter(ad=T(lc[0].copy()), bd=T(lc[1].copy()), c=T(lc[2][None].copy()),
                                  dt=1e-3)
    t, r = 600, 6
    rng = np.random.default_rng(14)
    u = T((0.3 + 0.5 * rng.random((t, r))).astype(np.float32))
    w = {None: None, "const": T(np.array([1, 0, 0.5, 1, 0.25, 1], np.float32)),
         "series": T(np.clip(2 * rng.random((t, r)) - 0.5, 0, 1).astype(np.float32))}[weight]
    x0 = T(_x0(filt, r))
    ep = ess.ESSParams.create(beta=PDU_KW["beta"], q_max_seconds=PDU_KW["q_max"], device="cpu")
    node, soc_t, _ = ess.simulate(ep, ess.ESSState(u[0], torch.full((r,), 0.5)), u, 1e-3, online=w)
    grid, _ = filters.simulate(tfilt, x0, torch.stack([torch.ones_like(node), node], dim=-1))
    got = ops.pdu_sim(u, u[0], torch.full((r,), 0.5), x0, *lc, 0.0, ess_on=w, **PDU_KW)
    _close(grid[..., 0], got[0], 2e-5, "grid")
    _close(soc_t, got[1], 2e-5, "soc")


def test_transfer_functions_match_jax():
    jcfg = jpdu.make_pdu(sample_dt=1e-3)
    tcfg = pdu.make_pdu(sample_dt=1e-3, device="cpu")
    f = np.logspace(-4, 3, 200).astype(np.float32)
    pairs = [
        (jess.transfer_function(jcfg.ess_params, J(f)),
         ess.transfer_function(tcfg.ess_params, T(f))),
        (jfilters.transfer_function_rack_to_grid(jcfg.filter_params, J(f)),
         filters.transfer_function_rack_to_grid(tcfg.filter_params, T(f))),
        (jpdu.combined_transfer_function(jcfg, J(f)), pdu.combined_transfer_function(tcfg, T(f))),
    ]
    for a, b in pairs:
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-12)
    peak_j = float(jfilters.resonance_peak_db(jcfg.filter_params))
    peak_t = float(filters.resonance_peak_db(tcfg.filter_params))
    assert peak_t == pytest.approx(peak_j, rel=1e-5)


# ------------------------------------------------------------- CPU dispatch


def _lc_args(t=6, r=2):
    return (np.eye(3, dtype=np.float32), np.zeros((3, 2), np.float32), np.ones(3, np.float32),
            torch.zeros(r, 3), torch.full((t, r), 0.5))


def _pdu_args(t=6, r=2):
    return (torch.full((t, r), 0.5), torch.full((r,), 0.5), torch.full((r,), 0.5),
            torch.zeros(r, 3), np.eye(3, dtype=np.float32), np.zeros((3, 2), np.float32),
            np.ones(3, np.float32), 0.0)


def _reset():
    for f in (lc_filter.lc_filter, pdu_sim.pdu_sim, gemm_burn.gemm_burn):
        f.launches = 0


def test_cpu_dispatch_takes_the_plain_versions():
    _reset()
    a, b = torch.randn(8, 4), torch.randn(4, 5)
    for force in (None, "ref"):
        grid, xf = ops.lc_filter(*_lc_args(), force=force)
        assert grid.shape == (6, 2) and xf.shape == (2, 3)
        out = ops.pdu_sim(*_pdu_args(), force=force, **PDU_KW)
        assert out[0].shape == (6, 2) and out[2][2].shape == (2, 3)
        assert ops.gemm_burn(a, b, 2, force=force).shape == (8, 5)
    with ops.forced("ref"):
        ops.gemm_burn(a, b)
    assert (lc_filter.lc_filter.launches, pdu_sim.pdu_sim.launches,
            gemm_burn.gemm_burn.launches) == (0, 0, 0)


def test_force_cuda_raises_on_cpu_tensors():
    a, b = torch.randn(8, 4), torch.randn(4, 5)
    with pytest.raises(ValueError, match="CUDA"):
        ops.lc_filter(*_lc_args(), force="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.pdu_sim(*_pdu_args(), force="cuda", **PDU_KW)
    with pytest.raises(ValueError, match="CUDA"):
        ops.gemm_burn(a, b, force="cuda")
    with pytest.raises(ValueError, match="force"):
        ops.gemm_burn(a, b, force="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        lc_filter.lc_filter(*_lc_args())
    with pytest.raises(ValueError, match="CUDA tensors"):
        pdu_sim.pdu_sim(*_pdu_args(), **PDU_KW)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gemm_burn.gemm_burn(a, b)


def test_kernel_route_refuses_a_recording_graph(monkeypatch):
    """On the kernel route the three ops have no gradient (as the
    reference's kernels); without a graph they reach the wrapper, whose
    device check is the first thing it does."""
    monkeypatch.setattr(ops, "_use_kernel", lambda t, force: True)
    a, b = torch.randn(8, 4, requires_grad=True), torch.randn(4, 5)
    with pytest.raises(NotImplementedError, match="backward"):
        ops.gemm_burn(a, b)
    lc = list(_lc_args())
    lc[4] = lc[4].requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        ops.lc_filter(*lc)
    pa = list(_pdu_args())
    pa[1] = pa[1].requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        ops.pdu_sim(*pa, **PDU_KW)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensors"):
            ops.gemm_burn(a, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.pdu_sim(*_pdu_args(), ess_on=torch.ones(2), **PDU_KW)
