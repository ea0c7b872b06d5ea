"""Parity of the port's software-burn baseline with the JAX package.

``gemm_burn`` (the burn GEMM's plain version), ``core/burn.py`` (paper
Algorithms 1 and 2, Fig. 11's energy comparison) and the testbench specs
of ``power/trace.py`` against ``repro``'s, on the same seeded inputs.
Tolerances and their reasons:

* ``gemm_burn`` against the interpret-mode kernel and ``ref.gemm_burn``:
  tests/test_kernels.py's own (products summed in another order; bf16
  outputs within a few ulps); ``n_iters`` 1 and 8 give the same value
  within 1e-4 (tests/test_kernels.py).
* ``calibrate`` on JAX's noise (fed in): a 2 x 2 least-squares solve in
  another order: 1e-6.  ``duty_for_power``, ``true_duty_power``: float32
  arithmetic: 1e-6 relative.  ``compare_energy``'s energies: float32 sums
  of 20000 samples in another order, over envelopes that differ as below:
  1e-5 relative; its fractions, differences of those energies over them:
  1e-5 absolute.
* ``ramp_compliant_envelope``: the port's closed form (float64, rounded
  once) against the reference's float32 max-scans, which round every step
  of a ramp: the scans drift by up to half an ulp (3e-8 at 0.5) per step
  over ramps of up to ~1640 steps in each of the two passes, so 1e-4
  absolute (measured 1.9e-5 on the Titan-X trace).
* Testbench traces: both packages render the same scenario IR; cos and
  erfinv rounding differ by an ulp or two: 1e-6 absolute.
* Fig. 11 on the CPU: ``chip_smoke.FIG11_TOLERANCES`` against
  ``JAX_FIG11`` (their reasons are in the script).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import burn as jburn
from repro.kernels import ops as jops, ref as jref
from repro.power import scenario as jSC, trace as jtrace
from repro_torch.core import burn, compliance
from repro_torch.kernels import ops, ref
from repro_torch.power import scenario as SC, trace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
T = lambda a: torch.from_numpy(np.array(a))
J = jnp.asarray


def _gemm_inputs(m, n, k, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    if dtype == "bfloat16":
        return (T(a).to(torch.bfloat16), T(b).to(torch.bfloat16),
                J(a).astype(jnp.bfloat16), J(b).astype(jnp.bfloat16))
    return T(a), T(b), J(a), J(b)


@pytest.mark.parametrize("n_iters", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mnk", [(128, 128, 128), (256, 128, 512), (384, 256, 128)])
def test_gemm_burn_matches_jax(mnk, dtype, n_iters):
    m, n, k = mnk
    ta, tb, ja, jb = _gemm_inputs(m, n, k, dtype, m + n + k)
    got = ops.gemm_burn(ta, tb, n_iters)
    assert got.dtype == ta.dtype and got.shape == (m, n)
    tol = chip_smoke._gemm_tol(dtype, k)
    for want in (jops.gemm_burn(ja, jb, n_iters, force="pallas", bm=128, bn=128, bk=128),
                 jref.gemm_burn(ja, jb, n_iters)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_gemm_burn_flop_knob_keeps_the_value():
    ta, tb, _, _ = _gemm_inputs(128, 128, 128, "float32", 2)
    np.testing.assert_allclose(ref.gemm_burn(ta, tb, 1).numpy(), ref.gemm_burn(ta, tb, 8).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_calibrate_matches_jax_on_its_noise():
    key = jax.random.key(3)
    want = jburn.calibrate(key, p_idle=0.06, p_peak=1.0, noise_std=0.005)
    noise = np.asarray(jax.random.normal(key, (16, 32)))
    got = burn.calibrate(None, 0.06, 1.0, noise_std=0.005, noise=T(noise), device="cpu")
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), abs=1e-6)
    assert float(got.a) == pytest.approx(0.94, abs=0.02)
    assert float(got.b) == pytest.approx(0.06, abs=0.02)
    own = burn.calibrate(torch.Generator().manual_seed(0), 0.06, 1.0, noise_std=0.005,
                         device="cpu")
    assert float(own.residual) < 0.01 and float(own.a) == pytest.approx(0.94, abs=0.02)
    with pytest.raises(ValueError, match="generator"):
        burn.calibrate(None, 0.06, 1.0, device="cpu")


def test_duty_map_matches_jax():
    jcal = jburn.DutyCalibration(a=J(0.9), b=J(0.1), residual=J(0.0))
    tcal = burn.DutyCalibration(a=torch.tensor(0.9), b=torch.tensor(0.1),
                                residual=torch.tensor(0.0))
    p = np.linspace(-0.5, 2.0, 26).astype(np.float32)
    d = burn.duty_for_power(tcal, T(p))
    np.testing.assert_allclose(d.numpy(), np.asarray(jburn.duty_for_power(jcal, J(p))), rtol=1e-6)
    assert float(d.min()) == 0.0 and float(d.max()) == 1.0
    back = burn.true_duty_power(d, 0.1, 1.0)
    np.testing.assert_allclose(back.numpy(), np.asarray(jburn.true_duty_power(J(d.numpy()), 0.1,
                                                                              1.0)), rtol=1e-6)
    inside = (p > 0.1) & (p < 1.0)
    np.testing.assert_allclose(back.numpy()[inside], p[inside], atol=1e-6)


@pytest.mark.parametrize("case", ["square", "square_2d", "slow", "titanx"])
def test_envelope_matches_the_reference_scans(case):
    dt, beta = 0.01, 0.1
    if case.startswith("square"):
        shape = (5000, 3) if case == "square_2d" else (5000,)
        rack = np.asarray(0.5 + 0.4 * jnp.sign(jax.random.normal(jax.random.key(1), shape)))
    elif case == "slow":
        t = np.arange(2000, dtype=np.float32) * dt
        rack = (0.5 + 0.3 * np.sin(2 * np.pi * 0.01 * t)).astype(np.float32)
    else:
        rack, dt = jtrace.titanx_testbench(jax.random.key(2))
        rack = np.concatenate([np.full(6000, 0.1, np.float32), np.asarray(rack)])
    want = np.asarray(jburn.ramp_compliant_envelope(J(rack), dt, beta))
    got = burn.ramp_compliant_envelope(T(rack), dt, beta)
    assert got.dtype == torch.float32 and got.shape == rack.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert bool(torch.all(got >= T(rack)))
    assert float(torch.max(compliance.max_abs_ramp(got, dt))) <= beta * (1 + 1e-3)
    if case == "slow":  # already compliant: the envelope is the trace
        np.testing.assert_allclose(got.numpy(), rack, atol=1e-6)


def test_burn_schedule_and_energy_match_jax():
    rack, dt = jtrace.titanx_testbench(jax.random.key(2))
    rack = np.asarray(rack)[:20000]
    jcal = jburn.calibrate(jax.random.key(3), p_idle=0.06, p_peak=1.0)
    tcal = burn.DutyCalibration(*(torch.tensor(float(v)) for v in jcal))
    want = jburn.burn_schedule(J(rack), dt, beta=0.1, cal=jcal)
    got = burn.burn_schedule(T(rack), dt, beta=0.1, cal=tcal)
    assert got.conditioned.shape == want.conditioned.shape == (26000,)
    for name in ("conditioned", "burn_power", "duty"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=2e-4, err_msg=name)
    assert float(got.energy_overhead_frac) == pytest.approx(float(want.energy_overhead_frac),
                                                           abs=1e-5)
    grid = rack * 0.98 + 0.01
    kw = dict(soc_delta=-0.05, q_max_seconds=40.0)
    jc = jburn.compare_energy(J(rack), J(grid), want.conditioned[6000:], dt, **kw)
    tc = burn.compare_energy(T(rack), T(grid), got.conditioned[6000:], dt, **kw)
    assert set(tc) == set(jc)
    for k in jc:
        tol = dict(abs=1e-5) if k.endswith("_frac") else dict(rel=1e-5)
        assert float(tc[k]) == pytest.approx(float(jc[k]), **tol), k


@pytest.mark.parametrize("name", ["choukse", "titanx", "cluster_fault"])
@pytest.mark.parametrize("noise_seed", [None, 2])
def test_testbench_specs_match_jax(name, noise_seed):
    jspec, tspec = getattr(jtrace, f"{name}_spec")(), getattr(trace, f"{name}_spec")()
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    if noise_seed is None:
        want, jdt = getattr(jtrace, f"{name}_testbench" if name != "cluster_fault"
                            else "cluster_fault_trace")()
        got, dt = getattr(trace, f"{name}_testbench" if name != "cluster_fault"
                          else "cluster_fault_trace")(device="cpu")
    else:
        want, jdt = jSC.render_trace(jtrace.scenario_from_testbench(jspec, noise_seed=noise_seed))
        got, dt = SC.render_trace(trace.scenario_from_testbench(tspec, noise_seed=noise_seed,
                                                                device="cpu"))
    assert dt == jdt and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_testbench_generator_noise():
    """The trace noise comes from the caller's generator: reproducible,
    clipped to [0, 1], of the spec's standard deviation."""
    a, _ = trace.titanx_testbench(torch.Generator().manual_seed(2), device="cpu")
    b, _ = trace.titanx_testbench(torch.Generator().manual_seed(2), device="cpu")
    clean, _ = trace.titanx_testbench(device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, clean)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    inside = (clean > 0.05) & (clean < 0.95)
    assert float(torch.std((a - clean)[inside])) == pytest.approx(0.01, rel=0.05)


def test_fig11_on_the_cpu():
    """Paper Fig. 11 through the port on the CPU: chip_smoke's phase 12
    pipeline on the counter-hashed trace, its bands and ``JAX_FIG11``."""
    got = chip_smoke.port_fig11_reference(device="cpu")
    assert chip_smoke.check_fig11(got) == []
    assert chip_smoke.compare_fig11(got, chip_smoke.JAX_FIG11) == []
