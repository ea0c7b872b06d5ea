"""Parity of the port's scenario renderer with the JAX package.

* ``mixed_campus`` workload columns: bitwise (drawn with the same numpy
  generator and rounded to float32 the same way).
* The noise hash: bitwise (uint32 wraparound emulated in int64).
* ``_floor_mod``: bitwise against ``jnp.mod`` on boundary values.
* The noise itself: XLA's float32 ``erfinv`` polynomial is a few ulp off
  near 0 and up to ~6e-6 relative in the tails, where the port's is the
  float64 value rounded: 1e-5 relative (1e-6 absolute near 0).
* The rendered trace: the noise above scaled by ``noise_std``, cos
  rounding and XLA's fused multiply-adds: 1e-6 absolute on per-unit
  power.
* Chunked rendering in the port equals whole-trace rendering bitwise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.power import scenario as JSC, trace as JTR
from repro_torch.power import scenario as TSC, trace as TTR

torch.set_num_threads(1)
ARCHS = ("llama3_2_1b", "deepseek_v3_671b", "chatglm3_6b", "whisper_large_v3")


@pytest.fixture(scope="module")
def campuses():
    kw = dict(duration_s=30.0, sample_hz=200.0, seed=3, fault_at_s=18.0, noise_seed=2)
    return JSC.mixed_campus(40, ARCHS, **kw), TSC.mixed_campus(40, ARCHS, device="cpu", **kw)


def test_mixed_campus_columns_bitwise(campuses):
    js, ts = campuses
    for f in dataclasses.fields(JSC.WorkloadParams):
        j = np.asarray(getattr(js.params, f.name))
        t = getattr(ts.params, f.name).numpy()
        assert t.dtype == j.dtype == np.float32, f.name
        np.testing.assert_array_equal(t, j, err_msg=f.name)
    for name in ("sample_hz", "total_samples", "edge_width", "edge_pad", "noise_seed"):
        assert getattr(ts, name) == getattr(js, name), name


def test_workload_from_model_bitwise():
    for arch in ARCHS + ("qwen1_5_4b", "rwkv6_7b"):
        j = JSC.workload_from_model(arch)
        t = TSC.workload_from_model(arch, device="cpu")
        for f in dataclasses.fields(JSC.WorkloadParams):
            np.testing.assert_array_equal(
                getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name)), err_msg=f"{arch}.{f.name}")


def test_fmix32_and_hash_bits_bitwise():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x85EBCA6B], np.uint64),
        rng.integers(0, 2**32, 4096, dtype=np.uint64),
    ])
    j = np.asarray(JSC._fmix32(jnp.asarray(x.astype(np.uint32))))
    t = TSC._fmix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(t.astype(np.uint64), j.astype(np.uint64))
    # The full lane/sample hash, against the reference's derivation.
    idx = np.arange(-3, 5000, 7, dtype=np.int32)[3:]
    for seed, salt, r in ((2, None, 13), (0xDEADBEEF, 12345, 5)):
        s = jnp.uint32(seed)
        lane_seed = jnp.arange(r, dtype=jnp.uint32) * jnp.uint32(0x9E3779B9) ^ (
            s * jnp.uint32(0x85EBCA6B) + jnp.uint32(0x2545F491))
        if salt is not None:
            lane_seed = lane_seed ^ jnp.uint32(salt)
        lane = JSC._fmix32(lane_seed)
        h = JSC._fmix32(jnp.asarray(idx).astype(jnp.uint32)[:, None] ^ lane[None, :])
        want = np.asarray(h >> jnp.uint32(8)).astype(np.int64)
        got = TSC._hash_bits(seed, torch.from_numpy(idx), r, salt).numpy()
        np.testing.assert_array_equal(got, want)


def test_floor_mod_bitwise_on_boundaries():
    ys = np.array([22.0, 110.0, 0.5, 7.3, 1e30, 1.55, 4.8812346], np.float32)
    pieces = []
    for y in ys:
        ks = np.arange(-12, 13, dtype=np.float32)
        base = (ks[:, None] * y).astype(np.float32).ravel()
        pieces.append(np.stack([np.broadcast_to(y, base.shape), base]))
        for d in (np.float32(np.inf), np.float32(-np.inf)):
            pieces.append(np.stack([np.broadcast_to(y, base.shape), np.nextafter(base, d)]))
    rng = np.random.default_rng(1)
    rand_x = rng.uniform(-60.0, 260.0, 20000).astype(np.float32)
    pieces.append(np.stack([rng.choice(ys[:4], rand_x.shape), rand_x]))
    y, x = np.concatenate(pieces, axis=1)
    # The workload range: job-local times of any trace (|x| <= 1e5 s);
    # NEVER appears only as a period.  Subnormal x (the float neighbours
    # of 0) are left out: XLA:CPU flushes them to zero and PyTorch does
    # not, and a job-local time t - t_start of float32 operands of
    # magnitude >= 1e-3 is never subnormal.
    keep = (np.abs(x) <= 1e5) & ((x == 0) | (np.abs(x) >= np.finfo(np.float32).tiny))
    y, x = y[keep], x[keep]
    want = np.asarray(jnp.mod(jnp.asarray(x), jnp.asarray(y)))
    got = TSC._floor_mod(torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(JSC._floor_mod(jnp.asarray(x), jnp.asarray(y))))


def test_noise_within_tolerance():
    idx = np.arange(0, 6000, dtype=np.int32)
    j = np.asarray(JSC._hash_normal(2, jnp.asarray(idx), (24,)))
    t = TSC._hash_normal(2, torch.from_numpy(idx), (24,)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_render_matches_jax_and_chunks_are_bitwise(campuses):
    js, ts = campuses
    n = js.total_samples
    j = np.asarray(JSC.render(js, 0, n))
    whole = TSC.render(ts, 0, n)
    np.testing.assert_allclose(whole.numpy(), j, rtol=0, atol=1e-6)
    for chunk in (1000, 777):
        parts = [TSC.render(ts, t0, min(chunk, n - t0)) for t0 in range(0, n, chunk)]
        assert torch.equal(torch.cat(parts), whole), f"chunk={chunk}"
    provider = TSC.chunk_provider(ts)
    assert torch.equal(provider(1234, 500), whole[1234:1734])
    # ZOH pad past the end repeats the last in-range sample.
    pad = TSC.render_padded(ts, n - 300, 1000)
    assert torch.equal(pad[:300], whole[-300:])
    assert torch.equal(pad[300:], whole[-1:].expand(700, -1))
    assert TSC.chunk_count(ts, 1000) == -(-n // 1000)


def test_testbench_scenario_matches_jax():
    spec = JTR.TestbenchSpec(duration_s=60.0, sample_hz=500.0, terminate_at_s=50.0, fault_at_s=20.0)
    tspec = TTR.TestbenchSpec(duration_s=60.0, sample_hz=500.0, terminate_at_s=50.0, fault_at_s=20.0)
    j, jdt = JTR.testbench_trace(spec)
    t, tdt = TTR.testbench_trace(tspec, device="cpu")
    assert jdt == tdt
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)
    js = JTR.scenario_from_testbench(spec, noise_seed=7)
    ts = TTR.scenario_from_testbench(tspec, noise_seed=7, device="cpu")
    np.testing.assert_allclose(
        TSC.render(ts, 0, ts.total_samples).numpy(),
        np.asarray(JSC.render(js, 0, js.total_samples)), rtol=0, atol=1e-6)
    # Legacy whole-trace noise from a torch.Generator: same statistics.
    g = torch.Generator().manual_seed(0)
    noisy, _ = TTR.testbench_trace(tspec, g, device="cpu")
    d = (noisy - t).numpy()
    assert 0.008 < float(np.std(d)) < 0.012 and noisy.min() >= 0.0 and noisy.max() <= 1.0
