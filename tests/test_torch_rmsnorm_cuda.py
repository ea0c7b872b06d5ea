"""The rmsnorm kernel on the card (``-m cuda``; each test skips without a
CUDA device).  No JAX here: the kernel is held to the port's plain version
(``ref.rmsnorm``) within one bf16 ulp (2^-7 of the value) or 1e-6 relative
in float32, plus 1e-6 absolute, as ``chip_smoke.py`` holds it, at every
shape ``chip_smoke.RMSNORM_SHAPES`` times (the main paths' prefill and
decode rows and the edge cases, which between them take every plan that
stages the weight), with the same bits on two runs and, on the row route,
as ``fold_rmsnorm``; and at every width of the row route (every plan that
holds the weight in registers).  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rmsnorm_cuda.py
"""
import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.kernels import _build, ref, rmsnorm as rn


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("the rmsnorm kernel runs only on a CUDA card")
    return torch.device("cuda")


def _inputs(rows, d, dtype, offset, dev, seed=0):
    """x (rows, d) and w (d,) from seeded numpy; with ``offset`` x starts one
    element past an aligned address."""
    rng = np.random.default_rng(seed)
    t = getattr(torch, dtype)
    flat = torch.from_numpy(rng.standard_normal(rows * d + int(offset)).astype(np.float32))
    x = flat.to(dev, t)[int(offset):].view(rows, d)
    w = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(dev, t)
    return x, w


def _close(got, want):
    rel = 2.0**-7 if got.dtype == torch.bfloat16 else 1e-6
    g, w = got.double(), want.double()
    return got.shape == want.shape and bool(((g - w).abs() <= rel * w.abs() + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype,offset", chip_smoke.RMSNORM_SHAPES)
def test_kernel_matches_plain_at_every_timed_shape(dev, rows, d, dtype, offset):
    x, w = _inputs(rows, d, dtype, offset, dev)
    got = rn.rmsnorm(x, w, 1e-5)
    assert _close(got, ref.rmsnorm(x, w, 1e-5))
    assert torch.equal(got, rn.rmsnorm(x, w, 1e-5))
    plan = rn.plan_for(x, w)
    row_route = not offset and d % 8 == 0 and rn.padded_vectors(d, x.dtype) <= rn.ROW_MAX_VECTORS
    assert plan.route == ("rows" if row_route else "scalar")
    if plan.route == "rows":
        assert torch.equal(got, rn.fold_rmsnorm(x, w, 1e-5))


@pytest.mark.cuda
def test_timed_shapes_take_every_staged_plan(dev):
    staged = set()
    for rows, d, dtype, offset in chip_smoke.RMSNORM_SHAPES:
        x, w = _inputs(rows, d, dtype, offset, dev)
        plan = rn.plan_for(x, w)
        if plan.route == "rows" and plan.stage:
            staged.add(plan[:3])
    assert staged == {p for p in rn.ROW_PLANS if p[2]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_every_row_route_width(dev, dtype):
    """Every D multiple of 8 up to the row route's limit (every plan with
    the weight in registers), 5 rows each, bit for bit ``fold_rmsnorm``."""
    v = 8 if dtype == "bfloat16" else 4
    plans = set()
    for d in range(8, v * rn.ROW_MAX_VECTORS + 1, 8):
        x, w = _inputs(5, d, dtype, False, dev, seed=d)
        plans.add(rn.plan_for(x, w)[:3])
        got = rn.rmsnorm(x, w, 1e-5)
        assert _close(got, ref.rmsnorm(x, w, 1e-5)), d
        assert torch.equal(got, rn.fold_rmsnorm(x, w, 1e-5)), d
    assert plans == {p for p in rn.ROW_PLANS if not p[2]}


@pytest.mark.cuda
def test_kernel_zero_rows_and_leading_axes(dev):
    w = torch.ones(512, device=dev, dtype=torch.bfloat16)
    assert rn.rmsnorm(torch.empty(0, 512, device=dev, dtype=torch.bfloat16), w).shape == (0, 512)
    assert rn.rmsnorm(torch.empty(2, 0, 512, device=dev, dtype=torch.bfloat16), w).shape \
        == (2, 0, 512)
    x, w = _inputs(3 * 7000, 64, "bfloat16", False, dev)
    x = x.view(3, 7000, 64)
    got = rn.rmsnorm(x, w, 1e-6)
    assert _close(got, ref.rmsnorm(x, w, 1e-6))
    assert torch.equal(got.view(-1, 64), rn.rmsnorm(x.view(-1, 64), w, 1e-6))


@pytest.mark.cuda
def test_kernel_refuses_a_plan_it_does_not_run(dev):
    """The C entry refuses a plan with no instantiation, one whose G x CH
    is not the row's padded width, and a staged weight past kStageMaxD."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.launch_fn("rmsnorm", "rmsnorm_launch",
                          [vp, vp, vp, ci, ci, ctypes.c_float, ci, ci, ci, ci, ci, ci, vp])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    for d, g, ch, stage in ((2048, 1, 8, 0), (2048, 8, 4, 0), (16384, 8, 8, 1)):
        x, w = _inputs(4, d, "bfloat16", False, dev)
        y = torch.empty_like(x)
        assert fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), 4, d, 1e-5, 1, g, ch, stage, 1, sms,
                  stream) != 0, (d, g, ch, stage)
