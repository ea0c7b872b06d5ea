"""The rmsnorm kernel's launch plan and order of summation, on the CPU.

``csrc/rmsnorm.cu`` cannot run here, so what surrounds it is held in
Python:

* ``launch_plan`` at every shape ``chip_smoke.py`` holds and times (and
  the main paths' widths over 1..3000 rows): every row goes to exactly one
  row group, every 16-byte vector of a row to exactly one lane, no more
  blocks than fit the card once (for any occupancy the runtime may give an
  instantiation) and none without a row; the plans it picks over every
  width of the row route are exactly the instantiations the source has;
  the constants and the row and lane maps are the source's (read from
  it).
* The kernel's sum of squares, emulated in float32 lane by lane for every
  instantiated (G, CH) of a width (a lane's CH vectors, the group's warps,
  the warp's xor butterfly), equals ``fold_sumsq`` bit for bit: the plan
  moves only the time.  ``fold_rmsnorm`` (the kernel's arithmetic) is held
  to the plain version (``ref.rmsnorm``) and to the JAX package's
  reference within one bf16 ulp (2^-7 of the value) or 1e-6 relative in
  float32, as ``chip_smoke.py`` holds the kernel, at the main paths'
  widths.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import ref as jref
from repro_torch.kernels import ref, rmsnorm as rn

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CSRC = (ROOT / "src/repro_torch/csrc/rmsnorm.cu").read_text()
H100_SMS = 132
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The row route's widths of chip_smoke's shapes: llama3.2-1b, rwkv6-7b,
# deepseek-v2/v3's MLA and block norms, and the edge case 9000.
WIDTHS = (512, 1536, 2048, 4096, 5120, 7168, 9000)


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CSRC).group(1))


def test_constants_and_instantiations_are_the_sources():
    assert rn.ROW_MAX_VECTORS == _constant("kRowMaxVec")
    assert rn.STAGE_MAX_D == _constant("kStageMaxD")
    assert rn.ROW_THREADS == _constant("kRowThreads")
    assert rn.ANY_THREADS == _constant("kAnyThreads")
    cases = re.findall(r"RMS_CASE\((\d+), (\d+), (\d+)\)", CSRC.split("#undef RMS_CASE")[0])
    assert tuple(tuple(map(int, c)) for c in cases) == rn.ROW_PLANS
    for n, ch in rn.REGISTER_CHUNKS.items():
        assert n % ch == 0 and 32 * n <= rn.ROW_MAX_VECTORS
    # The maps launch_plan's emulation below follows.
    assert "long long row = (long long)group * gridDim.x + blockIdx.x;" in CSRC
    assert "const long long step = (long long)gridDim.x * B::kGroups;" in CSRC
    assert "const int i = gl + c * 32 * G;" in CSRC
    assert "const int padded = padded_vectors(d / Vec<T>::N);" in CSRC
    assert "32 * warps_per_row * chunks != padded)" in CSRC


def test_plans_are_exactly_the_instantiations():
    """Over every width of the row route in both types, decode and prefill
    row counts and occupancies 1..3, ``launch_plan`` picks every
    instantiation of the source and no other; one more vector a row takes
    the scalar route."""
    seen = set()
    for t, v in ((torch.bfloat16, 8), (torch.float32, 4)):
        for d in range(8, v * rn.ROW_MAX_VECTORS + 1, 8):
            for rows in (1, 4, 2048, 5000):
                for per_sm in (1, 2, 3):
                    plan = rn.launch_plan(rows, d, t, H100_SMS, lambda g, c, s: per_sm)
                    assert plan.route == "rows"
                    seen.add(plan[:3])
        assert rn.launch_plan(4, v * rn.ROW_MAX_VECTORS + 8, t, H100_SMS,
                              lambda g, c, s: 1).route == "scalar"
    assert seen == set(rn.ROW_PLANS)


def _rows_of(plan: rn.Plan, rows: int) -> list[int]:
    """The rows each (block, group) walks, as the kernel does, flattened."""
    if plan.route == "scalar":
        return list(range(plan.blocks))
    step = plan.blocks * plan.groups
    return [r for b in range(plan.blocks) for k in range(plan.groups)
            for r in range(k * plan.blocks + b, rows, step)]


def _plans(rows, d, dtype):
    """The plan at (rows, d) for occupancies 1..6, aligned and not."""
    for per_sm in range(1, 7):
        for aligned in (True, False):
            yield per_sm, rn.launch_plan(rows, d, dtype, H100_SMS, lambda g, c, s: per_sm,
                                         aligned)


@pytest.mark.parametrize("rows,d,dtype,offset", chip_smoke.RMSNORM_SHAPES)
def test_plan_covers_every_row_once_at_the_timed_shapes(rows, d, dtype, offset):
    t = DTYPES[dtype]
    for per_sm, plan in _plans(rows, d, t):
        assert sorted(_rows_of(plan, rows)) == list(range(rows))
        if plan.route == "rows":
            assert plan[:3] in rn.ROW_PLANS
            assert 1 <= plan.blocks <= min(rows, H100_SMS * per_sm)
            p = rn.padded_vectors(d, t)
            assert 32 * plan.warps_per_row * plan.chunks == p
            lanes = sorted(gl + c * 32 * plan.warps_per_row
                           for gl in range(32 * plan.warps_per_row) for c in range(plan.chunks))
            assert lanes == list(range(p)) and p >= d // (8 if t == torch.bfloat16 else 4)
        else:
            assert plan.blocks == rows
    aligned = rn.launch_plan(rows, d, t, H100_SMS, lambda g, c, s: 2, not offset)
    assert aligned.route == ("rows" if d % 8 == 0 and not offset
                             and rn.padded_vectors(d, t) <= rn.ROW_MAX_VECTORS else "scalar")


@pytest.mark.parametrize("d", [512, 1536, 2048, 4096, 5120, 7168, 9000, 16384])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plan_covers_every_row_once_from_1_to_3000_rows(d, dtype):
    rng = np.random.default_rng(d)
    for rows in sorted({1, 2, 3, 4, 131, 132, 133, 263, 264, 265, 527, 528, 529, 2048,
                        *rng.integers(1, 3000, 20).tolist()}):
        for per_sm, plan in _plans(rows, d, DTYPES[dtype]):
            covered = _rows_of(plan, rows)
            assert len(covered) == rows and set(covered) == set(range(rows))
            assert plan.blocks <= (rows if plan.route == "scalar" else H100_SMS * per_sm)


def test_plan_stages_the_weight_only_for_many_wide_rows():
    """The weight goes to shared memory only where a row has >= 1024
    vectors, D is at most ``STAGE_MAX_D`` and the call has more rows than
    the register plan's groups at once (5120, 7168 and 10240 bf16 prefill,
    8192 to 10240 float32); decode rows and wider rows keep it in
    registers, up to ``ROW_MAX_VECTORS`` vectors a row."""
    res = lambda g, c, s: 2
    f32 = torch.float32
    plan = lambda rows, d, t=torch.bfloat16: rn.launch_plan(rows, d, t, H100_SMS, res)[:3]
    assert plan(2048, 5120) == plan(2048, 7168) == (4, 8, 1)
    assert plan(2048, 10240) == plan(2048, 8192, f32) == (8, 8, 1)
    assert plan(512, 9000, f32) == plan(2048, 10240, f32) == (16, 8, 1)
    for rows, d in ((4, 7168), (133, 7168), (2048, 2048), (2048, 4096), (2048, 512), (4, 2048)):
        assert plan(rows, d)[2] == 0
    assert plan(4, 7168) == (8, 4, 0)
    assert plan(2048, 16384) == (8, 8, 0) and plan(2048, 16384, f32) == (16, 8, 0)
    assert plan(4, 32768) == (16, 8, 0)
    assert rn.launch_plan(4, 32776, torch.bfloat16, H100_SMS, res).route == "scalar"


def _kernel_sums(x: torch.Tensor, g: int, ch: int) -> np.ndarray:
    """The kernel's sum of squares of each row with G = g, CH = ch, lane by
    lane in float32: a lane's vectors gl + c 32 G folded over c (stride
    CH / 2 first), the group's warps folded (stride G / 2 first), then the
    warp's xor butterfly, each lane adding its partner's value to its own."""
    d = x.shape[-1]
    v = 8 if x.dtype == torch.bfloat16 else 4
    xf = x.float().reshape(-1, d).numpy()
    sq = (xf * xf).reshape(len(xf), d // v, v)
    while sq.shape[-1] > 1:
        h = sq.shape[-1] // 2
        sq = sq[..., :h] + sq[..., h:]
    p = 32 * g * ch
    s = np.zeros((len(xf), p), np.float32)
    s[:, :d // v] = sq[..., 0]
    lane = s.reshape(len(xf), ch, 32 * g)  # [row, c, gl]: vector gl + c 32 G
    while lane.shape[1] > 1:
        h = lane.shape[1] // 2
        lane = lane[:, :h] + lane[:, h:]
    warp = lane[:, 0].reshape(len(xf), g, 32)  # [row, w, lane]: gl = 32 w + lane
    while warp.shape[1] > 1:
        h = warp.shape[1] // 2
        warp = warp[:, :h] + warp[:, h:]
    ss = warp[:, 0]
    for off in (16, 8, 4, 2, 1):
        ss = ss + ss[:, np.arange(32) ^ off]
    assert (ss == ss[:, :1]).all()  # every lane ends with the same bits
    return ss[:, 0]


@pytest.mark.parametrize("d", [8, 64, 256, 512, 1536, 2048, 4096, 5120, 7168, 9000, 10240,
                               16384])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_every_plan_folds_the_same_tree(d, dtype):
    t = DTYPES[dtype]
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((3, d)).astype(np.float32)).to(t)
    x[1] *= 1e3  # magnitudes where float32 sums round
    n = rn.padded_vectors(d, t) // 32
    want = rn.fold_sumsq(x).numpy()
    plans = sorted({(g, c) for g, c, _ in rn.ROW_PLANS if g * c == n})
    assert plans  # every width of the row route has an instantiation
    for g, c in plans:
        np.testing.assert_array_equal(_kernel_sums(x, g, c), want)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fold_rmsnorm_within_one_ulp_of_plain_and_jax(d, dtype):
    """The kernel's arithmetic (``fold_rmsnorm``) against ``ref.rmsnorm`` and
    JAX's jnp reference
    on the same bf16 or float32 values: one bf16 ulp (2^-7 of the value) or
    1e-6 relative, plus 1e-6 absolute, elementwise."""
    t = DTYPES[dtype]
    rng = np.random.default_rng(7 + d)
    x = torch.from_numpy(rng.standard_normal((16, d)).astype(np.float32)).to(t)
    w = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(t)
    got = rn.fold_rmsnorm(x, w, 1e-5).double()
    rel = 2.0**-7 if t == torch.bfloat16 else 1e-6
    jd = jnp.bfloat16 if t == torch.bfloat16 else jnp.float32
    jy = jref.rmsnorm(jnp.asarray(x.float().numpy(), jd), jnp.asarray(w.float().numpy(), jd), 1e-5)
    for want in (ref.rmsnorm(x, w, 1e-5).double(),
                 torch.from_numpy(np.array(jy.astype(jnp.float32))).double()):
        assert bool(((got - want).abs() <= rel * want.abs() + 1e-6).all())
