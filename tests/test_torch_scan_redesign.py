"""The redesigned ``rwkv6_scan`` and ``admm_step`` kernels' plans and
arithmetic, on the CPU.

On the card ``rwkv6_scan`` splits each state column's rows over threads
of 8 to 32 rows (two columns each) or 128 above 256, at most 8 of them in
a block (a slab of rows), each block summing its threads' partial outputs
in order through shared memory, with the bonus factored out of the (D, D)
loop; a head dim above 1024 has several slabs, whose partial outputs a
second kernel sums in order, so any head dim runs.  A single step up to
head dim 128 runs the step kernel, one thread a column, which sums the
column in the same parts and order.  ``admm_step`` at horizons 12 and 24 gives each rack a warp
(two at 24), lane i owning x-row i.  Without a card these tests hold:

* the rwkv plans (a single step and longer calls): every row of every
  column held by exactly one thread of one block, for D = 1..8192, and the
  step kernel's parts those of the chunk kernel;
* the port's plain ``rwkv6_scan`` at D = 4224 (B = H = 1, T = 3, from a
  state) against JAX's jnp reference and its Pallas kernel in interpret
  mode: 1e-5 of the largest value (``tests/test_torch_rwkv6.py``'s);
* the kernel's float32 arithmetic in its order, emulated on the CPU (each
  thread's four partial sums over its rows, the parts' sums added in
  order, the bonus c_t = sum_i (r_i u_i) k_i in its thread, warp-shuffle
  and warp order, o_j = fma(v_j, c_t, sum), the slabs added in order, the
  state update fma(w_i, S_ij, k_i v_j); fused multiply-adds computed in
  float64 and rounded once), against JAX's reference at D = 64, 256 and
  4224: ``chip_smoke.py`` phase 9's tolerance of the kernel against the
  plain version, 1e-5 x the largest value;
* the admm row-parallel plan: every row of x, G x, z and y owned by exactly
  one lane of the rack, for h = 1..24, by the rule the kernel's source
  states (its block size, ``rack_warps`` and ``xrow``/``grow``), and the forced shared-plan variant
  accepted at every horizon the kernel runs up to 57.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import admm_step, ref, rwkv6_scan as rw

torch.set_num_threads(1)

def _slab_rows(p) -> int:
    return p.parts * p.rows


@pytest.mark.parametrize("lo,hi", [(1, 1024), (1025, 4096), (4097, 8192)])
def test_rwkv_plan_holds_every_row_of_every_column_once(lo, hi):
    for d in range(lo, hi + 1):
        for steps in (1, 2) if d <= 256 else (2,):
            p = rw.lane_plan(d, steps)
            assert p.d == rw.kernel_head_dim(d) >= d and p.d % p.rows == 0
            # Every column in exactly one block of each slab: whole blocks of
            # adjacent columns.
            assert p.d % p.cols == 0 and p.cols % p.span == 0
            # Every row of a column with exactly one thread: slab z's part q
            # holds (or, in the step kernel, sums as one part) rows
            # z sr + q rows .. + rows, where it lies inside D.
            held = np.zeros(p.d, np.int32)
            sr = _slab_rows(p)
            for z in range(p.slabs):
                for q in range(p.parts):
                    start = z * sr + q * p.rows
                    if start < p.d:
                        held[start:start + p.rows] += 1
            assert (held == 1).all(), d
        if d <= 128:
            # The step kernel sums a column in the chunk kernel's parts, so a
            # single step rounds alike in either.
            one, more = rw.lane_plan(d, 1), rw.lane_plan(d, 2)
            assert (one.span, one.cols, one.chunk) == (1, one.d, 1)
            assert (one.rows, one.parts, one.slabs) == (more.rows, more.parts, more.slabs)
    if hi > 4096:
        assert rw.lane_plan(4224).slabs == 5 and rw.lane_plan(8192).slabs == 8


def _rwkv_inputs(b, h, t, d, seed):
    g = np.random.default_rng(seed)
    r, k, v = (g.standard_normal((b, h, t, d)).astype(np.float32) * 0.5 for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-g.standard_normal((b, h, t, d)))) * 0.5 + 0.45).astype(np.float32)
    u = (g.standard_normal((h, d)) * 0.3).astype(np.float32)
    s0 = (g.standard_normal((b, h, d, d)) * 0.5).astype(np.float32)
    return r, k, v, w, u, s0


def _assert_close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()), err_msg=what)


def test_plain_rwkv6_scan_past_4096_matches_jax():
    r, k, v, w, u, s0 = _rwkv_inputs(1, 1, 3, 4224, 4224)
    js = [jnp.asarray(x) for x in (r, k, v, w, u, s0)]
    po, ps = ref.rwkv6_scan(*(torch.from_numpy(x) for x in (r, k, v, w, u, s0)))
    for name, (jo, jst) in (("jnp reference", jref.rwkv6_scan(*js)),
                            ("Pallas interpret", jops.rwkv6_scan(*js, force="pallas"))):
        _assert_close(po.numpy(), jo, f"o vs {name}")
        _assert_close(ps.numpy(), jst, f"S vs {name}")


def _fma(a, b, c):
    """float32 fused multiply-add: the exact product (float64 holds it) plus
    c, rounded once more to float32 (double rounding aside)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _xor_tree(x, offsets):
    """A warp's butterfly sum over the last axis (its lanes), as
    ``__shfl_xor_sync`` at each offset computes it; every lane ends with the
    same bits, lane 0's are returned."""
    idx = np.arange(x.shape[-1])
    for off in offsets:
        x = x + x[..., idx ^ off]
    return x[..., 0]


def emulate_kernel_scan(r, k, v, w, u, s0, plan):
    """The kernel's float32 arithmetic in its order (csrc/rwkv6_scan.cu),
    for operands already at the plan's head dim; columns vectorised."""
    b_, h_, t_, d = r.shape
    R, sr = plan.rows, _slab_rows(plan)
    nthr = plan.cols // plan.span * plan.parts
    o = np.zeros((b_, h_, t_, d), np.float32)
    S = s0.astype(np.float32).copy()
    for b in range(b_):
        for h in range(h_):
            st = S[b, h]
            for t in range(t_):
                rt, kt, vt, wt = (x[b, h, t] for x in (r, k, v, w))
                out = None
                for z in range(plan.slabs):
                    row0 = z * sr
                    srs = min(sr, d - row0)
                    # Each thread's rows: four partial sums (row i into i mod
                    # 4), combined (a0 + a1) + (a2 + a3); the block's parts
                    # added in order.
                    total = None
                    for q in range(srs // R):
                        acc = np.zeros((4, d), np.float32)
                        for i in range(row0 + q * R, row0 + (q + 1) * R):
                            acc[i % 4] = _fma(rt[i], st[i], acc[i % 4])
                        part = (acc[0] + acc[1]) + (acc[2] + acc[3])
                        total = part if total is None else total + part
                    # The bonus over the slab's rows, summed where the rows
                    # are staged: thread q's four rows 4q .. 4q + 3 in order
                    # (where a step's vectors do not divide the block, a
                    # thread's vectors q = tid + m nthr in order), a
                    # butterfly over a step's lanes of a warp, the warps in
                    # order.
                    ru = (rt[row0:row0 + srs] * u[h, row0:row0 + srs]).astype(np.float32)
                    nq = srs // 4
                    terms = np.zeros(4 * nthr * -(-nq // nthr), np.float32)
                    terms[:srs] = ru
                    kterms = np.zeros_like(terms)
                    kterms[:srs] = kt[row0:row0 + srs]
                    if nthr % nq == 0 and nq & (nq - 1) == 0:  # a step's nq threads, vector q
                        vecs = np.arange(nq)[:, None]
                        bfly = min(nq, 32)
                    else:  # the block's threads, vectors tid + m nthr
                        vecs = np.arange(nthr)[:, None] + nthr * np.arange(len(terms) // 4 // nthr)
                        bfly = 32
                    part = np.zeros(vecs.shape[0], np.float32)
                    for m in range(vecs.shape[1]):
                        for e in range(4):
                            i = 4 * vecs[:, m] + e
                            part = _fma(terms[i], kterms[i], part)
                    offsets = [1 << b_ for b_ in range(bfly.bit_length() - 2, -1, -1)]
                    warps = _xor_tree(part.reshape(-1, bfly), offsets)
                    c = warps[0]
                    for x in warps[1:]:
                        c = np.float32(c + x)
                    slab = _fma(vt, c, total)
                    out = slab if out is None else out + slab
                o[b, h, t] = out
                st = _fma(wt[:, None], st, (kt[:, None] * vt[None, :]).astype(np.float32))
            S[b, h] = st
    return o, S


@pytest.mark.parametrize("b,h,t,d", [(2, 2, 24, 64), (1, 2, 12, 256), (1, 1, 3, 4224)])
def test_kernel_arithmetic_emulated_matches_jax(b, h, t, d):
    r, k, v, w, u, s0 = _rwkv_inputs(b, h, t, d, d + 1)
    plan = rw.lane_plan(d, t)
    assert plan.d == d
    o, s = emulate_kernel_scan(r, k, v, w, u, s0, plan)
    jo, jst = jref.rwkv6_scan(*(jnp.asarray(x) for x in (r, k, v, w, u, s0)))
    _assert_close(o, jo, "o")
    _assert_close(s, jst, "S")


ADMM_CU = Path(admm_step.__file__).resolve().parents[1] / "csrc" / "admm_step.cu"


def _admm_rows_rule():
    """The row-parallel kernel's own split, read from its source: the block
    size, the warps a rack (``rack_warps<H>``) and which lane owns the x-rows
    and the G-rows (``xrow``/``grow`` in ``admm_rows_kernel``), as Python
    functions of (h, lane)."""
    src = ADMM_CU.read_text()
    threads = int(re.search(r"constexpr int kRowThreads = (\d+);", src).group(1))
    warps = re.search(r"constexpr int rack_warps\(\) \{\s*return (.+?);", src).group(1)
    own = re.search(r"const bool xrow = (.+?), grow = (.+?);", src)
    c_to_py = lambda e: e.replace("/", "//")
    warps_of = lambda h: eval(c_to_py(warps), {"H": h})
    xrow = lambda h, i: eval(c_to_py(own.group(1)), {"i": i, "N2": 2 * h, "H": h})
    grow = lambda h, i: eval(c_to_py(own.group(2)), {"i": i, "N2": 2 * h, "H": h})
    return threads, warps_of, xrow, grow


def test_admm_row_plan_owns_every_row_once():
    threads, warps_of, xrow, grow = _admm_rows_rule()
    assert threads == admm_step.ROW_THREADS
    for h in range(1, 25):
        p = admm_step.row_plan(h)
        assert p.warps == warps_of(h) and p.racks == threads // (32 * p.warps)
        assert 32 * p.warps >= 2 * h > 32 * (p.warps - 1)  # a lane per x-row, no idle warp
        lanes = range(32 * p.warps)
        # Lane i computes x-row i where xrow holds and G-row i where grow
        # does; it updates z/y row i with its x-row and z/y row 2h + i with
        # its G-row (the ax of z-row 2h + i is G-row i of x).
        x_rows = sorted(i for i in lanes if xrow(h, i))
        g_rows = sorted(i for i in lanes if grow(h, i))
        zy_rows = sorted(x_rows + [2 * h + i for i in g_rows])
        assert x_rows == list(range(2 * h)), h
        assert g_rows == list(range(h)), h
        assert zy_rows == list(range(3 * h)), h
    assert admm_step.row_plan(12) == (1, 4) and admm_step.row_plan(24) == (2, 2)


def test_admm_shared_plan_variant_forced_up_to_57():
    runs = [12, 24] + list(range(25, 58))  # every horizon the kernel runs up to 57
    for h in runs:
        assert admm_step.resolve_variant(h, "shared plan") == "shared plan"
    assert [admm_step.resolve_variant(h) for h in (12, 24, 25, 57)] == \
        ["registers", "registers", "shared plan", "shared plan"]
    with pytest.raises(ValueError, match="does not serve"):
        admm_step.resolve_variant(58, "shared plan")
    with pytest.raises(ValueError, match="does not serve"):
        admm_step.resolve_variant(12, "global plan")
    with pytest.raises(ValueError, match="pads it"):
        admm_step.resolve_variant(6, "shared plan")
