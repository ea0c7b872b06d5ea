"""Head dims and horizons past the last shared-memory and register limits,
and the tensor-core flash backward's arithmetic, on the CPU.

On the card the flash kernels take any head dim (above 256 in column
chunks of at most 256 on a grid axis, every block computing the scores
over the full head dim), ``rwkv6_scan`` any head dim (threads of 128 rows a
state column above 256, in slabs of 8 above 1024) and ``admm_step`` any horizon (the plan read from
global memory above 57).  Without a card these tests hold the same seeded
numpy inputs through the JAX package (its Pallas kernels in interpret
mode, and its jnp references) and through the port's plain versions, on
the operands the port's kernel routes hand to their kernels:

* flash forward and backward at D = 320 and 512 (and 300, padded to
  320), causal and not, against JAX's Pallas kernels: 2e-5 on the
  forward, 1e-4 relative / 5e-5 absolute on the gradients
  (``tests/test_torch_wide_kernels.py``'s envelopes);
* ``rwkv6_scan`` at D = 384 and 512 from a state, against JAX's reference
  and Pallas kernel: 1e-5 of the largest value;
* ``admm_iterate`` at horizons 64 and 96 against JAX's reference and
  Pallas kernel within 2e-5 after 30 iterations;
* the routing: the column-chunk plan covers every column exactly once for
  D from 1 to 1024, the rwkv lane plan every row of every column for D up
  to 4096, and ``kernel_horizon`` / ``kernel_variant``;
* the bf16 tensor-core backward's arithmetic, emulated on float64 in the
  kernels' order (``split_bwd``: each 16-term MMA k-step an exact product
  of bf16 operands rounded once into a float32 accumulator, float32 p and
  dS, p^T and dS split into bf16 parts, the dK/dV walk in two warp sets
  summed at the end): on phase 7's shapes at smoke size it stays within
  ``chip_smoke.py``'s check of the bf16 kernels against the float32 plain
  backward, one bf16 ulp (2^-7 of the element) plus 1e-5 of the
  gradient's largest value.  It prints where two parts and one part land.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import admm_step, flash_attention as fa, ref
from repro_torch.kernels import rwkv6_scan as rw

from test_torch_kernel_shapes import _admm_problem

torch.set_num_threads(1)


def _np_f32(x):
    return np.asarray(x, np.float32)


def _pad_last(t: torch.Tensor, dp: int) -> torch.Tensor:
    return F.pad(t, (0, dp - t.shape[-1]))


# ------------------------------------------------------------- routing


def _launched_widths(source: str) -> set[int]:
    """The chunk widths a CUDA source's launcher dispatches to a kernel
    (its ``launch_w<W>`` instantiations)."""
    text = (Path(fa.__file__).parents[1] / "csrc" / source).read_text()
    return {int(w) for w in re.findall(r"return launch_w<(\d+)>\(", text)}


def test_column_chunk_plan_covers_every_column():
    # The widths the plan may pick are the ones both launchers instantiate.
    widths = _launched_widths("flash_attention.cu")
    assert widths == _launched_widths("flash_attention_bwd.cu") == set(fa.HEAD_DIMS)
    for d in range(1, 1025):
        n, w = fa.column_chunks(d)
        dk = fa.kernel_head_dim(d)
        # The launchers take D = n_chunks x W with W instantiated, at most
        # 256 columns a block.
        assert w in widths and w <= 256 and dk == n * w and dk % n == 0
        assert n * w >= d  # every real column in a chunk ...
        assert (n - 1) * w < d  # ... and no chunk of padding only
        assert n == -(-d // 256)  # as few chunks as widths of 256 allow
        # The narrowest instantiated width that covers d in n chunks.
        assert all(n * x < d for x in widths if x < w)
    assert [fa.column_chunks(d) for d in (320, 512, 300, 257, 1024)] == \
        [(2, 160), (2, 256), (2, 160), (2, 160), (4, 256)]
    with pytest.raises(ValueError, match="positive"):
        fa.column_chunks(0)


def test_rwkv_lane_plan_covers_every_row_up_to_4096():
    for d in range(1, 4097):
        p = rw.lane_plan(d)
        sr = p.parts * p.rows  # a slab's rows
        assert p.d == rw.kernel_head_dim(d) >= d
        assert p.d % p.rows == 0 and p.rows <= 128  # a thread's rows fit its registers
        assert 1 <= p.parts <= 8 and p.cols // p.span * p.parts <= 256  # blocks of <= 256
        assert p.d % p.cols == 0 and (p.slabs - 1) * sr < p.d <= p.slabs * sr
        if p.d > 256:
            assert p.d % 128 == 0 and p.rows == 128 and p.span == 1 and p.d - d < 128
            assert p.chunk == 1 and p.slabs == -(-p.d // p.rows // 8)
        else:
            assert p.rows == max(8, p.d // 8) and p.span == 2 and p.slabs == 1
            assert p.chunk == (16 if p.d <= 128 else 8)
    assert rw.lane_plan(512) == (512, 128, 1, 4, 64, 1, 1) == rw.lane_plan(400)
    assert rw.lane_plan(384) == (384, 128, 1, 3, 64, 1, 1)
    assert rw.lane_plan(4096) == (4096, 128, 1, 8, 32, 4, 1)
    assert rw.lane_plan(256) == (256, 32, 2, 8, 64, 1, 8)
    assert rw.lane_plan(64) == (64, 8, 2, 8, 64, 1, 16)
    # A single step up to 128 runs the step kernel: a thread a column, summed
    # in the chunk kernel's parts; at 256 the chunk kernel.
    assert rw.lane_plan(64, 1) == (64, 8, 1, 8, 64, 1, 1)
    assert rw.lane_plan(256, 1) == rw.lane_plan(256)
    # Past 4096 as below it: slabs of at most 8 threads of 128 rows.
    assert rw.lane_plan(4224) == (4224, 128, 1, 7, 32, 5, 1)
    assert rw.lane_plan(8192) == (8192, 128, 1, 8, 32, 8, 1)


def test_admm_horizon_routing_has_no_limit():
    got = [(h, admm_step.kernel_horizon(h), admm_step.kernel_variant(admm_step.kernel_horizon(h)))
           for h in (6, 24, 25, 57, 58, 128, 181, 182, 1000)]
    assert got == [(6, 12, "registers"), (24, 24, "registers"), (25, 25, "shared plan"),
                   (57, 57, "shared plan"), (58, 58, "global plan"), (128, 128, "global plan"),
                   (181, 181, "global plan"), (182, 182, "global plan and iterates"),
                   (1000, 1000, "global plan and iterates")]
    # The shared-plan kernel's 48 h^2 + 1280 h bytes fit a block's 232,448
    # up to 57; the global-plan kernel's shared iterates, 1280 h, up to 181.
    assert 48 * 57**2 + 1280 * 57 <= 232_448 < 48 * 58**2 + 1280 * 58
    assert 1280 * 181 <= 232_448 < 1280 * 182
    with pytest.raises(ValueError, match="positive"):
        admm_step.kernel_horizon(0)


# ------------------------------------------------------- flash attention


def _qkv(b, h, hkv, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))


FLASH_CASES = [(1, 2, 1, 128, 128, 320, True), (1, 2, 2, 128, 256, 320, False),
               (1, 2, 1, 128, 128, 512, True), (1, 2, 2, 128, 256, 512, False),
               (1, 2, 1, 128, 128, 300, True)]


@pytest.mark.parametrize("b,h,hkv,tq,tk,d,causal", FLASH_CASES)
def test_flash_forward_in_column_chunks_matches_jax(b, h, hkv, tq, tk, d, causal):
    qn, kn, vn = _qkv(b, h, hkv, tq, tk, d, seed=d + causal)
    want = jops.attention(*map(jnp.asarray, (qn, kn, vn)), causal=causal, force="pallas",
                          block_q=128, block_k=128)
    dk = fa.kernel_head_dim(d)
    q, k, v = (_pad_last(torch.from_numpy(a), dk) for a in (qn, kn, vn))
    o, lse = ref.attention(q, k, v, causal=causal, scale=d**-0.5, with_lse=True)
    assert torch.count_nonzero(o[..., d:]) == 0
    np.testing.assert_allclose(o[..., :d].numpy(), _np_f32(want), rtol=2e-5, atol=2e-5)
    _, lse_u = ref.attention(*map(torch.from_numpy, (qn, kn, vn)), causal=causal,
                             with_lse=True)
    np.testing.assert_allclose(lse.numpy(), lse_u.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,h,hkv,tq,tk,d,causal", FLASH_CASES)
def test_flash_backward_in_column_chunks_matches_jax(b, h, hkv, tq, tk, d, causal):
    qn, kn, vn = _qkv(b, h, hkv, tq, tk, d, seed=d + causal + 10)

    def loss(q, k, v):
        o = jops.attention(q, k, v, causal=causal, force="pallas", block_q=128, block_k=128)
        return jnp.sum(jnp.sin(o))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (qn, kn, vn)))
    dk = fa.kernel_head_dim(d)
    q, k, v = (_pad_last(torch.from_numpy(a), dk) for a in (qn, kn, vn))
    with torch.no_grad():
        o, lse = ref.attention(q, k, v, causal=causal, scale=d**-0.5, with_lse=True)
        do = _pad_last(torch.cos(o[..., :d]), dk)
        grads = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=d**-0.5)
    for nm, g, w in zip("qkv", grads, want):
        assert torch.count_nonzero(g[..., d:]) == 0, f"d{nm}: padded columns"
        np.testing.assert_allclose(g[..., :d].numpy(), _np_f32(w), rtol=1e-4, atol=5e-5,
                                   err_msg=f"d{nm}")


# ---------------------------------------------------------------- rwkv6


@pytest.mark.parametrize("d", [384, 512])
def test_rwkv6_scan_above_256_matches_jax(d):
    b, h, t = 1, 2, 16
    g = np.random.default_rng(d)
    r, k, v = (g.standard_normal((b, h, t, d)).astype(np.float32) * 0.5 for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-g.standard_normal((b, h, t, d)))) * 0.5 + 0.45).astype(np.float32)
    u = (g.standard_normal((h, d)) * 0.3).astype(np.float32)
    s0 = (g.standard_normal((b, h, d, d)) * 0.5).astype(np.float32)
    js = [jnp.asarray(x) for x in (r, k, v, w, u, s0)]
    want = [jref.rwkv6_scan(*js), jops.rwkv6_scan(*js, force="pallas", block_t=8)]
    dk = rw.kernel_head_dim(d)
    assert dk == d  # a multiple of 128: D / 128 lanes a column, unpadded
    po, ps = ref.rwkv6_scan(*(torch.from_numpy(x) for x in (r, k, v, w, u, s0)))
    for jo, jst in want:
        for got, ref_ in ((po, jo), (ps, jst)):
            ref_ = _np_f32(ref_)
            np.testing.assert_allclose(got.numpy(), ref_, rtol=0,
                                       atol=1e-5 * float(np.abs(ref_).max()))


# ----------------------------------------------------------------- admm


@pytest.mark.parametrize("horizon", [64, 96])
def test_admm_above_57_matches_jax(horizon):
    args, rho = _admm_problem(horizon, 40, horizon)
    assert admm_step.kernel_horizon(horizon) == horizon  # unpadded, plan in global memory
    got = ref.admm_iterate(*args, rho=rho, iters=30)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    for want in (jref.admm_iterate(*jargs, rho=rho, iters=30),
                 jops.admm_iterate(*jargs, rho=rho, iters=30, force="pallas")):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), _np_f32(b), rtol=0, atol=2e-5)


# ------------------------------------- the tensor-core backward's arithmetic


def _parts(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """float32 ``x`` as ``parts`` bf16 parts (x0 = bf16(x), x1 = bf16(x -
    x0), ..., each difference exact in float32), in float64."""
    out, rest = [], x
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        out.append(part.double())
        rest = rest - part
    return out


def _mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One ``mma.sync`` k-step as modelled here: the exact product of bf16
    values ``a @ b`` (float64; 16 terms) added to the float32 accumulator
    and rounded once to float32."""
    return (acc.double() + a @ b).to(torch.float32)


def split_bwd(q, k, v, o, lse, do, *, causal, parts=3):
    """The bf16 tensor-core backward's arithmetic, step for step as the
    kernels order it, in float64 with explicit float32 roundings.  Each
    ``mma.sync`` k-step (16 terms) is modelled as an exact product of bf16
    operands added to the float32 accumulator and rounded once (the
    instruction's internal rounding is not modelled).
    * s = q k^T and dP = dO V^T: 16-column k-steps over the head dim in
      order; p = exp(s * scale - lse) and dS = p (dP - delta) in float32
      (delta = sum(dO o) in float32, as the wrapper computes it), p = 0
      above the causal diagonal.
    * dK/dV, per 64-key tile: the walk over (query head of the group,
      query tile of BQ = 64 rows, 32 at D > 64) pairs on or below the
      diagonal, set 0 taking pairs 0, 2, ... and set 1 pairs 1, 3, ...,
      each into float32 accumulators of its own: per 16-query k-step, p^T
      and dS^T split into ``parts`` bf16 parts, one k-step per part, in
      order; then set 0's sums plus set 1's, rounded once.
    * dQ: 64-key tiles in order, 16-key k-steps, ``parts`` parts each.
    * dK and dQ scaled in float32; every gradient rounded to bf16."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rep = h // hkv
    f32 = torch.float32
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))  # bf16 values, exact
    kx, vx = kd.repeat_interleave(rep, 1), vd.repeat_interleave(rep, 1)
    scale = torch.tensor(d**-0.5, dtype=f32)
    s = torch.zeros((b, h, tq, tk), dtype=f32)
    dp = torch.zeros_like(s)
    for c in range(0, d, 16):
        cols = slice(c, c + 16)
        s = _mma(s, qd[..., cols], kx[..., cols].transpose(-1, -2))
        dp = _mma(dp, dod[..., cols], vx[..., cols].transpose(-1, -2))
    off = tk - tq if causal else 0
    seen = torch.ones(tq, tk, dtype=torch.bool)
    if causal:
        seen = torch.arange(tk)[None, :] <= torch.arange(tq)[:, None] + off
    p = torch.where(seen, torch.exp(s * scale - lse[..., None]), torch.tensor(0.0))
    delta = torch.sum(do.to(f32) * o.to(f32), dim=-1)
    ds = p * (dp - delta[..., None])
    pe, dse = _parts(p, parts), _parts(ds, parts)

    bq = 64 if d <= 64 else 32
    dk_acc = torch.zeros((b, hkv, tk, d), dtype=f32)
    dv_acc = torch.zeros((b, hkv, tk, d), dtype=f32)
    for k0 in range(0, tk, 64):
        keys = slice(k0, k0 + 64)
        nk = min(tk, k0 + 64) - k0
        qt0 = (k0 - off) // bq if causal and k0 > off else 0
        per_head = -(-tq // bq) - qt0
        acc = [[torch.zeros((b, hkv, nk, d), dtype=f32) for _ in range(2)] for _ in range(2)]
        for it in range(rep * per_head):
            st = it % 2  # the warp set
            hs = slice(it // per_head, h, rep)  # query head hk * rep + g of every KV head hk
            q0 = (qt0 + it % per_head) * bq
            for c in range(q0, min(q0 + bq, tq), 16):
                rows = slice(c, min(c + 16, tq))
                for i in range(parts):
                    pt = pe[i][:, hs, rows, keys].transpose(-1, -2)
                    dst = dse[i][:, hs, rows, keys].transpose(-1, -2)
                    acc[st][0] = _mma(acc[st][0], pt, dod[:, hs, rows])
                    acc[st][1] = _mma(acc[st][1], dst, qd[:, hs, rows])
        dv_acc[:, :, keys] = acc[0][0] + acc[1][0]
        dk_acc[:, :, keys] = acc[0][1] + acc[1][1]
    dq_acc = torch.zeros((b, h, tq, d), dtype=f32)
    for c in range(0, tk, 16):  # 64-key tiles of four 16-key steps, in order
        keys = slice(c, c + 16)
        for i in range(parts):
            dq_acc = _mma(dq_acc, dse[i][..., keys], kx[:, :, keys])
    bf = torch.bfloat16
    return (dq_acc * scale).to(bf), (dk_acc * scale).to(bf), dv_acc.to(bf)


# chip_smoke.py phase 7's bf16 cases at smoke size: (b, h, hkv, tq, tk, d, causal).
PHASE7_SMOKE = [(1, 8, 2, 256, 256, 64, True), (1, 8, 2, 64, 320, 64, True),
                (1, 8, 2, 100, 100, 64, True), (1, 8, 2, 128, 128, 64, False),
                (1, 4, 4, 77, 77, 32, True), (1, 4, 1, 100, 100, 128, True),
                (1, 4, 1, 128, 128, 160, True)]


@pytest.mark.parametrize("b,h,hkv,tq,tk,d,causal", PHASE7_SMOKE)
def test_split_backward_stays_within_one_bf16_ulp_of_float32(b, h, hkv, tq, tk, d, causal):
    rng = np.random.default_rng(tq + d + 7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
                   for s in ((b, h, tq, d), (b, hkv, tk, d), (b, hkv, tk, d), (b, h, tq, d)))
    # The forward's residuals as the bf16 kernel leaves them: o in bf16,
    # lse in float32.
    o, lse = ref.attention(q.float(), k.float(), v.float(), causal=causal, with_lse=True)
    o = o.to(torch.bfloat16)
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(), o.float(), lse,
                                   do.float(), causal=causal)
    ratio = {}
    for parts in (3, 2, 1):
        got = split_bwd(q, k, v, o, lse, do, causal=causal, parts=parts)
        ratio[parts] = max(
            float(((g.double() - w.double()).abs()
                   / (2.0**-7 * w.double().abs() + 1e-5 * float(w.abs().max()))).max())
            for g, w in zip(got, want))
    print(f"max |grad - grad_float32| / (2^-7 |grad| + 1e-5 max|grad|) over dq, dk, dv: "
          f"p and dS in three bf16 parts {ratio[3]:.3f}, two {ratio[2]:.3f}, one {ratio[1]:.3f}")
    assert ratio[3] <= 1.0
