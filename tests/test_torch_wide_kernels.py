"""The kernel shapes widened to the reference's, and the tensor-core
kernels' arithmetic, on the CPU.

On the card the flash kernels take head dims up to 256 in one column
chunk (forward and backward), ``rwkv6_scan`` any head dim up to 256 (a
state column split over two threads at 256) and ``admm_step`` any horizon
up to 57 with the plan in shared memory (a run-time variant above 24);
``tests/test_torch_wider_kernels.py`` takes the shapes past those.  Without a card these tests hold the same seeded numpy
inputs through the JAX package (its Pallas kernels in interpret mode, and
its jnp references) and through the port's plain versions, on the operands
the port's kernel routes hand to their kernels (a head dim between the
instantiated ones zero-padded up):

* flash forward and backward at D = 256 and at D = 200 (padded to 256),
  causal and not, against JAX's Pallas kernels: 2e-5 float32 (the JAX
  package's own Pallas-vs-reference envelope), 1e-4 relative / 5e-5
  absolute on the gradients (``tests/test_torch_train_kernels.py``'s);
* ``rwkv6_scan`` at D = 256 and D = 200 from a state, against JAX's
  reference and Pallas kernel: 1e-5 of the largest value
  (``tests/test_torch_rwkv6.py``'s), and the padded state rows and
  columns exactly zero;
* ``admm_iterate`` at horizons 48 and 30, which the card runs unpadded,
  against JAX's reference and Pallas kernel within 2e-5 after 30
  iterations (the reference's envelope);
* the routing: ``kernel_head_dim``, ``kernel_horizon`` and where their
  variants change;
* the bf16 flash forward's split-P arithmetic, emulated on float64 (exact
  products of bf16 operands, float32 online softmax over 64-key tiles, P
  split into three bf16 parts): on phase 5's shapes at smoke size it stays
  within ``chip_smoke.py``'s check of the bf16 kernel against the float32
  plain version, one bf16 ulp (2^-7 of the element) plus 1e-6, and 1e-5
  on the log-sum-exp.  It prints where P in two bf16 parts, and in one,
  lands against that check (two exceed it at D = 256; one by ~100x);
* ``gemm_burn``'s zero-padding of K and N (the bf16 kernel's tensor maps
  need rows of a multiple of 16 bytes) through the plain version: the
  padded product's first N columns equal the unpadded product bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import admm_step, flash_attention as fa, gemm_burn as gb, ref
from repro_torch.kernels import rwkv6_scan as rw

from test_torch_kernel_shapes import _admm_problem

torch.set_num_threads(1)


def _np_f32(x):
    return np.asarray(x, np.float32)


def _pad_last(t: torch.Tensor, dp: int) -> torch.Tensor:
    return F.pad(t, (0, dp - t.shape[-1]))


# ------------------------------------------------------------- routing


def test_routing_reaches_the_reference_shapes():
    assert fa.kernel_head_dim(256) == 256 and fa.kernel_head_dim(193) == 256
    assert fa.kernel_head_dim(200) == 256 and fa.HEAD_DIMS[-1] == 256
    assert rw.kernel_head_dim(256) == 256 and rw.kernel_head_dim(129) == 256
    assert rw.kernel_head_dim(200) == 256
    # Past the instantiated widths: flash in column chunks of at most 256,
    # rwkv in threads of 128 rows (slabs of at most 8 threads a column above
    # 1024, summed by a second pass, past 4096 too).
    assert fa.kernel_head_dim(257) == 320 and fa.column_chunks(257) == (2, 160)
    assert rw.kernel_head_dim(257) == 384 and rw.kernel_head_dim(4096) == 4096
    assert rw.kernel_head_dim(4097) == 4224 and rw.kernel_head_dim(8192) == 8192
    assert rw.lane_plan(4224)[-2:] == (5, 1) and rw.lane_plan(8192)[-2:] == (8, 1)
    assert [admm_step.kernel_horizon(h) for h in (6, 12, 13, 24, 25, 30, 48, 57, 58, 128)] == \
        [12, 12, 24, 24, 25, 30, 48, 57, 58, 128]
    # The shared-plan variant's 48 h^2 + 1280 h bytes fit a block's 232,448
    # up to SHARED_PLAN_MAX; above it the plan is read from global memory.
    fits = lambda h: 48 * h * h + 1280 * h <= 232_448
    assert fits(admm_step.SHARED_PLAN_MAX) and not fits(admm_step.SHARED_PLAN_MAX + 1)
    assert admm_step.kernel_variant(admm_step.SHARED_PLAN_MAX + 1) == "global plan"


# ------------------------------------------------------- flash attention


def _qkv(b, h, hkv, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))


FLASH_CASES = [(1, 2, 1, 128, 128, 256, True), (1, 2, 2, 128, 256, 256, False),
               (1, 2, 1, 128, 128, 200, True), (1, 2, 2, 128, 256, 200, False)]


@pytest.mark.parametrize("b,h,hkv,tq,tk,d,causal", FLASH_CASES)
def test_flash_forward_at_wide_head_dims_matches_jax(b, h, hkv, tq, tk, d, causal):
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
def test_flash_backward_at_wide_head_dims_matches_jax(b, h, hkv, tq, tk, d, causal):
    qn, kn, vn = _qkv(b, h, hkv, tq, tk, d, seed=d + causal + 10)

    def loss(q, k, v):
        o = jops.attention(q, k, v, causal=causal, force="pallas", block_q=128, block_k=128)
        return jnp.sum(jnp.sin(o))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (qn, kn, vn)))
    dk = fa.kernel_head_dim(d)
    q, k, v = (_pad_last(torch.from_numpy(a), dk) for a in (qn, kn, vn))
    with torch.no_grad():
        o, lse = ref.attention(q, k, v, causal=causal, scale=d**-0.5, with_lse=True)
        # The cotangent cos(o) of the real columns, zero-padded as the
        # kernel route pads dO.
        do = _pad_last(torch.cos(o[..., :d]), dk)
        grads = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=d**-0.5)
    for nm, g, w in zip("qkv", grads, want):
        assert torch.count_nonzero(g[..., d:]) == 0, f"d{nm}: padded columns"
        np.testing.assert_allclose(g[..., :d].numpy(), _np_f32(w), rtol=1e-4, atol=5e-5,
                                   err_msg=f"d{nm}")


# ---------------------------------------------------------------- rwkv6


@pytest.mark.parametrize("d", [256, 200])
def test_rwkv6_scan_at_wide_head_dims_matches_jax(d):
    b, h, t = 1, 2, 24
    g = np.random.default_rng(d)
    r, k, v = (g.standard_normal((b, h, t, d)).astype(np.float32) * 0.5 for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-g.standard_normal((b, h, t, d)))) * 0.5 + 0.45).astype(np.float32)
    u = (g.standard_normal((h, d)) * 0.3).astype(np.float32)
    s0 = (g.standard_normal((b, h, d, d)) * 0.5).astype(np.float32)
    js = [jnp.asarray(x) for x in (r, k, v, w, u, s0)]
    want = [jref.rwkv6_scan(*js), jops.rwkv6_scan(*js, force="pallas", block_t=8)]
    dk = rw.kernel_head_dim(d)
    ts = [_pad_last(torch.from_numpy(x), dk) for x in (r, k, v, w, u)]
    po, ps = ref.rwkv6_scan(*ts, F.pad(torch.from_numpy(s0), (0, dk - d, 0, dk - d)))
    assert torch.count_nonzero(po[..., d:]) == 0
    assert torch.count_nonzero(ps[..., d:, :]) == 0 and torch.count_nonzero(ps[..., :, d:]) == 0
    for jo, jst in want:
        for got, ref_ in ((po[..., :d], jo), (ps[..., :d, :d], jst)):
            ref_ = _np_f32(ref_)
            np.testing.assert_allclose(got.numpy(), ref_, rtol=0,
                                       atol=1e-5 * float(np.abs(ref_).max()))


# ----------------------------------------------------------------- admm


@pytest.mark.parametrize("horizon", [48, 30])
def test_admm_at_wide_horizons_matches_jax(horizon):
    args, rho = _admm_problem(horizon, 40, horizon)
    assert admm_step.kernel_horizon(horizon) == horizon  # run unpadded on the card
    got = ref.admm_iterate(*args, rho=rho, iters=30)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    for want in (jref.admm_iterate(*jargs, rho=rho, iters=30),
                 jops.admm_iterate(*jargs, rho=rho, iters=30, force="pallas")):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), _np_f32(b), rtol=0, atol=2e-5)


# ----------------------------------------------- the split-P arithmetic


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).double()


def split_p_attention(q, k, v, *, causal, parts=3):
    """The bf16 tensor-core forward's arithmetic on float64: s from exact
    products of the bf16 operands rounded once to float32, the scale and the
    mask in float32, the online softmax over 64-key tiles in float32 (m, l,
    p), and acc += p0 v + p1 v + p2 v from exact products, with p split
    into ``parts`` bf16 parts (p0 = bf16(p), p1 = bf16(p - p0), ...); o =
    acc / max(l, 1e-30) rounded to bf16, lse = m + log l."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rep = h // hkv
    qd, kd, vd = (t.double() for t in (q, k.repeat_interleave(rep, 1),
                                        v.repeat_interleave(rep, 1)))
    scale = torch.tensor(d**-0.5, dtype=torch.float32)
    s_all = ((qd @ kd.transpose(-1, -2)).float() * scale)
    if causal:
        rows = torch.arange(tq)[:, None] + tk - tq
        s_all = torch.where(torch.arange(tk)[None, :] > rows, torch.tensor(-1e30), s_all)
    m = torch.full((b, h, tq, 1), -1e30)
    l = torch.zeros((b, h, tq, 1))
    acc = torch.zeros((b, h, tq, d), dtype=torch.float64)
    for k0 in range(0, tk, 64):
        s = s_all[..., k0:k0 + 64]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        pe, rest = torch.zeros_like(p, dtype=torch.float64), p
        for _ in range(parts):
            part = rest.to(torch.bfloat16).float()
            pe, rest = pe + part.double(), rest - part
        acc = acc * corr.double() + pe @ vd[..., k0:k0 + 64, :]
    lc = torch.clamp(l, min=1e-30)
    o = (acc / lc.double()).float().to(torch.bfloat16)
    return o, (m + torch.log(lc))[..., 0]


# chip_smoke.py phase 5's flash cases at smoke size: (b, h, hkv, tq, tk, d, causal).
PHASE5_SMOKE = [(1, 8, 2, 256, 256, 64, True), (1, 8, 2, 64, 320, 64, True),
                (1, 8, 2, 100, 100, 64, True), (1, 8, 2, 128, 128, 64, False),
                (1, 4, 4, 77, 77, 32, True), (1, 4, 1, 128, 128, 160, True),
                (1, 4, 1, 100, 100, 192, True), (1, 4, 1, 100, 100, 256, True)]


@pytest.mark.parametrize("b,h,hkv,tq,tk,d,causal", PHASE5_SMOKE)
def test_split_p_stays_within_one_bf16_ulp_of_float32(b, h, hkv, tq, tk, d, causal):
    rng = np.random.default_rng(tq + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
               for s in ((b, h, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
    o_w, lse_w = ref.attention(q.float(), k.float(), v.float(), causal=causal, with_lse=True)
    o_w = o_w.double()
    bound = 2.0**-7 * o_w.abs() + 1e-6
    ratio = {}
    for parts in (3, 2, 1):
        o, lse = split_p_attention(q, k, v, causal=causal, parts=parts)
        ratio[parts] = float(((o.double() - o_w).abs() / bound).max())
        assert float((lse - lse_w).abs().max()) <= 1e-5
    print(f"max |o - o_float32| / (2^-7 |o| + 1e-6): P in three bf16 parts {ratio[3]:.3f}, "
          f"two {ratio[2]:.3f}, one {ratio[1]:.3f}")
    assert ratio[3] <= 1.0


# -------------------------------------------------------------- gemm_burn


@pytest.mark.parametrize("m,k,n", [(5, 13, 11), (33, 70, 130), (64, 64, 64), (17, 1, 3)])
@pytest.mark.parametrize("n_iters", [1, 3])
def test_gemm_burn_padding_is_exact(m, k, n, n_iters):
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(torch.bfloat16)
    pa, pb = gb.pad_operands(a, b)
    assert pa.shape[1] % 8 == 0 and pb.shape[1] % 8 == 0 and pa.shape[1] == pb.shape[0]
    assert torch.count_nonzero(pa[:, k:]) == 0 and torch.count_nonzero(pb[k:]) == 0
    assert torch.count_nonzero(pb[:, n:]) == 0
    want = ref.gemm_burn(a, b, n_iters)
    got = ref.gemm_burn(pa, pb, n_iters)[:, :n]
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,n,k", [(512, 512, 512), (512, 512, 520), (512, 512, 4096),
                                   (100, 100, 65), (32, 64, 1), (4096, 4096, 4096)])
@pytest.mark.parametrize("sms", [132, 114])
def test_f32_split_k_covers_k(m, n, k, sms):
    """The float32 kernel's split-K plan passes the launcher's checks: its
    ranges, multiples of 32 in length, cover K and none is empty; K is
    split only where the output tiles leave multiprocessors idle."""
    splits, k_split = gb.f32_split_k(m, n, k, sms)
    tiles = -(-m // 32) * -(-n // 64)
    assert 1 <= splits <= 8
    if splits == 1:
        assert k_split == k
        return
    assert tiles < sms and k_split % 32 == 0
    assert (splits - 1) * k_split < k <= splits * k_split
    if k <= 8 * 64:
        assert k_split <= 64  # two k-tiles, resident for every round
    if (m, n, k) == (512, 512, 512):
        assert (splits, k_split) == (8, 64)
