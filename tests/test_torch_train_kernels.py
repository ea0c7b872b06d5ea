"""Parity of the training kernels' plain versions with the JAX package.

The flash-attention backward: the same seeded numpy inputs go through the
JAX package's differentiable ``ops.attention`` with ``force="pallas"``
(the fused dK/dV and dQ Pallas kernels in interpret mode, 128-tiles), its
dense log-sum-exp oracle (``algorithm="reference"``) and ``jax.grad``
through ``ref.attention``, and through the port on the CPU: the plain
backward (``ref.flash_attention_bwd``, what the CUDA kernels are held to
on the card) and autograd through ``ops.attention``.  The loss and the
shapes are ``tests/test_kernels.py::test_flash_attention_backward``'s:
GQA, a decode offset, causal and non-causal.  Tolerances, the JAX
package's own for the same comparison: the plain backward against the
Pallas kernels 1e-4 relative and 2e-5 absolute (same math, the kernels
accumulate over tiles), against the oracle and autodiff 1e-4 relative and
5e-5 absolute.

rmsnorm: the port's gradients against ``jax.grad`` of the JAX reference
(float32 1e-5 of the gradient's scale, sums in another order; bf16 2^-7 of
the scale, one bf16 ulp of the largest element, as the two round the
float32 gradient once each).  The kernel paths' autograd wiring is tested
with the launches replaced by plain computations run under ``no_grad``
(which is what a ctypes launch is to autograd): the rmsnorm gradients must
equal autograd of the plain version exactly, and the flash ``Function``
must deliver the plain backward's gradients through its head-dim padding,
GQA and stride handling.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import flash_attention as fa, ops as tops, ref as tref, rmsnorm as rn

torch.set_num_threads(1)


def _attn_loss_jax(fn):
    return lambda q, k, v: jnp.sum(jnp.sin(fn(q, k, v)))


def _inputs(b, h, hkv, tq, tk, d, seed=9):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, tq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, tk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, tk, d)).astype(np.float32))


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize(
    "b,h,hkv,tq,tk,d",
    [(1, 2, 2, 256, 256, 64), (1, 4, 2, 128, 128, 64), (1, 2, 2, 128, 512, 64)],
)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_matches_jax(b, h, hkv, tq, tk, d, causal):
    qn, kn, vn = _inputs(b, h, hkv, tq, tk, d)
    jq, jk, jv = map(jnp.asarray, (qn, kn, vn))

    def jattn(algorithm):
        return lambda *a: jops.attention(*a, causal=causal, force="pallas", block_q=128,
                                         block_k=128, algorithm=algorithm)

    g_kernel = jax.grad(_attn_loss_jax(jattn("auto")), argnums=(0, 1, 2))(jq, jk, jv)
    g_oracle = jax.grad(_attn_loss_jax(jattn("reference")), argnums=(0, 1, 2))(jq, jk, jv)
    g_ref = jax.grad(_attn_loss_jax(lambda *a: jref.attention(*a, causal=causal)),
                     argnums=(0, 1, 2))(jq, jk, jv)

    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    # The plain backward on the forward's own residuals (o, lse) and the
    # loss's cotangent cos(o).
    with torch.no_grad():
        o, lse = tref.attention(q, k, v, causal=causal, with_lse=True)
        plain = tref.flash_attention_bwd(q, k, v, o, lse, torch.cos(o), causal=causal)
    auto = torch.autograd.grad(torch.sum(torch.sin(tops.attention(q, k, v, causal=causal))),
                               (q, k, v))
    for nm, p, a, gk, go, gr in zip("qkv", plain, auto, g_kernel, g_oracle, g_ref):
        _close(p, gk, 1e-4, 2e-5, f"d{nm}: plain backward vs the Pallas kernels")
        _close(p, go, 1e-4, 5e-5, f"d{nm}: plain backward vs the lse oracle")
        _close(a, gr, 1e-4, 5e-5, f"d{nm}: autograd vs jax.grad through ref.attention")


def test_flash_backward_is_the_vjp_of_plain_attention():
    """The plain backward equals autograd through the plain forward (GQA,
    decode offset, a ragged length and an odd head dim), and a given
    ``delta`` stands in for ``sum(do * o)``."""
    qn, kn, vn = _inputs(2, 6, 2, 45, 70, 30, seed=3)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    do = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 6, 45, 30)).astype(np.float32))
    o, lse = tref.attention(q, k, v, causal=True, with_lse=True)
    want = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        got = tref.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        got_delta = tref.flash_attention_bwd(q, k, v, None, lse, do, causal=True,
                                             delta=torch.sum(do * o, dim=-1))
    for g, gd, w in zip(got, got_delta, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=2e-6)
        torch.testing.assert_close(gd, g, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_gradients_match_jax(shape, dtype):
    rng = np.random.default_rng(5)
    jd, td = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx = jnp.asarray(rng.standard_normal(shape), jd)
    jw = jnp.asarray(1.0 + 0.1 * rng.standard_normal(shape[-1]), jd)
    c = rng.standard_normal(shape).astype(np.float32)
    loss = lambda x, w: jnp.sum(jref.rmsnorm(x, w, 1e-5).astype(jnp.float32) * c)
    gjx, gjw = jax.grad(loss, argnums=(0, 1))(jx, jw)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(td).requires_grad_()
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(td).requires_grad_()
    gx, gw = torch.autograd.grad(
        torch.sum(tops.rmsnorm(tx, tw, 1e-5).float() * torch.from_numpy(c)), (tx, tw))
    assert gx.dtype == td and gw.dtype == td
    rel = 2.0**-7 if dtype == "bfloat16" else 1e-5
    for got, want in ((gx, gjx), (gw, gjw)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=rel * float(np.max(np.abs(want))))


def _no_grad_launch(fn):
    """``fn`` as a ctypes launch looks to autograd: its output has no
    ``grad_fn``, whatever its inputs require."""
    def launch(*args, **kw):
        with torch.no_grad():
            return fn(*args, **kw)
    return launch


def test_rmsnorm_kernel_path_records_gradients(monkeypatch):
    """On the card ``ops.rmsnorm`` goes through the kernel; its output must
    carry the plain version's gradients for ``x`` and the weight."""
    monkeypatch.setattr(rn, "rmsnorm", _no_grad_launch(tref.rmsnorm))
    monkeypatch.setattr(tops, "_use_kernel", lambda t, force: True)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(64)).astype(np.float32)).requires_grad_()
    c = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32))
    y = tops.rmsnorm(x, w, 1e-5)
    assert y.grad_fn is not None
    got = torch.autograd.grad(torch.sum(y * c), (x, w))
    want = torch.autograd.grad(torch.sum(tref.rmsnorm(x, w, 1e-5) * c), (x, w))
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    # Without a graph to record, the kernel runs on its own.
    with torch.no_grad():
        assert tops.rmsnorm(x, w, 1e-5).grad_fn is None


def test_flash_function_delivers_the_plain_backward(monkeypatch):
    """``ops.attention`` on the kernel path: the ``FlashAttention`` Function
    saves the forward's residuals and its backward pads the head dim (30 to
    32, the scale kept from 30), normalises the strides of an expanded
    cotangent and launches dK/dV and dQ once each (here plain stand-ins
    that check what a launch receives)."""
    seen = []

    def fwd(q, k, v, *, causal, scale):
        return tref.attention(q, k, v, causal=causal, scale=scale, with_lse=True)

    def launch(which):
        def run(q, k, v, do, lse, delta, *, causal, scale):
            assert all(t.stride(-1) == 1 for t in (q, k, v, do))
            assert q.shape[-1] in fa.HEAD_DIMS and delta.shape == lse.shape
            seen.append((which, q.shape[-1], scale))
            dq, dk, dv = tref.flash_attention_bwd(q, k, v, None, lse, do, causal=causal,
                                                  scale=scale, delta=delta)
            return (dk, dv) if which == "dkv" else dq
        return _no_grad_launch(run)

    monkeypatch.setattr(fa, "flash_attention_fwd", _no_grad_launch(fwd))
    monkeypatch.setattr(fa, "flash_bwd_dkv", launch("dkv"))
    monkeypatch.setattr(fa, "flash_bwd_dq", launch("dq"))
    monkeypatch.setattr(tops, "_use_kernel", lambda t, force: True)
    qn, kn, vn = _inputs(2, 4, 2, 50, 50, 30, seed=12)
    for loss in (torch.sum, lambda o: torch.sum(torch.sin(o))):
        seen.clear()
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
        got = torch.autograd.grad(loss(tops.attention(q, k, v, causal=True)), (q, k, v))
        want = torch.autograd.grad(loss(tref.attention(q, k, v, causal=True)), (q, k, v))
        assert seen == [("dkv", 32, pytest.approx(30**-0.5)), ("dq", 32, pytest.approx(30**-0.5))]
        for g, w in zip(got, want):
            assert g.shape == w.shape
            torch.testing.assert_close(g, w, rtol=1e-5, atol=2e-6)


def test_backward_kernels_refuse_cpu_tensors():
    q, k = torch.randn(1, 2, 8, 32), torch.randn(1, 1, 8, 32)
    o, lse = tref.attention(q, k, k, with_lse=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd(q, k, k, o, lse, o)
    with pytest.raises(ValueError, match="Tq <= Tk"):
        fa.flash_attention_bwd(q, k[:, :, :4], k[:, :, :4], o, lse, o, causal=True)
    assert fa.flash_bwd_dkv.launches == 0 and fa.flash_bwd_dq.launches == 0
