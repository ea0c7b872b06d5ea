"""Parity of the LM kernels' plain versions with the JAX package.

The same seeded numpy inputs go through ``repro.kernels.ops`` with
``force="pallas"`` (the Pallas kernels in interpret mode; the flash
forward with 128-tiles, or the reference's dense fallback where the tiles
do not divide the sequence) and through ``repro_torch.kernels.ops`` on the
CPU, which runs the plain PyTorch versions (``kernels/ref.py``) that the
CUDA kernels are held against on the card.  Tolerances and their reasons:

* float32: 2e-5 absolute and relative, the JAX package's own
  Pallas-vs-reference envelope (``tests/test_kernels.py``): the products
  and softmax sums run in another order, and the flash kernel accumulates
  across key tiles.
* bfloat16: 2e-2, the same file's bf16 envelope.  The plain attention
  rounds the logits and the probabilities to bf16 (as the reference's
  einsums do) where the Pallas kernel computes in float32, and outputs of
  size ~1 round at 2^-8.
* the log-sum-exp is float32 on both sides: 2e-5.

The dispatch: CPU tensors take the plain versions, the CUDA wrappers
refuse CPU tensors, and recording a graph through the CUDA attention goes
through its autograd Function to the (CUDA-only) kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa, ops as jops, ref as jref
from repro_torch.kernels import flash_attention, ops as tops, ref as tref, rmsnorm

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _pair(a: np.ndarray, name: str):
    """The same values as a JAX array and a torch tensor of type ``name``
    (rounded to bf16 once, by JAX, and carried across bit for bit)."""
    jd, td = DTYPES[name]
    j = jnp.asarray(a, jd)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)
    return j, t


def _close(got: torch.Tensor, want, name):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(name))


@pytest.mark.parametrize("shape", [(8, 128), (37, 256), (4, 7, 512), (1, 1024), (3, 2, 4, 32),
                                   # the main paths' widths: deepseek's kv_a_norm and
                                   # q_a_norm, rwkv6-7b, deepseek-v2's and v3's blocks
                                   (3, 512), (2, 1536), (2, 4096), (2, 5120), (2, 7168)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax(shape, dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal(shape), dtype)
    jw, tw = _pair(rng.standard_normal(shape[-1]), dtype)
    got = tops.rmsnorm(tx, tw, 1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, jops.rmsnorm(jx, jw, 1e-5, force="pallas"), dtype)
    _close(got, jref.rmsnorm(jx, jw, 1e-5), dtype)


def _qkv(b, h, hkv, tq, tk, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return (_pair(rng.standard_normal((b, h, tq, d)), dtype),
            _pair(rng.standard_normal((b, hkv, tk, d)), dtype),
            _pair(rng.standard_normal((b, hkv, tk, d)), dtype))


@pytest.mark.parametrize(
    "b,h,hkv,tq,tk,d",
    [(2, 4, 4, 256, 256, 64), (1, 8, 2, 256, 256, 128), (1, 4, 2, 128, 512, 64),
     (2, 2, 1, 128, 128, 32)],
)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_jax_flash(b, h, hkv, tq, tk, d, causal, dtype):
    (jq, tq_), (jk, tk_), (jv, tv) = _qkv(b, h, hkv, tq, tk, d, dtype, seed=7)
    got = tops.attention(tq_, tk_, tv, causal=causal)
    assert got.dtype == tq_.dtype and got.shape == tq_.shape
    want = jops.attention(jq, jk, jv, causal=causal, force="pallas", block_q=128, block_k=128)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_decode_offset(dtype):
    """Tq < Tk: the causal offset aligns to the END of the KV sequence."""
    (jq, tq_), (jk, tk_), (jv, tv) = _qkv(1, 2, 2, 128, 1024, 64, dtype, seed=8)
    want = jops.attention(jq, jk, jv, causal=True, force="pallas", block_q=128, block_k=128)
    _close(tops.attention(tq_, tk_, tv, causal=True), want, dtype)


@pytest.mark.parametrize("tq,tk,causal", [(100, 100, True), (300, 300, True), (45, 300, True),
                                          (300, 77, False)])
def test_attention_plain_ragged_matches_jax_dense_fallback(tq, tk, causal):
    """Sequences the reference's tiles do not divide: its ``ops.attention``
    falls back to the dense reference."""
    (jq, tq_), (jk, tk_), (jv, tv) = _qkv(1, 4, 2, tq, tk, 64, "float32", seed=10)
    want = jops.attention(jq, jk, jv, causal=causal, force="pallas")
    _close(tops.attention(tq_, tk_, tv, causal=causal), want, "float32")


@pytest.mark.parametrize("causal", [True, False])
def test_attention_plain_lse_matches_jax_flash_forward(causal):
    """The log-sum-exp the flash forward emits (the backward's residual)."""
    (jq, tq_), (jk, tk_), (jv, tv) = _qkv(1, 2, 2, 128, 256, 64, "float32", seed=11)
    o, lse = jfa._flash_fwd(jq[0], jk[0], jv[0], causal=causal, scale=0.125, block_q=128,
                            block_k=128, interpret=True)
    got_o, got_lse = tref.attention(tq_, tk_, tv, causal=causal, with_lse=True)
    assert got_lse.dtype == torch.float32 and got_lse.shape == (1, 2, 128)
    _close(got_o[0], o, "float32")
    _close(got_lse[0], lse, "float32")


def test_lm_dispatch_on_cpu_tensors(monkeypatch):
    x, w = torch.randn(4, 64), torch.ones(64)
    q, k = torch.randn(1, 2, 8, 32), torch.randn(1, 1, 8, 32)
    # Plain versions on CPU tensors, automatically and under "ref".
    for force in (None, "ref"):
        torch.testing.assert_close(tops.rmsnorm(x, w, force=force), tref.rmsnorm(x, w), rtol=0, atol=0)
        torch.testing.assert_close(tops.attention(q, k, k, force=force), tref.attention(q, k, k),
                                   rtol=0, atol=0)
    with tops.forced("ref"):
        assert tops.rmsnorm(x, w).shape == x.shape
    assert rmsnorm.rmsnorm.launches == 0 and flash_attention.flash_attention_fwd.launches == 0
    # The kernels refuse CPU tensors.
    with pytest.raises(ValueError, match="CUDA"):
        tops.rmsnorm(x, w, force="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        with tops.forced("cuda"):
            tops.attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rmsnorm.rmsnorm(x, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention.flash_attention_fwd(q, k, k)
    # On the kernel path, recording a graph goes through the autograd
    # Function to the (CUDA-only) kernel, and so does a call with no graph:
    # neither falls back to the plain version.
    monkeypatch.setattr(tops, "_use_kernel", lambda t, force: True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.attention(q.requires_grad_(), k, k)
    with torch.inference_mode(), pytest.raises(ValueError, match="CUDA tensors"):
        tops.attention(q.detach(), k, k)
