"""The port's int8 gradient compression with error feedback
(``repro_torch.optim.compression``) against the JAX package's
(``repro.optim.compression``), on the CPU.

The first three tests are the counterparts of the reference's own
(``tests/test_substrate.py``): the round trip's accuracy, the
error-feedback bound under Hypothesis (a fixed seed range, numpy's
normals in place of ``jax.random``'s) and AdamW on compressed gradients
solving the quadratic.  The parity tests run both packages eagerly, as the
reference's functions are written (not jitted), on seeded trees: float32
and bf16 leaves, an all-zero leaf (the 1e-12 floor of the scale), values
at exact .5 ties of ``g / scale`` (``round`` half to even in both) and
clipped values.  Every operation is correctly rounded in both (the
widening, the add, the max, the division, the round, the product and the
difference; eager XLA contracts nothing into a fused multiply-add), so
the int8 values, the scales and the error state agree bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.optim import compression as JC
from repro_torch.optim import (
    AdamWConfig, CompressionState, Quantized, adamw_init, adamw_update, compress_int8,
    decompress_int8, init_compression,
)


def test_int8_compression_roundtrip_accuracy():
    g = {"w": torch.tensor([0.5, -0.25, 1.0, 0.0])}
    state = init_compression(g)
    q, state = compress_int8(g, state)
    out = decompress_int8(q)
    assert isinstance(q, Quantized) and isinstance(state, CompressionState)
    assert q.values["w"].dtype == torch.int8 and q.scales["w"].dtype == torch.float32
    np.testing.assert_allclose(out["w"].numpy(), g["w"].numpy(), atol=1.0 / 127)


@settings(max_examples=20, deadline=None, derandomize=True)
@given(seed=st.integers(0, 1000))
def test_property_error_feedback_unbiased(seed):
    """With error feedback, the sum of decompressed grads tracks the sum of
    true grads (residual bounded by one quantization step)."""
    rng = np.random.default_rng(seed)
    state = init_compression({"w": torch.zeros(16)})
    total_true = torch.zeros(16)
    total_sent = torch.zeros(16)
    for _ in range(8):
        g = {"w": torch.from_numpy(rng.standard_normal(16).astype(np.float32))}
        total_true = total_true + g["w"]
        q, state = compress_int8(g, state)
        total_sent = total_sent + decompress_int8(q)["w"]
    resid = (total_true - total_sent).abs()
    assert float(resid.max()) < 0.2  # bounded residual, not accumulating
    assert float(resid.max()) <= float(q.scales["w"]) * (0.5 + 1e-5)


def test_compressed_training_converges():
    """AdamW on int8-compressed grads still solves the quadratic."""
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params, cfg)
    comp = init_compression(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(250):
        grads = {"w": 2 * (params["w"] - target)}
        q, comp = compress_int8(grads, comp)
        params, state, _ = adamw_update(decompress_int8(q), state, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=5e-2)


def _trees(dtype, seed):
    """A port tree and its JAX twin: a matrix, a vector of small values, an
    all-zero leaf, exact ties (the largest value 127, so the scale is 1
    and every x.5 a tie) and a leaf with one outlier (most values quantize
    to a few levels)."""
    rng = np.random.default_rng(seed)
    leaves = {
        "blocks.0.w": rng.standard_normal((33, 20)).astype(np.float32),
        "blocks.0.b": (rng.standard_normal(300) * 1e-3).astype(np.float32),
        "zero": np.zeros((4, 5), np.float32),
        "ties": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5],
                         np.float32),
        "outlier": np.concatenate([rng.standard_normal(99), [1e3]]).astype(np.float32),
    }
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    tg = {n: torch.from_numpy(a).to(dtype) for n, a in leaves.items()}
    jg = {n: jnp.asarray(t.float().numpy()).astype(jdt) for n, t in tg.items()}
    return tg, jg


def _bits(x) -> bytes:
    return np.ascontiguousarray(np.asarray(x)).tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_jax_bit_for_bit(dtype, seed):
    """Four rounds with the error fed back, each round's gradients the
    tree scaled by a factor (the first round the tree itself): the int8
    values, the float32 scales and the float32 error state bit for bit,
    and the decompressed gradients too."""
    tg, jg = _trees(dtype, seed)
    ts, js = init_compression(tg), JC.init_compression(jg)
    assert all(torch.equal(e, torch.zeros_like(e)) and e.dtype == torch.float32
               for e in ts.error.values())
    for i, f in enumerate((1.0, 0.75, -1.25, 0.5)):
        tgi = tg if i == 0 else {n: (x.float() * f).to(dtype) for n, x in tg.items()}
        jgi = {n: jnp.asarray(x.float().numpy()).astype(jg[n].dtype) for n, x in tgi.items()}
        tq, ts = compress_int8(tgi, ts)
        jq, js = JC.compress_int8(jgi, js)
        tout, jout = decompress_int8(tq), JC.decompress_int8(jq)
        for n in tg:
            assert tq.values[n].dtype == torch.int8 and tq.scales[n].shape == ()
            assert _bits(tq.values[n].numpy()) == _bits(jq.values[n]), (i, n)
            assert _bits(tq.scales[n].numpy()) == _bits(jq.scales[n]), (i, n)
            assert _bits(ts.error[n].numpy()) == _bits(js.error[n]), (i, n)
            assert _bits(tout[n].numpy()) == _bits(jout[n]), (i, n)


def test_floor_ties_and_clip():
    """The all-zero leaf takes the 1e-12 floor (scale 1e-12 / 127, values
    and error zero); an exact tie rounds half to even (0.5 -> 0, 1.5 -> 2,
    2.5 -> 2, 126.5 -> 126); the largest value maps to 127 and nothing past
    +-127."""
    tg, _ = _trees(torch.float32, 0)
    q, state = compress_int8(tg, init_compression(tg))
    assert float(q.scales["zero"]) == np.float32(np.float32(1e-12) / np.float32(127.0))
    assert not q.values["zero"].any() and not state.error["zero"].any()
    assert float(q.scales["ties"]) == 1.0
    assert q.values["ties"].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 4]
    assert int(q.values["outlier"].max()) == 127
    for v in q.values.values():
        assert int(v.abs().max()) <= 127
