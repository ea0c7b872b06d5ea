"""The flash kernel at DeepSeek MLA's head dims, on the card (``-m cuda``;
each test skips without a CUDA device).  No JAX here: the kernel is held to
the port's plain version.  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa, ref as tref


@pytest.mark.cuda
@pytest.mark.parametrize("t", [512, 300])
def test_flash_kernel_at_mla_head_dims_matches_plain(t):
    """The kernel at q/k 192 and v 128 (v zero-padded to 192 in the wrapper;
    T = 512 and a ragged 300) against the plain version on the same inputs
    widened to float32: one bf16 ulp of the element on o, 1e-5 on lse (as
    ``chip_smoke.py`` phases 5 and 17a hold it)."""
    if not torch.cuda.is_available():
        pytest.skip("the flash kernel runs only on a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    mk = lambda d: torch.from_numpy(rng.standard_normal((2, 4, t, d)).astype(np.float32)).to(
        device=dev, dtype=torch.bfloat16)
    q, k, v = mk(192), mk(192), mk(128)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True, scale=192**-0.5)
    o_w, lse_w = tref.attention(q.float(), k.float(), v.float(), causal=True, scale=192**-0.5,
                                with_lse=True)
    assert o.shape == (2, 4, t, 128)
    assert bool(((o.double() - o_w.double()).abs() <= 2.0**-7 * o_w.double().abs() + 1e-6).all())
    assert float((lse - lse_w).abs().max()) <= 1e-5
