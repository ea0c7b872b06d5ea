"""The widened kernel shapes of the port, on the CPU.

On the card the flash kernels take any head dim (column chunks above
256), the ``rwkv6_scan`` kernel any head dim (slabs of rows above 1024),
``rmsnorm`` any ``D`` and ``admm_step`` any horizon (unpadded above 24); a
shape between the instantiated ones is zero-padded up.  Here, without a
card, these tests hold what runs on the CPU:

* the routing decisions (``kernel_head_dim``, ``kernel_horizon``; rwkv
  past 4096 in slabs);
* the padding routes against the plain versions: ``admm_step``'s padded
  QP gives the real block's iterates bit for bit (every real sum only gains
  zero terms); the zero-padded RWKV-6 scan keeps its padded state rows and
  columns exactly zero and matches the unpadded scan within 1e-6 relative
  (the plain version's einsum may block the padded sum differently; the
  kernel's sequential sum gains only zero terms);
* the plain rmsnorm at D = 100 and D = 9000 against JAX's within 1e-6
  relative;
* a dense prefill at head dim 160 (``d_model`` 320, 2 heads, the stablelm
  layout) on the plain versions against JAX's, at
  ``tests/test_torch_models.py``'s logit tolerance (2e-5 absolute, 1e-5
  relative).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import smoke_config as jsmoke
from repro.core import controller as jctrl, ess as jess
from repro.kernels import ops as jops, ref as jref
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.core import controller as tctrl
from repro_torch.kernels import admm_step, flash_attention as fa, ref, rwkv6_scan as rw
from repro_torch.models import transformer as T

torch.set_num_threads(1)


def test_flash_head_dim_routing():
    for d, want in ((30, 32), (64, 64), (100, 128), (150, 160), (160, 160), (176, 192),
                    (192, 192)):
        assert fa.kernel_head_dim(d) == want
    # Above 256: whole column chunks of at most 256 (no refusal).
    assert [fa.kernel_head_dim(d) for d in (257, 320, 400, 512, 513)] == [320, 320, 512, 512, 576]
    fa._check_grid(4096, 64, 512, 512)  # B * H = 262144, past the old 65535
    with pytest.raises(ValueError):
        fa._check_grid(2**16, 2**15, 512, 512)
    with pytest.raises(ValueError):
        fa._check_grid(1, 1, 64 * 65535 + 1, 64)


def test_rwkv_head_dim_routing_and_padding():
    assert [rw.kernel_head_dim(d) for d in (16, 32, 48, 64, 100, 128)] == [32, 32, 64, 64, 128,
                                                                            128]
    # Above 256: a multiple of 128 (threads of 128 rows a column), past 4096
    # too, a column's rows in slabs of at most 8 such threads.
    assert [rw.kernel_head_dim(d) for d in (257, 400, 512, 4096)] == [384, 512, 512, 4096]
    assert [rw.kernel_head_dim(d) for d in (4097, 4224, 8192)] == [4224, 4224, 8192]
    assert [rw.lane_plan(d).slabs for d in (4096, 4224, 8192)] == [4, 5, 8]
    rng = np.random.default_rng(0)
    b, h, t, d, dp = 2, 3, 40, 48, 64
    r, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(np.float32))
               for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 0.99, (b, h, t, d)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((h, d)).astype(np.float32))
    s0 = torch.from_numpy(rng.standard_normal((b, h, d, d)).astype(np.float32))
    o, s = ref.rwkv6_scan(r, k, v, w, u, s0)
    po, ps = ref.rwkv6_scan(*(F.pad(x, (0, dp - d)) for x in (r, k, v, w, u)),
                            F.pad(s0, (0, dp - d, 0, dp - d)))
    assert torch.count_nonzero(ps[..., d:, :]) == 0 and torch.count_nonzero(ps[..., :, d:]) == 0
    assert torch.count_nonzero(po[..., d:]) == 0
    scale = float(o.abs().max())
    np.testing.assert_allclose(po[..., :d].numpy(), o.numpy(), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(ps[..., :d, :d].numpy(), s.numpy(), rtol=0,
                               atol=1e-6 * float(s.abs().max()))


@pytest.mark.parametrize("d", [100, 9000])
def test_rmsnorm_any_width_matches_jax(d):
    x = np.random.default_rng(d).standard_normal((3, d)).astype(np.float32)
    wt = (1.0 + 0.1 * np.random.default_rng(1).standard_normal(d)).astype(np.float32)
    want = np.asarray(jops.rmsnorm(jnp.asarray(x), jnp.asarray(wt), force="ref"))
    got = ref.rmsnorm(torch.from_numpy(x), torch.from_numpy(wt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _admm_problem(horizon, r, seed):
    """A rack batch of the controller QP at ``horizon`` from the JAX
    package's plan, carried across."""
    jcfg = jctrl.ControllerConfig.create(horizon=horizon)
    jep = jess.ESSParams.create(beta=0.0625, q_max_seconds=600.0)
    jplan = jctrl.make_plan(jcfg, jep)
    plan = convert.plan_from_numpy(convert.numpy_tree(jplan), device="cpu")
    rng = np.random.default_rng(seed)
    soc = torch.from_numpy(rng.uniform(0.2, 0.8, r).astype(np.float32))
    u_prev = torch.from_numpy(rng.uniform(-0.5, 0.5, r).astype(np.float32))
    tcfg = convert.numpy_tree(jcfg)
    s_mid = torch.full((r,), float(tcfg["s_mid"]))
    q, lo, hi = tctrl._qp_state_terms(plan, soc, s_mid, u_prev)
    kq = plan.kkt_inv @ q
    kkt_stack = torch.cat([plan.kkt_inv_sigma, plan.kkt_inv_at], dim=1)
    x0 = torch.zeros_like(q)
    z0 = torch.clamp(plan.a_mat @ x0, lo, hi)
    h = plan.horizon
    return (kkt_stack, plan.a_mat[2 * h:].contiguous(), kq, lo, hi, x0, z0,
            torch.zeros_like(z0)), plan.rho


@pytest.mark.parametrize("horizon", [6, 7, 12, 17, 24])
def test_admm_horizon_padding_is_exact(horizon):
    args, rho = _admm_problem(horizon, 33, horizon)
    hp = admm_step.kernel_horizon(horizon)
    assert hp == (12 if horizon <= 12 else 24)
    want = ref.admm_iterate(*args, rho=rho, iters=30)
    padded = admm_step.pad_horizon(*args, hp)
    assert all(t.is_contiguous() for t in padded)
    got_p = ref.admm_iterate(*padded, rho=rho, iters=30)
    got = admm_step.unpad_horizon(*got_p, horizon)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    real = set(admm_step._real_rows(horizon, hp, 2))
    pad_rows = [i for i in range(2 * hp) if i not in real]
    assert torch.count_nonzero(got_p[0][pad_rows]) == 0
    # Above 24 a horizon runs as it is, past 57 too (the plan from global
    # memory): only horizons below 24 are padded.
    assert admm_step.kernel_horizon(58) == 58 and admm_step.kernel_horizon(200) == 200


def test_admm_horizon_6_matches_jax():
    args, rho = _admm_problem(6, 16, 0)
    got = ref.admm_iterate(*args, rho=rho, iters=30)
    want = jref.admm_iterate(*(jnp.asarray(a.numpy()) for a in args), rho=rho, iters=30)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5)


def test_dense_prefill_at_head_dim_160_matches_jax():
    kw = dict(d_model=320, n_heads=2, n_kv_heads=1, d_ff=512)
    cfg = dataclasses.replace(smoke_config("stablelm_12b"), **kw)
    jcfg = dataclasses.replace(jsmoke("stablelm_12b"), **kw)
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim == 160
    tree = convert.random_lm_tree(cfg, 0)
    model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want = JT.forward(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(tok)).logits
    with torch.inference_mode():
        got = T.forward(model, torch.from_numpy(tok)).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
