"""Parity of the port's ``hybrid`` serving slice (zamba2: Mamba2 SSD blocks
and the Zamba2 shared attention block) with the JAX package, on the CPU.

The same parameters (``convert.random_lm_tree``, numpy, seeded) and inputs
go through ``repro.models`` / ``repro.serve`` and through
``repro_torch.models`` / ``repro_torch.serve``, whose kernels (rmsnorm, the
flash forward) run their plain versions on CPU tensors; the SSD scan is
plain code in both packages.  The smoke config is float32.  Tolerances and
their reasons, those of ``tests/test_torch_models.py``:

* ``ssd_chunked``, ``mamba2_fwd``, the blocks and their states: 1e-5
  relative to the output's scale plus 1e-6 absolute.  The two frameworks
  sum the chunk products, the matmuls and the norms in other orders;
* gradients of ``ssd_chunked``: the same 1e-5 of each gradient's scale;
* the port's one-token step against its chunked form (the reference pads
  a token to a whole chunk): the same;
* logits of ``forward`` and ``decode_step``: 2e-5 absolute and 1e-5
  relative, tighter than the JAX package's own chunk-size envelope
  (``tests/test_models.py``: 2e-4 / 1e-3);
* greedy tokens: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import blocks as JB, mamba2 as JM, transformer as JT
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.models import attention as A, mamba2 as M, transformer as T
from repro_torch.serve import ServeEngine, build_prefill_step

torch.set_num_threads(1)

ARCH = "zamba2_2_7b"


def _close(got, want, rel=1e-5, atol=1e-6):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + atol)


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _carried(seed=0):
    cfg, jcfg = smoke_config(ARCH), jsmoke(ARCH)
    tree = convert.random_lm_tree(cfg, seed)
    return cfg, jcfg, tree, convert.lm_params_from_numpy(tree, cfg, device="cpu")


def _mamba_params(tree, g, k):
    return jax.tree.map(lambda a: jnp.asarray(a[g, k]), tree["groups"])


# ---------------------------------------------------------------- the scan


def _ssd_inputs(t, seed, *, h0=False, tiny=False, b=2, h=3, p=8, n=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    a = rng.uniform(0.5, 1.0, (b, t, h)).astype(np.float32)
    if tiny:  # decays at and below the clamp, and exact zeros
        a[:, ::3, 0] = 1e-20
        a[:, 1::5, 1] = 1e-30
        a[:, 2::7, 2] = 0.0
    bb = rng.standard_normal((b, t, n)).astype(np.float32)
    c = rng.standard_normal((b, t, n)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, n, p)) if h0 else np.zeros((b, h, n, p))).astype(np.float32)
    return x, a, bb, c, s0


SSD_CASES = {"multiple": dict(t=32), "ragged": dict(t=21), "h0": dict(t=32, h0=True),
             "tiny decays": dict(t=37, h0=True, tiny=True), "one chunk": dict(t=16, h0=True),
             "one token": dict(t=1, h0=True)}


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_chunked_matches_jax(case):
    x, a, b, c, s0 = _ssd_inputs(seed=3, **SSD_CASES[case])
    y, hf = M.ssd_chunked(*map(_t, (x, a, b, c)), 16, _t(s0))
    jy, jh = JM._ssd_chunked(*map(jnp.asarray, (x, a, b, c)), 16, jnp.asarray(s0))
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    _close(y, jy)
    _close(hf, jh)


@pytest.mark.parametrize("case", ["ragged", "tiny decays"])
def test_ssd_chunked_gradients_match_jax(case):
    """Gradients in x, a, b, c and h0 of a weighted sum of ``y`` and the
    final state, against ``jax.grad``: finite where decays reach the clamp
    (the masked log-decays are clamped before ``exp``).  The gradient in
    ``a`` is compared as ``a * grad`` (the gradient in ``log a``, what
    reaches ``dt`` through ``a = exp(-dt A)``): at a decay of 1e-20 the
    gradient in ``log a`` is a float32 residue of terms that cancel
    exactly (``log a_s`` enters ``cum_t`` and ``cum_s`` alike), which
    ``1 / a`` then scales by 1e20; the two packages' residues differ."""
    args = _ssd_inputs(seed=4, **SSD_CASES[case])
    gy = _x(args[0].shape, seed=8)
    gh = _x(args[4].shape, seed=9)

    def jloss(*xs):
        y, h = JM._ssd_chunked(*xs[:4], 16, xs[4])
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    ts = [_t(v).requires_grad_() for v in args]
    y, h = M.ssd_chunked(*ts[:4], 16, ts[4])
    got = torch.autograd.grad(torch.sum(y * _t(gy)) + torch.sum(h * _t(gh)), ts)
    got, want = list(got), [np.asarray(w) for w in want]
    got[1], want[1] = got[1] * _t(args[1]), want[1] * args[1]
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w)


def test_one_token_step_matches_the_chunked_form():
    """``ssd_step`` against ``ssd_chunked`` on one token (padded to a chunk,
    as the reference runs a decode step), from a nonzero state, with
    decays at the clamp."""
    for seed, tiny in ((5, False), (6, True)):
        x, a, b, c, s0 = _ssd_inputs(1, seed, h0=True)
        if tiny:
            a[0, 0, 0], a[1, 0, 1] = 1e-20, 0.0
        y, h = M.ssd_step(*map(_t, (x, a, b, c, s0)))
        yc, hc = M.ssd_chunked(*map(_t, (x, a, b, c)), 16, _t(s0))
        _close(y, yc.numpy())
        _close(h, hc.numpy())


# ------------------------------------------------------------ Mamba2 layer


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_fwd_matches_jax(with_state):
    cfg, jcfg, tree, model = _carried()
    mod = model.groups[1][0].mamba
    jp = _mamba_params(tree, 1, 0)["mamba"]
    x = _x((2, 21, cfg.d_model), scale=0.5)
    st = jst = None
    if with_state:
        s, _, h, ch = M.dims(cfg)
        conv, ssm = _x((2, s.d_conv - 1, ch), 6), _x((2, h, s.d_state, s.head_dim), 7, 0.3)
        st = M.SSMState(conv=_t(conv), ssm=_t(ssm), length=5)
        jst = JM.SSMState(conv=jnp.asarray(conv), ssm=jnp.asarray(ssm),
                          length=jnp.asarray(5, jnp.int32))
    with torch.inference_mode():
        out, ns = mod(_t(x), st)
    jout, jns = JM.mamba2_fwd(jp, jcfg, jnp.asarray(x), jst)
    _close(out, jout)
    _close(ns.conv, jns.conv)
    _close(ns.ssm, jns.ssm)
    assert ns.length == int(jns.length) == (26 if with_state else 21)


def test_mamba2_split_equals_one_shot():
    """16 + 16 tokens through the carried state against 32 at once, and a
    token at a time against the chunked form."""
    cfg, _, _, model = _carried()
    mod = model.groups[0][1].mamba
    x = _t(_x((2, 32, cfg.d_model), seed=2, scale=0.5))
    with torch.inference_mode():
        one, s1 = mod(x)
        a, sa = mod(x[:, :16])
        b, sb = mod(x[:, 16:], sa)
        _close(torch.cat([a, b], dim=1), one.numpy())
        _close(sb.ssm, s1.ssm.numpy())
        _close(sb.conv, s1.conv.numpy())
        steps, st = [], None
        for i in range(5):
            y, st = mod(x[:, i:i + 1], st)
            steps.append(y)
        _close(torch.cat(steps, dim=1), mod(x[:, :5])[0].numpy())


def test_mamba_block_matches_jax():
    cfg, jcfg, tree, model = _carried()
    x = _x((2, 19, cfg.d_model), scale=0.5)
    jp = _mamba_params(tree, 0, 1)
    with torch.inference_mode():
        out, st = model.groups[0][1](_t(x))
        out2, st2 = model.groups[0][1](_t(x[:, :3]), st)
    jout, jst = JB.mamba_block_fwd(jp, jcfg, jnp.asarray(x))
    jout2, jst2 = JB.mamba_block_fwd(jp, jcfg, jnp.asarray(x[:, :3]), jst)
    _close(out, jout)
    _close(out2, jout2)
    _close(st2.ssm, jst2.ssm)


def test_shared_block_matches_jax():
    """Without a cache (its fresh keys and values), then two tokens against
    the prompt's cache; the sub config is the reference's dense one at head
    dim d_model / shared_block_heads."""
    cfg, jcfg, tree, model = _carried()
    sb = model.shared
    assert sb.sub.family == "dense" and sb.sub.n_heads == sb.sub.n_kv_heads == 4
    assert sb.sub.resolved_head_dim == cfg.d_model // cfg.hybrid.shared_block_heads
    jp = jax.tree.map(jnp.asarray, tree["shared"])
    x, e0 = _x((2, 8, cfg.d_model), scale=0.5), _x((2, 8, cfg.d_model), seed=3, scale=0.5)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    with torch.inference_mode():
        out, fresh = sb(_t(x), _t(e0), _t(pos))
    jout, jfresh = JB.shared_block_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(e0), jnp.asarray(pos))
    _close(out, jout)
    _close(fresh.k, jfresh.k)
    cache = A.init_cache(sb.sub, 2, 12, dtype=torch.float32, device="cpu")
    cache.k[:, :8], cache.v[:, :8] = fresh.k, fresh.v
    cache = cache._replace(length=8)
    jc = A.KVCache(k=jnp.zeros((2, 12) + tuple(jfresh.k.shape[2:])).at[:, :8].set(jfresh.k),
                   v=jnp.zeros((2, 12) + tuple(jfresh.v.shape[2:])).at[:, :8].set(jfresh.v),
                   length=jnp.asarray(8, jnp.int32))
    x1, e1 = _x((2, 2, cfg.d_model), seed=5, scale=0.5), _x((2, 2, cfg.d_model), seed=6)
    p1 = np.broadcast_to(np.arange(8, 10, dtype=np.int32), (2, 2))
    with torch.inference_mode():
        out1, c1 = sb(_t(x1), _t(e1), _t(p1), cache)
    jout1, jc1 = JB.shared_block_fwd(jp, jcfg, jnp.asarray(x1), jnp.asarray(e1), jnp.asarray(p1),
                                     jc)
    _close(out1, jout1)
    _close(c1.k, jc1.k)
    assert c1.length == int(jc1.length) == 10


# ------------------------------------------------------------- the model


def test_forward_prefill_and_decode_match_jax():
    """``forward`` on 24 tokens (a ragged last chunk), a prefill of 20 and
    two cached decode tokens against the JAX package; every state leaf; the
    decode logits equal to ``forward``'s at the same positions."""
    cfg, jcfg, tree, model = _carried()
    jp = jax.tree.map(jnp.asarray, tree)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jfull = JT.forward(jp, jcfg, jnp.asarray(tok)).logits
    jst = JT.init_decode_state(jcfg, 2, 32)
    jl1, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok[:, :20]), jst, jnp.asarray(0, jnp.int32),
                              prefill=True)
    jsteps = []
    for i in (20, 21):
        jl, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok[:, i:i + 1]), jst,
                                 jnp.asarray(i, jnp.int32))
        jsteps.append(jl)
    with torch.inference_mode():
        full = T.forward(model, _t(tok)).logits
        l1, st = build_prefill_step(cfg)(model, _t(tok[:, :20]), 32)
        steps = []
        for i in (20, 21):
            lg, st = T.decode_step(model, _t(tok[:, i:i + 1]), st, i)
            steps.append(lg)
    for got, want in ((full, jfull), (l1, jl1), *zip(steps, jsteps)):
        assert got.dtype == torch.float32 and got.shape[-1] == cfg.padded_vocab
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full[:, 20:22].numpy(), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(l1.numpy(), full[:, :20].numpy(), atol=2e-5, rtol=1e-5)
    g, sh = st["groups"], st["shared"]
    assert g.conv.shape == (2, 2, 2, 3, 288) and g.ssm.dtype == torch.float32
    for got, want in ((g.conv, jst["groups"].conv), (g.ssm, jst["groups"].ssm),
                      (sh.k, jst["shared"].k), (sh.v, jst["shared"].v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    assert g.length == sh.length == int(jst["groups"].length) == int(jst["shared"].length) == 22


def test_greedy_generate_matches_jax():
    cfg, jcfg, tree, model = _carried()
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = np.asarray(JServeEngine(jcfg, jax.tree.map(jnp.asarray, tree), max_len=64).generate(
        jnp.asarray(prompts), n_tokens=6))
    out = ServeEngine(cfg, model, max_len=64, device="cpu").generate(_t(prompts), 6)
    np.testing.assert_array_equal(out.numpy(), want)
    with torch.inference_mode():
        full = T.forward(model, out[:, :-1]).logits
    np.testing.assert_array_equal(full[:, 7:].argmax(-1).numpy(), out[:, 8:].numpy())


def _leaves(tree) -> dict:
    return {".".join(k.key for k in p): (tuple(l.shape), np.dtype(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_random_lm_tree_matches_jax_layout(dtype):
    """Paths, shapes and types leaf for leaf against ``jax.eval_shape`` of
    the reference's ``init``: the doubly stacked ``groups`` leaves, the
    unstacked ``shared`` block and its empty ``_sub_heads`` marker;
    ``a_log``, ``dt_bias``, ``d_skip`` and the marker float32 in a bf16
    model; the initialisers' constants and ``a_log``'s vector."""
    cfg = dataclasses.replace(smoke_config(ARCH), dtype=dtype)
    jcfg = dataclasses.replace(jsmoke(ARCH), dtype=dtype)
    want = _leaves(jax.eval_shape(lambda: JT.init(jax.random.key(0), jcfg)))
    types = {p: (s, np.dtype(str(d).removeprefix("torch.")))
             for p, (s, d) in convert.lm_tree_shapes(cfg).items()}
    assert types == want
    assert want["shared._sub_heads"] == ((0,), np.dtype("float32"))
    f32 = {p for p, (_, d) in want.items() if d == np.float32}
    if dtype == "bfloat16":
        assert f32 == {"groups.mamba.a_log", "groups.mamba.dt_bias", "groups.mamba.d_skip",
                       "shared._sub_heads"}
    tree = convert.random_lm_tree(cfg, 0)
    assert {p: s for p, (s, _) in _leaves(tree).items()} == {p: s for p, (s, _) in want.items()}
    jinit = JT.init(jax.random.key(0), jcfg)
    np.testing.assert_allclose(tree["groups"]["mamba"]["a_log"],
                               np.asarray(jinit["groups"]["mamba"]["a_log"]), rtol=2e-7)
    np.testing.assert_array_equal(tree["groups"]["mamba"]["dt_bias"], 0.0)
    np.testing.assert_array_equal(tree["groups"]["mamba"]["d_skip"], 1.0)
    conv = tree["groups"]["mamba"]["conv"]["kernel"]
    assert np.abs(conv).max() <= 1.0 and 0.3 < conv.std() < 0.5  # 0.5 x a normal clipped at 2
    # The port's own initialiser gives the same constants.
    model = T.init(cfg, device="cpu")
    m = model.groups[1][0].mamba
    np.testing.assert_array_equal(m.a_log.detach().numpy(), tree["groups"]["mamba"]["a_log"][1, 0])
    assert float(m.d_skip.detach().min()) == 1.0 and float(m.dt_bias.detach().abs().max()) == 0.0
    assert model.shared._sub_heads.shape == (0,)


def test_weight_round_trip():
    """``lm_params_from_numpy`` then ``lm_params_to_numpy`` gives the tree
    back bit for bit (``_sub_heads`` included); ``lm_tree_to_numpy`` of
    gradients keeps the layout."""
    cfg, _, tree, model = _carried(seed=2)
    back = convert.lm_params_to_numpy(model)
    flat, bflat = convert._flatten(tree), convert._flatten(back)
    assert flat.keys() == bflat.keys()
    for k in flat:
        np.testing.assert_array_equal(bflat[k], flat[k])
    np.testing.assert_array_equal(model.groups[1][0].mamba.w_in.kernel.detach().numpy(),
                                  tree["groups"]["mamba"]["w_in"]["kernel"][1, 0])
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    g = convert._flatten(convert.lm_tree_to_numpy(zeros, cfg))
    assert {k: v.shape for k, v in g.items()} == {k: v.shape for k, v in flat.items()}
