"""Parity of the port's ``moe`` serving slice (DeepSeek-V2/V3: MLA, the
capacity-bounded MoE FFN with both routers, MTP) with the JAX package, on
the CPU.

The same parameters (``convert.random_lm_tree``, numpy, seeded) and inputs
go through ``repro.models`` / ``repro.serve`` and through
``repro_torch.models`` / ``repro_torch.serve``, whose kernels run their
plain versions on CPU tensors.  Tolerances and their reasons:

* float32 module outputs (MLA, the MoE FFN, a block): 1e-5 relative to the
  output's scale plus 1e-6 absolute, as ``tests/test_torch_models.py``: the
  two frameworks' matmuls and reductions sum in other orders (the MoE
  combine sums a token's kept choices in choice order where the
  reference's einsum sums over (expert, slot));
* bf16 MLA outputs: one bf16 ulp (2^-8 relative) of the output's scale (a
  float32 difference of an ulp before a rounding point may move a bf16
  result by one ulp); the bf16 MoE FFN: 2^-5 of the output's scale, since
  XLA's and PyTorch's silu round differently in bf16 and ``w_down`` sums
  d_expert such differences (the bf16 model as a whole is compared, with
  its routing near-ties, in ``tests/test_torch_moe_serve_reference.py``);
* ``MoEAux``: ``dropped_fraction`` and ``expert_load`` exactly (integer
  counts times float32(1 / count), as XLA evaluates the mean), the two
  losses 1e-5 relative;
* logits of ``forward`` (and ``mtp_logits``) and ``decode_step``: 2e-5
  absolute and 1e-5 relative, as the dense families';
* routing picks and greedy tokens: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import full_config as jfull, smoke_config as jsmoke
from repro.kernels import ref as jref
from repro.models import attention as JA, blocks as JB, moe as JMOE, transformer as JT
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import full_config, smoke_config
from repro_torch.kernels import flash_attention as fa, ops as tops, ref as tref
from repro_torch.models import attention as A, moe as MOE, transformer as T
from repro_torch.serve import ServeEngine, build_prefill_step

torch.set_num_threads(1)

MOE_ARCHS = ("deepseek_v2_236b", "deepseek_v3_671b")


def _close(got, want, rel=1e-5, atol=1e-6):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + atol)


def _cfgs(arch, dtype="float32", **moe):
    cfg, jcfg = smoke_config(arch), jsmoke(arch)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
    return dataclasses.replace(cfg, dtype=dtype), dataclasses.replace(jcfg, dtype=dtype)


def _carried(cfg, jcfg, seed=0):
    tree = convert.random_lm_tree(cfg, seed)
    like = _leaves(jax.eval_shape(lambda: JT.init(jax.random.key(0), jcfg)))
    jp = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(a, like[".".join(k.key for k in p)][1]), tree)
    return tree, jp, convert.lm_params_from_numpy(tree, cfg, device="cpu")


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _pair(a, dtype):
    """``a`` as a JAX array and a torch tensor of ``dtype`` with equal bits."""
    j = jnp.asarray(a, dtype)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(getattr(torch, dtype))


def _leaves(tree) -> dict:
    return {".".join(k.key for k in p): (tuple(l.shape), np.dtype(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ours(cfg) -> dict:
    return {p: (s, np.dtype(str(d).removeprefix("torch."))) for p, (s, d) in
            convert.lm_tree_shapes(cfg).items()}


def _bf16_close(got, want, extra=0.0):
    """Within one bf16 ulp of ``want``'s scale, plus ``extra``."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2.0**-8 * scale + extra)


# ------------------------------------------------------------ parameters


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_tree_matches_jax_layout(arch, dtype):
    """Paths, shapes and types of the smoke configs' trees: two stacks,
    ``dense_blocks`` and ``moe_blocks``, the float32 router (kernel and,
    for v3, bias) in a bf16 model, the routed experts without ``kernel``,
    the shared experts, MLA's leaves and v3's ``mtp``."""
    cfg, jcfg = _cfgs(arch, dtype)
    want = _leaves(jax.eval_shape(lambda: JT.init(jax.random.key(0), jcfg)))
    assert _ours(cfg) == want
    tree = convert.random_lm_tree(cfg, 0)
    assert {p: s for p, (s, _) in _leaves(tree).items()} == {p: s for p, (s, _) in want.items()}
    f32 = {p for p, (_, d) in want.items() if d == np.float32}
    if dtype == "bfloat16":
        assert f32 == {"moe_blocks.moe.router.kernel"} | (
            {"moe_blocks.moe.router.bias"} if cfg.moe.router == "sigmoid_bias" else set())
    assert ("mtp.block.attn.wq_a.kernel" in want) == (arch == "deepseek_v3_671b")
    model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    assert model.moe_blocks[0].moe.router.kernel.dtype == torch.float32


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_width_tree_matches_jax_layout(arch):
    """The published widths through ``device="meta"`` against
    ``jax.eval_shape`` (no weights drawn), at the full config's depth cut
    to its dense layers and two MoE layers (the reference's init traces
    each expert of each layer, ~1.5 min at full depth); the full depth's
    tree is the same with each stack's leading axis at its full length."""
    full, jf = full_config(arch), jfull(arch)
    nd = full.moe.first_dense_layers
    cut = dataclasses.replace(full, n_layers=nd + 2)
    want = _leaves(jax.eval_shape(lambda: JT.init(jax.random.key(0),
                                                  dataclasses.replace(jf, n_layers=nd + 2))))
    assert _ours(cut) == want
    lead = {"dense_blocks": nd, "moe_blocks": full.n_layers - nd}
    deep = {p: ((lead[p.split(".")[0]],) + s[1:] if p.split(".")[0] in lead else s, d)
            for p, (s, d) in want.items()}
    assert _ours(full) == deep
    n = sum(int(np.prod(s)) for s, _ in deep.values())
    assert n == {"deepseek_v2_236b": 235_741_434_880, "deepseek_v3_671b": 671_712_670_208}[arch]


def test_random_lm_leaves_stream_the_tree():
    cfg = smoke_config("deepseek_v3_671b")
    tree = convert._flatten(convert.random_lm_tree(cfg, 3))
    leaves = list(convert.random_lm_leaves(cfg, 3))
    assert [p for p, _ in leaves] == sorted(tree)
    for p, a in leaves:
        np.testing.assert_array_equal(a, tree[p])
    # The reference's initialisers in distribution: the router at 0.02, its
    # bias zeros, the stacked experts at 1/sqrt(d_in); numpy's standard
    # normal clipped at +-2 has a standard deviation of 0.9594.
    big = dataclasses.replace(cfg, d_model=512, moe=dataclasses.replace(cfg.moe, n_experts=64))
    t = convert._flatten(convert.random_lm_tree(big, 0))
    router = t["moe_blocks.moe.router.kernel"]
    assert abs(router.std() - 0.02 * 0.9594) < 2e-4 and np.abs(router).max() <= 0.04
    assert not t["moe_blocks.moe.router.bias"].any()
    w = t["moe_blocks.moe.experts.w_down"]
    assert w.shape == (2, 64, 64, 512) and abs(w.std() - 0.9594 / 8) < 2e-3


def test_lm_params_from_leaves_refuses_other_trees():
    cfg = smoke_config("deepseek_v2_236b")
    leaves = dict(convert.random_lm_leaves(cfg, 0))
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params_from_leaves(list(leaves.items())[1:], cfg, device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        convert.lm_params_from_leaves([("blocks.ln1.scale", np.ones(4))], cfg, device="cpu")
    bad = dict(leaves, **{"moe_blocks.moe.router.kernel": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_leaves(bad.items(), cfg, device="cpu")


# ----------------------------------------------------------------- MLA


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_prefill_and_absorbed_decode_match_jax(dtype, q_lora):
    """The expanded prefill (q/k head dim 48, v 32 at the smoke width) and
    then two tokens through the absorbed decode over the compressed cache
    (max_len 16), with and without ``q_lora_rank``."""
    cfg, jcfg = _cfgs("deepseek_v3_671b", dtype)
    if not q_lora:
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, q_lora_rank=None))
        jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(jcfg.mla, q_lora_rank=None))
    tree, jp, model = _carried(cfg, jcfg)
    attn, jattn = model.dense_blocks[0].attn, jax.tree.map(lambda a: a[0], jp["dense_blocks"])["attn"]
    assert hasattr(attn, "wq_a") == q_lora and hasattr(attn, "wq") != q_lora
    jx, x = _pair(_x((2, 8, cfg.d_model), scale=0.5), dtype)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    close = _close if dtype == "float32" else _bf16_close
    with torch.inference_mode():
        out, fresh = attn(x, torch.from_numpy(pos.copy()))
        jout, jfresh = JA.mla_fwd(jattn, jcfg, jx, jnp.asarray(pos))
        close(out, jout)
        close(fresh.k, jfresh.k)
        close(fresh.v, jfresh.v)
        assert fresh.k.shape == (2, 8, cfg.mla.kv_lora_rank) and fresh.length == 8
        cache = A.init_cache(cfg, 2, 16, dtype=x.dtype, device="cpu")
        jcache = JA.init_cache(jcfg, 2, 16, jx.dtype)
        assert cache.k.shape == jcache.k.shape and cache.v.shape == jcache.v.shape
        A.write_cache(cache.k, fresh.k, 0)
        A.write_cache(cache.v, fresh.v, 0)
        cache = cache._replace(length=8)
        jcache = JA.KVCache(k=jcache.k.at[:, :8].set(jfresh.k), v=jcache.v.at[:, :8].set(jfresh.v),
                            length=jnp.asarray(8, jnp.int32))
        jx2, x2 = _pair(_x((2, 2, cfg.d_model), seed=5, scale=0.5), dtype)
        p2 = np.broadcast_to(np.arange(8, 10, dtype=np.int32), (2, 2))
        out2, c2 = attn(x2, torch.from_numpy(p2.copy()), cache)
        jout2, jc2 = JA.mla_fwd(jattn, jcfg, jx2, jnp.asarray(p2), jcache)
        close(out2, jout2)
        close(c2.k[:, :10], jc2.k[:, :10])
        assert c2.length == int(jc2.length) == 10 and c2.k is cache.k


def test_mla_decode_equals_prefill():
    """The absorbed decode of a prompt equals the expanded prefill (float32;
    the two forms sum in other orders)."""
    cfg, jcfg = _cfgs("deepseek_v2_236b")
    _, _, model = _carried(cfg, jcfg)
    attn = model.dense_blocks[0].attn
    x = torch.from_numpy(_x((2, 6, cfg.d_model), seed=7, scale=0.5))
    pos = torch.arange(6).expand(2, 6)
    with torch.inference_mode():
        out, _ = attn(x, pos)
        cache = A.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
        out_c, _ = attn(x, pos, cache)
    _close(out_c, out.numpy())


# -------------------------------------------------------------- MoE FFN


MOE_CASES = [
    ("default", {}, (2, 16), 256),  # capacity factor 4.0: nothing dropped
    ("dropping", {"capacity_factor": 1.25}, (2, 64), 256),
    ("padded", {"capacity_factor": 1.25}, (3, 25), 32),  # 75 tokens: 3 groups, 21 padded rows
    ("group 32", {"capacity_factor": 1.0}, (4, 32), 32),
]


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("name,moe_kw,shape,group", MOE_CASES, ids=[c[0] for c in MOE_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_fwd_matches_jax(arch, name, moe_kw, shape, group, dtype):
    """``moe_fwd`` and its ``MoEAux`` against the reference for both routers:
    with pairs dropped at the published capacity factor, a token count that
    is not a multiple of the group (padded rows routed to expert 0, counted
    in ``dropped_fraction``) and ``group_size=32``."""
    cfg, jcfg = _cfgs(arch, dtype, **moe_kw)
    tree, jp, model = _carried(cfg, jcfg)
    moe, jmoe = model.moe_blocks[0].moe, jax.tree.map(lambda a: a[0], jp["moe_blocks"])["moe"]
    if cfg.moe.router == "sigmoid_bias":
        # A non-zero bias, so that it moves the selection.
        bias = _x((cfg.moe.n_experts,), seed=9, scale=0.05)
        moe.router.bias.data.copy_(torch.from_numpy(bias))
        jmoe["router"]["bias"] = jnp.asarray(bias)
    # Inputs at 3 x the unit scale, so that the router's logits (0.02 x
    # sqrt(d) x 3 ~ 0.7) load the experts unevenly enough to drop pairs.
    jx, x = _pair(_x(shape + (cfg.d_model,), seed=9, scale=3.0), dtype)
    with torch.inference_mode():
        y, aux = MOE.moe_fwd(moe, cfg, x, group_size=group)
        w, idx, scores, logits = MOE.route(moe, cfg, x.reshape(-1, cfg.d_model))
    jy, jaux = JMOE.moe_fwd(jmoe, jcfg, jx, group_size=group)
    jw, jidx, jscores, jlogits = JMOE._route(jmoe, jcfg, jx.reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w, jw)
    _close(logits, jlogits)
    assert aux.dropped_fraction.dtype == torch.float32
    assert float(aux.dropped_fraction) == float(jaux.dropped_fraction)
    np.testing.assert_array_equal(aux.expert_load.numpy(), np.asarray(jaux.expert_load))
    _close(aux.load_balance_loss, jaux.load_balance_loss)
    _close(aux.router_z_loss, jaux.router_z_loss)
    if name in ("dropping", "padded", "group 32"):
        assert float(aux.dropped_fraction) > 0
    if name == "padded":  # the padded rows' k pairs each count as kept or dropped
        n, k = shape[0] * shape[1], cfg.moe.experts_per_token
        sl = MOE.slots(idx, cfg, group)
        assert (sl.g, sl.s) == (3, 32) and sl.keep.shape == (3, 32 * k)
        assert float(aux.dropped_fraction) == float(
            np.float32(1) - np.float32(sl.keep.sum()) * np.float32(1 / (96 * k)))
        assert bool(sl.keep.reshape(96, k)[n:].any())  # padded pairs take slots too
    if dtype == "float32":
        _close(y, jy)
    else:
        # bf16: XLA's and PyTorch's silu round differently (a third of the
        # elements an ulp apart at the smoke width), which w_down sums over
        # d_expert products; 2^-5 of the output's scale, 4 bf16 ulps at its
        # top (measured up to 2 at values near 1/2 of the top).
        _close(y, jy, rel=2.0**-5)


def test_slots_follow_the_reference_count():
    """Every pair's slot is the number of earlier pairs of its group at its
    expert; the padded rows choose expert 0 after every real token."""
    import chip_smoke

    cfg = dataclasses.replace(smoke_config("deepseek_v2_236b"),
                              moe=dataclasses.replace(smoke_config("deepseek_v2_236b").moe,
                                                      capacity_factor=1.0))
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(np.stack([rng.choice(8, 2, replace=False) for _ in range(45)]))
    sl = MOE.slots(idx, cfg, 16)
    assert (sl.g, sl.s, sl.capacity) == (3, 16, 4)
    flat = sl.expert.reshape(3, 32)
    for g in range(3):
        for j in range(32):
            assert int(sl.slot[g, j]) == int((flat[g, :j] == flat[g, j]).sum())
    assert torch.equal(sl.expert.reshape(48, 2)[45:], torch.zeros((3, 2), dtype=idx.dtype))
    np.testing.assert_array_equal(sl.keep.reshape(48, 2)[:45].numpy(),
                                  chip_smoke.keep_flags(idx.numpy(), 8, 1.0, 16))


def test_update_router_bias_matches_jax():
    cfg, jcfg = _cfgs("deepseek_v3_671b")
    tree, jp, model = _carried(cfg, jcfg)
    moe, jmoe = model.moe_blocks[0].moe, jax.tree.map(lambda a: a[0], jp["moe_blocks"])["moe"]
    load = _x((cfg.moe.n_experts,), seed=3, scale=0.1) + 0.25
    load[2] = cfg.moe.experts_per_token / cfg.moe.n_experts  # on target: unchanged
    for _ in range(3):
        MOE.update_router_bias(moe, cfg, torch.from_numpy(load), lr=1e-2)
        jmoe = JMOE.update_router_bias(jmoe, jcfg, jnp.asarray(load), lr=1e-2)
    np.testing.assert_array_equal(moe.router.bias.detach().numpy(), np.asarray(jmoe["router"]["bias"]))
    assert float(moe.router.bias[2]) == 0.0
    v2 = convert.lm_params_from_numpy(convert.random_lm_tree(smoke_config("deepseek_v2_236b"), 0),
                                      smoke_config("deepseek_v2_236b"), device="cpu")
    before = v2.moe_blocks[0].moe.router.kernel.clone()
    MOE.update_router_bias(v2.moe_blocks[0].moe, smoke_config("deepseek_v2_236b"),
                           torch.from_numpy(load))
    assert v2.moe_blocks[0].moe.router.bias is None
    assert torch.equal(before, v2.moe_blocks[0].moe.router.kernel)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_matches_jax(arch):
    cfg, jcfg = _cfgs(arch)
    tree, jp, model = _carried(cfg, jcfg)
    x = _x((2, 8, cfg.d_model), scale=0.5)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    with torch.inference_mode():
        out, cache, aux = model.moe_blocks[1](torch.from_numpy(x), torch.from_numpy(pos.copy()))
    jout, jcache, jaux = JB.decoder_block_fwd(jax.tree.map(lambda a: a[1], jp["moe_blocks"]),
                                              jcfg, jnp.asarray(x), jnp.asarray(pos))
    _close(out, jout)
    _close(cache.k, jcache.k)
    np.testing.assert_array_equal(aux.expert_load.numpy(), np.asarray(jaux.expert_load))
    assert float(aux.dropped_fraction) == float(jaux.dropped_fraction) == 0.0
    with torch.inference_mode():
        _, _, dense_aux = model.dense_blocks[0](torch.from_numpy(x), torch.from_numpy(pos.copy()))
    assert dense_aux is None


# ---------------------------------------------------------- transformer


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_decode_match_jax(arch):
    """``forward`` (logits, the averaged aux, v3's ``mtp_logits``), then the
    prefill step on 8 tokens and two cached decode tokens."""
    cfg, jcfg = _cfgs(arch)
    tree, jp, model = _carried(cfg, jcfg)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jo = JT.forward(jp, jcfg, jnp.asarray(tok))
    jst = JT.init_decode_state(jcfg, 2, 32)
    jl1, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok[:, :8]), jst, jnp.asarray(0, jnp.int32),
                              prefill=True)
    jl2, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok[:, 8:9]), jst, jnp.asarray(8, jnp.int32))
    jl3, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok[:, 9:10]), jst, jnp.asarray(9, jnp.int32))
    t = torch.from_numpy(tok)
    with torch.inference_mode():
        o = T.forward(model, t)
        l1, st = build_prefill_step(cfg)(model, t[:, :8], 32)
        l2, st = T.decode_step(model, t[:, 8:9], st, 8)
        l3, st = T.decode_step(model, t[:, 9:10], st, 9)
    for got, want in ((o.logits, jo.logits), (l1, jl1), (l2, jl2), (l3, jl3)):
        assert got.dtype == torch.float32 and got.shape[-1] == cfg.padded_vocab
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    assert set(o.aux_losses) == set(jo.aux_losses)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(o.aux_losses[k].numpy(), np.asarray(jo.aux_losses[k]),
                                   rtol=1e-5, atol=1e-9)
    for k in ("expert_load", "dropped_fraction"):
        np.testing.assert_array_equal(o.aux_losses[k].numpy(), np.asarray(jo.aux_losses[k]))
    if cfg.mtp_depth:
        np.testing.assert_allclose(o.mtp_logits.numpy(), np.asarray(jo.mtp_logits), atol=2e-5,
                                   rtol=1e-5)
    else:
        assert o.mtp_logits is None and jo.mtp_logits is None
    for key in ("dense", "moe"):
        assert st[key].length == int(jst[key].length) == 10
        np.testing.assert_allclose(st[key].k.numpy()[:, :, :10], np.asarray(jst[key].k)[:, :, :10],
                                   atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(st[key].v.numpy()[:, :, :10], np.asarray(jst[key].v)[:, :, :10],
                                   atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_generate_matches_jax(arch):
    cfg, jcfg = _cfgs(arch)
    tree, jp, model = _carried(cfg, jcfg)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = np.asarray(JServeEngine(jcfg, jp, max_len=64).generate(jnp.asarray(prompts), n_tokens=6))
    out = ServeEngine(cfg, model, max_len=64, device="cpu").generate(torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(out.numpy(), want)


def test_serve_launcher_runs_deepseek_on_cpu(capsys):
    from repro_torch.launch import serve

    for arch in ("deepseek-v2-236b", "deepseek-v3-671b"):
        serve.main(["--arch", arch, "--requests", "2", "--prompt-len", "5", "--gen-tokens", "3",
                    "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4 and all(ln.startswith("req") for ln in lines)


# ------------------------------------------- flash at MLA's value width


def _mla_qkv(seed, b=2, h=3, t=40, dqk=48, dv=32, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    mk = lambda d: torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(np.float32)).to(dtype)
    return mk(dqk), mk(dqk), mk(dv)


def test_value_width_padding_is_exact_on_the_plain_version():
    """Zero value columns add zero output columns: the plain attention of
    ``v`` padded to the query's head dim, cut back, equals the plain
    attention of ``v`` bit for bit, and both match the JAX package's
    reference (which takes any value width)."""
    q, k, v = _mla_qkv(1)
    scale = 48**-0.5
    want = tref.attention(q, k, v, causal=True, scale=scale)
    padded = tref.attention(q, k, fa.pad_value(v, 48), causal=True, scale=scale)
    assert padded.shape[-1] == 48 and not padded[..., 32:].any()
    assert torch.equal(padded[..., :32], want)
    jwant = jref.attention(*(jnp.asarray(a.numpy()) for a in (q, k, v)), causal=True, scale=scale)
    _close(want, jwant)
    assert fa.pad_value(v, 32) is v


def test_flash_function_pads_the_value_width(monkeypatch):
    """``ops.attention`` on the kernel path at q/k 48, v 32: the
    ``FlashAttention`` Function hands the kernels ``v`` and the cotangent
    padded to 48 (plain stand-ins here that check what a launch receives),
    returns 32 output columns and cuts ``dv`` back, equal to the plain
    attention's output and gradients."""
    seen = []

    def fwd(q, k, v, *, causal, scale):
        seen.append(("fwd", q.shape[-1], v.shape[-1]))
        with torch.no_grad():
            return tref.attention(q, k, v, causal=causal, scale=scale, with_lse=True)

    def bwd(q, k, v, o, lse, do, *, causal, scale):
        seen.append(("bwd", v.shape[-1], do.shape[-1], o.shape[-1]))
        with torch.no_grad():
            return tref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)

    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    monkeypatch.setattr(tops, "_use_kernel", lambda t, force: True)
    qn, kn, vn = _mla_qkv(2)
    q, k, v = (a.clone().requires_grad_() for a in (qn, kn, vn))
    out = tops.attention(q, k, v, causal=True, scale=48**-0.5)
    assert out.shape == (2, 3, 40, 32)
    got = torch.autograd.grad(torch.sum(torch.sin(out)), (q, k, v))
    q2, k2, v2 = (a.clone().requires_grad_() for a in (qn, kn, vn))
    ref_out = tref.attention(q2, k2, v2, causal=True, scale=48**-0.5)
    want = torch.autograd.grad(torch.sum(torch.sin(ref_out)), (q2, k2, v2))
    torch.testing.assert_close(out.detach(), ref_out.detach(), rtol=1e-6, atol=1e-6)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=2e-6)
    assert seen == [("fwd", 48, 48), ("bwd", 48, 48, 48)]
