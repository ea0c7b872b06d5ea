"""Parity of the port's ``moe`` training slice (DeepSeek-V2/V3: the aux and
MTP losses, the router-bias nudge, remat of the MoE stack, AdamW's decay
over the stacks and its sliced update) with the JAX package, on the CPU.

The same parameters (``convert.random_lm_tree``, numpy, seeded), batches
and AdamW settings go through ``repro.models.transformer.lm_loss`` /
``repro.train.step`` and their ports, whose kernels run their plain
versions on CPU tensors.  The smoke configs run in float32 at the published
capacity factor 1.25, so pairs are dropped.  Tolerances and their reasons,
as ``tests/test_torch_train.py``'s:

* the loss and its terms: 1e-5 relative (matmuls, softmax, the MoE
  combine and the reference's masked vocab sum against the port's gather
  sum in other orders); ``expert_load`` and ``dropped_fraction`` exactly
  (counts times float32(1 / count) on both sides);
* gradients: 1e-4 of each leaf's scale (measured ~1e-6);
* train steps: 1e-5 relative on the loss, its terms and the grad norm;
  parameters after three steps: 99.9 % of each leaf's elements within
  1e-5 of the leaf's scale plus 1e-7, every element within ``2 lr`` per
  step (AdamW normalises each element, so a gradient within its float32
  noise of ``eps`` may flip an update); the sigmoid router's bias, which
  moves by decay and the nudge of 1e-3 a step only, within 1e-7.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamWConfig, adamw_init as jadamw_init
from repro.train.step import build_train_step as jbuild_train_step
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw, adamw_init, adamw_update
from repro_torch.train import build_train_step

torch.set_num_threads(1)

MOE_ARCHS = ("deepseek_v2_236b", "deepseek_v3_671b")


def _cfgs(arch, **over):
    cfg, jcfg = smoke_config(arch), jsmoke(arch)
    moe = dict(capacity_factor=1.25)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe), **over)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe), **over)
    return cfg, jcfg


def _jax_leaves(jcfg) -> dict:
    return {".".join(k.key for k in p): l for p, l in jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: JT.init(jax.random.key(0), jcfg)))[0]}


def _carried(cfg, jcfg, seed=0):
    tree = convert.random_lm_tree(cfg, seed)
    like = _jax_leaves(jcfg)
    jp = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(a, like[".".join(k.key for k in p)].dtype), tree)
    return jp, convert.lm_params_from_numpy(tree, cfg, device="cpu")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _batch(cfg, b=4, t=64, step=0):
    ds = SyntheticLMDataset(DataConfig(batch=b, seq_len=t, vocab_size=cfg.vocab_size))
    return ds.batch_at(step)


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


# ------------------------------------------------------------------ loss --


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    """The total loss with its aux and MTP terms, every metric and every
    gradient against ``jax.value_and_grad`` of the reference's ``lm_loss``.
    The sigmoid router's bias has no gradient path: JAX gives it zeros, the
    port none (the train step fills in zeros)."""
    cfg, jcfg = _cfgs(arch)
    jp, model = _carried(cfg, jcfg)
    batch = _batch(cfg)
    labels = batch["labels"].clone()
    labels[0, :5] = -100
    (jl, jm), jg = jax.value_and_grad(JT.lm_loss, has_aux=True)(
        jp, jcfg, jnp.asarray(batch["tokens"].numpy()), jnp.asarray(labels.numpy()))
    loss, metrics = T.lm_loss(model, batch["tokens"], labels)
    assert set(metrics) == set(jm)
    for k in ("total_loss", "lm_loss", "load_balance", "router_z", "mtp_loss"):
        if k in jm:
            np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]), rtol=1e-5,
                                       atol=1e-9, err_msg=k)
    for k in ("expert_load", "dropped_fraction", "tokens"):
        np.testing.assert_array_equal(metrics[k].detach().numpy(), np.asarray(jm[k]), err_msg=k)
    assert float(metrics["dropped_fraction"]) > 0  # pairs dropped at capacity factor 1.25
    assert float(loss) == float(metrics["total_loss"])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    unused = {n for n, g in zip(names, grads) if g is None}
    jflat = _flat(jax.tree.map(np.asarray, jg))
    if cfg.moe.router == "sigmoid_bias":
        assert unused == {f"moe_blocks.{i}.moe.router.bias" for i in range(len(model.moe_blocks))}
        assert not jflat["moe_blocks.moe.router.bias"].any()
    else:
        assert not unused
    named = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(model.named_parameters(), grads)}
    got = _flat(convert.lm_tree_to_numpy(named, cfg))
    assert got.keys() == jflat.keys()
    for k, w in jflat.items():
        scale = float(np.max(np.abs(w))) or 1.0
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * scale, err_msg=f"{arch} grad {k}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_block_equals_none_on_the_moe_stack(arch):
    """Checkpointing each dense and MoE block recomputes the same blocks,
    routing included: the loss, its metrics and every gradient equal the
    un-checkpointed run's."""
    out = {}
    for remat in ("block", "none"):
        cfg, jcfg = _cfgs(arch, remat=remat)
        _, model = _carried(cfg, jcfg)
        batch = _batch(cfg)
        loss, metrics = T.lm_loss(model, batch["tokens"], batch["labels"])
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        out[remat] = (loss, metrics, grads)
    assert torch.equal(out["block"][0], out["none"][0])
    for k, v in out["none"][1].items():
        assert torch.equal(out["block"][1][k], v), k
    for a, b in zip(out["block"][2], out["none"][2]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------- steps --


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_steps_match_jax(arch, microbatches):
    """Three ``build_train_step`` steps (AdamW with weight decay, the
    schedule warmed up in one step) against the JAX package's jitted step:
    every metric, the parameters, and after each step the sigmoid router's
    bias (zero gradient, decayed, then nudged by the layer-averaged load of
    the last microbatch)."""
    cfg, jcfg = _cfgs(arch)
    jp, model = _carried(cfg, jcfg)
    opt = dict(lr=1e-3, weight_decay=0.1)
    kw = dict(microbatches=microbatches, total_steps=10, warmup_steps=1)
    jstep = jax.jit(jbuild_train_step(jcfg, JAdamWConfig(**opt), **kw))
    tstep = build_train_step(cfg, AdamWConfig(**opt), **kw)
    js = jadamw_init(jp, JAdamWConfig(**opt))
    ts = adamw_init(dict(model.named_parameters()), AdamWConfig(**opt))
    for step in range(3):
        batch = _batch(cfg, step=step)
        jp, js, jm = jstep(jp, js, _jbatch(batch), jnp.asarray(step))
        model, ts, tm = tstep(model, ts, batch, step)
        for key in ("loss", "lm_loss", "load_balance", "router_z", "mtp_loss", "grad_norm", "lr",
                    "total_loss"):
            if key in jm:
                np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-9,
                                           err_msg=f"step {step} {key}")
        assert ("mtp_loss" in tm) == bool(cfg.mtp_depth)
        for key in ("expert_load", "dropped_fraction", "tokens"):
            np.testing.assert_array_equal(tm[key].numpy(), np.asarray(jm[key]),
                                          err_msg=f"step {step} {key}")
        if cfg.moe.router == "sigmoid_bias":
            jb = np.asarray(jp["moe_blocks"]["moe"]["router"]["bias"])
            tb = np.stack([b.moe.router.bias.detach().numpy() for b in model.moe_blocks])
            np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-7, err_msg=f"step {step} bias")
            assert (np.abs(tb) > 0).all()
    g, w = _flat(convert.lm_params_to_numpy(model)), _flat(jax.tree.map(np.asarray, jp))
    assert g.keys() == w.keys()
    for k in w:
        err = np.abs(g[k] - w[k])
        tight = err <= 1e-5 * float(np.max(np.abs(w[k]))) + 1e-7
        assert tight.mean() >= 0.999, (k, tight.mean())
        assert err.max() <= 2 * opt["lr"] * 3, (k, err.max())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reference_ndim_is_the_jax_leaf_rank(arch):
    """``reference_ndim`` of every parameter is the rank of its leaf in the
    JAX package's tree, so AdamW decays the same leaves: the stacked
    blocks' norm scales and router bias are matrices there, ``ln_f`` and
    the MTP head's norms are not."""
    cfg, jcfg = _cfgs(arch)
    shapes = _jax_leaves(jcfg)
    model = T.Transformer(cfg, device="meta")
    decayed = set()
    for name, p in model.named_parameters():
        head, _, tail = name.partition(".")
        path = f"{head}.{tail.split('.', 1)[1]}" if head in T.STACKS else name
        assert adamw.reference_ndim(name, p) == len(shapes[path].shape), name
        if adamw.reference_ndim(name, p) >= 2:
            decayed.add(path)
    assert "ln_f.scale" not in decayed and "moe_blocks.ln1.scale" in decayed
    assert "dense_blocks.attn.kv_a_norm.scale" in decayed
    if cfg.mtp_depth:
        assert {"mtp.ln.scale", "mtp.block.ln1.scale"}.isdisjoint(decayed)
        assert "moe_blocks.moe.router.bias" in decayed


# ----------------------------------------------------------------- adamw --


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_sliced_adamw_update_is_bitwise(monkeypatch, state_dtype):
    """A leaf larger than ``CHUNK_ELEMENTS`` runs over slices of its leading
    axis (here leaves of 6000 and 2400 elements against a chunk of 1000, the
    last slice short, and a leaf whose single row passes the chunk): the
    parameters and both moments equal the whole-leaf update's bit for bit
    over two steps (the clip scale is 1: the grad norm, summed slice by
    slice in another order, stays under ``clip_norm``), the grad norm
    within a float32 rounding."""
    rng = np.random.default_rng(0)
    shapes = {"blocks.0.w": ((5, 40, 30), torch.bfloat16),
              "moe_blocks.0.b": ((7, 343), torch.float32),
              "wide": ((1, 1500), torch.float32), "ln_f.scale": ((64,), torch.float32)}
    grads = [{n: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 1e-3).to(dt)
              for n, (s, dt) in shapes.items()} for _ in range(2)]
    start = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
             for n, (s, dt) in shapes.items()}
    cfg = AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    runs = {}
    for chunk in (1 << 40, 1000):
        monkeypatch.setattr(adamw, "CHUNK_ELEMENTS", chunk)
        params = {n: p.clone() for n, p in start.items()}
        st = adamw_init(params, cfg)
        norms = []
        for g in grads:
            _, st2, m = adamw_update(g, st, params, cfg, 0.5)
            assert all(st2.m[n] is st.m[n] and st2.v[n] is st.v[n] for n in params)  # in place
            st = st2
            norms.append(float(m["grad_norm"]))
        runs[chunk] = (params, st, norms)
    (pa, sa, na), (pb, sb, nb) = runs.values()
    assert max(na) < cfg.clip_norm
    np.testing.assert_allclose(na, nb, rtol=1e-6)
    for n in shapes:
        assert torch.equal(pa[n], pb[n]) and torch.equal(sa.m[n], sb.m[n]) \
            and torch.equal(sa.v[n], sb.v[n]), n
    assert sa.m["blocks.0.w"].dtype == getattr(torch, state_dtype)
    assert [len(list(adamw._slices(start[n]))) for n in shapes] == [5, 4, 1, 1]


# --------------------------------------------------------------- launcher --


def test_train_launcher_runs_deepseek_v3_on_cpu(capsys):
    from repro_torch.launch import train as launch

    launch.main(["--arch", "deepseek-v3-671b", "--steps", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    recs = [eval(ln, {}) for ln in lines]  # the launcher prints one dict a logged step
    assert [r["step"] for r in recs] == [0, 1]
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in recs)
