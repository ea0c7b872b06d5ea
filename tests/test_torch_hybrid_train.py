"""Parity of the port's ``hybrid`` training slice (zamba2: gradients through
the SSD scan and the causal conv, remat per group, AdamW's decay over the
doubly stacked Mamba leaves) with the JAX package, on the CPU.

The same parameters (``convert.random_lm_tree``, numpy, seeded), batches
and AdamW settings go through ``repro.models.transformer.lm_loss`` /
``repro.train.step`` and their ports, whose kernels run their plain
versions on CPU tensors.  The smoke config is float32 (4 layers: 2 groups
of 2 Mamba blocks, so the shared block is visited twice).  Tolerances and
their reasons, as ``tests/test_torch_train.py``'s:

* the loss: 1e-5 relative (matmuls, the scan, softmax and the reference's
  masked vocab sum against the port's gather sum in other orders);
* gradients: 1e-4 of each leaf's scale (measured ~1e-6);
* train steps: 1e-5 relative on the loss and the grad norm; parameters
  after three steps: 99.9 % of each leaf's elements within 1e-5 of the
  leaf's scale plus 1e-7, every element within ``2 lr`` per step (AdamW
  normalises each element, so a gradient within its float32 noise of
  ``eps`` may flip an update).  A leaf of fewer than 1000 elements may
  have one element outside the first bound: ``dt_bias`` (32 elements at
  smoke size) starts at zero, so its scale after three steps is that of
  the updates themselves (2.9e-3), and one element differs by 1.5e-7
  against a bound of 1.3e-7 (5e-5 of the three updates' size, the
  normalisation of a small gradient).
"""
import dataclasses
import threading

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
from repro_torch.kernels import ops, ref as tref
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw, adamw_init
from repro_torch.train import build_train_step

torch.set_num_threads(1)

ARCH = "zamba2_2_7b"


def _cfgs(**over):
    return (dataclasses.replace(smoke_config(ARCH), **over),
            dataclasses.replace(jsmoke(ARCH), **over))


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


def _batch(cfg, b=4, t=40, step=0):
    """4 x 40 tokens: two whole chunks of 16 and a ragged third."""
    ds = SyntheticLMDataset(DataConfig(batch=b, seq_len=t, vocab_size=cfg.vocab_size))
    return ds.batch_at(step)


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def test_lm_loss_and_grads_match_jax():
    """The loss, its metrics and every gradient against
    ``jax.value_and_grad`` of the reference's ``lm_loss``, ``_sub_heads``'s
    empty one included (the port's autograd gives it none; the train step
    fills in zeros, as for any leaf no path reaches)."""
    cfg, jcfg = _cfgs()
    jp, model = _carried(cfg, jcfg)
    batch = _batch(cfg)
    labels = batch["labels"].clone()
    labels[0, :5] = -100
    (jl, jm), jg = jax.value_and_grad(JT.lm_loss, has_aux=True)(
        jp, jcfg, jnp.asarray(batch["tokens"].numpy()), jnp.asarray(labels.numpy()))
    loss, metrics = T.lm_loss(model, batch["tokens"], labels)
    assert set(metrics) == set(jm) == {"lm_loss", "tokens", "total_loss"}
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_array_equal(metrics["tokens"].numpy(), np.asarray(jm["tokens"]))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    assert {n for n, g in zip(names, grads) if g is None} == {"shared._sub_heads"}
    named = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(model.named_parameters(), grads)}
    got, want = _flat(convert.lm_tree_to_numpy(named, cfg)), _flat(jax.tree.map(np.asarray, jg))
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = float(np.max(np.abs(w), initial=0.0)) or 1.0
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * scale, err_msg=f"grad {k}")
        assert np.isfinite(got[k]).all()


def test_reference_ndim_is_the_jax_leaf_rank():
    """``reference_ndim`` of every parameter is the rank of its leaf in the
    JAX package's tree: the Mamba leaves carry two stacking axes (so
    ``a_log``, ``dt_bias``, ``d_skip`` and the norm scales are decayed),
    the shared block's none (its norm scales are not)."""
    cfg, jcfg = _cfgs()
    shapes = _jax_leaves(jcfg)
    model = T.Transformer(cfg, device="meta")
    decayed = set()
    for name, p in model.named_parameters():
        head, _, tail = name.partition(".")
        path = f"{head}.{tail.split('.', 2)[2]}" if head == "groups" else name
        assert adamw.reference_ndim(name, p) == len(shapes[path].shape), name
        if adamw.reference_ndim(name, p) >= 2:
            decayed.add(path)
    assert {"groups.mamba.a_log", "groups.mamba.dt_bias", "groups.mamba.d_skip",
            "groups.ln.scale", "groups.mamba.out_norm.scale"} <= decayed
    assert {"shared.block.ln1.scale", "shared.block.ln2.scale", "ln_f.scale",
            "shared._sub_heads"}.isdisjoint(decayed)
    assert "shared.w_concat.kernel" in decayed


def test_remat_per_group_equals_none():
    """Checkpointing each group (its Mamba blocks and the shared visit)
    recomputes the same group: the loss equal and every gradient within
    float32 noise of the un-checkpointed run's."""
    out = {}
    for remat in ("block", "none"):
        cfg, jcfg = _cfgs(remat=remat)
        _, model = _carried(cfg, jcfg)
        batch = _batch(cfg)
        loss, _ = T.lm_loss(model, batch["tokens"], batch["labels"])
        out[remat] = (loss, torch.autograd.grad(loss, list(model.parameters()),
                                                allow_unused=True))
    assert torch.equal(out["block"][0], out["none"][0])
    for a, b in zip(out["block"][1], out["none"][1]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_forced_mode_reaches_the_group_recompute(monkeypatch):
    """``ops.forced("ref")`` set around the forward must hold in each
    group's recompute, which runs from the backward pass on another thread
    (autograd's device thread on the card): every norm of the forward and
    of the recompute (2 a Mamba block, 2 a shared visit; ``ln_f`` once)
    runs under it, and ``recomputing()`` is set in the recompute only."""
    seen = []
    plain = tref.rmsnorm

    def spy(x, w, eps=1e-6):
        seen.append((ops.current_mode(), T.recomputing()))
        return plain(x, w, eps)

    monkeypatch.setattr(tref, "rmsnorm", spy)
    cfg, jcfg = _cfgs()
    _, model = _carried(cfg, jcfg)
    batch = _batch(cfg)
    with ops.forced("ref"):
        loss, _ = T.lm_loss(model, batch["tokens"], batch["labels"])
    per_group = 2 * cfg.hybrid.shared_every + 2
    n_groups = cfg.n_layers // cfg.hybrid.shared_every
    assert len(seen) == n_groups * per_group + 1
    result = {}
    th = threading.Thread(target=lambda: result.update(
        g=torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)))
    th.start()
    th.join(timeout=120)
    assert not th.is_alive() and "g" in result
    assert len(seen) == 2 * n_groups * per_group + 1
    assert {m for m, _ in seen} == {"ref"}
    assert [r for _, r in seen] == [False] * (n_groups * per_group + 1) + [True] * (
        n_groups * per_group)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(microbatches):
    """Three ``build_train_step`` steps (AdamW with weight decay, the
    schedule warmed up in one step) against the JAX package's jitted step:
    the loss, the grad norm, the learning rate and every parameter."""
    cfg, jcfg = _cfgs()
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
        for key in ("loss", "lm_loss", "grad_norm", "lr", "total_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-9,
                                       err_msg=f"step {step} {key}")
    g, w = _flat(convert.lm_params_to_numpy(model)), _flat(jax.tree.map(np.asarray, jp))
    assert g.keys() == w.keys()
    for k in w:
        err = np.abs(g[k] - w[k])
        if not w[k].size:  # the empty _sub_heads marker
            continue
        tight = err <= 1e-5 * float(np.max(np.abs(w[k]))) + 1e-7
        assert (~tight).sum() <= max(1, int(1e-3 * tight.size)), (k, tight.mean(), err.max())
        assert err.max() <= 2 * opt["lr"] * 3, (k, err.max())
    # The decayed a_log moved away from its initial vector; the undecayed
    # shared norm scale only by its gradient.
    assert not np.array_equal(g["groups.mamba.a_log"],
                              convert.random_lm_tree(cfg, 0)["groups"]["mamba"]["a_log"])


def test_train_launcher_runs_zamba2_on_cpu(capsys):
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", "zamba2-2.7b", "--steps", "2", "--batch", "2", "--seq", "24",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "'step': 0" in out and "'step': 1" in out
