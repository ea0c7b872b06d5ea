"""Parity of the port's ``ssm`` training slice (RWKV-6: gradients through
the plain scan forms, remat per block, AdamW's decay over the stacked
block leaves) with the JAX package, on the CPU.

The same parameters (``convert.random_lm_tree``, numpy, seeded), batches
and AdamW settings go through ``repro.models.transformer.lm_loss`` /
``repro.train.step`` and their ports.  The JAX package trains RWKV-6
through its jnp ``rwkv6_chunked`` / ``rwkv6_scan`` (its kernel has no
gradient), and the port through their PyTorch counterparts, which
``ops.rwkv6_scan`` takes under a recording graph on every device.  The
smoke config is float32 (2 layers, d_model 128, 2 heads of 64).
Tolerances and their reasons, as ``tests/test_torch_hybrid_train.py``'s:

* the scan's gradients against ``jax.grad`` of the reference's forms:
  1e-5 of each gradient's largest value (float32 products summed in
  other orders; measured below 1e-6);
* the loss: 1e-5 relative; gradients 1e-4 of each leaf's scale (the
  matmuls, the chunked form's einsums and the norms sum in other orders;
  measured ~1e-6);
* train steps: 1e-5 relative on the loss and the grad norm of the first
  step; parameters after the steps: 99.9 % of each leaf's elements within
  1e-5 of the leaf's scale plus 1e-7 or 1e-3 of ``lr`` a step (an update
  normalised from a gradient that differs in its float32 noise: two of the
  128 elements of ``channel.mu_k``, scale 0.04, differ by 6.7e-7 at T =
  40), every element within ``2 lr`` per step (AdamW normalises each
  element, so a gradient within its float32 noise of ``eps`` may flip an
  update).  The second step's grad norm reads
  parameters that the first update moved apart so, by up to 0.07 lr in a
  few elements at T = 40 (the embedding rows that 160 tokens barely
  reach): 5e-5 relative there (measured 1.7e-5; the loss stays within
  2.1e-6).
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.kernels import ref as jref
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
from test_torch_rwkv6 import _scan_inputs

torch.set_num_threads(1)

ARCH = "rwkv6_7b"


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


def _batch(cfg, b=2, t=64, step=0):
    ds = SyntheticLMDataset(DataConfig(batch=b, seq_len=t, vocab_size=cfg.vocab_size))
    return ds.batch_at(step)


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _grads(fn, ts):
    """Gradients of ``sum(o * c) + sum(S_T * c')`` (fixed seeded weights)
    of ``fn(*ts)`` in every input."""
    ts = [t.clone().requires_grad_() for t in ts]
    o, s = fn(*ts)
    g = np.random.default_rng(9)
    co = torch.from_numpy(g.standard_normal(o.shape).astype(np.float32))
    cs = torch.from_numpy(g.standard_normal(s.shape).astype(np.float32))
    loss = torch.sum(o.float() * co) + torch.sum(s * cs)
    return torch.autograd.grad(loss, ts)


# ------------------------------------------------------------ the scan


@pytest.mark.parametrize("t,algorithm,plain", [
    (64, "auto", "chunked"), (96, "auto", "chunked"), (40, "auto", "sequential"),
    (64, "sequential", "sequential"), (32, "auto", "sequential")])
@pytest.mark.parametrize("with_state", [False, True])
def test_ops_scan_gradients_are_the_plain_forms(monkeypatch, t, algorithm, plain, with_state):
    """``ops.rwkv6_scan`` under autograd, on the CPU and on the card's
    route (a stand-in for ``_use_kernel``, as a CUDA tensor takes it): the
    gradients of every input, ``state0`` included, equal bit for bit those
    of the plain form the reference's host rule picks (the chunked form
    for T a multiple of 32 above 32, else the sequential scan), and lie
    within 1e-5 of ``jax.grad`` of the reference's jnp form."""
    ts, js = _scan_inputs(2, 2, t, 64, torch.float32, seed=t)
    if with_state:
        s0 = np.random.default_rng(1).standard_normal((2, 2, 64, 64)).astype(np.float32) * 0.1
        ts, js = ts + [torch.from_numpy(s0)], js + [jnp.asarray(s0)]
    fn = {"chunked": lambda *a: tref.rwkv6_chunked(*a, chunk=32), "sequential": tref.rwkv6_scan}
    want = _grads(fn[plain], ts)
    got_cpu = _grads(lambda *a: ops.rwkv6_scan(*a, algorithm=algorithm), ts)
    monkeypatch.setattr(ops, "_use_kernel", lambda x, force: force != "ref")
    monkeypatch.setattr(ops._rw, "rwkv6_scan", None)  # a launch would fail
    got_card = _grads(lambda *a: ops.rwkv6_scan(*a, algorithm=algorithm), ts)
    for a, b, c in zip(got_cpu, got_card, want):
        assert torch.equal(a, c) and torch.equal(b, c)
    jfn = {"chunked": lambda *a: jref.rwkv6_chunked(*a, chunk=32), "sequential": jref.rwkv6_scan}
    g = np.random.default_rng(9)
    co = g.standard_normal(want[0].shape).astype(np.float32)
    cs = g.standard_normal((2, 2, 64, 64)).astype(np.float32)

    def jloss(*a):
        o, s = jfn[plain](*a)
        return jnp.sum(o * co) + jnp.sum(s * cs)

    jg = jax.grad(jloss, argnums=tuple(range(len(js))))(*js)
    for a, b in zip(want, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * float(np.abs(b).max()))


def test_sequential_chunk_remat_changes_no_gradient(monkeypatch):
    """The sequential scan under a recording graph runs each 128 steps as
    one activation checkpoint when T is a multiple of 128 above it (the
    reference's chunked remat): at T = 256 two checkpoints, at T = 128 and
    T = 200 none, and the outputs, the final state and every gradient
    equal the run without checkpoints (``chunk`` past T) bit for bit."""
    n = []
    plain = torch.utils.checkpoint.checkpoint

    def counted(*a, **kw):
        n.append(None)
        return plain(*a, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    for t, want_n in ((256, 2), (128, 0), (200, 0)):
        n.clear()
        ts, _ = _scan_inputs(1, 2, t, 64, torch.float32, seed=3)
        got = _grads(tref.rwkv6_scan, ts)
        assert len(n) == want_n, t
        want = _grads(lambda *a: tref.rwkv6_scan(*a, chunk=4096), ts)
        for a, b in zip(got, want):
            assert torch.equal(a, b), t
        with torch.no_grad():
            o, s = tref.rwkv6_scan(*ts)
        o2, s2 = tref.rwkv6_scan(*(x.clone().requires_grad_() for x in ts))
        assert torch.equal(o, o2.detach()) and torch.equal(s, s2.detach())
    n.clear()
    with torch.no_grad():
        tref.rwkv6_scan(*_scan_inputs(1, 2, 256, 64, torch.float32)[0])
    assert not n  # serving keeps no checkpoints


# ------------------------------------------------------------ the model


def test_lm_loss_and_grads_match_jax():
    """The loss, its metrics and every gradient against
    ``jax.value_and_grad`` of the reference's ``lm_loss`` (T = 64: the
    chunked form on both sides; 5 ignored labels)."""
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
    grads = torch.autograd.grad(loss, list(model.parameters()))
    named = dict(zip([n for n, _ in model.named_parameters()], grads))
    got, want = _flat(convert.lm_tree_to_numpy(named, cfg)), _flat(jax.tree.map(np.asarray, jg))
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = float(np.max(np.abs(w), initial=0.0)) or 1.0
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * scale, err_msg=f"grad {k}")
        assert np.isfinite(got[k]).all() and np.abs(got[k]).max() > 0, k


def test_reference_ndim_is_the_jax_leaf_rank():
    """``reference_ndim`` of every parameter is the rank of its leaf in the
    JAX package's tree, where the block leaves are stacked over layers:
    every in-block leaf is decayed (``u_bonus``, ``decay_base``, the mix
    vectors and the norm scales too), ``ln_f`` is not, and the decay set
    is the reference's rank rule leaf by leaf."""
    cfg, jcfg = _cfgs()
    shapes = _jax_leaves(jcfg)
    model = T.Transformer(cfg, device="meta")
    decayed, seen = set(), set()
    for name, p in model.named_parameters():
        head, _, tail = name.partition(".")
        path = f"{head}.{tail.split('.', 1)[1]}" if head == "blocks" else name
        seen.add(path)
        assert adamw.reference_ndim(name, p) == len(shapes[path].shape), name
        if adamw.reference_ndim(name, p) >= 2:
            decayed.add(path)
    assert seen == set(shapes)
    assert decayed == {p for p, l in shapes.items() if len(l.shape) >= 2}
    assert {"blocks.time.u_bonus", "blocks.time.decay_base", "blocks.time.mu_base",
            "blocks.channel.mu_k", "blocks.channel.mu_r", "blocks.time.ln_x.scale",
            "blocks.ln1.scale", "blocks.ln2.scale"} <= decayed
    assert set(shapes) - decayed == {"ln_f.scale"}


def test_remat_per_block_equals_none(monkeypatch):
    """Checkpointing each block recomputes the same block: one checkpoint a
    block, the loss equal and every gradient equal bit for bit to the
    un-checkpointed run's (T = 64 and T = 40: the chunked form and the
    sequential scan)."""
    n = []
    plain = torch.utils.checkpoint.checkpoint

    def counted(*a, **kw):
        n.append(None)
        return plain(*a, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    for t in (64, 40):
        out = {}
        for remat in ("block", "none"):
            n.clear()
            cfg, jcfg = _cfgs(remat=remat)
            _, model = _carried(cfg, jcfg)
            batch = _batch(cfg, t=t)
            loss, _ = T.lm_loss(model, batch["tokens"], batch["labels"])
            out[remat] = (loss, torch.autograd.grad(loss, list(model.parameters())))
            assert len(n) == (cfg.n_layers if remat == "block" else 0)
        assert torch.equal(out["block"][0], out["none"][0])
        for a, b in zip(out["block"][1], out["none"][1]):
            assert torch.equal(a, b)


def test_forced_mode_and_algorithm_reach_the_block_recompute(monkeypatch):
    """``ops.forced("ref", algorithm="sequential")`` set around the forward
    must hold in each block's recompute, which runs from the backward pass
    on another thread (autograd's device thread on the card): every norm
    (3 a block, ``ln_f`` once) and every scan of the forward and of the
    recompute runs under it, the scans on the sequential form at T = 64,
    and ``recomputing()`` is set in the recompute only."""
    norms, scans = [], []
    plain_norm, plain_scan, plain_chunked = tref.rmsnorm, tref.rwkv6_scan, tref.rwkv6_chunked

    def norm_spy(x, w, eps=1e-6):
        norms.append((ops.current_mode(), T.recomputing()))
        return plain_norm(x, w, eps)

    def scan_spy(*a, **kw):
        scans.append(("sequential", ops.current_algorithm(), T.recomputing()))
        return plain_scan(*a, **kw)

    def chunked_spy(*a, **kw):
        scans.append(("chunked", ops.current_algorithm(), T.recomputing()))
        return plain_chunked(*a, **kw)

    monkeypatch.setattr(tref, "rmsnorm", norm_spy)
    monkeypatch.setattr(tref, "rwkv6_scan", scan_spy)
    monkeypatch.setattr(tref, "rwkv6_chunked", chunked_spy)
    cfg, jcfg = _cfgs()
    _, model = _carried(cfg, jcfg)
    batch = _batch(cfg)
    with ops.forced("ref", algorithm="sequential"):
        loss, _ = T.lm_loss(model, batch["tokens"], batch["labels"])
    nl = cfg.n_layers
    assert len(norms) == 3 * nl + 1 and len(scans) == nl
    result = {}
    th = threading.Thread(target=lambda: result.update(
        g=torch.autograd.grad(loss, list(model.parameters()))))
    th.start()
    th.join(timeout=120)
    assert not th.is_alive() and "g" in result
    assert {m for m, _ in norms} == {"ref"}
    assert [r for _, r in norms] == [False] * (3 * nl + 1) + [True] * (3 * nl)
    assert scans == [("sequential", "sequential", False)] * nl + [
        ("sequential", "sequential", True)] * nl


@pytest.mark.parametrize("seq,microbatches", [(64, 1), (40, 2)])
def test_train_steps_match_jax(seq, microbatches):
    """Two ``build_train_step`` steps (AdamW with weight decay, the
    schedule warmed up in one step) against the JAX package's jitted step:
    the loss, the grad norm, the learning rate and every parameter (T =
    64: the chunked form; T = 40 in 2 microbatches: the sequential
    scan)."""
    cfg, jcfg = _cfgs()
    jp, model = _carried(cfg, jcfg)
    opt = dict(lr=1e-3, weight_decay=0.1)
    kw = dict(microbatches=microbatches, total_steps=10, warmup_steps=1)
    jstep = jax.jit(jbuild_train_step(jcfg, JAdamWConfig(**opt), **kw))
    tstep = build_train_step(cfg, AdamWConfig(**opt), **kw)
    js = jadamw_init(jp, JAdamWConfig(**opt))
    ts = adamw_init(dict(model.named_parameters()), AdamWConfig(**opt))
    steps = 2
    for step in range(steps):
        batch = _batch(cfg, b=4, t=seq, step=step)
        jp, js, jm = jstep(jp, js, _jbatch(batch), jnp.asarray(step))
        model, ts, tm = tstep(model, ts, batch, step)
        for key in ("loss", "lm_loss", "grad_norm", "lr", "total_loss"):
            rtol = 5e-5 if key == "grad_norm" and step else 1e-5
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rtol, atol=1e-9,
                                       err_msg=f"step {step} {key}")
    g, w = _flat(convert.lm_params_to_numpy(model)), _flat(jax.tree.map(np.asarray, jp))
    assert g.keys() == w.keys()
    for k in w:
        err = np.abs(g[k] - w[k])
        tight = err <= max(1e-5 * float(np.max(np.abs(w[k]))) + 1e-7, 1e-3 * opt["lr"] * steps)
        assert (~tight).sum() <= max(1, int(1e-3 * tight.size)), (k, tight.mean(), err.max())
        assert err.max() <= 2 * opt["lr"] * steps, (k, err.max())
    # The decayed decay_base (a vector in the port, a stacked matrix in the
    # reference) moved by its decay as well as its gradient.
    assert not np.array_equal(
        g["blocks.time.decay_base"],
        convert.random_lm_tree(cfg, 0)["blocks"]["time"]["decay_base"])


def test_train_launcher_runs_rwkv6_on_cpu(capsys):
    """``launch.train`` trains the ssm smoke config with PowerSim in the
    loop."""
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", "rwkv6-7b", "--steps", "2", "--device", "cpu", "--power-sim"])
    out = capsys.readouterr().out
    assert "'step': 0" in out and "'step': 1" in out and "power:" in out
