"""Parity of the port's training slice with the JAX package, on the CPU.

The same parameters (``convert.random_lm_tree``, numpy, seeded), batches
and gradients go through ``repro.optim`` / ``repro.train`` /
``repro.power.integration`` and through their ports, whose kernels run
their plain versions on CPU tensors; the port's trees come back through
``convert.lm_params_to_numpy`` / ``lm_tree_to_numpy``.  The smoke configs
are float32.  Tolerances and their reasons:

* AdamW and the schedule: float32 elementwise math on identical inputs;
  XLA contracts multiply-adds and folds constant divisions, PyTorch does
  neither, so updated parameters and moments agree to a few float32 ulps
  (2e-6 of each leaf's scale); the global norm sums its squares in
  another order (1e-6 relative);
* losses and gradients: the forward and backward sum in other orders
  (matmuls, softmax, the reference's masked vocab sum against the port's
  gather): 1e-5 relative on the loss, gradients 1e-4 of each leaf's scale
  (measured ~1e-6);
* train steps: AdamW normalises each gradient element, ``m / (sqrt(v) +
  eps)``; where an element's gradient is within its float32 noise (~1e-6
  of the leaf's gradient scale) of ``eps`` = 1e-8, that noise moves the
  element's update by up to ``lr`` per step (a sign flip: ``2 lr``).  So
  after three steps at least 99.9 % of each leaf's elements are held to
  1e-5 of the leaf's scale plus 1e-7 (measured: all but 2 of 16384 in one
  leaf), and every element to ``2 lr`` per step;
* PowerSim: rendered traces to 1e-6 (erfinv rounding of the noise; the
  segment lookup is exact); the report's ramps, SoC and wear to 1e-4
  relative (the controller's float32 QP sums in another order); the
  worst spectral line to 2e-2 relative, since the reference's float32
  Goertzel bank drifts from the exact line (ROADMAP queue 3; 0.5 %
  measured here) where the port sums each chunk's lines in float64.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.data import DataConfig as JDataConfig, SyntheticLMDataset as JDataset
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamWConfig, adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim.schedules import cosine_schedule as jcosine, linear_warmup as jwarmup
from repro.power import integration as JI, phases as JP, scenario as JSC
from repro.core import compliance as JC
from repro.train.step import build_train_step as jbuild_train_step
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.core import compliance as TC
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.kernels import ops, ref as tref
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedules import cosine_schedule, linear_warmup
from repro_torch.power import integration as TI, phases as TP, scenario as TSC
from repro_torch.train import (
    Checkpointer, PowerAwareCheckpointer, StragglerMonitor, TrainConfig, build_train_step,
    reassign_shards, train,
)

torch.set_num_threads(1)

DENSE_ARCHS = ("llama3_2_1b", "qwen1_5_4b", "chatglm3_6b", "stablelm_12b", "chameleon_34b")


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _trees_close(got: dict, want: dict, rel: float, atol: float = 0.0, what: str = ""):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        scale = float(np.max(np.abs(w[k]))) or 1.0
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=rel * scale + atol,
                                   err_msg=f"{what} {k}")


def _split_grads(tree: dict, cfg) -> dict:
    """A gradient tree in the JAX layout as a dict keyed by the port's
    parameter names (blocks unstacked)."""
    out = {}
    for path, a in _flat(tree).items():
        if path.startswith("blocks."):
            rest = path[len("blocks."):]
            for i in range(cfg.n_layers):
                out[f"blocks.{i}.{rest}"] = torch.from_numpy(np.array(a[i]))
        else:
            out[path] = torch.from_numpy(np.array(a))
    return out


def _batch(cfg, b=4, t=16, seed=0):
    ds = SyntheticLMDataset(DataConfig(seed=seed, batch=b, seq_len=t, vocab_size=cfg.vocab_size))
    return ds.batch_at(3)


# -------------------------------------------------------------- optimizer --


def test_adamw_matches_jax_and_decays_stacked_norm_scales():
    """Two clipped AdamW updates with weight decay: every leaf, both
    moments and the grad norm match JAX's.  Norm scales with a zero
    gradient move by decay alone: the in-block scales (``(n_layers, d)``
    matrices in the reference's layout) decay, ``ln_f`` does not."""
    cfg = smoke_config("llama3_2_1b")
    tree = convert.random_lm_tree(cfg, 0)
    rng = np.random.default_rng(1)
    gtrees = []
    for _ in range(2):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.05, tree)
        for blk in ("ln1", "ln2"):
            g["blocks"][blk]["scale"][:] = 0.0
        g["ln_f"]["scale"][:] = 0.0
        gtrees.append(g)
    jcfg = JAdamWConfig(lr=1e-2, weight_decay=0.1)
    jp, js = _jtree(tree), jadamw_init(_jtree(tree), jcfg)
    model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    params = dict(model.named_parameters())
    tst = adamw_init(params, AdamWConfig(lr=1e-2, weight_decay=0.1))
    for g in gtrees:
        jp, js, jm = jadamw_update(_jtree(g), js, jp, jcfg, 0.5)
        _, tst, tm = adamw_update(_split_grads(g, cfg), tst, params,
                                  AdamWConfig(lr=1e-2, weight_decay=0.1), 0.5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
    _trees_close(convert.lm_params_to_numpy(model), jax.tree.map(np.asarray, jp), 2e-6,
                 what="params")
    _trees_close(convert.lm_tree_to_numpy(tst.m, cfg), jax.tree.map(np.asarray, js.m), 2e-6,
                 what="m")
    _trees_close(convert.lm_tree_to_numpy(tst.v, cfg), jax.tree.map(np.asarray, js.v), 2e-6,
                 what="v")
    assert int(tst.step) == int(js.step) == 2
    decayed = 1.0 - 1e-2 * 0.5 * 0.1  # one decay step of a unit scale
    assert float(model.blocks[1].ln1.scale[0].detach()) == pytest.approx(decayed**2, rel=1e-6)
    assert float(np.asarray(jp["blocks"]["ln1"]["scale"])[1, 0]) == pytest.approx(decayed**2, rel=1e-6)
    assert torch.all(model.ln_f.scale == 1.0)


def test_adamw_bf16_state_dtype():
    params = {"w": torch.ones(4, 4, requires_grad=True)}
    st = adamw_init(params, AdamWConfig(state_dtype="bfloat16"))
    _, st, _ = adamw_update({"w": torch.full((4, 4), 0.5)}, st, params,
                            AdamWConfig(state_dtype="bfloat16"))
    assert st.m["w"].dtype == torch.bfloat16 and st.v["w"].dtype == torch.bfloat16


def test_schedules_match_jax():
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(cosine_schedule(step, 100, 10)),
                                   float(jcosine(step, 100, 10)), rtol=2e-7)
        np.testing.assert_allclose(float(cosine_schedule(torch.tensor(step), 100, 0, 0.2)),
                                   float(jcosine(step, 100, 0, 0.2)), rtol=2e-7)
        np.testing.assert_allclose(float(linear_warmup(step, 7)), float(jwarmup(step, 7)),
                                   rtol=2e-7)


def test_synthetic_batches_equal_jax():
    for cfg in (DataConfig(), DataConfig(seed=3, batch=3, seq_len=40, vocab_size=128256)):
        jds = JDataset(JDataConfig(**dataclasses.asdict(cfg)))
        ds = SyntheticLMDataset(cfg)
        for step in (0, 1, 17):
            got, want = ds.batch_at(step), jds.batch_at(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    it = SyntheticLMDataset(DataConfig(batch=2, seq_len=8)).iterate(start_step=5)
    first = next(it)
    it.close()
    assert torch.equal(first["tokens"], SyntheticLMDataset(DataConfig(batch=2, seq_len=8))
                       .batch_at(5)["tokens"])


# ------------------------------------------------------------ loss, steps --


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    cfg, jcfg = smoke_config(arch), jsmoke(arch)
    tree = convert.random_lm_tree(cfg, 0)
    batch = _batch(cfg, b=2, t=12)
    labels = batch["labels"].clone()
    labels[0, :3] = -100  # ignored positions
    (jl, jm), jg = jax.value_and_grad(JT.lm_loss, has_aux=True)(
        _jtree(tree), jcfg, jnp.asarray(batch["tokens"].numpy()), jnp.asarray(labels.numpy()))
    model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    loss, metrics = T.lm_loss(model, batch["tokens"], labels)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert int(metrics["tokens"]) == int(jm["tokens"]) == 21
    assert float(metrics["total_loss"]) == float(loss)
    _trees_close(convert.lm_tree_to_numpy(dict(zip(names, grads)), cfg), jax.tree.map(np.asarray, jg), 1e-4,
                 what=f"{arch} grad")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(microbatches):
    """Three steps of ``build_train_step`` from the same tree, batches and
    AdamW (weight decay on) as the JAX package's jitted step."""
    cfg, jcfg = smoke_config("llama3_2_1b"), jsmoke("llama3_2_1b")
    tree = convert.random_lm_tree(cfg, 0)
    opt = dict(lr=1e-3, weight_decay=0.1)
    kw = dict(microbatches=microbatches, total_steps=10, warmup_steps=1)
    jstep = jax.jit(jbuild_train_step(jcfg, JAdamWConfig(**opt), **kw))
    tstep = build_train_step(cfg, AdamWConfig(**opt), **kw)
    jp = _jtree(tree)
    js = jadamw_init(jp, JAdamWConfig(**opt))
    model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    ts = adamw_init(dict(model.named_parameters()), AdamWConfig(**opt))
    ds = SyntheticLMDataset(DataConfig(batch=4, seq_len=16, vocab_size=cfg.vocab_size))
    for step in range(3):
        batch = ds.batch_at(step)
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        jp, js, jm = jstep(jp, js, jb, jnp.asarray(step))
        model, ts, tm = tstep(model, ts, batch, step)
        for key in ("loss", "lm_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                       err_msg=f"step {step} {key}")
        assert int(tm["tokens"]) == int(jm["tokens"])
    g, w = _flat(convert.lm_params_to_numpy(model)), _flat(jax.tree.map(np.asarray, jp))
    assert g.keys() == w.keys()
    for k in w:
        err = np.abs(g[k] - w[k])
        tight = err <= 1e-5 * float(np.max(np.abs(w[k]))) + 1e-7
        assert tight.mean() >= 0.999, (k, tight.mean())
        assert err.max() <= 2 * opt["lr"] * 3, (k, err.max())


def test_remat_block_equals_none():
    """Activation checkpointing recomputes the same blocks: loss and every
    gradient equal the un-checkpointed run's, and each block's norms and
    attention run twice."""
    base = smoke_config("llama3_2_1b")
    tree = convert.random_lm_tree(base, 0)
    batch = _batch(base)
    out = {}
    for remat in ("block", "none"):
        cfg = dataclasses.replace(base, remat=remat)
        model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
        loss, _ = T.lm_loss(model, batch["tokens"], batch["labels"])
        out[remat] = (loss, torch.autograd.grad(loss, list(model.parameters())))
    assert torch.equal(out["block"][0], out["none"][0])
    for a, b in zip(out["block"][1], out["none"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_forced_mode_reaches_the_recompute(monkeypatch):
    """``ops.forced("ref")`` set around the forward must hold in the
    checkpointed blocks' recompute, which runs from the backward pass on
    another thread (autograd's device thread on the card), where the
    caller's context variable is not set."""
    seen = []
    plain = tref.rmsnorm

    def spy(x, w, eps=1e-6):
        seen.append(ops.current_mode())
        return plain(x, w, eps)

    monkeypatch.setattr(tref, "rmsnorm", spy)
    cfg = smoke_config("llama3_2_1b")
    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, 0), cfg, device="cpu")
    batch = _batch(cfg)
    with ops.forced("ref"):
        loss, _ = T.lm_loss(model, batch["tokens"], batch["labels"])
    n_forward = len(seen)
    assert n_forward == 2 * cfg.n_layers + 1
    result = {}
    th = threading.Thread(target=lambda: result.update(
        g=torch.autograd.grad(loss, list(model.parameters()))))
    th.start()
    th.join(timeout=120)
    assert not th.is_alive() and "g" in result
    assert len(seen) == n_forward + 2 * cfg.n_layers  # the blocks' norms again
    assert seen == ["ref"] * len(seen)


# ------------------------------------------------------------------ loop --


def test_train_loop_loss_decreases():
    cfg = smoke_config("llama3_2_1b")
    res = train(cfg, DataConfig(batch=8, seq_len=64, vocab_size=cfg.vocab_size),
                AdamWConfig(lr=3e-3), TrainConfig(steps=60, log_every=30), device="cpu")
    assert res["last_loss"] < res["first_loss"] * 0.95
    assert [r["step"] for r in res["history"]] == [0, 30, 59]


def test_train_loop_checkpoint_resume(tmp_path):
    cfg = smoke_config("llama3_2_1b")
    dc = DataConfig(batch=4, seq_len=32, vocab_size=cfg.vocab_size)
    d = str(tmp_path / "ckpt")
    r1 = train(cfg, dc, AdamWConfig(lr=1e-3),
               TrainConfig(steps=6, checkpoint_every=3, checkpoint_dir=d, log_every=2),
               device="cpu")
    ck = Checkpointer(d)
    assert ck.latest_step() == 5
    params = dict(r1["params"].named_parameters())
    step, (saved, st) = ck.restore(None, (params, r1["opt_state"]))
    assert step == 5 and int(st.step) == 6
    for n, p in params.items():
        assert torch.equal(saved[n], p.detach())
    r2 = train(cfg, dc, AdamWConfig(lr=1e-3),
               TrainConfig(steps=8, checkpoint_every=3, checkpoint_dir=d, log_every=2,
                           resume=True), device="cpu")
    assert r2["history"][0]["step"] >= 6
    assert int(r2["opt_state"].step) == 8


def test_checkpoint_roundtrip_bf16_and_layout(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    ck.save(10, tree, blocking=True)
    step, restored = ck.restore(None, tree)
    assert step == 10
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    d = tmp_path / "step-000000010"
    assert sorted(p.name for p in d.iterdir()) == ["arrays.npz", "manifest.json"]
    with np.load(d / "arrays.npz") as z:
        assert sorted(z.files) == ["a", "b/c"] and z["b/c"].dtype == np.float32
    with pytest.raises(ValueError, match="shape"):
        ck.restore(None, {"a": torch.zeros(3), "b": {"c": torch.ones(4)}})


def test_checkpoint_atomic_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": torch.zeros(3)}, blocking=True)
    assert ck.all_steps() == [3, 4]
    (tmp_path / "tmp-99").mkdir()  # a stale partial write is not a checkpoint
    assert ck.latest_step() == 4


def test_checkpoint_async_then_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(8)})
    ck.wait()
    assert ck.all_steps() == [1]


def test_straggler_monitor_and_shards():
    mon = StragglerMonitor(n_hosts=8, patience=3)
    for _ in range(2):
        assert mon.observe([1.0] * 8) == []
    for _ in range(3):
        out = mon.observe([1.0] * 7 + [3.0])
    assert out == [7]
    blip = StragglerMonitor(n_hosts=4, patience=3)
    blip.observe([1, 1, 1, 5.0])
    for _ in range(5):
        out = blip.observe([1, 1, 1, 1.0])
    assert out == []
    blip.mark_power_degraded(2)
    assert 2 in blip.observe([1.0] * 4)
    m = reassign_shards(16, [0, 2, 3])
    assert sorted(s for shards in m.values() for s in shards) == list(range(16))


def test_power_aware_emergency_checkpoint(tmp_path):
    ck = PowerAwareCheckpointer(Checkpointer(str(tmp_path)), every_steps=1000,
                                soc_window=(0.2, 0.8))
    tree = {"w": torch.ones(2)}
    assert ck.maybe_save(5, tree, soc=0.5) is None
    assert ck.maybe_save(6, tree, soc=0.05) == "emergency"
    ck.ckpt.wait()
    assert ck.ckpt.all_steps() == [6]
    assert ck.maybe_save(7, tree, soc=0.05) is None  # cooldown


# -------------------------------------------------------------- PowerSim --


def test_phase_timeline_render_matches_jax():
    durs = np.array([0.37, 0.05, 1.2, 0.001, 0.8])
    pows = np.array([1.0, 0.3, 0.9, 0.1, 0.6], np.float32)
    per_rack = np.stack([pows, pows[::-1], 0.5 * pows])
    for p, kw in ((pows, dict(edge_time_s=0.1, noise_seed=7)), (per_rack, dict(edge_time_s=0.0)),
                  (pows, dict(edge_time_s=0.05))):
        js = JSC.from_phase_timeline(durs, p, 400.0, **kw)
        ts = TSC.from_phase_timeline(durs, p, 400.0, device="cpu", **kw)
        assert ts.total_samples == js.total_samples and ts.edge_width == js.edge_width
        assert ts.n_racks == js.n_racks
        got, dt = TSC.render_trace(ts)
        want, jdt = JSC.render_trace(js)
        assert dt == jdt
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        parts = [TSC.render(ts, t0, min(300, ts.total_samples - t0))
                 for t0 in range(0, ts.total_samples, 300)]
        assert torch.equal(torch.cat(parts), got)
    cost = JP.StepCost(flops=5e18, hbm_bytes=2e15, collective_bytes=5e14)
    js = JP.training_scenario(cost, JP.HardwareConstants(chips=256), JP.PhaseModel(), 8, 100.0)
    ts = TP.training_scenario(TP.StepCost(5e18, 2e15, 5e14), TP.HardwareConstants(chips=256),
                              TP.PhaseModel(), 8, 100.0, device="cpu")
    np.testing.assert_allclose(TSC.render_trace(ts)[0].numpy(), np.asarray(JSC.render_trace(js)[0]),
                               rtol=0, atol=1e-6)


def test_online_bank_matches_jax():
    for dt, fc in ((0.005, 2.0), (0.002, 0.5)):
        assert dataclasses.asdict(TC.make_online_bank(dt, fc)) == \
            dataclasses.asdict(JC.make_online_bank(dt, fc))


def test_power_sim_report_matches_jax():
    """Four steps (one with a checkpoint stall) through both PowerSims: a
    step of ~4 s of compute and ~9 s of exposed collective."""
    kw = dict(flops=1e17, hbm_bytes=2e14, collective_bytes=1e14)
    jsim = JI.PowerSim(JP.StepCost(**kw), JP.HardwareConstants(chips=256), JP.PhaseModel())
    tsim = TI.PowerSim(TP.StepCost(**kw), TP.HardwareConstants(chips=256), TP.PhaseModel(),
                       device="cpu")
    for stall in (False, True, False, False):
        jsim.on_step(checkpoint_stall=stall)
        tsim.on_step(checkpoint_stall=stall)
    got, want = tsim.report(), jsim.report()
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], bool):
            assert got[k] == want[k], k
        else:
            rtol = 2e-2 if k == "grid_worst_hf" else 1e-4
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-9, err_msg=k)
    assert got["grid_max_ramp"] <= 0.1 + 1e-3 < got["rack_max_ramp"]
    assert 0.1 <= got["final_soc"] <= 0.9


def test_train_loop_with_power_sim(monkeypatch):
    """EasyRider in the loop (the reference's integration test): the
    conditioned grid meets the ramp limit while training runs, and one
    ``pdu_health``/``admm_step`` call is made per controller interval."""
    from repro_torch.kernels import ref as kref

    calls = []
    cfg = smoke_config("llama3_2_1b")
    sim = TI.PowerSim(TP.StepCost(flops=1e17, hbm_bytes=2e14, collective_bytes=1e14),
                      TP.HardwareConstants(chips=256), TP.PhaseModel(checkpoint_every_steps=0),
                      device="cpu")
    orig = kref.pdu_health_sim
    monkeypatch.setattr(kref, "pdu_health_sim", lambda *a, **k: calls.append(1) or orig(*a, **k))
    res = train(cfg, DataConfig(batch=2, seq_len=16, vocab_size=cfg.vocab_size),
                AdamWConfig(), TrainConfig(steps=8, log_every=4), power_sim=sim, device="cpu")
    rep = res["power_report"]
    assert rep["grid_max_ramp"] <= 0.1 + 1e-3
    assert rep["rack_max_ramp"] > rep["grid_max_ramp"]
    assert 0.1 <= rep["final_soc"] <= 0.9
    durs, pows = TP.step_phases(sim.cost, sim.hw, sim.model)
    per_step = TSC.from_phase_timeline(durs, pows, 200.0, device="cpu").total_samples
    assert len(calls) == (8 * per_step) // sim._k
