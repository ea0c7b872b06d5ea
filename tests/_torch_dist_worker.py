"""One rank of a gloo world on the CPU for ``tests/test_torch_distributed.py``,
``tests/test_torch_fsdp.py``, ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_families.py``.

    python tests/_torch_dist_worker.py RANK WORLD STORE OUT_DIR [SUITE]

Joins the world through the ``file://`` store ``STORE`` (a 120 s timeout
on every collective), runs the world's cases (``WORLDS[WORLD]``, or with
SUITE ``fsdp`` ``FSDP_WORLDS[WORLD]``, with ``tp`` ``TP_WORLDS[WORLD]`` and
with ``tpf`` ``TPF_WORLDS[WORLD]``, whose worlds share
``OUT_DIR/../shared``) and writes
``OUT_DIR/rank{RANK}.pt``: a dict of named tensors, flags and error
messages that the test module asserts, case by case.  Rank 0 also runs
each case's one-process reference (the sequential region engine, the
unsharded campus, the one-rank service, the unsharded training step) and
stores it beside its result.  Imports torch and the port only; every
process runs one thread.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import convert, sharding  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import compliance, fleet, grid, pdu  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.power import faults as FLT, scenario as SC  # noqa: E402
from repro_torch.serve import ConditionerService  # noqa: E402
from repro_torch.sharding import fsdp, rules  # noqa: E402
from repro_torch.train import Checkpointer, TrainConfig, build_train_step, train  # noqa: E402
from repro_torch.train.loop import audio_frames  # noqa: E402

DEV = "cpu"
HZ = 50.0
CAMPUS_KW = dict(duration_s=22.5, sample_hz=HZ, seed=3, fault_at_s=12.0, noise_seed=2)
ARCHS = ("llama3_2_1b", "deepseek_v3_671b", "chatglm3_6b", "whisper_large_v3")
SPEC = compliance.GridSpec.create(device=DEV)
# Region windows: 4 intervals of 5 s a chunk at 50 Hz; the split falls on a
# chunk boundary (1000 samples) and the region's 30 s end leaves a ragged
# tail of 500 of 1500 samples.  The campus: 2 intervals a chunk, 1125
# samples (two chunks and a ragged 125), split at 500.
REGION_CHUNK_INTERVALS = 4
SPLIT = 1000
CAMPUS_SPLIT = 500


def region(n_campuses: int, stagger: bool):
    return grid.checkpoint_region(n_campuses, 4, duration_s=30.0, sample_hz=HZ, stagger=stagger,
                                  noise_seed=3, device=DEV)


def hetero_region():
    camp = lambda n, seed: SC.mixed_campus(n, ("llama3_2_1b", "whisper_large_v3"),
                                           duration_s=30.0, sample_hz=HZ, seed=seed,
                                           noise_seed=7, device=DEV)
    return grid.region([camp(3, 2), camp(5, 4)])


def campus(faulty: bool):
    s = SC.mixed_campus(16, ARCHS, device=DEV, **CAMPUS_KW)
    if faulty:
        proc = FLT.FaultProcess.create(rack_mtbf_s=40.0, rack_mttr_s=6.0, ess_mtbf_s=30.0,
                                       ess_mttr_s=8.0, sensor_mtbf_s=40.0, sensor_mttr_s=3.0)
        sched = FLT.sample_schedule(proc, 16, s.total_samples, HZ, seed=7, device=DEV)
        # An ESS outage across the split and NaN samples at t = 0.
        sched = FLT.inject_episodes(sched, ess=[(1, 325, 650)], sensor=[(3, 0, 75)])
        s = SC.attach_faults(s, sched)
    cfg = pdu.make_pdu(sample_dt=1.0 / HZ, track_health=True, degraded_mode=faulty,
                       safemode=faulty, device=DEV)
    return s, cfg


def region_cfg():
    return pdu.make_pdu(sample_dt=1.0 / HZ, device=DEV)


def flat(prefix: str, x, out: dict) -> None:
    """Every tensor of a result (reports, state, per-campus results) under
    its path."""
    if isinstance(x, torch.Tensor):
        out[prefix] = x.detach().clone()
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for f, v in zip(x._fields, x):
            if f not in ("grid_spec", "bank"):
                flat(f"{prefix}.{f}", v, out)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            flat(f"{prefix}.{i}", v, out)
    elif hasattr(x, "__dataclass_fields__"):
        for f in x.__dataclass_fields__:
            flat(f"{prefix}.{f}", getattr(x, f), out)


def error(fn) -> str:
    """``TypeName: message`` of what ``fn()`` raises, or ``"none"``."""
    try:
        fn()
    except (TypeError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "none"


def region_cases(mesh, n_campuses: int, tag: str, rank: int, out: dict) -> None:
    """Synchronized and staggered, one window and a window split at a
    chunk boundary and resumed, through the facade with the mesh."""
    cfg = region_cfg()
    for stagger in (False, True):
        reg = region(n_campuses, stagger)
        name = f"{tag}/{'staggered' if stagger else 'synchronized'}"
        run = lambda m, **s: fleet.condition(reg, cfg, SPEC, device=DEV, mesh=m, stream=dict(
            chunk_intervals=REGION_CHUNK_INTERVALS, **s))
        flat(f"{name}/whole", run(mesh), out)
        first = run(mesh, stop_sample=SPLIT)
        flat(f"{name}/resumed", run(mesh, state=first.state, start_sample=SPLIT), out)
        if rank == 0:
            flat(f"{name}/whole/ref", run(None), out)
            first = run(None, stop_sample=SPLIT)
            flat(f"{name}/resumed/ref", run(None, state=first.state, start_sample=SPLIT), out)


def campus_cases(mesh, tag: str, rank: int, out: dict) -> None:
    """The 16-rack campus rack-sharded on the host and scanned engines,
    clean and degraded (a fault schedule, safe mode); the scanned engine
    also split at a chunk boundary and resumed."""
    for faulty in (False, True):
        s, cfg = campus(faulty)
        for engine in ("host", "scanned"):
            name = f"{tag}/{'faulty' if faulty else 'clean'}/{engine}"
            run = lambda m, **kw: fleet.condition(s, cfg, SPEC, engine=engine, device=DEV, mesh=m,
                                                  qp_iters=30, stream=dict(chunk_intervals=2, **kw))
            flat(f"{name}/whole", run(mesh), out)
            if rank == 0:
                flat(f"{name}/whole/ref", run(None), out)
            if engine == "scanned":
                first = run(mesh, stop_sample=CAMPUS_SPLIT)
                flat(f"{name}/resumed", run(mesh, state=first.state, start_sample=CAMPUS_SPLIT),
                     out)


def service_cases(mesh, tag: str, rank: int, out: dict, shared: Path) -> None:
    """One window of a region service with the mesh, a checkpoint, the next
    window, and that window again from the checkpoint in a new service."""
    cfg = region_cfg()
    reg = region(4, False)
    for m, suffix in ((mesh, ""), (None, "/ref")):
        if m is None and rank != 0:
            continue
        log = shared / f"audit{suffix.replace('/', '_')}.jsonl"
        svc = ConditionerService(cfg, reg, SPEC, chunk_intervals=4, mesh=m, audit_path=log)
        flat(f"{tag}/window{suffix}", svc.advance(), out)
        ck = svc.checkpoint(shared / f"ck{suffix.replace('/', '_')}")
        flat(f"{tag}/live{suffix}", svc.advance(), out)
        again = ConditionerService(cfg, reg, SPEC, chunk_intervals=4, mesh=m)
        again.restore(ck)
        flat(f"{tag}/resumed{suffix}", again.advance(), out)
        out[f"{tag}/writes_log{suffix}"] = torch.tensor(svc.audit.path is not None)
        if svc.audit.path is not None:
            out[f"{tag}/log_lines{suffix}"] = torch.tensor(sum(1 for _ in open(log)))
        out[f"{tag}/events{suffix}"] = torch.tensor(len(svc.audit))


def error_cases(mesh, out: dict) -> None:
    """The reference's ValueErrors of the sharded engines, region_mesh and
    the service, on a (4, 1) region mesh."""
    cfg = region_cfg()
    reg3, reg4 = region(3, False), region(4, False)
    sched = FLT.schedule_from_episodes(4, rack=[(0, 10, 20)], device=DEV)
    faulty = grid.region([SC.attach_faults(c, sched) for c in reg4.campuses])
    st = fleet.condition(reg4, cfg, SPEC, device=DEV, stream=dict(stop_sample=500)).state
    rect = sharding.make_mesh((4,), ("data",), device_type=DEV)
    cases = {
        "no_campus_axis": lambda: grid.condition_region_sharded(cfg, reg4, SPEC, rect),
        "campus_count": lambda: grid.condition_region_sharded(cfg, reg3, SPEC, mesh),
        "states_count": lambda: grid.condition_region_sharded(cfg, reg4, SPEC, mesh,
                                                               states=st[:3]),
        "states_partial": lambda: grid.condition_region_sharded(
            cfg, reg4, SPEC, mesh, states=(st[0], None, st[2], st[3]), start_sample=500),
        "rate": lambda: grid.condition_region_sharded(
            pdu.make_pdu(sample_dt=1.0 / 100.0, device=DEV), reg4, SPEC, mesh),
        "faults": lambda: grid.condition_region_sharded(cfg, faulty, SPEC, mesh),
        "region_mesh_tile": lambda: sharding.region_mesh(3, device_type=DEV),
        "region_mesh_positive": lambda: sharding.region_mesh(0, device_type=DEV),
        "service_scenario": lambda: ConditionerService(cfg, reg4.campuses[0], SPEC, mesh=mesh),
        "oneshot": lambda: fleet.condition(reg4.campuses[0], cfg, SPEC, engine="oneshot",
                                           device=DEV, mesh=rect),
        "uneven_racks": lambda: fleet.condition(
            grid.checkpoint_region(1, 6, duration_s=20.0, sample_hz=HZ, device=DEV).campuses[0],
            cfg, SPEC, device=DEV, mesh=rect),
        "no_rack_axis": lambda: fleet.condition(
            reg4.campuses[0], cfg, SPEC, device=DEV,
            mesh=sharding.make_mesh((4,), ("racks",), device_type=DEV)),
        "fractional_online": lambda: fleet.condition(
            torch.full((500, 8), 0.5), pdu.make_pdu(sample_dt=1.0 / HZ, degraded_mode=True,
                                                    device=DEV),
            SPEC, engine="host", device=DEV, mesh=rect, ess_online=torch.full((8,), 0.5)),
    }
    for name, fn in cases.items():
        out[f"error/{name}"] = error(fn)


def hetero_cases(mesh, tag: str, rank: int, out: dict) -> None:
    """A region of a 3-rack and a 5-rack campus: the reference stacks its
    campuses and refuses it; a rank here runs its campus whole."""
    reg, cfg = hetero_region(), region_cfg()
    flat(f"{tag}/whole", fleet.condition(reg, cfg, SPEC, device=DEV, mesh=mesh), out)
    if rank == 0:
        flat(f"{tag}/whole/ref", fleet.condition(reg, cfg, SPEC, device=DEV), out)


def host_mesh_cases(out: dict) -> None:
    """``launch.mesh.make_host_mesh`` over the world: its shape and this
    rank's coordinates at model parallelism 1, 2 and one above the world."""
    for mp in (1, 2, 8):
        m = lmesh.make_host_mesh(mp, device_type=DEV)
        out[f"hostmesh/{mp}/shape"] = torch.tensor(tuple(m.shape))
        out[f"hostmesh/{mp}/coords"] = torch.tensor([m.get_local_rank(a) for a in ("data", "model")])


def run_case(case: str, world: int, rank: int, out: dict, shared: Path) -> None:
    region = lambda n: sharding.region_mesh(n, device_type=DEV)
    if case == "region4x1":
        region_cases(region(4), 4, case, rank, out)
    elif case == "region2x2":
        region_cases(region(2), 2, case, rank, out)
    elif case.startswith("campus"):
        campus_cases(sharding.make_mesh((world,), ("data",), device_type=DEV), case, rank, out)
    elif case == "service":
        service_cases(region(4), case, rank, out, shared)
    elif case == "errors":
        error_cases(region(4), out)
    elif case == "hetero":
        hetero_cases(region(2), case, rank, out)
    elif case == "hostmesh":
        host_mesh_cases(out)


# The cases each world runs, in order (every rank the same).
WORLDS = {
    4: ("region4x1", "region2x2", "campus4", "service", "errors", "hostmesh"),
    2: ("campus2", "hetero", "hostmesh"),
    1: ("campus1",),
}


# ---------------------------------------------------------------- FSDP --

# The families that train sharded, by their smoke configs (float32).
FSDP_ARCHS = ("llama3_2_1b", "rwkv6_7b", "zamba2_2_7b", "whisper_large_v3")
# The step configurations: (microbatches, gather_small_weights_once).
FSDP_STEPS = ((1, False), (2, True))
FSDP_RUN = dict(batch=4, seq_len=16, steps=2, lr=1e-3, weight_decay=0.1, total_steps=10,
                warmup_steps=1)
# The JAX comparison's run (``_jax_fsdp_reference.py`` runs the reference's
# own sharded step on two host devices with it).
FSDP_REF = dict(arch="llama3_2_1b", seed=0, batch=4, seq_len=16, steps=2, microbatches=2,
                lr=1e-3, weight_decay=0.1, total_steps=10, warmup_steps=1)


def fsdp_batch(cfg, i: int, b: int, t: int, ignore: bool = True) -> dict:
    """Step ``i``'s global batch; with ``ignore`` labels set to -100 so
    that the ranks' rows hold unequal valid counts in every microbatch
    (the loss must divide by the global count).  ``audio``: the reference
    loop's frames."""
    batch = SyntheticLMDataset(DataConfig(batch=b, seq_len=t, vocab_size=cfg.vocab_size)) \
        .batch_at(i)
    if ignore:
        batch["labels"][0, : t // 2] = -100
        batch["labels"][1, :3] = -100
    if cfg.family == "audio":
        batch["frames"] = audio_frames(cfg, b, i, DEV)
    return batch


def fsdp_model(cfg):
    return convert.lm_params_from_numpy(convert.random_lm_tree(cfg, 0), cfg, device=DEV)


def fsdp_run(cfg, mesh, mb: int, once: bool, run: dict = FSDP_RUN, ignore: bool = True) -> dict:
    """``run``'s steps of ``build_train_step`` from ``random_lm_tree(cfg,
    0)``, sharded on ``mesh`` (None: one process): each step's metrics, the
    final parameters and first moments (this rank's shards) and the
    rank's data dims."""
    opt = AdamWConfig(lr=run["lr"], weight_decay=run["weight_decay"])
    step = build_train_step(cfg, opt, microbatches=mb, total_steps=run["total_steps"],
                            warmup_steps=run["warmup_steps"], gather_small_weights_once=once)
    model = fsdp_model(cfg)
    if mesh is not None:
        fsdp.shard_model(model, mesh)
    params = dict(model.named_parameters())
    state = adamw_init(params, opt)
    out = {k: [] for k in ("loss", "lm_loss", "grad_norm", "tokens")}
    for i in range(run["steps"]):
        _, state, m = step(model, state, fsdp_batch(cfg, i, run["batch"], run["seq_len"], ignore),
                           i)
        for k in out:
            out[k].append(m[k].item())
    out = {k: torch.tensor(v, dtype=torch.float64) for k, v in out.items()}
    for n, p in params.items():
        out[f"param/{n}"] = p.detach().clone()
        out[f"m/{n}"] = state.m[n].clone()
        out[f"v/{n}"] = state.v[n].clone()
        info = fsdp.shard_of(p)
        out[f"dim/{n}"] = torch.tensor(-1 if info is None or info.dim is None else info.dim)
    return out


def fsdp_store(out: dict, prefix: str, res: dict) -> None:
    for k, v in res.items():
        out[f"{prefix}/{k}"] = v


def fsdp_shards_case(mesh, rank: int, out: dict) -> None:
    """Each family's model sharded: this rank's parameters; rank 0 also
    the unsharded ones."""
    for arch in FSDP_ARCHS:
        cfg = smoke_config(arch)
        model = fsdp.shard_model(fsdp_model(cfg), mesh)
        for n, p in model.named_parameters():
            out[f"shards/{arch}/param/{n}"] = p.detach().clone()
            d = fsdp.shard_of(p).dim
            out[f"shards/{arch}/dim/{n}"] = torch.tensor(-1 if d is None else d)
        if rank == 0:
            for n, p in fsdp_model(cfg).named_parameters():
                out[f"shards/{arch}/full/{n}"] = p.detach().clone()


def fsdp_steps_case(mesh, rank: int, out: dict) -> None:
    """Every family at each ``FSDP_STEPS`` configuration, sharded; rank 0
    also the one-process run."""
    for arch in FSDP_ARCHS:
        cfg = smoke_config(arch)
        for mb, once in FSDP_STEPS:
            tag = f"steps/{arch}/mb{mb}{'once' if once else ''}"
            fsdp_store(out, tag, fsdp_run(cfg, mesh, mb, once))
            if rank == 0 or mesh is None:
                fsdp_store(out, f"{tag}/ref", fsdp_run(cfg, None, mb, once))


def fsdp_jax_case(mesh, out: dict) -> None:
    """``FSDP_REF``'s run on the mesh (no ignored labels: the JAX side's
    batches are the dataset's), every parameter gathered whole."""
    c = FSDP_REF
    cfg = smoke_config(c["arch"])
    res = fsdp_run(cfg, mesh, c["microbatches"], True, c, ignore=False)
    out["jax/loss"], out["jax/grad_norm"] = res["loss"], res["grad_norm"]
    for k, v in res.items():
        if k.startswith("param/"):
            dim = int(res["dim/" + k[len("param/"):]])
            out["jax/" + k] = v if dim < 0 else rules.all_gather_dim(v, dim,
                                                                     mesh.get_group("data"))


def fsdp_state(model, state) -> dict:
    """``{path: tensor}`` of ``(params, opt_state)``."""
    out = {f"param/{n}": p.detach().clone() for n, p in model.named_parameters()}
    out.update({f"m/{n}": t.clone() for n, t in state.m.items()})
    out.update({f"v/{n}": t.clone() for n, t in state.v.items()})
    out["step"] = state.step.clone()
    return out


def leaf_shard(params: dict, key: str):
    """The ``DataShard`` of the sharded parameter a ``fsdp_state`` key
    (``param/``, ``m/``, ``v/`` + name) holds, or None (replicated, the
    step)."""
    info = fsdp.shard_of(params[key.split("/", 1)[1]]) if "/" in key else None
    return None if info is None or info.dim is None else info


def fsdp_ckpt_case(mesh, rank: int, out: dict, shared: Path) -> None:
    """Checkpoints across worlds, llama smoke.  2 -> 1: the world saves
    after one step; rank 0 restores it unsharded (a world of one) beside
    every leaf gathered whole.  1 -> 2: one process saves its state after
    one step; every rank restores it sharded beside its chunk of that
    state.  A step from the restored 2-rank state against the step without
    the restore."""
    c = FSDP_RUN
    cfg = smoke_config("llama3_2_1b")
    opt = AdamWConfig(lr=c["lr"], weight_decay=c["weight_decay"])
    step = build_train_step(cfg, opt, total_steps=c["total_steps"],
                            warmup_steps=c["warmup_steps"])
    group = mesh.get_group("data")

    def fresh(sharded: bool):
        model = fsdp_model(cfg)
        if sharded:
            fsdp.shard_model(model, mesh)
        return model, adamw_init(dict(model.named_parameters()), opt)

    # 2 -> 1
    model, state = fresh(True)
    params = dict(model.named_parameters())
    _, state, _ = step(model, state, fsdp_batch(cfg, 0, c["batch"], c["seq_len"]), 0)
    ck = Checkpointer(str(shared / "ck2"))
    sh = fsdp.shardings(model, state)
    ck.save(0, (params, state), shardings=sh, blocking=True)
    saved = fsdp_state(model, state)
    whole = {}
    for k, v in saved.items():
        info = leaf_shard(params, k)
        whole[k] = v if info is None else rules.all_gather_dim(v, info.dim, group)
    if rank == 0:
        one, one_state = fresh(False)
        one_params = dict(one.named_parameters())
        _, (got, got_state) = ck.restore(None, (one_params, one_state))
        with torch.no_grad():
            for n, p in one_params.items():
                p.copy_(got[n])
        restored = fsdp_state(one, got_state)
        out["ckpt/2to1/bad"] = [k for k in whole if not torch.equal(restored[k], whole[k])]
        out["ckpt/2to1/leaves"] = len(whole)
    # a step from the saved state, then the same step from its restore
    batch = fsdp_batch(cfg, 1, c["batch"], c["seq_len"])
    _, state, m_live = step(model, state, batch, 1)
    live = fsdp_state(model, state)
    model2, state2 = fresh(True)
    params2 = dict(model2.named_parameters())
    _, (got, state2) = ck.restore(None, (params2, state2), shardings=fsdp.shardings(model2, state2))
    with torch.no_grad():
        for n, p in params2.items():
            p.copy_(got[n])
    out["ckpt/2to2/bad"] = [k for k, v in fsdp_state(model2, state2).items()
                            if not torch.equal(v, saved[k])]
    _, state2, m_again = step(model2, state2, batch, 1)
    again = fsdp_state(model2, state2)
    out["ckpt/resume/bad"] = [k for k in live if not torch.equal(again[k], live[k])] + [
        k for k in ("loss", "grad_norm") if not torch.equal(m_live[k], m_again[k])]
    # 1 -> 2
    one, one_state = fresh(False)
    one_params = dict(one.named_parameters())
    _, one_state, _ = step(one, one_state, fsdp_batch(cfg, 0, c["batch"], c["seq_len"]), 0)
    ck1 = Checkpointer(str(shared / "ck1"))
    if rank == 0:
        ck1.save(0, (one_params, one_state), blocking=True)
    torch.distributed.barrier()
    model3, state3 = fresh(True)
    params3 = dict(model3.named_parameters())
    _, (got, state3) = ck1.restore(None, (params3, state3),
                                   shardings=fsdp.shardings(model3, state3))
    with torch.no_grad():
        for n, p in params3.items():
            p.copy_(got[n])
    want = fsdp_state(one, one_state)
    bad = []
    for k, v in fsdp_state(model3, state3).items():
        info = leaf_shard(params3, k)
        w = want[k] if info is None else fsdp.local_shard(want[k], info.dim, info.size, info.rank)
        if not torch.equal(v, w):
            bad.append(k)
    out["ckpt/1to2/bad"] = bad
    out["ckpt/1to2/leaves"] = len(want)


def fsdp_control_case(mesh, out: dict) -> None:
    """One llama smoke step with the replicated leaves' all-reduce left
    out: the ranks' replicated leaves must then differ (what the equality
    check across ranks catches)."""
    saved = rules.all_reduce_sum
    rules.all_reduce_sum = lambda tensors, group: list(tensors)
    try:
        res = fsdp_run(smoke_config("llama3_2_1b"), mesh, 1, False, dict(FSDP_RUN, steps=1))
    finally:
        rules.all_reduce_sum = saved
    for k, v in res.items():
        if k.startswith("param/") and int(res["dim/" + k[len("param/"):]]) < 0:
            out["control/" + k] = v


# The configs ``train(mesh=)`` runs (the audio one with its global frames).
FSDP_LOOP_ARCHS = ("llama3_2_1b", "whisper_large_v3")


def fsdp_loop_case(mesh, rank: int, out: dict, shared: Path) -> None:
    """``train(mesh=)`` on each ``FSDP_LOOP_ARCHS`` smoke config with
    checkpoints, then resumed from them; rank 0 also ``train()`` in one
    process."""
    for arch in FSDP_LOOP_ARCHS:
        cfg = smoke_config(arch)
        data = DataConfig(batch=4, seq_len=16, vocab_size=cfg.vocab_size)
        opt = AdamWConfig(lr=1e-3)
        tc = dict(steps=3, log_every=1, checkpoint_every=2,
                  checkpoint_dir=str(shared / f"loop_{arch}"))
        tag = f"loop/{arch}"
        res = train(cfg, data, opt, TrainConfig(**tc), device=DEV, mesh=mesh)
        out[f"{tag}/loss"] = torch.tensor([h["loss"] for h in res["history"]],
                                          dtype=torch.float64)
        out[f"{tag}/steps"] = torch.tensor(Checkpointer(tc["checkpoint_dir"]).all_steps())
        again = train(cfg, data, opt, TrainConfig(**dict(tc, steps=4, resume=True)), device=DEV,
                      mesh=mesh)
        out[f"{tag}/resumed_steps"] = torch.tensor([h["step"] for h in again["history"]])
        if rank == 0:
            ref = train(cfg, data, opt, TrainConfig(steps=3, log_every=1), device=DEV)
            out[f"{tag}/ref_loss"] = torch.tensor([h["loss"] for h in ref["history"]],
                                                  dtype=torch.float64)


def fsdp_error_cases(mesh, out: dict) -> None:
    """The refusals: an ssm model whose 3 RWKV heads do not split over a
    "model" axis of 2, a "pod" axis (the model, and the gather-once
    weight), the moe family and MTP under a mesh (the model, ``train`` and
    its sharded decode state), and a batch that does not split over the
    data axis."""
    cfg = smoke_config("llama3_2_1b")
    moe = smoke_config("deepseek_v3_671b")
    rwkv = smoke_config("rwkv6_7b", d_model=192)  # 3 RWKV heads: not on a model axis of 2
    tp = sharding.make_mesh((1, 2), ("data", "model"), device_type=DEV)
    pod = sharding.make_mesh((2, 1, 1), ("pod", "data", "model"), device_type=DEV)
    opt = AdamWConfig()
    model = fsdp.shard_model(fsdp_model(cfg), mesh)
    state = adamw_init(dict(model.named_parameters()), opt)
    odd = fsdp_batch(cfg, 0, 3, 8)
    cases = {
        "model_axis": lambda: fsdp.shard_model(fsdp_model(rwkv), tp),
        "pod_axis": lambda: fsdp.shard_model(fsdp_model(cfg), pod),
        "moe": lambda: fsdp.shard_model(T.init(moe, device=DEV), mesh),
        "moe_train": lambda: train(moe, DataConfig(batch=2, seq_len=8,
                                                   vocab_size=moe.vocab_size),
                                   opt, TrainConfig(steps=1), device=DEV, mesh=mesh),
        "batch": lambda: sharding.shard_batch(odd, mesh),
        "batch_step": lambda: build_train_step(cfg, opt)(model, state, odd, 0),
        "decode": lambda: T.init_decode_state(moe, 2, 8, device=DEV, mesh=mesh),
        "gathered_weight_tp": lambda: sharding.constrain_gathered_weight(
            "embed.embedding", model.embed.embedding, pod),
    }
    for name, fn in cases.items():
        out[f"error/{name}"] = error(fn)


def run_fsdp_case(case: str, world: int, rank: int, out: dict, shared: Path) -> None:
    mesh = lmesh.make_host_mesh(device_type=DEV)
    if case == "shards":
        fsdp_shards_case(mesh, rank, out)
    elif case == "steps":
        fsdp_steps_case(mesh, rank, out)
    elif case == "jax":
        fsdp_jax_case(mesh, out)
    elif case == "ckpt":
        fsdp_ckpt_case(mesh, rank, out, shared)
    elif case == "control":
        fsdp_control_case(mesh, out)
    elif case == "loop":
        fsdp_loop_case(mesh, rank, out, shared)
    elif case == "errors":
        fsdp_error_cases(mesh, out)


FSDP_WORLDS = {
    2: ("shards", "steps", "jax", "ckpt", "control", "loop", "errors"),
    1: ("steps",),
}


# ------------------------------------------------------------------ TP --

# The families that run tensor parallel, by their smoke configs (float32):
# llama (tied readout, 4 / 2 heads), chatglm3 (qkv bias, rope fraction 0.5,
# untied), chameleon (vlm: qk-norm, untied).  At model 4 their 2 KV heads
# do not divide the axis (the gathered-KV route).
TP_ARCHS = ("llama3_2_1b", "chatglm3_6b", "chameleon_34b")
TP_RUN = dict(batch=4, seq_len=16, steps=3, lr=1e-3, weight_decay=0.1, total_steps=10,
              warmup_steps=1)
# Serving: a (2, 8) prompt through the prefill step, then ``decode``
# teacher-forced decode steps.
TP_SERVE = dict(batch=2, prompt=8, decode=3, seed=5)


def tp_batch(cfg, i: int) -> dict:
    """Step ``i``'s global batch, with labels set to -100 so that the data
    ranks' rows hold unequal valid counts; ``audio``: with the reference
    loop's frames."""
    c = TP_RUN
    batch = SyntheticLMDataset(DataConfig(batch=c["batch"], seq_len=c["seq_len"],
                                          vocab_size=cfg.vocab_size)).batch_at(i)
    batch["labels"][0, : c["seq_len"] // 2] = -100
    batch["labels"][3, :3] = -100
    if cfg.family == "audio":
        batch["frames"] = audio_frames(cfg, c["batch"], i, DEV)
    return batch


def tp_frames(cfg):
    """The encoder frames of ``tp_prompts``' requests (float32 numpy), or
    None for a family without an encoder."""
    import numpy as np

    if cfg.family != "audio":
        return None
    rng = np.random.default_rng(TP_SERVE["seed"] + 1)
    return rng.normal(scale=0.02, size=(TP_SERVE["batch"], cfg.encdec.encoder_seq,
                                        cfg.d_model)).astype(np.float32)


def tp_prompts(cfg):
    """``(prompts (B, T0), fed (B, decode))`` int32 numpy arrays: the
    prompt and the tokens fed to the teacher-forced decode steps."""
    import numpy as np

    c = TP_SERVE
    rng = np.random.default_rng(c["seed"])
    toks = rng.integers(0, cfg.vocab_size, (c["batch"], c["prompt"] + c["decode"]),
                        dtype=np.int32)
    return toks[:, :c["prompt"]], toks[:, c["prompt"]:]


def tp_model(cfg, mesh=None):
    """``random_lm_tree(cfg, 0)``'s model, placed on ``mesh`` if given."""
    model = fsdp_model(cfg)
    return model if mesh is None else fsdp.shard_model(model, mesh)


def tp_chunk(full: torch.Tensor, info) -> torch.Tensor:
    """This rank's chunk of ``full`` by its ``DataShard``."""
    if info.model_dim is not None:
        full = full.chunk(info.model.size, info.model_dim)[info.model.rank]
    if info.dim is not None:
        full = full.chunk(info.size, info.dim)[info.rank]
    return full


def tp_whole(shard: torch.Tensor, info) -> torch.Tensor:
    """The whole leaf of this rank's ``shard`` (a collective)."""
    if info.dim is not None:
        shard = rules.all_gather_dim(shard, info.dim, info.group)
    if info.model_dim is not None:
        shard = rules.all_gather_dim(shard, info.model_dim, info.model.group)
    return shard


def tp_train(cfg, mesh, mb: int = 1, once: bool = False) -> dict:
    """``TP_RUN``'s steps of ``build_train_step`` on ``mesh`` (None: one
    process): each step's metrics, the final parameters (this rank's
    shards) and first moments."""
    c = TP_RUN
    opt = AdamWConfig(lr=c["lr"], weight_decay=c["weight_decay"])
    step = build_train_step(cfg, opt, microbatches=mb, total_steps=c["total_steps"],
                            warmup_steps=c["warmup_steps"], gather_small_weights_once=once)
    model = tp_model(cfg, mesh)
    params = dict(model.named_parameters())
    state = adamw_init(params, opt)
    out = {k: [] for k in ("loss", "lm_loss", "grad_norm", "tokens")}
    for i in range(c["steps"]):
        _, state, m = step(model, state, tp_batch(cfg, i), i)
        for k in out:
            out[k].append(m[k].item())
    out = {k: torch.tensor(v, dtype=torch.float64) for k, v in out.items()}
    out["params"] = {n: p.detach().clone() for n, p in params.items()}
    out["m"] = {n: state.m[n].clone() for n in params}
    return out


def tp_store_train(out: dict, tag: str, got: dict, ref: dict, params: dict) -> None:
    """``got``'s metrics beside ``ref``'s, and each parameter and moment
    shard beside the matching chunk of the one-process run."""
    for k in ("loss", "lm_loss", "grad_norm", "tokens"):
        out[f"{tag}/{k}"], out[f"{tag}/ref/{k}"] = got[k], ref[k]
    for kind in ("params", "m"):
        for n, t in got[kind].items():
            out[f"{tag}/{kind}/{n}"] = t
            out[f"{tag}/ref/{kind}/{n}"] = tp_chunk(ref[kind][n], fsdp.shard_of(params[n]))


def state_leaves(state, prefix: str = "") -> dict:
    """``{dotted name: tensor}`` of a decode state (dicts of NamedTuples,
    or an ``EncDecState``)."""
    if isinstance(state, torch.Tensor):
        return {prefix[:-1]: state}
    if isinstance(state, dict):
        items = state.items()
    elif isinstance(state, tuple) and hasattr(state, "_fields"):
        items = zip(state._fields, state)
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(state_leaves(v, f"{prefix}{k}."))
    return out


def tp_serve(cfg, mesh) -> dict:
    """The prefill step's logits and ``TP_SERVE["decode"]`` teacher-forced
    decode steps' (whole, on every rank), and a greedy ``ServeEngine``
    generation, on ``mesh`` (None: one process); ``audio`` from
    ``tp_frames``.  With the decode state's shapes (``state/<leaf>``)."""
    from repro_torch.serve import ServeEngine, build_decode_step, build_prefill_step

    prompts, fed = (torch.as_tensor(a) for a in tp_prompts(cfg))
    frames = tp_frames(cfg)
    enc = () if frames is None else (torch.as_tensor(frames),)
    t0, n = prompts.shape[1], fed.shape[1]
    model = tp_model(cfg)
    logits, state = build_prefill_step(cfg, mesh)(model, prompts, *enc, t0 + n)
    decode = build_decode_step(cfg, mesh)
    steps = []
    for i in range(n):
        step_logits, state = decode(model, fed[:, i:i + 1], state, t0 + i)
        steps.append(step_logits)
    eng = ServeEngine(cfg, tp_model(cfg), max_len=t0 + 4, device=DEV, mesh=mesh)
    out = {"prefill": logits, "steps": torch.cat(steps, dim=1),
           "generated": eng.generate(prompts, 4, frames=enc[0] if enc else None)}
    if cfg.family in ("dense", "vlm"):
        out["cache_shape"] = torch.tensor(state["blocks"].k.shape)
    else:
        out.update({f"state/{k}": torch.tensor(v.shape) for k, v in state_leaves(state).items()})
    return out


def tp_grads(cfg, mesh) -> dict:
    """One step's gradients on ``mesh`` (``lm_loss`` of ``tp_batch(cfg,
    0)``): this rank's raw gradients (before ``fsdp.reduce_grads``) and
    reduced ones of the model-replicated leaves, beside the one-process
    gradients."""
    from repro_torch.train.step import loss_fn

    out = {}
    for name, model in (("ref", tp_model(cfg)), ("tp", tp_model(cfg, mesh))):
        params = dict(model.named_parameters())
        batch = {k: torch.as_tensor(v) for k, v in tp_batch(cfg, 0).items()}
        if name == "tp":
            batch = sharding.shard_batch(batch, mesh)
        loss, _ = loss_fn(model, batch)
        grads = {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(
            params, torch.autograd.grad(loss, list(params.values()), allow_unused=True))}
        if name == "ref":
            ref = grads
            continue
        reduced = fsdp.reduce_grads(grads, params, {})
        for n, p in params.items():
            info = fsdp.shard_of(p)
            if info.model_dim is None:
                out[f"raw/{n}"], out[f"reduced/{n}"] = grads[n], reduced[n]
                out[f"ref/{n}"] = tp_chunk(ref[n], info)
                out[f"per_head/{n}"] = info.per_head
    return out


def tp_ckpt_save(mesh, rank: int, out: dict, shared: Path, arch: str = "llama3_2_1b",
                 key: str = "ckpt") -> None:
    """One step of ``arch`` on the (1, 2) ``mesh``, saved (every leaf
    gathered whole: rank 0 keeps them) for the restores into other layouts;
    then restored here into a (2, 1) mesh, and by rank 0 into one process.
    Results under ``key/``."""
    cfg = smoke_config(arch)
    c = TP_RUN
    opt = AdamWConfig(lr=c["lr"], weight_decay=c["weight_decay"])
    step = build_train_step(cfg, opt, total_steps=c["total_steps"],
                            warmup_steps=c["warmup_steps"])
    model = tp_model(cfg, mesh)
    params = dict(model.named_parameters())
    _, state, _ = step(model, adamw_init(params, opt), tp_batch(cfg, 0), 0)
    ck = shared / f"ck12_{arch}"
    Checkpointer(str(ck)).save(0, (params, state), blocking=True,
                               shardings=fsdp.shardings(model, state))
    whole = {k: tp_whole(v, fsdp.shard_of(params[k.split("/", 1)[1]]))
             if leaf_split(params, k) else v for k, v in fsdp_state(model, state).items()}
    if rank == 0:
        torch.save(whole, shared / f"ck12_{arch}_whole.pt")
        (shared / f"ck12_{arch}_done").touch()
        one = tp_model(cfg)
        one_params = dict(one.named_parameters())
        _, (got, got_state) = Checkpointer(str(ck)).restore(
            None, (one_params, adamw_init(one_params, opt)))
        with torch.no_grad():
            for n, p in one_params.items():
                p.copy_(got[n])
        restored = fsdp_state(one, got_state)
        out[f"{key}/to11/bad"] = [k for k in whole if not torch.equal(restored[k], whole[k])]
        out[f"{key}/to11/leaves"] = len(whole)
    out[f"{key}/to21/bad"] = tp_restore_check(
        sharding.make_mesh((2, 1), ("data", "model"), device_type=DEV), shared, whole, arch)


def leaf_split(params: dict, key: str) -> bool:
    """Whether the leaf a ``fsdp_state`` key holds is split over an axis."""
    return "/" in key and fsdp.shard_of(params[key.split("/", 1)[1]]).split


def tp_restore_check(mesh, shared: Path, whole: dict, arch: str = "llama3_2_1b") -> list:
    """``arch``'s (1, 2) checkpoint restored on ``mesh``: the keys whose
    restored shard differs from its chunk of ``whole``."""
    cfg = smoke_config(arch)
    opt = AdamWConfig(lr=TP_RUN["lr"], weight_decay=TP_RUN["weight_decay"])
    model = tp_model(cfg, mesh)
    params = dict(model.named_parameters())
    state = adamw_init(params, opt)
    _, (got, state) = Checkpointer(str(shared / f"ck12_{arch}")).restore(
        None, (params, state), shardings=fsdp.shardings(model, state))
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(got[n])
    bad = []
    for k, v in fsdp_state(model, state).items():
        want = tp_chunk(whole[k], fsdp.shard_of(params[k.split("/", 1)[1]])) \
            if leaf_split(params, k) else whole[k]
        if not torch.equal(v, want):
            bad.append(k)
    return bad


def tp_restore_wait(shared: Path, arch: str) -> list:
    """Once the 2-rank world has saved ``arch``'s (1, 2) checkpoint, its
    restore into this world's (2, 2) mesh (``tp_restore_check``)."""
    done = shared / f"ck12_{arch}_done"
    deadline = time.monotonic() + 100.0
    while not done.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {done}")
        time.sleep(0.1)
    whole = torch.load(shared / f"ck12_{arch}_whole.pt")
    return tp_restore_check(lmesh.make_host_mesh(2, device_type=DEV), shared, whole, arch)


def tp_mesh_case(mesh, tag: str, rank: int, out: dict) -> None:
    """Every ``TP_ARCHS`` config on ``mesh``: three training steps and the
    serving run, each beside one process's."""
    for arch in TP_ARCHS:
        cfg = smoke_config(arch)
        params = dict(tp_model(cfg, mesh).named_parameters())
        for n, p in params.items():
            info = fsdp.shard_of(p)
            out[f"{tag}/{arch}/shard/{n}"] = p.detach().clone()
            out[f"{tag}/{arch}/dims/{n}"] = torch.tensor(
                [-1 if d is None else d for d in (info.dim, info.model_dim)])
        tp_store_train(out, f"{tag}/{arch}/train", tp_train(cfg, mesh), tp_train(cfg, None),
                       params)
        for k, v in tp_serve(cfg, mesh).items():
            out[f"{tag}/{arch}/serve/{k}"] = v
        for k, v in tp_serve(cfg, None).items():
            out[f"{tag}/{arch}/serve/ref/{k}"] = v
    out[f"{tag}/coords"] = torch.tensor([sharding.axis_index(mesh, "data"),
                                         sharding.axis_index(mesh, "model")])


def tp_error_cases(mesh, out: dict) -> None:
    """The refusals of a real (1, 2) mesh: an ssm model of 3 RWKV heads
    (which do not split over 2) placed on it, its training and its
    serving."""
    from repro_torch.serve import ServeEngine

    rwkv = smoke_config("rwkv6_7b", d_model=192)
    cases = {
        "shard_ssm": lambda: fsdp.shard_model(fsdp_model(rwkv), mesh),
        "train_ssm": lambda: train(rwkv, DataConfig(batch=2, seq_len=8,
                                                    vocab_size=rwkv.vocab_size),
                                   AdamWConfig(), TrainConfig(steps=1), device=DEV, mesh=mesh),
        "serve_ssm": lambda: ServeEngine(rwkv, fsdp_model(rwkv), device=DEV, mesh=mesh),
    }
    for name, fn in cases.items():
        out[f"error/{name}"] = error(fn)


def run_tp_case(case: str, world: int, rank: int, out: dict, shared: Path) -> None:
    if case == "mesh12":
        mesh = lmesh.make_host_mesh(2, device_type=DEV)
        tp_mesh_case(mesh, "mesh12", rank, out)
        out["jax/coords"] = torch.tensor(0)
        for arch in TP_ARCHS:  # the run the JAX package's own (1, 2) step makes
            cfg = smoke_config(arch)
            res = tp_train(cfg, mesh)
            params = dict(tp_model(cfg, mesh).named_parameters())
            for n, t in res["params"].items():
                out[f"jax/{arch}/param/{n}"] = tp_whole(t, fsdp.shard_of(params[n]))
    elif case == "mesh22":
        mesh = lmesh.make_host_mesh(2, device_type=DEV)
        tp_mesh_case(mesh, "mesh22", rank, out)
        cfg = smoke_config("llama3_2_1b")
        params = dict(tp_model(cfg, mesh).named_parameters())
        tp_store_train(out, "mesh22/once", tp_train(cfg, mesh, 2, True),
                       tp_train(cfg, None, 2, True), params)
    elif case == "mesh14":
        tp_mesh_case(lmesh.make_host_mesh(4, device_type=DEV), "mesh14", rank, out)
    elif case == "grads":
        for arch in TP_ARCHS:
            mesh = lmesh.make_host_mesh(world, device_type=DEV)
            for k, v in tp_grads(smoke_config(arch), mesh).items():
                out[f"grads/{arch}/{k}"] = v
    elif case == "ckpt_save":
        tp_ckpt_save(lmesh.make_host_mesh(2, device_type=DEV), rank, out, shared)
    elif case == "ckpt_restore":
        out["ckpt/to22/bad"] = tp_restore_wait(shared, "llama3_2_1b")
    elif case == "loop":
        cfg = smoke_config("llama3_2_1b")
        data = DataConfig(batch=4, seq_len=16, vocab_size=cfg.vocab_size)
        res = train(cfg, data, AdamWConfig(lr=1e-3), TrainConfig(steps=3, log_every=1),
                    device=DEV, mesh=lmesh.make_host_mesh(2, device_type=DEV))
        ref = train(cfg, data, AdamWConfig(lr=1e-3), TrainConfig(steps=3, log_every=1),
                    device=DEV)
        for key, r in (("loop/loss", res), ("loop/ref_loss", ref)):
            out[key] = torch.tensor([h["loss"] for h in r["history"]], dtype=torch.float64)
    elif case == "hostmesh":
        for mp in (1, 2, 4, 8):
            out[f"hostmesh/{mp}"] = torch.tensor(
                tuple(lmesh.make_host_mesh(mp, device_type=DEV).shape))
    elif case == "errors":
        tp_error_cases(lmesh.make_host_mesh(2, device_type=DEV), out)


# The cases each world runs, in order.  The 2-rank world saves the (1, 2)
# checkpoint first; the 4-rank world restores it last, into (2, 2).
TP_WORLDS = {
    2: ("ckpt_save", "mesh12", "grads", "loop", "errors"),
    4: ("mesh22", "mesh14", "hostmesh", "ckpt_restore"),
}


# ------------------------------------------------------- TP, families --

# The ssm, hybrid and audio families that run tensor parallel, by their
# smoke configs (float32): rwkv6 (2 RWKV heads of 64; mix_lora_a's 40
# columns split across its five factors), zamba2 (8 Mamba2 heads of 32,
# w_in's 552 fused columns split across its segments, the shared block's 4
# heads) and whisper (4 heads, the encoder's 64 frames, untied head).
TPF_ARCHS = ("rwkv6_7b", "zamba2_2_7b", "whisper_large_v3")
# The family whose (1, 2) checkpoint moves across layouts.
TPF_CKPT_ARCH = "zamba2_2_7b"


def tpf_mesh_case(mesh, tag: str, archs, out: dict, whole: bool = False) -> None:
    """``archs`` on ``mesh``: the shards and dims, three training steps
    and the serving run, each beside one process's; with ``whole`` the
    trained parameters gathered whole (for the JAX comparison)."""
    for arch in archs:
        cfg = smoke_config(arch)
        params = dict(tp_model(cfg, mesh).named_parameters())
        for n, p in params.items():
            info = fsdp.shard_of(p)
            out[f"{tag}/{arch}/shard/{n}"] = p.detach().clone()
            out[f"{tag}/{arch}/dims/{n}"] = torch.tensor(
                [-1 if d is None else d for d in (info.dim, info.model_dim)])
        got = tp_train(cfg, mesh)
        tp_store_train(out, f"{tag}/{arch}/train", got, tp_train(cfg, None), params)
        if whole:
            for n, t in got["params"].items():
                out[f"{tag}/{arch}/whole/{n}"] = tp_whole(t, fsdp.shard_of(params[n]))
        for k, v in tp_serve(cfg, mesh).items():
            out[f"{tag}/{arch}/serve/{k}"] = v
        for k, v in tp_serve(cfg, None).items():
            out[f"{tag}/{arch}/serve/ref/{k}"] = v
    out[f"{tag}/coords"] = torch.tensor([sharding.axis_index(mesh, "data"),
                                         sharding.axis_index(mesh, "model")])


def tpf_error_cases(out: dict) -> None:
    """The refusals on a real (1, 4) mesh: the rwkv6 smoke config's 2 RWKV
    heads placed, trained and served on it."""
    from repro_torch.serve import ServeEngine

    mesh = lmesh.make_host_mesh(4, device_type=DEV)
    rwkv = smoke_config("rwkv6_7b")
    cases = {
        "shard": lambda: fsdp.shard_model(fsdp_model(rwkv), mesh),
        "train": lambda: train(rwkv, DataConfig(batch=2, seq_len=8, vocab_size=rwkv.vocab_size),
                               AdamWConfig(), TrainConfig(steps=1), device=DEV, mesh=mesh),
        "serve": lambda: ServeEngine(rwkv, fsdp_model(rwkv), device=DEV, mesh=mesh),
        "state": lambda: T.init_decode_state(rwkv, 2, 8, device=DEV, mesh=mesh),
    }
    for name, fn in cases.items():
        out[f"error/{name}"] = error(fn)


def run_tpf_case(case: str, world: int, rank: int, out: dict, shared: Path) -> None:
    if case == "mesh12":
        tpf_mesh_case(lmesh.make_host_mesh(2, device_type=DEV), "mesh12", TPF_ARCHS, out, True)
    elif case == "mesh22":
        tpf_mesh_case(lmesh.make_host_mesh(2, device_type=DEV), "mesh22", TPF_ARCHS, out)
    elif case == "mesh14":
        tpf_mesh_case(lmesh.make_host_mesh(4, device_type=DEV), "mesh14", TPF_ARCHS[1:], out)
    elif case == "grads":
        mesh = lmesh.make_host_mesh(world, device_type=DEV)
        for arch in TPF_ARCHS:
            for k, v in tp_grads(smoke_config(arch), mesh).items():
                out[f"grads/{arch}/{k}"] = v
    elif case == "ckpt_save":
        tp_ckpt_save(lmesh.make_host_mesh(2, device_type=DEV), rank, out, shared, TPF_CKPT_ARCH)
    elif case == "ckpt_restore":
        out["ckpt/to22/bad"] = tp_restore_wait(shared, TPF_CKPT_ARCH)
    elif case == "loop":
        cfg = smoke_config("whisper_large_v3")
        data = DataConfig(batch=4, seq_len=16, vocab_size=cfg.vocab_size)
        res = train(cfg, data, AdamWConfig(lr=1e-3), TrainConfig(steps=2, log_every=1),
                    device=DEV, mesh=lmesh.make_host_mesh(2, device_type=DEV))
        ref = train(cfg, data, AdamWConfig(lr=1e-3), TrainConfig(steps=2, log_every=1),
                    device=DEV)
        for key, r in (("loop/loss", res), ("loop/ref_loss", ref)):
            out[key] = torch.tensor([h["loss"] for h in r["history"]], dtype=torch.float64)
    elif case == "errors":
        tpf_error_cases(out)


# The cases each world runs, in order.  The 2-rank world saves the (1, 2)
# checkpoint first; the 4-rank world restores it last, into (2, 2).
TPF_WORLDS = {
    2: ("ckpt_save", "mesh12", "grads", "loop"),
    4: ("mesh22", "mesh14", "errors", "ckpt_restore"),
}


def main() -> None:
    rank, world, store, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    suite = sys.argv[5] if len(sys.argv) > 5 else "engines"
    torch.set_num_threads(1)
    lmesh.init_world(rank, world, f"file://{store}", device_type=DEV)
    shared = out_dir / "shared"  # the service's log and checkpoints, one for the world
    shared.mkdir(exist_ok=True)
    out: dict = {}
    cases, run = {"fsdp": (FSDP_WORLDS, run_fsdp_case), "tp": (TP_WORLDS, run_tp_case),
                  "tpf": (TPF_WORLDS, run_tpf_case)}.get(suite, (WORLDS, run_case))
    if suite in ("tp", "tpf"):  # one directory for both worlds (the checkpoint moves between them)
        shared = out_dir.parent / "shared"
        shared.mkdir(exist_ok=True)
    for case in cases[world]:
        t0 = time.perf_counter()
        run(case, world, rank, out, shared)
        out[f"seconds/{case}"] = time.perf_counter() - t0
    torch.save(out, out_dir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
