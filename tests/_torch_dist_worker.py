"""One rank of a gloo world on the CPU for ``tests/test_torch_distributed.py``.

    python tests/_torch_dist_worker.py RANK WORLD STORE OUT_DIR

Joins the world through the ``file://`` store ``STORE`` (a 120 s timeout
on every collective), runs the world's cases (``WORLDS[WORLD]``) and
writes ``OUT_DIR/rank{RANK}.pt``: a dict of named tensors, flags and error
messages that the test module asserts, case by case.  Rank 0 also runs
each case's one-process reference (the sequential region engine, the
unsharded campus, the one-rank service) and stores it beside its result.
Imports torch and the port only; every process runs one thread.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import sharding  # noqa: E402
from repro_torch.core import compliance, fleet, grid, pdu  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.power import faults as FLT, scenario as SC  # noqa: E402
from repro_torch.serve import ConditionerService  # noqa: E402

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


def main() -> None:
    rank, world, store, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    torch.set_num_threads(1)
    lmesh.init_world(rank, world, f"file://{store}", device_type=DEV)
    shared = out_dir / "shared"  # the service's log and checkpoints, one for the world
    shared.mkdir(exist_ok=True)
    out: dict = {}
    for case in WORLDS[world]:
        t0 = time.perf_counter()
        run_case(case, world, rank, out, shared)
        out[f"seconds/{case}"] = time.perf_counter() - t0
    torch.save(out, out_dir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
