"""The port's multi-rank engines on the CPU: gloo worlds of 4, 2 and 1
ranks (``_torch_dist_worker.py``, one process a rank, spawned once for the
module), each rank's results asserted case by case.

* The sharded region engine (``fleet.condition(region, mesh=...)``) on a
  (4, 1) mesh (4 campuses) and a (2, 2) mesh (2 campuses, each run by two
  ranks), synchronized and staggered, one window and a window split at a
  chunk boundary and resumed: on every rank bit for bit
  ``condition_region_sequential``'s result (rank 0's), every leaf (the
  POI, ``poi_freq_dev``, ``poi_volt_dev``, every campus aggregate and
  final state, the reports and verdicts).  A heterogeneous region (3 and 5
  racks) too, which the reference's sharded engine refuses (it stacks its
  campuses).  One sharded POI against the JAX package's region
  (``jax_region``) within ``test_torch_grid_region``'s tolerances.
* Rack sharding of a 16-rack campus over 4, 2 and 1 ranks, host and
  scanned engines, clean and under a fault schedule with safe mode: every
  per-rack leaf (the state, the wear report) bit for bit the unsharded
  run's; the campus means (``campus_rack``, ``campus_grid``,
  ``soc_mean``, the mean EFC) within 1e-6 absolute, the reference's LC
  chain envelope, since the ranks' block means combine in another order
  than one mean over the racks; the ramps within 2e-6 / dt (a difference
  of two such samples over a sample), the spectrum lines within 2e-6 (the
  line's gain over the trace is at most 2); counts (the ESS online
  fraction, the safe-mode snapshot), maxima and every verdict exactly;
  and every leaf, the observers' too, within ``chip_smoke.py``'s phase-23b
  rule (``sharded_campus_tolerance``), which covers every leaf.  Over one
  rank everything is bit for bit.  A scanned window split at a chunk
  boundary and resumed equals the one-call sharded run bit for bit.  The
  4-rank scanned campus, clean and faulty, against the JAX package's host
  engine on the same scenario within ``test_torch_fleet``'s tolerances.
* The region service with a mesh: a window, the next, and the next again
  from a checkpoint in a new service, bit for bit the one-rank service's
  on every rank; only rank 0 writes the audit log's file.
* The ``ValueError`` of every check the reference's sharded region engine,
  ``region_mesh`` and ``ConditionerService`` make, and the port's own.
* ``launch.mesh.make_host_mesh`` over worlds of 4 and 2.

Each world joins through a ``file://`` store in the test's temporary
directory (no port to clash across workers); the ranks' collectives time
out after 120 s and the module waits at most 120 s for its worlds.  A rank
that fails or hangs fails the tests.
"""
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import compliance as jcomp, fleet as jfleet, grid as jgrid, pdu as jpdu
from repro.power import faults as JFLT, scenario as JSC

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]
import chip_smoke  # noqa: E402
from test_torch_grid_region import _assert_matches_jax  # noqa: E402
from test_torch_grid_region_reference import jax_region  # noqa: E402

pytestmark = pytest.mark.grid

WORKER = Path(__file__).resolve().parent / "_torch_dist_worker.py"
WORLDS = (4, 2, 1)
JOIN_S = 120.0
HZ = 50.0
AGG_TOL = chip_smoke.SHARDED_AGG_TOL
RAMP_TOL = 2 * AGG_TOL * HZ
LINE_TOL = 2 * AGG_TOL


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> dict:
    """``{world: [rank 0's results, rank 1's, ...]}``: every world's ranks
    started at once, each world in its own directory."""
    root = tmp_path_factory.mktemp("worlds")
    procs = []
    for world in WORLDS:
        d = root / f"world{world}"
        d.mkdir()
        for r in range(world):
            log = open(d / f"rank{r}.log", "w")
            procs.append((world, r, log, subprocess.Popen(
                [sys.executable, str(WORKER), str(r), str(world), str(d / "store"), str(d)],
                stdout=log, stderr=subprocess.STDOUT, env=dict(os.environ))))
    deadline = time.monotonic() + JOIN_S
    try:
        for world, r, log, p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {r} of the {world}-rank world did not finish in {JOIN_S} s")
    finally:
        for _, _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [(w, r, p.returncode) for w, r, _, p in procs if p.returncode != 0]
    if bad:
        w, r, _ = bad[0]
        tail = (root / f"world{w}" / f"rank{r}.log").read_text()[-3000:]
        pytest.fail(f"ranks failed (world, rank, exit code): {bad}\n{tail}")
    return {w: [torch.load(root / f"world{w}" / f"rank{r}.pt", weights_only=False)
                for r in range(w)] for w in WORLDS}


def _case(out: dict, name: str) -> dict:
    """``{leaf path: tensor}`` of the result stored under ``name``."""
    return {k[len(name):]: v for k, v in out.items()
            if k.startswith(name + ".") and isinstance(v, torch.Tensor)}


def _assert_bitwise(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), (what, sorted(got.keys() ^ want.keys())[:5])
    bad = [k for k in want if got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k])]
    assert not bad, f"{what}: differ in {bad[:8]}"


REGION_CASES = [f"{mesh}/{kind}/{window}" for mesh in ("region4x1", "region2x2")
                for kind in ("synchronized", "staggered") for window in ("whole", "resumed")]


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("case", REGION_CASES)
def test_sharded_region_is_the_sequential_engine_bit_for_bit(ranks, case, rank):
    want = _case(ranks[4][0], f"{case}/ref")
    got = _case(ranks[4][rank], case)
    assert {".poi_rack", ".poi_grid", ".poi_freq_dev", ".poi_volt_dev",
            ".report_poi.mode_ok", ".state.0.qp_warm.x"} <= want.keys()
    _assert_bitwise(got, want, f"{case} on rank {rank}")


@pytest.mark.parametrize("rank", range(2))
def test_sharded_heterogeneous_region(ranks, rank):
    want = _case(ranks[2][0], "hetero/whole/ref")
    assert want[".campus_rack"].shape[0] == 2 and want[".state.1.u_prev"].shape == (5,)
    _assert_bitwise(_case(ranks[2][rank], "hetero/whole"), want, f"hetero on rank {rank}")


def _nest(flat: dict):
    """A namespace tree of ``{".a.b.0.c": tensor}`` (numeric parts index
    lists), for the JAX region comparison's attribute access."""
    root: dict = {}
    for path, v in flat.items():
        node, parts = root, path.lstrip(".").split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [build(node[str(i)]) for i in range(len(node))]
        return SimpleNamespace(**{k: build(v) for k, v in node.items()})

    return build(root)


def test_sharded_poi_matches_the_composed_jax_region(ranks):
    jcfg = jpdu.make_pdu(sample_dt=1.0 / HZ)
    jreg = jgrid.checkpoint_region(4, 4, duration_s=30.0, sample_hz=HZ, stagger=False,
                                   noise_seed=3)
    j = jax_region(jreg, jcfg, jcomp.GridSpec.create(), chunk_intervals=4)
    t = _nest(_case(ranks[4][1], "region4x1/synchronized/whole"))
    _assert_matches_jax(t, j, jreg, jcfg.sample_dt)


CAMPUS_CASES = [(world, kind, engine) for world in WORLDS for kind in ("clean", "faulty")
                for engine in ("host", "scanned")]
PER_RACK = (".state.", ".health.")
MEANS = (".campus_rack", ".campus_grid", ".soc_mean")
EXACT = (".ess_online_frac", ".safemode_trace", ".max_qp_residual")


@pytest.mark.parametrize("case", CAMPUS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_rack_sharded_campus(ranks, case):
    world, kind, engine = case
    name = f"campus{world}/{kind}/{engine}/whole"
    want = _case(ranks[world][0], f"{name}/ref")
    for rank, out in enumerate(ranks[world]):
        got = _case(out, name)
        assert got.keys() == want.keys()
        if world == 1:  # one block: the weights are 1.0 and the counts the whole's
            _assert_bitwise(got, want, f"{name} over one rank")
            continue
        _assert_bitwise({k: v for k, v in got.items() if k.startswith(PER_RACK)},
                        {k: v for k, v in want.items() if k.startswith(PER_RACK)},
                        f"{name} per-rack leaves on rank {rank}")
        for k in MEANS:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=AGG_TOL, err_msg=k)
        h, hw = got[".health_trace"], want[".health_trace"]
        np.testing.assert_allclose(h[:, 0], hw[:, 0], rtol=0, atol=AGG_TOL)
        assert torch.equal(h[:, 1:], hw[:, 1:])
        for k in EXACT:
            assert torch.equal(got[k], want[k]), k
        for rep in (".report_rack", ".report_grid"):
            for v in (".ramp_ok", ".spectrum_ok", ".ok"):
                assert torch.equal(got[rep + v], want[rep + v]), rep + v
            np.testing.assert_allclose(got[rep + ".max_ramp"], want[rep + ".max_ramp"],
                                       rtol=0, atol=RAMP_TOL)
            np.testing.assert_allclose(got[rep + ".worst_high_freq_mag"],
                                       want[rep + ".worst_high_freq_mag"], rtol=0, atol=LINE_TOL)
        # Every leaf, the observers' too, within phase 23b's rule; none unheld.
        plain = lambda d: {k[1:]: v for k, v in d.items()}
        assert chip_smoke._sharded_campus_check(f"{name} rank {rank}", plain(got), plain(want),
                                                False, 1.0 / HZ) == []
        if kind == "faulty":  # the schedule tripped and contained racks
            assert float(want[".ess_online_frac"].min()) < 1.0
        # Every rank returns the same whole result.
        _assert_bitwise(got, _case(ranks[world][0], name), f"{name}: rank {rank} vs rank 0")


def _jax_campus(faulty: bool):
    """The worker's 16-rack campus (``_torch_dist_worker.campus``) through
    the JAX package's host engine (its scanned engine's ragged tail is a
    known fault of the reference), its tree as ``{leaf path: array}``."""
    import jax

    kw = dict(duration_s=22.5, sample_hz=HZ, seed=3, fault_at_s=12.0, noise_seed=2)
    s = JSC.mixed_campus(16, ("llama3_2_1b", "deepseek_v3_671b", "chatglm3_6b",
                              "whisper_large_v3"), **kw)
    if faulty:
        proc = JFLT.FaultProcess.create(rack_mtbf_s=40.0, rack_mttr_s=6.0, ess_mtbf_s=30.0,
                                        ess_mttr_s=8.0, sensor_mtbf_s=40.0, sensor_mttr_s=3.0)
        sched = JFLT.sample_schedule(proc, 16, s.total_samples, HZ, seed=7)
        sched = JFLT.inject_episodes(sched, ess=[(1, 325, 650)], sensor=[(3, 0, 75)])
        s = JSC.attach_faults(s, sched)
    cfg = jpdu.make_pdu(sample_dt=1.0 / HZ, track_health=True, degraded_mode=faulty,
                        safemode=faulty)
    return jax.device_get(jfleet.condition(s, cfg, jcomp.GridSpec.create(), engine="host",
                                           qp_iters=30,
                                           stream=jfleet.StreamOptions(chunk_intervals=2)))


@pytest.mark.parametrize("kind", ["clean", "faulty"])
def test_rack_sharded_campus_matches_jax(ranks, kind):
    """The 4-rank scanned campus (rank 1's result) against the JAX
    package's engine on the same scenario, with ``test_torch_fleet``'s
    scenario-target tolerances (each package renders its own trace)."""
    j = _jax_campus(kind == "faulty")
    t = _nest(_case(ranks[4][1], f"campus4/{kind}/scanned/whole"))
    f = 2.0
    close = lambda a, b, atol, what, rtol=0.0: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=what)
    close(t.campus_rack, j.campus_rack, f * 1e-6, "campus_rack")
    close(t.campus_grid, j.campus_grid, f * 1e-5, "campus_grid")
    close(t.soc_mean, j.soc_mean, f * 1e-6, "soc_mean")
    close(t.max_qp_residual, j.max_qp_residual, 0.0, "max_qp_residual", rtol=f * 1e-6)
    close(t.health_trace, j.health_trace, f * 1e-6, "health_trace", rtol=f * 1e-5)
    close(t.ess_online_frac, j.ess_online_frac, 0.0, "ess_online_frac")
    for which in ("rack", "grid"):
        rt, rj = getattr(t, f"report_{which}"), j.report(which)
        close(rt.max_ramp, rj.max_ramp, 0.0, f"{which} max_ramp", rtol=f * 1e-3)
        close(rt.worst_high_freq_mag, rj.worst_high_freq_mag, f * 1e-5, f"{which} spectrum")
        for name in ("ramp_ok", "spectrum_ok", "ok"):
            assert bool(getattr(rt, name)) == bool(getattr(rj, name)), f"{which} {name}"
    for name in j.health._fields:
        rtol = f * 1e-5 if name in ("mean_soc", "calendar_life_frac",
                                     "capacity_fade", "projected_life_s") else 0.0
        atol = f * (1e-5 if name == "soc_std" else 1e-6)
        close(getattr(t.health, name), getattr(j.health, name), atol, name, rtol)


@pytest.mark.parametrize("case", [(w, k) for w in WORLDS for k in ("clean", "faulty")],
                         ids=lambda c: "-".join(map(str, c)))
def test_rack_sharded_window_split_and_resumed(ranks, case):
    world, kind = case
    for rank, out in enumerate(ranks[world]):
        whole = _case(out, f"campus{world}/{kind}/scanned/whole")
        res = _case(out, f"campus{world}/{kind}/scanned/resumed")
        _assert_bitwise({k: v for k, v in res.items() if k.startswith(".state.")},
                        {k: v for k, v in whole.items() if k.startswith(".state.")},
                        f"resumed state on rank {rank}")
        n = res[".campus_rack"].shape[0]
        for k in (".campus_rack", ".campus_grid"):
            assert torch.equal(res[k], whole[k][-n:]), k


@pytest.mark.parametrize("rank", range(4))
def test_region_service_with_a_mesh(ranks, rank):
    out, ref = ranks[4][rank], ranks[4][0]
    for window in ("window", "live", "resumed"):
        _assert_bitwise(_case(out, f"service/{window}"), _case(ref, f"service/{window}/ref"),
                        f"service {window} on rank {rank}")
    _assert_bitwise(_case(out, "service/resumed"), _case(out, "service/live"), "resume")
    # Only rank 0 writes the log's file; every rank keeps the same events.
    assert bool(out["service/writes_log"]) is (rank == 0)
    if rank == 0:
        assert int(out["service/log_lines"]) == int(out["service/events"])
    assert int(out["service/events"]) == int(ref["service/events/ref"])


@pytest.mark.parametrize("world", [4, 2])
def test_host_mesh(ranks, world):
    for rank, out in enumerate(ranks[world]):
        for mp in (1, 2, 8):
            m = min(mp, world)
            assert out[f"hostmesh/{mp}/shape"].tolist() == [world // m, m]
            assert out[f"hostmesh/{mp}/coords"].tolist() == list(divmod(rank, m))


ERRORS = {
    "no_campus_axis": "ValueError: mesh axes \\('data',\\) lack the 'campus' axis",
    "campus_count": "ValueError: mesh has 4 campus shards for 3 campuses",
    "states_count": "ValueError: 3 states for 4 campuses",
    "states_partial": "ValueError: per-campus resume states must be all-None",
    "rate": "ValueError: scenario sample rate 50.0 Hz != PDU sample_dt",
    "faults": "ValueError: the scenario has a fault schedule attached",
    "region_mesh_tile": "ValueError: 4 ranks do not tile 3 campuses",
    "region_mesh_positive": "ValueError: n_campuses must be positive, got 0",
    "service_scenario": "ValueError: mesh is only meaningful for GridRegion targets",
    "oneshot": "ValueError: the one-shot engine runs in one process",
    "uneven_racks": "ValueError: 6 racks do not split evenly over the 4 ranks",
    "no_rack_axis": "ValueError: mesh axes \\('racks',\\) lack the rack axis 'data'",
    # The port's own: rack sharding combines the online fraction as counts.
    "fractional_online": "ValueError: rack sharding combines the ESS online fraction as exact "
                         "counts: ess_online must be a 0/1 mask",
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_sharded_engines_refuse(ranks, name):
    msgs = [out[f"error/{name}"] for out in ranks[4]]
    assert all(re.match(ERRORS[name], m) for m in msgs), msgs
