"""The JAX package's numbers for ``chip_smoke.py``'s grid region (phase
16a), and a CPU check of the script's comparison at a reduced size.

The JAX package's own region engine cannot run on jax 0.9.0 (its
sequential engine sends each campus through ``shard_map``, whose
``check_rep`` keyword that jax rejects).  Every piece it composes does run,
so ``jax_region`` composes them in ``grid.condition_region_sequential``'s
order: each campus through the scanned ``fleet.condition``, the POI summed
left to right with the region's weights, ``grid._poi_fold`` with the
engines' chunk partition and ``grid._assemble_region_result``.

Run as a script it records ``chip_smoke.JAX_GRID_REGION``:
``chip_smoke.GRID_REGION`` (4 campuses x 256 racks, 200 s at 50 Hz),
synchronized and staggered, on the CPU (~20 s):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_grid_region_reference.py

With ``--port`` it also runs the port on the CPU on the same regions and
prints the comparison (``chip_smoke.compare_region``).

As a test it runs that comparison for both regions at 4 campuses x 8
racks, 40 s: the port builds, salts, renders and conditions everything
itself, as on the card.
"""
import functools
import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.grid


def jax_region(reg, cfg, spec, *, chunk_intervals: int = 16, qp_iters: int = 30, states=None,
               start_sample: int = 0, stop_sample: int | None = None):
    """The JAX package's region result, composed from the pieces of
    ``grid.condition_region_sequential`` that run on jax 0.9.0."""
    import jax.numpy as jnp

    from repro.core import fleet, grid

    C = reg.n_campuses
    states = (None,) * C if states is None else tuple(states)
    k, chunk, start, stop, t_total, n_full, rem, n_ctrl = grid._chunk_geometry(
        cfg, reg, chunk_intervals, start_sample, stop_sample)
    per = [
        fleet.condition(scen, cfg, spec, qp_iters=qp_iters, stream=fleet.StreamOptions(
            chunk_intervals=chunk_intervals, state=states[c], start_sample=start,
            stop_sample=stop))
        for c, scen in enumerate(reg.campuses)
    ]
    w = reg.weights
    add = lambda a, b: a + b
    poi_rack = functools.reduce(add, [w[c] * per[c].campus_rack for c in range(C)])
    poi_grid = functools.reduce(add, [w[c] * per[c].campus_grid for c in range(C)])
    bank = fleet._make_bank(spec, cfg, t_total)
    mbank = grid.mode_bank(t_total, cfg.sample_dt, reg.bands)
    po = grid._poi_fold(bank, mbank, chunk, n_full, rem, cfg.sample_dt)(poi_rack, poi_grid)
    stack = lambda name: jnp.stack([getattr(p, name) for p in per])
    return grid._assemble_region_result(
        cfg, reg, spec, per, campus_rack=stack("campus_rack"), campus_grid=stack("campus_grid"),
        soc_mean=stack("soc_mean"), health_trace=stack("health_trace"),
        ess_frac=stack("ess_online_frac"),
        max_qp=functools.reduce(jnp.maximum, [p.max_qp_residual for p in per]),
        poi_rack=poi_rack, poi_grid=poi_grid, po=po, bank=bank, mbank=mbank,
        sm_trace=stack("safemode_trace"))


def jax_region_summary(stagger: bool, n_racks: int, duration_s: float) -> dict:
    from repro.core import compliance, grid, pdu

    c = chip_smoke.GRID_REGION
    reg = chip_smoke.grid_region(grid, stagger, n_racks, duration_s)
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"])
    res = jax_region(reg, cfg, compliance.GridSpec.create(), chunk_intervals=c["chunk_intervals"],
                     qp_iters=c["qp_iters"])
    mbank = grid.mode_bank(reg.total_samples, cfg.sample_dt, reg.bands)
    return chip_smoke.region_summary(res, reg, mbank)


REGIONS = {"synchronized": False, "staggered": True}


@pytest.fixture(scope="module")
def jax_reduced():
    return {name: jax_region_summary(st, 8, 40.0) for name, st in REGIONS.items()}


@pytest.mark.parametrize("name", list(REGIONS))
def test_region_check_passes_on_cpu_at_reduced_size(jax_reduced, name):
    want = jax_reduced[name]
    *_, got, _ = chip_smoke.run_region(REGIONS[name], 8, 40.0, device="cpu")
    assert chip_smoke.compare_region(got, want) == []
    assert set(got) == set(want)
    # The finding holds at this size too: lockstep rings, staggered passes.
    assert got["modes_ok"] is (name == "staggered")


if __name__ == "__main__":
    c = chip_smoke.GRID_REGION
    want = {name: jax_region_summary(st, c["n_racks"], c["duration_s"])
            for name, st in REGIONS.items()}
    print("JAX_GRID_REGION = " + json.dumps(want, indent=1))
    if "--port" in sys.argv[1:]:
        for name, st in REGIONS.items():
            *_, got, wall = chip_smoke.run_region(st, c["n_racks"], c["duration_s"],
                                                  device="cpu")
            print(f"port {name} on the CPU ({wall:.1f} s): " + json.dumps(got, indent=1))
            print("differences: " + json.dumps(chip_smoke.compare_region(got, want[name])))
