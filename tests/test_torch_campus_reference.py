"""The JAX package's numbers for ``chip_smoke.py``'s acceptance campus,
and a CPU check of the script's campus comparison at a reduced size.

Run as a script it records ``chip_smoke.JAX_CAMPUS``: the 1024-rack,
88 s campus of ``benchmarks/paper_benches.py::bench_mixed_campus_health``
through the JAX package's host engine on the CPU (a few minutes):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_campus_reference.py

With ``--port`` it also runs the port on the CPU on the same campus and
prints its numbers and their comparison (``chip_smoke.compare_campus``).

As a test it runs the same comparison (``chip_smoke.compare_campus``)
between the port on the CPU and the JAX package on a 16-rack, 17.5 s
campus: every rack of the port is rendered, initialized and planned by
the port itself, as on the card, so the check's tolerances are exercised
on a campus 64x smaller (less averaging) than the one they guard.
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def jax_campus_summary(n_racks: int, duration_s: float) -> dict:
    from repro.core import compliance, fleet, health as hlt, pdu
    from repro.power import scenario as SC

    c = chip_smoke.CAMPUS
    s = SC.mixed_campus(n_racks, chip_smoke.ARCHS, duration_s=duration_s,
                        sample_hz=c["sample_hz"], seed=c["seed"],
                        fault_at_s=duration_s * 0.6, noise_seed=c["noise_seed"])
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], track_health=True)
    res = fleet.condition(
        s, cfg, compliance.GridSpec.create(), engine="host", qp_iters=c["qp_iters"],
        stream=fleet.StreamOptions(chunk_intervals=c["chunk_intervals"]),
    )
    return chip_smoke.campus_summary(res, hlt.fleet_summary(res.health))


def test_campus_check_passes_on_cpu_at_reduced_size():
    want = jax_campus_summary(16, 17.5)
    res, hsum, _ = chip_smoke.run_campus(16, 17.5, device="cpu")
    got = chip_smoke.campus_summary(res, hsum)
    assert chip_smoke.compare_campus(got, want) == []
    assert set(chip_smoke.JAX_CAMPUS) == set(want)


if __name__ == "__main__":
    c = chip_smoke.CAMPUS
    want = jax_campus_summary(c["n_racks"], c["duration_s"])
    print(json.dumps(want, indent=1))
    if "--port" in sys.argv[1:]:
        res, hsum, _ = chip_smoke.run_campus(c["n_racks"], c["duration_s"], device="cpu")
        got = chip_smoke.campus_summary(res, hsum)
        print("port on the CPU: " + json.dumps(got, indent=1))
        print("differences: " + json.dumps(chip_smoke.compare_campus(got, want)))
