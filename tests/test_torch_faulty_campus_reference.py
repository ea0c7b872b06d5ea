"""The JAX package's numbers for ``chip_smoke.py``'s degraded-mode campus
(phase 13), and a CPU check of the script's comparison at a reduced size.

Run as a script it records ``chip_smoke.JAX_FAULTY_CAMPUS``: the 1024-rack,
88 s campus of ``benchmarks/paper_benches.py::bench_mixed_campus_faulty``
(``chip_smoke.FAULTY_CAMPUS``) through the JAX package's host engine on the
CPU (a few minutes):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_faulty_campus_reference.py

With ``--port`` it also runs the port's host and one-shot engines on the
CPU on the same campus and prints their numbers and the comparison
(``chip_smoke.compare_faulty_campus``).

As a test it runs that comparison for both of the port's engines against
the JAX package's host engine on a 64-rack, 30 s cut of the campus: the
port renders, samples, initializes and plans everything itself, as on the
card.
"""
import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def jax_faulty_campus_summary(n_racks: int, duration_s: float) -> dict:
    from repro.core import compliance, fleet, pdu
    from repro.power import faults as FLT, scenario as SC

    c = chip_smoke.FAULTY_CAMPUS
    s = chip_smoke.faulty_campus(SC, FLT, n_racks, duration_s)
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], degraded_mode=True)
    res = fleet.condition(
        s, cfg, compliance.GridSpec.create(), engine="host", qp_iters=c["qp_iters"],
        stream=fleet.StreamOptions(chunk_intervals=c["chunk_intervals"]),
    )
    return chip_smoke.faulty_campus_summary(res, res.bank)


@pytest.fixture(scope="module")
def jax_reduced():
    return jax_faulty_campus_summary(64, 30.0)


@pytest.mark.parametrize("engine", ["host", "oneshot"])
def test_faulty_campus_check_passes_on_cpu_at_reduced_size(jax_reduced, engine):
    want = jax_reduced
    assert min(want["ess_online_frac"]) < 0.9, "the soup tripped too few ESS units"
    _, got, _ = chip_smoke.run_faulty_campus(64, 30.0, engine, device="cpu")
    assert chip_smoke.compare_faulty_campus(got, want) == []
    assert set(got) <= set(want)


if __name__ == "__main__":
    c = chip_smoke.FAULTY_CAMPUS
    want = jax_faulty_campus_summary(c["n_racks"], c["duration_s"])
    print(json.dumps(want, indent=1))
    if "--port" in sys.argv[1:]:
        for engine in ("host", "oneshot"):
            _, got, wall = chip_smoke.run_faulty_campus(c["n_racks"], c["duration_s"], engine,
                                                        device="cpu")
            print(f"port {engine} engine on the CPU ({wall:.1f} s): " + json.dumps(got, indent=1))
            print("differences: " + json.dumps(chip_smoke.compare_faulty_campus(got, want)))
