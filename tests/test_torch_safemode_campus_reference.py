"""The JAX package's numbers for ``chip_smoke.py``'s safe-mode drill (phase
15b), and a CPU check of the script's comparison at a reduced size.

Run as a script it records ``chip_smoke.JAX_SAFEMODE_DRILL``: the 1024-rack,
88 s faulty campus (``chip_smoke.FAULTY_CAMPUS``) supervised by the default
``SafeModeConfig``, from the initial state ``chip_smoke.SAFEMODE_DRILL``
corrupts, through the JAX package's host engine on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_safemode_campus_reference.py

With ``--port`` it also runs the port's host and scanned engines on the CPU
on the same campus and prints their numbers and the comparison
(``chip_smoke.compare_safemode_drill``).

As a test it runs that comparison for both of the port's engines against
the JAX package's host engine on a 64-rack, 30 s cut of the campus (the
drill's racks are online there too), and holds the port's engines to each
other bit for bit: the port renders, samples, initializes, corrupts and
plans everything itself, as on the card.
"""
import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def jax_safemode_drill_summary(n_racks: int, duration_s: float) -> dict:
    from repro.core import compliance, fleet, pdu
    from repro.power import faults as FLT, scenario as SC

    c = chip_smoke.FAULTY_CAMPUS
    s = chip_smoke.faulty_campus(SC, FLT, n_racks, duration_s)
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], degraded_mode=True, safemode=True)
    state = chip_smoke.safemode_drill_state(pdu.init_state(cfg, SC.render(s, 0, 1)[0]),
                                            lambda a, idx, v: a.at[idx].set(v))
    res = fleet.condition(
        s, cfg, compliance.GridSpec.create(), engine="host", qp_iters=c["qp_iters"],
        stream=fleet.StreamOptions(chunk_intervals=c["chunk_intervals"], state=state),
    )
    return chip_smoke.safemode_drill_summary(res, res.bank)


@pytest.fixture(scope="module")
def jax_reduced():
    return jax_safemode_drill_summary(64, 30.0)


@pytest.fixture(scope="module")
def port_reduced():
    return {engine: chip_smoke.run_safemode_drill(64, 30.0, engine, device="cpu")
            for engine in ("host", "scanned")}


@pytest.mark.parametrize("engine", ["host", "scanned"])
def test_safemode_drill_check_passes_on_cpu_at_reduced_size(jax_reduced, port_reduced, engine):
    want = jax_reduced
    summ = want["safemode_summary"]
    d = chip_smoke.SAFEMODE_DRILL
    # The drill did what it says in the JAX package too: the poisoned racks
    # tripped, the corrupted ones are quarantined (30 s is too short for
    # their re-admission), and the offline rack lowered every interval's
    # online fraction.
    assert summ["passthrough_racks"] == sorted(d["warm"])
    assert summ["quarantined_racks"] == sorted((d["soc_nan"], d["lc_nan"]))
    assert summ["quarantine_entries"] == 2 and summ["passthrough_entries"] == 2
    res, got, _ = port_reduced[engine]
    assert chip_smoke.compare_safemode_drill(got, want) == []
    assert torch.isfinite(res.campus_grid).all() and torch.isfinite(res.campus_rack).all()
    assert max(want["ess_online_frac"]) < 1.0


def test_safemode_drill_engines_agree_bitwise(port_reduced):
    (host, _, _), (scanned, _, _) = port_reduced["host"], port_reduced["scanned"]
    assert chip_smoke._differing_bits(host, scanned) == []
    assert torch.equal(host.safemode_trace, scanned.safemode_trace)


if __name__ == "__main__":
    c = chip_smoke.FAULTY_CAMPUS
    want = jax_safemode_drill_summary(c["n_racks"], c["duration_s"])
    print(json.dumps(want, indent=1))
    if "--port" in sys.argv[1:]:
        for engine in ("host", "scanned"):
            _, got, wall = chip_smoke.run_safemode_drill(c["n_racks"], c["duration_s"], engine,
                                                         device="cpu")
            print(f"port {engine} engine on the CPU ({wall:.1f} s): " + json.dumps(got, indent=1))
            print("differences: " + json.dumps(chip_smoke.compare_safemode_drill(got, want)))
