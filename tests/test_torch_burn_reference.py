"""The JAX package's numbers for ``chip_smoke.py``'s Fig. 11 comparison,
and a CPU check of that comparison at a reduced size.

Run as a script it records ``chip_smoke.JAX_FIG11``: the Titan-X testbench
with the counter-hashed noise of ``scenario_from_testbench(titanx_spec(),
noise_seed=2)`` (identical bits in both packages) through the JAX
package's burn baseline and ``pdu.condition`` on the CPU (about a minute):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_burn_reference.py

With ``--port`` it also runs the port on the CPU on the same trace and
prints its numbers and their comparison (``chip_smoke.compare_fig11``).

As a test it runs the same comparison on the first 60 s of the trace
(12000 samples, 12 controller intervals).
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def jax_fig11_summary(n_samples: int | None = None) -> dict:
    import jax

    from repro.core import burn, compliance, pdu
    from repro.power import scenario as SC, trace

    f = chip_smoke.FIG11
    rack, dt = SC.render_trace(trace.scenario_from_testbench(trace.titanx_spec(),
                                                             noise_seed=f["noise_seed"]))
    rack = rack[:n_samples]
    cal = burn.calibrate(jax.random.key(f["cal_seed"]), p_idle=f["p_idle"], p_peak=f["p_peak"])
    sched = burn.burn_schedule(rack, dt, beta=f["beta"], cal=cal)
    cfg = pdu.make_pdu(sample_dt=dt)
    st = pdu.init_state(cfg, rack[0])
    gez, _, telem = pdu.condition(cfg, st, rack, qp_iters=f["qp_iters"])
    nwarm = sched.conditioned.shape[0] - rack.shape[0]
    soc_last = float(np.asarray(telem.soc)[-1])
    cmp = burn.compare_energy(rack, gez, sched.conditioned[nwarm:], dt, soc_delta=soc_last - 0.5,
                              q_max_seconds=float(cfg.ess_params.q_max))
    out = {k: float(v) for k, v in cmp.items()}
    out.update(
        schedule_overhead_frac=float(sched.energy_overhead_frac),
        burn_max_ramp=float(compliance.max_abs_ramp(sched.conditioned, dt)),
        grid_max_ramp=float(compliance.max_abs_ramp(gez, dt)),
        soc_last=soc_last, cal_a=float(cal.a), cal_b=float(cal.b),
    )
    return out


def test_fig11_comparison_passes_on_cpu_at_reduced_size():
    want = jax_fig11_summary(12000)
    got = chip_smoke.port_fig11_reference(12000, device="cpu")
    assert chip_smoke.compare_fig11(got, want) == []
    assert set(chip_smoke.FIG11_TOLERANCES) <= set(want)


if __name__ == "__main__":
    want = jax_fig11_summary()
    print(json.dumps(want, indent=1))
    if "--port" in sys.argv[1:]:
        got = chip_smoke.port_fig11_reference(device="cpu")
        print("port on the CPU: " + json.dumps(got, indent=1))
        print("differences: " + json.dumps(chip_smoke.compare_fig11(got, want)))
        print("largest: " + json.dumps({k: abs(got[k] - want[k]) for k in want}))
