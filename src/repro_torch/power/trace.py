"""Workload power-trace synthesis (paper §7.1 testbench, Fig. 3/9/13).

Port of the ``TestbenchSpec`` entry points of ``repro.power.trace``: the
testbench trace (iteration compute/communicate square waves, periodic
checkpoint dips, a warm-up ramp, an abrupt job termination, an optional
mid-trace fault) compiled into the scenario IR and rendered by
``scenario.render``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.power import scenario as SC
from repro_torch.utils.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class TestbenchSpec:
    __test__ = False  # not a pytest test class

    duration_s: float = 240.0
    sample_hz: float = 1000.0
    iteration_period_s: float = 22.0  # compute+communicate cycle
    comm_fraction: float = 0.114  # fraction of the iteration in comms
    p_compute: float = 0.92  # per-unit power while computing
    p_comm: float = 0.25  # per-unit power during exposed communication
    dip_period_s: float = 110.0  # checkpoint stalls
    dip_duration_s: float = 3.0
    p_dip: float = 0.15
    warmup_s: float = 8.0
    p_idle: float = 0.10
    terminate_at_s: float | None = None  # abrupt drop to idle (job end)
    fault_at_s: float | None = None  # near-instantaneous full drop (Fig. 13)
    fault_duration_s: float = 20.0
    edge_time_s: float = 0.25  # transitions move over hundreds of ms
    noise_std: float = 0.01


def scenario_from_testbench(
    spec: TestbenchSpec, *, noise_seed: int | None = None, device="cuda"
) -> SC.Scenario:
    """Compile a ``TestbenchSpec`` into the scenario IR on ``device``."""
    params = SC.workload(
        iteration_period_s=spec.iteration_period_s,
        comm_fraction=spec.comm_fraction,
        p_compute=spec.p_compute,
        p_comm=spec.p_comm,
        dip_period_s=spec.dip_period_s,
        dip_duration_s=spec.dip_duration_s,
        p_dip=spec.p_dip,
        warmup_s=spec.warmup_s,
        p_idle=spec.p_idle,
        t_end_s=SC.NEVER if spec.terminate_at_s is None else spec.terminate_at_s,
        fault_at_s=SC.NEVER if spec.fault_at_s is None else spec.fault_at_s,
        fault_duration_s=spec.fault_duration_s,
        noise_std=spec.noise_std,
        device=device,
    )
    return SC.make_scenario(
        params,
        duration_s=spec.duration_s,
        sample_hz=spec.sample_hz,
        edge_time_s=spec.edge_time_s,
        noise_seed=noise_seed,
    )


def testbench_trace(
    spec: TestbenchSpec,
    generator: torch.Generator | None = None,
    *,
    device="cuda",
) -> tuple[torch.Tensor, float]:
    """Synthesize the testbench trace; returns ``(trace (T,), dt)``.

    With a ``generator`` the legacy whole-trace Gaussian measurement noise
    (``noise_std``) is drawn from it and the trace clipped to [0, 1], as
    the reference does with a ``jax.random`` key.  The port cannot
    reproduce ``jax.random``'s threefry bits, so the same seed gives a
    different noise realization than the reference; chunk-invariant
    counter-hashed noise (identical bits in both packages) is
    ``scenario_from_testbench(..., noise_seed=...)``.
    """
    dev = resolve_device(device)
    s = scenario_from_testbench(spec, device=dev)
    p, dt = SC.render_trace(s)
    if generator is not None and spec.noise_std > 0:
        noise = torch.randn(p.shape, generator=generator, device=dev, dtype=torch.float32)
        p = torch.clamp(p + spec.noise_std * noise, 0.0, 1.0)
    return p, dt
