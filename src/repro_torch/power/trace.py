"""Workload power-trace synthesis (paper §7.1 testbench, Fig. 3/9/13).

Port of ``repro.power.trace``: the testbench trace (iteration
compute/communicate square waves, periodic checkpoint dips, a warm-up
ramp, an abrupt job termination, an optional mid-trace fault) and explicit
phase timelines, compiled into the scenario IR and rendered by
``scenario.render``, and the reference's two golden oracles for them
(``testbench_trace_reference``, ``phase_timeline_trace_reference``), each
kept as an independent implementation.
"""
from __future__ import annotations

import dataclasses

import numpy as np
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


def testbench_trace_reference(
    spec: TestbenchSpec,
    generator: torch.Generator | None = None,
    *,
    device="cuda",
) -> tuple[torch.Tensor, float]:
    """The reference's original whole-trace implementation, kept as the
    golden oracle for the scenario engine (``testbench_trace``): the
    square wave, dips, warm-up ramp and termination evaluated on the sample
    times, boxcar edges of ``edge_time_s`` as a centred window sum (zero
    beyond the ends, ``np.convolve(..., "same")``), then the fault.  The
    noise is drawn from ``generator`` as in ``testbench_trace``."""
    dev = resolve_device(device)
    dt = 1.0 / spec.sample_hz
    t = torch.arange(int(round(spec.duration_s * spec.sample_hz)), device=dev) * dt
    # fmod is the reference's floor mod for the non-negative times.
    phase = torch.fmod(t, spec.iteration_period_s) / spec.iteration_period_s
    in_comm = phase >= (1.0 - spec.comm_fraction)
    p = torch.where(in_comm, spec.p_comm, spec.p_compute).to(torch.float32)
    in_dip = torch.fmod(t, spec.dip_period_s) < spec.dip_duration_s
    p = torch.where(in_dip, spec.p_dip, p)
    ramp = torch.clamp(t / max(spec.warmup_s, dt), 0.0, 1.0)
    p = spec.p_idle + ramp * (p - spec.p_idle)
    if spec.terminate_at_s is not None:
        p = torch.where(t >= spec.terminate_at_s, spec.p_idle, p)
    if spec.edge_time_s > 0:
        width = max(int(round(spec.edge_time_s * spec.sample_hz)), 1)
        kernel = torch.full((width,), 1.0 / width, dtype=torch.float32, device=dev)
        padded = torch.nn.functional.pad(p, (width // 2, (width - 1) // 2))
        p = (padded.unfold(0, width, 1) * kernel).sum(dim=-1)
    if spec.fault_at_s is not None:
        in_fault = (t >= spec.fault_at_s) & (t < spec.fault_at_s + spec.fault_duration_s)
        p = torch.where(in_fault, 0.02, p)
    if generator is not None and spec.noise_std > 0:
        noise = torch.randn(p.shape, generator=generator, device=dev, dtype=torch.float32)
        p = torch.clamp(p + spec.noise_std * noise, 0.0, 1.0)
    return p, dt


def choukse_spec() -> TestbenchSpec:
    """The default evaluation trace's spec (paper Fig. 3/9): 240 s at
    1 kHz, job end at 210 s."""
    return TestbenchSpec(duration_s=240.0, terminate_at_s=210.0)


def choukse_testbench(generator: torch.Generator | None = None, *, device="cuda"):
    """``testbench_trace(choukse_spec(), generator)``."""
    return testbench_trace(choukse_spec(), generator, device=device)


def titanx_spec() -> TestbenchSpec:
    """A 2-GPU Titan-X-style GPT-125M profile (paper §7.1): slower steps,
    checkpoint stalls, normalized to blade TDP; 300 s at 200 Hz."""
    return TestbenchSpec(
        duration_s=300.0,
        sample_hz=200.0,
        iteration_period_s=1.2,
        comm_fraction=0.15,
        p_compute=0.88,
        p_comm=0.55,
        dip_period_s=30.0,
        dip_duration_s=4.0,
        p_dip=0.22,
        warmup_s=5.0,
        p_idle=0.06,  # 15 W / 250 W
        terminate_at_s=280.0,
    )


def titanx_testbench(generator: torch.Generator | None = None, *, device="cuda"):
    """``testbench_trace(titanx_spec(), generator)`` (paper Fig. 11's trace)."""
    return testbench_trace(titanx_spec(), generator, device=device)


def cluster_fault_spec() -> TestbenchSpec:
    """Paper Fig. 13: a 40 MW cluster (scaled from H100 measurements) with a
    computation fault at t = 400 s causing a near-instant full drop."""
    return TestbenchSpec(
        duration_s=600.0,
        sample_hz=500.0,
        iteration_period_s=4.0,
        comm_fraction=0.2,
        p_compute=0.95,
        p_comm=0.42,
        dip_period_s=60.0,
        dip_duration_s=2.0,
        p_dip=0.3,
        warmup_s=20.0,
        fault_at_s=400.0,
        fault_duration_s=25.0,
        terminate_at_s=560.0,
    )


def cluster_fault_trace(generator: torch.Generator | None = None, *, device="cuda"):
    """``testbench_trace(cluster_fault_spec(), generator)``."""
    return testbench_trace(cluster_fault_spec(), generator, device=device)


def phase_timeline_trace(
    durations_s,
    powers,
    sample_hz: float,
    *,
    edge_time_s: float = 0.1,
    device="cuda",
) -> tuple[torch.Tensor, float]:
    """Render an explicit phase timeline to a sampled trace on ``device``:
    ``scenario.from_phase_timeline``'s segment table (phase transitions get
    ``edge_time_s`` boxcar edges) rendered whole.  Returns ``(trace,
    dt)``."""
    s = SC.from_phase_timeline(durations_s, powers, sample_hz, edge_time_s=edge_time_s,
                               device=device)
    return SC.render_trace(s)


def phase_timeline_trace_reference(
    durations_s, powers, sample_hz: float, *, edge_time_s: float = 0.1, device="cuda"
) -> tuple[torch.Tensor, float]:
    """The reference's original numpy implementation, kept as the golden
    oracle for ``phase_timeline_trace``; the trace lands on ``device``."""
    durations = np.asarray(durations_s, np.float64)
    powers_np = np.asarray(powers, np.float32)
    counts = np.maximum(np.round(durations * sample_hz).astype(np.int64), 1)
    trace = np.repeat(powers_np, counts)
    if edge_time_s > 0:
        width = max(int(round(edge_time_s * sample_hz)), 1)
        kernel = np.ones((width,), np.float32) / width
        trace = np.convolve(trace, kernel, mode="same")
    return torch.as_tensor(trace, device=resolve_device(device)), 1.0 / sample_hz
