"""Declarative scenario engine: workload events -> batched, chunk-renderable traces.

Port of ``repro.power.scenario`` on the parametric path.  A scenario is a
struct of per-rack workload parameters (``WorkloadParams``: warmup ramp,
iteration compute/communicate wave, periodic checkpoint dips, job
start/stop envelope, fault window, diurnal inference envelope, noise)
whose float32 leaves carry a rack axis ``(R,)`` for a heterogeneous fleet.
``render(scenario, t0, n)`` is a pure function of the absolute sample
index, so chunked rendering equals whole-trace rendering bit for bit and
serves as the fleet engines' chunk provider; chunks are rendered on the
scenario's device.

Numerics against the reference: the workload columns and the noise
hash are bitwise; ``_floor_mod`` is exact; cos and erfinv are evaluated in
float64 and rounded (torch's float32 versions differ from XLA's, and on
the CPU torch's vectorized and scalar paths can differ by an ulp, which
would break chunk invariance), so the rendered trace agrees with the
reference to a tolerance (tests).  A scenario may instead carry an
explicit segment table (``seg_bounds``/``seg_powers``, compiled from a
phase timeline by ``from_phase_timeline``): the piecewise-constant base
that ``power.integration.PowerSim`` renders each training step from.  The
stochastic fault schedules (``faults``/``attach_faults``) are a later
slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils.devices import resolve_device
from repro_torch.utils.structures import Struct

F32 = torch.float32
# "never happens" sentinel for event times (float32-representable).
NEVER = 1e30
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class WorkloadParams(Struct):
    """Parametric per-rack workload (struct of float32 tensors, each ``()``
    for one rack or ``(R,)`` for a rack batch)."""

    iteration_period_s: torch.Tensor
    comm_fraction: torch.Tensor
    p_compute: torch.Tensor
    p_comm: torch.Tensor
    dip_period_s: torch.Tensor
    dip_duration_s: torch.Tensor
    p_dip: torch.Tensor
    warmup_s: torch.Tensor
    p_idle: torch.Tensor
    t_start_s: torch.Tensor
    t_end_s: torch.Tensor
    fault_at_s: torch.Tensor
    fault_duration_s: torch.Tensor
    p_fault: torch.Tensor
    diurnal_period_s: torch.Tensor
    diurnal_amp: torch.Tensor
    diurnal_phase_s: torch.Tensor
    scale: torch.Tensor
    noise_std: torch.Tensor

    def leaves(self) -> list[torch.Tensor]:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def _validate_workload(w: WorkloadParams) -> WorkloadParams:
    fd = w.fault_duration_s.detach().cpu().numpy()
    if np.any(fd < 0.0):
        raise ValueError(
            f"fault_duration_s must be >= 0, got {fd} — a negative window "
            "would silently render as no fault at all"
        )
    fa = w.fault_at_s.detach().cpu().numpy()
    if np.any(fa < 0.0):
        raise ValueError(f"fault_at_s must be >= 0 (or NEVER to disable), got {fa}")
    return w


def workload(
    *,
    iteration_period_s=22.0,
    comm_fraction=0.114,
    p_compute=0.92,
    p_comm=0.25,
    dip_period_s=110.0,
    dip_duration_s=3.0,
    p_dip=0.15,
    warmup_s=8.0,
    p_idle=0.10,
    t_start_s=0.0,
    t_end_s=NEVER,
    fault_at_s=NEVER,
    fault_duration_s=20.0,
    p_fault=0.02,
    diurnal_period_s=NEVER,
    diurnal_amp=0.0,
    diurnal_phase_s=0.0,
    scale=1.0,
    noise_std=0.01,
    device="cuda",
) -> WorkloadParams:
    """Build ``WorkloadParams`` from keyword knobs (scalars or (R,) arrays)."""
    dev = resolve_device(device)
    as32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return _validate_workload(WorkloadParams(
        iteration_period_s=as32(iteration_period_s),
        comm_fraction=as32(comm_fraction),
        p_compute=as32(p_compute),
        p_comm=as32(p_comm),
        dip_period_s=as32(dip_period_s),
        dip_duration_s=as32(dip_duration_s),
        p_dip=as32(p_dip),
        warmup_s=as32(warmup_s),
        p_idle=as32(p_idle),
        t_start_s=as32(t_start_s),
        t_end_s=as32(t_end_s),
        fault_at_s=as32(fault_at_s),
        fault_duration_s=as32(fault_duration_s),
        p_fault=as32(p_fault),
        diurnal_period_s=as32(diurnal_period_s),
        diurnal_amp=as32(diurnal_amp),
        diurnal_phase_s=as32(diurnal_phase_s),
        scale=as32(scale),
        noise_std=as32(noise_std),
    ))


def stack_workloads(params_list: list[WorkloadParams]) -> WorkloadParams:
    """Stack per-rack scalar params into one (R,)-batched ``WorkloadParams``."""
    return WorkloadParams(**{
        f.name: torch.stack([getattr(p, f.name).reshape(()) for p in params_list])
        for f in dataclasses.fields(WorkloadParams)
    })


@dataclasses.dataclass(frozen=True)
class Scenario(Struct):
    """A renderable scenario: parametric workloads or a segment table.

    If ``seg_powers`` is present the base waveform is the piecewise-constant
    segment lookup (``seg_bounds`` holds int32 start-sample indices,
    ``seg_bounds[0] == 0``; ``seg_powers`` is ``(K,)`` shared or ``(R, K)``
    per rack, noise at ``seg_noise_std``); otherwise it is the parametric
    ``params`` workload.  (The reference's fault-schedule field comes with
    its slice.)"""

    params: WorkloadParams | None = None
    seg_bounds: torch.Tensor | None = None
    seg_powers: torch.Tensor | None = None
    # Noise level of a segment-table scenario (parametric scenarios carry
    # theirs in ``params.noise_std``); None = 0.
    seg_noise_std: torch.Tensor | None = None
    # uint32 XORed into the noise lane hash (decorrelated noise streams of
    # otherwise identical scenarios); None keeps the unsalted stream.
    noise_salt: int | None = None
    sample_hz: float = 1000.0
    total_samples: int = 0
    # Edge smoothing window in samples (0/1 = off).
    edge_width: int = 0
    # Smoothing boundary: "zero" (legacy boxcar) or "clamp" (replicate).
    edge_pad: str = "zero"
    # Counter-hashed noise seed; None disables noise.
    noise_seed: int | None = None

    @property
    def duration_s(self) -> float:
        return self.total_samples / self.sample_hz

    @property
    def dt(self) -> float:
        return 1.0 / self.sample_hz

    @property
    def device(self) -> torch.device:
        return (self.seg_powers if self.seg_powers is not None else self.params.p_idle).device

    @property
    def n_racks(self) -> int | None:
        """Rack batch size, or None for an unbatched (T,) scenario."""
        if self.seg_powers is not None and self.seg_powers.ndim == 2:
            return self.seg_powers.shape[0]
        if self.params is not None:
            for leaf in self.params.leaves():
                if leaf.ndim == 1:
                    return leaf.shape[0]
        return None


def _edge_width(edge_time_s: float, sample_hz: float) -> int:
    return max(int(round(edge_time_s * sample_hz)), 1) if edge_time_s > 0 else 0


def make_scenario(
    params: WorkloadParams,
    *,
    duration_s: float,
    sample_hz: float,
    edge_time_s: float = 0.25,
    edge_pad: str = "zero",
    noise_seed: int | None = None,
    faults=None,
) -> Scenario:
    """Wrap parametric workloads into a renderable ``Scenario`` on the
    params' device.  A scripted ``fault_at_s`` past the end is rejected."""
    if faults is not None:
        raise NotImplementedError(
            "fault schedules are not ported yet (ROADMAP.md queue 1 item 8)"
        )
    total = int(round(duration_s * sample_hz))
    if edge_pad not in ("zero", "clamp"):
        raise ValueError(f"edge_pad must be 'zero' or 'clamp', got {edge_pad!r}")
    fa = params.fault_at_s.detach().cpu().numpy()
    scripted = fa < 0.5 * NEVER
    if np.any(scripted & (fa * sample_hz >= total)):
        bad = fa[scripted & (fa * sample_hz >= total)]
        raise ValueError(
            f"fault_at_s {np.unique(bad)} is past the scenario end "
            f"({duration_s} s = {total} samples); use NEVER to disable"
        )
    return Scenario(
        params=params,
        sample_hz=float(sample_hz),
        total_samples=total,
        edge_width=_edge_width(edge_time_s, sample_hz),
        edge_pad=edge_pad,
        noise_seed=noise_seed,
    )


# ------------------------------------------------------------------ rendering


def _floor_mod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact floor-mod ``x mod y`` for ``y > 0`` (numpy/jnp semantics) by a
    Dekker-split product: ``k = trunc(x / y)``, ``r = x - k y`` exact,
    ``k`` corrected by one, then the floor fixup.  Every op is rounded on
    its own (eager PyTorch contracts nothing), which the split needs."""
    c = 4097.0  # 2^12 + 1 Dekker splitter

    def sub_prod(x, k, y):
        ck = c * k
        k_hi = ck - (ck - k)
        k_lo = k - k_hi
        cy = c * y
        y_hi = cy - (cy - y)
        y_lo = y - y_hi
        p_hi = k * y
        p_lo = ((k_hi * y_hi - p_hi) + k_hi * y_lo + k_lo * y_hi) + k_lo * y_lo
        return (x - p_hi) - p_lo

    k = torch.trunc(x / y)
    r1 = sub_prod(x, k, y)
    k = k + (r1 >= y).to(x.dtype) - (r1 < 0).to(x.dtype)
    rc = sub_prod(x, k, y)
    return torch.where(rc < 0, rc + y, rc)


def _cos32(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine evaluated in float64 (see module docstring)."""
    return torch.cos(x.to(torch.float64)).to(F32)


def _parametric_base(w: WorkloadParams, t: torch.Tensor, dt: float) -> torch.Tensor:
    """Per-sample base power at times ``t`` (seconds); pure and elementwise,
    in the reference's order (wave -> dips -> warmup -> envelope)."""
    batched = any(leaf.ndim == 1 for leaf in w.leaves())
    if batched:
        t = t[:, None]
    te = t - w.t_start_s
    phase = _floor_mod(te, w.iteration_period_s) / w.iteration_period_s
    p = torch.where(phase >= 1.0 - w.comm_fraction, w.p_comm, w.p_compute)
    in_dip = (_floor_mod(te, w.dip_period_s) < w.dip_duration_s) & (
        w.dip_period_s < 0.5 * NEVER
    )
    p = torch.where(in_dip, w.p_dip, p)
    ramp = torch.clamp(te / torch.clamp(w.warmup_s, min=dt), 0.0, 1.0)
    p = w.p_idle + ramp * (p - w.p_idle)
    period = torch.clamp(w.diurnal_period_s, min=dt)
    env = 1.0 - w.diurnal_amp * 0.5 * (
        1.0 - _cos32(float(np.float32(2.0 * np.pi)) * (t - w.diurnal_phase_s) / period)
    )
    p = torch.where(w.diurnal_amp > 0.0, w.p_idle + env * (p - w.p_idle), p)
    return torch.where((te < 0.0) | (t >= w.t_end_s), w.p_idle, p)


def _segment_base(s: Scenario, idx: torch.Tensor) -> torch.Tensor:
    """The segment table's power at each absolute sample index."""
    j = torch.clamp(
        torch.searchsorted(s.seg_bounds, idx.to(s.seg_bounds.dtype), right=True) - 1,
        0, s.seg_bounds.shape[0] - 1,
    )
    if s.seg_powers.ndim == 2:
        return s.seg_powers[:, j].T  # (n, R)
    return s.seg_powers[j]


def _base(s: Scenario, idx: torch.Tensor) -> torch.Tensor:
    if s.seg_powers is not None:
        return _segment_base(s, idx)
    return _parametric_base(s.params, idx.to(F32) * s.dt, s.dt)


def _window_mean(base: torch.Tensor, n: int, w: int) -> torch.Tensor:
    """Mean over the ``w``-sample boxcar from shared dyadic partial sums,
    with the reference's fixed stitch topology (so chunked rendering stays
    bitwise equal to the whole trace); the ``1/w`` is a float32 reciprocal
    multiply, as the reference's compiled division by a constant is."""
    levels = {1: base}
    k = 1
    while 2 * k <= w:
        s = levels[k]
        levels[2 * k] = s[:-k] + s[k:]
        k *= 2
    acc, off, rem = None, 0, w
    while rem:
        p = 1 << (rem.bit_length() - 1)
        part = levels[p][off : off + n]
        acc = part if acc is None else acc + part
        off += p
        rem -= p
    return acc * float(np.float32(1.0) / np.float32(w))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for uint32 values held in int64, without
    overflowing int64: the product is split at 16 bits."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit avalanche finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _hash_bits(
    seed: int, idx: torch.Tensor, r: int, salt: int | None = None
) -> torch.Tensor:
    """The 24 uniform bits ``h >> 8`` of the reference's noise hash, an
    ``(n, r)`` int64 tensor: per-rack lane seeds mixed once, then one
    murmur3 finalizer per sample (uint32 wraparound emulated in int64
    masked to 32 bits)."""
    s = int(seed) & _MASK32
    seed_mix = ((s * 0x85EBCA6B) + 0x2545F491) & _MASK32
    lanes = torch.arange(r, dtype=torch.int64, device=idx.device)
    lane_seed = _mul32(lanes, 0x9E3779B9) ^ seed_mix
    if salt is not None:
        lane_seed = lane_seed ^ (int(salt) & _MASK32)
    lane = _fmix32(lane_seed)
    h = _fmix32((idx.to(torch.int64) & _MASK32)[:, None] ^ lane[None, :])
    return h >> 8


def _hash_normal(
    seed: int, idx: torch.Tensor, tail: tuple[int, ...], salt: int | None = None
) -> torch.Tensor:
    """Counter-hashed standard-normal noise, pure in the absolute sample
    index: ``sqrt(2) erfinv(2u - 1)`` with ``u`` centred in
    ``[2^-25, 1 - 2^-25]`` from ``_hash_bits`` (bitwise the reference's
    hash); erfinv in float64, rounded."""
    u = _hash_bits(seed, idx, tail[0] if tail else 1, salt).to(F32) * float(2.0**-24)
    u = u + float(2.0**-25)
    z = float(np.float32(np.sqrt(2.0))) * torch.erfinv(
        (2.0 * u - 1.0).to(torch.float64)
    ).to(F32)
    return z if tail else z[:, 0]


def render(s: Scenario, t0: int, n: int) -> torch.Tensor:
    """Render ``n`` samples starting at absolute sample ``t0`` on the
    scenario's device: ``(n,)`` unbatched or ``(n, R)``.  Pure in the
    absolute index, so any chunking concatenates to the whole trace bit
    for bit."""
    dev = s.device
    idx = int(t0) + torch.arange(n, dtype=torch.int32, device=dev)
    w = s.edge_width
    if w > 1:
        # Zero-padded window mean over [i-(w-1-c), i+c], c=(w-1)//2 — the
        # window of np.convolve(p, ones(w)/w, mode="same").
        c = (w - 1) // 2
        lo = w - 1 - c
        eidx = (int(t0) - lo) + torch.arange(n + w - 1, dtype=torch.int32, device=dev)
        if s.edge_pad == "clamp":
            base = _base(s, torch.clamp(eidx, 0, s.total_samples - 1))
        else:
            base = _base(s, eidx)
            valid = (eidx >= 0) & (eidx < s.total_samples)
            base = torch.where(valid if base.ndim == 1 else valid[:, None], base, 0.0)
        p = _window_mean(base, n, w)
    else:
        p = _base(s, idx)

    wp = s.params
    if wp is not None:
        # Fault window bypasses edge smoothing (paper Fig. 13).
        t = idx.to(F32) * s.dt
        tb = t[:, None] if p.ndim == 2 else t
        in_fault = (tb >= wp.fault_at_s) & (tb < wp.fault_at_s + wp.fault_duration_s)
        p = torch.where(in_fault, wp.p_fault, p)
    if s.noise_seed is not None:
        noise = _hash_normal(s.noise_seed, idx, tuple(p.shape[1:]), s.noise_salt)
        if wp is not None:
            std = wp.noise_std
        else:
            std = s.seg_noise_std if s.seg_noise_std is not None else 0.0
        p = torch.clamp(p + std * noise, 0.0, 1.0)
    if wp is not None:
        p = p * wp.scale
    return p.to(F32)


def render_padded(s: Scenario, t0: int, n: int) -> torch.Tensor:
    """``render`` with zero-order-hold padding past the scenario end: rows
    at absolute indices ``>= total_samples`` repeat the chunk's last
    in-range sample.  Requires ``t0 < total_samples``."""
    tr = render(s, t0, n)
    last = min(max(s.total_samples - 1 - int(t0), 0), n - 1)
    if last < n - 1:
        tr = torch.cat([tr[: last + 1], tr[last : last + 1].expand((n - 1 - last,) + tr.shape[1:])])
    return tr


def chunk_count(s: Scenario, chunk_samples: int) -> int:
    """Number of ``chunk_samples``-sample chunks covering the scenario."""
    if chunk_samples <= 0:
        raise ValueError(f"chunk_samples must be positive, got {chunk_samples}")
    return -(-s.total_samples // int(chunk_samples))


def render_trace(s: Scenario) -> tuple[torch.Tensor, float]:
    """Render the whole scenario; returns ``(trace, dt)``."""
    return render(s, 0, s.total_samples), s.dt


def chunk_provider(s: Scenario):
    """A ``f(t0, n) -> (n, R)`` chunk provider for the host fleet engine;
    chunks are rendered on the scenario's device."""

    def provider(t0: int, n: int) -> torch.Tensor:
        return render(s, t0, int(n))

    return provider


# ------------------------------------------------- compiled phase timelines


def from_phase_timeline(
    durations_s,
    powers,
    sample_hz: float,
    *,
    edge_time_s: float = 0.1,
    noise_seed: int | None = None,
    noise_std: float = 0.01,
    device="cuda",
) -> Scenario:
    """Compile an explicit phase timeline into a segment-table scenario on
    ``device``: each phase gets ``max(round(duration * hz), 1)`` samples
    and transitions get boxcar edges of ``edge_time_s``.  ``powers`` may
    be ``(K,)`` or a per-rack ``(R, K)``.  Measurement noise at
    ``noise_std`` is enabled by passing ``noise_seed``."""
    dev = resolve_device(device)
    durations = np.asarray(durations_s, np.float64)
    counts = np.maximum(np.round(durations * sample_hz).astype(np.int64), 1)
    bounds = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    return Scenario(
        params=None,
        seg_bounds=torch.as_tensor(bounds, device=dev),
        seg_powers=torch.as_tensor(np.asarray(powers, np.float32), device=dev),
        seg_noise_std=torch.tensor(noise_std, dtype=F32, device=dev),
        sample_hz=float(sample_hz),
        total_samples=int(counts.sum()),
        edge_width=_edge_width(edge_time_s, sample_hz),
        noise_seed=noise_seed,
    )


# ------------------------------------------------------- model-derived racks


def workload_from_model(
    arch: str,
    *,
    hw=None,
    phase_model=None,
    tokens_per_step: float = 2**20,
    min_exposed_fraction: float = 0.08,
    device="cuda",
    **overrides,
) -> WorkloadParams:
    """Derive a rack workload from an assigned model config's step cost
    (``configs.registry.step_cost`` through ``phases.step_phases``); the
    exposed-communication share is floored at ``min_exposed_fraction`` of
    the busy time and checkpoint stalls become the periodic dips.  The
    phase model keeps the reference's TPU v5e power constants, which fix
    the workloads' shape (not a speed claim of the port)."""
    from repro_torch.configs import registry
    from repro_torch.power import phases as P

    hw = hw or P.HardwareConstants()
    pm = phase_model or P.PhaseModel()
    cost = registry.step_cost(arch, tokens_per_step=tokens_per_step)
    d, pw = P.step_phases(cost, hw, pm)
    t_busy = float(d[0])
    t_exposed = max(float(d[1]), min_exposed_fraction * t_busy)
    period = t_busy + t_exposed
    dev = pm.device
    p_idle = dev.p_idle_w / dev.p_peak_w
    knobs = dict(
        iteration_period_s=period,
        comm_fraction=t_exposed / period,
        p_compute=float(pw[0]),
        p_comm=float(pw[1]),
        dip_period_s=(
            pm.checkpoint_every_steps * period if pm.checkpoint_every_steps else NEVER
        ),
        dip_duration_s=pm.checkpoint_stall_s,
        p_dip=p_idle,
        p_idle=p_idle,
        warmup_s=10.0,
    )
    knobs.update(overrides)
    return workload(**knobs, device=device)


def inference_workload(
    *,
    p_idle: float = 0.15,
    p_peak: float = 0.75,
    diurnal_period_s: float = 600.0,
    diurnal_amp: float = 0.85,
    diurnal_phase_s: float = 0.0,
    iteration_period_s: float = 0.5,
    comm_fraction: float = 0.2,
    device="cuda",
    **overrides,
) -> WorkloadParams:
    """A serving rack: fast shallow batching ripple under a deep diurnal
    envelope."""
    knobs = dict(
        iteration_period_s=iteration_period_s,
        comm_fraction=comm_fraction,
        p_compute=p_peak,
        p_comm=p_peak * 0.8,
        dip_period_s=NEVER,
        dip_duration_s=0.0,
        p_dip=p_idle,
        p_idle=p_idle,
        warmup_s=5.0,
        diurnal_period_s=diurnal_period_s,
        diurnal_amp=diurnal_amp,
        diurnal_phase_s=diurnal_phase_s,
    )
    knobs.update(overrides)
    return workload(**knobs, device=device)


def mixed_campus(
    n_racks: int,
    archs: tuple[str, ...],
    *,
    duration_s: float = 240.0,
    sample_hz: float = 200.0,
    seed: int = 0,
    inference_fraction: float = 0.25,
    stagger_s: float = 30.0,
    stop_fraction: float = 0.15,
    fault_rack_fraction: float = 0.1,
    fault_at_s: float | None = None,
    fault_cascade_s: float = 5.0,
    fault_duration_s: float = 30.0,
    edge_time_s: float = 0.25,
    edge_pad: str = "zero",
    noise_seed: int | None = None,
    device="cuda",
) -> Scenario:
    """A heterogeneous campus: training racks cycling the given model
    workloads, an inference-diurnal block, staggered job starts, early job
    terminations and a mid-trace fault cascade over a contiguous rack
    range.  The per-rack columns are drawn with numpy exactly as the
    reference draws them, so they are bitwise equal to its columns."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_inf = int(round(n_racks * inference_fraction))
    n_train = n_racks - n_inf

    as_floats = lambda w: {f.name: float(getattr(w, f.name)) for f in dataclasses.fields(w)}
    train_templates = [as_floats(workload_from_model(a, device="cpu")) for a in archs]
    inf_template = as_floats(
        inference_workload(diurnal_period_s=duration_s / 1.5, device="cpu")
    )
    cols: dict[str, np.ndarray] = {}
    for f in dataclasses.fields(WorkloadParams):
        train_vals = [train_templates[i % len(train_templates)][f.name] for i in range(n_train)]
        cols[f.name] = np.asarray(train_vals + [inf_template[f.name]] * n_inf, np.float32)
    cols["diurnal_phase_s"][n_train:] = rng.uniform(0.0, duration_s, n_inf)

    cols["t_start_s"] = rng.uniform(0.0, stagger_s, n_racks).astype(np.float32)
    n_stop = int(round(n_racks * stop_fraction))
    stop_idx = rng.choice(n_racks, size=n_stop, replace=False)
    cols["t_end_s"][stop_idx] = rng.uniform(0.7, 0.95, n_stop) * duration_s

    n_fault = int(round(n_racks * fault_rack_fraction))
    if n_fault:
        f0 = duration_s * 0.6 if fault_at_s is None else fault_at_s
        lo = int(rng.integers(0, max(n_racks - n_fault, 1)))
        cols["fault_at_s"][lo : lo + n_fault] = f0 + np.linspace(
            0.0, fault_cascade_s, n_fault, dtype=np.float32
        )
    cols["fault_duration_s"] = np.full(n_racks, fault_duration_s, np.float32)
    cols["scale"] = (1.0 + 0.05 * rng.uniform(-1.0, 1.0, n_racks)).astype(np.float32)
    params = WorkloadParams(**{k: torch.as_tensor(v, device=dev) for k, v in cols.items()})
    return make_scenario(
        params,
        duration_s=duration_s,
        sample_hz=sample_hz,
        edge_time_s=edge_time_s,
        edge_pad=edge_pad,
        noise_seed=noise_seed,
    )
