"""Stochastic fault/repair processes as scenario data.

Port of ``repro.power.faults``.  A ``FaultSchedule`` holds, per rack and
per channel (rack power loss, ESS-unit trip, sensor dropout), sorted
``(R, K)`` int32 start/end sample indices of its episodes; episode ``j`` of
rack ``r`` is active over ``[start[r, j], end[r, j])`` and unused slots are
empty (``start == end``) after the real ones.  Every signal derived from it
is a pure function of the absolute sample index, so chunked evaluation
equals whole-trace evaluation bit for bit.

Sampling draws the reference's uniforms: ``_threefry`` is a numpy copy of
the threefry-2x32 generator behind ``jax.random.key`` / ``fold_in`` /
``uniform`` (the partitionable bit layout, float32 uniforms), so
``sample_schedule`` returns the reference's tables bit for bit.  The
geometric durations that follow are float64 numpy in both packages.

Every signal goes through one membership primitive, ``_started`` (how many
boundaries of a sorted row are at or before an index), with the
reference's two backends: ``"legacy"`` (``torch.searchsorted``) and
``"compiled"`` (K elementwise compares).  Both give the same integers, so
every float that follows is the same.  The schedule's tables live on the
device the caller names; sampling and validation run on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils.devices import resolve_device
from repro_torch.utils.structures import Struct

I32 = torch.int32
F32 = torch.float32

# "never happens" sentinel, as ``scenario.NEVER``.
NEVER = 1e30
# Episode-count cap per (rack, channel), as the reference's.
MAX_EPISODES = 512
# Widest episode axis the compiled membership path unrolls.
_UNROLL_MAX = 32
_PAD = np.iinfo(np.int32).max


# ---------------------------------------------------------- threefry-2x32


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def _threefry2x32(k1, k2, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block function (20 rounds) on uint32 arrays,
    broadcast elementwise: what ``jax._src.prng._threefry2x32_lowering``
    computes."""
    u = lambda v: np.atleast_1d(np.asarray(v, np.uint32))
    k1, k2, x0, x1 = u(k1), u(k2), u(x0), u(x1)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in rot[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _key(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``jax.random.key(seed)``'s two words for an int32 seed (the
    reference runs without 64-bit types): a logical shift leaves the high
    word 0, the low word is the seed's bits."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed must fit int32, got {seed}")
    return np.uint32(0), np.uint32(seed & 0xFFFFFFFF)


def _fold_in(key, data) -> tuple[np.ndarray, np.ndarray]:
    """``jax.random.fold_in``: the block function on the count ``(0,
    data)`` (``data`` a uint32 array folds in elementwise)."""
    return _threefry2x32(key[0], key[1], np.zeros_like(np.asarray(data, np.uint32)), data)


def _uniform(key, n: int, minval: float, maxval: float) -> np.ndarray:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for keys
    with a trailing batch of racks (``key`` words shaped ``(R,)``): the
    partitionable 32-bit draw (counts ``(0, i)``, the two output words
    XORed), 23 mantissa bits over 1.0f minus 1, then ``f * (maxval -
    minval) + minval`` with one rounding (XLA fuses the multiply-add) and
    floored at ``minval``.  Returns ``(R, n)`` float32."""
    k1 = np.asarray(key[0], np.uint32)[:, None]
    k2 = np.asarray(key[1], np.uint32)[:, None]
    cnt = np.arange(n, dtype=np.uint32)[None, :]
    b1, b2 = _threefry2x32(k1, k2, np.zeros_like(cnt), cnt)
    bits = (b1 ^ b2) >> np.uint32(9) | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # The float64 product of two float32 values is exact, so one rounding
    # of the float64 sum is the fused multiply-add.
    fused = (f.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, fused)


# ---------------------------------------------------------------- process


@dataclasses.dataclass(frozen=True)
class FaultProcess(Struct):
    """Per-channel alternating-renewal rates (seconds; float32 host arrays,
    scalars or ``(R,)``).  ``NEVER`` disables a channel; up and down times
    are geometric in samples with means MTBF and MTTR, at least one
    sample."""

    rack_mtbf_s: np.ndarray
    rack_mttr_s: np.ndarray
    ess_mtbf_s: np.ndarray
    ess_mttr_s: np.ndarray
    sensor_mtbf_s: np.ndarray
    sensor_mttr_s: np.ndarray
    p_fault: np.ndarray  # rack power while a rack-loss episode is active

    @staticmethod
    def create(
        *,
        rack_mtbf_s=NEVER,
        rack_mttr_s=30.0,
        ess_mtbf_s=NEVER,
        ess_mttr_s=60.0,
        sensor_mtbf_s=NEVER,
        sensor_mttr_s=5.0,
        p_fault=0.02,
    ) -> "FaultProcess":
        for name, mtbf, mttr in (
            ("rack", rack_mtbf_s, rack_mttr_s),
            ("ess", ess_mtbf_s, ess_mttr_s),
            ("sensor", sensor_mtbf_s, sensor_mttr_s),
        ):
            if np.any(np.asarray(mtbf, np.float64) <= 0.0):
                raise ValueError(
                    f"{name}_mtbf_s must be > 0 (got {mtbf}); use "
                    f"faults.NEVER to disable the channel"
                )
            if np.any(np.asarray(mttr, np.float64) <= 0.0):
                raise ValueError(f"{name}_mttr_s must be > 0 (got {mttr})")
        f = lambda v: np.asarray(v, np.float32)
        return FaultProcess(
            rack_mtbf_s=f(rack_mtbf_s), rack_mttr_s=f(rack_mttr_s),
            ess_mtbf_s=f(ess_mtbf_s), ess_mttr_s=f(ess_mttr_s),
            sensor_mtbf_s=f(sensor_mtbf_s), sensor_mttr_s=f(sensor_mttr_s),
            p_fault=f(p_fault),
        )


@dataclasses.dataclass(frozen=True)
class FaultSchedule(Struct):
    """A compiled fault schedule: per channel sorted ``(R, K)`` int32
    episode tables on one device, plus ``p_fault (R,)`` float32."""

    rack_start: torch.Tensor
    rack_end: torch.Tensor
    ess_start: torch.Tensor
    ess_end: torch.Tensor
    sensor_start: torch.Tensor
    sensor_end: torch.Tensor
    p_fault: torch.Tensor

    @property
    def n_racks(self) -> int:
        return self.rack_start.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rack_start.device

    def to(self, device) -> "FaultSchedule":
        dev = torch.device(device)
        return FaultSchedule(**{f.name: getattr(self, f.name).to(dev)
                                for f in dataclasses.fields(self)})


_CHANNELS = ("rack", "ess", "sensor")


def _schedule(tables: dict, p_fault, n_racks: int, device) -> FaultSchedule:
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)
    kw = {}
    for name in _CHANNELS:
        kw[f"{name}_start"], kw[f"{name}_end"] = (t(a) for a in tables[name])
    pf = np.broadcast_to(np.asarray(p_fault, np.float32), (n_racks,))
    return FaultSchedule(**kw, p_fault=torch.as_tensor(pf.copy(), device=dev))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ construction


def _geometric_samples(u: np.ndarray, mean_s, sample_hz: float) -> np.ndarray:
    """Geometric durations (samples, >= 1) with mean ``mean_s`` seconds, in
    float64 as the reference computes them."""
    n_bar = np.maximum(np.asarray(mean_s, np.float64) * sample_hz, 1.0)
    p = 1.0 / n_bar
    return np.floor(np.log(u) / np.log1p(-p)) + 1.0


def _channel_episodes(
    key, tag: int, n_racks: int, total_samples: int, sample_hz: float,
    mtbf_s, mttr_s, max_episodes: int | None,
) -> tuple[np.ndarray, np.ndarray]:
    """One channel's ``(R, K)`` start/end tables: alternating geometric
    up/down durations from a healthy start, truncated at the trace end,
    with the uniforms of ``fold_in(fold_in(key, tag), rack)`` as the
    reference draws them."""
    mtbf = np.broadcast_to(np.asarray(mtbf_s, np.float64), (n_racks,))
    mttr = np.broadcast_to(np.asarray(mttr_s, np.float64), (n_racks,))
    if max_episodes is None:
        cycle = (np.min(mtbf) + np.min(mttr)) * sample_hz
        expect = total_samples / max(cycle, 1.0)
        max_episodes = int(np.clip(np.ceil(3.0 * expect + 4.0), 1, MAX_EPISODES))
    k = int(max_episodes)
    ck = _fold_in(key, np.uint32(tag))
    rk = _fold_in((np.full(n_racks, ck[0]), np.full(n_racks, ck[1])),
                  np.arange(n_racks, dtype=np.uint32))
    u = _uniform(rk, 2 * k, 1e-7, 1.0).reshape(n_racks, k, 2).astype(np.float64)
    up = _geometric_samples(u[:, :, 0], mtbf[:, None], sample_hz)
    down = _geometric_samples(u[:, :, 1], mttr[:, None], sample_hz)
    start = np.cumsum(up, axis=1) + np.concatenate(
        [np.zeros((n_racks, 1)), np.cumsum(down, axis=1)[:, :-1]], axis=1
    )
    end = start + down
    t = float(total_samples)
    return np.clip(start, 0.0, t).astype(np.int32), np.clip(end, 0.0, t).astype(np.int32)


def sample_schedule(
    process: FaultProcess,
    n_racks: int,
    total_samples: int,
    sample_hz: float,
    *,
    seed: int,
    max_episodes: int | None = None,
    device="cuda",
) -> FaultSchedule:
    """Compile a ``FaultProcess`` into a ``FaultSchedule`` on ``device``;
    the tables equal the reference's ``sample_schedule`` bit for bit."""
    if total_samples <= 0:
        raise ValueError(f"total_samples must be positive, got {total_samples}")
    if n_racks <= 0:
        raise ValueError(f"n_racks must be positive, got {n_racks}")
    key = _key(seed)
    tables = {
        name: _channel_episodes(
            key, tag, n_racks, total_samples, sample_hz,
            getattr(process, f"{name}_mtbf_s"), getattr(process, f"{name}_mttr_s"),
            max_episodes,
        )
        for tag, name in enumerate(_CHANNELS)
    }
    return _schedule(tables, process.p_fault, n_racks, device)


def _coalesce(eps: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Union of sorted ``(start, end)`` intervals (overlaps and adjacency merge)."""
    out: list[tuple[int, int]] = []
    for a, b in eps:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _pack(rows: list[list[tuple[int, int]]]) -> tuple[np.ndarray, np.ndarray]:
    """Coalesced per-rack episode lists -> ``(R, K)`` tables padded with
    empty intervals at int32 max after the real episodes."""
    k = max(max((len(p) for p in rows), default=0), 1)
    start = np.full((len(rows), k), _PAD, np.int32)
    end = np.full((len(rows), k), _PAD, np.int32)
    for r, p in enumerate(rows):
        for j, (s, e) in enumerate(p):
            start[r, j], end[r, j] = s, e
    return start, end


def _episodes_by_rack(eps, n_racks: int) -> dict[int, list[tuple[int, int]]]:
    per: dict[int, list[tuple[int, int]]] = {}
    for r, s, e in eps:
        if not 0 <= r < n_racks:
            raise ValueError(f"rack index {r} outside fleet of {n_racks}")
        if e < s or s < 0:
            raise ValueError(f"bad episode [{s}, {e}) for rack {r}")
        per.setdefault(int(r), []).append((int(s), int(e)))
    return per


def schedule_from_episodes(
    n_racks: int,
    *,
    rack=(),
    ess=(),
    sensor=(),
    p_fault=0.02,
    device="cuda",
) -> FaultSchedule:
    """A scripted schedule from explicit ``(rack_idx, start, end)``
    episodes (sample indices, end exclusive), coalesced per rack."""
    tables = {}
    for name, eps in (("rack", rack), ("ess", ess), ("sensor", sensor)):
        per = _episodes_by_rack(eps, n_racks)
        tables[name] = _pack([_coalesce(sorted(per.get(r, []))) for r in range(n_racks)])
    return _schedule(tables, p_fault, n_racks, device)


def inject_episodes(s: FaultSchedule, *, rack=(), ess=(), sensor=()) -> FaultSchedule:
    """Merge scripted ``(rack_idx, start, end)`` episodes into ``s``: the
    injected episodes are unioned with each rack's real ones, rows
    re-sorted, coalesced and re-padded.  A channel with nothing injected
    keeps its tables."""
    tables = {}
    for name, extra in (("rack", rack), ("ess", ess), ("sensor", sensor)):
        st = _host(getattr(s, f"{name}_start"))
        en = _host(getattr(s, f"{name}_end"))
        per = _episodes_by_rack(extra, st.shape[0])
        if not per:
            tables[name] = (st, en)
            continue
        rows = []
        for r in range(st.shape[0]):
            real = en[r] > st[r]
            eps = [(int(a), int(b)) for a, b in zip(st[r][real], en[r][real])]
            rows.append(_coalesce(sorted(eps + per.get(r, []))))
        tables[name] = _pack(rows)
    return _schedule(tables, _host(s.p_fault), s.n_racks, s.device)


def select_racks(s: FaultSchedule, lo: int, hi: int) -> FaultSchedule:
    """The schedule of racks ``[lo, hi)``: their rows of every table (the
    episode width kept), as views on the device (a rank's block of a
    rack-sharded run; no host read, so a CUDA graph may capture it)."""
    return FaultSchedule(**{f.name: getattr(s, f.name)[lo:hi] for f in dataclasses.fields(s)})


def validate_tables(s: FaultSchedule) -> None:
    """Check the invariants the membership primitives assume: matching
    ``(R, K)`` tables, no inverted episode, rows sorted, real episodes
    non-overlapping with at least one clean sample between them, and empty
    slots (either padding convention) only after the real ones."""
    for name in _CHANNELS:
        st, en = _host(getattr(s, f"{name}_start")), _host(getattr(s, f"{name}_end"))
        if st.shape != en.shape or st.ndim != 2:
            raise ValueError(
                f"{name} episode tables must be matching (R, K) arrays, got "
                f"{st.shape} / {en.shape}"
            )
        if np.any(en < st):
            raise ValueError(
                f"{name} table has an inverted episode (end < start); "
                "episodes are [start, end) with end >= start"
            )
        real = en > st
        if st.shape[1] > 1:
            if np.any(st[:, 1:] < st[:, :-1]):
                raise ValueError(f"{name} table rows must be sorted ascending by start")
            if np.any(real[:, 1:] & ~real[:, :-1]):
                raise ValueError(
                    f"{name} table has a real episode after an empty padding "
                    "slot; pad unused slots only after the real episodes"
                )
            if np.any(real[:, 1:] & (st[:, 1:] <= en[:, :-1])):
                raise ValueError(
                    f"{name} table rows must be non-overlapping with a gap of at "
                    "least one sample between episodes"
                )


# -------------------------------------------------------------- membership


def _resolve_method(method: str, k: int) -> str:
    if method == "auto":
        return "compiled" if k <= _UNROLL_MAX else "legacy"
    if method not in ("compiled", "legacy"):
        raise ValueError(f"method must be 'auto', 'compiled' or 'legacy', got {method!r}")
    return method


def _started(table: torch.Tensor, idx: torch.Tensor, method: str) -> torch.Tensor:
    """``(R, n)`` int32: per rack, how many entries of the sorted ``(R, K)``
    boundary table are at or before each absolute index."""
    if _resolve_method(method, table.shape[1]) == "legacy":
        vals = idx[None, :].expand(table.shape[0], -1).contiguous()
        return torch.searchsorted(table.contiguous(), vals, right=True).to(I32)
    cnt = torch.zeros((table.shape[0], idx.shape[0]), dtype=I32, device=idx.device)
    for j in range(table.shape[1]):
        cnt = cnt + (table[:, j : j + 1] <= idx[None, :]).to(I32)
    return cnt


def _select_boundaries(starts, ends, idx, method):
    """``(cnt, st_sel, en_sel)``, each ``(R, n)``: the start count at each
    index and the boundaries of the most recently started episode (row 0's
    where none has started; callers gate on ``cnt > 0``)."""
    cnt = _started(starts, idx, method)
    if _resolve_method(method, starts.shape[1]) == "legacy":
        jc = torch.clamp(cnt - 1, 0, starts.shape[1] - 1).to(torch.int64)
        return cnt, torch.gather(starts, 1, jc), torch.gather(ends, 1, jc)
    st_sel = starts[:, :1].expand(cnt.shape)
    en_sel = ends[:, :1].expand(cnt.shape)
    for j in range(1, starts.shape[1]):
        pick = cnt >= (j + 1)
        st_sel = torch.where(pick, starts[:, j : j + 1], st_sel)
        en_sel = torch.where(pick, ends[:, j : j + 1], en_sel)
    return cnt, st_sel, en_sel


def _active(starts, ends, idx, method="auto") -> torch.Tensor:
    """``(n, R)`` bool: is an episode of each rack active at each index."""
    return (_started(starts, idx, method) - _started(ends, idx, method) > 0).T


def start_index(t0):
    """A window's absolute start sample as the window functions (and
    ``scenario.render``) take it: a Python int, or a 0-d int32 tensor on
    the schedule's device, which a CUDA graph reads at replay, so one
    captured graph serves every start."""
    return t0 if isinstance(t0, torch.Tensor) else int(t0)


def _window(s: FaultSchedule, t0, n: int) -> torch.Tensor:
    return start_index(t0) + torch.arange(n, dtype=I32, device=s.device)


def rack_down(s: FaultSchedule, t0, n: int, *, method: str = "auto") -> torch.Tensor:
    """``(n, R)`` bool: rack-power-loss membership for samples [t0, t0+n)."""
    return _active(s.rack_start, s.rack_end, _window(s, t0, n), method)


def _edge_intensity(starts, ends, idx, edge: int, method="auto") -> torch.Tensor:
    """``(n, R)`` float32 episode intensity in [0, 1], ramping 0 -> 1 over
    the ``edge`` samples after a start and 1 -> 0 after its end; binary
    membership for ``edge <= 1``.  The reference's arithmetic: ``inv =
    float32(1 / edge)``, ``clip((a + 1) inv) - clip((b + 1) inv)``."""
    if edge <= 1:
        return _active(starts, ends, idx, method).to(F32)
    inv = float(np.float32(1.0 / float(edge)))
    cnt, st_sel, en_sel = _select_boundaries(starts, ends, idx, method)
    a = (idx[None, :] - st_sel).to(F32)
    b = (idx[None, :] - en_sel).to(F32)
    w = torch.clamp((a + 1.0) * inv, 0.0, 1.0) - torch.clamp((b + 1.0) * inv, 0.0, 1.0)
    return torch.where(cnt > 0, w, 0.0).T


def fault_weight(s: FaultSchedule, t0, n: int, edge: int, *, method: str = "auto"):
    """``(n, R)`` float32 rack power-loss intensity, edges linearised over
    ``edge`` samples."""
    return _edge_intensity(s.rack_start, s.rack_end, _window(s, t0, n), edge, method)


def ess_weight(s: FaultSchedule, t0, n: int, edge: int, *, method: str = "auto"):
    """``(n, R)`` float32 per-sample ESS availability weight: 1 engaged, 0
    tripped, fractional over the ``edge``-sample converter wind-down and
    soft-start around each trip and repair."""
    return 1.0 - _edge_intensity(s.ess_start, s.ess_end, _window(s, t0, n), edge, method)


def sensor_down(s: FaultSchedule, t0, n: int, *, method: str = "auto") -> torch.Tensor:
    """``(n, R)`` bool: sensor-dropout membership for samples [t0, t0+n)."""
    return _active(s.sensor_start, s.sensor_end, _window(s, t0, n), method)


def _interval_starts(s: FaultSchedule, start_sample, n_intervals: int, k: int) -> torch.Tensor:
    return start_index(start_sample) + k * torch.arange(n_intervals, dtype=I32, device=s.device)


def interval_online(s: FaultSchedule, start_sample, n_intervals: int, k: int, *,
                    method: str = "auto") -> torch.Tensor:
    """``(n_intervals, R)`` float32 ESS availability, one row per controller
    interval: offline iff an ESS episode covers the interval's first
    sample."""
    idx = _interval_starts(s, start_sample, n_intervals, k)
    return 1.0 - _active(s.ess_start, s.ess_end, idx, method).to(F32)


def interval_sensed(s: FaultSchedule, start_sample, n_intervals: int, k: int, *,
                    stop=None, method: str = "auto") -> torch.Tensor:
    """``(n_intervals, R)`` bool: does each interval hold at least one
    finite sample?  Interval ``[i0, i0 + k)`` is dark iff the sensor
    episode active at ``i0`` ends at or after ``min(i0 + k, stop)``
    (``stop`` is where real samples end; padding repeats the last one)."""
    i0 = _interval_starts(s, start_sample, n_intervals, k)
    hi = i0 + k if stop is None else torch.clamp(i0 + k, max=start_index(stop))
    cnt, _, en_sel = _select_boundaries(s.sensor_start, s.sensor_end, i0, method)
    active = (cnt - _started(s.sensor_end, i0, method)) > 0
    return (~(active & (en_sel >= hi[None, :]))).T


def sensor_dark_hold(s: FaultSchedule, idx: torch.Tensor, *, method: str = "auto"):
    """``(dark, hold)``, each ``(n, R)``: sensor-dropout membership at the
    absolute indices ``idx`` and the index of the last finite sample
    before the covering episode (``start - 1``; arbitrary where not
    dark)."""
    cnt, st_sel, _ = _select_boundaries(s.sensor_start, s.sensor_end, idx, method)
    dark = (cnt - _started(s.sensor_end, idx, method)) > 0
    return dark.T, (st_sel - 1).T


def episodes_in_window(s: FaultSchedule, start_sample: int, stop_sample: int) -> list[dict]:
    """Every fault and repair edge in ``[start_sample, stop_sample)``,
    sorted by sample index (host-side, for audit logs)."""
    out: list[dict] = []
    for channel, name in (("rack_power", "rack"), ("ess", "ess"), ("sensor", "sensor")):
        st, en = _host(getattr(s, f"{name}_start")), _host(getattr(s, f"{name}_end"))
        real = en > st
        for r, j in np.argwhere(real & (st >= start_sample) & (st < stop_sample)):
            out.append(dict(event="fault", channel=channel, rack=int(r),
                            sample=int(st[r, j]), until=int(en[r, j])))
        for r, j in np.argwhere(real & (en >= start_sample) & (en < stop_sample)):
            out.append(dict(event="repair", channel=channel, rack=int(r),
                            sample=int(en[r, j])))
    out.sort(key=lambda d: (d["sample"], d["rack"], d["event"]))
    return out
