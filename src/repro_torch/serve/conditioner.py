"""Resume-safe operator service for the power conditioner.

Port of ``repro.serve.conditioner``.  ``ConditionerService`` wraps the
scanned engine (through the ``fleet.condition`` facade) in the loop a
campus operator runs: advance the stream window by window, checkpoint the
carried ``PDUState`` at controller-interval boundaries, restore after a
crash and continue with bit for bit the same telemetry, and keep an
append-only JSONL audit log of what happened — scheduled faults and
repairs of the scenario's fault schedule, degraded-mode entry and exit,
the operator's manual ESS trips, compliance verdicts, safe-mode
transitions, and checkpoint / restore events.

The service also runs whole grid regions (``core.grid.GridRegion``): the
carried state is then the tuple of per-campus states, rack indices of
``inject_fault`` / ``clear_fault`` are global across the region (mapped to
(campus, local rack)), ``status()`` grows POI and per-campus aggregates,
and wide-area mode-band violations land in the log as
``mode_band_violation`` events.

Resume safety rests on two properties of the scanned engine:

  * A window's aggregates are pure in the absolute sample index (the
    render, the fault schedule and the availability are), so a restored
    service re-enters the stream where it left off.
  * Windows of one length replay one CUDA graph (the start sample is read
    on the card), and the engine copies the carried state into the graph's
    static buffers, so a resumed run is the same program on the same
    floats.  An operator's override of ``ess_online`` is such a copy too:
    it costs no recapture.

The checkpoint is the port's own: an ``.npz`` of the state's tensor leaves
with the service's fingerprint, a sha256 over the structure and the leaf
bytes of the config, the scenario or region and the grid spec.  A
checkpoint of the JAX package (another magic) is never loaded.

A region service takes a ``mesh`` (``sharding.region_mesh``): every rank
of its world builds the same service and makes the same calls, each window
runs the sharded region engine (``grid.condition_region_sharded``), and
only rank 0 writes the audit log's file and the checkpoints (every rank
keeps the events in memory; a checkpoint waits for all ranks, so any rank
may restore from it).  A window and its resume are the one-rank service's
bit for bit.

The audit log is strict JSON (``allow_nan=False``): health summaries go
through ``health.fleet_summary(..., json_safe=True)``, so an empty wear
history's infinite projected lifetime becomes ``null``.
"""
from __future__ import annotations

import glob as _glob
import hashlib
import json
import os
import zipfile
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import compliance, fleet, health as hlt, pdu, safemode as smode
from repro_torch.sharding import rules

_CKPT_MAGIC = "easyrider-torch-conditioner-ckpt-v1"
_LOAD_ERRORS = (OSError, ValueError, KeyError, zipfile.BadZipFile, EOFError)


def _fingerprint(cfg, scenario, grid_spec) -> str:
    """sha256 over the service's configuration: for the config, the
    scenario (or region) and the grid spec, ``fleet._tree_spec`` of their
    host copies (structure, every non-tensor field, each tensor's shape and
    dtype) and every tensor leaf's bytes.  Stored in checkpoints and checked
    on restore, so a checkpoint never loads into a service over other
    physics, fleet geometry or compliance limits.  It leaves out the device,
    ``chunk_intervals`` and the carried state."""
    h = hashlib.sha256()
    for obj in (cfg, scenario, grid_spec):
        host = fleet._tree_map(lambda t: t.detach().cpu(), obj)
        h.update(repr(fleet._tree_spec(host)).encode())
        for leaf in fleet._tree_leaves(host):
            h.update(leaf.contiguous().numpy().tobytes())
    return h.hexdigest()


def _campus_states(state) -> tuple:
    """A region's per-campus states, or a campus's one state, as a tuple
    (``PDUState`` is a NamedTuple: only a plain tuple is a region's)."""
    return (state,) if isinstance(state, pdu.PDUState) else tuple(state)


class AuditLog:
    """Append-only JSONL event log (in-memory list + optional file).

    Every record is one line of strict JSON (``allow_nan=False``), written
    whole, so the file is valid and tail-able at any crash point.  Each
    record carries a ``seq`` number, monotone within its file (a restarted
    service continues from the line count of the existing file).
    ``fsync=True`` makes every append durable (flush + ``os.fsync``).
    ``max_bytes`` turns on size-based rotation: when the file would exceed
    it, it is shifted to ``<path>.1`` (older generations to ``.2``, ... up
    to ``backups``; the oldest is dropped) and the main file starts fresh.
    """

    def __init__(
        self,
        path: str | os.PathLike | None = None,
        *,
        fsync: bool = False,
        max_bytes: int | None = None,
        backups: int = 3,
    ):
        self.path = os.fspath(path) if path is not None else None
        self.fsync = bool(fsync)
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self.backups = int(backups)
        self._events: list[dict] = []
        self._seq = 0
        if self.path is not None and os.path.exists(self.path):
            with open(self.path) as f:
                self._seq = sum(1 for _ in f)

    def append(self, event: str, **fields) -> dict:
        if self.path is not None and self.max_bytes is not None and os.path.exists(self.path):
            probe = json.dumps(dict(event=event, seq=self._seq, **fields), sort_keys=True,
                               allow_nan=False)
            if os.path.getsize(self.path) + len(probe) + 1 > self.max_bytes:
                self._rotate()  # restarts seq: assign it only after this
        rec = dict(event=event, seq=self._seq, **fields)
        line = json.dumps(rec, sort_keys=True, allow_nan=False)
        self._events.append(rec)
        self._seq += 1
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(line + "\n")
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
        return rec

    def _rotate(self) -> None:
        if self.backups <= 0:
            os.remove(self.path)
        else:
            for i in range(self.backups - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            os.replace(self.path, f"{self.path}.1")
        self._seq = 0  # monotone per file

    def tail(self, n: int = 10) -> list[dict]:
        return self._events[-n:]

    def __len__(self) -> int:
        return len(self._events)


class ConditionerService:
    """Operator loop over the scanned conditioning engine.

    ``scenario`` is one ``power.scenario.Scenario`` (a campus) or a
    ``core.grid.GridRegion`` (N campuses at a POI); both run through
    ``fleet.condition`` on the config's device.  The service owns the
    carried state (one ``PDUState``, or a tuple of per-campus states) and
    the absolute stream position in samples; both ride in checkpoints.
    ``mesh`` (regions only) runs the campuses in parallel (module
    docstring).
    """

    def __init__(
        self,
        cfg: pdu.PDUConfig,
        scenario,
        grid_spec: compliance.GridSpec,
        *,
        chunk_intervals: int = 16,
        qp_iters: int = 30,
        soc0: float = 0.5,
        mesh=None,
        audit_path: str | os.PathLike | None = None,
        audit_fsync: bool = False,
        audit_max_bytes: int | None = None,
        checkpoint_dir: str | os.PathLike | None = None,
        checkpoint_every: int | None = None,
        keep_checkpoints: int = 3,
    ):
        from repro_torch.power import scenario as SC

        if mesh is not None:
            rules.check_mesh(mesh, device_type=cfg.device.type)
            if not hasattr(scenario, "campuses"):
                raise ValueError("mesh is only meaningful for GridRegion targets")
        self.mesh = mesh
        self._writer = mesh is None or dist.get_rank() == 0
        self.cfg = cfg
        self.scenario = scenario
        self.grid_spec = grid_spec
        self.chunk_intervals = int(chunk_intervals)
        self.qp_iters = int(qp_iters)
        self._k = fleet._window_geometry(cfg, scenario.total_samples, chunk_intervals, 0, None)[0]
        self.sample_pos = 0
        self.audit = AuditLog(audit_path if self._writer else None, fsync=audit_fsync,
                              max_bytes=audit_max_bytes)
        self.checkpoint_dir = os.fspath(checkpoint_dir) if checkpoint_dir is not None else None
        self.checkpoint_every = None if checkpoint_every is None else int(checkpoint_every)
        if self.checkpoint_every is not None and self.checkpoint_dir is None:
            raise ValueError("checkpoint_every requires checkpoint_dir")
        self.keep_checkpoints = int(keep_checkpoints)
        self._windows_since_ckpt = 0
        self._degraded_now = False
        self._last_result: fleet.ConditioningResult | None = None
        self._is_region = hasattr(scenario, "campuses")
        self.fingerprint = _fingerprint(cfg, scenario, grid_spec)
        self._sm_prev = (0, 0, 0)  # (passthrough_entries, quarantine_entries, readmissions)

        campuses = scenario.campuses if self._is_region else (scenario,)
        states = []
        for c in campuses:
            fleet._check_scenario_rate(c, cfg)
            fleet._check_scenario_faults(c, cfg)
            r0 = SC.render(c, 0, 1)[0]
            if r0.ndim == 0:
                r0 = r0[None]
            states.append(pdu.init_state(cfg, r0, soc0=soc0))
        self.state = tuple(states) if self._is_region else states[0]
        self._campus_racks = [int(st.ess_online.shape[0]) for st in states]
        self._campus_offsets = np.concatenate([[0], np.cumsum(self._campus_racks)]).astype(np.int64)
        self.n_racks = int(self._campus_offsets[-1])
        has_faults = any(c.faults is not None for c in campuses)
        # Which availability path the engine takes: "compiled" renders the
        # schedule's episode tables inside the engine; "streamed" (safe mode)
        # materialises the per-sample weight of each chunk.
        fault_path = None
        if cfg.degraded_mode and has_faults:
            fault_path = "streamed" if cfg.safemode else "compiled"
        self.audit.append(
            "service_start",
            sample=0,
            n_racks=self.n_racks,
            n_campuses=scenario.n_campuses if self._is_region else 1,
            total_samples=int(scenario.total_samples),
            sample_hz=float(scenario.sample_hz),
            degraded_mode=bool(cfg.degraded_mode),
            has_fault_schedule=has_faults,
            fault_path=fault_path,
        )

    # ------------------------------------------------------------- position

    @property
    def position_s(self) -> float:
        return self.sample_pos / float(self.scenario.sample_hz)

    @property
    def exhausted(self) -> bool:
        return self.sample_pos >= int(self.scenario.total_samples)

    # -------------------------------------------------------------- advance

    def advance(self, n_intervals: int | None = None) -> fleet.ConditioningResult:
        """Condition the next ``n_intervals`` controller intervals (default:
        one chunk, ``chunk_intervals``); windows of one length replay one
        graph.  Returns the window's ``ConditioningResult`` and logs its
        scheduled fault and repair edges, degraded entry and exit, the
        verdict and (regions) mode-band violations."""
        if self.exhausted:
            raise RuntimeError(f"stream exhausted at sample {self.sample_pos}; nothing to advance")
        n = self.chunk_intervals if n_intervals is None else int(n_intervals)
        if n <= 0:
            raise ValueError(f"n_intervals must be positive, got {n}")
        start = self.sample_pos
        stop = min(start + n * self._k, int(self.scenario.total_samples))
        res = fleet.condition(
            self.scenario, self.cfg, self.grid_spec, device=self.cfg.device, mesh=self.mesh,
            stream=fleet.StreamOptions(chunk_intervals=self.chunk_intervals, state=self.state,
                                       start_sample=start, stop_sample=stop),
            qp_iters=self.qp_iters,
        )
        self.state = res.state
        self.sample_pos = stop
        self._last_result = res
        self._log_window(start, stop, res)
        if self.cfg.safemode:
            self._log_safemode(start)
        if self.checkpoint_every is not None:
            self._windows_since_ckpt += 1
            if self._windows_since_ckpt >= self.checkpoint_every:
                self._auto_checkpoint()
        return res

    # ------------------------------------------------------------- safe mode

    def _sm_totals(self) -> tuple[int, int, int]:
        """(passthrough_entries, quarantine_entries, readmissions) summed
        over racks and campuses."""
        tot = [0, 0, 0]
        for st in _campus_states(self.state):
            sm = st.safemode
            tot[0] += int(sm.passthrough_entries.sum())
            tot[1] += int(sm.quarantine_entries.sum())
            tot[2] += int(sm.readmissions.sum())
        return tuple(tot)

    def _sm_racks(self, mode: int) -> list[int]:
        """Global rack indices now in the given safe-mode state."""
        out, off = [], 0
        for st in _campus_states(self.state):
            m = st.safemode.mode.detach().cpu().reshape(-1)
            out.extend(int(i) + off for i in torch.nonzero(m == mode).reshape(-1))
            off += m.shape[0]
        return out

    def _log_safemode(self, start: int) -> None:
        """Counter deltas of the supervisor: a window that tripped new racks
        logs ``safemode_enter`` (with the racks now contained), one with
        re-admissions ``safemode_exit``."""
        pt, qr, ra = self._sm_totals()
        d_pt, d_qr, d_ra = pt - self._sm_prev[0], qr - self._sm_prev[1], ra - self._sm_prev[2]
        self._sm_prev = (pt, qr, ra)
        if d_pt or d_qr:
            self.audit.append(
                "safemode_enter", sample=start, new_passthrough=d_pt, new_quarantine=d_qr,
                passthrough_racks=self._sm_racks(smode.PASSTHROUGH),
                quarantined_racks=self._sm_racks(smode.QUARANTINE),
            )
        if d_ra:
            self.audit.append(
                "safemode_exit", sample=start, readmissions=d_ra,
                still_contained=self._sm_racks(smode.PASSTHROUGH)
                + self._sm_racks(smode.QUARANTINE),
            )

    def _auto_checkpoint(self) -> None:
        if self._writer:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.checkpoint(os.path.join(self.checkpoint_dir, f"ckpt_{self.sample_pos:012d}.npz"))
        self._windows_since_ckpt = 0
        if self._writer:
            kept = sorted(_glob.glob(os.path.join(self.checkpoint_dir, "ckpt_*.npz")))
            for old in kept[: max(0, len(kept) - self.keep_checkpoints)]:
                os.remove(old)

    def _log_window(self, start: int, stop: int, res: fleet.ConditioningResult) -> None:
        from repro_torch.power import faults as FLT

        campuses = self.scenario.campuses if self._is_region else (self.scenario,)
        for c, scen in enumerate(campuses):
            if scen.faults is None:
                continue
            for ev in FLT.episodes_in_window(scen.faults, start, stop):
                if self._is_region:
                    ev["rack"] += int(self._campus_offsets[c])
                    ev["campus"] = self.scenario.names[c]
                self.audit.append(**ev)
        frac = res.ess_online_frac.detach().cpu().numpy()
        degraded = bool(frac.size) and float(frac.min()) < 1.0
        if degraded and not self._degraded_now:
            self.audit.append("degraded_enter", sample=start, min_online_frac=float(frac.min()))
        elif self._degraded_now and not degraded:
            self.audit.append("degraded_exit", sample=start)
        self._degraded_now = degraded
        rep = res.report_grid
        ramp_ok, spec_ok = bool(rep.ramp_ok), bool(rep.spectrum_ok)
        modes_ok = bool(rep.modes_ok) if rep.modes_ok is not None else True
        window = dict(
            sample=start,
            stop=stop,
            ramp_ok=ramp_ok,
            spectrum_ok=spec_ok,
            min_online_frac=float(frac.min()) if frac.size else 1.0,
            max_qp_residual=float(res.max_qp_residual),
        )
        if rep.modes_ok is not None:
            window["modes_ok"] = modes_ok
        self.audit.append("window", **window)
        if rep.mode_ok is not None and self._is_region:
            mode_ok = rep.mode_ok.detach().cpu().numpy()
            mags = rep.mode_mags.detach().cpu().numpy()
            for i, band in enumerate(self.scenario.bands):
                if not bool(mode_ok[i]):
                    self.audit.append(
                        "mode_band_violation", sample=start, stop=stop, band=band.name,
                        lo_hz=float(band.lo_hz), hi_hz=float(band.hi_hz),
                        magnitude=float(mags[i]), threshold=float(band.threshold),
                    )
        if not (ramp_ok and spec_ok and modes_ok):
            self.audit.append("compliance_violation", sample=start, stop=stop, ramp_ok=ramp_ok,
                              spectrum_ok=spec_ok, modes_ok=modes_ok)

    # ----------------------------------------------------- manual overrides

    def inject_fault(self, racks: Sequence[int] | int, *, reason: str = "manual"):
        """Trip the given racks' ESS units offline until ``clear_fault``: the
        operator's kill switch.  It writes the persistent
        ``PDUState.ess_online`` override, which every engine multiplies into
        the effective availability, on top of the scenario's schedule."""
        racks = self._check_racks(racks)
        self._set_ess_online(racks, 0.0)
        self.audit.append("manual_fault_injected", sample=self.sample_pos, racks=racks,
                          reason=reason)

    def clear_fault(self, racks: Sequence[int] | int):
        """Return manually tripped racks to service."""
        racks = self._check_racks(racks)
        self._set_ess_online(racks, 1.0)
        self.audit.append("manual_fault_cleared", sample=self.sample_pos, racks=racks)

    def _set_ess_online(self, racks: list[int], value: float) -> None:
        """Write ``value`` into ``ess_online`` of each global rack's campus
        (a copy of the tensor: a state handed out earlier stays as it was)."""
        states = list(_campus_states(self.state))
        for c in range(len(states)):
            lo, hi = int(self._campus_offsets[c]), int(self._campus_offsets[c + 1])
            local = [r - lo for r in racks if lo <= r < hi]
            if local:
                on = states[c].ess_online.clone()
                on[local] = value
                states[c] = states[c]._replace(ess_online=on)
        self.state = tuple(states) if self._is_region else states[0]

    def _check_racks(self, racks) -> list[int]:
        racks = [int(r) for r in np.atleast_1d(np.asarray(racks, dtype=np.int64))]
        bad = [r for r in racks if not 0 <= r < self.n_racks]
        if bad:
            raise ValueError(f"rack indices {bad} outside fleet of {self.n_racks}")
        return racks

    # ------------------------------------------------------ checkpoint/restore

    def checkpoint(self, path: str | os.PathLike) -> str:
        """Write the carried state and the stream position to ``path``
        (``.npz``), atomically: a same-directory temp file, flushed and
        fsync'd, then ``os.replace``'d over the target and the directory
        fsync'd, so a crash leaves the previous checkpoint or the whole new
        one, never a torn file at the target.  Every ``advance`` stops at an
        interval boundary, so the state is always the interval carry.  With
        a mesh, rank 0 writes and every rank returns once the file is
        there."""
        path = os.fspath(path)
        if not path.endswith(".npz"):
            path += ".npz"
        if self._writer:
            self._write_checkpoint(path)
        if self.mesh is not None:
            dist.barrier()
        self.audit.append("checkpoint_saved", sample=self.sample_pos, path=path)
        return path

    def _write_checkpoint(self, path: str) -> None:
        leaves = fleet._tree_leaves(self.state)
        payload = dict(
            magic=np.asarray(_CKPT_MAGIC),
            fingerprint=np.asarray(self.fingerprint),
            sample_pos=np.int64(self.sample_pos),
            n_leaves=np.int64(len(leaves)),
            **{f"leaf_{i}": l.detach().cpu().numpy() for i, l in enumerate(leaves)},
        )
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def restore(self, path: str | os.PathLike) -> None:
        """Load a checkpoint written by ``checkpoint`` into this service,
        which must be built over the same config and scenario: the magic,
        the fingerprint and every leaf's count, shape and dtype are checked,
        so a checkpoint of another fleet, physics config or float width is
        refused as a mismatch.  Continuing with ``advance`` reproduces the
        uninterrupted run bit for bit."""
        path = os.fspath(path)
        with np.load(path) as z:
            magic = str(z["magic"]) if "magic" in z.files else None
            if magic != _CKPT_MAGIC:
                raise ValueError(f"{path} is not a checkpoint of this service (magic {magic!r})")
            fp = str(z["fingerprint"])
            if fp != self.fingerprint:
                raise ValueError(
                    f"checkpoint fingerprint {fp[:12]}... does not match this service's "
                    f"{self.fingerprint[:12]}... — it was written under a different "
                    "config/scenario/grid spec")
            template = fleet._tree_leaves(self.state)
            n = int(z["n_leaves"])
            if n != len(template):
                raise ValueError(f"checkpoint has {n} leaves; this service's state has "
                                 f"{len(template)} — config/scenario mismatch")
            leaves = []
            for i, t in enumerate(template):
                arr = z[f"leaf_{i}"]
                want_dtype = torch.empty((), dtype=t.dtype).numpy().dtype
                if arr.shape != tuple(t.shape):
                    raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != expected "
                                     f"{tuple(t.shape)} — config/scenario mismatch")
                if arr.dtype != want_dtype:
                    raise ValueError(f"checkpoint leaf {i} dtype {arr.dtype} != expected "
                                     f"{want_dtype} — config/scenario mismatch")
                leaves.append(torch.from_numpy(arr.copy()).to(t.device))
            pos = int(z["sample_pos"])
        it = iter(leaves)
        self.state = fleet._tree_map(lambda _: next(it), self.state)
        self.sample_pos = pos
        self._last_result = None
        self._sm_prev = self._sm_totals() if self.cfg.safemode else (0, 0, 0)
        self.audit.append("restored", sample=self.sample_pos, path=path)

    def recover(self, ckpt_dir: str | os.PathLike) -> str | None:
        """Restore from the newest valid checkpoint under ``ckpt_dir``.

        Candidates (``*.npz``, not recursive) are tried newest first by
        their stored ``sample_pos``; a torn or unreadable file, a zero-byte
        one, a foreign ``.npz`` or a checkpoint of another service (the JAX
        package's included) is skipped with a ``recover_skipped`` event.
        Returns the path restored from, or ``None`` (with a
        ``recover_failed`` event, the service as it was) when none is
        valid."""
        ckpt_dir = os.fspath(ckpt_dir)
        candidates = []
        for p in _glob.glob(os.path.join(ckpt_dir, "*.npz")):
            try:
                with np.load(p) as z:
                    magic = str(z["magic"]) if "magic" in z.files else None
                    if magic != _CKPT_MAGIC:
                        raise ValueError(f"not a checkpoint of this service (magic {magic!r})")
                    pos = int(z["sample_pos"])
            except _LOAD_ERRORS as e:
                self.audit.append("recover_skipped", path=p, error=f"{type(e).__name__}: {e}")
                continue
            candidates.append((pos, p))
        for _, p in sorted(candidates, reverse=True):
            try:
                self.restore(p)
            except _LOAD_ERRORS as e:
                self.audit.append("recover_skipped", path=p, error=f"{type(e).__name__}: {e}")
                continue
            self.audit.append("recovered", sample=self.sample_pos, path=p)
            return p
        self.audit.append("recover_failed", dir=ckpt_dir)
        return None

    # --------------------------------------------------------------- status

    def status(self) -> dict:
        """JSON-safe snapshot for dashboards and health endpoints.  A grid
        region's also carries the last window's POI view (peak power,
        frequency and voltage excursions, each band's magnitude and
        verdict) and per-campus aggregates."""
        online = torch.cat([st.ess_online.detach().cpu().reshape(-1)
                            for st in _campus_states(self.state)])
        out = dict(
            sample_pos=self.sample_pos,
            position_s=self.position_s,
            total_samples=int(self.scenario.total_samples),
            exhausted=self.exhausted,
            n_racks=self.n_racks,
            degraded_active=self._degraded_now,
            manual_offline_racks=[int(i) for i in torch.nonzero(online <= 0.0).reshape(-1)],
            audit_events=len(self.audit),
        )
        if self._is_region:
            out["region"] = dict(n_campuses=int(self.scenario.n_campuses),
                                 campus_names=list(self.scenario.names),
                                 campus_racks=list(self._campus_racks))
        res = self._last_result
        if res is not None:
            h = lambda x: x.detach().cpu().numpy()
            frac = h(res.ess_online_frac)
            rep = res.report_grid
            last = dict(
                ramp_ok=bool(rep.ramp_ok),
                spectrum_ok=bool(rep.spectrum_ok),
                min_online_frac=float(frac.min()) if frac.size else 1.0,
                mean_online_frac=float(frac.mean()) if frac.size else 1.0,
                max_qp_residual=float(res.max_qp_residual),
            )
            out["last_window"] = last
            if self._is_region:
                last["modes_ok"] = bool(rep.modes_ok) if rep.modes_ok is not None else True
                mags, mode_ok = h(rep.mode_mags), h(rep.mode_ok)
                out["poi"] = dict(
                    peak_power_pu=float(torch.amax(res.poi_grid)),
                    max_freq_dev_hz=float(torch.amax(torch.abs(res.poi_freq_dev))),
                    max_volt_dev=float(torch.amax(torch.abs(res.poi_volt_dev))),
                    mode_bands=[dict(band=b.name, magnitude=float(mags[i]),
                                     threshold=float(b.threshold), ok=bool(mode_ok[i]))
                                for i, b in enumerate(self.scenario.bands)],
                )
                camp_grid, weights = h(res.campus_grid), h(res.weights)
                out["campuses"] = [
                    dict(
                        name=self.scenario.names[c],
                        n_racks=int(self._campus_racks[c]),
                        weight=float(weights[c]),
                        peak_power_pu=float(camp_grid[c].max()),
                        min_online_frac=float(frac[c].min()) if frac.size else 1.0,
                        ramp_ok=bool(res.per_campus[c].report_grid.ramp_ok),
                    )
                    for c in range(int(self.scenario.n_campuses))
                ]
            else:
                out["health"] = hlt.fleet_summary(res.health, json_safe=True)
        if self.cfg.safemode:
            per = [smode.summary(st.safemode) for st in _campus_states(self.state)]
            out["safemode"] = dict(
                n_normal=sum(p["n_normal"] for p in per),
                n_passthrough=sum(p["n_passthrough"] for p in per),
                n_quarantined=sum(p["n_quarantined"] for p in per),
                passthrough_racks=self._sm_racks(smode.PASSTHROUGH),
                quarantined_racks=self._sm_racks(smode.QUARANTINE),
                passthrough_entries=sum(p["passthrough_entries"] for p in per),
                quarantine_entries=sum(p["quarantine_entries"] for p in per),
                readmissions=sum(p["readmissions"] for p in per),
                worst_resid_streak=max(p["worst_resid_streak"] for p in per),
            )
        json.dumps(out, allow_nan=False)  # the strict-JSON guarantee
        return out
