"""Fault tolerance for 1000+-node operation (a copy of
``repro.train.fault_tolerance``: numpy only, with the port's
``Checkpointer``).

Three mechanisms, each exercised by tests:

  * **StragglerMonitor** — per-host step-time EMA with robust (MAD-based)
    outlier detection; flags persistent stragglers so the launcher can
    drop/replace the host and the data shards get reassigned
    (``reassign_shards``).  Power tie-in: a host whose rack PDU reports a
    saturated battery is treated as degraded before it even slows down.

  * **Elastic remesh** — resume a checkpoint on a different device count:
    checkpoints are stored unsharded (reshard-on-restore comes with the
    port's multi-GPU sharding); the data pipeline is step-keyed so the
    batch stream continues identically.

  * **PowerAwareCheckpointer** — EasyRider SoC telemetry drives emergency
    checkpoints: if the battery leaves its safe band (grid event in
    progress; the rack may be about to brown out), save NOW rather than at
    the next scheduled interval.  This is the integration the paper enables
    but does not build: the PDU's BMS is a failure *predictor* visible to
    software with seconds of warning.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.train.checkpoint import Checkpointer


# ------------------------------------------------------------ stragglers --


@dataclasses.dataclass
class StragglerMonitor:
    n_hosts: int
    ema_alpha: float = 0.2
    threshold: float = 3.0  # MAD multiples above median
    patience: int = 3  # consecutive flags before declaring

    def __post_init__(self):
        self._ema = np.zeros(self.n_hosts)
        self._count = np.zeros(self.n_hosts, np.int64)
        self._flags = np.zeros(self.n_hosts, np.int64)
        self._forced: set[int] = set()

    def observe(self, step_times_s: Sequence[float]) -> list[int]:
        """Feed per-host durations for one step; returns declared stragglers.

        Outlier-ness is judged on the CURRENT step time (robust median/MAD
        across hosts) so a single transient blip cannot poison the verdict
        through the EMA; the EMA is kept for reporting.  Declaration needs
        ``patience`` consecutive outlier steps — or a power-degradation
        mark, which persists until cleared.
        """
        t = np.asarray(step_times_s, np.float64)
        first = self._count == 0
        self._ema = np.where(first, t, (1 - self.ema_alpha) * self._ema + self.ema_alpha * t)
        self._count += 1
        med = np.median(t)
        mad = np.median(np.abs(t - med)) + 1e-9
        outlier = t > med + self.threshold * mad * 1.4826
        self._flags = np.where(outlier, self._flags + 1, 0)
        declared = set(int(i) for i in np.nonzero(self._flags >= self.patience)[0])
        return sorted(declared | self._forced)

    def mark_power_degraded(self, host: int) -> None:
        """A rack PDU reporting SoC saturation = imminent trouble."""
        self._forced.add(host)

    def clear(self, host: int) -> None:
        self._forced.discard(host)
        self._flags[host] = 0


def reassign_shards(n_shards: int, healthy_hosts: Sequence[int]) -> dict[int, list[int]]:
    """Deterministic round-robin remap of data shards to surviving hosts."""
    healthy = sorted(healthy_hosts)
    if not healthy:
        raise ValueError("no healthy hosts")
    out: dict[int, list[int]] = {h: [] for h in healthy}
    for s in range(n_shards):
        out[healthy[s % len(healthy)]].append(s)
    return out


# --------------------------------------------------- power-aware saving ---


class PowerAwareCheckpointer:
    """Checkpointer wrapper that adds SoC-triggered emergency saves."""

    def __init__(
        self,
        ckpt: Checkpointer,
        *,
        every_steps: int = 200,
        soc_window: tuple[float, float] = (0.15, 0.85),
        cooldown_steps: int = 20,
    ):
        self.ckpt = ckpt
        self.every_steps = every_steps
        self.soc_window = soc_window
        self.cooldown_steps = cooldown_steps
        self._last_emergency = -(10**9)
        self.emergency_saves = 0

    def maybe_save(self, step: int, tree, *, soc: float | None = None) -> str | None:
        """Returns "scheduled" | "emergency" | None."""
        if soc is not None and not (self.soc_window[0] <= soc <= self.soc_window[1]):
            if step - self._last_emergency >= self.cooldown_steps:
                self.ckpt.save(step, tree)
                self._last_emergency = step
                self.emergency_saves += 1
                return "emergency"
        if self.every_steps and step > 0 and step % self.every_steps == 0:
            self.ckpt.save(step, tree)
            return "scheduled"
        return None
