"""Host-side phase profiling for the conditioning engines.

Port of ``repro.core.profiling``: a process-global span accumulator that
the host engine's loop annotates (``render`` and ``solve`` per chunk,
``host-sync`` around the result).  Spans are no-ops unless ``enable()``
was called, so the instrumented sites cost nothing in normal runs; when
enabled, each span also opens ``torch.profiler.record_function
("repro.<name>")``, so a ``torch.profiler`` capture carries the same phase
names on its host timeline.

Measurement model: CUDA launches return before the device finishes, so a
wall-clock span around them measures the enqueue.  ``span(name)`` hands
its body a ``sync`` that blocks on a value (``torch.cuda.synchronize`` of
the value's device; nothing for CPU tensors) before the clock closes:
profiling serializes the phases it measures, so their sum lies close to
(a little above) the unprofiled wall.  The scanned engine replays one CUDA
graph of the whole window: one span, ``replay`` (a cold call's capture
included).  The sharded engines time their collectives as ``gather``.
"""
from __future__ import annotations

import contextlib
import time

import torch

_ENABLED = False
_PHASES: dict[str, float] = {}


def enable() -> None:
    """Turn spans on and clear any accumulated phase times."""
    global _ENABLED
    _ENABLED = True
    _PHASES.clear()


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def phases() -> dict[str, float]:
    """Accumulated seconds per phase since ``enable()``."""
    return dict(_PHASES)


def _device_of(x) -> torch.device | None:
    """The device of the first tensor in ``x`` (a tensor, or tuples and
    lists of them, depth first), or None."""
    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, (tuple, list)):
        for v in x:
            dev = _device_of(v)
            if dev is not None:
                return dev
    return None


@contextlib.contextmanager
def span(name: str):
    """Accumulate wall time under ``name`` (no-op unless enabled).

    The body may hand back a value to block on before the clock closes::

        with profiling.span("solve") as sync:
            out = step(...)
            sync(out)
    """
    if not _ENABLED:
        yield lambda x: x
        return

    def sync(x):
        dev = _device_of(x)
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return x

    t0 = time.perf_counter()
    with torch.profiler.record_function(f"repro.{name}"):
        try:
            yield sync
        finally:
            _PHASES[name] = _PHASES.get(name, 0.0) + (time.perf_counter() - t0)
