"""Time the checkout's ``pdu_health`` and ``pdu_sim`` kernels on the card.

Run from the root of a checkout (``PYTHONPATH=src python3
tools/hw_pipeline_time.py LABEL [--chunks 16,32,64,96]``).  Inputs are made from a seed with
numpy, the same in every checkout: ``pdu_health`` on one controller
interval (T = 1000, R = 1024, the campus filter at 200 Hz, slew and wear
fold) clean, with an (R,) row, a (T, R) series and episode tables at edges
1 and 50, and on the quickstart's interval (T = 2500, R = 1); ``pdu_sim``
unweighted over 17600 x 1024 and 60000 x 128.  Each time is the median of
25 launches timed with CUDA events (the card kept busy while the host
enqueues, as ``chip_smoke.py``'s ``_median_ms`` does).  Prints ``LABEL
{"case": [ms, sha256 of the outputs' bytes], ...}``: two checkouts whose
kernels compute the same bits print the same digests.
``tools/hw_pipeline_compare.sh`` runs it in two checkouts, interleaved.
``--chunks`` times every case again with each chunk given passed to
``hw_plan.plan`` in place of ``hw_plan.CHUNK`` (cases ``name@chunk``; every
chunk must give the same digests), the sweep from which ``CHUNK`` was
chosen.
"""
import argparse
import contextlib
import functools
import hashlib
import json
import statistics
import sys

import numpy as np
import torch

from repro_torch.core import health as hlt, pdu
from repro_torch.kernels import hw_plan, ops, pdu_health


def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def interval(t, r, rng, dev):
    """Rack power stepping between load levels, the campus filter and state,
    slew rows, wear state, and the four weight operands."""
    steps = rng.choice([0.15, 0.6, 0.95], size=(t // 20 + 2, r))
    rack = np.clip(np.repeat(steps, 20, axis=0)[:t] + 0.01 * rng.standard_normal((t, r)), 0, 1)
    rack = torch.tensor(rack, dtype=torch.float32, device=dev)
    cfg = pdu.make_pdu(sample_dt=5e-3, track_health=True, device=dev)
    st = pdu.init_state(cfg, rack[0])
    lc = tuple(m.cpu().numpy() for m in (st.filter_obj.ad, st.filter_obj.bd, st.filter_obj.c[0]))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    slew = (f32(rng.uniform(-5e-3, 5e-3, r)), f32(rng.uniform(-5e-3, 5e-3, r)))
    kw = dict(slew=slew, health=(hlt.step_consts(cfg.health), tuple(st.health)),
              **pdu.hw_kwargs(cfg))
    args = (rack, st.ess_state.g_filter, st.ess_state.soc, st.filter_state, *lc)
    row = f32(rng.uniform(0, 1, r) > 0.1)
    series = f32(np.clip(np.linspace(1.2, -0.3, t)[:, None] + rng.uniform(-0.2, 0.2, (1, r)), 0, 1))
    i0, e = 5000, 6
    cuts = np.sort(rng.integers(i0 - 3000, i0 + t + 3000, size=(2 * e, r)), axis=0)
    cuts += np.arange(2 * e)[:, None]  # strictly increasing down each column
    st_ev = torch.tensor(cuts[0::2], dtype=torch.int32, device=dev)
    en_ev = torch.tensor(cuts[1::2] + 1, dtype=torch.int32, device=dev)
    events = (st_ev, en_ev, row, i0, i0 + t - 1)
    modes = {"clean": {}, "row": dict(ess_on=row), "series": dict(ess_on=series),
             "events_edge1": dict(ess_events=events, ess_edge=1),
             "events_edge50": dict(ess_events=events, ess_edge=50)}
    return args, kw, modes


@contextlib.contextmanager
def planned(chunk: int):
    """Plan every launch inside the block with ``chunk`` samples a slot."""
    orig = hw_plan.plan
    hw_plan.plan = functools.partial(orig, chunk=chunk)
    try:
        yield
    finally:
        hw_plan.plan = orig


def cases(dev, suffix: str = "") -> dict:
    """Every case's time and digest (keys end with ``suffix``)."""
    rng = np.random.default_rng(4)
    out = {}
    args, kw, modes = interval(1000, 1024, rng, dev)
    for name, mkw in modes.items():
        p = pdu_health.prepare(*args, **kw, **mkw)
        pdu_health.launch(p)
        out[f"pdu_health_{name}{suffix}"] = [median_ms(lambda: pdu_health.launch(p)),
                                              digest(p.grid, p.soc_t, p.sf, p.hf)]
    args, kw, _ = interval(2500, 1, rng, dev)
    p = pdu_health.prepare(*args, **kw)
    pdu_health.launch(p)
    out[f"pdu_health_quickstart_2500x1{suffix}"] = [median_ms(lambda: pdu_health.launch(p)),
                                                    digest(p.grid, p.soc_t, p.sf, p.hf)]
    for t, r in ((17600, 1024), (60000, 128)):
        args, kw, _ = interval(t, r, rng, dev)
        hw = {k: v for k, v in kw.items() if k not in ("slew", "health")}
        corr = torch.zeros_like(args[0])
        call = lambda: ops.pdu_sim(*args, corr, **hw)
        res = call()
        out[f"pdu_sim_{t}x{r}{suffix}"] = [median_ms(call, reps=10),
                                           digest(res[0], res[1], *res[2])]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", default="this")
    ap.add_argument("--chunks", default="", help="comma-separated chunks to time beside the plan's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hw_pipeline_time: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = cases(dev)
    for ch in [int(c) for c in args.chunks.split(",") if c]:
        with planned(ch):
            swept = cases(dev, f"@{ch}")
        for name, (ms, dig) in swept.items():
            if dig != out[name.split("@")[0]][1]:
                print(f"hw_pipeline_time: {name} differs from chunk {hw_plan.CHUNK}",
                      file=sys.stderr)
                return 1
        out.update(swept)
    print(args.label, json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
