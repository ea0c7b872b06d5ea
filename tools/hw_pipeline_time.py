"""Time the checkout's ``pdu_health``, ``pdu_sim`` and ``lc_filter`` kernels on the card.

Run from the root of a checkout (``PYTHONPATH=src python3
tools/hw_pipeline_time.py LABEL [--chunks 16,32,64,96] [--routes]``).  Inputs are made from a
seed with numpy, the same in every checkout: ``pdu_health`` on one
controller interval (T = 1000, R = 1024, the campus filter at 200 Hz, slew
and wear fold) clean, with an (R,) row, a (T, R) series and episode tables
at edges 1 and 50, and on the quickstart's interval (T = 2500, R = 1);
``pdu_sim`` unweighted over 17600 x 1024 and 60000 x 128; ``lc_filter``
over 17600 x 1024, 60000 x 128 and 2500 x 1.  Each time is the median of
25 launches (10 for ``pdu_sim``) timed with CUDA events (the card kept
busy while the host enqueues, as ``chip_smoke.py``'s ``_median_ms``
does).  Prints ``LABEL {"case": [ms, sha256 of the outputs' bytes],
...}``: two checkouts whose kernels compute the same bits print the same
digests.  ``tools/hw_pipeline_compare.sh`` runs it in two checkouts,
interleaved.  ``--chunks`` times every case again with each chunk given
passed to ``hw_plan.plan`` and ``hw_plan.lc_plan`` in place of their
default (cases ``name@chunk``; every chunk must give the same digests; a
case whose plan does not fit the shared memory at that chunk is left
out), the sweep from which ``CHUNK`` and ``LC_CHUNK`` were chosen.
``--routes`` also times ``lc_filter`` at its two bench shapes and at
2500 x 4 on each of its four (load, store) routes (TMA boxes or 4-byte ``cp.async`` copies;
box stores or spread 4-byte stores), in turns 1 2 3 4 4 3 2 1 (cases
``lc_filter_TxR[loads+stores]``, two times each; every route must give the
same digests): which half of the ``cp.async`` route costs it.
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
from repro_torch.kernels import hw_plan, lc_filter, ops, pdu_health


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
    orig, orig_lc = hw_plan.plan, hw_plan.lc_plan
    hw_plan.plan = functools.partial(orig, chunk=chunk)
    hw_plan.lc_plan = functools.partial(orig_lc, chunk=chunk)
    try:
        yield
    finally:
        hw_plan.plan, hw_plan.lc_plan = orig, orig_lc


def timed(out: dict, name: str, call, outputs, reps: int = 25) -> None:
    """``out[name] = [median ms of call(), digest of outputs(call())]``;
    left out where the plan does not fit at a swept chunk."""
    try:
        res = call()
    except ValueError as e:
        print(f"hw_pipeline_time: {name}: {e}", file=sys.stderr)
        return
    out[name] = [median_ms(call, reps=reps), digest(*outputs(res))]


def timed_health(out: dict, name: str, args, kw) -> None:
    """A ``pdu_health`` case: prepared once, its launch timed."""
    try:
        p = pdu_health.prepare(*args, **kw)
    except ValueError as e:
        print(f"hw_pipeline_time: {name}: {e}", file=sys.stderr)
        return
    pdu_health.launch(p)
    out[name] = [median_ms(lambda: pdu_health.launch(p)), digest(p.grid, p.soc_t, p.sf, p.hf)]


LC_SHAPES = ((17600, 1024), (60000, 128), (2500, 1))


def lc_problem(t, r, rng, dev):
    """lc_filter's operands: the campus filter, its state and a rack trace
    as the node power."""
    args, _, _ = interval(t, r, rng, dev)
    return args[4:], args[3], args[0]


def cases(dev, suffix: str = "") -> dict:
    """Every case's time and digest (keys end with ``suffix``)."""
    rng = np.random.default_rng(4)
    out = {}
    args, kw, modes = interval(1000, 1024, rng, dev)
    for name, mkw in modes.items():
        timed_health(out, f"pdu_health_{name}{suffix}", args, {**kw, **mkw})
    args, kw, _ = interval(2500, 1, rng, dev)
    timed_health(out, f"pdu_health_quickstart_2500x1{suffix}", args, kw)
    for t, r in ((17600, 1024), (60000, 128)):
        args, kw, _ = interval(t, r, rng, dev)
        hw = {k: v for k, v in kw.items() if k not in ("slew", "health")}
        corr = torch.zeros_like(args[0])
        timed(out, f"pdu_sim_{t}x{r}{suffix}", lambda: ops.pdu_sim(*args, corr, **hw),
              lambda res: (res[0], res[1], *res[2]), reps=10)
    rng = np.random.default_rng(5)
    for t, r in LC_SHAPES:
        lc, x0, node = lc_problem(t, r, rng, dev)
        timed(out, f"lc_filter_{t}x{r}{suffix}", lambda: ops.lc_filter(*lc, x0, node),
              lambda res: res)
    return out


LC_ROUTES = (("tma", "tma"), ("cp.async", "spread"), ("tma", "spread"), ("cp.async", "tma"))


def routes(dev) -> dict:
    """lc_filter at its two bench shapes, and at the quickstart's T = 2500
    on the fewest racks the TMA route takes (4), on each (load, store)
    route, in turns 1 2 3 4 4 3 2 1: ``[ms, ms, digest]`` a route."""
    rng = np.random.default_rng(5)
    out = {}
    for t, r in LC_SHAPES[:2] + ((2500, 4),):
        lc, x0, node = lc_problem(t, r, rng, dev)
        for loads, stores in LC_ROUTES + LC_ROUTES[::-1]:
            plan = hw_plan.lc_plan(r, loads=loads, stores=stores)
            call = lambda: lc_filter.lc_filter(*lc, x0, node, plan=plan)
            name = f"lc_filter_{t}x{r}[{loads}+{stores}]"
            ms = median_ms(call)
            if name in out:
                out[name].insert(1, ms)
            else:
                out[name] = [ms, digest(*call())]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", default="this")
    ap.add_argument("--chunks", default="", help="comma-separated chunks to time beside the plan's")
    ap.add_argument("--routes", action="store_true",
                    help="time lc_filter on each of its four (load, store) routes")
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
    if args.routes:
        by_route = routes(dev)
        for name, (*_, dig) in by_route.items():
            shape = name.split("[")[0]
            if dig != by_route[f"{shape}[tma+tma]"][-1] or dig != out.get(shape, (0, dig))[1]:
                print(f"hw_pipeline_time: {name} differs from the TMA route", file=sys.stderr)
                return 1
        out.update(by_route)
    print(args.label, json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
