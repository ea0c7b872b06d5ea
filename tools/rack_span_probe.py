"""Does a column sum's order follow the tensor's width on the card?

Run from the root of a checkout (``PYTHONPATH=src python3
tools/rack_span_probe.py [--phase23b]``).  The wear fold's block sums
(``ref.block_sums``) reduce an interval's (t, r) SoC path over t.  A rank of
a rack-sharded run holds r of a campus's n racks, so its per-rack sums are
the one-rank run's only if a column's sum does not depend on the width.
For t in 1 .. 4000 and n in 16 .. 4096, split into 2, 4, 8 and 16 blocks,
inputs drawn from a seeded generator on the card, it counts the blocks
whose sums at the block's width differ from the whole width's, and those
whose sums with ``rack_span`` (the campus-width sums the rack-sharded
engines use) differ; prints one line a (t, n) with differing blocks, then
``{"blocks": N, "differ_at_block_width": N, "differ_with_rack_span": N}``.

``--phase23b`` also conditions ``chip_smoke.py``'s phase-4 campus (1024
racks, 88 s at 200 Hz) unsharded on the host and scanned engines, then
rack-sharded over two gloo ranks sharing the card (phase 23b's world),
once as shipped and once with ``ref.block_sums`` ignoring ``rack_span``,
and prints for each rank and engine how many per-rack leaves (the final
state, the wear report) are not bit for bit the unsharded run's.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _block_width_rank(*args):
    """A phase-23b rank whose wear sums run at the block's width."""
    import chip_smoke
    from repro_torch.kernels import ref

    block_sums = ref.block_sums
    ref.block_sums = lambda soc_t, state, rack_span=None: block_sums(soc_t, state)
    chip_smoke._sharded_rank(*args)


def sweep() -> None:
    import torch

    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    blocks = plain = spanned = 0
    for t in (1, 2, 10, 25, 50, 200, 400, 1000, 4000):
        for n in (16, 32, 64, 96, 256, 512, 1024, 2048, 4096):
            x = torch.rand((t, n), generator=gen, device="cuda") * 0.5 + 0.25
            state = [torch.rand((n,), generator=gen, device="cuda") for _ in range(11)]
            whole = ref.block_sums(x, state)[:4]
            row = {}
            for nb in (2, 4, 8, 16):
                r = n // nb
                for lo in range(0, n, r):
                    part = lambda span: ref.block_sums(
                        x[:, lo:lo + r].contiguous(), [s[lo:lo + r] for s in state], span)[:4]
                    same = lambda got: all(torch.equal(g, w[lo:lo + r])
                                           for g, w in zip(got, whole))
                    blocks += 1
                    if not same(part(None)):
                        plain += 1
                        row[r] = row.get(r, 0) + 1
                    spanned += not same(part((lo, n)))
            if row:
                print(f"t={t} n={n}: blocks of width {sorted(row)} differ at the block's width "
                      f"({sum(row.values())} blocks)")
    print(json.dumps({"blocks": blocks, "differ_at_block_width": plain,
                      "differ_with_rack_span": spanned}), flush=True)


def phase23b() -> None:
    import torch

    import chip_smoke
    from repro_torch.core import fleet

    c = chip_smoke.CAMPUS
    want = {}
    for engine in ("host", "scanned"):
        res, _, _ = chip_smoke.run_campus(c["n_racks"], c["duration_s"], engine=engine)
        want[engine] = {k: v.cpu() for k, v in chip_smoke._result_leaves(res).items()
                        if k.startswith(("state.", "health."))}
    fleet._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()
    shipped = chip_smoke._sharded_rank
    try:
        for label, rank_fn in (("campus-width sums", shipped),
                               ("block-width sums", _block_width_rank)):
            chip_smoke._sharded_rank = rank_fn
            t0 = time.perf_counter()
            ranks = chip_smoke._run_world(2, "gloo", "campus")
            print(f"phase 23b's world of 2 gloo ranks, {label} "
                  f"({time.perf_counter() - t0:.1f} s):", flush=True)
            for engine in ("host", "scanned"):
                for r, o in enumerate(ranks):
                    got = o[f"{engine}/res"]
                    bad = [k for k, w in want[engine].items() if not torch.equal(got[k], w)]
                    print(f"  {engine} rank {r}: {len(bad)} of {len(want[engine])} per-rack "
                          f"leaves not bit for bit {bad[:8]}", flush=True)
    finally:
        chip_smoke._sharded_rank = shipped


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase23b", action="store_true")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    sweep()
    if args.phase23b:
        phase23b()


if __name__ == "__main__":
    main()
