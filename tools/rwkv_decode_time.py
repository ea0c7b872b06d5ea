"""Time one decode step of the checkout's ``rwkv6_scan`` kernel on the card.

Run from the root of a checkout (``PYTHONPATH=src python3
tools/rwkv_decode_time.py LABEL``): a single step (T = 1) of 4 sequences x
64 heads in bf16 from a float32 state, at head dims 32, 64, 128 and 256,
each the median of 101 calls timed with CUDA events (the card kept busy
while the host enqueues, as ``chip_smoke.py``'s ``_median_ms`` does).
Prints ``LABEL {"32": ms, ...}``.  ``tools/rwkv_decode_compare.sh`` runs
it in two checkouts, interleaved.
"""
import json
import statistics
import sys

import torch

from repro_torch.kernels import rwkv6_scan as rw


def median_ms(fn, reps: int = 101, warmup: int = 5) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("rwkv_decode_time: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    b, h = 4, 64
    out = {}
    for d in (32, 64, 128, 256):
        r, k, v = (0.5 * randn(b, h, 1, d) for _ in range(3))
        w = torch.exp(-torch.exp(-6.0 + randn(b, h, 1, d)))
        u = 0.1 * randn(h, d)
        s0 = 0.5 * randn(b, h, d, d)
        args = [x.to(torch.bfloat16) for x in (r, k, v, w, u)] + [s0]
        out[d] = median_ms(lambda: rw.rwkv6_scan(*args))
    print(sys.argv[1] if len(sys.argv) > 1 else "this", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
