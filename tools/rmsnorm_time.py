"""Time the checkout's ``rmsnorm`` kernel on the card, warm, cold and back to
back.

Run from the root of a checkout (``PYTHONPATH=src python3
/path/to/tools/rmsnorm_time.py LABEL``): every shape of
``chip_smoke.RMSNORM_SHAPES`` (the main paths' prefill rows in bf16, (2048,
2048) in float32, the decode step's 4 rows, and the edge cases), each the
median of 51 calls timed with CUDA events by ``chip_smoke._median_ms`` (the
card kept busy while the host enqueues): warm (the inputs left in the 50 MB
L2 by the calls before) and cold (``chip_smoke.FLUSH_BYTES`` zeroed before
each call, so the L2 holds other data, dirty, as after a caller's GEMM).
``F.rms_norm`` is timed beside the kernel the same ways.  Back to back:
the wall time of 500 calls enqueued with no pause, then one synchronize,
a call, the least of 7 such runs (the host is shared: the least is the
run others disturbed least); where the card's work is small (the
decode rows) that is the host's time a call, the wrapper's checks, plan
and launch.  The kernel is imported from the ``src`` on ``PYTHONPATH``
(checked to lie under the working directory), then ``chip_smoke`` from the
root of the checkout that holds this script (it puts its own ``src`` first
on the path, which no longer matters once the kernel is imported).  Prints
``LABEL {shape: {"warm": ms, "cold": ms, "lib_warm": ms, "lib_cold": ms,
"host_us": us}, ...}``.
``tools/rmsnorm_compare.sh`` runs it in two checkouts, interleaved.
"""
import json
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as rn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import FLUSH_BYTES, RMSNORM_SHAPES, _median_ms, _rmsnorm_inputs  # noqa: E402

BACK_TO_BACK = 500


def shape_key(rows: int, d: int, dtype: str, offset: bool) -> str:
    return f"{rows}x{d} {dtype}{' offset' if offset else ''}"


def back_to_back_us(fn, calls: int = BACK_TO_BACK, runs: int = 7) -> float:
    """Wall microseconds a call of ``calls`` calls enqueued with no pause,
    the least of ``runs`` runs."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    return min(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("rmsnorm_time: no CUDA device available", file=sys.stderr)
        return 2
    if not Path(rn.__file__).resolve().is_relative_to(Path.cwd().resolve()):
        print(f"rmsnorm_time: the kernel came from {rn.__file__}, outside {Path.cwd()}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    eps = 1e-5
    out = {}
    for rows, d, dtype, offset in RMSNORM_SHAPES:
        x, w = _rmsnorm_inputs(rows, d, dtype, offset, gen, dev)
        kernel = lambda: rn.rmsnorm(x, w, eps)
        lib = lambda: F.rms_norm(x, (d,), w, eps)
        out[shape_key(rows, d, dtype, offset)] = {
            "warm": _median_ms(kernel, reps=51, warmup=5),
            "cold": _median_ms(kernel, reps=51, warmup=5, flush=flush),
            "lib_warm": _median_ms(lib, reps=51, warmup=5),
            "lib_cold": _median_ms(lib, reps=51, warmup=5, flush=flush),
            "host_us": back_to_back_us(kernel)}
    print(sys.argv[1] if len(sys.argv) > 1 else "this", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
