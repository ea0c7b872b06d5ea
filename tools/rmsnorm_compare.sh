#!/bin/bash
# rmsnorm kernel times in this checkout and another, in one call on one
# card, interleaved (other, this, this, other, other, this), warm, cold and
# back to back (the host's time a call), at every shape of
# chip_smoke.RMSNORM_SHAPES (tools/rmsnorm_time.py).
#
#   mkdir -p build/other && git archive <commit> src | tar -x -C build/other
#   bash tools/rmsnorm_compare.sh build/other      # build/ is gitignored
#
# Builds the kernel in both checkouts at once, then runs
# tools/rmsnorm_time.py in each; prints the card's name and power limit
# first and, last, each shape's times by checkout (min, median and max of
# the three runs) and the ratios of the medians.
set -euo pipefail
here=$(cd "$(dirname "$0")/.." && pwd)
other=$(cd "${1:?usage: rmsnorm_compare.sh OTHER_CHECKOUT}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
build() {
  (cd "$1" && PYTHONPATH=src python3 -c \
    "from repro_torch.kernels import _build; _build.build(['rmsnorm'])" > /dev/null)
}
build "$other" & p1=$!
build "$here" & p2=$!
wait $p1
wait $p2
lines=$(mktemp)
trap 'rm -f "$lines"' EXIT
for label in other this this other other this; do
  dir=$here
  [ "$label" = other ] && dir=$other
  (cd "$dir" && PYTHONPATH=src python3 "$here/tools/rmsnorm_time.py" "$label") | tee -a "$lines"
done
python3 - "$lines" <<'EOF'
import json, statistics, sys
runs = {"this": [], "other": []}
for line in open(sys.argv[1]):
    label, _, rest = line.partition(" ")
    runs[label].append(json.loads(rest))
print("shape: this warm [min median max] | other warm | this cold | other cold | "
      "F.rms_norm warm, cold (medians) | this/other warm, cold | this/F.rms_norm warm, cold | "
      "back to back us a call, this, other [medians]")
for key in runs["this"][0]:
    get = lambda label, k: sorted(r[key][k] for r in runs[label])
    tw, ow, tc, oc = get("this", "warm"), get("other", "warm"), get("this", "cold"), get("other", "cold")
    lw = statistics.median(get("this", "lib_warm") + get("other", "lib_warm"))
    lc = statistics.median(get("this", "lib_cold") + get("other", "lib_cold"))
    med = statistics.median
    fmt = lambda v: "[" + " ".join(f"{t:.5f}" for t in (v[0], med(v), v[-1])) + "]"
    print(f"{key}: {fmt(tw)} | {fmt(ow)} | {fmt(tc)} | {fmt(oc)} | {lw:.5f}, {lc:.5f} | "
          f"{med(tw) / med(ow):.3f}, {med(tc) / med(oc):.3f} | {med(tw) / lw:.3f}, {med(tc) / lc:.3f} | "
          f"{med(get('this', 'host_us')):.2f}, {med(get('other', 'host_us')):.2f}")
EOF
