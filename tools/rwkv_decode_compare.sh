#!/bin/bash
# Decode-step times of rwkv6_scan in this checkout and another, in one call
# on one card, interleaved (other, this, this, other, other, this).
#
#   git archive <commit> src | tar -x -C build/other   # build/ is gitignored
#   bash tools/rwkv_decode_compare.sh build/other
#
# Builds the kernel in both checkouts at once, then runs
# tools/rwkv_decode_time.py in each; prints the card's name and power limit
# first.
set -euo pipefail
here=$(cd "$(dirname "$0")/.." && pwd)
other=$(cd "${1:?usage: rwkv_decode_compare.sh OTHER_CHECKOUT}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
build() {
  (cd "$1" && PYTHONPATH=src python3 -c \
    "from repro_torch.kernels import _build; _build.build(['rwkv6_scan'])" > /dev/null)
}
build "$other" & p1=$!
build "$here" & p2=$!
wait $p1
wait $p2
for label in other this this other other this; do
  dir=$here
  [ "$label" = other ] && dir=$other
  (cd "$dir" && PYTHONPATH=src python3 "$here/tools/rwkv_decode_time.py" "$label")
done
