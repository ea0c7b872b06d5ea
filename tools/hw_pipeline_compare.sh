#!/bin/bash
# pdu_health, pdu_sim and lc_filter times in this checkout and another, in one call on
# one card, interleaved (other, this, this, other), each with a digest of
# its outputs (the same digests: the same bits).
#
#   git archive <commit> src | tar -x -C build/other   # build/ is gitignored
#   bash tools/hw_pipeline_compare.sh build/other
#
# Builds the three kernels in both checkouts at once, then runs
# tools/hw_pipeline_time.py in each; prints the card's name and power limit
# first.
set -euo pipefail
here=$(cd "$(dirname "$0")/.." && pwd)
other=$(cd "${1:?usage: hw_pipeline_compare.sh OTHER_CHECKOUT}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
build() {
  (cd "$1" && PYTHONPATH=src python3 -c \
    "from repro_torch.kernels import _build; _build.build(['pdu_health', 'pdu_sim', 'lc_filter'])" > /dev/null)
}
build "$other" & p1=$!
build "$here" & p2=$!
wait $p1
wait $p2
for label in other this this other; do
  dir=$here
  [ "$label" = other ] && dir=$other
  (cd "$dir" && PYTHONPATH=src python3 "$here/tools/hw_pipeline_time.py" "$label")
done
