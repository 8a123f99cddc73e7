#!/bin/bash
# The wall time of `python3 chip_smoke.py` in each source tree given, in
# the order given, each with a fresh build of the kernels.  Run on a
# machine with a card, from the root of a checkout; a tree is a directory
# holding chip_smoke.py and its package, e.g. this checkout (.) or a
# `git archive` of another commit unpacked under build/:
#
#     bash tools/smoke_wall.sh build/parent . . build/parent
#
# Prints one line per run (its tree, exit code and seconds); run k's output
# goes to chiprun_out/smoke_wall_<k>.jsonl and its errors to .err.
set -u
TIMEFORMAT=%R
out=$PWD/chiprun_out
mkdir -p "$out"
k=0
for tree in "$@"; do
  k=$((k + 1))
  rm -rf "$tree/build/neilpy_tpu_torch"
  secs=$( { time (cd "$tree" && python3 chip_smoke.py \
      > "$out/smoke_wall_$k.jsonl" 2> "$out/smoke_wall_$k.err"); } 2>&1 )
  rc=$?
  echo "run $k tree $tree rc=$rc wall_s=$secs"
done
