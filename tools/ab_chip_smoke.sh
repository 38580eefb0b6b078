#!/usr/bin/env bash
# Compare two checkouts on one card: chip_smoke.py of the parent, this
# checkout, this checkout, the parent, each log in OUT_DIR/abba_*.log
# (default log/ab), the summary lines printed. Unpack the parent first into
# a directory that .gitignore lists, e.g.
#   git archive <commit> | tar -x -C playground/parent
# and run from the root of this checkout:
#   bash tools/ab_chip_smoke.sh playground/parent [OUT_DIR]
set -o pipefail
parent=${1:?usage: ab_chip_smoke.sh PARENT_DIR [OUT_DIR]}
out=${2:-log/ab}
mkdir -p "$out"
i=0
for who in parent change change parent; do
  i=$((i+1))
  if [ $who = parent ]; then d=$parent; else d=.; fi
  s=$(date +%s)
  (cd "$d" && python3 chip_smoke.py) > "$out/abba_${i}_${who}.log" 2>&1
  rc=$?
  echo "run $i $who rc=$rc $(( $(date +%s) - s )) s"
  grep -a "^card: \|^training at b16\|^train CLI timing\|^NVIDIA" \
    "$out/abba_${i}_${who}.log" | cut -c1-1500
done
