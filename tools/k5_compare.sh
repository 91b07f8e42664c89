#!/bin/bash
# K5 of a parent tree against this one, in one call on the card: phases
# 0, 1, 10, 11 and 15 (tools/k5_compare.py) in turns, parent, this tree,
# this tree, parent, each in its own process; logs under LOG_DIR (second
# argument, default build/k5cmp).  The parent is a git archive unpacked
# into a directory .gitignore lists, e.g.
#   mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
#   bash tools/k5_compare.sh build/parent   # one H100
cd "$(dirname "$0")/.." || exit 1
parent=${1:-build/parent}
logs=${2:-build/k5cmp}
mkdir -p "$logs"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
for t in "$parent" . . "$parent"; do
  i=$((i + 1))
  timeout 900 python3 tools/k5_compare.py "$t" > "$logs/run$i.log" 2>&1
  echo "run $i ($t) rc $?"
  grep -a "\[cmp\]\|Error\|FAIL\|Traceback" "$logs/run$i.log" | cut -c1-200 | tail -5
done
