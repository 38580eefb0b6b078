#!/usr/bin/env bash
# The edge-rollout phase of chip_smoke.py alone, in alternating pairs of
# the parent checkout and this one (each a fresh process: build, weights
# from seed 0, two timed runs of the phase); prints one "EDGE <who> <fps>
# <fps>" line a process. Usage, from the root of this checkout:
#   bash tools/ab_edge_rollout.sh playground/parent [pairs]
set -o pipefail
parent=${1:?usage: ab_edge_rollout.sh PARENT_DIR [PAIRS]}
pairs=${2:-5}
one() {
  (cd "$1" && python3 -c "
import torch, chip_smoke as cs
from video_layout_generation_tpu_torch.ops import kernels as kern
from video_layout_generation_tpu_torch.ops.kernels import _build
_build.build()
w = cs.edge_mode_weights(0)
fps = [cs.run_edge_rollout(torch, kern, w, 0)[1]['fps'] for _ in range(2)]
print('EDGE', '$2', ' '.join('%.1f' % f for f in fps), flush=True)
" 2>&1 | grep -a "^EDGE")
}
for i in $(seq 1 "$pairs"); do
  if [ $((i % 2)) = 1 ]; then one "$parent" parent; one . change
  else one . change; one "$parent" parent; fi
done
