#!/bin/bash
# Where K8's time goes: builds copies of the port beside the working tree,
# each with one part of K8's kernels switched off, and times each with
# tools/time_flow_kernels.py --k8 (K8 forward at batch 8 and 40, K8
# backward with the device time of each of its kernels):
#   p1  no conv1 products in the fused kernel (its conv1 slices skipped),
#   p2  no conv2 products in the fused kernel,
#   p3  one TF32 product (hi hi) instead of three in the fused kernel and
#       the convolutions of stages 2-3 (csrc/coupling_3x3.cuh run_slice),
#   p4  no operand split in those products (A taken as it is stored),
#   p5  no weight streaming in those kernels (no slice is copied),
#   p6  no products at all: run_slice's and the weight stage's mma removed
#       (what is left: loads, splits the compiler keeps, barriers,
#       epilogues).
# The differences against the working tree's own times are each part's
# exposed cost. The outputs are wrong in p1-p6: this times, it checks
# nothing. Run on the card from the root of the repo; each copy's log goes
# to OUT_DIR (default: the git-ignored chip_checkout/probe_k8):
#
#     bash tools/probe_k8_parts.sh [OUT_DIR]
set -e
OUT=${1:-chip_checkout/probe_k8}
mkdir -p "$OUT"
H=sin_inn_tpu_torch/csrc/coupling_3x3.cuh
W=sin_inn_tpu_torch/csrc/weight_stage.cuh
mk() {
  rm -rf "chip_checkout/$1"; mkdir -p "chip_checkout/$1"
  cp -r sin_inn_tpu_torch "chip_checkout/$1/"
  rm -rf "chip_checkout/$1/sin_inn_tpu_torch/build"
}
# patch FILE OLD NEW...: each OLD must be in FILE once or more
patch() {
  python3 - "$@" <<'EOF'
import sys
path, pairs = sys.argv[1], sys.argv[2:]
text = open(path).read()
for old, new in zip(pairs[::2], pairs[1::2]):
    old, new = old.replace("\\n", "\n"), new.replace("\\n", "\n")
    assert old in text, f"{path}: {old!r} not found"
    text = text.replace(old, new)
open(path, "w").write(text)
EOF
}
LO='if (g < live) mma(t[i][g], lo[i], bh[g][0], bh[g][1]);'
HL='if (g < live) mma(t[i][g], hi[i], bl[g][0], bl[g][1]);'
HH='if (g < live) mma(t[i][g], hi[i], bh[g][0], bh[g][1]);'
mk p1; patch "chip_checkout/p1/$H" \
  'if (warp + kWarps * t < mt1)\n' 'if (warp + kWarps * t < 0)\n'
mk p2; patch "chip_checkout/p2/$H" 'if (gi < groups2)\n' 'if (gi < 0)\n'
mk p3; patch "chip_checkout/p3/$H" "$LO" ';' "$HL" ';'
mk p4; patch "chip_checkout/p4/$H" \
  'split(p0[0], hi[i][0], lo[i][0]);' 'hi[i][0] = lo[i][0] = __float_as_uint(p0[0]);' \
  'split(p1[0], hi[i][1], lo[i][1]);' 'hi[i][1] = lo[i][1] = __float_as_uint(p1[0]);' \
  'split(p0[4], hi[i][2], lo[i][2]);' 'hi[i][2] = lo[i][2] = __float_as_uint(p0[4]);' \
  'split(p1[4], hi[i][3], lo[i][3]);' 'hi[i][3] = lo[i][3] = __float_as_uint(p1[4]);'
mk p5; patch "chip_checkout/p5/$H" \
  'if (i + ns - 1 < total) issue(i + ns - 1);' 'if (i + ns - 1 < 0) issue(i + ns - 1);'
mk p6; patch "chip_checkout/p6/$H" "$LO" ';' "$HL" ';' "$HH" ';'
patch "chip_checkout/p6/$W" 'mma(t[i][n], lo[i], bh0, bh1);' ';' \
  'mma(t[i][n], hi[i], bl0, bl1);' ';' 'mma(t[i][n], hi[i], bh0, bh1);' ';'
# the builds of every copy at once (one nvcc a source, the sources at once)
for v in tree p1 p2 p3 p4 p5 p6; do
  if [ $v = tree ]; then P=.; else P=chip_checkout/$v; fi
  PYTHONPATH=$P python3 -c "from sin_inn_tpu_torch.ops.cuda import _build
_build.build_all(['coupling_3x3', 'coupling_3x3_bwd', 'coupling_1x1_bwd'])" &
done
wait
for v in tree p1 p2 p3 p4 p5 p6; do
  if [ $v = tree ]; then P=.; else P=chip_checkout/$v; fi
  PYTHONPATH=$P python3 tools/time_flow_kernels.py $v --k8 \
    > "$OUT/probe_k8_$v.log" 2>&1
  grep -v "build\|Warning\|_warn_once" "$OUT/probe_k8_$v.log"
done
