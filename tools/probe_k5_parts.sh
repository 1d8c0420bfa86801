#!/bin/bash
# Where K5's time goes: builds copies of the port beside the working tree,
# each with more of csrc/splat_region.cu's splat kernel switched off, and
# times each with tools/time_flow_kernels.py --k5 (K5 and K5 local on the
# tool's flows, then K5 on a quarter of the flow and on 0.3 px of noise,
# each kernel's device time):
#   p1  no adds: a queued source is dropped (the window walk, the chunk
#       summaries, the per-source tests and the queue are left),
#   p2  p1 and no window walk (left: the zeroed sums, the slots' maxima,
#       the conversion and the stores),
#   p3  p2 and no stores of the output (the conversion is still made).
# The differences against the working tree's own times are each part's
# exposed cost. The outputs are wrong in p1-p3: this times, it checks
# nothing. Run on the card from the root of the repo; each copy's log goes
# to OUT_DIR (default: the git-ignored chip_checkout/probe_k5):
#
#     bash tools/probe_k5_parts.sh [OUT_DIR]
set -e
OUT=${1:-chip_checkout/probe_k5}
mkdir -p "$OUT"
K=sin_inn_tpu_torch/csrc/splat_region.cu
mk() {
  rm -rf "chip_checkout/$1"; mkdir -p "chip_checkout/$1"
  cp -r sin_inn_tpu_torch "chip_checkout/$1/"
  rm -rf "chip_checkout/$1/sin_inn_tpu_torch/build"
}
# patch FILE OLD NEW...: each OLD must be in FILE once or more
patch() {
  python3 - "$@" <<'PY'
import sys
path, pairs = sys.argv[1], sys.argv[2:]
text = open(path).read()
for old, new in zip(pairs[::2], pairs[1::2]):
    old, new = old.replace("\\n", "\n"), new.replace("\\n", "\n")
    assert old in text, f"{path}: {old!r} not found"
    text = text.replace(old, new)
open(path, "w").write(text)
PY
}
NOADD=('  if (q < 0) return;\n' '  return;\n')
NOWALK=('for (int base = 0; base < npair; base += 32)'
        'for (int base = 0; base < 0 * npair; base += 32)')
NOSTORE=('      out[(img + (long long)(r0 + ry) * w + c0) * C + xc] = stage[e];'
         '      if (stage[e] == 12345.678f) out[0] = stage[e];')
mk p1; patch "chip_checkout/p1/$K" "${NOADD[@]}"
mk p2; patch "chip_checkout/p2/$K" "${NOADD[@]}" "${NOWALK[@]}"
mk p3; patch "chip_checkout/p3/$K" "${NOADD[@]}" "${NOWALK[@]}" "${NOSTORE[@]}"
# the builds of every copy at once
for v in tree p1 p2 p3; do
  if [ $v = tree ]; then P=.; else P=chip_checkout/$v; fi
  PYTHONPATH=$P python3 -c "from sin_inn_tpu_torch.ops.cuda import _build
_build.build_all(['splat_region'])" &
done
wait
for v in tree p1 p2 p3; do
  if [ $v = tree ]; then P=.; else P=chip_checkout/$v; fi
  PYTHONPATH=$P python3 tools/time_flow_kernels.py $v --k5 \
    > "$OUT/probe_k5_$v.log" 2>&1
  grep -v "build\|Warning\|_warn_once" "$OUT/probe_k5_$v.log"
done
