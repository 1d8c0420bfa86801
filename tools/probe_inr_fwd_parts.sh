#!/bin/bash
# Where K7 forward's time goes: builds three copies of the port beside the
# working tree with one part of csrc/inr_fwd.cu switched off, and times each
# with tools/time_flow_kernels.py (K7 forward in every mode and K5):
#   v1  no encoding (encode_slice returns at once: u_0 left as it was),
#   v2  no products (slice_mma returns at once),
#   v3  no weight reads (every weight copy zero-filled, nothing read),
#   v4  neither encoding nor products (the tile walk, weight stream, syncs,
#       epilogues and output layer alone).
# The differences against the working tree's own times are each part's
# exposed cost. The outputs are wrong in v1-v4: this times, it checks
# nothing. Run on the card from the root of the repo:
#
#     bash tools/probe_inr_fwd_parts.sh [OUT_DIR]
set -e
OUT=${1:-chiprun_out}
mkdir -p "$OUT"
F=sin_inn_tpu_torch/csrc/inr_fwd.cu
mk() {
  rm -rf "chip_checkout/$1"; mkdir -p "chip_checkout/$1"
  cp -r sin_inn_tpu_torch "chip_checkout/$1/"
  rm -rf "chip_checkout/$1/sin_inn_tpu_torch/build"
}
no_encode='s/^  const int c = s \* kBK + lane;/  if (true) return;\n  const int c = s * kBK + lane;/'
no_mma='s/int nt, float (&acc)\[2\]\[kNT\]\[4\]) {/int nt, float (\&acc)[2][kNT][4]) {\n  if (true) return;/'
no_reads='s/const bool ok = k_lo + r < K \&\& c4 < H;/const bool ok = false;/'
mk v1; sed -i "$no_encode" "chip_checkout/v1/$F"
mk v2; sed -i "$no_mma" "chip_checkout/v2/$F"
mk v3; sed -i "$no_reads" "chip_checkout/v3/$F"
mk v4; sed -i -e "$no_encode" -e "$no_mma" "chip_checkout/v4/$F"
for v in v1 v2 v3 v4; do
  test "$(grep -c 'if (true) return;\|ok = false' "chip_checkout/$v/$F")" -ge 1
done
for v in tree v1 v2 v3 v4; do
  if [ $v = tree ]; then P=.; else P=chip_checkout/$v; fi
  PYTHONPATH=$P python3 tools/time_flow_kernels.py $v > "$OUT/probe_$v.log" 2>&1
  grep "K7 forward" "$OUT/probe_$v.log"
done
