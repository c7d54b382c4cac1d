#!/bin/bash
# On a machine with one card: the CPU prefill of F2's test model 2,000
# times with and without CUDA initialised, on 8 threads and on 1, and
# traced op by op (cpu_prefill.py).  Log: $OUT/f2cpu.log (OUT defaults
# to results/f2).
#     bash scripts/f2/cpu_call.sh
cd "$(dirname "$0")/../.."
OUT=${OUT:-results/f2}
mkdir -p "$OUT"
O=$OUT/f2cpu.log
: > $O
python -c 'import torch; print(torch.__version__); print(torch.__config__.parallel_info()); print(torch.__config__.show())' >> $O 2>&1
lscpu | head -20 >> $O 2>&1
nproc >> $O
for args in "plain 2000" "plain 2000 cuda" "plain 2000 cuda 1" "plain 2000 1" "trace 300 cuda" "trace 300"; do
  PYTHONPATH=src timeout 300 python scripts/f2/cpu_prefill.py $args >> $O 2>&1
  echo "rc=$? [$args]" >> $O
done
grep '^{' $O
