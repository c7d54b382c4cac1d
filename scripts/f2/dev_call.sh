#!/bin/bash
# On a machine with one card: chip_smoke.py, then F2's test (ROADMAP queue 3),
# the determinism probe (probe.py), every cuda-marked test and
# compute-sanitizer's racecheck, synccheck and initcheck on one flash
# launch.  Logs go to $OUT/d1_* (OUT defaults to results/f2).
#     bash scripts/f2/dev_call.sh
cd "$(dirname "$0")/../.."
OUT=${OUT:-results/f2}
mkdir -p "$OUT"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' > $OUT/d1_env.log 2>&1
( time python3 chip_smoke.py ) > $OUT/d1_smoke.log 2> $OUT/d1_smoke.err
echo "smoke rc=$?" >> $OUT/d1_smoke.err
PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_cuda.py -k "test_lm_prefill_and_serving_on_card_equal_cpu" -p no:cacheprovider > $OUT/d1_f2.log 2>&1
echo "f2 rc=$?" >> $OUT/d1_f2.log
timeout 600 python scripts/f2/probe.py repeat 100 10 > $OUT/d1_probe.log 2>&1
echo "probe rc=$?" >> $OUT/d1_probe.log
PYTHONPATH=src timeout 600 python -m pytest -q -m cuda tests/test_torch_cuda.py -p no:cacheprovider > $OUT/d1_tests.log 2>&1
echo "tests rc=$?" >> $OUT/d1_tests.log
CS=${COMPUTE_SANITIZER:-compute-sanitizer}
{ command -v "$CS"; } > $OUT/d1_sanitize.log 2>&1
for tool in racecheck synccheck initcheck; do
  echo "== $tool" >> $OUT/d1_sanitize.log
  timeout 300 $CS --tool $tool python scripts/f2/probe.py sanitize >> $OUT/d1_sanitize.log 2>&1
  echo "rc=$?" >> $OUT/d1_sanitize.log
done
tail -3 $OUT/d1_smoke.log; tail -2 $OUT/d1_f2.log $OUT/d1_tests.log; cat $OUT/d1_probe.log; tail -20 $OUT/d1_sanitize.log
