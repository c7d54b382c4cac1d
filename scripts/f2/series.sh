#!/bin/bash
# F2 series: chip_smoke.py, then F2's test, then the CPU prefill of the
# test's model 2,000 times on 8 threads and 300 times pinned to each core
# (one process per core in iterations 2-7, one process in turn after);
# iterations FIRST..LAST on a machine with one card, one summary line each
# in $OUT/f2_summary.jsonl (OUT defaults to results/f2).
#     bash scripts/f2/series.sh FIRST LAST
cd "$(dirname "$0")/../.."
OUT=${OUT:-results/f2}
mkdir -p "$OUT"
for i in $(seq $1 $2); do
  P=$OUT/L$i
  ( time python3 chip_smoke.py ) > ${P}_smoke.log 2> ${P}_smoke.err
  src=$?
  PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_cuda.py -k "test_lm_prefill_and_serving_on_card_equal_cpu" -p no:cacheprovider > ${P}_f2.log 2>&1
  trc=$?
  PYTHONPATH=src timeout 120 python scripts/f2/cpu_prefill.py plain 2000 > ${P}_cpu.log 2>&1
  PYTHONPATH=src timeout 120 python scripts/f2/cpu_prefill.py cores 300 >> ${P}_cpu.log 2>&1
  python - $i $src $trc "$OUT" <<'PY' >> $OUT/f2_summary.jsonl
import json, sys
i, src, trc, out = sys.argv[1:]
P = f"{out}/L{i}"
f2 = [json.loads(l) for l in open(P + "_f2.log") if l.startswith("{")]
cpu = [json.loads(l) for l in open(P + "_cpu.log") if l.startswith("{")]
print(json.dumps({"iter": int(i), "smoke_rc": int(src), "test_rc": int(trc),
                  "f2": [{k: d.get(k) for k in ("arch", "card_digest", "cpu_digest", "logits_max_abs_err", "cache_max_abs_err")} for d in f2],
                  "cpu": [{"cpus": "all", "digests": d["digests"], "not_good": d["not_good"][:5]} if "digests" in d else
                          {"per_core": {c: v for c, v in d["per_core"].items()}} for d in cpu]}))
PY
  tail -1 $OUT/f2_summary.jsonl | cut -c1-400
done
