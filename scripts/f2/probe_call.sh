#!/bin/bash
# On a machine with one card: probe_after_card.py (200 traced CPU
# prefills, 200 card/CPU pairs) and probe.py after card work.
# Log: $OUT/f2p2.log (OUT defaults to results/f2).
#     bash scripts/f2/probe_call.sh
cd "$(dirname "$0")/../.."
OUT=${OUT:-results/f2}
mkdir -p "$OUT"
O=$OUT/f2p2.log
: > $O
timeout 600 python scripts/f2/probe_after_card.py 200 200 >> $O 2>&1; echo "rc=$?" >> $O
timeout 300 python scripts/f2/probe.py repeat 100 50 >> $O 2>&1; echo "rc=$?" >> $O
cat $O | cut -c1-6000
