#!/bin/bash
# N fresh processes of first_call.py ARGS, 8 at a time, on the tree TREE
# (default: this checkout); prints how many gave each (first, second) digest
# pair, the largest first-call error and, with trace, the first traced
# output that moved against the most common run.
#     [TREE=dir] bash scripts/f2/first_call.sh N ARGS...
HERE=$(cd "$(dirname "$0")" && pwd)
cd "${TREE:-$HERE/../..}"
N=$1; shift
OUT=$(mktemp -d)
seq 1 "$N" | xargs -P 8 -I{} sh -c "python $HERE/first_call.py $* > $OUT/{}.json"
python - "$OUT" "$*" <<'PY'
import collections, glob, json, sys
rs = [json.load(open(f)) for f in glob.glob(sys.argv[1] + "/*.json")]
pairs = collections.Counter((r["d1"], r["d2"]) for r in rs)
moved = []
if rs and rs[0].get("log"):
    common = collections.Counter(r["d1"] for r in rs).most_common(1)[0][0]
    ref = next(r["log"] for r in rs if r["d1"] == common)
    for r in rs:
        j = next((j for j, (a, b) in enumerate(zip(r["log"], ref)) if a != b), None)
        if j is not None:
            moved.append({"digest": r["d1"], "op": j, "name": r["log"][j][0],
                          "before": [x[0] for x in r["log"][max(0, j - 3):j]]})
print(json.dumps({"args": sys.argv[2], "processes": len(rs),
                  "first_second_digests": {f"{a} {b}": n for (a, b), n in pairs.items()},
                  "max_first_err": max((r.get("err1", r.get("cache_12", 0.0)) for r in rs), default=None),
                  "moved": moved}))
PY
rm -rf "$OUT"
