"""F2: is the narrow qwen2 prefill on the CPU run-to-run deterministic, and
if not, which operation moves first?  ``not_good`` lists the runs whose
digest is not the most common one.  Usage:
    python scripts/f2/cpu_prefill.py plain N [cuda] [threads] [coreC]
                                         digests of N CPU prefills
    python scripts/f2/cpu_prefill.py cores N
                                         N prefills on one thread pinned to
                                         each core in turn, digests per core
    python scripts/f2/cpu_prefill.py trace N [cuda]
                                         every torch call's output, per run
(from the root of the repository)
"""
import collections, hashlib, json, os, sys, time
sys.path.insert(0, "src")
for f in sys.argv[3:]:
    if f.startswith("core"):
        os.sched_setaffinity(0, {int(f[4:])})
import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.config.base import reduced_config
from repro_torch.configs import get_arch
from repro_torch.models import model as MDL

mode, n = sys.argv[1], int(sys.argv[2])
flags = sys.argv[3:]
if "cuda" in flags:
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
for f in flags:
    if f.isdigit():
        torch.set_num_threads(int(f))
cfg = reduced_config(get_arch("qwen2-0.5b"), head_dim=64)
cpu = MDL.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
toks = torch.from_numpy(np.random.default_rng(1).integers(1, cfg.vocab, (1, 150)))

def dig(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]

def run():
    w, wc = MDL.prefill_with_caches(cfg, cpu, toks, 192)
    return w, wc, dig(w, *[c[k] for c in wc for k in sorted(c)])

out = {"mode": mode, "flags": flags, "threads": torch.get_num_threads(),
       "torch": torch.__version__, "cpus": sorted(os.sched_getaffinity(0))}
if mode == "plain":
    seq = []
    ref = None
    errs = {}
    t0 = time.time()
    for i in range(n):
        w, wc, d = run()
        if ref is None:
            ref = (w, wc, d)
        elif d != ref[2]:
            errs[i] = {"logits": float((w - ref[0]).abs().max()),
                       "cache": max(float((a[k] - b[k]).abs().max())
                                    for a, b in zip(wc, ref[1]) for k in b)}
        seq.append(d)
    out.update(digests=dict(collections.Counter(seq)), first=seq[0],
               not_good=[i for i, d in enumerate(seq)
                         if d != collections.Counter(seq).most_common(1)[0][0]][:50],
               deviations=errs, seconds=time.time() - t0)
elif mode == "cores":
    torch.set_num_threads(1)
    seqs = {}
    t0 = time.time()
    for c in out["cpus"]:
        os.sched_setaffinity(0, {c})
        seqs[c] = [run()[2] for _ in range(n)]
    common = collections.Counter(
        d for s in seqs.values() for d in s).most_common(1)[0][0]
    out.update(per_core={c: {"digests": dict(collections.Counter(s)),
                             "not_good": [i for i, d in enumerate(s)
                                          if d != common][:50]}
                         for c, s in seqs.items()},
               seconds=time.time() - t0)
else:
    class Rec(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.log = []
        def __torch_function__(self, func, types, args=(), kwargs=None):
            r = func(*args, **(kwargs or {}))
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            if isinstance(r, torch.Tensor) and r.dtype.is_floating_point:
                self.log.append((getattr(func, "__name__", str(func)),
                                 dig(*ins) if ins else "", dig(r),
                                 r.detach().clone(), [tuple(a.shape) for a in ins]))
            return r
    runs = []
    ref_log = None
    finals = collections.Counter()
    firsts = []
    for i in range(n):
        rec = Rec()
        with rec:
            w, wc, d = run()
        finals[d] += 1
        if ref_log is None:
            ref_log = rec.log
            continue
        for j, (a, b) in enumerate(zip(rec.log, ref_log)):
            if a[2] != b[2]:
                firsts.append({"run": i, "op": j, "name": a[0],
                               "inputs_equal": a[1] == b[1],
                               "in_shapes": a[4],
                               "max_abs_diff": float((a[3] - b[3]).abs().max())
                               if a[3].shape == b[3].shape else None})
                break
        del rec
    out.update(ops_per_run=len(ref_log), digests=dict(finals),
               first_divergence=firsts[:20], n_divergent=len(firsts))
print(json.dumps(out), flush=True)
