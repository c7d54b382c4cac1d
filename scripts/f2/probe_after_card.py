"""F2 probe 2: after card work in the same process (3,000 flash launches
beside 4096^2 matmuls on a side stream, 100 card prefills), the CPU prefill
of the narrow qwen2, traced op by op (first op whose output moves, its
inputs, the size of the move); then card and CPU prefills alternating, as
the test runs them.  Usage, from the root of the repository:
    python scripts/f2/probe_after_card.py N_TRACE N_PAIRS"""
import collections, hashlib, json, sys, time
sys.path.insert(0, "src")
import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.config.base import reduced_config
from repro_torch.configs import get_arch
from repro_torch.models import model as MDL

n_trace, n_pairs = int(sys.argv[1]), int(sys.argv[2])
build.build_kernels()
dev = torch.device("cuda")

def dig(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]

cfg = reduced_config(get_arch("qwen2-0.5b"), head_dim=64)
cpu = MDL.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
card = {k: v.to(dev) for k, v in cpu.items() if k != "layers"}
card["layers"] = [{k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev))
                   for k, v in lp.items()} for lp in cpu["layers"]]
toks = torch.from_numpy(np.random.default_rng(1).integers(1, cfg.vocab, (1, 150)))

def prefill(params, t):
    w, wc = MDL.prefill_with_caches(cfg, params, t, 192)
    return w, wc, dig(w, *[c[k] for c in wc for k in sorted(c)])

out = {"cpu_threads": torch.get_num_threads(), "torch": torch.__version__}
g = torch.Generator().manual_seed(0)
q = torch.randn(1, 150, 4, 64, generator=g).to(dev)
k = torch.randn(1, 150, 1, 64, generator=g).to(dev)
v = torch.randn(1, 150, 1, 64, generator=g).to(dev)
side = torch.cuda.Stream()
a = torch.randn(4096, 4096, device=dev)
for i in range(3000):
    if i % 2:
        with torch.cuda.stream(side):
            a @ a
    FA.flash_attention(q, k, v, causal=True)
cards = collections.Counter(prefill(card, toks.to(dev))[2] for _ in range(100))
out["card_digests"] = dict(cards)

class Rec(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.log = []
    def __torch_function__(self, func, types, args=(), kwargs=None):
        r = func(*args, **(kwargs or {}))
        ins = [x for x in args if isinstance(x, torch.Tensor)]
        if isinstance(r, torch.Tensor) and r.dtype.is_floating_point:
            self.log.append((getattr(func, "__name__", str(func)),
                             dig(*ins) if ins else "", dig(r), r.detach().clone(),
                             [tuple(x.shape) for x in ins]))
        return r

ref = None
finals = collections.Counter()
firsts = []
for i in range(n_trace):
    rec = Rec()
    with rec:
        w, wc, d = prefill(cpu, toks)
    finals[d] += 1
    if ref is None:
        ref = (rec.log, w, wc)
        continue
    for j, (x, y) in enumerate(zip(rec.log, ref[0])):
        if x[2] != y[2]:
            firsts.append({"run": i, "op": j, "name": x[0], "inputs_equal": x[1] == y[1],
                           "in_shapes": x[4],
                           "max_abs_diff": float((x[3] - y[3]).abs().max()) if x[3].shape == y[3].shape else None,
                           "n_diff": int((x[3] != y[3]).sum()) if x[3].shape == y[3].shape else None,
                           "final_logits": float((w - ref[1]).abs().max()),
                           "final_cache": max(float((p[kk] - r[kk]).abs().max()) for p, r in zip(wc, ref[2]) for kk in r)})
            break
out.update(trace_runs=n_trace, trace_digests=dict(finals), first_divergence=firsts[:30],
           n_divergent=len(firsts))
pairs_card, pairs_cpu, devs = collections.Counter(), collections.Counter(), []
base = None
for i in range(n_pairs):
    gw, gc, gd = prefill(card, toks.to(dev))
    w, wc, d = prefill(cpu, toks)
    pairs_card[gd] += 1
    pairs_cpu[d] += 1
    if base is None:
        base = (w, wc, d)
    elif d != base[2]:
        devs.append({"pair": i, "logits": float((w - base[0]).abs().max()),
                     "cache": [max(float((p[kk] - r[kk]).abs().max()) for kk in r) for p, r in zip(wc, base[1])]})
out.update(pairs=n_pairs, pair_card_digests=dict(pairs_card), pair_cpu_digests=dict(pairs_cpu),
           pair_cpu_deviations=devs[:30])
print(json.dumps(out), flush=True)
