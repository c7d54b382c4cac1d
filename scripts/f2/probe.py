"""F2 probe: is the card's or the CPU's side of the narrow qwen2 prefill
run-to-run deterministic?  Modes: 'sanitize' (one flash launch at the
test's shapes, for compute-sanitizer), 'repeat' (digests of many runs).
From the root of the repository:
    python scripts/f2/probe.py sanitize | repeat N_CARD N_CPU"""
import hashlib, json, sys, time
sys.path.insert(0, "src")
import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA

mode = sys.argv[1]
build.build_kernels()
dev = torch.device("cuda")
g = torch.Generator().manual_seed(0)
q = torch.randn(1, 150, 4, 64, generator=g).to(dev)
k = torch.randn(1, 150, 1, 64, generator=g).to(dev)
v = torch.randn(1, 150, 1, 64, generator=g).to(dev)

def dig(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]

if mode == "sanitize":
    o = FA.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    print(json.dumps({"flash_digest": dig(o), "finite": bool(torch.isfinite(o).all())}))
    sys.exit(0)

out = {}
# 1. the flash kernel alone, 3000 launches, half of them beside a large
# matmul on another stream (perturbed timing)
ref = FA.flash_attention(q, k, v, causal=True)
side = torch.cuda.Stream()
a = torch.randn(4096, 4096, device=dev)
bad = 0
t0 = time.time()
for i in range(3000):
    if i % 2:
        with torch.cuda.stream(side):
            a @ a
    o = FA.flash_attention(q, k, v, causal=True)
    if not torch.equal(o, ref):
        bad += 1
torch.cuda.synchronize()
out["flash_launches"] = 3000
out["flash_mismatches"] = bad
out["flash_s"] = time.time() - t0
# 2. the test's whole prefill on the card and on the CPU, repeated
from repro_torch.config.base import reduced_config
from repro_torch.configs import get_arch
from repro_torch.models import model as MDL
cfg = reduced_config(get_arch("qwen2-0.5b"), head_dim=64)
cpu = MDL.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
card = {kk: vv.to(dev) for kk, vv in cpu.items() if kk != "layers"}
card["layers"] = [{kk: ({n: t.to(dev) for n, t in vv.items()} if isinstance(vv, dict) else vv.to(dev))
                   for kk, vv in lp.items()} for lp in cpu["layers"]]
toks = torch.from_numpy(np.random.default_rng(1).integers(1, cfg.vocab, (1, 150)))
def pdig(logits, caches):
    ts = [logits] + [c[kk] for c in caches for kk in sorted(c)]
    return dig(*ts)
cards, cpus = {}, {}
for i in range(int(sys.argv[2]) if len(sys.argv) > 2 else 50):
    got, gc = MDL.prefill_with_caches(cfg, card, toks.to(dev), 192)
    d = pdig(got, gc)
    cards[d] = cards.get(d, 0) + 1
for i in range(int(sys.argv[3]) if len(sys.argv) > 3 else 10):
    want, wc = MDL.prefill_with_caches(cfg, cpu, toks, 192)
    d = pdig(want, wc)
    cpus[d] = cpus.get(d, 0) + 1
out["card_prefill_digests"] = cards
out["cpu_prefill_digests"] = cpus
out["cpu_threads"] = torch.get_num_threads()
print(json.dumps(out))
