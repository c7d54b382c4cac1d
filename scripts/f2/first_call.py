"""F2: the first CPU call of an operation in a fresh process.  One process,
one JSON line (digests of the first and second result, and their largest
error against float64).  From the root of the repository:
    python scripts/f2/first_call.py cos|sin|polar [threads]
        the rotation angles of the test model's rope, 150 positions
    python scripts/f2/first_call.py prefill [trace]
        the test model's CPU prefill (logits and caches digested); with
        trace, the digest of every torch call's output in the first run
Run it in many fresh processes with scripts/f2/first_call.sh."""
import hashlib, json, sys
sys.path.insert(0, "src")
import numpy as np
import torch


def dig(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


mode = sys.argv[1]
if len(sys.argv) > 2 and sys.argv[2].isdigit():
    torch.set_num_threads(int(sys.argv[2]))
if mode == "prefill":
    from repro_torch.config.base import reduced_config
    from repro_torch.configs import get_arch
    from repro_torch.models import model as MDL

    cfg = reduced_config(get_arch("qwen2-0.5b"), head_dim=64)
    cpu = MDL.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (1, 150)))
    from torch.overrides import TorchFunctionMode

    log = []

    class Rec(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            r = func(*args, **(kwargs or {}))
            if isinstance(r, torch.Tensor) and r.dtype.is_floating_point:
                log.append([getattr(func, "__name__", str(func)), dig(r)])
            return r

    runs = []
    for i in range(2):
        if i == 0 and "trace" in sys.argv:
            with Rec():
                runs.append(MDL.prefill_with_caches(cfg, cpu, toks, 192))
        else:
            runs.append(MDL.prefill_with_caches(cfg, cpu, toks, 192))
    print(json.dumps({"log": log,
        "d1": dig(runs[0][0], *[c[k] for c in runs[0][1] for k in sorted(c)]),
        "d2": dig(runs[1][0], *[c[k] for c in runs[1][1] for k in sorted(c)]),
        "cache_12": max(float((a[k] - b[k]).abs().max())
                        for a, b in zip(runs[0][1], runs[1][1]) for k in a)}))
else:
    ang = torch.arange(150, dtype=torch.float32)[:, None] * (
        10000.0 ** (-torch.arange(0, 32, dtype=torch.float32) / 32))
    f = {"cos": torch.cos, "sin": torch.sin,
         "polar": lambda a: torch.polar(torch.ones_like(a), a).real}[mode]
    ref = (np.sin if mode == "sin" else np.cos)(ang.double().numpy())
    r1, r2 = f(ang), f(ang)
    print(json.dumps({"d1": dig(r1), "d2": dig(r2),
                      "err1": float(np.abs(r1.numpy() - ref).max()),
                      "err2": float(np.abs(r2.numpy() - ref).max())}))
