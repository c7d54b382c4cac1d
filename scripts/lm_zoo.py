#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``lm_zoo`` phase alone on a card.

    python scripts/lm_zoo.py

Builds the kernels (the ``build`` phase), then serves and checks the rest
of the LM zoo at full published width as ``phase_lm_zoo`` does: runs (a)-(e)
with their depth cuts, each run's launch window, plain replays, the
absorbed MLA decode, forwards against the plain path, MoE drops, KV-cache
bytes and the flash kernel at hd 128 and non-causal.  Prints the same JSON
lines as the whole script's phase, then one line with the phase's seconds
(the build included) and the launches summed over the runs.  Exits 2
without a CUDA device.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lm_zoo: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    state: dict = {}
    t0 = time.perf_counter()
    C.phase_build(state)
    C.phase_lm_zoo(state)
    print(json.dumps({"zoo_seconds": time.perf_counter() - t0,
                      "launches": state["lm_zoo_launches"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
