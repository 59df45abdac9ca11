#!/usr/bin/env python3
"""chip_smoke.py's (t1) and (t2) alone, from the checkout at ROOT (default:
this one), so that a parent and a change can be compared in one chip call:

    python3 scripts/train_phase.py [ROOT]

(t1) holds flash_attention's backward to its plain version at full-width
qwen3-1.7b's training shape (also with window 1024, at gemma3-4b's d 256
heads and hymba-1.5b's 25 / 5 heads of 64) and times it; (t2) runs 5 train
steps of
full-width qwen3-1.7b over 2 x 4096 tokens and profiles one more (ROOT's
chip_smoke.py, its own phase functions). Run parent, change, change,
parent. It prints what the two phases print, then one JSON line: (t1)'s
device times by case, (t2)'s warm step, tokens/s, model-FLOPs utilisation,
the profiled step's device busy time and its backward kernels' time.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT
    if not torch.cuda.is_available():
        print("train_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(root), str(root / "src")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.configs import get_config

    smi = cs.phase_device()
    cfg = get_config(cs.TRAIN_NAME)
    kern = cs.phase_train_kernel(cfg, smi)
    _, _, step = cs.phase_train_step(cfg, smi)
    print(json.dumps({"root": str(root), "card": smi,
                      "t1_ms": {label: r["ms"] for label, r in kern.items() if "ms" in r},
                      **{k: step[k] for k in ("warm_step_ms", "tokens_per_s", "mfu", "busy_ms",
                                              "bwd_kernels_ms")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
