#!/usr/bin/env python3
"""flash_attention at head dim 256 alone, from the checkout at ROOT (default:
this one), so that a parent and a change can be compared in one chip call:

    python3 scripts/wide_phase.py [ROOT]

Runs ROOT's own chip_smoke.py phases: (t9) first, in a process of its own
that has the card to itself (gemma3-4b at 12 of its 34 layers trained for 3
steps, one more profiled; it peaks within a few GiB of the card's memory),
then (o)'s flash_attention rows (gemma3-4b's 8 / 4 heads of 256 over 4096
tokens, causal and window 1024, each held to its plain version and timed
beside SDPA and its bound; the other (o) kernels run too) and (t1) (the
backward at every training shape, gemma3-4b's d 256 ones among them, with
SDPA's backward and the bounds). Run parent, change, change, parent. It
prints what the phases print, then one JSON line: the card, (o)'s flash
times, (t1)'s times by case, and (t9)'s warm step, tokens/s, model-FLOPs
utilisation, busy time and flash kernels' time, or the last line of its
error.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    args = [a for a in sys.argv[1:] if a != "--t9"]
    root = Path(args[0]).resolve() if args else ROOT
    if not torch.cuda.is_available():
        print("wide_phase: no CUDA device", file=sys.stderr)
        return 2
    if "--t9" not in sys.argv:
        child = subprocess.run([sys.executable, __file__, str(root), "--t9"],
                               capture_output=True, text=True)
        print(child.stdout, end="")
        t9 = (json.loads(child.stdout.splitlines()[-1]) if child.returncode == 0 else
              {"error": (child.stderr.strip().splitlines() or ["rc %d" % child.returncode])[-1]})
    sys.path[:0] = [str(root), str(root / "src")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.configs import get_config

    smi = cs.phase_device()
    gemma = get_config(cs.SWA_NAME)
    if "--t9" in sys.argv:
        cfg = dataclasses.replace(gemma, n_layers=cs.FAMILY_TRAIN_LAYERS[cs.SWA_NAME])
        _, _, step = cs.phase_train_family(cfg, cs.FAMILY_TRAIN_STEPS, "train (t9)", smi)
        print(json.dumps({k: step[k] for k in ("warm_step_ms", "tokens_per_s", "mfu", "peak_gib",
                                               "busy_ms", "bwd_kernels_ms", "fwd_kernels_ms",
                                               "bwd_kernels")}))
        return 0
    flash = cs.phase_wide_kernels(gemma, smi)["flash_attention"]
    cs.free_weights()
    o = {}
    for label, r in (("window_0", flash), (f"window_{gemma.sliding_window}", flash["windowed"])):
        o[label] = {"ms": r["ms"], "library_ms": r["library_ms"], "err": r["err"],
                    "bound_ms": r["bound"]["tensor_core"][0]}
    kern = cs.phase_train_kernel(get_config(cs.TRAIN_NAME), smi)
    t1 = {label: {"ms": r["ms"], "library_ms": r["library_ms"], "variant": r["variant"],
                  "errs": r["errs"], "bound_ms": r["bound"]["tensor_core"][0],
                  "design_bound_ms": r["design_bound"]["tensor_core"][0]}
          for label, r in kern.items() if "ms" in r}
    print(json.dumps({"root": str(root), "card": smi, "o_flash": o, "t1": t1, "t9": t9}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
