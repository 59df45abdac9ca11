#!/usr/bin/env python3
"""selective_scan's kernels alone from the checkout at ROOT (default: this
one), so that a parent and a change can be compared in one chip call:

    python3 scripts/scan_phase.py [ROOT]

It times the chunked forward at the state-space path's prefill shape
(chip_smoke.py phase 7: s 4160, n 16, bfloat16 x, B and C slices of the
(b, s, 2n + 1) projection, bfloat16-rounded dt) at hymba-1.5b's d_inner
3200 and falcon-mamba-7b's 8192: serving's launch, without carry stores.
Where ROOT's wrapper has the backward (``carries_buffer``,
``selective_scan_bwd``), it also times at the training shape (s 4096) the
forward with its carry stores and the backward (random float32 dy). Each
time is the median device time of one call (ROOT's ``chip_smoke.device_ms``).
Inputs are seeded, the same for every ROOT. Run parent, change, change,
parent; the last line is one JSON object with every number.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = {"hymba": 3200, "falcon-mamba": 8192}
PREFILL_S, TRAIN_S, N = 4160, 4096, 16


def main() -> int:
    import torch

    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT
    if not torch.cuda.is_available():
        print("scan_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.kernels.selective_scan import ops as ss

    smi = cs.phase_device()
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def inputs(s, d_in):
        x = rn(1, s, d_in)
        dt = torch.nn.functional.softplus(rn(1, s, dtype=torch.float32) - 2.0).to(torch.bfloat16)
        A = -torch.exp(rn(d_in, N, dtype=torch.float32))
        proj = rn(1, s, 2 * N + 1)
        return x, dt, A, proj[..., :N], proj[..., N: 2 * N]

    out = {"root": str(root), "card": smi}
    for label, d_in in WIDTHS.items():
        args = inputs(PREFILL_S, d_in)
        out[f"{label} prefill ms"] = cs.device_ms(lambda: ss.selective_scan(*args))
        if hasattr(ss, "selective_scan_bwd"):
            args = inputs(TRAIN_S, d_in)
            carries = ss.carries_buffer(args[0], N)
            dy = rn(1, TRAIN_S, d_in, dtype=torch.float32)
            out[f"{label} training forward ms"] = cs.device_ms(lambda: ss.selective_scan(*args))
            out[f"{label} training forward with carries ms"] = cs.device_ms(
                lambda: ss.selective_scan(*args, carries=carries))
            out[f"{label} backward ms"] = cs.device_ms(
                lambda: ss.selective_scan_bwd(*args, None, dy, carries=carries), reps=10)
        print(", ".join(f"{k} {v:.4f}" for k, v in out.items() if k.startswith(label)))
        del args
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
