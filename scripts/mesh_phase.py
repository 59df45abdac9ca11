#!/usr/bin/env python3
"""chip_smoke.py's (t13)-(t16), training over a mesh of the card, and (v),
serving over one, alone, from the checkout at ROOT (default: this one):

    python3 scripts/mesh_phase.py [ROOT]

It builds the kernels (``phase_device``), then runs ``phase_train_mesh``:
(t13) full-width qwen3-1.7b on a 2 x 2 mesh of cuda:0 against the
unsharded step over the same rows, (t13b) a 1 x 4 mesh bit for bit the
unsharded step, (t15) compressed_psum on four embedding gradients, (t14)
granite-moe-3b-a800m's dispatch under the split, (t16) the sharded
restore, (v) qwen3-1.7b and hymba-1.5b served over meshes of the card. It
prints what the phases print, then one JSON line of their numbers.
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
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(root), str(root / "src")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs

    smi = cs.phase_device()
    paths, numbers, (serve_paths, serve_numbers) = cs.phase_train_mesh(smi)
    print(json.dumps({"root": str(root), "card": smi, "launches": {**paths, "serve": serve_paths},
                      **numbers, "serve": serve_numbers}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
