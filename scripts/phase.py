#!/usr/bin/env python3
"""Phases of chip_smoke.py, or timings beside them, alone, from the checkout
at ROOT (default: this one), so that a parent and a change can be compared
in one chip call:

    python3 scripts/phase.py [--root ROOT] PHASE...

PHASE is one of:

- ``t17``: builds the kernels (``phase_device``), trains full-width
  qwen3-1.7b as (t2) does (``phase_train_step``), then runs
  ``phase_train_roofline``: the step counted by ``launch/roofline.py``'s
  StepAnalyzer live on the card and on meta tensors (the two counts must
  be equal), the predicted bytes against ``max_memory_allocated``, the
  roofline against the warm step, and the dry run's CLI on qwen3-1.7b's
  train_4k cell. ROOT's chip_smoke.py must have (t17).
- ``host``: the host time of one wrapper call, without a synchronize
  (argument checks, the recorder lookup, the launch), for flash_attention
  forward (with its logsumexp) and backward at (t2)'s microbatch
  (qwen3-1.7b, 1 x 4096 tokens, 16 / 8 heads, d 128, bfloat16), the scan
  forward (with carries) and backward at hymba-1.5b's (1 x 4096, d_inner
  3200, n 16, bfloat16) and decode_attention's stacked form at a
  qwen2.5-7b decode step (28 / 4 heads, 4100 tokens in pages of 16,
  bfloat16): the median over ROUNDS rounds of CALLS calls each; and,
  where ROOT has ``kernels/work.py``, the host time of its recorder lookup
  with no recorder entered (``work.active()``, what such a checkout's
  wrappers add a call), the median of ROUNDS rounds of LOOKUPS calls. Only
  the wrappers come from ROOT; the timing is this file's.

- ``serve_mesh``: builds the kernels, then chip_smoke.py's (v) on
  full-width qwen3-1.7b from a seeded init (its meshes of the card at their
  batches) with one more case, a 1 x 16 mesh at batch 2 x 4096: its 8 kv
  heads do not divide 16, so the cache's sequence splits over the tensor
  axis, as on the production mesh; then hymba-1.5b on 1 x 2. ROOT's
  chip_smoke.py must have (v).

- ``serve_mesh_sparse``: builds the kernels, then chip_smoke.py's (v) on
  full-width qwen3-1.7b from a seeded init over (vs)'s meshes and batches
  alone (the dense mesh decode steps whose times (vs) prints beside its
  own), then (vs): ContiguousKV's sparse decode over those meshes, without
  and with cached chunk summaries. ROOT's chip_smoke.py must have (vs).

- ``t2``: builds the kernels, trains full-width qwen3-1.7b as (t2) does
  (``phase_train_step``: its step ms, warm step the median of steps 1-4),
  then times ROOT's ``optimizer.clip_scale`` by events on float32 copies
  of the trained params (the shapes and dtype of the step's gradients at
  grad_accum 2): the global-norm clip every unsharded train step computes.

- ``train_mesh_hymba``: builds the kernels, then full-width hymba-1.5b
  trained one step on a 1 x 2 mesh of the card (``phase_train_mesh_hybrid``):
  its 25 heads 13 / 12 a tensor shard and its 3200 mamba channels 1600 a
  shard through flash_attention and selective_scan forward and backward,
  held within twice the unsharded step's distance from float32. ROOT's
  chip_smoke.py must have it.

Run parent, change, change, parent. It prints what the phases print, then
one JSON line: the root, the card, and each phase's numbers.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("t2", "t17", "host", "serve_mesh", "serve_mesh_sparse", "train_mesh_hymba")
SERVE_MESH_EXTRA = ((1, 16, 2, 4096),)
CALLS, ROUNDS, LOOKUPS = 100, 9, 100_000


def phase_t17(smi: str) -> dict:
    import chip_smoke as cs
    from repro_torch.configs import get_config

    cfg = get_config(cs.TRAIN_NAME)
    params, _, step = cs.phase_train_step(cfg, smi)
    paths, numbers = cs.phase_train_roofline(cfg, params, step["warm_step_ms"], smi)
    return {"launches": paths, **numbers}


def phase_t2(smi: str) -> dict:
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import clip_scale
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(cs.TRAIN_NAME)
    params, paths, numbers = cs.phase_train_step(cfg, smi)
    grads = tree_map(lambda p: p.float(), params)  # grad_accum 2: float32 gradients
    del params
    clip_ms = cs.device_ms(lambda: clip_scale(grads), reps=9)
    n = sum(g.numel() for g in tree_leaves(grads))
    print(f"t2: clip_scale on {cfg.name}'s {n:,} float32 gradient elements: {clip_ms:.3f} ms by "
          f"events, against (t2)'s warm step {numbers['warm_step_ms']:.1f} ms ({smi})")
    del grads
    return {"launches": paths, "clip_scale_ms": clip_ms, **numbers}


def phase_serve_mesh(smi: str) -> dict:
    import chip_smoke as cs
    from repro_torch.configs import get_config

    cfg = get_config(cs.TRAIN_NAME)
    params = cs._init_weights("serve (v)", cfg)
    paths, numbers = cs.phase_serve_mesh_models(cfg, params, smi, SERVE_MESH_EXTRA)
    return {"launches": paths, **numbers}


def phase_serve_mesh_sparse(smi: str) -> dict:
    import chip_smoke as cs
    from repro_torch.configs import get_config

    cfg = get_config(cs.TRAIN_NAME)
    params = cs._init_weights("serve (vs)", cfg)
    _, dense = cs.phase_serve_mesh(cfg, params, smi, cs.SPARSE_MESH_CASES)
    launched, numbers = cs.phase_serve_mesh_sparse(cfg, params, smi, dense)
    return {"launches": launched, "dense": dense, **numbers}


def phase_train_mesh_hymba(smi: str) -> dict:
    import chip_smoke as cs

    paths, numbers = cs.phase_train_mesh_hybrid(smi)
    return {"launches": paths, **numbers}


def _host_ms(fn) -> list:
    """Host ms of one call of ``fn``, median over ROUNDS rounds of CALLS
    calls, and every round's figure."""
    import torch

    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        rounds.append((time.perf_counter() - t0) / CALLS * 1e3)
        torch.cuda.synchronize()
    return [statistics.median(rounds), rounds]


def phase_host(smi: str) -> dict:
    import torch

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.selective_scan import ops as ss

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, dtype=bf):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    q, k, v, do = (rn(1, 4096, n, 128).transpose(1, 2) for n in (16, 8, 8, 16))
    lse = fa.lse_buffer(q)
    out = fa.flash_attention(q, k, v, lse=lse)
    x, dt = rn(1, 4096, 3200), torch.nn.functional.softplus(rn(1, 4096))
    A = -torch.exp(rn(3200, 16, dtype=torch.float32))
    Bm, Cm, dy = rn(1, 4096, 16), rn(1, 4096, 16), rn(1, 4096, 3200, dtype=torch.float32)
    carries = ss.carries_buffer(x, 16)
    qd = rn(1, 28, 128)
    kp, vp = rn(1, 257, 16, 4, 128), rn(1, 257, 16, 4, 128)
    table = torch.arange(257, dtype=torch.int32, device="cuda")[None]
    lens = torch.tensor([4100], dtype=torch.int32, device="cuda")
    calls = {
        "flash_attention": lambda: fa.flash_attention(q, k, v, lse=lse),
        "flash_attention_bwd": lambda: fa.flash_attention_bwd(q, k, v, out, do, lse=lse),
        "selective_scan": lambda: ss.selective_scan(x, dt, A, Bm, Cm, carries=carries),
        "selective_scan_bwd": lambda: ss.selective_scan_bwd(x, dt, A, Bm, Cm, None, dy,
                                                            carries=carries),
        "decode_attention": lambda: da.decode_attention(qd, kp, vp, table, lens),
    }
    got = {}
    for name, fn in calls.items():
        got[name] = _host_ms(fn)
        print(f"host: {name} {got[name][0]:.5f} ms a call (median of {ROUNDS} rounds of "
              f"{CALLS}; rounds {', '.join(f'{r:.5f}' for r in got[name][1])}) ({smi})")
    try:
        from repro_torch.kernels.work import active
    except ImportError:  # a checkout from before the recorder
        return got
    rounds = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(LOOKUPS):
            active()
        rounds.append((time.perf_counter() - t0) / LOOKUPS * 1e9)
    got["recorder_lookup_ns"] = [statistics.median(rounds), rounds]
    print(f"host: work.active() with no recorder entered {got['recorder_lookup_ns'][0]:.1f} ns "
          f"a call (median of {ROUNDS} rounds of {LOOKUPS}) ({smi})")
    return got


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("phases", nargs="+", choices=PHASES)
    args = ap.parse_args()
    root = args.root.resolve()
    if not torch.cuda.is_available():
        print("phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(root), str(root / "src")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs

    smi = cs.phase_device()
    got = {"root": str(root), "card": smi}
    for name in args.phases:
        got[name] = {"t2": phase_t2, "t17": phase_t17, "host": phase_host,
                     "serve_mesh": phase_serve_mesh,
                     "serve_mesh_sparse": phase_serve_mesh_sparse,
                     "train_mesh_hymba": phase_train_mesh_hymba}[name](smi)
    print(json.dumps(got))
    return 0


if __name__ == "__main__":
    sys.exit(main())
