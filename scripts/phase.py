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

- ``mesh4``: the mesh paths on four distinct cards of one host, one
  process driving them (raises below four cards; ~2 min after the build
  on four H100s joined by NVLink):
  (a) ``nvidia-smi topo -m``, peer access and a 1 GiB copy's GB/s for every
  ordered pair beside ``roofline.Hardware.nvlink_bw``; (b) full-width
  qwen3-1.7b over cards 0-3 against [cuda:0] x 4 in one process, bit for
  bit: (v)'s prefill and 16 decode steps on 2 x 2 (16 x 1024) and 1 x 4
  (2 x 4096), (vs)'s sparse decode on 2 x 2 without and with summaries,
  (t13)'s train step on 2 x 2 for 3 steps; (c) ContiguousKV served with
  every decode attend split over the cards: serve's CLI with --tp-decode 4
  against none, the same greedy tokens; then full-width Qwen2.5-7B through
  the Scheduler over ``make_serving_mesh(kv_split=4)`` at c = 1 and 4,
  held as chip_smoke.py's phase 5b holds k shards (first-token logits bit
  for bit, the first decode step within the dense limits, each sharded
  attend within 2^-7 / 1e-5 of the unsharded kernel), the pages it copies
  a step; (d) internvl2-76b at full width and depth (80 layers, 141 GB: no
  one card holds it) laid out by ``init_params(..., shardings=)`` on 1 x 4
  and 2 x 2: a warm prefill of 2 x 4096 patch embeddings, 16 decode steps,
  4 sparse steps without and 4 with summaries, each card's peak beside
  the prediction, flash launches by card, one layer's gather and row-sum
  beside the analyzer's wire bytes at nvlink_bw, the two meshes' tokens
  and logits; (e) the same model cut to 8 layers on 1 x 4 against the
  unsharded one-card step within twice the bfloat16 floor, and its
  float32 sparse picks against the unsharded float32 step's. Every time is
  taken to a synchronize of every card (``mesh.synchronize``), every peak
  is each card's (``mesh.peak_memory``).

Run parent, change, change, parent. It prints what the phases print, then
one JSON line: the root, the card, and each phase's numbers.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("t2", "t17", "host", "serve_mesh", "serve_mesh_sparse", "train_mesh_hymba", "mesh4")
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


# ---------------------------------------------------------------------------
# mesh4: the mesh paths on four distinct cards
MESH4_SERVE = ((2, 2, 16, 1024), (1, 4, 2, 4096))  # (b): (v) over cards 0-3
MESH4_SPARSE = (2, 2, 2, 4096)  # (b): (vs)
MESH4_PROMPT, MESH4_DECODE, MESH4_SPARSE_STEPS = (2, 4096), 16, 4  # (d), (e)
MESH4_CHUNK, MESH4_BUDGET = 16, 0.05
MESH4_GRIDS = ((1, 4), (2, 2))
MESH4_CUT = 8  # (e): internvl2-76b's layers held against the unsharded step
PEER_COPY_BYTES, PEER_COPY_REPS = 1 << 30, 5


def _sync_ms(mesh, fn):
    """(fn(), its ms from a synchronize of every card of ``mesh`` to the
    next)."""
    from repro_torch.launch.mesh import synchronize

    synchronize(mesh)
    t0 = time.perf_counter()
    out = fn()
    synchronize(mesh)
    return out, (time.perf_counter() - t0) * 1e3


def _mesh4_topology(devices, smi: str) -> dict:
    """(a) nvidia-smi's topology, peer access and a 1 GiB copy's rate for
    every ordered pair of distinct cards."""
    import torch

    from repro_torch.launch.roofline import Hardware

    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True)
    print(f"mesh4 (a): nvidia-smi topo -m\n{topo.stdout.rstrip()}")
    nvlink = Hardware().nvlink_bw
    cards = sorted({d.index for d in devices})
    pairs = {}
    for a in cards:
        for b in cards:
            if a == b:
                continue
            x = torch.ones(PEER_COPY_BYTES, dtype=torch.uint8, device=f"cuda:{a}")
            y = torch.empty(PEER_COPY_BYTES, dtype=torch.uint8, device=f"cuda:{b}")
            y.copy_(x)  # warm: peer access enabled, the copy engines started
            ms = []
            for _ in range(PEER_COPY_REPS):
                for d in (a, b):
                    torch.cuda.synchronize(d)
                t0 = time.perf_counter()
                y.copy_(x)
                for d in (a, b):
                    torch.cuda.synchronize(d)
                ms.append((time.perf_counter() - t0) * 1e3)
            med = statistics.median(ms)
            rate = PEER_COPY_BYTES / med / 1e6  # GB/s
            peer = torch.cuda.can_device_access_peer(a, b)
            pairs[f"{a}->{b}"] = dict(peer_access=peer, ms=med, ms_all=ms, gb_per_s=rate)
            print(f"mesh4 (a): cuda:{a} -> cuda:{b}: peer access {peer}, a 1 GiB copy "
                  f"{med:.3f} ms (median of {PEER_COPY_REPS}), {rate:.1f} GB/s against "
                  f"roofline.Hardware.nvlink_bw {nvlink / 1e9:.0f} GB/s a direction ({smi})")
            del x, y
    return dict(topo=topo.stdout, nvlink_bw=nvlink, pairs=pairs)


def _states_equal(a: dict, b: dict, dev0) -> list:
    """The names of the state leaves whose blocks differ between two runs
    laid out alike."""
    import torch

    from repro_torch.launch.sharding import ShardedTensor

    out = []
    for name, st in a.items():
        if not isinstance(st, ShardedTensor):
            continue
        if any(not torch.equal(st.block_at(p).to(dev0), b[name].block_at(p).to(dev0))
               for p in st.positions()):
            out.append(name)
    return out


def _mesh4_distinct_vs_repeated(devices, smi: str) -> dict:
    """(b) qwen3-1.7b at full width over cards 0-3 and over [cuda:0] x 4:
    (v)'s prefill and 16 decode steps on 2 x 2 and 1 x 4, (vs)'s sparse
    decode on 2 x 2 without and with summaries, (t13)'s train step on 2 x 2
    for 3 steps; each bit for bit between the two."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh, synchronize
    from repro_torch.launch.sharding import param_shardings, unshard
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    cfg = get_config(cs.TRAIN_NAME)
    dev0 = devices[0]
    layouts = (("cards 0-3", devices), ("[cuda:0] x 4", [dev0] * 4))
    out = {}

    def laid(mesh):
        return T.init_params(cfg, torch.Generator(device=dev0).manual_seed(0), dev0,
                             shardings=param_shardings(cfg, mesh, fsdp=True))

    for data, model, b, s in MESH4_SERVE:
        case = f"(v) {data} x {model}, {b} x {s}"
        tokens = cs._serve_tokens(cfg, b, s, 50 + b)
        runs, feed = [], None
        for label, devs in layouts:
            mesh = make_host_mesh(data, model, devices=devs)
            ps = laid(mesh)
            logits, state, fed, pre_ms, dec_ms = cs._serve_run(cfg, ps, tokens, feed, mesh)
            synchronize(mesh)
            feed = feed or fed
            runs.append((logits, state))
            print(f"mesh4 (b) {case} over {label}: prefill {pre_ms:.2f} ms, a decode step "
                  f"{statistics.median(dec_ms):.2f} ms (events on cuda:0's stream) ({smi})")
            del ps
            cs.free_weights()
        (far, far_st), (near, near_st) = runs
        same = [i for i, (g, w) in enumerate(zip(far, near)) if not torch.equal(g, w)]
        states = _states_equal(far_st, near_st, dev0)
        print(f"mesh4 (b) {case}: cards 0-3 against [cuda:0] x 4: logits of "
              f"{len(far) - len(same)} of {len(far)} calls bit for bit, state leaves differing "
              f"{states or 'none'}")
        if same or states:
            cs.fail(f"mesh4 (b) {case}: distinct cards differ from the card repeated (calls "
                    f"{same}, leaves {states})")
        out[case] = dict(bit_for_bit=True, calls=len(far))
        del runs, far, near, far_st, near_st
        cs.free_weights()

    data, model, b, s = MESH4_SPARSE
    tokens = cs._serve_tokens(cfg, b, s, 70 + b)
    for cached in (False, True):
        case = f"(vs) {data} x {model}, {b} x {s}" + (", cached summaries" if cached else "")
        runs, feed = [], None
        for label, devs in layouts:
            mesh = make_host_mesh(data, model, devices=devs)
            blocks = cs._seq_blocks(cfg, mesh, b)
            c = cs.SPARSE_MESH_CHUNK
            cap = -(-(s + cs.SPARSE_MESH_STEPS) // (blocks * c)) * blocks * c
            ps = laid(mesh)
            with cs._picks_recorded() as picks:
                logits, state, fed, ms = cs._sparse_run(cfg, ps, tokens, cap, cached, feed, mesh)
            synchronize(mesh)
            feed = feed or fed
            runs.append((logits, state, [p.to(dev0) for p in picks]))
            del ps
            cs.free_weights()
        (fl, fs, fp), (nl, ns, np_) = runs
        bad = ([i for i, (g, w) in enumerate(zip(fl, nl)) if not torch.equal(g, w)],
               _states_equal(fs, ns, dev0),
               sum(not torch.equal(g, w) for g, w in zip(fp, np_)))
        print(f"mesh4 (b) {case}: cards 0-3 against [cuda:0] x 4: logits differing in calls "
              f"{bad[0] or 'none'}, state leaves {bad[1] or 'none'}, picks differing in "
              f"{bad[2]} of {len(fp)} selections")
        if any(bad):
            cs.fail(f"mesh4 (b) {case}: distinct cards differ from the card repeated: {bad}")
        out[case] = dict(bit_for_bit=True, calls=len(fl), picks=len(fp))
        del runs, fl, nl, fs, ns
        cs.free_weights()

    case = f"(t13) 2 x 2, {cs.MESH_STEPS} steps"
    params = cs._init_weights("mesh4 (b) (t13)", cfg)
    batch = cs._train_batch(cfg, cs.MESH_BATCH, cs.TRAIN_SEQ, 29)
    runs = []
    for label, devs in layouts:
        mesh = make_host_mesh(2, 2, devices=devs)
        ps, opt, _ = cs._mesh_state(cfg, params, mesh)
        step = make_train_step(cfg, grad_accum=cs.MESH_ACCUM, remat=False, lr=cs.TRAIN_LR,
                               mesh=mesh)
        losses, ms = [], []
        for _ in range(cs.MESH_STEPS):
            (ps, opt, metrics), t = _sync_ms(mesh, lambda: step(ps, opt, batch))
            losses.append(metrics["loss"].to(dev0))
            ms.append(t)
        print(f"mesh4 (b) {case} over {label}: losses "
              f"{', '.join(f'{float(x):.6f}' for x in losses)}, step ms "
              f"{', '.join(f'{x:.1f}' for x in ms)} (synchronized on every card; {smi})")
        runs.append((losses, ps, opt, ms))
        del ps, opt
        cs.free_weights()
    (fl, fp, fo, fms), (nl, np_, no, nms) = runs
    differ = []
    for kind, got, want in (("params", fp, np_), ("m", fo["m"], no["m"]), ("v", fo["v"], no["v"])):
        for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
            if not torch.equal(unshard(g, dev0), unshard(w, dev0)):
                differ.append(f"{kind}[{i}]")
    lossy = [i for i, (a, b_) in enumerate(zip(fl, nl)) if not torch.equal(a, b_)]
    print(f"mesh4 (b) {case}: cards 0-3 against [cuda:0] x 4: losses differing at steps "
          f"{lossy or 'none'}, leaves differing {differ or 'none'}")
    if differ or lossy:
        cs.fail(f"mesh4 (b) {case}: distinct cards differ from the card repeated")
    out[case] = dict(bit_for_bit=True, step_ms=fms, repeated_step_ms=nms)
    del runs, params
    cs.free_weights()
    return out


def _mesh4_serve_tp(devices, smi: str) -> dict:
    """(c) ContiguousKV served over a serving mesh of the cards, every decode
    attend split over them: serve's CLI (2 layers) with --tp-decode K
    (4 on four cards) against none at c = 1 and 4, the same greedy tokens;
    then full-width Qwen2.5-7B through the Scheduler over
    RealCompute(tp_mesh=make_serving_mesh(kv_split=4)), 4 requests at c = 1
    and c = 4, held as chip_smoke.py's phase 5b holds its k shards: the
    first-token logits bit for bit the run without a mesh, the first decode
    step within the dense limits, each sharded attend against the unsharded
    kernel on the same inputs (out within 2^-7, mass within 1e-5 of its
    largest); the greedy tokens agreeing and the pages the attend copied
    a decode step printed."""
    import contextlib
    import io

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.backends import RealCompute
    from repro_torch.core.engine import ContiguousKVEngine
    from repro_torch.core.session import build_real_session
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import sharded_sparse as SS
    from repro_torch.launch.mesh import make_serving_mesh, synchronize
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, Scheduler, summarize
    from repro_torch.storage.timing import RealExecutor

    dev0 = devices[0]
    distinct = len({d for d in devices}) == len(devices)
    k = str(len(devices)) if distinct else "0"
    out = {}
    base = ["--arch", "qwen2.5-7b", "--n-layers", "2", "--requests", "4", "--decode-tokens", "3"]
    for c in (1, 4):
        tokens = {}
        for flag in ((), ("--tp-decode", k)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                done = serve_cli.main(base + ["--concurrency", str(c), *flag])
            tokens[flag] = [r.trace.decode_tokens_out for r in done]
            if flag and "tensor-parallel decode:" not in buf.getvalue():
                cs.fail(f"mesh4 (c) CLI: no mesh line:\n{buf.getvalue()}")
            mesh_line = [ln for ln in buf.getvalue().splitlines() if "tensor-parallel" in ln]
        same = tokens[()] == tokens[("--tp-decode", k)]
        print(f"mesh4 (c) serve CLI --tp-decode {k} c={c} (2 layers, 4 requests): greedy "
              f"tokens {'equal to' if same else 'DIFFERENT from'} the run without it; "
              f"{mesh_line[0] if mesh_line else ''}")
        if not same:
            cs.fail(f"mesh4 (c) CLI c={c}: --tp-decode {k} changed the greedy tokens")
        out[f"cli c={c}"] = dict(tokens_equal=True)

    cfg = get_config("qwen2.5-7b")
    params = T.init_params(cfg, torch.Generator(device=dev0).manual_seed(0), dev0)
    prefix = np.random.default_rng(0).integers(0, cfg.vocab_size, cs.PREFIX_LEN)
    sess = build_real_session(cfg, params, prefix, chunk_tokens=cs.CHUNK, in_memory=True,
                              device=dev0)
    rng = np.random.default_rng(7)
    suffixes = [rng.integers(0, cfg.vocab_size, cs.SUFFIX_LEN) for _ in range(4)]
    mesh = make_serving_mesh(kv_split=4, devices=devices)
    worst = {"out": 0.0, "mass": 0.0}

    def held(attend):
        def checked(q, kp, vp, table, lengths):
            o, m = attend(q, kp, vp, table, lengths)
            want_o, want_m = decode_attention(q, kp, vp, table, lengths)
            eo = (o.float() - want_o.float()).abs().max().item() / max(
                want_o.float().abs().max().item(), 1e-30)
            em = (m - want_m).abs().max().item() / max(want_m.abs().max().item(), 1e-30)
            worst["out"], worst["mass"] = max(worst["out"], eo), max(worst["mass"], em)
            return o, m
        return checked

    def run(c, tp):
        worst.update(out=0.0, mass=0.0)
        be = RealCompute(cfg, params, device=dev0, tp_mesh=mesh if tp else None)
        if tp:
            be._tp_attend = held(be._tp_attend)
        eng = ContiguousKVEngine(sess, be, RealExecutor(), budget=cs.BUDGET, period=cs.PERIOD,
                                 subperiod=cs.SUBPERIOD)
        taps = cs._tapped(eng)
        reqs = [Request(request_id=i, suffix=s, decode_tokens=cs.DECODE_TOKENS)
                for i, s in enumerate(suffixes)]
        sched = Scheduler(eng, policy="fcfs", max_concurrency=c, batch_decode=True)
        SS.page_copy_bytes = 0
        done = sched.run(reqs)
        synchronize(mesh)
        eng.ex.shutdown()
        sizes = [len(m) for m in sched.real_batch_log]
        execs = 4 * cs.DECODE_TOKENS - sum(sizes) + len(sizes)  # decode steps run
        return done, taps, summarize(done), SS.page_copy_bytes, execs

    for c in (1, 4):
        d0, t0_, s0, _, _ = run(c, False)
        d1, t1_, s1, copied, steps = run(c, True)
        first = all(np.array_equal(t0_[i]["first"], t1_[i]["first"]) for i in range(4))
        rel, cos = 0.0, 1.0
        for i in range(4):
            r, cs_ = cs.logit_agreement(t1_[i]["steps"][0][0, -1], t0_[i]["steps"][0][0, -1])
            rel, cos = max(rel, r), min(cos, cs_)
        agree = sum(x == y for a, b in zip(d0, d1)
                    for x, y in zip(a.trace.decode_tokens_out, b.trace.decode_tokens_out))
        per_step = copied / max(steps, 1)
        print(f"mesh4 (c) {cfg.name} c={c} over {dict(mesh.shape)} ({len(set(devices))} cards): "
              f"first-token logits {'bit-identical to' if first else 'DIFFERENT from'} the run "
              f"without a mesh; first decode step, worst request: max abs err / max |logit| "
              f"{rel:.4g} (tol {cs.DENSE_REL_TOL}), cosine {cos:.6f} (tol {cs.DENSE_MIN_COS}); "
              f"greedy tokens agreeing {agree} of {4 * cs.DECODE_TOKENS}; every sharded "
              f"attend against the unsharded kernel: out {worst['out']:.3g} (limit "
              f"{cs.FLASH_REL:g}), mass {worst['mass']:.3g} (limit 1e-05) of the largest; pages "
              f"copied {copied / 2**20:.1f} MiB over {steps} decode steps, "
              f"{per_step / 2**20:.2f} MiB a step; mean TPOT {s1['mean_tpot'] * 1e3:.3f} ms "
              f"(no mesh {s0['mean_tpot'] * 1e3:.3f}) ({smi})")
        if (not first or rel > cs.DENSE_REL_TOL or cos < cs.DENSE_MIN_COS
                or worst["out"] > cs.FLASH_REL or worst["mass"] > 1e-5):
            cs.fail(f"mesh4 (c) c={c}: the tensor-parallel decode disagrees with none")
        out[f"full width c={c}"] = dict(first_token_bit_for_bit=True, first_step_rel_err=rel,
                                        first_step_cosine=cos, tokens_agreeing=agree,
                                        tokens=4 * cs.DECODE_TOKENS, err_out=worst["out"],
                                        err_mass=worst["mass"], page_copy_bytes=copied,
                                        decode_steps=steps, page_copy_bytes_per_step=per_step,
                                        mean_tpot_ms=s1["mean_tpot"] * 1e3,
                                        no_mesh_mean_tpot_ms=s0["mean_tpot"] * 1e3)
    del params, sess
    cs.free_weights()
    return out


def _embeds_run(cfg, params, embeds, cap, steps, *, mesh=None, feed=None, sparse=None,
                dev0=None, warm=False):
    """Prefill ``embeds`` (b, s, d) into a cache of ``cap`` positions and run
    ``steps`` decode steps fed greedy tokens (or ``feed``), unsharded on
    ``dev0`` or over ``mesh`` (params laid out on it); then, where
    ``sparse`` is (chunk, budget), MESH4_SPARSE_STEPS sparse steps without
    and then with cached chunk summaries. ``warm``: the prefill runs twice,
    the second timed. Returns (logits of each call, the state, the tokens
    fed, {"prefill_ms", "step_ms", "sparse_ms"}) timed to a synchronize of
    every card."""
    import torch

    import chip_smoke as cs
    from repro_torch.launch.mesh import make_host_mesh, synchronize
    from repro_torch.launch.sharding import (NamedSharding, P, batch_specs,
                                             serve_state_shardings, shard)
    from repro_torch.launch.specs import decode_token_tree
    from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                          make_sparse_decode_step)
    from repro_torch.models import transformer as T

    b, s = embeds.shape[:2]
    sync = mesh if mesh is not None else make_host_mesh(1, 1, devices=[dev0])
    state = T.init_serve_state(cfg, b, cap, device=dev0)
    batch, put = {"embeds": embeds}, (lambda t: t)
    if mesh is not None:
        ssh = serve_state_shardings(cfg, mesh, b)
        state = {k: v if k == "length" else shard(v, ssh[k]) for k, v in state.items()}
        batch = {"embeds": shard(embeds, batch_specs(cfg, mesh, b, s, training=False)["embeds"])}
        # the decode inputs are token ids (b, 1): the embeddings' spec without its last dim
        tsh = decode_token_tree(cfg, mesh, b).sharding
        tsh = NamedSharding(mesh, P(*tuple(tsh.spec)[:2]))
        put = lambda t: shard(t, tsh)  # noqa: E731
    prefill, decode = make_prefill_step(cfg, mesh=mesh), make_decode_step(cfg, mesh=mesh)
    times = {}
    if warm:
        _sync_ms(sync, lambda: prefill(params, batch, state))
    (logits, state), times["prefill_ms"] = _sync_ms(sync, lambda: prefill(params, batch, state))
    outs, fed, times["step_ms"] = [logits], [], []
    for i in range(steps):
        tok = logits.argmax(-1).to(torch.int32) if feed is None else feed[i]
        fed.append(tok)
        x = put(tok)
        (logits, state), ms = _sync_ms(sync, lambda: decode(params, x, state))
        outs.append(logits)
        times["step_ms"].append(ms)
    if sparse is not None:
        times["sparse_ms"] = {}
        for cached in (False, True):
            if cached:
                state["kmean"] = cs._summaries(state["k"])
            step = make_sparse_decode_step(cfg, chunk_tokens=sparse[0], budget=sparse[1],
                                           cached_summaries=cached, mesh=mesh)
            ms_all = times["sparse_ms"]["cached" if cached else "kmeans"] = []
            for i in range(MESH4_SPARSE_STEPS):
                j = steps + i + (MESH4_SPARSE_STEPS if cached else 0)
                tok = logits.argmax(-1).to(torch.int32) if feed is None else feed[j]
                fed.append(tok)
                x = put(tok)
                (logits, state), ms = _sync_ms(sync, lambda: step(params, x, state))
                outs.append(logits)
                ms_all.append(ms)
    return outs, state, fed, times


@contextlib.contextmanager
def _flash_by_card():
    """{device: flash_attention launches} of the calls made while entered
    (``models.attention``'s name for the wrapper, wrapped)."""
    from repro_torch.models import attention

    seen, real = {}, attention.flash_attention

    def counted(q, *a, **kw):
        seen[str(q.device)] = seen.get(str(q.device), 0) + 1
        return real(q, *a, **kw)

    attention.flash_attention = counted
    try:
        yield seen
    finally:
        attention.flash_attention = real


def _joins(cfg, ps, mesh, b: int, s: int) -> dict:
    """One layer's weight gather for every tensor shard (``MeshServe._weights``,
    the all-gathers) and the row-parallel sum of (b, s, d_model) partials
    (``MeshServe._sum``), each timed to a synchronize of every card (median
    of 5) beside the step analyzer's collective wire bytes for it priced
    at ``Hardware.nvlink_bw``."""
    import torch

    from repro_torch.launch import roofline as RL
    from repro_torch.launch.tp_compute import MeshServe, _Part

    model = MeshServe(cfg, mesh)
    near = model.pos(0, 0)
    part = _Part(0, slice(0, b), mesh.devices[near], near, None, 0, False, 1.0)
    bw = RL.Hardware().nvlink_bw

    def gather():
        return [model._weights(ps, 0, sh, dev, pos, part)
                for _, sh, pos, dev in model._tensor_shards(part)]

    parts = [torch.randn((b, s, cfg.d_model), device=mesh.devices[model.pos(0, t)]).to(
        cfg.activation_dtype()) for t in range(model.n_tp)]
    out = {}
    for name, fn in (("gather", gather), ("row_sum", lambda: model._sum(parts, part.home))):
        fn()
        ms = statistics.median(_sync_ms(mesh, fn)[1] for _ in range(5))
        with RL.StepAnalyzer(sample_loops=False) as an:
            fn()
        wire = sum(an.metrics.coll_by_group.values())
        out[name] = dict(ms=ms, wire_bytes=wire, model_ms=wire / bw * 1e3)
    return out


def _mesh4_internvl(devices, smi: str, layers: int) -> dict:
    """(d) internvl2-76b at full width and ``layers`` of 80 on 1 x 4 and
    2 x 2 meshes of the cards: the laid-out init, a warm prefill of 2 x 4096
    patch embeddings, 16 greedy decode steps (2 x 2 fed 1 x 4's tokens),
    MESH4_SPARSE_STEPS sparse steps without and with summaries; every card's
    peak beside the prediction (its blocks, its cache, a gathered layer
    slice), flash launches by card, the joins' times beside the analyzer's,
    finite logits, the two meshes' tokens and logits' relative L2."""
    import dataclasses

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import (distinct_devices, make_host_mesh, peak_memory,
                                         reset_peak_memory, synchronize)
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.models import transformer as T
    from repro_torch.models.frontends import make_frontend_embeds
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("internvl2-76b"), n_layers=layers)
    dev0 = devices[0]
    b, s = MESH4_PROMPT
    embeds = make_frontend_embeds(cfg, b, s, torch.Generator(device=dev0).manual_seed(1), dev0)
    out, ref = {}, None
    for data, model in MESH4_GRIDS:
        grid = f"{data} x {model}"
        mesh = make_host_mesh(data, model, devices=devices)
        cards = distinct_devices(mesh)
        cs.free_weights()
        reset_peak_memory(mesh)
        ps, init_ms = _sync_ms(mesh, lambda: T.init_params(
            cfg, torch.Generator(device=dev0).manual_seed(0), dev0,
            shardings=param_shardings(cfg, mesh, fsdp=True)))
        init_peak = peak_memory(mesh)
        weights = dict.fromkeys(map(str, cards), 0)
        for st in tree_leaves(ps):
            for pos in st.positions():
                blk = st.block_at(pos)
                weights[str(blk.device)] += blk.numel() * blk.element_size()
        c = MESH4_CHUNK
        blocks = cs._seq_blocks(cfg, mesh, b)
        cap = -(-(s + MESH4_DECODE + 2 * MESH4_SPARSE_STEPS) // (blocks * c)) * blocks * c
        cache = 2 * cfg.n_layers * b * cap * cfg.n_kv_heads * cfg.d_head * 2 / len(cards)
        layer = sum(math.prod(x.shape[1:]) * x.dtype.itemsize
                    for x in tree_leaves(ps["layers"])) / model  # a tensor shard's slice
        reset_peak_memory(mesh)
        with _flash_by_card() as flash:
            logits, state, fed, times = _embeds_run(
                cfg, ps, embeds, cap, MESH4_DECODE, mesh=mesh, dev0=dev0, warm=True,
                feed=None if ref is None else ref[1], sparse=(c, MESH4_BUDGET))
        peak = peak_memory(mesh)
        joins = {"prefill": _joins(cfg, ps, mesh, b, s), "decode": _joins(cfg, ps, mesh, b, 1)}
        finite = all(bool(torch.isfinite(x).all()) for x in logits)
        greedy = [x.argmax(-1).to(torch.int32) for x in logits[:-1]]
        step = statistics.median(times["step_ms"][1:])
        row = dict(init_ms=init_ms, init_peak_bytes=init_peak, peak_bytes=peak,
                   weight_bytes=weights, cache_bytes=cache,
                   layer_slice_bytes=layer, flash_by_card=dict(flash),
                   prefill_ms=times["prefill_ms"], step_ms=step, step_ms_all=times["step_ms"],
                   sparse_ms=times["sparse_ms"], joins=joins, finite=finite, capacity=cap)
        print(f"mesh4 (d) {cfg.name} ({cfg.n_layers} layers) on {grid} over "
              f"{len(cards)} cards: laid-out init {init_ms / 1e3:.1f} s; warm prefill of "
              f"{b} x {s} embeddings {times['prefill_ms']:.1f} ms, a decode step {step:.1f} ms "
              f"(median of steps 2-{MESH4_DECODE}), sparse steps "
              f"{_fmt_ms(times['sparse_ms']['kmeans'])} / with summaries "
              f"{_fmt_ms(times['sparse_ms']['cached'])} ms, all synchronized on every card; "
              f"flash launches by card {dict(flash)}; logits finite: {finite} ({smi})")
        for d in map(str, cards):
            predicted = weights[d] + cache + layer * (data > 1)
            print(f"mesh4 (d) {grid} {d}: peak {peak[d] / 1e9:.2f} GB in the steps, "
                  f"{init_peak[d] / 1e9:.2f} GB in the init; predicted {predicted / 1e9:.2f} GB "
                  f"(its blocks {weights[d] / 1e9:.2f}, its cache {cache / 1e9:.2f}, "
                  + (f"a gathered layer slice {layer / 1e9:.2f}" if data > 1 else
                     "no gather: its slices are its blocks") + ") plus activations")
        for kind, j in joins.items():
            print(f"mesh4 (d) {grid} {kind}: one layer's weight gather {j['gather']['ms']:.3f} "
                  f"ms ({j['gather']['wire_bytes'] / 1e9:.3f} GB on the wire by the analyzer, "
                  f"{j['gather']['model_ms']:.3f} ms at nvlink_bw), a row-sum "
                  f"{j['row_sum']['ms']:.3f} ms ({j['row_sum']['wire_bytes'] / 1e9:.4f} GB, "
                  f"{j['row_sum']['model_ms']:.3f} ms)")
        if not finite:
            cs.fail(f"mesh4 (d) {grid}: logits not finite")
        if max(peak.values()) > 80e9 or max(init_peak.values()) > 80e9:
            cs.fail(f"mesh4 (d) {grid}: a card's peak passed 80 GB")
        if ref is None:
            ref = (logits, fed)
        else:
            rel = max(cs._rel_l2(a.to(dev0), b_.to(dev0)) for a, b_ in zip(logits, ref[0]))
            same = sum(int((g == r).all()) for g, r in zip(greedy, ref[1]))
            row.update(rel_l2_to_1x4=rel, greedy_equal=same, greedy_calls=len(greedy))
            print(f"mesh4 (d) {grid} fed 1 x 4's tokens: its own greedy pick equals 1 x 4's in "
                  f"{same} of {len(greedy)} calls; logits relative L2 to 1 x 4's {rel:.3g} "
                  f"(largest over the prefill and {len(greedy) - 1} steps)")
        out[grid] = row
        del ps, state, logits
        synchronize(mesh)
        cs.free_weights()
    return out


def _fmt_ms(xs) -> str:
    return ", ".join(f"{x:.1f}" for x in xs)


def _mesh4_internvl_cut(devices, smi: str, layers: int = MESH4_CUT) -> dict:
    """(e) internvl2-76b at full width cut to ``layers``: the 1 x 4 mesh of
    the cards teacher-forced on the unsharded one-card step's greedy tokens,
    held by chip_smoke's ``_serve_mesh_hold`` within twice the bfloat16 floor
    (the unsharded step's relative L2 from a float32 run on the same
    tokens) in logits and cache; then float32 sparse steps (chunks of 16,
    budget 0.05, without and with summaries) on the mesh and unsharded,
    teacher-forced alike, their picks compared as (vs) does."""
    import dataclasses

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import param_shardings, shard_tree
    from repro_torch.models import transformer as T
    from repro_torch.models.frontends import make_frontend_embeds
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("internvl2-76b"), n_layers=layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    dev0 = devices[0]
    b, s = MESH4_PROMPT
    mesh = make_host_mesh(1, 4, devices=devices)
    c = MESH4_CHUNK
    blocks = cs._seq_blocks(cfg, mesh, b)
    cap = -(-(s + MESH4_DECODE + 2 * MESH4_SPARSE_STEPS) // (blocks * c)) * blocks * c
    embeds = make_frontend_embeds(cfg, b, s, torch.Generator(device=dev0).manual_seed(1), dev0)
    params = T.init_params(cfg, torch.Generator(device=dev0).manual_seed(0), dev0)
    want, want_state, feed, _ = _embeds_run(cfg, params, embeds, cap, MESH4_DECODE, dev0=dev0)
    want_state = {k: v for k, v in want_state.items() if k != "length"}
    params32 = tree_map(lambda x: x.float(), params)
    f_logits, f_state, _, _ = _embeds_run(cfg32, params32, embeds, cap, MESH4_DECODE,
                                          dev0=dev0, feed=feed)
    floor = {"logits": max(cs._rel_l2(a, b_) for a, b_ in zip(want, f_logits))}
    floor.update({k: cs._rel_l2(want_state[k], f_state[k]) for k in want_state})
    del f_logits, f_state
    cs.free_weights()
    sparse_feed = (feed * 2)[:2 * MESH4_SPARSE_STEPS]
    with cs._picks_recorded() as f_picks:
        _embeds_run(cfg32, params32, embeds, cap, 0, dev0=dev0, feed=sparse_feed,
                    sparse=(c, MESH4_BUDGET))
    ps32 = shard_tree(params32, param_shardings(cfg32, mesh, fsdp=True))
    del params32
    cs.free_weights()
    with cs._picks_recorded() as m_picks:
        _embeds_run(cfg32, ps32, embeds, cap, 0, mesh=mesh, dev0=dev0,
                    feed=sparse_feed, sparse=(c, MESH4_BUDGET))
    del ps32
    cs.free_weights()
    same = sum(int(torch.equal(g.to(dev0).sort(dim=1).values, w.sort(dim=1).values))
               for g, w in zip(m_picks, f_picks))
    share = same / max(len(f_picks), 1)
    ps = shard_tree(params, param_shardings(cfg, mesh, fsdp=True))
    del params
    cs.free_weights()
    got, got_state, _, times = _embeds_run(cfg, ps, embeds, cap, MESH4_DECODE, mesh=mesh,
                                           dev0=dev0, feed=feed)
    got_state = {k: v for k, v in got_state.items() if k != "length"}
    hold = cs._serve_mesh_hold(f"mesh4 (e) {cfg.name} cut to {layers} layers, 1 x 4 over "
                               f"{len(set(devices))} cards", got, want, got_state, want_state,
                               floor, exact=False, steps=MESH4_DECODE)
    print(f"mesh4 (e) float32 sparse picks (chunks of {c}, budget {MESH4_BUDGET}, "
          f"{2 * MESH4_SPARSE_STEPS} steps x {layers} layers, without then with summaries) "
          f"equal the unsharded float32 step's in {same} of {len(f_picks)} (step, layer) "
          f"selections ({share:.4f}; limit {cs.SPARSE_MESH_F32_PICKS}) ({smi})")
    if len(m_picks) != len(f_picks) or share < cs.SPARSE_MESH_F32_PICKS:
        cs.fail("mesh4 (e): the float32 mesh picks other chunks than the unsharded step")
    del ps, got, got_state, want, want_state
    cs.free_weights()
    return dict(hold=hold, picks_equal=same, picks=len(f_picks), picks_share=share,
                prefill_ms=times["prefill_ms"], step_ms=statistics.median(times["step_ms"]))


def phase_mesh4(smi: str, devices=None, layers: int = 80, cut: int = MESH4_CUT) -> dict:
    """The mesh paths on four distinct cards: (a)-(e) of the module
    docstring. ``devices`` (default every card, four at least) and
    ``layers`` / ``cut`` let a one-card rehearsal run the same code on
    [cuda:0] x 4 at fewer layers."""
    import torch

    if devices is None:
        n = torch.cuda.device_count()
        if n < 4:
            raise RuntimeError(f"mesh4 needs four CUDA cards, {n} present")
        devices = [torch.device("cuda", i) for i in range(4)]
    t0 = time.perf_counter()
    got = {"topology": _mesh4_topology(devices, smi)}
    got["distinct_vs_repeated"] = _mesh4_distinct_vs_repeated(devices, smi)
    got["serve_tp"] = _mesh4_serve_tp(devices, smi)
    got["internvl"] = _mesh4_internvl(devices, smi, layers)
    got["internvl_cut"] = _mesh4_internvl_cut(devices, smi, cut)
    got["seconds"] = time.perf_counter() - t0
    print(f"mesh4: took {got['seconds']:.1f} s")
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
                     "train_mesh_hymba": phase_train_mesh_hymba,
                     "mesh4": phase_mesh4}[name](smi)
    print(json.dumps(got))
    return 0


if __name__ == "__main__":
    sys.exit(main())
