#!/usr/bin/env python3
"""Drive the PyTorch port of ContiguousKV on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code:

  1. device   — the card's name and power limit (nvidia-smi), then the build
                of the CUDA kernels from csrc/ with nvcc, timed;
  2. kernels  — chunk_score, chunk_attention and decode_attention at the
                main path's shapes on full-width Qwen2.5-7B, each held
                against its plain PyTorch version on the same card inputs
                (tolerances stated below), timed beside its plain version
                and the least time the card could take (bound);
  3. e2e      — ContiguousKV Re-Prefill then decode on full-width
                Qwen2.5-7B (28 layers, random bfloat16 weights from a seeded
                generator on the card): ingest a 4096-token prefix, serve 4
                requests of a 64-token suffix with 16 decode tokens each at
                budget 0.25, period 8, subperiod 4, c=16; assert read
                amplification 1.0 and each kernel's launch count per
                request; print where each request's time goes and profile
                one more request (device busy time, idle share, top device
                ops); hold a budget-1.0 run's first-token logits against the
                dense forward over prefix + suffix;
  4. a ``{"kernels": [...]}`` JSON line with each kernel's launches on the
     main path, its error against its plain version, and its times;
  5. last line: ``{"ok": true, "device": {...}}``.

It needs one card and exits non-zero, printing no result, without one or
outside a checkout (it builds and imports ``src/repro_torch``).
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

# H100 SXM data-sheet peaks (dense). ``bound_ms`` takes the products at the
# bfloat16/float16 tensor-core rate. The kernels run them in float32 on the
# CUDA cores instead: the engine's queries and suffix KV are float32 from
# layer 0's part B on, and each kernel is held to 1e-5 of its float32 plain
# version, which bfloat16 operands (8-bit mantissa) would miss. So the line
# also gives the bound at the float32 CUDA-core rate.
HBM_BYTES_PER_S = 3.35e12
TENSOR_CORE_OPS_PER_S = 989e12
CUDA_CORE_FP32_OPS_PER_S = 67e12

# full-width main path (serve.py's default prefix length)
PREFIX_LEN, SUFFIX_LEN, DECODE_TOKENS, N_REQUESTS = 4096, 64, 16, 4
BUDGET, PERIOD, SUBPERIOD, CHUNK = 0.25, 8, 4, 16
# budget-1.0 first-token logits against the dense forward: the engine keeps
# a float32 hidden state from layer 0's part B on and reads float16 store
# KV, while the dense forward runs all 28 layers in bfloat16, so the two
# differ by bfloat16 rounding compounded over 28 layers where the reduced
# test (4 layers) allows 3e-2. An H100 run measured 0.016 of the largest
# logit and cosine 0.99986; the limits leave about 3x room
DENSE_REL_TOL, DENSE_MIN_COS = 0.05, 0.999


def fail(msg: str):
    raise RuntimeError(msg)


def device_ms(fn, reps: int = 30) -> float:
    """Median device time of one call of ``fn``: every call is bracketed by
    CUDA events and all calls sit queued behind a sleep kernel, so the host's
    enqueue time never shows as device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(200_000_000)  # ~0.1 s: the host enqueues every call meanwhile
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))


def wall_ms(fn, reps: int = 10) -> float:
    """Median host time of one call of ``fn`` up to a synchronize (the plain
    versions are many small launches, some with host round trips)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bounds(nbytes: float, ops: float):
    """{"tensor_core" | "cuda_core": (least ms, "bytes" | "operations")} on the
    H100 at its data-sheet peaks: the products at either rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    out = {}
    for name, rate in (("tensor_core", TENSOR_CORE_OPS_PER_S),
                       ("cuda_core", CUDA_CORE_FP32_OPS_PER_S)):
        t_ops = ops / rate * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dname(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    from repro_torch.kernels import build as B

    t0 = time.perf_counter()
    lib = B.build()
    B.library()
    print(f"device: build of {lib.name} took {time.perf_counter() - t0:.2f} s")


def phase_kernels(cfg):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from repro_torch.kernels.chunk_attention.ops import chunk_attention
    from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
    from repro_torch.kernels.chunk_score.ops import chunk_score
    from repro_torch.kernels.chunk_score.ref import chunk_score_ref
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    s, nq, nkv, d = SUFFIX_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    m = -(-PREFIX_LEN // CHUNK)
    n_sel = math.ceil(BUDGET * m)
    rows = {}

    # chunk_score: float32 q as at every identify past layer 0; also the
    # bfloat16 q of layer 0 and a ragged prefix (4100 tokens)
    for qdt, n in ((torch.float32, PREFIX_LEN), (torch.bfloat16, PREFIX_LEN),
                   (torch.float32, PREFIX_LEN + 4)):
        q, kk = rn(s, nq, d, dtype=qdt), rn(n, nkv, d, dtype=torch.float16)
        got, ref = chunk_score(q, kk, CHUNK), chunk_score_ref(q, kk, CHUNK)
        err, tol = max_err(got, ref), 1e-5 * ref.abs().max().item() + 1e-6
        if not err <= tol:
            fail(f"chunk_score {dname(q)} n={n}: max abs err {err} > {tol}")
        if not torch.equal(got, chunk_score(q, kk, CHUNK)):
            fail("chunk_score is not reproducible bit for bit")
        print(f"kernels: chunk_score q {dname(q)} n={n}: max abs err {err:.3g} "
              f"(tol {tol:.3g}), two runs bit-identical")
        if qdt == torch.float32 and n == PREFIX_LEN:
            rows["chunk_score"] = dict(
                err=err, ms=device_ms(lambda: chunk_score(q, kk, CHUNK)),
                plain_ms=wall_ms(lambda: chunk_score_ref(q, kk, CHUNK)),
                bound=bounds(nbytes(q, kk) + 4 * m, 2.0 * s * nq * n * d))

    # chunk_attention: float32 q/suffix KV (layers past 0) and bfloat16 (layer 0)
    ks, vs = (rn(n_sel, CHUNK, nkv, d, dtype=torch.float16) for _ in range(2))
    for qdt, n_valid in ((torch.float32, n_sel), (torch.bfloat16, n_sel),
                         (torch.float32, n_sel - 7)):
        q, kf, vf = rn(s, nq, d, dtype=qdt), rn(s, nkv, d, dtype=qdt), rn(s, nkv, d, dtype=qdt)
        (o, ms), (o2, ms2) = (chunk_attention(q, ks, vs, n_valid, kf, vf),
                              chunk_attention_ref(q, ks, vs, n_valid, kf, vf))
        err = max(max_err(o, o2), max_err(ms, ms2))
        tol = 1e-5 * max(o2.abs().max().item(), ms2.abs().max().item()) + 1e-6
        if not err <= tol or o.dtype != torch.float32:
            fail(f"chunk_attention {dname(q)} n_valid={n_valid}: err {err} > {tol}")
        print(f"kernels: chunk_attention q {dname(q)} chunks {n_valid}/{n_sel}: "
              f"max abs err {err:.3g} (tol {tol:.3g}) on out and A_j")
        if qdt == torch.float32 and n_valid == n_sel:
            pairs = s * n_valid * CHUNK + s * (s + 1) // 2
            rows["chunk_attention"] = dict(
                err=err, ms=device_ms(lambda: chunk_attention(q, ks, vs, n_valid, kf, vf)),
                plain_ms=wall_ms(lambda: chunk_attention_ref(q, ks, vs, n_valid, kf, vf)),
                bound=bounds(nbytes(q, kf, vf, o, ms) + nbytes(ks, vs) * n_valid // n_sel,
                             4.0 * nq * d * pairs))

    # decode_attention: bfloat16 as decode runs; the last step's pool of
    # 64 resident pages + 5 tail pages, a partial last page, one pad slot
    n_res, n_tail = n_sel, -(-(s + DECODE_TOKENS) // CHUNK)
    n_pages = n_res + n_tail
    q = rn(1, nq, d, dtype=torch.bfloat16)
    kp, vp = (rn(1, n_pages, CHUNK, nkv, d, dtype=torch.bfloat16) for _ in range(2))
    tight = torch.arange(n_pages - 1, dtype=torch.int32, device=dev)[None]
    wide = torch.cat([tight, torch.full((1, 1), -1, dtype=torch.int32, device=dev)], 1)
    lens = torch.tensor([(n_pages - 2) * CHUNK + 5], dtype=torch.int32, device=dev)
    (o, pm), (o2, pm2) = decode_attention(q, kp, vp, wide, lens), decode_attention_ref(
        q, kp, vp, wide, lens)
    o_t, pm_t = decode_attention(q, kp, vp, tight, lens)
    if not (torch.equal(o, o_t) and torch.equal(pm[..., :-1], pm_t)
            and pm[..., -1].abs().max().item() == 0.0):
        fail("decode_attention: a pad slot changed the real pages' results")
    # bfloat16 output: both round one float32 result, so one bfloat16 ulp
    err_o, tol_o = max_err(o, o2), 2.0 ** -7 * o2.float().abs().max().item()
    err_m, tol_m = max_err(pm, pm2), 1e-5 * pm2.abs().max().item() + 1e-7
    if not (err_o <= tol_o and err_m <= tol_m):
        fail(f"decode_attention: err out {err_o} > {tol_o} or mass {err_m} > {tol_m}")
    print(f"kernels: decode_attention bfloat16 {n_pages - 1} pages + 1 pad slot: max abs "
          f"err out {err_o:.3g} (tol {tol_o:.3g}), mass {err_m:.3g} (tol {tol_m:.3g}); "
          f"pad slot bit-identical")
    L = int(lens.item())
    rows["decode_attention"] = dict(
        err=max(err_o, err_m), ms=device_ms(lambda: decode_attention(q, kp, vp, wide, lens)),
        plain_ms=wall_ms(lambda: decode_attention_ref(q, kp, vp, wide, lens)),
        bound=bounds(nbytes(q, o, pm, wide, lens) + 2 * L * nkv * d * kp.element_size(),
                     4.0 * nq * d * L))
    for name, r in rows.items():
        tc, cc = r["bound"]["tensor_core"], r["bound"]["cuda_core"]
        print(f"kernels: {name}: {r['ms']:.4f} ms on the card (plain version "
              f"{r['plain_ms']:.4f} ms, bound {tc[0]:.5f} ms by {tc[1]} at the tensor-core "
              f"rate, {cc[0]:.5f} ms by {cc[1]} at the float32 CUDA-core rate, "
              f"library call: none returns the per-chunk/page mass)")
    return rows


def phase_e2e(cfg):
    import numpy as np
    import torch

    from repro_torch.core.backends import RealCompute
    from repro_torch.core.engine import ContiguousKVEngine
    from repro_torch.core.session import build_real_session
    from repro_torch.kernels.chunk_attention import ops as ca
    from repro_torch.kernels.chunk_score import ops as cs
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.models import transformer as T
    from repro_torch.storage.timing import RealExecutor

    ops = {"chunk_score": cs, "chunk_attention": ca, "decode_attention": da}
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["unembed"],
                                       *params["layers"].values()])
    print(f"e2e: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads d_ff {cfg.d_ff} vocab {cfg.vocab_size}: "
          f"{n_params / 1e9:.2f} B random {cfg.dtype} weights in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN)
    t0 = time.perf_counter()
    sess = build_real_session(cfg, params, prefix, chunk_tokens=CHUNK, in_memory=True,
                              device=DEVICE)
    print(f"e2e: ingest of {PREFIX_LEN} tokens took {time.perf_counter() - t0:.2f} s")

    ex = RealExecutor()
    eng = ContiguousKVEngine(sess, RealCompute(cfg, params, device=DEVICE), ex, budget=BUDGET,
                             period=PERIOD, subperiod=SUBPERIOD)
    n_periods = -(-cfg.n_layers // PERIOD)
    expect = {"chunk_score": n_periods, "chunk_attention": cfg.n_layers,
              "decode_attention": cfg.n_layers * DECODE_TOKENS}
    suffixes = [rng.integers(0, cfg.vocab_size, SUFFIX_LEN) for _ in range(N_REQUESTS)]
    walls = []  # request wall time: first token, then the decode tokens
    for mod in ops.values():
        mod.launches = 0
    for i, suffix in enumerate(suffixes):
        before = {k: mod.launches for k, mod in ops.items()}
        busy = dict(ex.stage_times)
        t0 = time.perf_counter()
        logits, trace = eng.reprefill(suffix, request_id=i, decode_tokens=DECODE_TOKENS)
        walls.append((time.perf_counter() - t0) * 1e3)
        got = {k: mod.launches - before[k] for k, mod in ops.items()}
        if got != expect:
            fail(f"request {i}: kernel launches {got}, expected {expect}")
        if trace.read_amplification != 1.0:
            fail(f"request {i}: read amplification {trace.read_amplification}")
        toks = trace.decode_tokens_out
        if (logits.shape != (1, 1, cfg.vocab_size) or not np.isfinite(logits).all()
                or len(toks) != DECODE_TOKENS or not all(0 <= t < cfg.vocab_size for t in toks)):
            fail(f"request {i}: bad output {logits.shape} {toks}")
        print(f"e2e: request {i}: TTFT {trace.ttft * 1e3:.2f} ms, TPOT "
              f"{trace.tpot * 1e3:.3f} ms over {trace.n_decoded} tokens, read "
              f"amplification {trace.read_amplification}, {len(trace.selected_per_layer[0])}"
              f" of {sess.meta.n_chunks} chunks, launches {got}")
        # host clock inside the engine's compute ops (each ends in a device
        # sync) by tag, and the engine's waits on IO; the rest of a request's
        # time is the engine's own bookkeeping
        busy = {k: round((v - busy.get(k, 0.0)) * 1e3, 2) for k, v in ex.stage_times.items()}
        waits = {k: round(v * 1e3, 2) for k, v in trace.stages.items()}
        print(f"e2e: request {i}: compute ops ms {busy}, waits ms {waits}")
    totals = {k: mod.launches for k, mod in ops.items()}
    print(f"e2e: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    profile_request(eng, suffixes[0], statistics.mean(walls[1:]))

    # budget 1.0 against the dense forward over prefix + suffix
    full = ContiguousKVEngine(sess, RealCompute(cfg, params, device=DEVICE), RealExecutor(),
                              budget=1.0,
                              period=PERIOD, subperiod=SUBPERIOD)
    logits, _ = full.reprefill(suffixes[0])
    toks = torch.as_tensor(np.concatenate([prefix, suffixes[0]]), device=DEVICE)[None]
    dense = T.forward(params, {"tokens": toks}, cfg, logits_positions="last")
    a = torch.as_tensor(logits[0, -1], device=DEVICE)
    b = dense[0, -1]
    rel = ((a - b).abs().max() / b.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    print(f"e2e: budget 1.0 vs dense forward: max abs err / max |logit| {rel:.4f} "
          f"(tol {DENSE_REL_TOL}), cosine {cos:.5f} (min {DENSE_MIN_COS}), argmax "
          f"{int(a.argmax())} vs {int(b.argmax())}")
    if not (rel <= DENSE_REL_TOL and cos >= DENSE_MIN_COS):
        fail("budget-1.0 first-token logits disagree with the dense forward")
    ex.shutdown()
    return totals


def profile_request(eng, suffix, warm_wall_ms: float):
    """One more request under torch.profiler: the device's busy time (sum of
    its kernels and copies, one stream), the idle share against the mean wall
    time of the warm requests run without the profiler (which slows the
    host), and the device operations that take most of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.reprefill(suffix, request_id=N_REQUESTS, decode_tokens=DECODE_TOKENS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    def device_us(e):  # the attribute's name changed across torch versions
        t = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if t is None else t

    dev = [(e.key, e.count, device_us(e)) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(t for _, _, t in dev) / 1e3
    if busy_ms <= 0:
        fail("the profiler saw no device time")
    top = sorted(dev, key=lambda x: -x[2])[:6]
    print(f"e2e: profiled request: device busy {busy_ms:.1f} ms of a warm request's "
          f"{warm_wall_ms:.1f} ms ({100 * (1 - busy_ms / warm_wall_ms):.1f} % idle; "
          f"{wall_ms:.1f} ms under the profiler); top device ops: "
          + "; ".join(f"{k[:48]} x{n} {t / 1e3:.2f} ms" for k, n, t in top))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config

    cfg = get_config("qwen2.5-7b")
    phase_device()
    rows = phase_kernels(cfg)
    launches = phase_e2e(cfg)
    sources = {"chunk_score": ("src/repro_torch/csrc/chunk_score.cu",
                               "src/repro/kernels/chunk_score/kernel.py:65"),
               "chunk_attention": ("src/repro_torch/csrc/chunk_attention.cu",
                                   "src/repro/kernels/chunk_attention/kernel.py:71"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention/kernel.py:77")}
    kernels = []
    for name, r in rows.items():
        if launches[name] < 1:
            fail(f"{name} never launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": sources[name][0],
                        "replaces": sources[name][1], "launches": launches[name],
                        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound"]["tensor_core"][0],
                        "bound_by": r["bound"]["tensor_core"][1],
                        "cuda_core_bound_ms": r["bound"]["cuda_core"][0],
                        "cuda_core_bound_by": r["bound"]["cuda_core"][1],
                        "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
