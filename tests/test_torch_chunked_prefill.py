"""Chunked prefill and the batched part B of the port, against the JAX
package, on the CPU.

Reduced float32 Qwen2.5-7B (2 layers) and hymba-1.5b (3 layers), inputs and
weights made from numpy seeds (the JAX weights bridged to torch):

- chunk_attention's indexed form (plain version) against the JAX package's
  ``reprefill_attention_paged``, through its jnp reference and through the
  Pallas kernel interpreted: the output within 1e-5; A_j against the engine's
  mass (``sparse_attention.reprefill_attention``) on ``pool[idx]`` within
  1e-5 (the Pallas wrapper normalises A_j per head over the chunks instead);
- ``RealCompute.part_b_batch`` against the JAX backend's on the same ctx
  inputs (h and A_j within 1e-5) and against b single ``part_b`` calls;
- every engine's chunked plan op for op against the JAX engine's (tag,
  phase, tokens, flops, bytes, weight key, a PrefillChunkCtx attached), and
  its logits and greedy tokens bit for bit against the unchunked run's;
- the Scheduler at c = 4 with chunked prefill forms batches of at least two
  members whose results equal the unbatched run's within 2e-5 and whose
  greedy tokens equal the JAX scheduler's; at c = 1 it equals drive_serial
  bit for bit; the serve CLI runs with ``--prefill-chunk-tokens``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core import build_real_session as jax_build_session
from repro.core import sparse_attention as JSA
from repro.core.backends import RealCompute as JaxCompute
from repro.core.backends import StateCompute as JaxStateCompute
from repro.core.engine import StateSpaceEngine as JaxStateSpaceEngine
from repro.core.stepplan import PrefillChunkCtx as JaxChunkCtx
from repro.core.stepplan import resolve_handle as jax_resolve
from repro.kernels.chunk_attention.ops import reprefill_attention_paged
from repro.models import transformer as JT
from repro.serving import Request as JaxRequest
from repro.serving import Scheduler as JaxScheduler
from repro.serving.tenancy import ENGINE_CLASSES as JAX_ENGINES
from repro.storage.timing import RealExecutor as JaxExecutor
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core.backends import RealCompute, StateCompute
from repro_torch.core.engine import StateSpaceEngine
from repro_torch.core.session import build_real_session
from repro_torch.core.stepplan import PrefillChunkCtx, resolve_handle
from repro_torch.kernels.chunk_attention import ops as ca_ops
from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
from repro_torch.launch import serve
from repro_torch.serving import ENGINE_CLASSES, Request, Scheduler
from repro_torch.storage.timing import RealExecutor

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-6)
SYSTEMS = list(ENGINE_CLASSES)
PREFIX, SUFFIX, DECODE = 128, 32, 2
# unchunked, a divisor of the suffix, at least the suffix, a non-divisor
CHUNKS = [None, 16, SUFFIX, 12]


def _rand(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32).astype(dtype)


def _t(a):
    return bridge.tensor_from_numpy(a, "cpu")


# --------------------------------------------------------------------------
# the indexed form
# --------------------------------------------------------------------------
def _indexed_inputs(seed, b, s, nq, nkv, m, c, d, n_sel, n_valid):
    rng = np.random.default_rng(seed)
    q = _rand(seed, (b, s, nq, d))
    k_pool, v_pool = (_rand(seed + i, (m, c, nkv, d), np.float16) for i in (1, 2))
    k_suf, v_suf = (_rand(seed + i, (b, s, nkv, d)) for i in (3, 4))
    idx = np.stack([rng.permutation(m)[:n_sel] for _ in range(b)]).astype(np.int32)
    return q, k_pool, v_pool, idx, np.asarray(n_valid, np.int32), k_suf, v_suf


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n_valid", [[5, 8, 0], [1, 3, 8]])
def test_indexed_form_matches_reprefill_attention_paged(use_kernel, n_valid):
    """Each member against the JAX package's paged Re-Prefill attention
    (use_kernel: the Pallas kernel, interpreted on the CPU), unsorted
    indices into a pool of 12 chunks, ragged n_valid. The jnp reference
    multiplies P, cast to the pool's dtype, by V in that dtype, so it is
    given the float16 pool's values exactly in float32, where its arithmetic
    is the port's; the Pallas kernel takes the float16 pool itself."""
    b, s, nq, nkv, m, c, d, n_sel = 3, 8, 4, 2, 12, 16, 32, 8
    q, kp, vp, idx, nv, kf, vf = _indexed_inputs(7, b, s, nq, nkv, m, c, d, n_sel, n_valid)
    out, mass = ca_ops.chunk_attention_indexed(*(_t(x) for x in (q, kp, vp, idx, nv, kf, vf)))
    assert out.shape == (b, s, nq, d) and mass.shape == (b, n_sel)
    assert out.dtype == mass.dtype == torch.float32
    pool_dtype = np.float16 if use_kernel else np.float32
    for i in range(b):
        jo, _ = reprefill_attention_paged(
            jnp.asarray(q[i].transpose(1, 0, 2)), jnp.asarray(kp.astype(pool_dtype)),
            jnp.asarray(vp.astype(pool_dtype)),
            jnp.asarray(idx[i]), jnp.int32(nv[i]), jnp.asarray(kf[i]), jnp.asarray(vf[i]),
            use_kernel=use_kernel)
        np.testing.assert_allclose(out[i].numpy(), np.asarray(jo).transpose(1, 0, 2), **TOL)
        valid = np.arange(n_sel) < nv[i]
        _, jm = JSA.reprefill_attention(jnp.asarray(q[i]), jnp.asarray(kp[idx[i]]),
                                        jnp.asarray(vp[idx[i]]), jnp.asarray(valid),
                                        jnp.asarray(kf[i]), jnp.asarray(vf[i]), chunk_tokens=c)
        np.testing.assert_allclose(mass[i].numpy(), np.asarray(jm), **TOL)
        assert np.all(mass[i].numpy()[nv[i]:] == 0.0)


def test_indexed_form_equals_the_gathered_form_per_member():
    """The plain versions: member i of the indexed form is the gathered form
    on pool[chunk_idx[i]] bit for bit; a pad slot's index (here out of the
    pool's range) is never read; the launch counters do not move on the CPU."""
    b, s, nq, nkv, m, c, d, n_sel = 2, 5, 4, 2, 9, 8, 16, 4
    q, kp, vp, idx, nv, kf, vf = _indexed_inputs(11, b, s, nq, nkv, m, c, d, n_sel, [2, 4])
    idx[0, 2:] = 10 ** 6
    before = (ca_ops.launches, dict(ca_ops.launches_by_variant))
    out, mass = ca_ops.chunk_attention_indexed(*(_t(x) for x in (q, kp, vp, idx, nv, kf, vf)))
    assert (ca_ops.launches, ca_ops.launches_by_variant) == before
    for i in range(b):
        k_sel, v_sel = kp[np.minimum(idx[i], m - 1)], vp[np.minimum(idx[i], m - 1)]
        go, gm = chunk_attention_ref(_t(q[i]), _t(k_sel), _t(v_sel), int(nv[i]), _t(kf[i]),
                                     _t(vf[i]))
        assert torch.equal(out[i], go) and torch.equal(mass[i], gm)


# --------------------------------------------------------------------------
# shared stack: float32 weights, both packages' sessions
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def stack():
    cfg = dataclasses.replace(jax_reduced_config("qwen2.5-7b", n_layers=2), dtype="float32")
    pcfg = dataclasses.replace(reduced_config("qwen2.5-7b", n_layers=2), dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    prefix = (np.arange(PREFIX) % cfg.vocab_size).astype(np.int64)
    psess = {coarse: build_real_session(pcfg, tparams, prefix, coarse_blocks=coarse,
                                        in_memory=True, device="cpu")
             for coarse in (False, True)}
    jsess = {coarse: jax_build_session(cfg, params, prefix, coarse_blocks=coarse,
                                       in_memory=True)
             for coarse in (False, True)}
    return cfg, pcfg, params, tparams, psess, jsess


def _ctx_inputs(seed, cfg, s, nb, c, n_valid):
    d, nq, nkv = cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    valid = np.arange(nb) < n_valid
    return dict(h=_rand(seed, (1, s, cfg.d_model)), q=_rand(seed + 1, (1, s, nq, d)),
                k_suf=_rand(seed + 2, (1, s, nkv, d)), v_suf=_rand(seed + 3, (1, s, nkv, d)),
                k_sel=_rand(seed + 4, (nb, c, nkv, d), np.float16),
                v_sel=_rand(seed + 5, (nb, c, nkv, d), np.float16), valid=valid)


@pytest.mark.parametrize("b", [2, 3])
def test_part_b_batch_matches_jax_and_single_calls(stack, b):
    cfg, pcfg, params, tparams, _, _ = stack
    s, nb, c, layer = 16, 8, 16, 1
    inputs = [_ctx_inputs(100 + 10 * i, cfg, s, nb, c, [8, 3, 6][i]) for i in range(b)]
    jbe, pbe = JaxCompute(cfg, params), RealCompute(pcfg, tparams, device="cpu")
    jctxs = [JaxChunkCtx(backend=jbe, layer=layer, chunk_tokens=c,
                         **{k: (jnp.asarray(v) if k in ("h", "q", "k_suf", "v_suf") else v)
                            for k, v in x.items()}) for x in inputs]
    pctxs = [PrefillChunkCtx(backend=pbe, layer=layer, chunk_tokens=c,
                             **{k: (_t(v) if k in ("h", "q", "k_suf", "v_suf") else v)
                                for k, v in x.items()}) for x in inputs]
    assert len({x.shape_key() for x in pctxs}) == 1
    assert all(p.shape_key() == j.shape_key() for p, j in zip(pctxs, jctxs))
    got = pbe.part_b_batch(pctxs)
    ref = jbe.part_b_batch(jctxs)
    assert len(got) == b
    for (h, mass), (jh, jm), x, ctx in zip(got, ref, inputs, pctxs):
        assert h.shape == (1, s, cfg.d_model) and mass.shape == (nb,)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mass, np.asarray(jm), **TOL)
        sh, sm = pbe.part_b(layer, ctx.h, ctx.q, ctx.k_suf, ctx.v_suf, x["k_sel"], x["v_sel"],
                            x["valid"], c)
        np.testing.assert_allclose(h.numpy(), sh.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(mass, sm)  # the attention is the same per member


def test_shape_key_groups_like_jax(stack):
    """Ragged members (another n_valid is fine, another bucket or suffix is
    not) and the dtype names: the port groups as the JAX package does."""
    cfg, pcfg, params, tparams, _, _ = stack
    keys = []
    for nb, s, n_valid in ((8, 16, 8), (8, 16, 2), (16, 16, 8), (8, 12, 8)):
        x = _ctx_inputs(5, cfg, s, nb, 16, n_valid)
        p = PrefillChunkCtx(backend=None, layer=0, chunk_tokens=16,
                            **{k: (_t(v) if k in ("h", "q", "k_suf", "v_suf") else v)
                               for k, v in x.items()})
        j = JaxChunkCtx(backend=None, layer=0, chunk_tokens=16,
                        **{k: (jnp.asarray(v) if k in ("h", "q", "k_suf", "v_suf") else v)
                           for k, v in x.items()})
        assert p.shape_key() == j.shape_key()
        keys.append(p.shape_key())
    assert keys[0] == keys[1] and len(set(keys)) == 3


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------
def _kw(system, chunk):
    kw = dict(device_cap=64, host_cap=128, prefill_chunk_tokens=chunk)
    if system == "contiguous_kv":
        kw.update(budget=0.5, period=2, subperiod=1)
    elif system != "as_lru":
        kw.update(budget=0.5)
    return kw


def _suffix(rid, vocab):
    return (np.arange(SUFFIX) + 3 * rid) % vocab


def _record(ex, plan, resolve):
    """drive_serial that records every ComputeOp's pricing."""
    ops, send = [], None
    plan.clock.t = ex.now()
    try:
        while True:
            op = plan.gen.send(send)
            if type(op).__name__ == "ComputeOp":
                ops.append((op.tag, op.phase, op.tokens, op.flops, op.hbm_bytes,
                            op.weight_bytes, op.weight_key,
                            type(op.batch_ctx).__name__ == "PrefillChunkCtx"))
                send = ex.compute(op.fn, flops=op.flops, hbm_bytes=op.hbm_bytes, tag=op.tag)
            else:
                ex.wait(op.handle)
                send = resolve(op.handle)
            plan.clock.t = ex.now()
    except StopIteration as stop:
        return stop.value, ops


def _port_engine(stack, system, chunk):
    _, pcfg, _, tparams, psess, _ = stack
    return ENGINE_CLASSES[system](psess[system != "contiguous_kv"],
                                  RealCompute(pcfg, tparams, device="cpu"), RealExecutor(),
                                  **_kw(system, chunk))


@pytest.fixture(scope="module")
def unchunked(stack):
    """system -> (logits, trace) of the port's unchunked engine."""
    cfg = stack[0]
    return {system: _port_engine(stack, system, None).reprefill(
        _suffix(0, cfg.vocab_size), decode_tokens=DECODE) for system in SYSTEMS}


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("system", SYSTEMS)
def test_chunked_plan_matches_jax(stack, unchunked, system, chunk):
    cfg, _, params, _, _, jsess = stack
    suffix = _suffix(0, cfg.vocab_size)
    eng = _port_engine(stack, system, chunk)
    plan = eng.plan(suffix, decode_tokens=DECODE)
    logits, ops = _record(eng.ex, plan, resolve_handle)
    jeng = JAX_ENGINES[system](jsess[system != "contiguous_kv"], JaxCompute(cfg, params),
                               JaxExecutor(), **_kw(system, chunk))
    _, jops = _record(jeng.ex, jeng.plan(suffix, decode_tokens=DECODE), jax_resolve)
    assert ops == jops
    n_chunked = sum(1 for op in ops if op[0] == "compute" and op[2] > 0)
    if chunk is None or chunk >= SUFFIX:
        assert n_chunked == 0 and not any(op[-1] for op in ops)
    else:
        assert n_chunked == cfg.n_layers * -(-SUFFIX // chunk)
        assert sum(op[-1] for op in ops) == cfg.n_layers
    ref_logits, ref_trace = unchunked[system]
    np.testing.assert_array_equal(logits, ref_logits)
    assert plan.trace.decode_tokens_out == ref_trace.decode_tokens_out
    for l, sel in ref_trace.selected_per_layer.items():
        np.testing.assert_array_equal(plan.trace.selected_per_layer[l], sel)


@pytest.fixture(scope="module")
def state_stack():
    """Reduced float32 hymba-1.5b: both packages' weights, a prefix and a
    suffix, and the port's unchunked first-token logits."""
    name = "hymba-1.5b"
    cfg = dataclasses.replace(jax_reduced_config(name, n_layers=3), dtype="float32")
    pcfg = dataclasses.replace(reduced_config(name, n_layers=3), dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    rng = np.random.default_rng(0)
    prefix, suffix = rng.integers(0, cfg.vocab_size, 20), rng.integers(0, cfg.vocab_size, 12)
    be = StateCompute(pcfg, tparams, device="cpu")
    ref, _ = StateSpaceEngine(pcfg, be, RealExecutor(), prefix_tokens=prefix).reprefill(
        suffix, decode_tokens=DECODE)
    return cfg, pcfg, params, be, prefix, suffix, ref


@pytest.mark.parametrize("chunk", CHUNKS)
def test_state_engine_chunked_plan_matches_jax(state_stack, chunk):
    cfg, pcfg, params, be, prefix, suffix, ref = state_stack
    eng = StateSpaceEngine(pcfg, be, RealExecutor(), prefix_tokens=prefix,
                           prefill_chunk_tokens=chunk)
    logits, ops = _record(eng.ex, eng.plan(suffix, decode_tokens=DECODE), resolve_handle)
    jeng = JaxStateSpaceEngine(cfg, JaxStateCompute(cfg, params), JaxExecutor(),
                               prefix_tokens=prefix, prefill_chunk_tokens=chunk)
    jplan = jeng.plan(suffix, decode_tokens=DECODE)
    jops = []
    send = None
    try:  # the ops' pricing only: the JAX state backend is not run
        while True:
            op = jplan.gen.send(send)
            jops.append((op.tag, op.phase, op.tokens, op.flops, op.hbm_bytes, op.weight_bytes,
                         op.weight_key, False))
            if op.phase == "decode":
                break
            send = None if op.fn is None else (np.zeros((1, 1, cfg.vocab_size)), None)
    except StopIteration:
        pass
    n_pre = sum(1 for op in jops if op[1] == "prefill")
    assert ops[: n_pre + 1] == jops
    assert n_pre == -(-(len(prefix) + len(suffix)) // (chunk or 10 ** 9))
    np.testing.assert_array_equal(logits, ref)


# --------------------------------------------------------------------------
# the slice: the Scheduler with chunked prefill
# --------------------------------------------------------------------------
def _requests(cfg, n, cls=Request):
    return [cls(request_id=r, suffix=_suffix(r, cfg.vocab_size), decode_tokens=DECODE)
            for r in range(n)]


def test_chunked_scheduler_batches_part_b(stack):
    cfg, _, params, _, _, jsess = stack
    runs = {}
    for batched in (True, False):
        sched = Scheduler(_port_engine(stack, "contiguous_kv", 16), max_concurrency=4,
                          batch_decode=batched)
        runs[batched] = (sched.run(_requests(cfg, 4)), sched)
    (done_b, sched_b), (done_u, sched_u) = runs[True], runs[False]
    prefill = [m for m in sched_b.real_batch_log if m[0][1] == "prefill"]
    assert prefill, "c=4 chunked prefill never formed a part-B batch"
    assert all(len(m) >= 2 and all(p == "prefill" for _, p, _ in m) for m in prefill)
    assert sched_u.real_batch_log == []
    jeng = JAX_ENGINES["contiguous_kv"](jsess[False], JaxCompute(cfg, params), JaxExecutor(),
                                        **_kw("contiguous_kv", 16))
    jdone = JaxScheduler(jeng, max_concurrency=4).run(_requests(cfg, 4, JaxRequest))
    for cb, cu, jc in zip(done_b, done_u, jdone):
        np.testing.assert_allclose(cb.result, cu.result, rtol=2e-5, atol=2e-5)
        assert cb.trace.decode_tokens_out == cu.trace.decode_tokens_out
        assert cb.trace.decode_tokens_out == jc.trace.decode_tokens_out


def test_chunked_scheduler_at_concurrency_one_is_serial(stack):
    cfg = stack[0]
    sched = Scheduler(_port_engine(stack, "contiguous_kv", 12), max_concurrency=1)
    done = sched.run(_requests(cfg, 2))
    assert sched.real_batch_log == []
    eng = _port_engine(stack, "contiguous_kv", 12)
    for r, c in enumerate(done):
        logits, trace = eng.reprefill(_suffix(r, cfg.vocab_size), request_id=r,
                                      decode_tokens=DECODE)
        np.testing.assert_array_equal(c.result, logits)
        assert c.trace.decode_tokens_out == trace.decode_tokens_out


def test_serve_cli_chunked_prefill_on_the_cpu(capsys):
    done = serve.main(["--device", "cpu", "--arch", "qwen2.5-7b", "--n-layers", "2",
                       "--requests", "4", "--concurrency", "4", "--decode-tokens", "2",
                       "--period", "2", "--subperiod", "1", "--prefill-chunk-tokens", "16"])
    out = capsys.readouterr().out
    assert len(done) == 4 and all(len(c.trace.decode_tokens_out) == 2 for c in done)
    assert "prefill-chunk batches:" in out
