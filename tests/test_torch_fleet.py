"""The port's heterogeneous fleet on the CPU, against its own serial runs
and against the JAX package (the port's half of tests/test_fleet.py).

Reduced float32 Qwen2.5-7B (dense), hymba-1.5b (hybrid), falcon-mamba-7b
(ssm) and granite-moe-3b-a800m (moe) on the JAX package's weights
(``bridge.params_from_numpy``):

- ``parse_fleet_spec`` against the JAX package's, and its refusals;
- ``StatePool`` swap: a device pool's round trip bit for bit with the bytes
  equal to ``nbytes`` (the JAX pool's minus its int32 length), ``is_device``
  unchanged while swapped out, the meter seeing the swap-in; a host pool
  moves nothing;
- ``StateCompute.decode_step_batch`` against the JAX backend's on the same
  stacked states at b = 3: the same greedy tokens, logits and states within
  1e-4 of their scale (tests/test_torch_state_engine.py's bound: the JAX
  decode runs the Pallas scan, interpreted, the port the plain version);
  each member's state against its own unbatched step within 1e-5 of its
  scale (a batched product of b rows sums as one row's does, bar the order
  of a few float32 sums), every member still owning its tensors; a ragged
  batch bit for bit the per-request steps;
- ``StateSpaceEngine``'s decode ops carry the JAX engine's ``DecodeBatchCtx``
  tokens and positions, and its pricing hooks return the JAX engine's;
- a mixed fleet at concurrency 1 bit for bit each family's ``drive_serial``
  alone, and with the JAX Scheduler's greedy tokens on the same fleet; at
  concurrency 4 every batch holds one weight stream and the state-space
  members batch; an SSM decode survives preemption with swap and a
  disaggregated handoff bit for bit; ``launch.serve --fleet`` on the CPU;
- tests/test_fleet.py's NEW_FAMILIES (ssm, hybrid, moe) each through
  Scheduler(max_concurrency=1) bit for bit its ``drive_serial`` run, and its
  MIXED_SPEC (two dense tenants, an ssm and an MoE one): in sim the JAX
  fleet's timeline event for event and ``serve --mode sim`` output character
  for character; in real mode at c = 1 each family alone bit for bit and the
  JAX Scheduler's greedy tokens, at c = 4 batched as unbatched.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core import build_real_session as jax_build_session
from repro.core.backends import RealCompute as JaxRealCompute
from repro.core.backends import StateCompute as JaxStateCompute
from repro.core.engine import ContiguousKVEngine as JaxContiguousKV
from repro.core.engine import StateSpaceEngine as JaxStateSpaceEngine
from repro.core.stepplan import DecodeBatchCtx as JaxDecodeBatchCtx
from repro.models import transformer as JT
from repro.serving import Request as JaxRequest
from repro.serving import Scheduler as JaxScheduler
from repro.serving.tenancy import TenantFleet as JaxTenantFleet
from repro.serving.tenancy import parse_fleet_spec as jax_parse_fleet_spec
from repro.storage.timing import RealExecutor as JaxExecutor
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core.backends import RealCompute, StateCompute, StatePool
from repro_torch.core.engine import ContiguousKVEngine, StateSpaceEngine
from repro_torch.core.session import build_real_session
from repro_torch.core.stepplan import DecodeBatchCtx, drive_serial, weight_stream
from repro_torch.launch import serve
from repro_torch.serving import DisaggTopology, Request, Scheduler, TenantFleet, parse_fleet_spec
from repro_torch.storage.h2d_meter import H2DMeter
from repro_torch.storage.timing import RealExecutor
from test_torch_sim import JAX, PORT, assert_same
from test_torch_sim_serving import fleet_run

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DENSE, HYBRID, SSM = "qwen2.5-7b", "hymba-1.5b", "falcon-mamba-7b"
MOE = "granite-moe-3b-a800m"
STATE_NAMES = [HYBRID, SSM]
FLEET = [DENSE, HYBRID, SSM]
NEW_FAMILIES = [SSM, HYBRID, MOE]  # tests/test_fleet.py's
MIXED_SPEC = "qwen2_5_7b:2,falcon_mamba_7b:1,granite_moe_3b_a800m:1"  # tests/test_fleet.py's
MIXED = [DENSE, DENSE, SSM, MOE]
PREFIX, SUFFIX, DECODE = 96, 16, 4


@pytest.fixture(scope="module")
def models():
    """name -> (JAX cfg, port cfg, JAX params, port params), float32."""
    out = {}
    for name in FLEET + [MOE]:
        cfg = dataclasses.replace(jax_reduced_config(name), dtype="float32")
        pcfg = dataclasses.replace(reduced_config(name), dtype="float32")
        params = JT.init_params(jax.random.PRNGKey(0), cfg)
        tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
        out[name] = (cfg, pcfg, params, tparams)
    return out


def _prefix():
    return (np.arange(PREFIX) % 256).astype(np.int64)


def _suffix(rid):
    return ((np.arange(SUFFIX) + 3 * rid) % 256).astype(np.int64)


def _scale_tol(ref, rel=1e-4):
    return dict(rtol=0, atol=rel * float(np.abs(np.asarray(ref, np.float32)).max()))


def _engine(models, name, ex, *, tenant=0, backend=None):
    _, pcfg, _, tparams = models[name]
    if pcfg.family in ("ssm", "hybrid"):
        be = backend or StateCompute(pcfg, tparams, device="cpu")
        return StateSpaceEngine(pcfg, be, ex, prefix_tokens=_prefix(), tenant=tenant)
    sess = build_real_session(pcfg, tparams, _prefix(), chunk_tokens=16, in_memory=True,
                              device="cpu")
    return ContiguousKVEngine(dataclasses.replace(sess, tenant=tenant),
                              RealCompute(pcfg, tparams, device="cpu"), ex,
                              budget=0.5, device_cap=64, host_cap=128)


def _jax_engine(models, name, ex, *, tenant=0):
    cfg, _, params, _ = models[name]
    if cfg.family in ("ssm", "hybrid"):
        return JaxStateSpaceEngine(cfg, JaxStateCompute(cfg, params), ex,
                                   prefix_tokens=_prefix(), tenant=tenant)
    sess = jax_build_session(cfg, params, _prefix(), chunk_tokens=16, in_memory=True)
    return JaxContiguousKV(dataclasses.replace(sess, tenant=tenant), JaxRealCompute(cfg, params),
                           ex, budget=0.5, device_cap=64, host_cap=128)


# ---------------------------------------------------------------------------
# spec parsing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["qwen2_5_7b:2,falcon_mamba_7b:1,hymba_1_5b:1",
                                  "QWEN2.5-7B", " hymba-1.5b:3 ,, qwen2_5_14b "])
def test_parse_fleet_spec_matches_jax(spec):
    assert parse_fleet_spec(spec) == jax_parse_fleet_spec(spec)


@pytest.mark.parametrize("bad", ["qwen2.5-7b:x", "qwen2.5-7b:0", ",,", "hymba_1_5b:-1"])
def test_parse_fleet_spec_malformed_raises(bad):
    with pytest.raises(ValueError):
        jax_parse_fleet_spec(bad)
    with pytest.raises(ValueError):
        parse_fleet_spec(bad)


def test_parse_fleet_spec_unported_architecture():
    # the port's registry is the JAX package's: an MoE tenant parses alike,
    # and an architecture neither knows raises a KeyError naming the registry
    assert (parse_fleet_spec(MIXED_SPEC) == jax_parse_fleet_spec(MIXED_SPEC)
            == [("qwen2.5-7b", 2), ("falcon-mamba-7b", 1), ("granite-moe-3b-a800m", 1)])
    with pytest.raises(KeyError, match="available.*hymba-1.5b"):
        parse_fleet_spec("qwen2_5_7b:1,no_such_model:1")
    assert parse_fleet_spec("qwen2_5_7b:2,falcon_mamba_7b") == [("qwen2.5-7b", 2),
                                                                 ("falcon-mamba-7b", 1)]


def test_tenant_fleet_has_the_jax_fields():
    assert ([f.name for f in dataclasses.fields(TenantFleet)]
            == [f.name for f in dataclasses.fields(JaxTenantFleet)])
    fleet = TenantFleet(engines={}, executor=None, cache=None)
    assert (fleet.workloads, fleet.configs, fleet.topology, fleet.replicas) == ({}, {}, None,
                                                                               None)


# ---------------------------------------------------------------------------
# StatePool swap
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", STATE_NAMES)
def test_state_pool_swap_round_trip(name, models):
    cfg, pcfg, params, tparams = models[name]
    be = StateCompute(pcfg, tparams, device="cpu")
    logits, pool = be.prefill(_prefix(), extra_tokens=3)
    assert not pool.is_device  # a pool built on the CPU is a host pool
    host_state = pool.state
    assert (pool.swap_out(), pool.is_resident) == (0, False)
    assert (pool.swap_in(), pool.is_resident) == (0, True)
    assert pool.state is host_state and pool.state["ssm_h"] is host_state["ssm_h"]
    # a device pool (here on the CPU, as the JAX package's pools are there)
    pool = StatePool(pool.state, device=True)
    tok = int(np.argmax(logits[0, -1]))
    before = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in pool.state.items()}
    ref_logits, _ = be.decode_step(tok, {k: v.clone() if isinstance(v, torch.Tensor) else v
                                         for k, v in pool.state.items()})
    _, jpool = JaxStateCompute(cfg, params).prefill(_prefix(), extra_tokens=3)
    out_bytes = pool.swap_out()
    assert out_bytes == pool.nbytes > 0 and not pool.is_resident and pool.is_device
    assert out_bytes == jpool.swap_out() - np.asarray(jpool.state["length"]).nbytes
    with pytest.raises(RuntimeError, match="already swapped out"):
        pool.swap_out()
    with H2DMeter("cpu") as meter:
        in_bytes = pool.swap_in()
    assert in_bytes == out_bytes and pool.is_resident and pool.is_device
    assert meter.total == in_bytes  # the swap-in passes the meter's doors
    with pytest.raises(RuntimeError, match="not swapped out"):
        pool.swap_in()
    for key, v in before.items():
        if isinstance(v, torch.Tensor):
            assert pool.state[key].device == pool.home and torch.equal(pool.state[key], v)
        else:
            assert pool.state[key] == v
    got_logits, _ = be.decode_step(tok, pool.state)
    np.testing.assert_array_equal(got_logits, ref_logits)


# ---------------------------------------------------------------------------
# StateCompute.decode_step_batch
# ---------------------------------------------------------------------------
def _torch_state(jstate):
    return {k: (int(np.asarray(v)) if k == "length" else torch.from_numpy(np.array(v)))
            for k, v in jstate.items()}


def _clone(state):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in state.items()}


@pytest.mark.parametrize("name", STATE_NAMES)
def test_decode_step_batch_matches_jax(name, models):
    cfg, pcfg, params, tparams = models[name]
    jbe, be = JaxStateCompute(cfg, params), StateCompute(pcfg, tparams, device="cpu")
    jctxs, ctxs = [], []
    for rid in range(3):  # the same lengths: one stacked step
        toks = np.concatenate([_prefix(), _suffix(rid)])
        logits, jpool = jbe.prefill(toks, extra_tokens=2)
        tok = int(np.argmax(np.asarray(logits)[0, -1]))
        jctxs.append(JaxDecodeBatchCtx(backend=jbe, token=tok, pos=len(toks), pools={0: jpool}))
        ctxs.append(DecodeBatchCtx(backend=be, token=tok, pos=len(toks),
                                   pools={0: StatePool(_torch_state(jpool.state))}))
    singles = [be.decode_step(c.token, _clone(c.pools[0].state)) for c in ctxs]
    owned = [{k: (v, v.untyped_storage().data_ptr()) for k, v in c.pools[0].state.items()
              if isinstance(v, torch.Tensor)} for c in ctxs]
    dicts = [c.pools[0].state for c in ctxs]
    jouts = jbe.decode_step_batch(jctxs)
    outs = be.decode_step_batch(ctxs)
    assert len(outs) == 3
    ptrs = set()
    for i, (c, jc) in enumerate(zip(ctxs, jctxs)):
        ref = np.asarray(jouts[i])
        assert outs[i].shape == ref.shape == (1, 1, pcfg.vocab_size)
        assert int(np.argmax(outs[i][0, -1])) == int(np.argmax(ref[0, -1]))
        np.testing.assert_allclose(outs[i], ref, **_scale_tol(ref))
        st = c.pools[0].state
        assert st is dicts[i] and st["length"] == int(np.asarray(jc.pools[0].state["length"]))
        for key, jv in jc.pools[0].state.items():
            if key != "length":
                np.testing.assert_allclose(st[key].numpy(), np.asarray(jv), **_scale_tol(jv))
        # against the member's own unbatched step
        s_logits, s_state = singles[i]
        np.testing.assert_allclose(outs[i], s_logits, **_scale_tol(s_logits, 1e-5))
        for key, (t, ptr) in owned[i].items():
            assert st[key] is t and t.untyped_storage().data_ptr() == ptr
            assert t.shape[1] == 1
            np.testing.assert_allclose(t.numpy(), s_state[key].numpy(),
                                       **_scale_tol(s_state[key].numpy(), 1e-5))
            ptrs.add(ptr)
    assert len(ptrs) == sum(len(o) for o in owned)  # no member shares storage


@pytest.mark.parametrize("name", STATE_NAMES)
def test_decode_step_batch_ragged_falls_back(name, models):
    _, pcfg, _, tparams = models[name]
    be = StateCompute(pcfg, tparams, device="cpu")
    ctxs = []
    for rid, n in enumerate((16, 9, 16)):  # unequal lengths
        logits, pool = be.prefill(np.concatenate([_prefix(), _suffix(rid)[:n]]),
                                  extra_tokens=2)
        ctxs.append(DecodeBatchCtx(backend=be, token=int(np.argmax(logits[0, -1])),
                                   pos=pool.valid_tokens, pools={0: pool}))
    refs = [be.decode_step(c.token, _clone(c.pools[0].state)) for c in ctxs]
    outs = be.decode_step_batch(ctxs)
    for out, c, (lg, st) in zip(outs, ctxs, refs):
        np.testing.assert_array_equal(out, lg)
        for key, v in st.items():
            got = c.pools[0].state[key]
            assert torch.equal(got, v) if isinstance(v, torch.Tensor) else got == v


# ---------------------------------------------------------------------------
# StateSpaceEngine: decode ops' ctx and the pricing hooks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", STATE_NAMES)
def test_state_engine_ctx_and_hooks_match_jax(name, models):
    cfg, pcfg, params, tparams = models[name]
    eng = _engine(models, name, RealExecutor())
    jeng = JaxStateSpaceEngine(cfg, JaxStateCompute(cfg, params), JaxExecutor(),
                               prefix_tokens=_prefix())
    assert eng.hybrid is None and eng.cache is None and eng.prefix_len == jeng.prefix_len
    plan, jplan = eng.plan(_suffix(0), decode_tokens=3), jeng.plan(_suffix(0), decode_tokens=3)
    op, jop = plan.gen.send(None), jplan.gen.send(None)
    send, jsend = op.fn(), jop.fn()
    pool = send[1]
    for _ in range(3):
        op, jop = plan.gen.send(send), jplan.gen.send(jsend)
        ctx, jctx = op.batch_ctx, jop.batch_ctx
        assert isinstance(ctx, DecodeBatchCtx) and ctx.backend is eng.backend
        assert (ctx.token, ctx.pos) == (jctx.token, jctx.pos)
        assert ctx.pools == {0: pool} and (op.weight_key, op.tokens) == (
            jop.weight_key, jop.tokens) == (f"model@{pcfg.name}", 1)
        send, jsend = op.fn(), jop.fn()
    for suffix_len, decoded in ((SUFFIX, 0), (SUFFIX, 3), (40, 7)):
        a = types.SimpleNamespace(request=types.SimpleNamespace(suffix=np.zeros(suffix_len)),
                                  plan=types.SimpleNamespace(trace=types.SimpleNamespace(
                                      decode_times=[0.0] * decoded)))
        assert eng._state_bytes(suffix_len, decoded) == jeng._state_bytes(suffix_len, decoded)
        assert eng.swap_bytes_of(a) == jeng.swap_bytes_of(a)
        assert eng.handoff_payload(a) == jeng.handoff_payload(a)


def test_decode_ctx_backend_is_read_at_run_time(models):
    """A restamped ctx.backend runs the step (the disaggregated handoff)."""
    _, pcfg, _, tparams = models[SSM]

    class Counting(StateCompute):
        steps = 0

        def decode_step(self, token, state):
            Counting.steps += 1
            return super().decode_step(token, state)

    eng = _engine(models, SSM, RealExecutor())
    plan = eng.plan(_suffix(0), decode_tokens=1)
    op = plan.gen.send(None)
    op = plan.gen.send(op.fn())
    op.batch_ctx.backend = Counting(pcfg, tparams, device="cpu")
    op.fn()
    assert Counting.steps == 1


# ---------------------------------------------------------------------------
# the fleet behind the Scheduler
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def serial(models):
    """name -> [(logits, greedy tokens)] of drive_serial alone, 2 requests."""
    out = {}
    for name in FLEET + [MOE]:
        eng = _engine(models, name, RealExecutor())
        out[name] = []
        for rid in range(2):
            plan = eng.plan(_suffix(rid), rid, decode_tokens=DECODE)
            logits = drive_serial(eng.ex, plan)
            out[name].append((logits, list(plan.trace.decode_tokens_out)))
    return out


def _fleet_requests(n, n_tenants, cls=Request):
    return [cls(request_id=rid, suffix=_suffix(rid % 2), tenant=1 + rid % n_tenants,
                decode_tokens=DECODE) for rid in range(n)]


def test_mixed_fleet_c1_matches_each_family_alone_and_jax(models, serial):
    ex, jex = RealExecutor(), JaxExecutor()
    engines = {t: _engine(models, name, ex, tenant=t) for t, name in enumerate(FLEET, 1)}
    jengines = {t: _jax_engine(models, name, jex, tenant=t)
                for t, name in enumerate(FLEET, 1)}
    sched = Scheduler(engines, max_concurrency=1)
    done = sched.run(_fleet_requests(6, 3))
    jdone = JaxScheduler(jengines, max_concurrency=1).run(_fleet_requests(6, 3, JaxRequest))
    assert sched.real_batch_log == []
    for c, jc in zip(done, jdone):
        name = FLEET[c.request.tenant - 1]
        ref_logits, ref_toks = serial[name][c.request.request_id % 2]
        np.testing.assert_array_equal(c.result, ref_logits)
        assert c.trace.decode_tokens_out == ref_toks
        assert c.trace.decode_tokens_out == jc.trace.decode_tokens_out
        ref = np.asarray(jc.result)
        rel = 1e-3 if name == DENSE else 1e-4  # tests/test_torch_serving.py's dense bound
        np.testing.assert_allclose(c.result, ref, **_scale_tol(ref, rel))


def test_mixed_fleet_batches_stay_family_pure(models, serial):
    """Concurrent mixed serving: same-model state-space decode steps batch
    (the two falcon-mamba tenants share one backend), no batch spans two
    weight streams, and the batched run decodes as the unbatched one."""
    _, pcfg, _, tparams = models[SSM]
    runs = {}
    for batched in (True, False):
        ex = RealExecutor()
        shared = StateCompute(pcfg, tparams, device="cpu")
        roster = [(DENSE, None), (HYBRID, None), (SSM, shared), (SSM, shared)]
        engines = {t: _engine(models, name, ex, tenant=t, backend=be)
                   for t, (name, be) in enumerate(roster, 1)}
        sched = Scheduler(engines, max_concurrency=4, batch_decode=batched)
        runs[batched] = (sched.run(_fleet_requests(8, 4)), sched)
    (done, sched), (done_u, sched_u) = runs[True], runs[False]
    assert len(done) == 8 and sched_u.real_batch_log == []
    assert sched.real_batch_log, "no batch formed"
    for members in sched.real_batch_log:
        assert len({wk for _, _, wk in members}) == 1
        assert len({weight_stream(wk) for _, _, wk in members}) == 1
    ssm_batches = [m for m in sched.real_batch_log if m[0][2] == f"model@{pcfg.name}"]
    assert ssm_batches and max(len(m) for m in ssm_batches) >= 2
    for c, cu in zip(done, done_u):
        assert c.trace.decode_tokens_out == cu.trace.decode_tokens_out
        np.testing.assert_allclose(c.result, cu.result, **_scale_tol(cu.result, 1e-5))
        name = FLEET[[0, 1, 2, 2][c.request.tenant - 1]]
        assert c.trace.decode_tokens_out == serial[name][c.request.request_id % 2][1]


class _DevicePools(StateCompute):
    """Builds device pools on the CPU (as the JAX package's CPU pools are),
    so a swap moves the state."""

    def prefill(self, tokens, extra_tokens: int = 0):
        logits, pool = super().prefill(tokens, extra_tokens)
        return logits, StatePool(pool.state, device=True)


@pytest.mark.parametrize("name", STATE_NAMES)
@pytest.mark.parametrize("device_pools", [True, False])
def test_ssm_decode_survives_preemption_with_swap(name, device_pools, models, serial):
    _, pcfg, _, tparams = models[name]
    be = (_DevicePools if device_pools else StateCompute)(pcfg, tparams, device="cpu")
    eng = _engine(models, name, RealExecutor(), backend=be)
    legs = []
    real = StatePool.swap_out

    def swap_out(pool):
        legs.append(pool.nbytes)
        return real(pool)

    StatePool.swap_out = swap_out
    try:
        sched = Scheduler(eng, max_concurrency=1, preempt=True, swap_on_preempt=True,
                          prefill_estimate=1e3)
        done = sched.run([Request(request_id=0, suffix=_suffix(0), decode_tokens=DECODE),
                          Request(request_id=1, suffix=_suffix(1), decode_tokens=1,
                                  ttft_target=1e-6)])
    finally:
        StatePool.swap_out = real
    victim = done[0]
    assert sched.preemptions >= 1 and victim.preemptions >= 1 and len(legs) >= 1
    if device_pools:
        assert sched.swaps == len(legs) and sched.swap_bytes == 2 * sum(legs)
    else:
        assert sched.swaps == sched.swap_bytes == 0
    ref_logits, ref_toks = serial[name][0]
    np.testing.assert_array_equal(victim.result, ref_logits)
    assert victim.trace.decode_tokens_out == ref_toks


def test_state_engine_disaggregated_bit_identical(models, serial):
    _, pcfg, _, tparams = models[HYBRID]
    workers = [_DevicePools(pcfg, tparams, device="cpu") for _ in range(2)]
    eng = _engine(models, HYBRID, RealExecutor(),
                  backend=_DevicePools(pcfg, tparams, device="cpu"))
    sched = Scheduler(eng, max_concurrency=1,
                      topology=DisaggTopology(n_prefill=1, decode_backends=workers))
    done = sched.run([Request(request_id=r, suffix=_suffix(r), decode_tokens=DECODE)
                      for r in range(2)])
    assert sched.handoffs == 2 and sched.handoff_bytes > 0
    for c in done:
        logits, toks = serial[HYBRID][c.request.request_id]
        np.testing.assert_array_equal(c.result, logits)
        assert c.trace.decode_tokens_out == toks


def test_serve_cli_fleet_on_the_cpu(capsys):
    done = serve.main(["--device", "cpu", "--fleet",
                       "qwen2_5_7b:1,falcon_mamba_7b:1,hymba_1_5b:1", "--requests", "6",
                       "--concurrency", "3", "--decode-tokens", "3"])
    out = capsys.readouterr().out
    assert ("heterogeneous fleet: t1=qwen2.5-7b-smoke[dense], "
            "t2=falcon-mamba-7b-smoke[ssm], t3=hymba-1.5b-smoke[hybrid]") in out
    assert len(done) == 6 and all(len(c.trace.decode_tokens_out) == 3 for c in done)
    assert [c.request.tenant for c in done] == [1, 2, 3, 1, 2, 3]
    assert "concurrency=3 policy=fcfs p50=" in out and "decode: mean TPOT=" in out
    assert "falcon-mamba-7b-smoke: ttft=" in out
    with pytest.raises(SystemExit, match="does not compose"):
        serve.main(["--device", "cpu", "--fleet", "hymba_1_5b:1", "--disaggregate", "1:1"])
    for flags in (["--hybrid-reprefill", "auto"], ["--cache-tiers", "4:8:16"]):
        with pytest.raises(SystemExit, match="does not compose"):
            serve.main(["--device", "cpu", "--fleet", "hymba_1_5b:1"] + flags)
    done = serve.main(["--device", "cpu", "--fleet", "granite_moe_3b_a800m:1", "--requests", "2",
                       "--concurrency", "2", "--decode-tokens", "2"])
    out = capsys.readouterr().out
    assert "heterogeneous fleet: t1=granite-moe-3b-a800m-smoke[moe]" in out
    assert len(done) == 2 and all(len(c.trace.decode_tokens_out) == 2 for c in done)


# ---------------------------------------------------------------------------
# the MoE family in the fleet (tests/test_fleet.py's NEW_FAMILIES, MIXED_SPEC)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_new_family_c1_scheduler_bit_identical_to_serial(name, models, serial):
    sched = Scheduler(_engine(models, name, RealExecutor()), max_concurrency=1)
    done = sched.run([Request(request_id=rid, suffix=_suffix(rid), decode_tokens=DECODE)
                      for rid in range(2)])
    for rid, c in enumerate(done):
        ref_logits, ref_toks = serial[name][rid]
        np.testing.assert_array_equal(c.result, ref_logits)
        assert c.trace.decode_tokens_out == ref_toks


def test_mixed_spec_real_c1_matches_each_family_alone_and_jax(models, serial):
    ex, jex = RealExecutor(), JaxExecutor()
    engines = {t: _engine(models, name, ex, tenant=t) for t, name in enumerate(MIXED, 1)}
    jengines = {t: _jax_engine(models, name, jex, tenant=t) for t, name in enumerate(MIXED, 1)}
    done = Scheduler(engines, max_concurrency=1).run(_fleet_requests(8, 4))
    jdone = JaxScheduler(jengines, max_concurrency=1).run(_fleet_requests(8, 4, JaxRequest))
    for c, jc in zip(done, jdone):
        name = MIXED[c.request.tenant - 1]
        ref_logits, ref_toks = serial[name][c.request.request_id % 2]
        np.testing.assert_array_equal(c.result, ref_logits)
        assert c.trace.decode_tokens_out == ref_toks == jc.trace.decode_tokens_out
        ref = np.asarray(jc.result)
        rel = 1e-4 if name == SSM else 1e-3  # tests/test_torch_serving.py's dense bound
        np.testing.assert_allclose(c.result, ref, **_scale_tol(ref, rel))


def test_mixed_spec_real_c4_batches_per_model(models, serial):
    """At c = 4, with half the requests the MoE tenant's, its decode steps
    batch with no other model's, and the batched run decodes the tokens of
    the unbatched one."""
    tenants = [4, 4, 1, 4, 2, 4, 3, 4]
    runs = {}
    for batched in (True, False):
        ex = RealExecutor()
        engines = {t: _engine(models, name, ex, tenant=t) for t, name in enumerate(MIXED, 1)}
        sched = Scheduler(engines, max_concurrency=4, batch_decode=batched)
        reqs = [Request(request_id=rid, suffix=_suffix(rid % 2), tenant=t, decode_tokens=DECODE)
                for rid, t in enumerate(tenants)]
        runs[batched] = (sched.run(reqs), sched)
    (done, sched), (done_u, _) = runs[True], runs[False]
    assert sched.real_batch_log, "no batch formed"
    for members in sched.real_batch_log:
        assert len({weight_stream(wk) for _, _, wk in members}) == 1
    assert max(len(m) for m in sched.real_batch_log) >= 2
    for c, cu in zip(done, done_u):
        name = MIXED[c.request.tenant - 1]
        assert c.trace.decode_tokens_out == cu.trace.decode_tokens_out
        assert c.trace.decode_tokens_out == serial[name][c.request.request_id % 2][1]
        np.testing.assert_allclose(c.result, cu.result, **_scale_tol(cu.result, 1e-5))


def test_mixed_spec_sim_matches_jax():
    """The sim fleet of MIXED_SPEC: the same timeline event for event (the
    MoE tenant's decode priced by its active experts), every batch one
    model's weight stream."""
    got = fleet_run(PORT, n=8, fleet=MIXED_SPEC)
    assert_same(got, fleet_run(JAX, n=8, fleet=MIXED_SPEC))
    for batch in got["sim_batch_log"]:
        assert len({key.rpartition("@")[2] for _, _, key in batch}) == 1, batch


def test_mixed_spec_serve_sim_cli_matches_jax(monkeypatch, capsys):
    import sys

    from repro.launch import serve as jax_serve

    args = ["--mode", "sim", "--fleet", MIXED_SPEC, "--decode-tokens", "3"]
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jax_serve.main()
    want = capsys.readouterr().out
    serve.main(args)
    assert capsys.readouterr().out == want
    assert "t4=granite-moe-3b-a800m[moe]" in want


def test_mixed_spec_serve_cli_on_the_cpu(capsys):
    done = serve.main(["--device", "cpu", "--fleet", MIXED_SPEC, "--requests", "8",
                       "--concurrency", "4", "--decode-tokens", "3"])
    out = capsys.readouterr().out
    assert ("heterogeneous fleet: t1=qwen2.5-7b-smoke[dense], t2=qwen2.5-7b-smoke[dense], "
            "t3=falcon-mamba-7b-smoke[ssm], t4=granite-moe-3b-a800m-smoke[moe]") in out
    assert len(done) == 8 and all(len(c.trace.decode_tokens_out) == 3 for c in done)
    assert "granite-moe-3b-a800m-smoke: ttft=" in out
