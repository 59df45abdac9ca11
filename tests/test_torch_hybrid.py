"""The port's compute-or-load Re-Prefill against the JAX package's, on the CPU.

- The planner (``core/hybrid.py``): ``decide`` gives the JAX planner's
  decision, field for field, in sim form (each package's ``ChannelSim`` with
  equal ``free_at``, derated SSDs, three modes, shared reservations) and in
  real form (after equal ``observe_io`` calls); ``price_handoff``, ``reset``
  and the unknown mode likewise. The planners are numpy and Python floats
  over equal inputs, so the comparisons are exact.
- The four KV engines on a reduced float32 Qwen2.5-7B (2 layers, a
  128-token prefix, c = 16; the baselines on 32-token blocks), each with the
  same planner mode as the JAX engine: equal recompute counts, frontiers,
  SSD bytes avoided, selections and greedy tokens; logits within 1e-3 of
  their scale (the float32 rounding of two packages, as
  ``test_torch_engine.py`` allows); force-load bit for bit the port's run
  without a planner, and force-compute too, since the recomputed KV is bit
  for bit the store's on the CPU.
- ContiguousKV over a content-addressed ``TieredPrefixStore`` (memory mode):
  hits by tier per request equal the JAX engine's, and the logits are bit
  for bit a run with caches of size 0 (an SSD-tier hit returns the stored
  bytes); a second tenant of the same prompt hits the first one's units.
- The Scheduler at c = 4 with part B in chunks of 16 and force-compute: the
  JAX Scheduler's greedy tokens; the recompute op never joins a batch; a run
  resets the planner's reservations.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.core import build_real_session as jax_build_session
from repro.core.backends import RealCompute as JaxCompute
from repro.core.engine import PlanStore as JaxPlanStore
from repro.core.hybrid import HybridPlanner as JaxPlanner
from repro.models import transformer as JT
from repro.serving import Request as JaxRequest
from repro.serving import Scheduler as JaxScheduler
from repro.serving.tenancy import ENGINE_CLASSES as JAX_ENGINES
from repro.storage.layout import ContiguousChunkLayout as JaxLayout
from repro.storage.layout import KVGeometry as JaxGeometry
from repro.storage.tierstore import TieredPrefixStore as JaxTierStore
from repro.storage.timing import ChannelSim as JaxChannelSim
from repro.storage.timing import DeviceModel as JaxDeviceModel
from repro.storage.timing import RealExecutor as JaxExecutor
from repro_torch import bridge
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.backends import RealCompute
from repro_torch.core.hybrid import HYBRID_MODES, HybridPlanner
from repro_torch.core.session import build_real_session, prefix_digest
from repro_torch.core.stepplan import ComputeOp
from repro_torch.serving import ENGINE_CLASSES, Request, Scheduler
from repro_torch.storage.layout import ContiguousChunkLayout, KVGeometry
from repro_torch.storage.tierstore import TieredPrefixStore
from repro_torch.storage.timing import ChannelSim, DeviceModel, IOHandle, RealExecutor

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SYSTEMS = list(ENGINE_CLASSES)
PREFIX, SUFFIX, DECODE, BLOCK = 128, 24, 2, 32
# the default constants with an SSD 2000x slower: auto then recomputes
SLOW_SSD = dict(ssd_bandwidth=7.45e9 / 2000, ssd_iops=600e3 / 2000, ssd_latency=80e-6 * 2000)


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------
class _PlanStore:
    """Layout math without a backing store, what ``decide`` reads."""

    def __init__(self, layout):
        self.layout = layout

    def run_plan(self, layer, units):
        runs = self.layout.coalesce(layer, units)
        return sum(r.nbytes for r in runs), len(runs)


def _plan_stores(name, prefix_len=2048):
    jc, pc = jax_get_config(name), get_config(name)
    jg = JaxGeometry(n_kv_heads=jc.n_kv_heads, d_head=jc.d_head, bytes_per_el=2)
    pg = KVGeometry(n_kv_heads=pc.n_kv_heads, d_head=pc.d_head, bytes_per_el=2)
    return ((jc, JaxPlanStore(JaxLayout(prefix_len, jc.n_layers, jg, 16))),
            (pc, _PlanStore(ContiguousChunkLayout(prefix_len, pc.n_layers, pg, 16))))


def _models(scale):
    derate = dict(ssd_bandwidth=7.45e9 / scale, ssd_iops=600e3 / scale,
                  ssd_latency=80e-6 * scale, compute_flops=312e12, hbm_bandwidth=2.039e12)
    return JaxDeviceModel(**derate), DeviceModel(**derate)


def _decisions_equal(dj, dp):
    assert dataclasses.asdict(dp) == dataclasses.asdict(dj)


@pytest.mark.parametrize("name", ["qwen2.5-7b", "qwen2.5-32b"])
@pytest.mark.parametrize("scale", [1, 16, 64])
def test_decide_sim_form_matches_jax(name, scale):
    """Each package's ChannelSim with equal backlogs: equal decisions and
    equal anti-herd reservations, over missing sets of every shape, two
    suffix lengths, two compute channels and the three modes."""
    (jc, js), (pc, ps) = _plan_stores(name)
    n_units = ps.layout.n_units
    rng = np.random.default_rng(scale)
    missing_sets = [list(range(n_units)), list(range(0, n_units, 3)),
                    sorted(rng.choice(n_units, n_units // 4, replace=False).tolist()),
                    [0], [n_units - 1]]
    jm, pm = _models(scale)
    for mode in ("auto", "force-compute", "force-load"):
        jp, pp = JaxPlanner(mode, device_model=jm), HybridPlanner(mode, device_model=pm)
        for backlog in (0.0, 0.05, 0.5):
            for suffix_len, channel in ((0, "compute"), (256, "compute:p0")):
                jex, pex = JaxChannelSim(jm), ChannelSim(pm)
                for ex in (jex, pex):
                    ex.free_at["ssd"] = backlog
                    ex.free_at[channel] = backlog / 2
                for i, missing in enumerate(missing_sets):
                    kw = dict(missing_units=missing, prefix_len=2048, clock_t=0.01 * i,
                              suffix_len=suffix_len, attended_tokens=512 + suffix_len,
                              extra_overlap_flops=1e9 * i, compute_channel=channel)
                    _decisions_equal(jp.decide(cfg=jc, store=js, executor=jex, **kw),
                                     pp.decide(cfg=pc, store=ps, executor=pex, **kw))
                    assert pp._reserved_until == jp._reserved_until


@pytest.mark.parametrize("mode", ["auto", "force-compute", "force-load"])
def test_decide_real_form_matches_jax(mode):
    """Real form: the EWMA of measured against modelled IO time scales the IO
    leg; equal observe_io calls give equal io_scale and decisions."""
    (jc, js), (pc, ps) = _plan_stores("qwen2.5-7b", 4096)
    jp, pp = JaxPlanner(mode), HybridPlanner(mode)
    assert dataclasses.asdict(pp.model) == dataclasses.asdict(jp.model)
    rng = np.random.default_rng(3)
    for step in range(6):
        if step:
            nbytes, nreq = int(rng.integers(1, 64)) * 16384, int(rng.integers(1, 8))
            secs = float(rng.random() * 0.01)
            jp.observe_io(nbytes, nreq, secs)
            pp.observe_io(nbytes, nreq, secs)
        assert (pp.io_scale, pp.io_observations) == (jp.io_scale, jp.io_observations)
        missing = sorted(rng.choice(256, 64, replace=False).tolist())
        kw = dict(missing_units=missing, prefix_len=4096, suffix_len=64,
                  attended_tokens=64 * 16 + 64, extra_overlap_flops=4e9)
        _decisions_equal(jp.decide(cfg=jc, store=js, **kw), pp.decide(cfg=pc, store=ps, **kw))
    assert pp._reserved_until == {}  # real form reserves nothing


def test_timed_fetch_feeds_the_ewma():
    pp = HybridPlanner("auto")
    assert pp.timed_fetch(lambda: "payload", 65536, 2)() == "payload"
    assert pp.io_observations == 1 and pp.io_scale > 0


@pytest.mark.parametrize("mode", ["off", "auto", "force-compute", "force-load"])
def test_price_handoff_matches_jax(mode):
    (jc, _), (pc, _) = _plan_stores("qwen2.5-7b")
    jm, pm = _models(4)
    jp, pp = JaxPlanner(mode, device_model=jm), HybridPlanner(mode, device_model=pm)
    for i, (nbytes, tokens) in enumerate(((1 << 20, 512), (1 << 28, 4096), (1 << 32, 64))):
        jex, pex = JaxChannelSim(jm), ChannelSim(pm)
        for ex in (jex, pex):
            ex.add_channel("interconnect")
            ex.add_channel("compute:d0")
            ex.free_at["interconnect"] = 0.002 * i
        kw = dict(nbytes=nbytes, tokens=tokens, dst_channel="compute:d0", clock_t=0.001 * i)
        assert (pp.price_handoff(cfg=pc, executor=pex, **kw)
                == jp.price_handoff(cfg=jc, executor=jex, **kw))
        assert pp._reserved_until == jp._reserved_until


def test_reset_and_unknown_mode():
    assert HYBRID_MODES == ("off", "auto", "force-compute", "force-load")
    for cls in (JaxPlanner, HybridPlanner):
        with pytest.raises(ValueError, match="not in"):
            cls("sometimes")
    (_, _), (pc, ps) = _plan_stores("qwen2.5-7b")
    pp = HybridPlanner("force-compute")
    ex = ChannelSim(pp.model)
    pp.decide(cfg=pc, store=ps, missing_units=[0, 1], prefix_len=2048, executor=ex)
    pp.observe_io(1 << 20, 1, 0.001)
    scale = pp.io_scale
    assert pp._reserved_until
    pp.reset()  # drops the sim-clock reservations, keeps the IO calibration
    assert pp._reserved_until == {} and pp.io_scale == scale and pp.io_observations == 1


# --------------------------------------------------------------------------
# the engines
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def stack():
    cfg = dataclasses.replace(jax_reduced_config("qwen2.5-7b", n_layers=2), dtype="float32")
    pcfg = dataclasses.replace(reduced_config("qwen2.5-7b", n_layers=2), dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    prefix = (np.arange(PREFIX) % cfg.vocab_size).astype(np.int64)
    psess = {c: build_real_session(pcfg, tparams, prefix, coarse_blocks=c, block_tokens=BLOCK,
                                   in_memory=True, device="cpu") for c in (False, True)}
    jsess = {c: jax_build_session(cfg, params, prefix, coarse_blocks=c, block_tokens=BLOCK,
                                  in_memory=True) for c in (False, True)}
    return cfg, pcfg, params, tparams, psess, jsess


def _kw(system, **extra):
    kw = dict(extra)
    if system == "contiguous_kv":
        kw.update(budget=0.5, period=2, subperiod=1)
    elif system != "as_lru":
        kw.update(budget=0.5)
    return kw


def _planner(cls, model_cls, mode):
    if mode == "auto-slow-ssd":
        return cls("auto", device_model=model_cls(**SLOW_SSD))
    return None if mode is None else cls(mode)


def _suffix(rid, vocab):
    return (np.arange(SUFFIX) + 3 * rid) % vocab


def _port_engine(stack, system, mode, **kw):
    _, pcfg, _, tparams, psess, _ = stack
    return ENGINE_CLASSES[system](psess[system != "contiguous_kv"],
                                  RealCompute(pcfg, tparams, device="cpu"), RealExecutor(),
                                  hybrid=_planner(HybridPlanner, DeviceModel, mode),
                                  **_kw(system, **kw))


def _jax_engine(stack, system, mode, **kw):
    cfg, _, params, _, _, jsess = stack
    return JAX_ENGINES[system](jsess[system != "contiguous_kv"], JaxCompute(cfg, params),
                               JaxExecutor(), hybrid=_planner(JaxPlanner, JaxDeviceModel, mode),
                               **_kw(system, **kw))


@pytest.fixture(scope="module")
def plain(stack):
    """system -> [(logits, trace)] of the port's engines without a planner,
    two requests each on caches of size 0."""
    cfg = stack[0]
    out = {}
    for system in SYSTEMS:
        eng = _port_engine(stack, system, None)
        out[system] = [eng.reprefill(_suffix(r, cfg.vocab_size), request_id=r,
                                     decode_tokens=DECODE) for r in range(2)]
    return out


HYBRID_COUNTS = ("recompute_units", "recompute_tokens", "ssd_bytes_avoided", "ssd_bytes",
                 "misses", "hits_device", "tokens_loaded")


@pytest.mark.parametrize("mode", ["force-compute", "force-load", "auto", "auto-slow-ssd"])
@pytest.mark.parametrize("system", SYSTEMS)
def test_engine_with_planner_matches_jax(stack, plain, system, mode):
    """Two requests on caches of size 0, so each decides afresh; auto's
    second request would price its IO leg with each package's own measured
    EWMA, so only its first is held decision for decision."""
    cfg = stack[0]
    je, pe = _jax_engine(stack, system, mode), _port_engine(stack, system, mode)
    n = 1 if mode.startswith("auto") else 2
    for r in range(n):
        sfx = _suffix(r, cfg.vocab_size)
        lj, tj = je.reprefill(sfx, request_id=r, decode_tokens=DECODE)
        lp, tp = pe.reprefill(sfx, request_id=r, decode_tokens=DECODE)
        assert {f: getattr(tp, f) for f in HYBRID_COUNTS} == {f: getattr(tj, f)
                                                              for f in HYBRID_COUNTS}
        dj, dp = tj.hybrid_decision, tp.hybrid_decision
        assert (dp.recompute_units, dp.load_units) == (dj.recompute_units, dj.load_units)
        if mode.startswith("auto") or r == 0:
            _decisions_equal(dj, dp)
        for l, sel in tj.selected_per_layer.items():
            np.testing.assert_array_equal(tp.selected_per_layer[l], sel)
        assert tp.decode_tokens_out == tj.decode_tokens_out
        np.testing.assert_allclose(lp, lj, rtol=0, atol=1e-3 * np.abs(lj).max())
        # the recompute changes where the KV comes from, never its value
        l0, t0 = plain[system][r]
        np.testing.assert_array_equal(lp, l0)
        assert tp.decode_tokens_out == t0.decode_tokens_out
        if mode == "force-load":
            assert tp.recompute_units == 0 and tp.ssd_bytes == t0.ssd_bytes
        if mode in ("force-compute", "auto-slow-ssd"):
            assert tp.recompute_units > 0 and tp.ssd_bytes < t0.ssd_bytes
            assert "recompute" in tp.stages


@pytest.mark.parametrize("system", SYSTEMS)
def test_chunked_plan_with_planner_is_the_unchunked_one(stack, plain, system):
    """Part B in chunks of 16 changes nothing the planner decides or the
    request returns: the recompute op comes before the first part B."""
    cfg = stack[0]
    eng = _port_engine(stack, system, "force-compute", prefill_chunk_tokens=16)
    logits, tr = eng.reprefill(_suffix(0, cfg.vocab_size), decode_tokens=DECODE)
    l0, t0 = plain[system][0]
    assert tr.recompute_units > 0
    np.testing.assert_array_equal(logits, l0)
    assert tr.decode_tokens_out == t0.decode_tokens_out


@pytest.mark.parametrize("system", ["contiguous_kv", "as_lru"])
def test_recomputed_kv_is_the_store(stack, system):
    """A recomputed unit's float16 KV equals the store's ingested bytes: a
    causal forward over a head of the prefix never sees the tail."""
    _, pcfg, _, _, psess, _ = stack
    eng = _port_engine(stack, system, "force-compute", device_cap=64, host_cap=128)
    _, tr = eng.reprefill(_suffix(0, pcfg.vocab_size))
    store = psess[system != "contiguous_kv"].store
    units = tr.hybrid_decision.recompute_units
    assert len(units) >= 2 and tr.recompute_tokens == min((units[-1] + 1)
                                                          * store.layout.unit_tokens, PREFIX)
    for u in units:
        for l in range(pcfg.n_layers):
            np.testing.assert_array_equal(eng._data[eng._key(l, u)],
                                          store.read_units(l, [u])[u])


def test_session_carries_tokens_and_digest(stack):
    cfg, _, _, _, psess, jsess = stack
    for c in (False, True):
        np.testing.assert_array_equal(psess[c].tokens, jsess[c].tokens)
        assert psess[c].digest == jsess[c].digest == prefix_digest(psess[c].tokens)
    assert prefix_digest(np.arange(5)) != prefix_digest(np.arange(6))


# --------------------------------------------------------------------------
# the tier store under the engine
# --------------------------------------------------------------------------
def _tier(cls, unit_bytes, unit_shape, caps=(2, 4, 64)):
    return cls(*caps, unit_bytes=unit_bytes, payload_mode="memory", unit_shape=unit_shape)


TIER_COUNTS = ("hits_device", "hits_host", "hits_ssd", "misses", "ssd_bytes",
               "ssd_bytes_demand", "ssd_requests", "needed_bytes", "tokens_loaded")


def test_engine_over_tier_store_matches_jax(stack, plain):
    """Caps 2:4:64 units against 8 selected a request: later requests hit all
    three tiers. Hits by tier equal the JAX engine's request by request, the
    store ends in the same state, and the logits are bit for bit those of the
    run on caches of size 0."""
    cfg, _, _, _, psess, jsess = stack
    layout = psess[False].store.layout
    shape = psess[False].store.unit_shape
    jt = _tier(JaxTierStore, layout.unit_bytes, shape)
    pt = _tier(TieredPrefixStore, layout.unit_bytes, shape)
    je = _jax_engine(stack, "contiguous_kv", None, cache=jt)
    pe = _port_engine(stack, "contiguous_kv", None, cache=pt)
    ref = _port_engine(stack, "contiguous_kv", None)
    seen = np.zeros(3, int)
    for r in range(5):
        sfx = _suffix(r % 3 + (r > 2), cfg.vocab_size)
        _, tj = je.reprefill(sfx, request_id=r, decode_tokens=DECODE)
        lp, tp = pe.reprefill(sfx, request_id=r, decode_tokens=DECODE)
        l0, t0 = ref.reprefill(sfx, request_id=r, decode_tokens=DECODE)
        assert {f: getattr(tp, f) for f in TIER_COUNTS} == {f: getattr(tj, f)
                                                            for f in TIER_COUNTS}
        np.testing.assert_array_equal(lp, l0)
        assert tp.decode_tokens_out == t0.decode_tokens_out == tj.decode_tokens_out
        seen += (tp.hits_device, tp.hits_host, tp.hits_ssd)
    assert seen.min() > 0 and pt.read_amplification() == jt.read_amplification() >= 1.0
    assert pt.tiers == jt.tiers and pt.hits == jt.hits
    assert all(k[0] == psess[False].digest for t in pt.tiers.values() for k in t)


def test_two_tenants_share_one_copy(stack):
    """Two tenants of the same prompt on one store: the second tenant's first
    request hits the first tenant's units, held once."""
    _, pcfg, _, tparams, psess, _ = stack
    layout = psess[False].store.layout
    store = _tier(TieredPrefixStore, layout.unit_bytes, psess[False].store.unit_shape,
                  caps=(64, 64, 64))
    engines = [ENGINE_CLASSES["contiguous_kv"](
        dataclasses.replace(psess[False], tenant=t), RealCompute(pcfg, tparams, device="cpu"),
        RealExecutor(), cache=store, **_kw("contiguous_kv")) for t in (1, 2)]
    sfx = _suffix(0, pcfg.vocab_size)
    l1, t1 = engines[0].reprefill(sfx, request_id=0)
    l2, t2 = engines[1].reprefill(sfx, request_id=1)
    assert t1.misses > 0 and t2.misses == 0 and t2.hits_device == t1.misses
    np.testing.assert_array_equal(l1, l2)
    assert store.dedup_saved_units() == len(store._payload) > 0
    assert store.payload_bytes() == len(store._payload) * layout.unit_bytes
    assert store.tenant_usage()[1] == store.tenant_usage()[2]


class _OnWait:
    """A future that runs its read only when it is waited on."""

    def __init__(self, fn):
        self.fn, self.done, self.value = fn, False, None

    def result(self):
        if not self.done:
            self.value, self.done = self.fn(), True
        return self.value


class _ReadOnWaitExecutor(RealExecutor):
    """Every read runs at its wait: each insert between a read's submit and
    its wait (the next layer's, on the prefetch path) lands before it."""

    def submit_io(self, fn, *, nbytes, n_requests, channel):
        return IOHandle(future=_OnWait(fn))


@pytest.mark.parametrize("executor", ["on-wait", "threads"])
@pytest.mark.parametrize("payload_mode", ["memory", "file"])
def test_ssd_tier_overflow_under_reads_in_flight(stack, plain, payload_mode, executor):
    """Caps 1:2:3 units in 4-unit segments: the SSD tier overflows and
    compacts while its reads are queued. Pinned slots outlive the drops
    until their read, so the logits stay bit for bit those of caches of
    size 0."""
    cfg, pcfg, _, tparams, psess, _ = stack
    st = psess[False].store
    store = TieredPrefixStore(1, 2, 3, unit_bytes=st.layout.unit_bytes, segment_units=4,
                              payload_mode=payload_mode, unit_shape=st.unit_shape)
    ex = _ReadOnWaitExecutor() if executor == "on-wait" else RealExecutor()
    eng = ENGINE_CLASSES["contiguous_kv"](psess[False], RealCompute(pcfg, tparams, device="cpu"),
                                          ex, cache=store, **_kw("contiguous_kv"))
    hits_ssd = 0
    with store:
        for r in range(2 * len(plain["contiguous_kv"])):
            logits, tr = eng.reprefill(_suffix(r % 2, cfg.vocab_size), request_id=r,
                                       decode_tokens=DECODE)
            l0, t0 = plain["contiguous_kv"][r % 2]
            np.testing.assert_array_equal(logits, l0)
            assert tr.decode_tokens_out == t0.decode_tokens_out
            hits_ssd += tr.hits_ssd
        assert hits_ssd > 0 and store.ssd.compaction.units_read > 0
        assert store.ssd.pending_discards == 0 and not store.ssd._pins
        if executor == "on-wait":
            assert store.ssd.deferred_discards > 0


# --------------------------------------------------------------------------
# the Scheduler
# --------------------------------------------------------------------------
def _requests(cfg, n, cls=Request):
    return [cls(request_id=r, suffix=_suffix(r, cfg.vocab_size), decode_tokens=DECODE)
            for r in range(n)]


def test_chunked_scheduler_with_force_compute_matches_jax(stack):
    """c = 4, part B in chunks of 16, force-compute: the JAX Scheduler's
    greedy tokens; every recompute op runs alone (no batching context), and
    the run resets the planner's reservations."""
    cfg = stack[0]
    eng = _port_engine(stack, "contiguous_kv", "force-compute", prefill_chunk_tokens=16)
    eng.hybrid._reserved_until["compute"] = 1e9  # a stale reservation
    recompute_ops = []
    plan = eng.plan

    def watched(suffix, request_id=0, decode_tokens=0):
        p = plan(suffix, request_id, decode_tokens=decode_tokens)
        gen = p.gen

        def tap():
            send = None
            while True:
                try:
                    op = gen.send(send)
                except StopIteration as stop:
                    return stop.value
                if isinstance(op, ComputeOp) and op.tag == "recompute":
                    recompute_ops.append(op)
                send = yield op
        p.gen = tap()
        return p

    eng.plan = watched
    sched = Scheduler(eng, max_concurrency=4)
    done = sched.run(_requests(cfg, 4))
    assert eng.hybrid._reserved_until == {}
    assert len(recompute_ops) == 4 and all(op.batch_ctx is None for op in recompute_ops)
    assert any(m[0][1] == "prefill" for m in sched.real_batch_log)
    assert all(wk.startswith("layer:") for m in sched.real_batch_log for _, ph, wk in m
               if ph == "prefill")
    jeng = _jax_engine(stack, "contiguous_kv", "force-compute", prefill_chunk_tokens=16)
    jdone = JaxScheduler(jeng, max_concurrency=4).run(_requests(cfg, 4, JaxRequest))
    for c, jc in zip(done, jdone):
        assert c.trace.recompute_units == jc.trace.recompute_units > 0
        assert c.trace.decode_tokens_out == jc.trace.decode_tokens_out
