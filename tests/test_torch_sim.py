"""The port's discrete-event sim mode against the JAX package's, on the CPU.

Each scenario is built once from seeded numpy inputs and run through both
packages' sim stacks (``SyntheticWorkload``, ``build_sim_session``,
``SimCompute``, the engines, ``SimExecutor`` / ``ChannelSim``); every
channel occupancy (start, end, resource, tag) and every trace field must be
equal, unrounded: the north star's "sim timelines equal to the last bit".
The two committed golden timelines are reproduced by the port alone too.
The Scheduler's scenarios are in ``test_torch_sim_serving.py``.
"""
import dataclasses
import json
import math
import pathlib
import sys
import types

import numpy as np
import pytest

from repro import configs as jax_configs
from repro.core import backends as jax_backends
from repro.core import engine as jax_engine
from repro.core import hybrid as jax_hybrid
from repro.core import session as jax_session
from repro.serving import disagg as jax_disagg
from repro.serving import replicas as jax_replicas
from repro.serving import scheduler as jax_scheduler
from repro.serving import tenancy as jax_tenancy
from repro.storage import tierstore as jax_tierstore
from repro.storage import timing as jax_timing
from repro_torch import configs as pt_configs
from repro_torch.core import backends as pt_backends
from repro_torch.core import engine as pt_engine
from repro_torch.core import hybrid as pt_hybrid
from repro_torch.core import session as pt_session
from repro_torch.serving import disagg as pt_disagg
from repro_torch.serving import replicas as pt_replicas
from repro_torch.serving import scheduler as pt_scheduler
from repro_torch.serving import tenancy as pt_tenancy
from repro_torch.storage import tierstore as pt_tierstore
from repro_torch.storage import timing as pt_timing

GOLDEN = pathlib.Path(__file__).parent / "golden"
MODEL = "qwen2.5-7b"
ROUND = 9  # the golden files' resolution (ns at the sim's seconds scale)
SYSTEMS = ("contiguous_kv", "as_lru", "as_h2o_lfu", "impress")
# the JAX package's "paper" device (tests/test_hybrid.py); with its SSD 64x
# slower, compute-or-load's auto recomputes a head of Qwen2.5-7B's prefix
PAPER = dict(compute_flops=312e12, hbm_bandwidth=2.039e12)


def _derated(scale):
    return dict(PAPER, ssd_bandwidth=7.45e9 / scale, ssd_iops=600e3 / scale,
                ssd_latency=80e-6 * scale)


def _pkg(cfgs, be, eng, ses, hyb, sched, ten, tier, tim, dis, rep):
    return types.SimpleNamespace(
        get_config=cfgs.get_config, list_configs=cfgs.list_configs, SimCompute=be.SimCompute,
        SyntheticWorkload=ses.SyntheticWorkload, build_sim_session=ses.build_sim_session,
        ContiguousKVEngine=eng.ContiguousKVEngine, ASLRUEngine=eng.ASLRUEngine,
        ASH2OEngine=eng.ASH2OEngine, IMPRESSEngine=eng.IMPRESSEngine,
        StateSpaceEngine=eng.StateSpaceEngine, HybridPlanner=hyb.HybridPlanner,
        Scheduler=sched.Scheduler, Request=sched.Request, summarize=sched.summarize,
        ENGINE_CLASSES=ten.ENGINE_CLASSES, build_sim_fleet=ten.build_sim_fleet,
        TieredPrefixStore=tier.TieredPrefixStore, ChannelSim=tim.ChannelSim,
        SimExecutor=tim.SimExecutor, DeviceModel=tim.DeviceModel,
        DisaggTopology=dis.DisaggTopology, ReplicaSet=rep.ReplicaSet)


JAX = _pkg(jax_configs, jax_backends, jax_engine, jax_session, jax_hybrid, jax_scheduler,
           jax_tenancy, jax_tierstore, jax_timing, jax_disagg, jax_replicas)
PORT = _pkg(pt_configs, pt_backends, pt_engine, pt_session, pt_hybrid, pt_scheduler,
            pt_tenancy, pt_tierstore, pt_timing, pt_disagg, pt_replicas)


def plain(x):
    """Numbers, arrays and dataclasses as comparable Python values; floats
    stay exact (NaN as a string, so that equal NaNs compare equal)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(plain(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return sorted((plain(v) for v in x), key=repr)
    if isinstance(x, list):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


TRACE_FIELDS = ("system", "ttft", "stages", "ssd_bytes", "ssd_bytes_demand", "ssd_bytes_spec",
                "ssd_bytes_probe", "ssd_requests", "pcie_bytes", "needed_bytes",
                "tokens_loaded", "hits_device", "hits_host", "hits_ssd", "misses",
                "selected_per_period", "selected_per_layer", "first_token_at", "decode_times",
                "decode_selected", "decode_tokens_out", "recompute_units",
                "recompute_tokens", "ssd_bytes_avoided", "hybrid_decision")


def trace_digest(tr) -> dict:
    """Every field of a ReprefillTrace, with its read amplification and TPOT."""
    out = {f: plain(getattr(tr, f)) for f in TRACE_FIELDS}
    out["read_amplification"] = tr.read_amplification
    out["tpot"] = tr.tpot
    return out


def cache_digest(cache) -> dict:
    if cache is None:
        return {}
    out = {"tiers": plain(cache.tiers)}
    for name in ("I", "F", "hits", "misses"):
        if hasattr(cache, name):
            out[name] = plain(getattr(cache, name))
    if hasattr(cache, "ssd"):
        lay = cache.ssd.layout
        out.update(ssd_stats=plain(cache.ssd.stats), compaction=plain(cache.ssd.compaction),
                   live=lay.live_units(), segments=len(lay.segments),
                   read_amp=cache.read_amplification(),
                   dedup=cache.dedup_saved_units(), occupancy=plain(cache.tier_occupancy()))
    return out


def _suffix(rid, n=64):
    return np.random.default_rng((11, rid)).integers(0, 1000, n)


def _engine(P, system, ex, *, prefix=1024, seed=3, budget=0.25, caps=(64, 128), **kw):
    cfg = P.get_config(MODEL)
    wl = P.SyntheticWorkload(prefix, cfg.n_layers, seed=seed)
    sess = P.build_sim_session(cfg, prefix, coarse_blocks=system != "contiguous_kv")
    cls = P.ENGINE_CLASSES[system]
    if system != "as_lru":
        kw["budget"] = budget
    return cls(sess, P.SimCompute(cfg, wl), ex, device_cap=caps[0], host_cap=caps[1], **kw)


def serial_run(P, system, *, n_req=3, decode=3, model=None, hybrid=None, **kw):
    """``n_req`` requests one after the other on one engine (a warm cache
    from the second on): the executor's events, each trace, the cache."""
    ex = P.SimExecutor(P.DeviceModel(**(model or {})))
    hp = None if hybrid is None else P.HybridPlanner(hybrid, device_model=ex.model)
    eng = _engine(P, system, ex, hybrid=hp, **kw)
    traces = [eng.reprefill(_suffix(r), request_id=r, decode_tokens=decode)[1]
              for r in range(n_req)]
    return {"events": plain(ex.events), "traces": [trace_digest(t) for t in traces],
            "cache": cache_digest(eng.cache)}


def assert_same(got, want):
    """Equal digests; on a difference, name the first differing key."""
    if got != want:
        for k in want:
            assert got.get(k) == want[k], f"{k} differs"
        assert got == want


# ---------------------------------------------------------------- golden files
def golden_scenario(P, mixed: bool):
    """tests/test_golden_trace.py's two scenarios: 2 requests at concurrency 2
    with 2 decode tokens; or chunked prefill mixed into decode with one
    forced SLO preemption and swap."""
    cfg = P.get_config(MODEL)
    wl = P.SyntheticWorkload(512, cfg.n_layers, seed=3)
    ex = P.ChannelSim(P.DeviceModel())
    eng = P.ContiguousKVEngine(P.build_sim_session(cfg, 512), P.SimCompute(cfg, wl), ex,
                               budget=0.25, device_cap=64, host_cap=128,
                               prefill_chunk_tokens=16 if mixed else None)
    if not mixed:
        reqs = [P.Request(request_id=rid, suffix=np.zeros(32, np.int64) + rid, arrival=0.0,
                          decode_tokens=2) for rid in range(2)]
        sched = P.Scheduler(eng, max_concurrency=2)
    else:
        reqs = [P.Request(request_id=rid, suffix=np.zeros(32, np.int64) + rid, arrival=0.0,
                          decode_tokens=8) for rid in range(3)]
        reqs.append(P.Request(request_id=3, suffix=np.zeros(32, np.int64) + 3, arrival=0.05,
                              ttft_target=1e-3))
        sched = P.Scheduler(eng, policy="slo_aware", max_concurrency=3, max_batch_tokens=64,
                            preempt=True, swap_on_preempt=True, prefill_estimate=10.0)
    done = sched.run(reqs)
    return {"events": plain(ex.events),
            "ttft": {str(c.request.request_id): (c.ttft if mixed else c.trace.ttft)
                     for c in done},
            "finish": {str(c.request.request_id): c.finish for c in done},
            "preemptions": sched.preemptions, "swaps": sched.swaps,
            "traces": [trace_digest(c.trace) for c in done],
            "summary": plain(P.summarize(done)), "batch_log": sched.batch_log,
            "sim_batch_log": plain(sched.sim_batch_log)}


@pytest.mark.parametrize("mixed,fixture", [(False, "ckv_sim_timeline.json"),
                                           (True, "ckv_mixed_timeline.json")])
def test_golden_timelines_reproduced(mixed, fixture):
    """The port reproduces the committed fixture event for event at its
    rounding, and the JAX package's run of the scenario unrounded."""
    got = golden_scenario(PORT, mixed)
    want = json.loads((GOLDEN / fixture).read_text())
    r = lambda x: round(x, ROUND)  # noqa: E731
    assert [[r(s), r(e), res, tag] for s, e, res, tag in got["events"]] == want["events"]
    assert {k: r(v) for k, v in got["ttft"].items()} == want["ttft"]
    assert {k: r(v) for k, v in got["finish"].items()} == want["finish"]
    if mixed:
        assert (got["preemptions"], got["swaps"]) == (want["preemptions"], want["swaps"]) == (1, 1)
        assert any("mixed" in tag for *_, tag in got["events"])
    assert_same(got, golden_scenario(JAX, mixed))


# ------------------------------------------------------------------ engines
@pytest.mark.parametrize("system,kw", [
    ("contiguous_kv", {}),
    ("contiguous_kv", {"prefetch": False}),  # w/o P
    ("contiguous_kv", {"inter_period": False}),
    ("contiguous_kv", {"caps": (0, 0), "period": 4, "subperiod": 2}),
    ("as_lru", {}),
    ("as_h2o_lfu", {}),
    ("impress", {}),
    ("impress", {"caps": (0, 0)}),
], ids=["ckv", "ckv_wo_p", "ckv_no_inter", "ckv_no_cache", "as_lru", "as_h2o_lfu", "impress",
        "impress_no_cache"])
def test_engine_sim_matches_jax(system, kw):
    """Three requests in a row with 3 decode tokens each (warm caches, decode
    demand fetches): the same events, traces and cache state."""
    assert_same(serial_run(PORT, system, **kw), serial_run(JAX, system, **kw))


@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("mode,scale", [("force-compute", 1), ("force-load", 1), ("auto", 1),
                                        ("auto", 64)])
def test_hybrid_sim_matches_jax(system, mode, scale):
    """Compute-or-load in sim form on the JAX tests' paper device, its SSD
    derated ``scale`` times: the same decisions (every HybridDecision field),
    recompute ops and timelines. Force-load and auto on the plain SSD keep
    the plan without a planner; auto on the starved one recomputes."""
    got = serial_run(PORT, system, model=_derated(scale), hybrid=mode)
    assert_same(got, serial_run(JAX, system, model=_derated(scale), hybrid=mode))
    recomputed = [t["recompute_units"] for t in got["traces"]]
    if mode == "force-compute" or scale > 1:
        assert recomputed[0] > 0
    else:
        assert recomputed == [0, 0, 0]
        without = serial_run(PORT, system, model=_derated(scale))
        assert got["events"] == without["events"]
        for t, w in zip(got["traces"], without["traces"]):
            assert {**t, "hybrid_decision": None} == w


@pytest.mark.parametrize("caps,tenants", [((4, 8, 64), 1), ((16, 32, 48), 1), ((8, 16, 256), 2)])
def test_tierstore_plan_mode_matches_jax(caps, tenants):
    """ContiguousKV over the three-tier store in plan mode (its SSD tier's
    reads priced with ``ssd_plan(charge=True)``, sharing one submission with
    the layer's misses): hits by tier, the log's stats and compaction, and
    the timeline. Two tenants share one prompt by digest."""

    def run(P):
        cfg = P.get_config(MODEL)
        ex = P.SimExecutor(P.DeviceModel())
        store = None
        engines = []
        for t in range(1, tenants + 1):
            sess = dataclasses.replace(P.build_sim_session(cfg, 1024, digest="prompt"),
                                       tenant=t)
            if store is None:
                store = P.TieredPrefixStore(*caps, unit_bytes=sess.store.layout.unit_bytes,
                                            segment_units=16, payload_mode="plan")
            wl = P.SyntheticWorkload(1024, cfg.n_layers, seed=5)
            engines.append(P.ContiguousKVEngine(sess, P.SimCompute(cfg, wl), ex, cache=store,
                                                budget=0.25))
        traces = [engines[r % tenants].reprefill(_suffix(r), request_id=r,
                                                 decode_tokens=2)[1] for r in range(4)]
        return {"events": plain(ex.events), "traces": [trace_digest(t) for t in traces],
                "cache": cache_digest(store)}

    got = run(PORT)
    assert_same(got, run(JAX))
    assert sum(t["hits_ssd"] for t in got["traces"]) > 0


# ------------------------------------------------------------------ the zoo
def zoo_run(P, name, decode):
    """tests/test_zoo.py's engine for one config: the KV engine for attention
    families, StateSpaceEngine (no backend) for ssm/hybrid, chunked prefill."""
    cfg = P.get_config(name)
    ex = P.SimExecutor(P.DeviceModel())
    if cfg.family in ("ssm", "hybrid"):
        eng = P.StateSpaceEngine(cfg, None, ex, prefix_len=1024, prefill_chunk_tokens=64)
    else:
        wl = P.SyntheticWorkload(1024, cfg.n_layers, seed=7)
        eng = P.ContiguousKVEngine(P.build_sim_session(cfg, 1024), P.SimCompute(cfg, wl), ex,
                                   budget=0.25, device_cap=128, host_cap=512,
                                   prefill_chunk_tokens=64)
    logits, tr = eng.reprefill(np.arange(32) % cfg.vocab_size, request_id=0,
                               decode_tokens=decode)
    return logits, tr, {"events": plain(ex.events), "trace": trace_digest(tr)}


@pytest.mark.parametrize("name", pt_configs.list_configs())
def test_zoo_step_plan_and_sim_decode(name):
    """Every config of the port plans and decodes in sim as the JAX package
    does (test_zoo.py's smoke: first token, 4 decode times, in order)."""
    logits, tr, got = zoo_run(PORT, name, 4)
    assert logits is None and tr.ttft > 0 and len(tr.decode_times) == 4
    assert tr.decode_times == sorted(tr.decode_times)
    assert_same(got, zoo_run(JAX, name, 4)[2])


@pytest.mark.parametrize("name", [n for n in pt_configs.list_configs()
                                  if pt_configs.get_config(n).family in ("ssm", "hybrid")])
def test_zoo_ssm_decode_steps_cost_constant_time(name):
    """test_zoo.py's family contract: an SSM decode step costs the same at
    every position, a hybrid's only lengthens; equal to the JAX timeline."""
    _, tr, got = zoo_run(PORT, name, 8)
    gaps = np.diff([tr.first_token_at] + list(tr.decode_times))
    if pt_configs.get_config(name).family == "ssm":
        np.testing.assert_allclose(gaps, gaps[0], rtol=1e-9)
    else:
        assert np.all(np.diff(gaps) >= -1e-12)
    assert_same(got, zoo_run(JAX, name, 8)[2])


# ------------------------------------------------------------ the headline
def headline_ttfts(P, prefix=6000, device_model=None):
    """test_system.py's Fig. 10 ordering: the four engines at 5 % budget on
    a 6000-token prefix, one request each, cold caches of 500/2000 units."""
    cfg = P.get_config(MODEL)
    wl = P.SyntheticWorkload(prefix, cfg.n_layers, seed=0)
    out = {}
    for name, cls, coarse, kw in [("ckv", P.ContiguousKVEngine, False, dict(budget=0.05)),
                                  ("impress", P.IMPRESSEngine, True, dict(budget=0.05)),
                                  ("as_h2o", P.ASH2OEngine, True, dict(budget=0.05)),
                                  ("as_lru", P.ASLRUEngine, True, {})]:
        sess = P.build_sim_session(cfg, prefix, coarse_blocks=coarse)
        ex = P.SimExecutor(device_model or P.DeviceModel())
        eng = cls(sess, P.SimCompute(cfg, wl), ex, device_cap=500, host_cap=2000, **kw)
        _, tr = eng.reprefill(np.zeros(64, np.int64))
        out[name] = (tr.ttft, trace_digest(tr), plain(ex.events))
    return out


def test_headline_speedup_ordering():
    got = headline_ttfts(PORT)
    assert got == headline_ttfts(JAX)
    t = {k: v[0] for k, v in got.items()}
    assert t["ckv"] < t["impress"] < t["as_h2o"]
    assert t["ckv"] < t["as_lru"]
    assert t["impress"] / t["ckv"] > 2.0


# ------------------------------------------------------------ device models
def test_default_device_model_is_the_reference_and_h100_is_a_preset():
    """``DeviceModel()`` keeps the JAX package's constants (every parity
    above rests on it); the H100 preset changes only the data-sheet compute,
    HBM, host-link and NVLink rates, and prices the same plan faster."""
    assert dataclasses.asdict(PORT.DeviceModel()) == dataclasses.asdict(JAX.DeviceModel())
    h100 = PORT.DeviceModel.h100_sxm5()
    diff = {k: v for k, v in dataclasses.asdict(h100).items()
            if v != getattr(PORT.DeviceModel(), k)}
    assert diff == {"compute_flops": 989e12, "hbm_bandwidth": 3.35e12, "pcie_bandwidth": 64e9,
                    "interconnect_bandwidth": 450e9}
    got = headline_ttfts(PORT, prefix=2048, device_model=h100)
    ref = headline_ttfts(PORT, prefix=2048)
    for name in got:
        assert got[name][0] < ref[name][0], name


def test_sim_mode_imports_no_jax():
    """The sim stack of the port runs where jax and the JAX package are absent."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "from repro_torch.serving.tenancy import build_sim_fleet\n"
            "from repro_torch.serving import Scheduler, Request\n"
            "import numpy as np\n"
            "f = build_sim_fleet('contiguous_kv', 'qwen2.5-7b', prefix_len=512)\n"
            "d = Scheduler(f.engines).run([Request(0, np.zeros(8, np.int64), tenant=1)])\n"
            "assert d[0].trace.ttft > 0; print('SIM-OK')\n")
    import subprocess

    root = pathlib.Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], env={"PYTHONPATH": str(root / "src"),
                                                           "PATH": "/usr/bin:/bin"},
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "SIM-OK" in res.stdout, res.stderr
