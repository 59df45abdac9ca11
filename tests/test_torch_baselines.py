"""The port's baseline engines and ContiguousKV's w/o-P switches against the
JAX package's, on the CPU.

Reduced float32 Qwen2.5-7B (4 layers, a 100-token prefix) on coarse sessions
of 32-token blocks, as the reference's tests/test_engine.py uses: over three
requests the two packages' engines select the same tokens (or chunks) per
layer, count the same bytes, hits and misses, decode the same greedy tokens
and leave the same cache behind. Their logits differ by float32 rounding,
plus the rare float16 store value that rounds to the neighbouring float16
because the two ingest forwards differ in the last float32 bit; 1e-3 of the
logits' scale covers that, as in test_torch_engine.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core import ASH2OEngine as JaxASH2O
from repro.core import ASLRUEngine as JaxASLRU
from repro.core import ContiguousKVEngine as JaxCKV
from repro.core import IMPRESSEngine as JaxIMPRESS
from repro.core import build_real_session as jax_build_session
from repro.core.backends import RealCompute as JaxCompute
from repro.core.importance import chunk_scores_from_token_scores as jax_chunk_scores
from repro.models import transformer as JT
from repro.storage.timing import RealExecutor as JaxExecutor
from repro_torch import bridge, core
from repro_torch.configs import reduced_config
from repro_torch.core.backends import RealCompute
from repro_torch.core.engine import ASH2OEngine, ASLRUEngine, ContiguousKVEngine, IMPRESSEngine
from repro_torch.core.importance import chunk_scores_from_token_scores
from repro_torch.core.session import build_real_session
from repro_torch.models import transformer as PT
from repro_torch.storage.timing import RealExecutor

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK = 32
TRACE_COUNTS = ("hits_device", "hits_host", "misses", "ssd_bytes", "ssd_bytes_demand",
                "ssd_bytes_spec", "ssd_bytes_probe", "ssd_requests", "pcie_bytes",
                "needed_bytes", "tokens_loaded")


@pytest.fixture(scope="module")
def fx():
    cfg = dataclasses.replace(jax_reduced_config("qwen2.5-7b", n_layers=4), dtype="float32")
    pcfg = dataclasses.replace(reduced_config("qwen2.5-7b", n_layers=4), dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 100)  # 100 % 32 != 0: a partial last block
    suffix = rng.integers(0, cfg.vocab_size, 16)
    sessions = {
        "coarse": (jax_build_session(cfg, params, prefix, coarse_blocks=True,
                                     block_tokens=BLOCK, in_memory=True),
                   build_real_session(pcfg, tparams, prefix, coarse_blocks=True,
                                      block_tokens=BLOCK, in_memory=True, device="cpu")),
        "dense": (jax_build_session(cfg, params, prefix, in_memory=True),
                  build_real_session(pcfg, tparams, prefix, in_memory=True, device="cpu")),
    }
    return dict(cfg=cfg, pcfg=pcfg, params=params, tparams=tparams, prefix=prefix,
                suffix=suffix, sessions=sessions)


# name -> (JAX class, port class, session, keyword arguments)
ENGINES = {
    "as_lru": (JaxASLRU, ASLRUEngine, "coarse", {}),
    "as_h2o_lfu": (JaxASH2O, ASH2OEngine, "coarse", {"budget": 0.25}),
    "impress": (JaxIMPRESS, IMPRESSEngine, "coarse", {"budget": 0.25}),
    "ckv_wo_prefetch": (JaxCKV, ContiguousKVEngine, "dense",
                        {"budget": 0.25, "period": 2, "subperiod": 1, "prefetch": False}),
    "ckv_wo_inter_period": (JaxCKV, ContiguousKVEngine, "dense",
                            {"budget": 0.25, "period": 2, "subperiod": 1,
                             "inter_period": False}),
}


def _engines(fx, name, **caps):
    jcls, pcls, sess, kw = ENGINES[name]
    jsess, psess = fx["sessions"][sess]
    je = jcls(jsess, JaxCompute(fx["cfg"], fx["params"]), JaxExecutor(), **kw, **caps)
    pe = pcls(psess, RealCompute(fx["pcfg"], fx["tparams"], device="cpu"), RealExecutor(),
              **kw, **caps)
    return je, pe


def _record_logits(engine):
    """Keep every logits call of the engine's backend (the first of a request
    is its first token's)."""
    seen, be = [], engine.backend
    inner = be.logits

    def logits(h):
        out = np.asarray(inner(h))
        seen.append(out)
        return out

    be.logits = logits
    return seen


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * np.abs(b).max())


def _cache_state(cache):
    state = {"tiers": cache.tiers}
    for attr in ("_freq", "_score"):  # LFU and IMPRESS frequencies; IMPRESS's static scores
        if hasattr(cache, attr):
            state[attr] = getattr(cache, attr)
    if hasattr(cache, "_last"):  # LRU: the order of last access
        state["lru_order"] = sorted(cache._last, key=cache._last.get)
    return state


@pytest.mark.parametrize("device_cap,host_cap", [(4, 2), (999, 0)])
@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_matches_jax_over_requests(fx, name, device_cap, host_cap):
    """Three requests with two decode tokens each on one engine: later ones
    find earlier units in the cache's tiers. Selections per layer, trace
    counts, greedy tokens and first-token logits per request, and the cache
    after them, equal the JAX engine's."""
    je, pe = _engines(fx, name, device_cap=device_cap, host_cap=host_cap)
    j_logits, p_logits = _record_logits(je), _record_logits(pe)
    rng = np.random.default_rng(1)
    suffixes = [fx["suffix"]] + [rng.integers(0, fx["cfg"].vocab_size, 16) for _ in range(2)]
    for suffix in suffixes:
        n_seen = len(j_logits), len(p_logits)
        _, tj = je.reprefill(suffix, decode_tokens=2)
        _, tp = pe.reprefill(suffix, decode_tokens=2)
        assert sorted(tp.selected_per_layer) == sorted(tj.selected_per_layer)
        for l, sel in tj.selected_per_layer.items():
            np.testing.assert_array_equal(tp.selected_per_layer[l], sel)
        assert {f: getattr(tp, f) for f in TRACE_COUNTS} == {f: getattr(tj, f) for f in TRACE_COUNTS}
        assert tp.read_amplification == tj.read_amplification
        assert tp.decode_tokens_out == tj.decode_tokens_out and len(tp.decode_tokens_out) == 2
        _close(p_logits[n_seen[1]], j_logits[n_seen[0]])
    assert _cache_state(pe.cache) == _cache_state(je.cache)


def test_read_amplification_of_the_baselines(fx):
    """AS-LRU needs every block it loads (1.0); the token baselines load
    whole blocks for a share of their tokens (> 1), and the engine's byte
    counters give sum |blocks| B / sum |tokens| over the layers."""
    _, pe = _engines(fx, "as_lru")
    assert pe.reprefill(fx["suffix"])[1].read_amplification == 1.0
    layout = fx["sessions"]["coarse"][1].store.layout
    for name in ("as_h2o_lfu", "impress"):
        _, pe = _engines(fx, name)
        trace = pe.reprefill(fx["suffix"])[1]
        sel = trace.selected_per_layer.values()
        blocks = sum(len(layout.units_for_tokens(t)) for t in sel)
        expect = blocks * BLOCK / sum(len(t) for t in sel)
        assert trace.read_amplification == pytest.approx(expect, rel=1e-12) and expect > 1


def test_token_scores_match_jax(fx):
    """RealCompute.token_scores at full keys and at IMPRESS's partial keys
    (the first int(d * 0.125) dims, scale d_probe^-0.5) against the JAX
    backend's, on the same queries and probe keys."""
    cfg, pcfg = fx["cfg"], fx["pcfg"]
    jbe, pbe = JaxCompute(cfg, fx["params"]), RealCompute(pcfg, fx["tparams"], device="cpu")
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 16, cfg.n_heads, cfg.d_head)).astype(np.float32)
    probe = fx["sessions"]["coarse"][0].probe[1]
    for ratio in (1.0, 0.125):
        kp = probe[..., : max(1, int(cfg.d_head * ratio))]
        a_jax = jbe.token_scores(jnp.asarray(q), kp, 1)
        a_port = pbe.token_scores(torch.from_numpy(q), kp, 1)
        assert a_port.shape == a_jax.shape == (len(fx["prefix"]),)
        np.testing.assert_allclose(a_port, a_jax, rtol=0, atol=1e-5 * np.abs(a_jax).max())


def test_chunk_scores_from_token_scores_match_jax():
    a = np.random.default_rng(0).random(100).astype(np.float32)
    for c in (1, 16, 32, 100, 128):
        np.testing.assert_allclose(chunk_scores_from_token_scores(torch.from_numpy(a), c).numpy(),
                                   np.asarray(jax_chunk_scores(jnp.asarray(a), c)), rtol=1e-6)


def test_coarse_session_matches_jax(fx):
    jsess, psess = fx["sessions"]["coarse"]
    assert type(psess.store.layout).__name__ == type(jsess.store.layout).__name__
    assert psess.store.layout.unit_tokens == BLOCK
    assert dataclasses.asdict(psess.meta) == dataclasses.asdict(jsess.meta)
    units = list(range(jsess.store.layout.n_units))
    for l in range(fx["cfg"].n_layers):
        got, ref = psess.store.read_units(l, units), jsess.store.read_units(l, units)
        for u in units:
            assert got[u].dtype == np.float16 and got[u].shape == ref[u].shape
            # float16 of near-equal float32 values: equal, or one float16 ulp apart
            np.testing.assert_allclose(got[u].astype(np.float32), ref[u].astype(np.float32),
                                       rtol=1e-3, atol=1e-3)


def test_as_lru_matches_dense_forward(fx):
    """AS-LRU attends to every block: its first-token logits match the dense
    forward over prefix + suffix within the float16 store's quantization (the
    reference test's 3e-2), on a prefix of whole blocks."""
    pcfg, tparams, suffix = fx["pcfg"], fx["tparams"], fx["suffix"]
    prefix = fx["prefix"][:96]
    sess = build_real_session(pcfg, tparams, prefix, coarse_blocks=True, block_tokens=BLOCK,
                              in_memory=True, device="cpu")
    eng = ASLRUEngine(sess, RealCompute(pcfg, tparams, device="cpu"), RealExecutor(),
                      device_cap=99, host_cap=99)
    logits, trace = eng.reprefill(suffix)
    full = np.concatenate([prefix, suffix])
    dense = PT.forward(tparams, {"tokens": torch.as_tensor(full)[None]}, pcfg,
                       block_q=16, logits_positions="last")[0, -1].numpy()
    assert np.max(np.abs(dense - logits[0, -1])) / np.max(np.abs(dense)) < 3e-2
    assert trace.read_amplification == 1.0


def test_wo_prefetch_computes_what_the_full_engine_does(fx):
    """w/o P changes when chunks load, not what is computed: at caps 0 the
    first-token logits equal the full engine's bit for bit, with the same
    selections and no speculative traffic."""
    psess = fx["sessions"]["dense"][1]
    runs = {}
    for prefetch in (True, False):
        eng = ContiguousKVEngine(psess, RealCompute(fx["pcfg"], fx["tparams"], device="cpu"),
                                 RealExecutor(), budget=0.25, period=2, subperiod=1,
                                 prefetch=prefetch)
        runs[prefetch] = eng.reprefill(fx["suffix"])
    (l_full, t_full), (l_wo, t_wo) = runs[True], runs[False]
    np.testing.assert_array_equal(l_wo, l_full)
    for l, sel in t_full.selected_per_layer.items():
        np.testing.assert_array_equal(t_wo.selected_per_layer[l], sel)
    assert t_wo.ssd_bytes_spec == 0 < t_full.ssd_bytes_spec


def test_contiguous_kv_loads_fewer_tokens_than_impress(fx):
    """Table 2: ContiguousKV loads fewer tokens than IMPRESS at the same
    budget (the reference's test_io_reduction_vs_impress)."""
    psess_c, psess_b = fx["sessions"]["dense"][1], fx["sessions"]["coarse"][1]
    mk = lambda: RealCompute(fx["pcfg"], fx["tparams"], device="cpu")  # noqa: E731
    e1 = ContiguousKVEngine(psess_c, mk(), RealExecutor(), budget=0.1, period=2, subperiod=1,
                            inter_period=False)
    e2 = IMPRESSEngine(psess_b, mk(), RealExecutor(), budget=0.1)
    assert e1.reprefill(fx["suffix"])[1].tokens_loaded < e2.reprefill(fx["suffix"])[1].tokens_loaded


def test_core_exports_the_four_engines():
    assert [getattr(core, n) for n in core.ENGINES] == [
        ContiguousKVEngine, ASLRUEngine, ASH2OEngine, IMPRESSEngine]
