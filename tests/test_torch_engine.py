"""The port's Re-Prefill engine against the JAX package's, on the CPU.

Reduced float32 Qwen2.5-7B (4 layers, period 2): the two engines must select
the same chunks per layer and decode the same greedy tokens. Their logits
differ by float32 rounding, plus the rare float16 store value that rounds to
the neighbouring float16 because the two ingest forwards differ in the last
float32 bit; 1e-3 of the logits' scale covers that.
"""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core import ContiguousKVEngine as JaxEngine
from repro.core import build_real_session as jax_build_session
from repro.core.backends import RealCompute as JaxCompute
from repro.models import transformer as JT
from repro.storage.timing import RealExecutor as JaxExecutor
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core.backends import RealCompute
from repro_torch.core.engine import ContiguousKVEngine
from repro_torch.core.session import build_real_session
from repro_torch.models import transformer as PT
from repro_torch.storage.timing import RealExecutor

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _setup(dtype):
    cfg = dataclasses.replace(jax_reduced_config("qwen2.5-7b", n_layers=4), dtype=dtype)
    pcfg = dataclasses.replace(reduced_config("qwen2.5-7b", n_layers=4), dtype=dtype)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 100)  # 100 % 16 != 0: a partial last chunk
    suffix = rng.integers(0, cfg.vocab_size, 16)
    return cfg, pcfg, params, tparams, prefix, suffix


@pytest.fixture(scope="module")
def fp32():
    cfg, pcfg, params, tparams, prefix, suffix = _setup("float32")
    jsess = jax_build_session(cfg, params, prefix, in_memory=True)
    psess = build_real_session(pcfg, tparams, prefix, in_memory=True, device="cpu")
    return cfg, pcfg, params, tparams, prefix, suffix, jsess, psess


def _engines(fx, budget, **kw):
    cfg, pcfg, params, tparams, _, _, jsess, psess = fx
    je = JaxEngine(jsess, JaxCompute(cfg, params), JaxExecutor(), budget=budget,
                   period=2, subperiod=1, **kw)
    pe = ContiguousKVEngine(psess, RealCompute(pcfg, tparams, device="cpu"),
                            RealExecutor(), budget=budget, period=2, subperiod=1, **kw)
    return je, pe


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * np.abs(b).max())


def test_ingest_matches_jax(fp32):
    *_, jsess, psess = fp32
    assert psess.prefix_len == jsess.prefix_len
    assert dataclasses.asdict(psess.meta) == dataclasses.asdict(jsess.meta)
    assert psess.probe.dtype == np.float16 and psess.probe.shape == jsess.probe.shape
    # float16 of near-equal float32 values: equal, or one float16 ulp apart
    np.testing.assert_allclose(psess.probe.astype(np.float32), jsess.probe.astype(np.float32),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("budget", [0.1, 0.25, 0.5])
def test_reprefill_matches_jax(fp32, budget):
    je, pe = _engines(fp32, budget)
    suffix = fp32[5]
    lj, tj = je.reprefill(suffix)
    lp, tp = pe.reprefill(suffix)
    assert tp.read_amplification == pytest.approx(1.0) == tj.read_amplification
    assert sorted(tp.selected_per_layer) == sorted(tj.selected_per_layer)
    for l, sel in tj.selected_per_layer.items():
        np.testing.assert_array_equal(tp.selected_per_layer[l], sel)
    assert lp.dtype == np.float32 and lp.shape == lj.shape
    _close(lp, lj)
    je, pe = _engines(fp32, budget)
    _, tj = je.reprefill(suffix, decode_tokens=8)
    _, tp = pe.reprefill(suffix, decode_tokens=8)
    assert len(tp.decode_tokens_out) == 8
    assert tp.decode_tokens_out == tj.decode_tokens_out


def test_full_budget_matches_dense_forward(fp32):
    """A 96-token prefix (whole chunks): with a partial last chunk both
    engines also attend to its zero padding, as the JAX engine does."""
    cfg, pcfg, params, tparams, prefix, suffix, _, _ = fp32
    prefix = prefix[:96]
    psess = build_real_session(pcfg, tparams, prefix, in_memory=True, device="cpu")
    pe = ContiguousKVEngine(psess, RealCompute(pcfg, tparams, device="cpu"), RealExecutor(),
                            budget=1.0, period=2, subperiod=1, device_cap=999, host_cap=999)
    logits, trace = pe.reprefill(suffix)
    full = np.concatenate([prefix, suffix])
    dense = PT.forward(tparams, {"tokens": torch.as_tensor(full)[None]}, pcfg,
                       block_q=16, logits_positions="last")[0, -1].numpy()
    err = np.max(np.abs(dense - logits[0, -1])) / np.max(np.abs(dense))
    assert err < 3e-2  # float16 store quantization, as tests/test_engine.py allows
    assert trace.read_amplification == pytest.approx(1.0)
    jsess = jax_build_session(cfg, params, prefix, in_memory=True)
    je = JaxEngine(jsess, JaxCompute(cfg, params), JaxExecutor(), budget=1.0,
                   period=2, subperiod=1, device_cap=999, host_cap=999)
    _close(logits, je.reprefill(suffix)[0])


TRACE_COUNTS = ("hits_device", "hits_host", "misses", "ssd_bytes", "ssd_bytes_demand",
                "ssd_bytes_spec", "ssd_bytes_probe", "ssd_requests", "pcie_bytes",
                "needed_bytes", "tokens_loaded")


@pytest.mark.parametrize("device_cap,host_cap", [(4, 2), (999, 0)])
def test_cache_tiers_across_requests_match_jax(fp32, device_cap, host_cap):
    """Three requests on one engine: later ones find earlier chunks in the
    attention-guided cache (device or host tier). Hits, misses and bytes per
    request, and the cache's tiers and frequencies after them, equal the JAX
    engine's; the importance scores agree to float32 rounding."""
    je, pe = _engines(fp32, 0.25, device_cap=device_cap, host_cap=host_cap)
    rng = np.random.default_rng(1)
    suffixes = [fp32[5]] + [rng.integers(0, fp32[0].vocab_size, 16) for _ in range(2)]
    for suffix in suffixes:
        _, tj = je.reprefill(suffix, decode_tokens=2)
        _, tp = pe.reprefill(suffix, decode_tokens=2)
        assert {f: getattr(tp, f) for f in TRACE_COUNTS} == {f: getattr(tj, f) for f in TRACE_COUNTS}
        assert tp.decode_tokens_out == tj.decode_tokens_out
    assert pe.cache.tiers == je.cache.tiers and pe.cache.F == je.cache.F
    keys = sorted(je.cache.I)
    assert sorted(pe.cache.I) == keys
    np.testing.assert_allclose([pe.cache.I[k] for k in keys], [je.cache.I[k] for k in keys],
                               rtol=1e-4)


def test_engine_runs_real_mode_only(fp32):
    """The executor sets the mode: a RealExecutor engine runs real mode
    only, and a ChannelSim one is a sim engine whose plan runs no model."""
    from repro_torch.core.backends import SimCompute
    from repro_torch.core.session import SyntheticWorkload, build_sim_session
    from repro_torch.storage.timing import ChannelSim, DeviceModel, SimExecutor

    _, pcfg, _, tparams, *_, psess = fp32
    real = ContiguousKVEngine(psess, RealCompute(pcfg, tparams, device="cpu"), RealExecutor())
    assert real.sim is False
    sess = build_sim_session(pcfg, 100)
    sim = ContiguousKVEngine(sess, SimCompute(pcfg, SyntheticWorkload(100, pcfg.n_layers)),
                             SimExecutor(DeviceModel()), period=2, subperiod=1)
    assert sim.sim is True and isinstance(sim.ex, ChannelSim)
    logits, trace = sim.reprefill(np.zeros(16, np.int64), decode_tokens=2)
    assert logits is None and trace.ttft > 0 and len(trace.decode_times) == 2


def test_host_pool_decodes_like_device_pool(fp32):
    _, pe_dev = _engines(fp32, 0.25)
    _, pe_host = _engines(fp32, 0.25, device_tail_pool=False)
    _, t_dev = pe_dev.reprefill(fp32[5], decode_tokens=4)
    _, t_host = pe_host.reprefill(fp32[5], decode_tokens=4)
    assert t_dev.decode_tokens_out == t_host.decode_tokens_out


def test_hidden_state_dtypes_follow_jax():
    """bfloat16 model: jnp promotes float16 chunks with bfloat16 suffix KV to
    float32, so part B of layer 0 leaves a float32 hidden state and layer 1's
    q/k/v are float32; decode restarts from a bfloat16 embedding and stays
    bfloat16. The port must cast where jnp promotes."""
    cfg, pcfg, params, tparams, prefix, suffix = _setup("bfloat16")
    jbe, pbe = JaxCompute(cfg, params), RealCompute(pcfg, tparams, device="cpu")
    rng = np.random.default_rng(3)
    nb, c = 8, 16
    k_sel = rng.standard_normal((nb, c, cfg.n_kv_heads, cfg.d_head)).astype(np.float16)
    v_sel = rng.standard_normal(k_sel.shape).astype(np.float16)
    valid = np.arange(nb) < 5
    name = lambda t: str(t.dtype).removeprefix("torch.")
    hj, hp = jbe.embed(suffix), pbe.embed(suffix)
    seen = []
    for layer in (0, 1):
        _, qj, kj, vj = jbe.part_a(layer, hj, len(prefix))
        _, qp, kp, vp = pbe.part_a(layer, hp, len(prefix))
        assert name(qp) == qj.dtype.name and name(kp) == kj.dtype.name
        hj, mj = jbe.part_b(layer, hj, qj, kj, vj, k_sel, v_sel, valid, c)
        hp, mp = pbe.part_b(layer, hp, qp, kp, vp, k_sel, v_sel, valid, c)
        assert name(hp) == hj.dtype.name
        seen.append((name(qp), name(hp)))
        np.testing.assert_allclose(mp, mj, rtol=0.05, atol=1e-3)
    assert seen == [("bfloat16", "float32"), ("float32", "float32")]
    # decode: one token through layer 0 over a pool holding only that token
    from repro_torch.core.backends import DeviceTailPool
    h = pbe.embed(np.array([7]))
    _, q, k, v = pbe.part_a_at(0, h, [[len(prefix) + len(suffix)]])
    pool = DeviceTailPool(np.zeros((0, c, pcfg.n_kv_heads, pcfg.d_head), np.float16),
                          np.zeros((0, c, pcfg.n_kv_heads, pcfg.d_head), np.float16),
                          None, c, 1, dtype=q.dtype, device="cpu")
    pool.append(k, v)
    h, _ = pbe.decode_attend(0, h, q, pool)
    assert (name(q), pool.k.dtype, name(h)) == ("bfloat16", torch.bfloat16, "bfloat16")


# -- isolation: the port runs with neither jax nor repro importable ---------
_ISOLATED = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np, torch
from repro_torch.configs import reduced_config
from repro_torch.core.backends import RealCompute
from repro_torch.core.engine import ContiguousKVEngine
from repro_torch.core.session import build_real_session
from repro_torch.models.transformer import init_params
from repro_torch.storage.timing import RealExecutor
cfg = reduced_config("qwen2.5-7b")
params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
rng = np.random.default_rng(0)
sess = build_real_session(cfg, params, rng.integers(0, 256, 48), in_memory=True, device="cpu")
eng = ContiguousKVEngine(sess, RealCompute(cfg, params, device="cpu"), RealExecutor(),
                         budget=0.5, period=1, subperiod=1)
logits, trace = eng.reprefill(rng.integers(0, 256, 8), decode_tokens=2)
assert np.isfinite(logits).all() and len(trace.decode_tokens_out) == 2
import repro_torch.models.ssm, repro_torch.kernels.flash_attention.ops
import repro_torch.kernels.selective_scan.ops
from repro_torch.core.backends import StateCompute, StatePool
from repro_torch.core.engine import StateSpaceEngine
for name in ("hymba-1.5b", "falcon-mamba-7b"):
    cfg = reduced_config(name)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = StateSpaceEngine(cfg, StateCompute(cfg, params, device="cpu"), RealExecutor(),
                           prefix_tokens=rng.integers(0, 256, 20))
    logits, trace = eng.reprefill(rng.integers(0, 256, 4), decode_tokens=2)
    assert np.isfinite(logits).all() and len(trace.decode_tokens_out) == 2
import repro_torch.serving, repro_torch.launch.serve, repro_torch.storage.h2d_meter
import repro_torch.data.synthetic
from repro_torch.serving import Request, Scheduler
cfg = reduced_config("qwen2.5-7b")
params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
sess = build_real_session(cfg, params, rng.integers(0, 256, 48), in_memory=True, device="cpu")
eng = ContiguousKVEngine(sess, RealCompute(cfg, params, device="cpu"), RealExecutor(),
                         budget=0.5, period=1, subperiod=1)
done = Scheduler(eng, max_concurrency=2).run(
    [Request(request_id=i, suffix=rng.integers(0, 256, 8), decode_tokens=2) for i in range(2)])
assert [len(c.trace.decode_tokens_out) for c in done] == [2, 2]
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
               if sys.modules[m] is not None)
print("ISOLATED-OK")
"""


def test_port_runs_without_jax_or_repro():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", _ISOLATED], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "ISOLATED-OK" in res.stdout


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_module_of_the_port_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {mod}"
