"""The port's state-space engine against the JAX package's, on the CPU.

Reduced float32 hymba-1.5b (hybrid) and falcon-mamba-7b (ssm): the port's
``StateSpaceEngine`` over ``StateCompute`` and the JAX one over its
``StateCompute`` (whose decode runs the Pallas selective_scan, interpreted)
serve the same prefix + suffix and must decode the same greedy tokens. The
JAX prefill scans chunk by chunk with an associative scan where the port
runs the recurrence step by step, so first-token logits and prefill states
differ by float32 re-association: 1e-4 of their scale.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core.backends import StateCompute as JaxStateCompute
from repro.core.engine import StateSpaceEngine as JaxStateSpaceEngine
from repro.models import transformer as JT
from repro.storage.timing import RealExecutor as JaxExecutor
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core import costmodel as CM
from repro_torch.core.backends import RealCompute, StateCompute, StatePool, TailPool
from repro_torch.core.engine import StateSpaceEngine
from repro_torch.storage.timing import ChannelSim, DeviceModel, RealExecutor

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NAMES = ["hymba-1.5b", "falcon-mamba-7b"]


def _setup(name):
    cfg = dataclasses.replace(jax_reduced_config(name, n_layers=3), dtype="float32")
    pcfg = dataclasses.replace(reduced_config(name, n_layers=3), dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 45)
    suffix = rng.integers(0, cfg.vocab_size, 11)
    return cfg, pcfg, params, tparams, prefix, suffix


def _scale_tol(ref):
    return dict(rtol=0, atol=1e-4 * float(np.abs(np.asarray(ref, np.float32)).max()))


@pytest.mark.parametrize("name", NAMES)
def test_state_engine_matches_jax(name):
    cfg, pcfg, params, tparams, prefix, suffix = _setup(name)
    lj, tj = JaxStateSpaceEngine(cfg, JaxStateCompute(cfg, params), JaxExecutor(),
                                 prefix_tokens=prefix).reprefill(suffix, decode_tokens=8)
    be = StateCompute(pcfg, tparams, device="cpu")
    lt, tt = StateSpaceEngine(pcfg, be, RealExecutor(), prefix_tokens=prefix).reprefill(
        suffix, decode_tokens=8)
    assert tt.decode_tokens_out == tj.decode_tokens_out and len(tt.decode_tokens_out) == 8
    np.testing.assert_allclose(lt, np.asarray(lj), **_scale_tol(lj))
    assert tt.system == tj.system == "state_space"
    assert set(tt.stages) == set(tj.stages) == {"ssm_prefill"}
    assert tt.n_decoded == 8 and tt.ttft > 0 and tt.first_token_at >= tt.ttft
    # first-token logits and the prefill state, through the backends
    toks = np.concatenate([prefix, suffix])
    l0j, pool_j = JaxStateCompute(cfg, params).prefill(toks, extra_tokens=3)
    l0t, pool_t = be.prefill(toks, extra_tokens=3)
    np.testing.assert_allclose(l0t, np.asarray(l0j), **_scale_tol(l0j))
    assert pool_t.valid_tokens == pool_j.valid_tokens == len(toks)
    # the JAX pytree also holds the int32 length; the port keeps it as an int
    assert pool_t.nbytes == pool_j.nbytes - np.asarray(pool_j.state["length"]).nbytes
    for key, ref in pool_j.state.items():
        if key != "length":
            np.testing.assert_allclose(pool_t.state[key].numpy(), np.asarray(ref),
                                       **_scale_tol(ref))


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_advances_the_pool_in_place(name):
    _, pcfg, _, tparams, prefix, _ = _setup(name)
    be = StateCompute(pcfg, tparams, device="cpu")
    logits, pool = be.prefill(prefix, extra_tokens=2)
    assert isinstance(pool, StatePool) and not pool.is_device and pool.is_resident
    nbytes, h = pool.nbytes, pool.state["ssm_h"]
    lg, state = be.decode_step(int(np.argmax(logits[0, -1])), pool.state)
    assert state is pool.state and state["ssm_h"] is h  # the same buffers, rewritten
    assert pool.valid_tokens == len(prefix) + 1 and pool.nbytes == nbytes
    assert lg.shape == (1, 1, pcfg.vocab_size) and np.isfinite(lg).all()


def test_state_engine_plan_prices_ops_like_jax():
    """The plan's ops carry the JAX engine's costs, tags and phases."""
    cfg, pcfg, params, tparams, prefix, suffix = _setup("hymba-1.5b")
    plan = StateSpaceEngine(pcfg, StateCompute(pcfg, tparams, device="cpu"), RealExecutor(),
                            prefix_tokens=prefix).plan(suffix, decode_tokens=2)
    op = plan.gen.send(None)
    total = len(prefix) + len(suffix)
    cost = CM.ssm_prefill_cost(pcfg, total, attended_tokens=total)
    assert (op.tag, op.phase, op.tokens, op.flops, op.hbm_bytes) == (
        "ssm_prefill", "prefill", total, cost.flops, cost.hbm_bytes)
    op = plan.gen.send(op.fn())
    cost = CM.ssm_decode_cost(pcfg, [total + 1] * pcfg.n_layers)
    assert (op.tag, op.phase, op.tokens, op.flops) == ("decode", "decode", 1, cost.flops)


def test_state_engine_runs_real_mode_only():
    _, pcfg, _, tparams, prefix, _ = _setup("falcon-mamba-7b")
    be = StateCompute(pcfg, tparams, device="cpu")
    assert StateSpaceEngine(pcfg, be, RealExecutor(), prefix_tokens=prefix).sim is False
    # over a ChannelSim the engine is a sim engine: its ops run nothing
    sim = StateSpaceEngine(pcfg, be, ChannelSim(DeviceModel()), prefix_tokens=prefix)
    plan = sim.plan(np.zeros(4, np.int32), decode_tokens=1)
    ops = [plan.gen.send(None), plan.gen.send(None)]  # the prefill, one decode step
    assert sim.sim and all(op.fn is None for op in ops)
    dense = reduced_config("qwen2.5-7b")
    with pytest.raises(ValueError):
        StateSpaceEngine(dense, be, RealExecutor())
    with pytest.raises(ValueError):
        StateCompute(dense, tparams, device="cpu")
    with pytest.raises(ValueError):  # attention-free: no KV for Re-Prefill
        RealCompute(pcfg, tparams, device="cpu")


def test_constructors_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pcfg, _, tparams, _, _ = _setup("hymba-1.5b")
    z = np.zeros((0, 16, 1, 16), np.float16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TailPool(z, z, None, 16, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StateCompute(pcfg, tparams)
    assert TailPool(z, z, None, 16, 4, device="cpu").device.type == "cpu"
