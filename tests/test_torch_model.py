"""The port's configs, bridge and dense model against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. float32
configs are held to float32 rounding (the two frameworks sum in different
orders); bfloat16 configs to a few bfloat16 ulps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.configs import reduced_config as jax_reduced_config
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import (ASSIGNED, get_config, list_configs, reduced_config,
                                 resolve_config_name)
from repro_torch.models import transformer as PT

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NAMES = ["qwen2.5-7b", "qwen2.5-14b", "qwen2.5-32b", "hymba-1.5b", "falcon-mamba-7b",
         "gemma3-4b", "granite-moe-3b-a800m", "internvl2-76b", "mixtral-8x22b",
         "musicgen-large", "qwen3-1.7b", "yi-34b"]


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _pair(name, dtype, **overrides):
    cfg = dataclasses.replace(jax_reduced_config(name, **overrides), dtype=dtype)
    pcfg = dataclasses.replace(reduced_config(name, **overrides), dtype=dtype)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    # non-zero biases and norm scales, so the test exercises them
    rng = np.random.default_rng(1)
    for key in ("bq", "bk", "bv", "attn_norm", "ffn_norm"):
        leaf = params["layers"][key]
        params["layers"][key] = jnp.asarray(
            0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
    return cfg, pcfg, params, bridge.params_from_numpy(_np_tree(params), "cpu")


@pytest.mark.parametrize("name", NAMES)
def test_config_fields_equal(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jax_get_config(name))
    for kw in ({}, {"n_layers": 4}):
        assert (dataclasses.asdict(reduced_config(name, **kw))
                == dataclasses.asdict(jax_reduced_config(name, **kw)))


def test_config_registry():
    assert list_configs() == sorted(NAMES) == jax_list_configs()
    assert ASSIGNED == JAX_ASSIGNED
    assert resolve_config_name("qwen2_5_7b") == "qwen2.5-7b"
    assert get_config("qwen2.5-7b").activation_dtype() is torch.bfloat16
    with pytest.raises(KeyError):
        resolve_config_name("no-such-model")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridged_params_equal(dtype):
    cfg, pcfg, params, tparams = _pair("qwen2.5-7b", dtype)
    flat_j = jax.tree_util.tree_flatten_with_path(_np_tree(params))[0]
    assert len(flat_j) == sum(1 for _ in _leaves(tparams))
    for path, leaf in flat_j:
        t = tparams
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == leaf.dtype.name, path
        np.testing.assert_array_equal(t.to(torch.float32).numpy(), leaf.astype(np.float32))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_structure_matches_jax(dtype):
    cfg = dataclasses.replace(jax_reduced_config("qwen2.5-14b"), dtype=dtype)
    pcfg = dataclasses.replace(reduced_config("qwen2.5-14b"), dtype=dtype)
    jp = _np_tree(JT.init_params(jax.random.PRNGKey(0), cfg))
    tp = PT.init_params(pcfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, tp))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            jax.tree_util.tree_leaves(tp)):
        assert tuple(b.shape) == a.shape and b.dtype == pcfg.activation_dtype(), path
        # same scale: the init std of each weight matrix agrees within sampling noise
        if a.ndim >= 3:
            sa, sb = float(a.astype(np.float32).std()), float(b.float().std())
            assert abs(sa - sb) <= 0.1 * sa, path


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("qwen2.5-7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.tensor_from_numpy(np.zeros(3, np.float32))


# float32: both sides run the same float32 arithmetic in another order;
# bfloat16: every op rounds to 8 mantissa bits, and XLA fuses elementwise ops
# (skipping intermediate roundings) where torch rounds after each one.
TOL = {"float32": dict(rtol=1e-5, atol=2e-5), "bfloat16": dict(rtol=0.05, atol=0.1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["qwen2.5-7b", "qwen2.5-14b"])
def test_forward_logits_and_kv_match_jax(name, dtype):
    cfg, pcfg, params, tparams = _pair(name, dtype, n_layers=3)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 40))
    lj, (kj, vj) = JT.forward(params, {"tokens": jnp.asarray(toks)}, cfg,
                              block_q=16, return_kv=True)
    lt, (kt, vt) = PT.forward(tparams, {"tokens": torch.as_tensor(toks)}, pcfg,
                              block_q=16, return_kv=True)
    assert lt.dtype == torch.float32 and kt.dtype == pcfg.activation_dtype()
    assert tuple(kt.shape) == kj.shape and tuple(lt.shape) == lj.shape
    for a, b in ((lj, lt), (kj, kt), (vj, vt)):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), **TOL[dtype])
    last = PT.forward(tparams, {"tokens": torch.as_tensor(toks)}, pcfg, block_q=16,
                      logits_positions="last")
    torch.testing.assert_close(last, lt[:, -1:])
