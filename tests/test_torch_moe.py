"""The port's MoE FFN and MoE family against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages in
float32. The routing (top-k ids, the (expert, slot) gather table, which
assignments are kept and which dropped at capacity) must be equal; outputs
within 1e-6 of their largest (the per-expert products and the router's
logits sum in other orders; the combine adds each token's kept
contributions in the reference's order, ascending expert, at every top_k).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT

torch.backends.cuda.matmul.allow_tf32 = False

REL = 1e-6


def _inputs(seed, T, d, E, f):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T // 2, d)).astype(np.float32)
    p = {"w_router": rng.standard_normal((d, E)) * d ** -0.5,
         "w_gate": rng.standard_normal((E, d, f)) * d ** -0.5,
         "w_up": rng.standard_normal((E, d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((E, f, d)) * f ** -0.5}
    return x, {k: v.astype(np.float32) for k, v in p.items()}


def _jax_table(x, p, E, k, cap):
    """The reference's routing, step for step (src/repro/models/moe.py)."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    T = xt.shape[0]
    top_idx, _ = JM._router(xt, jnp.asarray(p["w_router"]), k)
    flat_expert = top_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_expert, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    keep = pos < cap
    slot = jnp.where(keep, flat_expert * cap + pos, E * cap)
    table = jnp.full((E * cap + 1,), T, jnp.int32)
    table = table.at[slot].set(jnp.repeat(jnp.arange(T, dtype=jnp.int32), k), mode="drop")
    return (np.asarray(top_idx), np.asarray(keep),
            np.asarray(table[: E * cap].reshape(E, cap)))


@pytest.mark.parametrize("top_k,E,cf,dropless", [
    (1, 4, 0.5, False), (2, 8, 0.5, False), (8, 40, 0.5, False),   # tokens overflow
    (8, 40, 1.25, False),                                          # granite's own factor
    (1, 4, 1.0, True), (2, 8, 0.5, True), (8, 40, 0.5, True),      # dropless: cap = T
])
def test_moe_ffn_matches_jax(top_k, E, cf, dropless):
    T, d, f = 96, 32, 16
    x, p = _inputs(top_k * 100 + E, T, d, E, f)
    want = np.asarray(JM.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                                 n_experts=E, top_k=top_k, capacity_factor=cf,
                                 dropless=dropless))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = PM.moe_ffn(torch.from_numpy(x), tp, n_experts=E, top_k=top_k, capacity_factor=cf,
                     dropless=dropless).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())

    cap = PM.capacity(T, E, top_k, cf, dropless)
    j_idx, j_keep, j_table = _jax_table(x, p, E, top_k, cap)
    p_idx, _ = PM._router(torch.from_numpy(x).reshape(T, d), tp["w_router"], top_k)
    slot, keep, table = PM.dispatch(p_idx, cap, E)
    np.testing.assert_array_equal(p_idx.numpy(), j_idx)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    np.testing.assert_array_equal(table.numpy(), j_table)
    assert dropless == bool(j_keep.all())
    if not dropless:
        assert not j_keep.all()  # the case drops assignments
    # a token every one of whose experts was full gets nothing: its FFN
    # output is exactly 0 in both, and it keeps its residual
    none_kept = ~j_keep.reshape(T, top_k).any(axis=1)
    zero = np.all(got.reshape(T, d) == 0, axis=1)
    np.testing.assert_array_equal(zero, np.all(want.reshape(T, d) == 0, axis=1))
    np.testing.assert_array_equal(zero, none_kept)


def test_capacity_matches_the_reference_formula():
    for T, E, k, cf in [(96, 4, 1, 0.5), (4096, 40, 8, 1.25), (3, 8, 2, 0.1), (64, 8, 2, 4.0)]:
        cap = max(1, int(-(-T * k * cf // E)))
        assert PM.capacity(T, E, k, cf, False) == min(cap, T)
        assert PM.capacity(T, E, k, cf, True) == T


def test_combine_is_reproducible_and_logs_drops():
    x, p = _inputs(7, 96, 32, 40, 16)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    PM.drop_log = []
    try:
        a = PM.moe_ffn(torch.from_numpy(x), tp, n_experts=40, top_k=8, capacity_factor=0.5)
        b = PM.moe_ffn(torch.from_numpy(x), tp, n_experts=40, top_k=8, capacity_factor=0.5)
        drops = [int(t) for t in PM.drop_log]
    finally:
        PM.drop_log = None
    assert torch.equal(a, b)
    _, keep, _ = _jax_table(x, p, 40, 8, PM.capacity(96, 40, 8, 0.5, False))
    assert drops == [int((~keep).sum())] * 2 and drops[0] > 0


def test_init_moe_params_structure_matches_jax():
    cfg = reduced_config("granite-moe-3b-a800m")
    jp = JT.init_params(jax.random.PRNGKey(0), jax_reduced_config("granite-moe-3b-a800m"))
    tp = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for key, leaf in jp["layers"]["moe"].items():
        t = tp["layers"]["moe"][key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16, key
        sa, sb = float(np.asarray(leaf, np.float32).std()), float(t.float().std())
        assert abs(sa - sb) <= 0.1 * sa, key
    assert tuple(tp["layers"]["ffn_norm"].shape) == jp["layers"]["ffn_norm"].shape
    assert "w_gate" not in tp["layers"]


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "mixtral-8x22b"])
def test_moe_forward_drops_where_jax_drops(name):
    """A reduced MoE model at capacity factor 0.5 (the forward drops) and at
    E / k (dropless by the config's own rule): forward logits within float32
    rounding of the JAX forward, and the same greedy tokens."""
    for cf in (0.5, 2.0):  # reduced: 4 experts, top 2
        cfg = dataclasses.replace(jax_reduced_config(name), dtype="float32",
                                  moe_capacity_factor=cf)
        pcfg = dataclasses.replace(reduced_config(name), dtype="float32",
                                   moe_capacity_factor=cf)
        params = JT.init_params(jax.random.PRNGKey(3), cfg)
        tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
        toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24))
        want = np.asarray(JT.forward(params, {"tokens": jnp.asarray(toks)}, cfg, block_q=8))
        got = PT.forward(tparams, {"tokens": torch.as_tensor(toks)}, pcfg, block_q=8).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_full_config_prices_active_experts():
    cfg = get_config("granite-moe-3b-a800m")
    assert (cfg.n_experts, cfg.top_k, cfg.moe_d_ff, cfg.d_ff) == (40, 8, 512, 0)
    assert cfg.active_param_count() < cfg.param_count() / 2
