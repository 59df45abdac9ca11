"""The port's training path against the JAX package's, on the CPU.

Same weights (``bridge``) and numpy-seeded batches through both packages,
float32 reduced configs. Limits, each against the largest element of the
JAX side's tensor:
- the loss within 1e-6 relative and every gradient leaf within 1e-5 (the
  same float32 math summed in other orders: measured ~1e-7 and ~2e-6);
- params and AdamW moments after each of 3 train steps within 1e-5, but for
  the few elements whose Adam step or int8 level rounding can move
  (``test_train_steps_match_jax`` states their limits);
- the port's own invariants (remat, grad accumulation, int8) as
  ``tests/test_train.py`` states them for the JAX package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.launch import steps as JS
from repro.models import common as JC
from repro.models import transformer as JT
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.launch import steps as PS
from repro_torch.launch import train as ptrain
from repro_torch.models import common as PC
from repro_torch.models import transformer as PT
from repro_torch.train.compression import quantize_dequantize
from repro_torch.train.optimizer import adamw_init, adamw_update, global_norm
from repro_torch.tree import path_key, tree_flatten_with_path, tree_leaves, tree_map

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FAMILIES = ["qwen3-1.7b", "gemma3-4b", "granite-moe-3b-a800m", "falcon-mamba-7b", "hymba-1.5b",
            "musicgen-large"]


def _pair(name, dtype="float32", **overrides):
    cfg = dataclasses.replace(jax_reduced_config(name, **overrides), dtype=dtype)
    pcfg = dataclasses.replace(reduced_config(name, **overrides), dtype=dtype)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, pcfg, params, bridge.params_from_numpy(_np(params), "cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(vocab, b=4, s=32, seed=1, mask=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}
    if mask:
        batch["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return batch


def _family_batch(cfg, seed=1):
    """``_batch`` for a token family; for a frontend family (musicgen's
    EnCodec frames) numpy frame embeddings in place of the tokens, which
    both packages' loss_fn take as ``{"embeds": (b, s, d_model)}``."""
    batch = _batch(cfg.vocab_size, seed=seed)
    if cfg.frontend:
        tokens = batch.pop("tokens")
        batch["embeds"] = np.random.default_rng(seed + 100).standard_normal(
            tokens.shape + (cfg.d_model,)).astype(np.float32)
    return batch


def _jax_flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_trees(port_tree, jax_tree, rel, outliers=0.0, loose=None, atol=0.0):
    """Every leaf within ``rel`` of its largest JAX element (plus ``atol``),
    but for at most a share ``outliers`` of its elements, which must lie
    within ``loose``."""
    want = _jax_flat(jax_tree)
    got = {path_key(p): x for p, x in tree_flatten_with_path(bridge.tree_to_numpy(port_tree))}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].astype(np.float32)
        err = np.abs(g - w.astype(np.float32))
        off = err > rel * max(np.abs(w).max(), 1e-30) + atol
        assert off.mean() <= outliers, (k, err.max(), np.abs(w).max(), off.mean())
        if off.any():
            assert err.max() <= loose, (k, err.max(), loose)


def _grads(pcfg, tparams, batch, **kw):
    return PS.make_value_and_grad(pcfg, **kw)(tparams, batch)


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_jax(name):
    """musicgen-large trains on frame embeddings: its token embedding is not
    read, and both packages give it zero gradients."""
    cfg, pcfg, params, tparams = _pair(name)
    batch = _family_batch(cfg)
    jl, jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jax.tree_util.tree_map(jnp.asarray, batch), cfg))(params)
    pl, pg = _grads(pcfg, tparams, batch, remat=False)
    assert abs(pl.item() - float(jl)) <= 1e-6 * abs(float(jl))
    _close_trees(pg, jg, 1e-5)


def test_loss_mask_matches_jax():
    cfg, pcfg, params, tparams = _pair("qwen3-1.7b")
    batch = _batch(cfg.vocab_size, mask=True)
    jl, jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jax.tree_util.tree_map(jnp.asarray, batch), cfg))(params)
    pl, pg = _grads(pcfg, tparams, batch, remat=False)
    assert abs(pl.item() - float(jl)) <= 1e-6 * abs(float(jl))
    _close_trees(pg, jg, 1e-5)


@pytest.mark.parametrize("remat", [True, "dots"])
@pytest.mark.parametrize("name", ["qwen3-1.7b", "hymba-1.5b"])
def test_remat_matches_no_remat(name, remat):
    """Recomputing a layer repeats the same float32 ops: the same bits."""
    cfg, pcfg, _, tparams = _pair(name)
    batch = _batch(cfg.vocab_size)
    l0, g0 = _grads(pcfg, tparams, batch, remat=False)
    l1, g1 = _grads(pcfg, tparams, batch, remat=remat)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("grad_accum,compression", [(1, None), (2, None), (1, "int8")])
def test_train_steps_match_jax(grad_accum, compression):
    """Three steps of make_train_step: params and moments after each.

    Adam's first steps move an element by lr * g / (|g| + eps), so the
    gradients' float32 differences (~1e-5 relative) reach the params as
    ~1e-5 lr a step: params may also differ by 1e-4 lr a step, which is what
    decides for the norm scales, zeros before the first step. Where |g| is
    near eps, rounding of g moves the step by up to lr, so a few elements
    (measured: 1 of 8192 in wq) may differ by up to 2 lr a step.
    Under int8 compression a gradient element on a rounding edge takes the
    next level, 1/127 of its leaf's largest gradient, which moves its first
    moment by about 1e-2 of the largest; at most 1 % of a leaf may do so."""
    cfg, pcfg, params, tparams = _pair("qwen3-1.7b")
    batch = _batch(cfg.vocab_size, seed=2)
    lr = 1e-3
    kw = dict(grad_accum=grad_accum, remat=False, lr=lr, grad_compression=compression)
    jstep = jax.jit(JS.make_train_step(cfg, **kw))
    pstep = PS.make_train_step(pcfg, **kw)
    jopt = jax_adamw_init(params)
    popt = bridge.opt_state_from_numpy(_np(jopt), "cpu")
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    for t in range(3):
        params, jopt, jm = jstep(params, jopt, jbatch)
        tparams, popt, pm = pstep(tparams, popt, batch)
        assert abs(pm["loss"].item() - float(jm["loss"])) <= 1e-6 * abs(float(jm["loss"]))
        assert int(popt["step"]) == int(jopt["step"])
        assert popt["step"].dtype == torch.int32 and popt["step"].dim() == 0
        _close_trees(tparams, params, 1e-5, outliers=1e-3, loose=2 * lr * (t + 1),
                     atol=1e-4 * lr * (t + 1))
        for key in ("m", "v"):
            want = _jax_flat(jopt[key])
            _close_trees(popt[key], jopt[key], 1e-5, outliers=1e-2,
                         loose=1e-2 * max(np.abs(w).max() for w in want.values()))


def test_counts_match_jax():
    for name, dtype in (("qwen3-1.7b", "bfloat16"), ("granite-moe-3b-a800m", "float32"),
                        ("hymba-1.5b", "bfloat16")):
        _, _, params, tparams = _pair(name, dtype)
        assert PC.count_params(tparams) == JC.count_params(params)
        assert PC.param_bytes(tparams) == JC.param_bytes(params)
        opt = adamw_init(tparams)
        assert PC.param_bytes(opt) == JC.param_bytes(jax_adamw_init(params))


@pytest.mark.parametrize("chunk", [1, 40, 1000])
def test_adamw_update_by_slices_is_bit_for_bit(monkeypatch, chunk):
    """A leaf updated a slice of its leading dim at a time (the large leaves'
    path) gives the same bits as the whole leaf at once: params, moments."""
    from repro_torch.train import optimizer as O

    _, _, _, tparams = _pair("granite-moe-3b-a800m")
    rng = np.random.default_rng(6)
    grads = tree_map(lambda p: torch.from_numpy(
        rng.standard_normal(tuple(p.shape)).astype(np.float32)), tparams)
    state = adamw_init(tparams)
    state = {"m": tree_map(lambda m: m + 0.01, state["m"]),
             "v": tree_map(lambda v: v + 0.02, state["v"]), "step": state["step"] + 2}
    want_p, want_s = adamw_update(grads, state, tparams, lr=1e-2)
    monkeypatch.setattr(O, "CHUNK_ELEMENTS", chunk)
    got_p, got_s = adamw_update(grads, state, tparams, lr=1e-2)
    for a, b in zip(tree_leaves((got_p, got_s["m"], got_s["v"])),
                    tree_leaves((want_p, want_s["m"], want_s["v"]))):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_adamw_update_frees_its_trees_without_a_gc_pass():
    """The params and moments an update returns are freed when their last
    reference goes, not at some later pass of Python's cycle collector: no
    reference cycle holds them (a step's replaced moments kept alive so on
    the card varied the 12-layer gemma3-4b step's peak from 70 to 78 GiB)."""
    import gc
    import weakref

    _, _, _, tparams = _pair("qwen3-1.7b")
    grads = tree_map(torch.ones_like, tparams)
    gc.collect()
    gc.disable()
    try:
        new_p, new_s = adamw_update(grads, adamw_init(tparams), tparams)
        refs = [weakref.ref(t) for t in tree_leaves((new_p, new_s["m"], new_s["v"]))]
        del new_p, new_s
        assert refs and all(r() is None for r in refs)
    finally:
        gc.enable()


def test_global_norm_sums_in_jax_leaf_order():
    """A dict built in another key order sums its leaves in sorted order."""
    rng = np.random.default_rng(3)
    leaves = {k: torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 10.0 ** e)
              for k, n, e in (("b", 7, 3), ("a", 5, -4), ("c", 3, 0))}
    tree = {"c": leaves["c"], "a": leaves["a"], "b": leaves["b"]}
    want = torch.sqrt(sum(torch.sum(torch.square(leaves[k])) for k in "abc"))
    assert torch.equal(global_norm(tree), want)
    jwant = JS.adamw_update.__globals__["global_norm"](
        {k: jnp.asarray(v.numpy()) for k, v in tree.items()})
    assert abs(global_norm(tree).item() - float(jwant)) <= 1e-6 * float(jwant)


# --- mirrors of tests/test_train.py ---------------------------------------


@pytest.fixture(scope="module")
def setup():
    _, pcfg, _, tparams = _pair("qwen3-1.7b", n_layers=2)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, pcfg.vocab_size, (8, 32)).astype(np.int32),
             "labels": rng.integers(0, pcfg.vocab_size, (8, 32)).astype(np.int32)}
    return pcfg, tparams, batch


def test_adamw_first_step_is_lr_sized(setup):
    _, params, _ = setup
    grads = tree_map(torch.ones_like, params)
    new_params, opt2 = adamw_update(grads, adamw_init(params), params, lr=0.1,
                                    weight_decay=0.0, clip_norm=1e9)
    leaf, leaf2 = tree_leaves(params)[0], tree_leaves(new_params)[0]
    np.testing.assert_allclose((leaf - leaf2).numpy(), 0.1, rtol=1e-4)
    assert int(opt2["step"]) == 1


def test_grad_clipping_bounds_norm(setup):
    _, params, _ = setup
    grads = tree_map(lambda p: 100.0 * torch.ones_like(p), params)
    p1, _ = adamw_update(grads, adamw_init(params), params, lr=1.0, clip_norm=1.0,
                         weight_decay=0.0)
    delta = global_norm(tree_map(lambda a, b: a - b, params, p1))
    n_el = sum(x.numel() for x in tree_leaves(params))
    assert float(delta) < 1.1 * np.sqrt(n_el)


def test_train_step_descends(setup):
    cfg, params, batch = setup
    step = PS.make_train_step(cfg, grad_accum=1, remat=False, lr=5e-3)
    opt, p, losses = adamw_init(params), params, []
    for _ in range(5):
        p, opt, metrics = step(p, opt, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]


def test_grad_accum_equivalence(setup):
    """accum=4 must equal accum=1 on the same global batch (same grads)."""
    cfg, params, batch = setup
    s1 = PS.make_train_step(cfg, grad_accum=1, remat=False, lr=1e-3)
    s4 = PS.make_train_step(cfg, grad_accum=4, remat=False, lr=1e-3)
    p1, _, m1 = s1(params, adamw_init(params), batch)
    p4, _, m4 = s4(params, adamw_init(params), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)


def test_int8_compression_bounded_error():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((256, 64)).astype(np.float32))
    y = quantize_dequantize(x)
    assert float((x - y).abs().max()) <= float(x.abs().max()) / 127.0 + 1e-6
    # round half to even, as jnp.round: the same int8 levels as the JAX package
    want = JS.GC.quantize_dequantize(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))


def test_compressed_train_step_still_descends(setup):
    cfg, params, batch = setup
    step = PS.make_train_step(cfg, grad_accum=1, remat=False, lr=5e-3, grad_compression="int8")
    p, opt, m0 = step(params, adamw_init(params), batch)
    for _ in range(4):
        p, opt, m = step(p, opt, batch)
    assert float(m["loss"]) < float(m0["loss"])


# --- the serve-side step factories -----------------------------------------


@pytest.mark.parametrize("cached", [False, True])
def test_sparse_decode_step_matches_jax(cached):
    """Three sparse decode steps over a prefilled cache of 8 chunks of 8:
    logits and the state's K / V / summaries against the JAX step's."""
    cfg, pcfg, params, tparams = _pair("qwen3-1.7b")
    c, S, b, s0 = 8, 64, 2, 29
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (b, s0)).astype(np.int32)
    jstate = JT.init_serve_state(cfg, b, S)
    _, jstate = JT.prefill(params, {"tokens": jnp.asarray(prompt)}, cfg, jstate)
    if cached:
        L, n_kv, d = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
        jstate["kmean"] = jstate["k"].reshape(L, b, S // c, c, n_kv, d).mean(axis=3)
    pstate = {k: (bridge.tensor_from_numpy(np.asarray(v), "cpu") if k != "length"
                  else int(v)) for k, v in jstate.items()}
    kw = dict(chunk_tokens=c, budget=0.3, cached_summaries=cached)
    jstep = JS.make_sparse_decode_step(cfg, **kw)
    pstep = PS.make_sparse_decode_step(pcfg, **kw)
    for t in range(3):
        tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jl, jstate = jstep(params, jnp.asarray(tok), jstate)
        pl, pstate = pstep(tparams, torch.from_numpy(tok), pstate)
        assert pstate["length"] == int(jstate["length"]) == s0 + t + 1
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
        for key in ("k", "v") + (("kmean",) if cached else ()):
            np.testing.assert_allclose(pstate[key].numpy(), np.asarray(jstate[key]),
                                       rtol=1e-5, atol=1e-6)


def test_prefill_and_decode_steps_match_jax():
    cfg, pcfg, params, tparams = _pair("qwen3-1.7b")
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    jl, js = JS.make_prefill_step(cfg)(params, {"tokens": jnp.asarray(prompt)},
                                       JT.init_serve_state(cfg, 2, 16))
    pl, ps = PS.make_prefill_step(pcfg)(tparams, {"tokens": torch.from_numpy(prompt)},
                                        PT.init_serve_state(pcfg, 2, 16, device="cpu"))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
    jl, _ = JS.make_decode_step(cfg)(params, jnp.asarray(tok), js)
    pl, _ = PS.make_decode_step(pcfg)(tparams, torch.from_numpy(tok), ps)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


# --- the CLI ---------------------------------------------------------------


def test_train_cli_saves_and_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--preset", "tiny", "--steps", "4", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    ptrain.main(argv)
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "summary:" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000001", "step_00000003"]
    argv[argv.index("4")] = "6"
    params = ptrain.main(argv)
    out = capsys.readouterr().out
    assert "restored checkpoint, resuming at step 4" in out
    assert "'steps': 2" in out
    assert all(torch.isfinite(x).all() for x in tree_leaves(params))
