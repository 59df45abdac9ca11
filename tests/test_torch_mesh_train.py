"""The port's train step over a mesh against the JAX package's, on the CPU.

A mesh here is ``[cpu] * k``: k shards on one device, where the JAX side
forces 4 host devices (one subprocess for the module) and runs
``jax.jit(make_train_step(...))`` under ``with mesh, activation_sharding(mesh)``
on params, moments and a batch laid out by ``param_shardings`` and
``P("data", None)``, as ``tests/test_sharding_small.py`` does: float32
configs cut to 2 layers, grad_accum 2, remat True, lr 1e-3, one step on a
numpy-seeded batch of 4 x 32 tokens. hymba-1.5b runs at 5 q heads over one
kv head: split ceil-wise, 3 / 2 over two tensor shards and 2 / 2 / 1 / 0
over four, its kv head on the fallback layout and read by every shard.
Limits:
- 2 x 2 and 1 x 4 meshes against JAX, with and without int8 compression:
  the loss within 1e-6 relative; the new params and moments within 1e-5
  of each leaf's largest element (the tensor shards' float32 sums in
  other orders than the unsharded step's, as GSPMD's are), but for the
  elements ``test_train_steps_match_jax`` (``tests/test_torch_train.py``)
  lets move: an Adam step on a gradient near eps, an int8 level on a
  rounding edge (the limits below);
- a 1 x 1 mesh, and meshes whose tensor axes have size 1 (4 x 1, 2 x 1),
  against the port's step without a mesh: bit for bit, for every arch,
  grad_accum 1 and 2, with and without int8 (2 x 1 over one row a part
  against one row a microbatch, where each part is weighed by an exact
  1/2, for the archs without an MoE, whose split keeps the microbatch's
  dispatch instead);
- mixtral-8x22b at capacity factor 0.5 (assignments drop): the split keeps
  and drops exactly the assignments the whole microbatch does, layer by
  layer, and the JAX comparison above holds at that factor.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import (NamedSharding, P, ShardedTensor, block_index,
                                         param_shardings, shard, shard_tree, unshard_tree)
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.train.optimizer import adamw_init
from repro_torch.tree import path_key, tree_flatten_with_path, tree_leaves, tree_replace_leaves

torch.backends.cuda.matmul.allow_tf32 = False

CPU = torch.device("cpu")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
LR = 1e-3
ARCHS = {"qwen3-1.7b": {}, "mixtral-8x22b": {"moe_capacity_factor": 0.5},
         "falcon-mamba-7b": {}, "hymba-1.5b": {"n_heads": 5, "n_kv_heads": 1}}
GRIDS = ((2, 2), (1, 4))

JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, SRC_PATH)
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import reduced_config
from repro.launch.act_sharding import activation_sharding
from repro.launch.mesh import make_host_mesh
from repro.launch.sharding import param_shardings
from repro.launch.steps import make_train_step
from repro.models import transformer as T
from repro.train.optimizer import adamw_init

def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}

assert jax.device_count() == 4
out = {}
for arch, over in ARCHS.items():
    cfg = dataclasses.replace(reduced_config(arch, n_layers=2, **over), dtype="float32")
    params = T.init_params(jax.random.PRNGKey(0), cfg)
    for k, x in flat(params).items():
        out[f"{arch}|init|{k}"] = x
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)}
    for grid in GRIDS:
        mesh = make_host_mesh(*grid)
        bsh = NamedSharding(mesh, P("data", None))
        sh = param_shardings(cfg, mesh, fsdp=True)
        for comp in (None, "int8"):
            p = jax.device_put(params, sh)
            opt = jax.device_put(adamw_init(params),
                                 {"m": sh, "v": sh, "step": NamedSharding(mesh, P())})
            b = jax.device_put(batch, {"tokens": bsh, "labels": bsh})
            step = make_train_step(cfg, grad_accum=2, remat=True, lr=LR, grad_compression=comp)
            with mesh, activation_sharding(mesh):
                p2, o2, m2 = jax.jit(step)(p, opt, b)
            key = f"{arch}|{grid}|{comp}"
            out[f"{key}|loss"] = np.asarray(m2["loss"])
            out[f"{key}|step"] = np.asarray(o2["step"])
            for kind, tree in (("params", p2), ("m", o2["m"]), ("v", o2["v"])):
                for k, x in flat(tree).items():
                    out[f"{key}|{kind}|{k}"] = x
np.savez(OUT_PATH, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_train") / "jax.npz")
    code = (JAX_SCRIPT.replace("SRC_PATH", repr(SRC)).replace("OUT_PATH", repr(path))
            .replace("ARCHS", repr(ARCHS)).replace("GRIDS", repr(GRIDS))
            .replace("LR", repr(LR)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=900, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(path) as data:
        return dict(data)


def _cfg(arch):
    return dataclasses.replace(reduced_config(arch, n_layers=2, **ARCHS[arch]), dtype="float32")


def _batch(cfg, b=4, s=32):
    rng = np.random.default_rng(1)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _jax_params(jax_run, arch, cfg):
    """The JAX side's initial params in the port's tree."""
    meta = PT.init_params(cfg, None, device="meta")
    return {path: jax_run[f"{arch}|init|{path_key(path)}"] for path, _ in
            tree_flatten_with_path(meta)}, meta


def _port_params(jax_run, arch, cfg):
    flat, meta = _jax_params(jax_run, arch, cfg)
    return tree_replace_leaves(meta, [bridge.tensor_from_numpy(flat[p], "cpu")
                                      for p, _ in tree_flatten_with_path(meta)])


def _on_mesh(cfg, params, mesh):
    sh = param_shardings(cfg, mesh, fsdp=True)
    opt = adamw_init(params)
    return shard_tree(params, sh), {"m": shard_tree(opt["m"], sh), "v": shard_tree(opt["v"], sh),
                                    "step": shard(opt["step"], NamedSharding(mesh, P()))}


def _mesh(data, model):
    return make_host_mesh(data, model, devices=[CPU] * (data * model))


def _within(got, want, rel, outliers=0.0, loose=None, atol=0.0):
    """``got`` within ``rel`` of ``want``'s largest element (plus ``atol``)
    but for at most a share ``outliers`` of its elements, which lie within
    ``loose``."""
    err = np.abs(got.astype(np.float32) - want.astype(np.float32))
    off = err > rel * max(np.abs(want).max(), 1e-30) + atol
    assert off.mean() <= outliers, (err.max(), np.abs(want).max(), off.mean())
    if off.any():
        assert err.max() <= loose, (err.max(), loose)


@pytest.mark.parametrize("compression", [None, "int8"])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_mesh_step_matches_jax(jax_run, arch, grid, compression):
    """One mesh step, 2 x 2 and 1 x 4, against JAX's jitted mesh step on
    the same mesh. Params may also differ by 1e-4 lr (the norm scales start
    at zero) and, for at most 1e-3 of a leaf, by 2 lr (Adam's step on a
    gradient near eps); under int8 at most 1 % of a moment leaf may sit one
    level (1/127 of the leaf's largest gradient) away, within 1e-2 of its
    largest element, and the moments are compared at the clip factor those
    level flips imply (``_int8_clip_ratio``): AdamW clips the quantized
    gradient by its global norm, so one flip of a large element moves every
    element of every leaf by one common factor."""
    cfg = _cfg(arch)
    params = _port_params(jax_run, arch, cfg)
    mesh = _mesh(*grid)
    ps, opt = _on_mesh(cfg, params, mesh)
    step = PS.make_train_step(cfg, grad_accum=2, remat=True, lr=LR, grad_compression=compression,
                              mesh=mesh)
    new_p, new_o, metrics = step(ps, opt, _batch(cfg))
    key = f"{arch}|{grid}|{compression}"
    want_loss = float(jax_run[f"{key}|loss"])
    assert abs(metrics["loss"].item() - want_loss) <= 1e-6 * abs(want_loss)
    assert all(int(new_o["step"].block_at(pos)) == int(jax_run[f"{key}|step"])
               for pos in new_o["step"].positions())
    leaves = {}
    for kind, tree in (("params", new_p), ("m", new_o["m"]), ("v", new_o["v"])):
        for path, st in tree_flatten_with_path(tree):
            assert isinstance(st, ShardedTensor) and st.sharding.mesh is mesh
            got = bridge.tree_to_numpy(unshard_tree({"x": st}, CPU))["x"]
            leaves[kind, path] = got, jax_run[f"{key}|{kind}|{path_key(path)}"]
    ratio = 1.0
    if compression == "int8":
        ratio = _int8_clip_ratio([g for (k, _), g in leaves.items() if k == "m"])
    for (kind, _), (got, want) in leaves.items():
        if kind == "params":
            _within(got, want, 1e-5, outliers=1e-3, loose=2 * LR, atol=1e-4 * LR)
        elif compression == "int8":
            want = want * (ratio if kind == "m" else ratio ** 2)
            _within(got, want, 1e-5, outliers=1e-2, loose=1e-2 * np.abs(want).max())
        else:
            _within(got, want, 1e-5)


def _int8_clip_ratio(pairs) -> float:
    """The common factor between two runs' first moments under int8 (m =
    (1 - b1) c g, g the dequantized gradient and c the global-norm clip of
    the quantized gradient), held to what their level flips imply. A flip
    (an element one int8 level, more than half a level, apart) changes the
    quantized gradient's norm and so c, the same for every element: the
    ratio r is fitted on the other elements, and, the step clipping (c =
    1 / ||g||, so sum m^2 = (1 - b1)^2 on both sides), r^2 must be (sum of
    want^2 - sum of the flipped got^2) / (sum of the other want^2), within
    2e-6 (each side's sum m^2 is that to float32 sums). A run whose step
    does not clip must give r = 1 within 1e-6."""
    flat = [(g.astype(np.float64).ravel(), w.astype(np.float64).ravel()) for g, w in pairs]
    flips = [np.abs(g - w) > np.abs(w).max() / 254 for g, w in flat]
    kept = sum((w * w)[~f].sum() for (_, w), f in zip(flat, flips))
    ratio = sum((g * w)[~f].sum() for (g, w), f in zip(flat, flips)) / kept
    total = sum((w * w).sum() for _, w in flat)
    if abs(total / 0.1 ** 2 - 1) > 1e-5:  # not clipped: c = 1 on both sides
        assert abs(ratio - 1) <= 1e-6, ratio
        return ratio
    implied = (total - sum((g * g)[f].sum() for (g, _), f in zip(flat, flips))) / kept
    assert abs(implied - ratio ** 2) <= 2e-6, (ratio, implied)
    return ratio


ONE_SHARD_CASES = [(grid, ga, ref_ga, comp, arch)
                   for arch in ARCHS
                   for grid, ga, ref_ga, comp in (((1, 1), 2, 2, None), ((1, 1), 1, 1, None),
                                                  ((1, 1), 2, 2, "int8"), ((4, 1), 2, 2, None),
                                                  ((2, 1), 2, 4, None), ((2, 1), 2, 4, "int8"))
                   if grid != (2, 1) or arch != "mixtral-8x22b"]


@pytest.mark.parametrize("grid,grad_accum,ref_accum,compression,arch", ONE_SHARD_CASES)
def test_one_dp_shard_is_the_unsharded_step(arch, grid, grad_accum, ref_accum, compression):
    """A mesh with one tensor shard computes each dp part's rows with whole
    layer slices: bit for bit the step without a mesh, params and moments,
    every block. 1 x 1 with grad_accum 1 and 2, with and without int8; 4 x 1
    at grad_accum 2, whose 2-row microbatches do not split over 4 dp shards
    (FSDP blocks gathered from four positions, gradients block by block);
    2 x 1 at grad_accum 2, one row a part, against grad_accum 4 (the parts'
    gradients weighed by 1/2 and summed in float32 are the microbatches'
    summed and divided by 4, bit for bit)."""
    cfg = _cfg(arch)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg)
    kw = dict(remat=True, lr=LR, grad_compression=compression)
    want_p, want_o, want_m = PS.make_train_step(cfg, grad_accum=ref_accum, **kw)(
        params, adamw_init(params), batch)
    mesh = _mesh(*grid)
    ps, opt = _on_mesh(cfg, params, mesh)
    got_p, got_o, got_m = PS.make_train_step(cfg, grad_accum=grad_accum, mesh=mesh, **kw)(
        ps, opt, batch)
    assert torch.equal(got_m["loss"], want_m["loss"])
    for got, want in ((got_p, want_p), (got_o["m"], want_o["m"]), (got_o["v"], want_o["v"])):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert g.dtype == w.dtype and g.shape == tuple(w.shape)
            assert torch.equal(unshard_tree({"x": g}, CPU)["x"], w)
            for pos in g.positions():  # every replica too
                assert torch.equal(g.block_at(pos), w[block_index(g.shape, g.sharding, pos)])


def test_split_keeps_the_microbatch_dispatch(monkeypatch):
    """mixtral at capacity factor 0.5 drops assignments; on a 2 x 2 mesh
    each microbatch's rows run as two parts, and the parts keep and drop, at
    every layer, exactly the assignments the whole microbatch does (the
    parts' keep masks, concatenated in order, against the unsharded
    step's); the losses agree within 1e-6 relative."""
    cfg = _cfg("mixtral-8x22b")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg)
    seen = []
    real = PM.dispatch

    def recording(top_idx, cap, n_experts, offset=None):
        out = real(top_idx, cap, n_experts, offset)
        seen.append(out[1].clone())
        return out

    monkeypatch.setattr(PM, "dispatch", recording)
    kw = dict(grad_accum=2, remat=False, lr=LR)
    _, _, want_m = PS.make_train_step(cfg, **kw)(params, adamw_init(params), batch)
    whole, seen[:] = list(seen), []
    mesh = _mesh(2, 2)
    ps, opt = _on_mesh(cfg, params, mesh)
    _, _, got_m = PS.make_train_step(cfg, mesh=mesh, **kw)(ps, opt, batch)
    L = cfg.n_layers
    assert len(whole) == 2 * L and len(seen) == 2 * 2 * L
    dropped = 0
    for i in range(2):  # microbatch i: the whole one's layers, then each part's
        for l in range(L):
            split = torch.cat([seen[(2 * i + j) * L + l] for j in range(2)])
            assert torch.equal(split, whole[i * L + l])
            dropped += int((~whole[i * L + l]).sum())
    assert dropped > 0
    assert abs(got_m["loss"].item() - want_m["loss"].item()) <= 1e-6 * abs(want_m["loss"].item())


@pytest.mark.parametrize("case", ["mask", "indivisible"])
def test_split_weights_and_indivisible_rows(case):
    """A ``loss_mask`` weighs each part by its mask sum (on 2 x 2); a
    microbatch of 3 rows over 2 dp shards runs on the first alone (on 2 x
    1, whose one tensor shard computes with whole layer slices: then bit
    for bit the unsharded step). The loss within 1e-6 relative and params
    and moments within 1e-5 of the largest element of the unsharded
    step's."""
    cfg = _cfg("qwen3-1.7b")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    if case == "mask":
        batch = _batch(cfg)
        batch["loss_mask"] = (np.random.default_rng(2).random((4, 32)) < 0.6).astype(np.float32)
        batch["loss_mask"][1] = 0.0  # a part with nothing to count
        ga = 2
    else:
        batch, ga = _batch(cfg, b=3), 1
    kw = dict(grad_accum=ga, remat=False, lr=LR)
    want_p, want_o, want_m = PS.make_train_step(cfg, **kw)(params, adamw_init(params), batch)
    mesh = _mesh(2, 2) if case == "mask" else _mesh(2, 1)
    ps, opt = _on_mesh(cfg, params, mesh)
    got_p, got_o, got_m = PS.make_train_step(cfg, mesh=mesh, **kw)(ps, opt, batch)
    assert abs(got_m["loss"].item() - want_m["loss"].item()) <= 1e-6 * abs(want_m["loss"].item())
    for got, want in ((got_p, want_p), (got_o["m"], want_o["m"]), (got_o["v"], want_o["v"])):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert not any(b.requires_grad for b in g.blocks.flat)
            g = unshard_tree({"x": g}, CPU)["x"]
            if case == "indivisible":
                assert torch.equal(g, w)
            else:
                assert float((g - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1e-30)


OTHER_ARCHS = ("gemma3-4b", "granite-moe-3b-a800m", "internvl2-76b", "musicgen-large",
               "qwen2.5-7b")


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_other_archs_on_two_by_two_match_the_unsharded_step(arch):
    """The archs the JAX comparison leaves out (sliding windows, an MoE with
    one kv head, the frontends' embeddings in place of tokens) on a 2 x 2
    mesh under remat, against the port's step without a mesh over the same
    microbatches: the loss within 1e-6 relative, moments within 1e-5 of each
    leaf's largest element, params the same but for at most 1e-3 of a
    leaf's elements within 2 lr (Adam's first step on a gradient near 0
    takes its sign). qwen2.5's ``bk`` adds q . b to each score of a query's
    row alike, which the softmax cancels: its gradient is rounding noise
    on both sides, so its params are held within 2 lr alone. Every weight
    gather's gradient reaches its blocks: ``GradSink.finish`` raises
    otherwise."""
    cfg = dataclasses.replace(reduced_config(arch, n_layers=2), dtype="float32")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg)
    if cfg.frontend:
        batch["embeds"] = np.random.default_rng(101).standard_normal(
            batch.pop("tokens").shape + (cfg.d_model,)).astype(np.float32)
    kw = dict(grad_accum=2, remat=True, lr=LR)
    want_p, want_o, want_m = PS.make_train_step(cfg, **kw)(params, adamw_init(params), batch)
    mesh = _mesh(2, 2)
    ps, opt = _on_mesh(cfg, params, mesh)
    got_p, got_o, got_m = PS.make_train_step(cfg, mesh=mesh, **kw)(ps, opt, batch)
    assert abs(got_m["loss"].item() - want_m["loss"].item()) <= 1e-6 * abs(want_m["loss"].item())
    for kind, got, want in (("params", got_p, want_p), ("m", got_o["m"], want_o["m"]),
                            ("v", got_o["v"], want_o["v"])):
        for (path, g), w in zip(tree_flatten_with_path(got), tree_leaves(want)):
            g, w = unshard_tree({"x": g}, CPU)["x"].numpy(), w.numpy()
            if kind == "params" and path_key(path) == "layers/bk":
                assert np.abs(g - w).max() <= 2 * LR
            elif kind == "params":
                _within(g, w, 1e-5, outliers=1e-3, loose=2 * LR, atol=1e-4 * LR)
            else:
                _within(g, w, 1e-5)

