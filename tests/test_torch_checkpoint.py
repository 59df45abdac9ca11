"""The port's checkpointing and fault tolerance, and checkpoints across packages.

Mirrors tests/test_checkpoint.py (round trip, async save, retention, the
elastic restore onto another mesh, restart after an injected failure,
heartbeat and straggler detection) on the port, with a tree laid out on a
mesh of ``[cpu] * 4`` saved and restored bit for bit and a train run over
a mesh restarted from its sharded checkpoint,
and holds the on-disk format to the JAX package's: a checkpoint written by
either package restores in the other, bit for bit, with the same manifest.
bfloat16 leaves are stored as both packages store them, raw 2-byte values
(numpy ``|V2``) with "bfloat16" in the manifest; the JAX side reads them by
viewing those bytes as ``ml_dtypes.bfloat16`` (its own ``restore_checkpoint``
hands the void array to ``jnp.asarray``, which refuses it).
"""
import dataclasses
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import transformer as JT
from repro.train import checkpoint as JCK
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import (NamedSharding, P, ShardedTensor, block_index,
                                         param_shardings, shard_tree, unshard_tree)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as PT
from repro_torch.train.checkpoint import (CheckpointManager, latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.ft import FailureInjector, HeartbeatMonitor
from repro_torch.train.optimizer import adamw_init
from repro_torch.tree import tree_leaves


@pytest.fixture(scope="module")
def state():
    cfg = dataclasses.replace(reduced_config("qwen3-1.7b", n_layers=2), dtype="float32")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params, adamw_init(params)


CPU = torch.device("cpu")


def _on_mesh(cfg, params, opt, mesh, shard_leaves=True):
    """({"params", "opt"} laid out on ``mesh`` by ``param_shardings``, the
    step replicated; their shardings)."""
    psh = param_shardings(cfg, mesh, fsdp=True)
    sh = {"params": psh, "opt": {"m": psh, "v": psh, "step": NamedSharding(mesh, P())}}
    return (shard_tree({"params": params, "opt": opt}, sh) if shard_leaves else None), sh


def _trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _jax_pair(dtype):
    cfg = dataclasses.replace(jax_reduced_config("qwen3-1.7b", n_layers=2), dtype=dtype)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    tree = {"params": params, "opt": jax_adamw_init(params)}
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    port = {"params": bridge.params_from_numpy(np_tree["params"], "cpu"),
            "opt": bridge.opt_state_from_numpy(np_tree["opt"], "cpu")}
    return tree, np_tree, port


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


class TestCheckpoint:
    def test_roundtrip(self, state, tmp_path):
        _, params, opt = state
        tree = {"params": params, "opt": opt}
        save_checkpoint(str(tmp_path), 7, tree)
        assert latest_step(str(tmp_path)) == 7
        _trees_equal(tree, restore_checkpoint(str(tmp_path), 7, tree))

    def test_async_save(self, state, tmp_path):
        _, params, _ = state
        t = save_checkpoint(str(tmp_path), 3, {"params": params}, blocking=False)
        t.join()
        assert latest_step(str(tmp_path)) == 3

    def test_manager_retention(self, state, tmp_path):
        _, params, _ = state
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, {"params": params}, blocking=True)
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                       if d.startswith("step_"))
        assert steps == [3, 4]

    def test_blocking_save_after_an_async_save_of_the_same_step(self, state, tmp_path):
        """The train CLI's last save repeats a periodic one: the manager lets
        the async write finish first, so no tmp dir is left behind."""
        _, params, _ = state
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(3, {"params": params})
        mgr.save(3, {"params": params}, blocking=True)
        assert sorted(os.listdir(tmp_path)) == ["step_00000003"]

    @pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
    def test_elastic_restore_onto_different_mesh(self, state, tmp_path, grid):
        """Save unsharded, restore with explicit shardings onto a 1 x 1 and
        a 2 x 2 mesh (the path used when node counts change between runs):
        every leaf laid out on the mesh, equal to the saved tree."""
        cfg, params, _ = state
        save_checkpoint(str(tmp_path), 1, {"params": params})
        mesh = make_host_mesh(*grid, devices=[CPU] * 4)
        sh = {"params": param_shardings(cfg, mesh, fsdp=True)}
        restored = restore_checkpoint(str(tmp_path), 1, {"params": params}, sh)
        _trees_equal({"params": params}, unshard_tree(restored, CPU))
        for leaf, want in zip(tree_leaves(restored), tree_leaves(sh)):
            assert isinstance(leaf, ShardedTensor) and leaf.sharding == want
            assert leaf.mesh.shape["model"] == grid[1]

    def test_sharded_save_restores_bit_for_bit(self, state, tmp_path):
        """Params and moments laid out on a 2 x 2 mesh save the unsharded
        tree's bytes; restored onto 2 x 2 and onto 1 x 4 every block is bit
        for bit the saved leaf's slice; a ShardedTensor target without
        shardings keeps its own layout; a None sharding restores on the
        target leaf's device."""
        cfg, params, opt = state
        mesh = make_host_mesh(2, 2, devices=[CPU] * 4)
        tree, sh = _on_mesh(cfg, params, opt, mesh)
        save_checkpoint(str(tmp_path / "mesh"), 2, tree)
        save_checkpoint(str(tmp_path / "flat"), 2, {"params": params, "opt": opt})
        assert _manifest(tmp_path / "mesh", 2) == _manifest(tmp_path / "flat", 2)
        with np.load(tmp_path / "mesh" / "step_00000002" / "arrays.npz") as a, \
                np.load(tmp_path / "flat" / "step_00000002" / "arrays.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
        flat = {"params": params, "opt": opt}
        for grid in ((2, 2), (1, 4)):
            m = make_host_mesh(*grid, devices=[CPU] * 4)
            _, msh = _on_mesh(cfg, params, opt, m, shard_leaves=False)
            got = restore_checkpoint(str(tmp_path / "mesh"), 2, tree, msh)
            for g, w in zip(tree_leaves(got), tree_leaves(flat)):
                assert isinstance(g, ShardedTensor) and g.mesh is m
                for pos in g.positions():
                    b = g.block_at(pos)
                    assert b.dtype == w.dtype and torch.equal(b, w[block_index(g.shape,
                                                                           g.sharding, pos)])
        kept = restore_checkpoint(str(tmp_path / "mesh"), 2, tree)
        assert all(k.sharding == t.sharding for k, t in zip(tree_leaves(kept), tree_leaves(tree)))
        plain = restore_checkpoint(str(tmp_path / "mesh"), 2, flat,
                                   {"params": None, "opt": {"m": None, "v": None, "step": None}})
        _trees_equal(plain, flat)

    def test_mesh_step_restart_resumes_training(self, state, tmp_path):
        """Train on a 2 x 2 mesh, kill at step 3 (injected), restore the
        sharded checkpoint with ``shardings=`` and finish: the params and
        moments equal an uninterrupted mesh run's bit for bit."""
        cfg, params, opt = state
        mesh = make_host_mesh(2, 2, devices=[CPU] * 4)
        tree, sh = _on_mesh(cfg, params, opt, mesh)
        rng = np.random.default_rng(1)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)}
        step_fn = make_train_step(cfg, grad_accum=2, remat=False, lr=1e-3, mesh=mesh)
        mgr = CheckpointManager(str(tmp_path), keep=2)
        injector = FailureInjector(fail_at=[3])

        def run(p, o, start, save=True):
            for s in range(start, 5):
                if save:
                    injector.maybe_fail(s)
                p, o, _ = step_fn(p, o, batch)
                if save:
                    mgr.save(s, {"params": p, "opt": o}, blocking=True)
            return p, o

        with pytest.raises(RuntimeError, match="injected node failure at step 3"):
            run(tree["params"], tree["opt"], 0)
        assert mgr.latest() == 2
        restored = mgr.restore(tree, sh)
        p, o = run(restored["params"], restored["opt"], 3)
        p2, o2 = run(tree["params"], tree["opt"], 0, save=False)
        for a, b in zip(tree_leaves({"params": p, "opt": o}), tree_leaves({"params": p2,
                                                                             "opt": o2})):
            assert a.sharding == b.sharding
            assert all(torch.equal(a.block_at(pos), b.block_at(pos)) for pos in a.positions())

    def test_restart_resumes_training(self, state, tmp_path):
        """Kill at step 3 (injected), restart from the checkpoint, finish: the
        params and moments equal an uninterrupted run's bit for bit."""
        cfg, params, opt = state
        rng = np.random.default_rng(1)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)}
        step_fn = make_train_step(cfg, grad_accum=1, remat=False, lr=1e-3)
        mgr = CheckpointManager(str(tmp_path), keep=2)
        injector = FailureInjector(fail_at=[3])

        def run(p, o, start, save=True):
            for s in range(start, 6):
                if save:
                    injector.maybe_fail(s)
                p, o, _ = step_fn(p, o, batch)
                if save:
                    mgr.save(s, {"params": p, "opt": o}, blocking=True)
            return p, o

        with pytest.raises(RuntimeError, match="injected node failure at step 3"):
            run(params, opt, 0)
        latest = mgr.latest()
        assert latest == 2
        restored = mgr.restore({"params": params, "opt": opt})
        p, o = run(restored["params"], restored["opt"], latest + 1)
        assert mgr.latest() == 5
        p2, o2 = run(params, opt, 0, save=False)
        _trees_equal({"params": p, "opt": o}, {"params": p2, "opt": o2})


class TestAcrossPackages:
    def test_port_checkpoint_restores_in_jax(self, tmp_path):
        tree, np_tree, port = _jax_pair("float32")
        save_checkpoint(str(tmp_path / "port"), 4, port)
        JCK.save_checkpoint(str(tmp_path / "jax"), 4, tree)
        assert _manifest(tmp_path / "port", 4) == _manifest(tmp_path / "jax", 4)
        restored = JCK.restore_checkpoint(str(tmp_path / "port"), 4, tree)
        for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(tree)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_jax_checkpoint_restores_in_the_port(self, tmp_path):
        tree, _, port = _jax_pair("float32")
        JCK.save_checkpoint(str(tmp_path), 9, tree)
        target = jax.tree_util.tree_map(torch.zeros_like, port)
        _trees_equal(restore_checkpoint(str(tmp_path), 9, target), port)

    def test_bfloat16_across_packages(self, tmp_path):
        tree, np_tree, port = _jax_pair("bfloat16")
        assert port["params"]["embed"].dtype == torch.bfloat16
        # the port writes: the JAX side reads the raw values by the manifest
        save_checkpoint(str(tmp_path / "port"), 2, port)
        JCK.save_checkpoint(str(tmp_path / "jax"), 2, tree)
        manifest = _manifest(tmp_path / "port", 2)
        assert manifest == _manifest(tmp_path / "jax", 2)
        want = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(x)
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
        for name in ("port", "jax"):
            with np.load(tmp_path / name / "step_00000002" / "arrays.npz") as data:
                for key, w in want.items():
                    arr = data[key]
                    if manifest["dtypes"][key] == "bfloat16":
                        assert arr.dtype == np.dtype("V2")
                        arr = arr.view(ml_dtypes.bfloat16)
                    assert arr.dtype == w.dtype, key
                    np.testing.assert_array_equal(arr.reshape(-1).view(np.uint8),
                                                  w.reshape(-1).view(np.uint8))
        # the JAX package writes: the port restores bit for bit
        target = jax.tree_util.tree_map(torch.zeros_like, port)
        _trees_equal(restore_checkpoint(str(tmp_path / "jax"), 2, target), port)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip(dtype):
    """JAX params and AdamW state into the port and back to numpy: the same
    keys, dtypes (bfloat16 as ml_dtypes.bfloat16) and bits."""
    _, np_tree, port = _jax_pair(dtype)
    assert port["opt"]["step"].dtype == torch.int32 and port["opt"]["step"].dim() == 0
    back = bridge.tree_to_numpy(port)
    want = jax.tree_util.tree_flatten_with_path(np_tree)[0]
    got = jax.tree_util.tree_leaves(back)
    assert len(got) == len(want)
    for (path, w), g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8), w.reshape(-1).view(np.uint8))


class TestHeartbeat:
    def test_straggler_detection(self):
        flagged = []
        mon = HeartbeatMonitor(window=20, k_sigma=3.0,
                               on_straggler=lambda r: flagged.append(r.step))
        for s in range(20):
            mon.beat(s, 0.10 + 0.001 * (s % 3))
        assert not flagged
        mon.beat(20, 0.50)  # 5x slower
        assert flagged == [20]
        assert mon.summary()["stragglers"] == 1

    def test_no_false_positives_on_noise(self):
        mon = HeartbeatMonitor(window=30, k_sigma=3.0)
        rng = np.random.default_rng(0)
        flags = [mon.beat(s, 0.1 + rng.normal(0, 0.002)) for s in range(100)]
        assert sum(flags) <= 2

    def test_failure_injector_fires_once(self):
        inj = FailureInjector(fail_at=[2])
        inj.maybe_fail(1)
        with pytest.raises(RuntimeError):
            inj.maybe_fail(2)
        inj.maybe_fail(2)  # a restarted run passes the step
        assert inj.failed == [2]
