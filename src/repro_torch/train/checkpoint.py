"""Step-atomic checkpointing, in the JAX package's on-disk layout.

Layout:  <dir>/step_<n:08d>/{manifest.json, arrays.npz}   (+ a tmp dir and an
atomic rename). Keys are the leaves' dict paths joined by "/" and the
manifest holds the step, the tree structure as JAX prints it, the sorted
keys, shapes and dtypes, so a checkpoint written by either package restores
in the other.

bfloat16 has no numpy dtype. A bfloat16 leaf is stored as the JAX package
stores it: its raw 2-byte values as a numpy void array (``|V2``) with
"bfloat16" in the manifest; ``restore_checkpoint`` reads such an entry back
bit for bit. (The JAX package's own restore cannot read one: it hands the
void array to ``jnp.asarray``.) Saves can run on a background thread; the
tensors are copied to the host before the thread starts, so the train loop
may go on updating them.

A tree laid out on a mesh (``launch/sharding.ShardedTensor`` leaves) is
saved gathered to the host, as JAX's ``np.asarray`` gathers: the same bytes
as the unsharded tree's. ``restore_checkpoint(..., shardings=)`` lays each
leaf with a ``NamedSharding`` onto its mesh, any mesh: an elastic restart
onto another topology.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch.sharding import ShardedTensor, shard, unshard
from repro_torch.tree import path_key, tree_flatten_with_path, tree_replace_leaves, treedef_str


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, ShardedTensor):
        t = unshard(t, "cpu")  # a fresh host tensor
    else:
        t = t.detach().to("cpu", copy=True)  # the caller may go on updating its tensor
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def save_checkpoint(directory: str, step: int, tree, *, blocking: bool = True):
    """Atomically persist ``tree`` (params + optimizer state + ...) for
    ``step``; returns the writing thread when ``blocking`` is False."""
    leaves = {path_key(p): leaf for p, leaf in tree_flatten_with_path(tree)}
    flat = {k: _to_numpy(leaf) for k, leaf in leaves.items()}
    dtypes = {k: str(leaf.dtype).removeprefix("torch.") for k, leaf in leaves.items()}
    treedef = treedef_str(tree)

    def _write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "treedef": treedef,
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": dtypes,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def restore_checkpoint(directory: str, step: int, target_tree, shardings=None):
    """Restore into the structure of ``target_tree``. ``shardings`` (the
    same tree shape, ``NamedSharding`` leaves or None) lays each leaf with
    a sharding onto its mesh (``shard``); a leaf without one lands on its
    target leaf's device, or in its layout where the target leaf is a
    ``ShardedTensor``."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes: Dict[str, str] = json.load(f)["dtypes"]
    flat = tree_flatten_with_path(target_tree)
    flat_sh = ({path_key(p): sh for p, sh in tree_flatten_with_path(shardings)}
               if shardings is not None else {})
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for p, leaf in flat:
            key = path_key(p)
            sh = flat_sh.get(key)
            if sh is None and isinstance(leaf, ShardedTensor):
                sh = leaf.sharding
            if sh is None:
                leaves.append(_from_numpy(data[key], dtypes[key], leaf.device))
            else:
                leaves.append(shard(_from_numpy(data[key], dtypes[key], "cpu"), sh))
    return tree_replace_leaves(target_tree, leaves)


class CheckpointManager:
    """Retention + async saves + restart discovery."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: List[threading.Thread] = []

    def save(self, step: int, tree, *, blocking: bool = False):
        if blocking:
            # an async save of the same step would share its tmp dir
            self.wait()
        t = save_checkpoint(self.directory, step, tree, blocking=blocking)
        if t is not None:
            self._pending.append(t)
        self._gc()

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()

    def latest(self) -> Optional[int]:
        self.wait()
        return latest_step(self.directory)

    def restore(self, target_tree, shardings=None, step: Optional[int] = None):
        step = step if step is not None else self.latest()
        if step is None:
            return None
        return restore_checkpoint(self.directory, step, target_tree, shardings)

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
