"""Weights from the JAX package into the port.

``params_from_numpy`` takes a params pytree of the JAX package whose leaves
were turned into numpy arrays (``jax.tree_util.tree_map(np.asarray, p)``) and
returns the port's params dict: the same keys, shapes and dtypes, so both
packages run the same weights with no checkpoint to load. bfloat16 leaves
arrive as ``ml_dtypes.bfloat16`` arrays and are reinterpreted bit for bit.
``opt_state_from_numpy`` carries an AdamW state (``m``, ``v``, ``step``)
across the same way, and ``tree_to_numpy`` turns a port tree back into numpy
arrays for the comparisons.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def tensor_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    """One numpy array (bfloat16 included) as a tensor with the same bits."""
    dev = resolve_device(device)
    a = np.array(a, order="C")  # a writable copy: torch refuses read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts of numpy arrays -> the same nesting of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), device)


def opt_state_from_numpy(state: Any, device="cuda") -> Any:
    """The JAX package's AdamW state as numpy arrays -> the port's:
    float32 ``m`` and ``v`` trees and a 0-dim int32 ``step`` tensor."""
    return {"m": params_from_numpy(state["m"], device),
            "v": params_from_numpy(state["v"], device),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                                 device=resolve_device(device))}


def tree_to_numpy(tree: Any) -> Any:
    """Nested dicts of tensors -> the same nesting of numpy arrays, bfloat16
    as ``ml_dtypes.bfloat16`` (the JAX package's numpy type for it)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only bfloat16 needs it; it comes with jax

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
