"""Weights from the JAX package into the port.

``params_from_numpy`` takes a params pytree of the JAX package whose leaves
were turned into numpy arrays (``jax.tree_util.tree_map(np.asarray, p)``) and
returns the port's params dict: the same keys, shapes and dtypes, so both
packages run the same weights with no checkpoint to load. bfloat16 leaves
arrive as ``ml_dtypes.bfloat16`` arrays and are reinterpreted bit for bit.
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
