"""In-house AdamW with global-norm clipping (float32 moments), in the JAX
package's order of operations.

The state is ``{"m": tree, "v": tree, "step": 0-dim int32 tensor}`` on the
params' device. ``global_norm`` sums the leaves in JAX's order (dict keys
sorted), so the clip scale sums its float32 terms as the reference does.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map, tree_replace_leaves


def adamw_init(params) -> Dict[str, Any]:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    device = tree_leaves(params)[0].device
    return {
        "m": zeros,
        "v": tree_map(lambda z: z.clone(), zeros),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def adamw_update(
    grads,
    state: Dict[str, Any],
    params,
    *,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step: new params (in their dtypes) and new state. Nothing
    is updated in place."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1, bc2 = 1 - b1 ** stepf, 1 - b2 ** stepf

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    paths = [path for path, _ in tree_flatten_with_path(grads)]

    def at(tree, path):
        for key in path:
            tree = tree[key]
        return tree

    out = [upd(g, at(state["m"], path), at(state["v"], path), at(params, path))
           for path, g in zip(paths, tree_leaves(grads))]
    new_p = tree_replace_leaves(grads, [o[0] for o in out])
    new_m = tree_replace_leaves(grads, [o[1] for o in out])
    new_v = tree_replace_leaves(grads, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}
