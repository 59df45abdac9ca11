"""In-house AdamW with global-norm clipping (float32 moments), in the JAX
package's order of operations.

The state is ``{"m": tree, "v": tree, "step": 0-dim int32 tensor}`` on the
params' device. ``global_norm`` sums the leaves in float32 in JAX's order
(dict keys sorted), as the reference does, each leaf's sum of squares
accumulated in float64 and rounded once, so that ``global_norm_blocks``
(a train step over a mesh, which sums each block of a leaf on its own)
gives the same clip but through float64's rounding, far below a float32
ulp. The float64 sums cost every train step about 20 bytes of traffic an
element of a float32 gradient (its read, a float64 copy of a chunk, the
copy's read) against float32's 12, and a temporary of ``CHUNK_ELEMENTS``
float64 (PERF.md has the time).

A leaf of more than ``CHUNK_ELEMENTS`` elements is updated a slice of its
leading dim (a layer of a stacked leaf, rows of an embedding) at a time into
its new tensors: the update is elementwise, so the bits are the same, and
its float32 temporaries stay a slice's size instead of several copies of the
largest leaf (a stacked expert or embedding leaf of ~1e9 elements would
want 4 GB each).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map, tree_replace_leaves


CHUNK_ELEMENTS = 1 << 25  # elements of a slice the update takes at a time


def adamw_init(params) -> Dict[str, Any]:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    device = tree_leaves(params)[0].device
    return {
        "m": zeros,
        "v": tree_map(lambda z: z.clone(), zeros),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """sum(x ** 2) in float64, ``CHUNK_ELEMENTS`` at a time: each chunk's
    float64 copy read once by one reduction (its L2 norm, squared)."""
    flat = x.reshape(-1)
    return sum(torch.linalg.vector_norm(flat[i: i + CHUNK_ELEMENTS].to(torch.float64)) ** 2
               for i in range(0, flat.numel(), CHUNK_ELEMENTS))


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf's elements together, float32: each leaf's
    sum of squares accumulated in float64 and rounded once, the leaves'
    sums added in float32 in order."""
    return torch.sqrt(sum(_sum_squares(x).to(torch.float32) for x in tree_leaves(tree)))


def global_norm_blocks(leaves) -> torch.Tensor:
    """``global_norm`` of a tree held as ``leaves``, each the list of its
    distinct blocks (every element once): a leaf's blocks' float64 sums of
    squares added on the first block's device and rounded once, so the
    result is the whole tree's but for float64's rounding."""
    home = leaves[0][0].device
    return torch.sqrt(sum(sum(_sum_squares(b).to(home) for b in blocks).to(torch.float32)
                          for blocks in leaves))


def clip_factor(norm: torch.Tensor, clip_norm: float = 1.0) -> torch.Tensor:
    """min(1, clip_norm / norm): the global-norm clip's factor."""
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_scale(grads, clip_norm: float = 1.0) -> torch.Tensor:
    """The global-norm clip's factor on every gradient of the tree
    ``grads``."""
    return clip_factor(global_norm(grads), clip_norm)


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
    scale=None,
) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step: new params (in their dtypes) and new state. Nothing
    is updated in place. ``scale`` is the clip factor where the caller
    computed it over a larger tree than ``grads`` (a mesh position's blocks
    of the global gradient); else ``clip_scale(grads, clip_norm)``."""
    step = state["step"] + 1
    if scale is None:
        scale = clip_scale(grads, clip_norm)
    stepf = step.to(torch.float32)
    bc1, bc2 = 1 - b1 ** stepf, 1 - b2 ** stepf

    def upd_slice(g, m, v, p):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    def upd(g, m, v, p):
        if g.dim() == 0 or g.numel() <= CHUNK_ELEMENTS:
            return upd_slice(g, m, v, p)
        rows = max(1, CHUNK_ELEMENTS // (g.numel() // g.shape[0]))
        out = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
        for lo in range(0, g.shape[0], rows):
            part = slice(lo, lo + rows)
            for o, x in zip(out, upd_slice(g[part], m[part], v[part], p[part])):
                o[part] = x
        return out

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
