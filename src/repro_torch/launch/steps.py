"""Step factories: train_step (grad-accum + remat + AdamW), prefill_step,
decode_step, and the ContiguousKV sparse decode step.

Batches may be numpy arrays or tensors; a train step moves them to the
params' device. Entry points run where the params live: on the card unless
the caller built them on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import transformer as T
from repro_torch.models.attention import NEG_INF, _grouped_out, _grouped_scores, qkv_project
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.train import compression as GC
from repro_torch.train.optimizer import adamw_update
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map, tree_replace_leaves


def _batch_on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_value_and_grad(cfg: ModelConfig, *, grad_accum: int = 1, block_q: int = 512,
                        remat=True):
    """Returns value_and_grad(params, batch) -> (loss, grads), the first half
    of a train step.

    With ``grad_accum`` > 1 the batch's leading dim is cut into that many
    microbatches, each differentiated on its own; the gradients are added in
    float32 accumulators and the losses summed in microbatch order, as the
    JAX package's ``lax.scan`` does, then both divided by ``grad_accum``.
    With ``grad_accum`` 1 the gradients keep the params' dtypes."""

    def one(params, mb):
        flat = tree_flatten_with_path(params)
        leaves = [leaf.detach().requires_grad_() for _, leaf in flat]
        tracked = tree_replace_leaves(params, leaves)
        with torch.enable_grad():
            loss = T.loss_fn(tracked, mb, cfg, block_q=block_q, remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not read (the token embedding of a batch of
        # frame embeddings) gets zeros, as jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), tree_replace_leaves(params, grads)

    def value_and_grad(params, batch):
        batch = _batch_on(batch, tree_leaves(params)[0].device)
        if grad_accum == 1:
            return one(params, batch)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)
        lsum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
        for i in range(grad_accum):
            mb = {k: v[i * (v.shape[0] // grad_accum): (i + 1) * (v.shape[0] // grad_accum)]
                  for k, v in batch.items()}
            l_i, g_i = one(params, mb)
            # in place: the same float32 sums as acc + g, without a second copy
            tree_map(lambda a, g: a.add_(g.to(torch.float32)), acc, g_i)
            lsum = lsum + l_i
            del g_i
        tree_map(lambda a: a.div_(grad_accum), acc)
        return lsum / grad_accum, acc

    return value_and_grad


def make_train_step(
    cfg: ModelConfig,
    *,
    grad_accum: int = 1,
    block_q: int = 512,
    remat=True,
    lr: float = 3e-4,
    grad_compression: Optional[str] = None,  # None | "int8"
):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics):
    the loss and gradients (``make_value_and_grad``), the int8 numerics if
    asked, then AdamW. ``metrics["loss"]`` stays on the device."""
    value_and_grad = make_value_and_grad(cfg, grad_accum=grad_accum, block_q=block_q,
                                         remat=remat)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch)
        if grad_compression == "int8":
            grads = GC.quantize_dequantize_tree(grads)
        new_params, new_opt = adamw_update(grads, opt_state, params, lr=lr)
        return new_params, new_opt, {"loss": loss}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, block_q: int = 512):
    """prefill_step(params, batch, state) -> (first-token logits, state)."""

    def prefill_step(params, batch, state):
        return T.prefill(params, batch, cfg, state, block_q=block_q)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, token, state) -> (logits, state)."""

    def decode_step(params, token, state):
        return T.decode_step(params, token, cfg, state)

    return decode_step


def make_sparse_decode_step(cfg: ModelConfig, *, chunk_tokens: int = 16,
                            budget: float = 0.05, cached_summaries: bool = False):
    """ContiguousKV-sparse decode: one new token attends to only the
    top-(budget) ContiguousChunks of the cached context per layer.

    Per layer, chunk scores of the query against chunk-mean keys pick
    ``max(1, int(budget * m))`` of the m chunks of the serve state's K cache
    (``state["k"]``, (L, b, S, n_kv, d) with S a multiple of
    ``chunk_tokens``); attention runs over the picked chunks' positions
    only. Ties go to the lower chunk index, as ``lax.top_k`` breaks them.
    Plain torch, as the JAX package computes it outside any kernel.

    ``cached_summaries=True`` keeps the chunk-mean keys in the state
    (``state["kmean"]``, (L, b, m, n_kv, d)) and adds the new key's 1/c share
    to its chunk's mean, so identification never re-reads the K cache. The
    state's buffers are updated in place and the same dict is returned, as
    the port's ``decode_step`` does."""
    if not cfg.has_attention:
        raise ValueError(f"{cfg.name}: the sparse decode step needs attention layers")
    c, n_kv, d = chunk_tokens, cfg.n_kv_heads, cfg.d_head

    def sparse_decode_step(params, token, state):
        h = token.to(cfg.activation_dtype()) if token.dim() == 3 else params["embed"][token]
        b = h.shape[0]
        length = int(state["length"])
        m_chunks = state["k"].shape[2] // c
        k_sel_count = max(1, int(budget * m_chunks))
        dev = h.device
        positions = torch.full((b, 1), length, dtype=torch.long, device=dev)
        cpos = torch.arange(m_chunks, device=dev) * c
        rows = torch.arange(b, device=dev)[:, None]
        for l in range(cfg.n_layers):
            lp = T.layer_params(params, l)
            xn = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
            q, k_new, v_new = qkv_project(xn, lp, cfg, positions)
            k_cache, v_cache = state["k"][l], state["v"][l]
            k_cache[:, length: length + 1] = k_new
            v_cache[:, length: length + 1] = v_new
            kc = k_cache.reshape(b, m_chunks, c, n_kv, d)
            if cached_summaries:
                kmean = state["kmean"][l]
                kmean[:, length // c] += (k_new[:, 0] / c).to(kmean.dtype)
                k_mean = kmean
            else:
                k_mean = kc.mean(dim=2)  # re-reads the whole K cache
            scores = _grouped_scores(q, k_mean)  # (b, n_q, 1, m)
            chunk_scores = scores.to(torch.float32).sum(dim=(1, 2))  # (b, m)
            chunk_scores = torch.where(cpos[None] < length + 1, chunk_scores,
                                       float("-inf"))
            top_idx = torch.sort(chunk_scores, dim=-1, descending=True,
                                 stable=True).indices[:, :k_sel_count]
            k_flat = kc[rows, top_idx].reshape(b, k_sel_count * c, n_kv, d)
            v_flat = v_cache.reshape(kc.shape)[rows, top_idx].reshape(b, k_sel_count * c, n_kv, d)
            sel_pos = (top_idx[:, :, None] * c
                       + torch.arange(c, device=dev)[None, None, :]).reshape(b, -1)
            valid = sel_pos <= length  # positions of a picked chunk past the new token
            att = _grouped_scores(q, k_flat).to(torch.float32) * (d ** -0.5)
            att = torch.where(valid[:, None, None, :], att, NEG_INF)
            p = torch.softmax(att, dim=-1).to(v_flat.dtype)
            h = h + T._out_proj(_grouped_out(p, v_flat), lp, cfg)
            h = T._ffn(h, lp, cfg, dropless=True)
        state["length"] = length + 1
        return T._logits(params, h, cfg), state

    return sparse_decode_step
