"""flash_attention's backward: the plain version against autograd and jax.grad.

``flash_attention_bwd_ref`` (the backward kernel's plain version, which the
CPU path of ``flash_attention_bwd`` runs) is held against torch autograd
through ``flash_attention_ref`` and against ``jax.grad`` through the JAX
package's jnp oracle (``repro.kernels.flash_attention.ref``; ``pallas_call``
has no autodiff). float32 inputs made with numpy from a seed; each gradient
within 1e-5 of its largest element (float32 sums of at most a few hundred
terms in other orders). ``FlashAttentionFn`` on CPU tensors runs the plain
forward and backward, so its gradients equal the plain version's.
``flash_attention_lse_ref`` (the logsumexp the wgmma forward saves for the
backward, in log2 units) is held against ``jax.nn.logsumexp`` of the same
masked, scaled float32 scores times log2(e), within 1e-5 of the largest
|lse| (float32 sums in other orders). Head dims 16, 64 and 256 (gemma3-4b,
whose backward on the card is the wgmma variant's d-256 kernels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_lse_ref, flash_attention_ref)

REL = 1e-5


def _inputs(seed, b, n_q, n_kv, s_q, s_k, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n_q, s_q, d)).astype(np.float32)
    k = rng.standard_normal((b, n_kv, s_k, d)).astype(np.float32)
    v = rng.standard_normal((b, n_kv, s_k, d)).astype(np.float32)
    do = rng.standard_normal((b, n_q, s_q, d)).astype(np.float32)
    return q, k, v, do


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


CASES = [  # group, causal, window, d, s_q, q_offset
    (g, True, w, d, 37, 0) for g in (1, 2, 4) for w in (0, 5) for d in (16, 64)
] + [
    (2, True, 0, 16, 70, 0),    # two 64-row tiles and a ragged third
    (2, True, 9, 64, 70, 0),
    (4, True, 0, 16, 19, 13),   # queries at positions 13.. over 32 keys
    (2, True, 6, 16, 19, 13),
    (1, False, 0, 64, 23, 0),   # every key visible
] + [
    # gemma3-4b's head dim, which the wgmma backward's d-256 kernels take
    (g, True, w, 256, s, 0) for g in (1, 2) for w in (0, 9) for s in (37, 70)
]


@pytest.mark.parametrize("group,causal,window,d,s_q,q_offset", CASES)
def test_bwd_ref_matches_torch_autograd(group, causal, window, d, s_q, q_offset):
    n_kv = 2
    s_k = s_q + q_offset
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(0, 2, group * n_kv, n_kv, s_q, s_k, d))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_ref(*leaves, **kw)
    want = torch.autograd.grad(out, leaves, do)
    got = flash_attention_bwd_ref(q, k, v, out.detach(), do, **kw, block_q=16)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w.numpy())


@pytest.mark.parametrize("group,causal,window,d,s_q,q_offset", CASES)
def test_bwd_ref_matches_jax_grad(group, causal, window, d, s_q, q_offset):
    n_kv = 2
    s_k = s_q + q_offset
    q, k, v, do = _inputs(1, 2, group * n_kv, n_kv, s_q, s_k, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, vjp = jax.vjp(lambda a, b_, c: jax_flash_ref(a, b_, c, **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = flash_attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                  torch.from_numpy(np.array(out)), torch.from_numpy(do), **kw)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("window", [0, 7])
def test_flash_attention_fn_on_the_cpu(window):
    """The autograd Function's gradients are the plain backward's, and the
    CPU wrapper of the backward runs that plain version."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 1, 8, 2, 45, 45, 32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.FlashAttentionFn.apply(*leaves, True, window, 0)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    want = fa.flash_attention_bwd(q, k, v, out.detach(), do, window=window)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ref = torch.autograd.grad(flash_attention_ref(*leaves, window=window), leaves, do)
    for g, w in zip(got, ref):
        _close(g.numpy(), w.numpy())


def test_bwd_ref_keeps_input_dtypes():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(3, 1, 4, 2, 20, 20, 16))
    out = flash_attention_ref(q, k, v)
    got = flash_attention_bwd_ref(q, k, v, out, do)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]


LSE_CASES = [  # causal, window, q_offset, s_q, s_k
    (True, 0, 0, 37, 37),
    (True, 5, 0, 37, 37),
    (True, 0, 13, 19, 32),
    (True, 6, 13, 19, 32),
    (False, 0, 0, 23, 23),
    (True, 5, 0, 19, 8),  # rows 12 on see no key: lse 0
]


@pytest.mark.parametrize("causal,window,q_offset,s_q,s_k", LSE_CASES)
def test_lse_ref_matches_jax_logsumexp(causal, window, q_offset, s_q, s_k, d=32):
    q, k, _, _ = _inputs(4, 2, 4, 2, s_q, s_k, d)
    got = flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), causal=causal,
                                  window=window, q_offset=q_offset, block_q=16)
    assert got.dtype == torch.float32 and got.shape == (2, 4, s_q)
    sc = jnp.einsum("bngsd,bntd->bngst", jnp.asarray(q).reshape(2, 2, 2, s_q, d),
                    jnp.asarray(k)) * d ** -0.5
    i = q_offset + jnp.arange(s_q)[:, None]
    t = jnp.arange(s_k)[None, :]
    vis = jnp.ones((s_q, s_k), bool)
    if causal:
        vis &= t <= i
    if window > 0:
        vis &= i - t < window
    lse = jax.nn.logsumexp(jnp.where(vis, sc, -jnp.inf), axis=-1) / np.log(2.0)
    want = np.where(vis.any(-1), np.asarray(lse), 0.0).reshape(2, 4, s_q)
    _close(got.numpy(), want)
    if s_k == 8:
        assert (got[..., 12:] == 0).all()


@pytest.mark.parametrize("causal,window,q_offset,s_q,s_k", [LSE_CASES[1], LSE_CASES[5]])
def test_lse_ref_matches_jax_logsumexp_head_dim_256(causal, window, q_offset, s_q, s_k):
    """The logsumexp the wgmma forward saves at gemma3-4b's head dim."""
    test_lse_ref_matches_jax_logsumexp(causal, window, q_offset, s_q, s_k, d=256)
