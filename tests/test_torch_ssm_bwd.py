"""selective_scan's backward: the plain versions against autograd and jax.vjp.

``selective_scan_bwd_ref`` (the backward kernel's plain version, which the
CPU path of ``selective_scan_bwd`` and of ``SelectiveScanFn`` runs) is held
against torch autograd through ``selective_scan_ref``, against ``jax.vjp``
of the JAX package's scan oracle (``repro.kernels.selective_scan.ref``, with
h0) and against ``jax.vjp`` of ``repro.models.ssm._selective_scan_chunked``,
the function JAX training differentiates (dt broadcast over d_in there, its
cotangent summed over d_in here). ``selective_scan_bwd_chunked_ref``, the
backward kernel's decomposition (chunks walked from last to first from the
forward's carries, runs folded backwards, a suffix scan over runs), is held
against the sequential form. float32 inputs made with numpy from a seed,
random dy and dh_final; each gradient within 1e-5 of its largest element
(float32 sums in other orders). ``SelectiveScanFn`` passes
``torch.autograd.gradcheck`` in float64, where the plain versions compute in
float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ref import selective_scan_ref as jax_scan_ref
from repro.models.ssm import _selective_scan_chunked as jax_scan_chunked
from repro_torch.configs import reduced_config
from repro_torch.kernels.selective_scan import ops as ss
from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_chunked_ref,
                                                   selective_scan_bwd_ref, selective_scan_ref)
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT

REL = 1e-5
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dh0")
SHAPES = [(1, 1, 32, 4), (2, 7, 48, 16), (2, 40, 32, 4), (1, 300, 48, 16)]  # b, s, d_in, n


def _inputs(seed, b, s, d_in, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d_in))
    dt = np.log1p(np.exp(rng.standard_normal((b, s)) - 1.0))  # softplus
    A = -np.exp(rng.standard_normal((d_in, n)))
    B = rng.standard_normal((b, s, n))
    C = rng.standard_normal((b, s, n))
    h0 = rng.standard_normal((b, d_in, n))
    dy = rng.standard_normal((b, s, d_in))
    dh = rng.standard_normal((b, d_in, n))
    return tuple(a.astype(dtype) for a in (x, dt, A, B, C, h0, dy, dh))


def _close(got, want, rel=REL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + 1e-30, (name, err, np.abs(want).max())


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("b,s,d_in,n", SHAPES)
def test_bwd_ref_matches_torch_autograd(b, s, d_in, n, seeded):
    x, dt, A, B, C, h0, dy, dh = _t(*_inputs(0, b, s, d_in, n))
    h0, dh = (h0, dh) if seeded else (None, None)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, h = selective_scan_ref(*leaves, h0)
    want = torch.autograd.grad((y, h), leaves, (dy, torch.zeros_like(h) if dh is None else dh))
    got = selective_scan_bwd_ref(x, dt, A, B, C, h0, dy, dh)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w.numpy(), name=name)
    if seeded:  # dh0 against autograd through h0
        h0l = h0.clone().requires_grad_()
        y, h = selective_scan_ref(x, dt, A, B, C, h0l)
        (want_h0,) = torch.autograd.grad((y, h), (h0l,), (dy, dh))
        _close(got[5].numpy(), want_h0.numpy(), name="dh0")


@pytest.mark.parametrize("b,s,d_in,n", [(2, 7, 48, 16), (2, 300, 32, 4)])
def test_bwd_ref_matches_jax_vjp_of_the_scan_reference(b, s, d_in, n):
    x, dt, A, B, C, h0, dy, dh = _inputs(1, b, s, d_in, n)
    _, vjp = jax.vjp(jax_scan_ref, *map(jnp.asarray, (x, dt, A, B, C, h0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = selective_scan_bwd_ref(*_t(x, dt, A, B, C, h0, dy, dh))
    for name, g, w in zip(GRADS, got, want):
        _close(g.numpy(), w, name=name)


@pytest.mark.parametrize("b,s,d_in,n,chunk", [(2, 300, 32, 16, 128)])  # a ragged third chunk
def test_bwd_ref_matches_jax_vjp_of_the_chunked_scan(b, s, d_in, n, chunk):
    """The function JAX training differentiates: dt (b, s, d_in), the scalar
    dt broadcast over the channels, from a zero state."""
    x, dt, A, B, C, _, dy, dh = _inputs(2, b, s, d_in, n)
    dt_full = np.broadcast_to(dt[..., None], (b, s, d_in)).copy()
    _, vjp = jax.vjp(lambda *a: jax_scan_chunked(*a, chunk=chunk),
                     *map(jnp.asarray, (x, dt_full, A, B, C)))
    wx, wdt, wA, wB, wC = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = selective_scan_bwd_ref(*_t(x, dt, A, B, C), None, *_t(dy, dh))
    for name, g, w in zip(GRADS, got, (wx, np.asarray(wdt).sum(-1), wA, wB, wC)):
        _close(g.numpy(), w, name=name)


@pytest.mark.parametrize("s,chunk,run", [(1, 16, 4), (7, 16, 4), (40, 16, 4), (300, 32, 4),
                                         (300, 256, 16), (600, 256, 16),
                                         (5, 256, 8), (300, 256, 8), (600, 256, 8)])
@pytest.mark.parametrize("seeded", [False, True])
def test_chunked_bwd_matches_sequential(s, chunk, run, seeded):
    """The backward kernel's decomposition: ragged last chunks, one run a
    chunk too few to scan, 256 / 16 over two and three chunks, and the
    kernel's 256 / 8 (32 runs: a warp a channel) over one, two and three."""
    x, dt, A, B, C, h0, dy, dh = _t(*_inputs(3, 2, s, 40, 8))
    h0, dh = (h0, dh) if seeded else (None, None)
    want = selective_scan_bwd_ref(x, dt, A, B, C, h0, dy, dh)
    got = selective_scan_bwd_chunked_ref(x, dt, A, B, C, h0, dy, dh, chunk=chunk, run=run)
    for name, g, w in zip(GRADS, got, want):
        _close(g.numpy(), w.numpy(), name=name)


def test_bwd_refs_keep_the_inputs_dtypes():
    """16-bit x, B, C and dt get their gradients rounded once to their
    dtypes; dA and dh0 stay float32."""
    x, dt, A, B, C, h0, dy, dh = _t(*_inputs(4, 1, 40, 32, 4))
    bf = torch.bfloat16
    args = (x.to(bf), dt.to(bf), A, B.to(bf), C.to(bf), h0, dy, dh)
    want32 = selective_scan_bwd_ref(*(t.float() for t in args))
    got = selective_scan_bwd_ref(*args)  # the same float32 values, rounded once
    assert all(torch.equal(g, w.to(g.dtype)) for g, w in zip(got, want32))
    got = selective_scan_bwd_chunked_ref(*args)  # within one bfloat16 ulp of the largest
    assert [g.dtype for g in got] == [bf, bf, torch.float32, bf, bf, torch.float32]
    for g, w in zip(got, want32):
        _close(g.float().numpy(), w.numpy(), rel=2.0 ** -7)


@pytest.mark.parametrize("b,s", [(2, 1), (2, 6), (1, 17)])
def test_selective_scan_fn_gradcheck(b, s):
    x, dt, A, B, C, h0, _, _ = _t(*_inputs(5, b, s, 3, 2, np.float64))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C, h0)]
    assert torch.autograd.gradcheck(ss.SelectiveScanFn.apply, leaves)


def test_selective_scan_fn_on_cpu_runs_the_plain_versions():
    """On CPU tensors the Function's gradients are selective_scan_bwd_ref's,
    bit for bit; inputs that need none get None; the wrappers refuse the
    carries (the CUDA kernels' own buffer)."""
    x, dt, A, B, C, h0, dy, dh = _t(*_inputs(6, 2, 40, 32, 4))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C, h0)]
    y, h = ss.SelectiveScanFn.apply(*leaves)
    yr, hr = selective_scan_ref(x, dt, A, B, C, h0)
    assert torch.equal(y, yr) and torch.equal(h, hr)
    got = torch.autograd.grad((y, h), leaves, (dy, dh))
    want = selective_scan_bwd_ref(x, dt, A, B, C, h0, dy, dh)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(ss.selective_scan_bwd(x, dt, A, B, C, h0, dy, dh)[0], want[0])
    only_x = [x.clone().requires_grad_(), dt, A, B, C, None]
    y, h = ss.SelectiveScanFn.apply(*only_x)
    (gx,) = torch.autograd.grad(y, only_x[:1], dy)  # h_final's gradient is None: zeros
    assert torch.equal(gx, selective_scan_bwd_ref(x, dt, A, B, C, None, dy)[0])
    with pytest.raises(ValueError, match="carries"):
        ss.selective_scan(x, dt, A, B, C, carries=ss.carries_buffer(x, 4))
    with pytest.raises(ValueError, match="carries"):
        ss.selective_scan_bwd(x, dt, A, B, C, None, dy, carries=ss.carries_buffer(x, 4))


def test_mamba_block_trains_through_selective_scan_fn(monkeypatch):
    """Under grad, with weights that require grad, mamba_block calls
    SelectiveScanFn; without grad, or without a tracked input, the wrapper."""
    cfg = reduced_config("hymba-1.5b", dtype="float32")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = {k: v[0] for k, v in params["layers"]["mamba"].items()}
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 20, cfg.d_model))
                         .astype(np.float32))
    calls = []

    class Counting(ss.SelectiveScanFn):
        @staticmethod
        def forward(ctx, *a):
            calls.append("fn")
            return ss.SelectiveScanFn.forward(ctx, *a)

    monkeypatch.setattr(PS, "SelectiveScanFn", Counting)
    want = PS.mamba_block(x, p, cfg)
    assert calls == [] and want.grad_fn is None
    tracked = {k: v.clone().requires_grad_() for k, v in p.items()}
    out = PS.mamba_block(x, tracked, cfg)
    assert calls == ["fn"] and torch.equal(out, want)
    with torch.no_grad():
        PS.mamba_block(x, tracked, cfg)
    assert calls == ["fn"]
    grads = torch.autograd.grad(out.sum(), list(tracked.values()))
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
