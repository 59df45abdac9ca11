"""The port's state-space modules against the JAX package, on the CPU.

Covers the two kernels of the state-space path through their plain versions
(``selective_scan``, ``flash_attention``: the wrappers run them for CPU
tensors) against the Pallas kernels in interpret mode and their oracles,
then ``attention_decode``, the mamba block and decode step, and ``forward``,
``prefill`` and ``decode_step`` of reduced hymba-1.5b (hybrid) and
falcon-mamba-7b (ssm). Inputs and weights are made with numpy / jax from a
seed and handed to both packages.

Tolerances: float32 against float32 arithmetic in another order: the JAX
block runs a chunked associative scan where the port runs the recurrence
step by step, so sums re-associate (1e-5 on the kernels, 1e-4 relative
through the model's projections). bfloat16 configs: every op rounds to
8 mantissa bits, and XLA fuses elementwise ops (skipping intermediate
roundings) where torch rounds after each one, so a few bfloat16 ulps of the
values' scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.selective_scan.ops import selective_scan as jax_scan
from repro.kernels.selective_scan.ref import selective_scan_ref as jax_scan_ref
from repro.models import attention as JA
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import selective_scan_chunked_ref, selective_scan_ref
from repro_torch.models import attention as PA
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STATE_NAMES = ["hymba-1.5b", "falcon-mamba-7b"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=0.05, atol=0.1)}


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a):
    return bridge.tensor_from_numpy(np.asarray(a), "cpu")


def _np(t):
    return t.to(torch.float32).numpy()


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got) if isinstance(got, torch.Tensor) else got,
                               np.asarray(want, np.float32), **tol)


def _pair(name, dtype, **overrides):
    """JAX and port configs and the same random weights in both packages,
    with non-zero norm scales, conv bias and dt bias so the test exercises
    them."""
    cfg = dataclasses.replace(jax_reduced_config(name, **overrides), dtype=dtype)
    pcfg = dataclasses.replace(reduced_config(name, **overrides), dtype=dtype)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    layers = params["layers"]
    for key in ("attn_norm", "ffn_norm"):
        if key in layers:
            layers[key] = jnp.asarray(0.1 * rng.standard_normal(layers[key].shape),
                                      layers[key].dtype)
    m = layers["mamba"]
    for key, scale in (("conv_b", 0.1), ("dt_bias", 0.5), ("D", 0.5)):
        m[key] = jnp.asarray(m[key] + scale * rng.standard_normal(m[key].shape), m[key].dtype)
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, pcfg, params, tparams


def _layer(tree, l):
    return jax.tree_util.tree_map(lambda a: a[l], tree)


# -- configs and weights ------------------------------------------------------
@pytest.mark.parametrize("name", STATE_NAMES)
def test_param_count_matches_jax(name):
    assert get_config(name).param_count() == jax_get_config(name).param_count()
    assert (reduced_config(name).param_count()
            == jax_reduced_config(name).param_count())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", STATE_NAMES)
def test_bridged_state_params_equal_bit_for_bit(name, dtype):
    """The nested mamba dict, with its float32 A_log, D and dt_bias beside
    the model-dtype weights, crosses the bridge bit for bit."""
    _, pcfg, params, tparams = _pair(name, dtype)
    flat = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, params))[0]
    assert {"A_log", "D", "dt_bias", "conv_w"} <= set(tparams["layers"]["mamba"])
    for path, leaf in flat:
        t = tparams
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == leaf.dtype.name, path
        if leaf.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), leaf.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), leaf)
    assert tparams["layers"]["mamba"]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("name", STATE_NAMES)
def test_init_params_structure_matches_jax(name):
    cfg = jax_reduced_config(name)
    jp = jax.tree_util.tree_map(np.asarray, JT.init_params(jax.random.PRNGKey(0), cfg))
    tp = PT.init_params(reduced_config(name), torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, tp))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            jax.tree_util.tree_leaves(tp)):
        assert tuple(b.shape) == a.shape and str(b.dtype).removeprefix("torch.") == \
            a.dtype.name, path
    m = tp["layers"]["mamba"]
    # log(1..n): the two libraries' logs may differ in the last float32 bit
    np.testing.assert_allclose(m["A_log"].numpy(), jp["layers"]["mamba"]["A_log"], rtol=2e-7)
    np.testing.assert_array_equal(m["D"].numpy(), jp["layers"]["mamba"]["D"])


# -- selective_scan -----------------------------------------------------------
def _scan_inputs(seed, b, s, d_in, n):
    x = _rand(seed, (b, s, d_in))
    dt = np.log1p(np.exp(_rand(seed + 1, (b, s)) - 1.0)).astype(np.float32)
    A = -np.exp(_rand(seed + 2, (d_in, n), 0.5))
    return x, dt, A, _rand(seed + 3, (b, s, n)), _rand(seed + 4, (b, s, n))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_matches_jax(dtype):
    b, s, d_in, n = 2, 32, 64, 8
    x, dt, A, B, C = _scan_inputs(0, b, s, d_in, n)
    if dtype == "bfloat16":  # bfloat16 x/B/C as the model passes them
        x, B, C = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (x, B, C))
    jargs = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    targs = [_t(a) for a in (x, dt, A, B, C)]
    y, h = selective_scan(*targs)
    assert y.dtype == h.dtype == torch.float32
    for yj, hj in (jax_scan(*jargs, block_s=16, block_d=32), jax_scan_ref(*jargs)):
        _close(y, yj, rtol=1e-5, atol=1e-5)
        _close(h, hj, rtol=1e-5, atol=1e-5)


def test_selective_scan_h0_resume_matches_jax():
    """Scanning [0:k) and resuming [k:s) from the carried state gives the
    whole scan, and the seeded resume agrees with JAX's."""
    b, s, k, d_in, n = 1, 64, 32, 64, 8
    x, dt, A, B, C = _scan_inputs(20, b, s, d_in, n)
    t = [_t(a) for a in (x, dt, A, B, C)]
    y_full, h_full = selective_scan(*t)
    _, h_mid = selective_scan(*(a[:, :k] if a.dim() > 2 or a is t[1] else a for a in t))
    tail = [a[:, k:] if a.dim() > 2 or a is t[1] else a for a in t]
    y_res, h_res = selective_scan(*tail, h_mid)
    torch.testing.assert_close(y_res, y_full[:, k:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h_res, h_full, rtol=1e-5, atol=1e-5)
    jtail = [jnp.asarray(_np(a)) for a in tail]
    yj, hj = jax_scan(*jtail, jnp.asarray(_np(h_mid)), block_s=16, block_d=32)
    _close(y_res, yj, rtol=1e-5, atol=1e-5)
    _close(h_res, hj, rtol=1e-5, atol=1e-5)


CHUNK = scan_ops.CHUNK


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("s", [1, 7, CHUNK, 3 * CHUNK + 5])
def test_selective_scan_chunked_decomposition_matches_jax(s, seeded):
    """The card's chunked scan, as its plain-torch decomposition (per-run
    folds, a scan of the runs' pairs, the carry from chunk to chunk), holds
    the JAX kernel's recurrence and the port's sequential plain version: the
    same float32 arithmetic re-associated, within 1e-5 of the largest value."""
    b, d_in, n = 2, 32, 8
    x, dt, A, B, C = _scan_inputs(30, b, s, d_in, n)
    h0 = _rand(35, (b, d_in, n)) if seeded else None
    targs = [_t(a) for a in (x, dt, A, B, C)] + [None if h0 is None else _t(h0)]
    y, h = selective_scan_chunked_ref(*targs, chunk=CHUNK, run=scan_ops.RUN)
    jargs = [jnp.asarray(a) for a in (x, dt, A, B, C)] + [None if h0 is None else jnp.asarray(h0)]
    for yw, hw in (jax_scan(*jargs, block_s=s, block_d=d_in),  # Pallas, interpreted
                   selective_scan_ref(*targs)):
        yw, hw = np.asarray(yw, np.float32), np.asarray(hw, np.float32)
        _close(y, yw, rtol=0, atol=1e-5 * np.abs(yw).max())
        _close(h, hw, rtol=0, atol=1e-5 * np.abs(hw).max())


def test_selective_scan_chunked_decomposition_resumes_bit_for_bit_on_a_chunk_boundary():
    """Cut on a chunk boundary the resumed decomposition runs the same
    chunks on the same carries: bit-identical; at a ragged cut the sums
    re-associate, so it agrees within 1e-5."""
    s, d_in, n = 2 * CHUNK + 40, 16, 4
    t = [_t(a) for a in _scan_inputs(40, 1, s, d_in, n)]
    kw = dict(chunk=CHUNK, run=scan_ops.RUN)
    y_full, h_full = selective_scan_chunked_ref(*t, **kw)
    for k in (CHUNK, CHUNK + 37):
        head = [a[:, :k] if a.dim() > 2 or a is t[1] else a for a in t]
        tail = [a[:, k:] if a.dim() > 2 or a is t[1] else a for a in t]
        _, h_mid = selective_scan_chunked_ref(*head, **kw)
        y_res, h_res = selective_scan_chunked_ref(*tail, h_mid, **kw)
        if k % CHUNK == 0:
            assert torch.equal(y_res, y_full[:, k:]) and torch.equal(h_res, h_full)
        else:
            _close(y_res, y_full[:, k:], rtol=0, atol=1e-5 * y_full.abs().max().item())
            _close(h_res, h_full, rtol=0, atol=1e-5 * h_full.abs().max().item())


# -- flash_attention ----------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_q,s_k,window,q_offset", [
    (64, 64, 0, 0), (64, 64, 24, 0), (32, 96, 0, 64), (32, 96, 40, 64)])
def test_flash_attention_matches_jax(dtype, s_q, s_k, window, q_offset):
    b, nq, nkv, d = 1, 10, 2, 16  # group 5, as hymba's heads
    q, k, v = _rand(0, (b, nq, s_q, d)), _rand(1, (b, nkv, s_k, d)), _rand(2, (b, nkv, s_k, d))
    if dtype == "bfloat16":
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = flash_attention(_t(q), _t(k), _t(v), **kw)
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kernel = jax_flash(jq, jk, jv, block_q=16, block_k=16, **kw)  # Pallas, interpreted
    oracle = jax_flash_ref(jq, jk, jv, **kw)
    # float32: the same arithmetic in another order; bfloat16: each side
    # rounds the output once (the JAX oracle also rounds P to bfloat16 before
    # P V), so one bfloat16 ulp of the largest output
    scale = float(np.abs(np.asarray(kernel, np.float32)).max())
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=0, atol=2 ** -7 * scale)
    _close(got, kernel, **tol)
    _close(got, oracle, **tol)


def test_attention_prefill_on_cpu_keeps_the_blockwise_form():
    """On the CPU attention_prefill is JAX's block-wise form, and it agrees
    with the flash_attention plain version the card path computes."""
    b, s, nq, nkv, d = 1, 40, 10, 2, 16
    q, k, v = _rand(3, (b, s, nq, d)), _rand(4, (b, s, nkv, d)), _rand(5, (b, s, nkv, d))
    for window in (0, 12):
        got = PA.attention_prefill(_t(q), _t(k), _t(v), window=window, block_q=16)
        want = JA.attention_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    window=window, block_q=16)
        _close(got, want, rtol=1e-5, atol=1e-5)
        flash = flash_attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                                _t(v).transpose(1, 2), window=window).transpose(1, 2)
        torch.testing.assert_close(flash, got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_attention_decode_matches_jax(dtype, window):
    b, S, nq, nkv, d, length = 2, 24, 10, 2, 16, 17
    q, kc, vc = _rand(6, (b, 1, nq, d)), _rand(7, (b, S, nkv, d)), _rand(8, (b, S, nkv, d))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, kc, vc = (np.asarray(jnp.asarray(a, jdt)) for a in (q, kc, vc))
    got = PA.attention_decode(_t(q), _t(kc), _t(vc), length=length, window=window)
    want = JA.attention_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               length=length, window=window)
    _close(got, want, **({"rtol": 1e-5, "atol": 1e-6} if dtype == "float32" else TOL[dtype]))


# -- mamba block and decode step ------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [2, 37])  # s < k - 1: the carried window keeps zeros
def test_mamba_block_matches_jax(dtype, s):
    cfg, pcfg, params, tparams = _pair("hymba-1.5b", dtype)
    jp, tp = _layer(params["layers"]["mamba"], 0), PT.layer_params(tparams, 0)["mamba"]
    x = np.asarray(jnp.asarray(_rand(9, (2, s, cfg.d_model)), cfg.activation_dtype()))
    out_j, (h_j, conv_j) = JS.mamba_block(jnp.asarray(x), jp, cfg, return_state=True)
    out_t, (h_t, conv_t) = PS.mamba_block(_t(x), tp, pcfg, return_state=True)
    assert out_t.dtype == pcfg.activation_dtype() and h_t.dtype == torch.float32
    assert tuple(conv_t.shape) == conv_j.shape == (2, cfg.ssm_conv - 1, cfg.d_inner)
    _close(out_t, out_j, **TOL[dtype])
    _close(h_t, h_j, **TOL[dtype])
    _close(conv_t, conv_j, rtol=0, atol=0)  # raw projections: the same GEMM result
    if s < cfg.ssm_conv - 1:
        assert not conv_t[:, : cfg.ssm_conv - 1 - s].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_step_matches_jax(dtype):
    cfg, pcfg, params, tparams = _pair("falcon-mamba-7b", dtype)
    jp, tp = _layer(params["layers"]["mamba"], 1), PT.layer_params(tparams, 1)["mamba"]
    b = 2
    x = np.asarray(jnp.asarray(_rand(10, (b, 1, cfg.d_model)), cfg.activation_dtype()))
    h0 = _rand(11, (b, cfg.d_inner, cfg.ssm_state), 0.5)
    conv0 = np.asarray(jnp.asarray(_rand(12, (b, cfg.ssm_conv - 1, cfg.d_inner)),
                                   cfg.activation_dtype()))
    out_t, (h_t, conv_t) = PS.mamba_decode_step(_t(x), (_t(h0), _t(conv0)), tp, pcfg)
    for use_kernel in (True, False):  # the Pallas path real serving takes, and XLA's
        out_j, (h_j, conv_j) = JS.mamba_decode_step(
            jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(conv0)), jp, cfg,
            use_kernel=use_kernel)
        _close(out_t, out_j, **TOL[dtype])
        _close(h_t, h_j, **TOL[dtype])
        _close(conv_t, conv_j, rtol=0, atol=0)


# -- ssm_scan_dtype: the JAX block's bfloat16 scan is refused, not ignored -----
def test_mamba_block_refuses_a_bfloat16_scan(monkeypatch):
    """At ssm_scan_dtype "bfloat16" the JAX block keeps its scan elements and
    the h . C product in bfloat16, so its output moves off the float32 one
    on the same weights; the port's block, whose scan runs in float32 only,
    raises ValueError instead, with and without grad, before any scan."""
    cfg, pcfg, params, tparams = _pair("hymba-1.5b", "float32")
    jp, tp = _layer(params["layers"]["mamba"], 0), PT.layer_params(tparams, 0)["mamba"]
    x = _rand(13, (2, 37, cfg.d_model))
    bf_cfg = dataclasses.replace(cfg, ssm_scan_dtype="bfloat16")
    bf_pcfg = dataclasses.replace(pcfg, ssm_scan_dtype="bfloat16")
    want = np.asarray(JS.mamba_block(jnp.asarray(x), jp, cfg))
    got_bf = np.asarray(JS.mamba_block(jnp.asarray(x), jp, bf_cfg))
    assert np.abs(got_bf - want).max() > 1e-4 * np.abs(want).max()  # the setting is felt
    _close(PS.mamba_block(_t(x), tp, pcfg), want, **TOL["float32"])
    calls = []
    monkeypatch.setattr(PS, "selective_scan", lambda *a, **k: calls.append("scan"))
    monkeypatch.setattr(PS, "SelectiveScanFn", None)  # any use of it fails differently
    with pytest.raises(ValueError, match="ssm_scan_dtype"):
        PS.mamba_block(_t(x), tp, bf_pcfg)
    tracked = {k: v.clone().requires_grad_() for k, v in tp.items()}
    with pytest.raises(ValueError, match="ssm_scan_dtype"):
        PS.mamba_block(_t(x), tracked, bf_pcfg, return_state=True)
    assert calls == []


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_step_ignores_the_scan_dtype_as_jax_does(dtype):
    """The JAX decode step does not read ssm_scan_dtype; the port's matches
    it at "bfloat16" as at "float32"."""
    cfg, pcfg, params, tparams = _pair("hymba-1.5b", dtype)
    cfg = dataclasses.replace(cfg, ssm_scan_dtype="bfloat16")
    pcfg = dataclasses.replace(pcfg, ssm_scan_dtype="bfloat16")
    jp, tp = _layer(params["layers"]["mamba"], 0), PT.layer_params(tparams, 0)["mamba"]
    b = 2
    x = np.asarray(jnp.asarray(_rand(14, (b, 1, cfg.d_model)), cfg.activation_dtype()))
    h0 = _rand(15, (b, cfg.d_inner, cfg.ssm_state), 0.5)
    conv0 = np.asarray(jnp.asarray(_rand(16, (b, cfg.ssm_conv - 1, cfg.d_inner)),
                                   cfg.activation_dtype()))
    out_t, (h_t, _) = PS.mamba_decode_step(_t(x), (_t(h0), _t(conv0)), tp, pcfg)
    out_j, (h_j, _) = JS.mamba_decode_step(jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(conv0)),
                                           jp, cfg)
    _close(out_t, out_j, **TOL[dtype])
    _close(h_t, h_j, **TOL[dtype])


# -- whole models ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", STATE_NAMES)
def test_forward_prefill_decode_match_jax(name, dtype):
    cfg, pcfg, params, tparams = _pair(name, dtype, n_layers=3)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 21))
    # forward, with per-layer KV for the hybrid
    lj, kvj = JT.forward(params, {"tokens": jnp.asarray(toks)}, cfg, block_q=8,
                         return_kv=True)
    lt, kvt = PT.forward(tparams, {"tokens": torch.as_tensor(toks)}, pcfg, block_q=8,
                         return_kv=True)
    _close(lt, lj, **TOL[dtype])
    if cfg.has_attention:
        for a, b in zip(kvj, kvt):
            _close(b, a, **TOL[dtype])
    else:
        assert kvt is None
    # prefill into a serve state with room for 4 decode tokens, then decode
    sj = JT.init_serve_state(cfg, 1, toks.shape[1] + 4)
    st = PT.init_serve_state(pcfg, 1, toks.shape[1] + 4, device="cpu")
    assert set(st) == set(sj)
    lj, sj = JT.prefill(params, {"tokens": jnp.asarray(toks)}, cfg, sj, block_q=8)
    lt, st = PT.prefill(tparams, {"tokens": torch.as_tensor(toks)}, pcfg, st, block_q=8)
    _close(lt, lj, **TOL[dtype])
    assert st["length"] == int(sj["length"]) == toks.shape[1]
    for step in range(3):
        for key in ("k", "v", "ssm_h", "ssm_conv"):
            if key in sj:
                _close(st[key], sj[key], **TOL[dtype])
        tok = np.array([[int(np.argmax(np.asarray(lj)[0, -1]))]])
        lj, sj = JT.decode_step(params, jnp.asarray(tok), cfg, sj, ssm_kernel=True)
        lt, st = PT.decode_step(tparams, torch.as_tensor(tok), pcfg, st)
        _close(lt, lj, **TOL[dtype])
        assert st["length"] == int(sj["length"])
