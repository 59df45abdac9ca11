"""The port's decode pools and batched decode step, on the CPU.

Contracts, as the JAX package's tests/test_device_pool.py pins them for its
own pools:

1. a DeviceTailPool fed the same resident pages, suffix KV and per-step
   token KV as a host TailPool holds the same buffers and drives
   decode_attention to the same results, bit for bit, over a multi-token
   decode and in a ragged batch;
2. swap_out / swap_in restore the buffers bit for bit and report the bytes
   moved; a second swap the same way raises; the host pool's swap is free;
3. after warm-up the device pool moves no pool bytes host-to-device, by the
   torch meter (``repro_torch.storage.h2d_meter``), while the host pool,
   the positive control, trips it every step;
4. ``RealCompute.decode_step_batch`` over device pools equals the host-pool
   path bit for bit, and the JAX package's ``decode_step_batch`` on the same
   contexts and weights within 1e-5 relative (float32; the two frameworks
   sum the products in other orders);
5. the plain ``decode_attention_pools`` equals the JAX package's (its plain
   path) within 1e-5 relative, with exactly 0 mass on pad slots.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core.backends import DeviceTailPool as JaxDeviceTailPool
from repro.core.backends import RealCompute as JaxCompute
from repro.core.stepplan import DecodeBatchCtx as JaxCtx
from repro.kernels.decode_attention.ops import decode_attention_pools as jax_pools
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core.backends import DeviceTailPool, RealCompute, TailPool, stack_tail_pools
from repro_torch.core.stepplan import DecodeBatchCtx
from repro_torch.kernels.decode_attention.ops import decode_attention, decode_attention_pools
from repro_torch.storage.h2d_meter import H2DMeter

PAGE, N_KV, D, N_Q = 4, 2, 16, 4


def _rand(rng, shape, dtype=np.float32):
    return rng.normal(size=shape).astype(dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pool_pair(seed, n_res, suffix_len, extra):
    """(rng, host pool, device pool) built from identical data, float32 tails."""
    rng = np.random.default_rng(seed)
    k_res = _rand(rng, (n_res, PAGE, N_KV, D), np.float16)
    v_res = _rand(rng, (n_res, PAGE, N_KV, D), np.float16)
    kv_suffix = None
    if suffix_len:
        kv_suffix = (_t(_rand(rng, (1, suffix_len, N_KV, D))),
                     _t(_rand(rng, (1, suffix_len, N_KV, D))))
    kw = dict(dtype=torch.float32, device="cpu")
    return (rng, TailPool(k_res, v_res, kv_suffix, PAGE, extra, **kw),
            DeviceTailPool(k_res, v_res, kv_suffix, PAGE, extra, **kw))


def _token(rng):
    return _t(_rand(rng, (1, 1, N_KV, D))), _t(_rand(rng, (1, 1, N_KV, D)))


@pytest.mark.parametrize("n_res,suffix_len,n_decode", [
    (2, 6, 7),   # the tail crosses a page boundary mid-decode
    (3, 8, 5),   # the suffix fills two pages exactly, decode opens a third
    (2, 0, 6),   # no suffix KV: the tail is decoded tokens only
    (0, 5, 4),   # no resident pages
])
def test_device_pool_matches_host_pool_over_decode(n_res, suffix_len, n_decode):
    rng, host, dev = _pool_pair(0, n_res, suffix_len, n_decode)
    assert dev.is_device and not host.is_device
    for step in range(n_decode):
        kt, vt = _token(rng)
        host.append(kt, vt)
        dev.append(kt, vt)
        assert (dev.t, dev.n_active) == (host.t, host.n_active)
        assert torch.equal(dev.k, host.k) and torch.equal(dev.v, host.v), step
        q = _t(_rand(rng, (1, N_Q, D)))
        out_h, mass_h = decode_attention(q, *host.attend_args())
        out_d, mass_d = decode_attention(q, *dev.attend_args())
        assert torch.equal(out_h, out_d) and torch.equal(mass_h, mass_d), step


def _ragged_pairs():
    pairs = [_pool_pair(10, 3, 6, 8), _pool_pair(11, 1, 0, 3), _pool_pair(12, 0, 9, 2)]
    for n_written, (rng, host, dev) in zip((2, 1, 0), pairs):
        for _ in range(n_written):
            kt, vt = _token(rng)
            host.append(kt, vt)
            dev.append(kt, vt)
    return [p[1] for p in pairs], [p[2] for p in pairs]


def test_ragged_batch_bit_identical():
    """b = 3 ragged pools: stacked host pools, stacked device pools and the
    device pools as they are (the pools form) give the same results."""
    hosts, devs = _ragged_pairs()
    kh, vh, th, lh = stack_tail_pools(hosts)
    kd, vd, td, ld = stack_tail_pools(devs)
    for a, b in ((kh, kd), (vh, vd), (th, td), (lh, ld)):
        assert torch.equal(a, b)
    assert th[1].tolist()[:2] == [0, 1] and th[1, 2:].tolist() == [-1] * (th.shape[1] - 2)
    q = _t(_rand(np.random.default_rng(1), (3, N_Q, D)))
    out_h, mass_h = decode_attention(q, kh, vh, th, lh)
    out_p, mass_p = decode_attention_pools(q, [p.k for p in devs], [p.v for p in devs], td, ld)
    assert torch.equal(out_h, out_p) and torch.equal(mass_h, mass_p)
    assert mass_p[1, :, 2:].abs().max().item() == 0.0  # pad slots


def test_table_width():
    _, host, _ = _pool_pair(13, 2, 5, 7)
    assert host.table().tolist() == [0, 1, 2, 3, -1]
    assert host.table(8).tolist() == [0, 1, 2, 3, -1, -1, -1, -1]
    with pytest.raises(ValueError):
        host.table(3)


def test_swap_out_in_bit_identical():
    rng, _, dev = _pool_pair(2, 2, 6, 5)
    for _ in range(3):
        dev.append(*_token(rng))
    q = _t(_rand(rng, (1, N_Q, D)))
    out0, mass0 = decode_attention(q, *dev.attend_args())
    # the old buffer stays referenced, so the allocator cannot hand its
    # address to swap_in's copy (on the CPU it would, now and then)
    k_old = dev.k
    k0, v0, ptr = dev.k.clone(), dev.v.clone(), k_old.data_ptr()
    nbytes = dev.swap_out()
    assert not dev.is_resident and dev.k.device.type == "cpu"
    assert nbytes == 2 * k0.numel() * k0.element_size()  # K and V both travel
    assert dev.swap_in() == nbytes and dev.is_resident
    assert dev.k.data_ptr() != ptr  # the buffers came back as new tensors
    assert torch.equal(dev.k, k0) and torch.equal(dev.v, v0)
    out1, mass1 = decode_attention(q, *dev.attend_args())
    assert torch.equal(out0, out1) and torch.equal(mass0, mass1)
    dev.append(*_token(rng))  # the pool keeps working after the round trip
    decode_attention(q, *dev.attend_args())


def test_double_swap_raises():
    _, _, dev = _pool_pair(3, 1, 4, 2)
    dev.swap_out()
    with pytest.raises(RuntimeError):
        dev.swap_out()
    dev.swap_in()
    with pytest.raises(RuntimeError):
        dev.swap_in()


def test_host_pool_swap_is_free():
    _, host, _ = _pool_pair(4, 2, 5, 3)
    assert host.is_resident and host.swap_out() == 0 and host.swap_in() == 0


N_DECODE = 6


def _drive(pool, rng):
    """One decode tail: append and attend per step."""
    for _ in range(N_DECODE):
        pool.append(*_token(rng))
        decode_attention(_t(_rand(rng, (1, N_Q, D))), *pool.attend_args())


def test_device_pool_moves_no_pool_bytes_after_warmup():
    """After construction only control bytes move: page tables and lengths,
    each far below one page, together below one pool buffer."""
    n_res, suffix_len, extra = 8, 6, N_DECODE + 28
    rng, _, dev = _pool_pair(5, n_res, suffix_len, extra)
    pool_bytes = dev.k.numel() * dev.k.element_size()
    with H2DMeter("cpu") as meter:
        _drive(dev, rng)
    page_bytes = PAGE * N_KV * D * 4
    assert meter.transfers, "the meter saw no transfer at all: it is blind"
    assert meter.largest <= page_bytes, meter.transfers
    assert meter.total < pool_bytes, meter.transfers


def test_host_pool_trips_the_meter():
    """Positive control: the host pool uploads its whole buffer every step."""
    rng, host, _ = _pool_pair(7, 2, 6, N_DECODE)
    with H2DMeter("cpu") as meter:
        _drive(host, rng)
    pool_bytes = host.k.numel() * host.k.element_size() * 1  # (1, n_pages, ...) view
    assert meter.largest >= pool_bytes
    assert meter.total >= 2 * N_DECODE * pool_bytes  # K and V


def test_meter_ignores_device_sources_and_dtype_casts():
    x = torch.zeros(8)
    doors = (torch.Tensor.to, torch.Tensor.cuda, torch.Tensor.copy_, torch.as_tensor,
             torch.tensor)
    with H2DMeter("cuda") as meter:  # a CPU tensor's cast is no transfer toward the card
        x.to(torch.float64)
        x.to("cpu")
    assert meter.transfers == []
    with H2DMeter("cpu") as meter:
        x.to(torch.float64)
        torch.as_tensor(np.zeros(3, np.int32), device="cpu")
        torch.tensor([1, 2], device="cpu")
        torch.zeros(8).copy_(x)
        torch.as_tensor(np.zeros(3))  # no device: stays where it is
    assert [d for d, _ in meter.transfers] == ["as_tensor", "tensor", "copy_"]
    assert (torch.Tensor.to, torch.Tensor.cuda, torch.Tensor.copy_, torch.as_tensor,
            torch.tensor) == doors  # restored on exit


# -- the batched decode step --------------------------------------------------
@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(jax_reduced_config("qwen2.5-7b", n_layers=2), dtype="float32")
    pcfg = dataclasses.replace(reduced_config("qwen2.5-7b", n_layers=2), dtype="float32")
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, pcfg, params, tparams


def _ctx_data(cfg, b=3, page=16, n_res=(3, 1, 2), extra=6, suffix_len=10):
    """Per request: token, position and per layer (k_res, v_res, k_suf, v_suf)."""
    rng = np.random.default_rng(9)
    out = []
    for i in range(b):
        layers = []
        for _ in range(cfg.n_layers):
            shape_res = (n_res[i], page, cfg.n_kv_heads, cfg.d_head)
            shape_suf = (1, suffix_len + i, cfg.n_kv_heads, cfg.d_head)
            layers.append((_rand(rng, shape_res, np.float16), _rand(rng, shape_res, np.float16),
                           _rand(rng, shape_suf), _rand(rng, shape_suf)))
        out.append((7 * i + 1, 100 + suffix_len + i, layers))
    return out, page, extra


def _port_ctxs(be, pool_cls, data, page, extra):
    return [DecodeBatchCtx(backend=be, token=tok, pos=pos, pools={
        l: pool_cls(kr, vr, (_t(ks), _t(vs)), page, extra, device="cpu")
        for l, (kr, vr, ks, vs) in enumerate(layers)}) for tok, pos, layers in data]


def test_decode_step_batch_device_pools_match_host_pools(models):
    _, pcfg, _, tparams = models
    be = RealCompute(pcfg, tparams, device="cpu")
    data, page, extra = _ctx_data(pcfg)
    ctx_d = _port_ctxs(be, DeviceTailPool, data, page, extra)
    ctx_h = _port_ctxs(be, TailPool, data, page, extra)
    for step in range(2):  # the second step reads the first one's token KV
        outs_d = be.decode_step_batch(ctx_d)
        outs_h = be.decode_step_batch(ctx_h)
        for i, ((ld, md), (lh, mh)) in enumerate(zip(outs_d, outs_h)):
            np.testing.assert_array_equal(ld, lh, err_msg=f"step {step} req {i}")
            assert ld.shape == (1, 1, pcfg.vocab_size)
            for l in mh:
                np.testing.assert_array_equal(md[l], mh[l])
                assert md[l].shape == (ctx_d[i].pools[l].n_res,)
    for cd, ch in zip(ctx_d, ctx_h):
        for l in cd.pools:
            assert torch.equal(cd.pools[l].k, ch.pools[l].k)
            assert cd.pools[l].t == ch.pools[l].t


def test_decode_step_batch_moves_only_control_bytes(models):
    """Device pools: one control block a step (every layer's tables, lengths
    and pool pointers), the tokens and positions; no pool bytes. Host
    pools: every layer's stacked buffers, the positive control."""
    _, pcfg, _, tparams = models
    be = RealCompute(pcfg, tparams, device="cpu")
    data, page, extra = _ctx_data(pcfg)
    for pool_cls in (DeviceTailPool, TailPool):
        ctxs = _port_ctxs(be, pool_cls, data, page, extra)
        be.decode_step_batch(ctxs)  # warm-up
        pool_bytes = min(p.k.numel() * p.k.element_size() for c in ctxs for p in c.pools.values())
        with H2DMeter("cpu") as meter:
            be.decode_step_batch(ctxs)
        if pool_cls is DeviceTailPool:
            assert meter.transfers and meter.largest < pool_bytes, meter.transfers
        else:
            assert meter.largest >= 3 * pool_bytes  # a stacked batch of three


def test_decode_step_batch_matches_jax(models):
    """The same contexts through the JAX package's decode_step_batch (its
    pools on the CPU, its decode kernel in interpret mode): logits and
    per-layer masses within 1e-5 relative, two steps."""
    cfg, pcfg, params, tparams = models
    be = RealCompute(pcfg, tparams, device="cpu")
    jbe = JaxCompute(cfg, params)
    data, page, extra = _ctx_data(pcfg)
    ctxs = _port_ctxs(be, DeviceTailPool, data, page, extra)
    jctxs = [JaxCtx(backend=jbe, token=tok, pos=pos, pools={
        l: JaxDeviceTailPool(kr, vr, (ks, vs), page, extra)
        for l, (kr, vr, ks, vs) in enumerate(layers)}) for tok, pos, layers in data]
    for step in range(2):
        outs = be.decode_step_batch(ctxs)
        jouts = jbe.decode_step_batch(jctxs)
        for (lp, mp), (lj, mj) in zip(outs, jouts):
            lj = np.asarray(lj)
            np.testing.assert_allclose(lp, lj, rtol=0, atol=1e-5 * np.abs(lj).max())
            for l in mj:
                mjl = np.asarray(mj[l])
                np.testing.assert_allclose(mp[l], mjl, rtol=0, atol=1e-5 * max(mjl.max(), 1e-6))
        for c, jc in zip(ctxs, jctxs):  # feed the next step the same tokens
            c.pos += 1
            jc.pos += 1


def test_plain_pools_form_matches_jax():
    """Ragged pools of 5, 2 and 7 pages, tables padded with -1 to 7."""
    rng = np.random.default_rng(21)
    n_pages, n_active = (5, 2, 7), (4, 2, 7)
    ks = [_rand(rng, (n, PAGE, N_KV, D)) for n in n_pages]
    vs = [_rand(rng, (n, PAGE, N_KV, D)) for n in n_pages]
    q = _rand(rng, (3, N_Q, D))
    table = np.full((3, 7), -1, np.int32)
    for i, n in enumerate(n_active):
        table[i, :n] = rng.permutation(n_pages[i])[:n]
    lengths = np.array([(n - 1) * PAGE + 2 for n in n_active], np.int32)
    out, mass = decode_attention_pools(_t(q), [_t(k) for k in ks], [_t(v) for v in vs],
                                       _t(table), _t(lengths))
    jout, jmass = jax_pools(jnp.asarray(q), [jnp.asarray(k) for k in ks],
                            [jnp.asarray(v) for v in vs], jnp.asarray(table),
                            jnp.asarray(lengths), use_kernel=False)
    jout, jmass = np.asarray(jout), np.asarray(jmass)
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-5 * np.abs(jout).max())
    np.testing.assert_allclose(mass.numpy(), jmass, rtol=0, atol=1e-5)
    pad = np.broadcast_to((table < 0)[:, None, :], mass.shape)
    assert np.all(mass.numpy()[pad] == 0.0)
