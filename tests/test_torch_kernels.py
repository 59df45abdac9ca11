"""The port's three kernel modules against the JAX package, on the CPU.

For a CPU tensor each wrapper runs its plain version; those are held against
(a) the jnp function the JAX engine really calls and (b) the Pallas kernel
in interpret mode, as tests/test_kernels.py runs it. Inputs are made with
numpy from a seed. The kernels themselves run only on the card
(tests/test_torch_gpu.py and chip_smoke.py).

Tolerances: float32 against float32 arithmetic summed in another order
(1e-5 relative); bfloat16 inputs are exact in float32, so the same holds.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sparse_attention as JSA
from repro.kernels.chunk_attention.ops import reprefill_attention_paged
from repro.kernels.chunk_score.kernel import chunk_score as pallas_chunk_score
from repro.kernels.decode_attention.kernel import decode_attention as pallas_decode
from repro_torch import bridge
from repro_torch.kernels.chunk_attention import ops as ca_ops
from repro_torch.kernels.chunk_attention.ref import (chunk_attention_ref,
                                                     chunk_attention_split_ref, tf32_split)
from repro_torch.kernels.chunk_score import ops as cs_ops
from repro_torch.kernels.chunk_score.ref import chunk_score_ref
from repro_torch.kernels.decode_attention import ops as da_ops

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-6)


def _rand(seed, shape, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(dtype)


def _t(a):
    return bridge.tensor_from_numpy(a, "cpu")


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _engine_chunk_scores(q, k, c):
    """The JAX engine's identify arithmetic (src/repro/core/engine.py:834-843)."""
    tok = np.asarray(JSA.probe_token_scores(q, k))
    m = -(-len(tok) // c)
    return np.add.reduceat(np.pad(tok, (0, m * c - len(tok))), np.arange(0, m * c, c))


class TestChunkScore:
    @pytest.mark.parametrize("s,nq,nkv,n,d,c", [
        (8, 4, 1, 100, 16, 16),   # ragged: partial last chunk
        (5, 4, 2, 64, 32, 16),
        (16, 8, 2, 131, 16, 8),
    ])
    @pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
    def test_matches_engine_identify(self, s, nq, nkv, n, d, c, qdtype):
        q = _rand(0, (s, nq, d))
        k = _rand(1, (n, nkv, d), np.float16)
        jq = jnp.asarray(q) if qdtype == "float32" else _bf16(q)
        ref = _engine_chunk_scores(jq, jnp.asarray(k), c)
        got = cs_ops.chunk_score(_t(np.asarray(jq)), _t(k), c)
        assert got.dtype == torch.float32 and got.shape == (-(-n // c),)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)

    def test_matches_pallas_kernel(self):
        s, nq, nkv, n, d, c = 8, 4, 2, 128, 32, 16
        q = _rand(2, (s, nq, d))
        k = _rand(3, (n, nkv, d), np.float16)
        pallas = pallas_chunk_score(jnp.asarray(q.transpose(1, 0, 2)),
                                    jnp.asarray(k.transpose(1, 0, 2)), c,
                                    block_k=64, interpret=True)
        got = chunk_score_ref(_t(q), _t(k), c)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def _chunk_inputs(seed, s, nq, nkv, nb, c, d, qdtype):
    q = _rand(seed, (s, nq, d))
    ks = _rand(seed + 1, (nb, c, nkv, d), np.float16)
    vs = _rand(seed + 2, (nb, c, nkv, d), np.float16)
    kf = _rand(seed + 3, (s, nkv, d))
    vf = _rand(seed + 4, (s, nkv, d))
    if qdtype == "bfloat16":
        q, kf, vf = (np.asarray(_bf16(x)) for x in (q, kf, vf))
    return q, ks, vs, kf, vf


class TestChunkAttention:
    @pytest.mark.parametrize("n_valid", [1, 5, 8])
    @pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
    def test_matches_engine_part_b(self, n_valid, qdtype):
        """Output and A_j by the engine's definition, including the float32
        promotion of float16 chunks beside bfloat16 suffix KV."""
        s, nq, nkv, nb, c, d = 12, 4, 2, 8, 16, 16
        q, ks, vs, kf, vf = _chunk_inputs(0, s, nq, nkv, nb, c, d, qdtype)
        valid = np.arange(nb) < n_valid
        jo, jm = JSA.reprefill_attention(jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
                                         jnp.asarray(valid), jnp.asarray(kf),
                                         jnp.asarray(vf), chunk_tokens=c)
        po, pm = ca_ops.chunk_attention(_t(q), _t(ks), _t(vs), n_valid, _t(kf), _t(vf))
        assert str(po.dtype).removeprefix("torch.") == jo.dtype.name == "float32"
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(pm.numpy(), np.asarray(jm), **TOL)
        assert np.all(pm.numpy()[n_valid:] == 0.0)

    @pytest.mark.parametrize("n_valid", [0, 1, 5, 8])
    @pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
    def test_split_tf32_ref_matches_engine_part_b(self, n_valid, qdtype):
        """chunk_attention_split_ref, the CUDA kernel's split-TF32 products in
        plain torch, against the JAX engine's part B and the plain version."""
        s, nq, nkv, nb, c, d = 12, 4, 2, 8, 16, 32
        q, ks, vs, kf, vf = _chunk_inputs(3, s, nq, nkv, nb, c, d, qdtype)
        valid = np.arange(nb) < n_valid
        jo, jm = JSA.reprefill_attention(jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
                                         jnp.asarray(valid), jnp.asarray(kf),
                                         jnp.asarray(vf), chunk_tokens=c)
        args = (_t(q), _t(ks), _t(vs), n_valid, _t(kf), _t(vf))
        so, sm = chunk_attention_split_ref(*args)
        po, pm = chunk_attention_ref(*args)
        assert so.dtype == sm.dtype == torch.float32
        np.testing.assert_allclose(so.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(sm.numpy(), np.asarray(jm), **TOL)
        np.testing.assert_allclose(so.numpy(), po.numpy(), **TOL)
        np.testing.assert_allclose(sm.numpy(), pm.numpy(), **TOL)

    def test_output_matches_pallas_kernel(self):
        """Output only: the Pallas path normalises A_j per head over the
        chunks, the engine over [chunks ; suffix]."""
        s, nq, nkv, m, c, d, n_valid = 8, 4, 2, 12, 16, 32, 5
        q, pool_k, pool_v, kf, vf = _chunk_inputs(5, s, nq, nkv, m, c, d, "float32")
        idx = np.array([0, 3, 4, 7, 11, 0, 0, 0], np.int32)
        out, _ = reprefill_attention_paged(
            jnp.asarray(q.transpose(1, 0, 2)), jnp.asarray(pool_k), jnp.asarray(pool_v),
            jnp.asarray(idx), jnp.int32(n_valid), jnp.asarray(kf), jnp.asarray(vf))
        got, _ = chunk_attention_ref(_t(q), _t(pool_k[idx]), _t(pool_v[idx]), n_valid,
                                     _t(kf), _t(vf))
        np.testing.assert_allclose(got.numpy(), np.asarray(out).transpose(1, 0, 2), **TOL)


def _decode_inputs(b, nq, nkv, d, page, reqs, n_pages, dtype=np.float32):
    n_active = [n_res + -(-t // page) for n_res, t in reqs]
    width = max(n_active)
    q = _rand(0, (b, nq, d), dtype)
    kp = _rand(1, (b, n_pages, page, nkv, d), dtype)
    vp = _rand(2, (b, n_pages, page, nkv, d), dtype)
    tbl = np.full((b, width), -1, np.int32)
    lens = np.zeros(b, np.int32)
    for i, (n_res, t) in enumerate(reqs):
        tbl[i, : n_active[i]] = np.arange(n_active[i])
        lens[i] = n_res * page + t
    return q, kp, vp, tbl, lens, n_active


class TestDecodeAttention:
    @pytest.mark.parametrize("page,reqs", [
        (8, [(2, 5)]),                   # partial last page
        (8, [(3, 8), (1, 2), (0, 9)]),   # ragged batch with pad slots
        (16, [(2, 16), (0, 3)]),
    ])
    def test_matches_pallas_kernel(self, page, reqs):
        b, nq, nkv, d = len(reqs), 4, 2, 32
        q, kp, vp, tbl, lens, n_active = _decode_inputs(
            b, nq, nkv, d, page, reqs, max(n + -(-t // page) for n, t in reqs) + 2)
        jo, jm = pallas_decode(*(jnp.asarray(x) for x in (q, kp, vp, tbl, lens)),
                               interpret=True)
        po, pm = da_ops.decode_attention(*(_t(x) for x in (q, kp, vp, tbl, lens)))
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=3e-4, atol=3e-6)
        for i in range(b):
            assert pm.numpy()[i, :, n_active[i]:].max(initial=0.0) == 0.0

    def test_bfloat16_output_dtype(self):
        q, kp, vp, tbl, lens, _ = _decode_inputs(1, 4, 2, 16, 8, [(2, 3)], 4)
        args = [np.asarray(_bf16(x)) for x in (q, kp, vp)] + [tbl, lens]
        jo, jm = pallas_decode(*(jnp.asarray(x) for x in args), interpret=True)
        po, pm = da_ops.decode_attention(*(_t(x) for x in args))
        assert po.dtype == torch.bfloat16 and jo.dtype == jnp.bfloat16
        # both round a float32 result once to bfloat16: at most one ulp apart
        np.testing.assert_allclose(po.float().numpy(), np.asarray(jo, np.float32),
                                   rtol=8e-3, atol=8e-3)
        np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=3e-4, atol=3e-6)

    def test_pad_slots_leave_valid_pages_bit_identical(self):
        """Widening a table with -1 slots must not perturb the real pages."""
        q, kp, vp, tbl, lens, _ = _decode_inputs(1, 4, 2, 32, 8, [(2, 6)], 8)
        tight = _t(tbl)
        wide = torch.cat([tight, torch.full((1, 3), -1, dtype=torch.int32)], dim=1)
        args = [_t(x) for x in (q, kp, vp)]
        out_t, mass_t = da_ops.decode_attention(*args, tight, _t(lens))
        out_w, mass_w = da_ops.decode_attention(*args, wide, _t(lens))
        assert torch.equal(out_t, out_w)
        assert torch.equal(mass_t, mass_w[:, :, : tight.shape[1]])
        assert mass_w[:, :, tight.shape[1]:].abs().max() == 0.0


def test_tf32_split_is_exact_to_2_pow_minus_22():
    """hi and lo are TF32 (low 13 mantissa bits 0), x - hi - lo is below
    2^-22 |x|, and float16 / bfloat16 values split with lo = 0."""
    x = torch.from_numpy(_rand(7, (4096,)) * np.float32(1e3))
    hi, lo = tf32_split(x)
    for t in (hi, lo):
        assert (t.view(torch.int32) & 0x1FFF).abs().max().item() == 0
    assert ((x - hi - lo).abs() <= 2.0 ** -22 * x.abs()).all()
    for dt in (torch.float16, torch.bfloat16):
        e = x.to(dt).float()
        hi, lo = tf32_split(e)
        assert torch.equal(hi, e) and lo.abs().max().item() == 0.0


def test_importance_matches_jax():
    """core/importance.py: token mass in torch, top-k on numpy."""
    from repro.core import importance as JI
    from repro_torch.core import importance as PI

    q, k = _rand(0, (6, 4, 16)), _rand(1, (50, 2, 16), np.float16)
    ja = JI.token_attention_scores(jnp.asarray(q), jnp.asarray(k))
    pa = PI.token_attention_scores(_t(q), _t(k))
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), **TOL)
    scores = _rand(2, (37,))
    for budget in (0.1, 0.25, 1.0):
        np.testing.assert_array_equal(PI.select_topk_chunks(scores, budget),
                                      JI.select_topk_chunks(scores, budget))
        np.testing.assert_array_equal(PI.select_topk_tokens(scores, budget),
                                      JI.select_topk_tokens(scores, budget))


def test_cpu_tensors_never_launch():
    before = (cs_ops.launches, ca_ops.launches, da_ops.launches)
    q, ks, vs, kf, vf = _chunk_inputs(0, 4, 4, 2, 8, 16, 16, "float32")
    cs_ops.chunk_score(_t(q), _t(ks.reshape(-1, 2, 16)), 16)
    ca_ops.chunk_attention(_t(q), _t(ks), _t(vs), 3, _t(kf), _t(vf))
    assert (cs_ops.launches, ca_ops.launches, da_ops.launches) == before


def test_mixed_devices_raise():
    q = torch.zeros(4, 4, 16)
    k = torch.zeros(8, 2, 16, dtype=torch.float16, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        cs_ops.chunk_score(q, k, 16)
