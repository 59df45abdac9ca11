"""The port's numpy storage and cache modules against the JAX package's:
the same inputs give the same outputs, to the last bit."""
import numpy as np
import pytest

from repro.core import cache as JC
from repro.storage import layout as JL
from repro.storage import ssd as JS
from repro.storage import timing as JT
from repro_torch.core import cache as PC
from repro_torch.storage import layout as PL
from repro_torch.storage import ssd as PS
from repro_torch.storage import timing as PT


def _geom(L):
    return L.KVGeometry(n_kv_heads=2, d_head=16, bytes_per_el=2)


@pytest.mark.parametrize("seed", range(4))
def test_layout_coalesce_runs_equal(seed):
    rng = np.random.default_rng(seed)
    units = sorted(rng.choice(13, size=rng.integers(1, 13), replace=False).tolist())
    for mk in ("ContiguousChunkLayout", "CoarseBlockLayout"):
        ja = getattr(JL, mk)(200, 3, _geom(JL), 16)
        pa = getattr(PL, mk)(200, 3, _geom(PL), 16)
        for layer in range(3):
            jr, pr = ja.coalesce(layer, units), pa.coalesce(layer, units)
            assert [(r.offset, r.nbytes, r.units) for r in jr] == \
                   [(r.offset, r.nbytes, r.units) for r in pr]


@pytest.mark.parametrize("in_memory", [True, False])
def test_chunk_store_round_trip(in_memory):
    rng = np.random.default_rng(0)
    n, L = 100, 2  # 100 tokens: a partial last chunk
    kv = [(rng.standard_normal((n, 2, 16)).astype(np.float16),
           rng.standard_normal((n, 2, 16)).astype(np.float16)) for _ in range(L)]
    jstore = JS.ChunkStore(JL.ContiguousChunkLayout(n, L, _geom(JL), 16), in_memory=in_memory)
    pstore = PS.ChunkStore(PL.ContiguousChunkLayout(n, L, _geom(PL), 16), in_memory=in_memory)
    try:
        for l, (k, v) in enumerate(kv):
            jstore.write_layer(l, k, v)
            pstore.write_layer(l, k, v)
        for l in range(L):
            units = [0, 2, 3, 6]
            jr, pr = jstore.read_units(l, units), pstore.read_units(l, units)
            assert sorted(jr) == sorted(pr) == units
            for u in units:
                np.testing.assert_array_equal(jr[u], pr[u])
            np.testing.assert_array_equal(pr[2][:, 0], kv[l][0][32:48])
            assert pstore.run_plan(l, units) == jstore.run_plan(l, units)
        assert vars(pstore.stats) == vars(jstore.stats)
    finally:
        jstore.close()
        pstore.close()


def _trace(seed, n=300):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 3)), (int(rng.integers(0, 2)), int(rng.integers(0, 24))),
             float(rng.exponential())) for _ in range(n)]


@pytest.mark.parametrize("seed", range(3))
def test_cache_eviction_order_equal(seed):
    """One fixed op trace through both AttentionGuidedCaches: the tiers after
    every op, and so the eviction order, are identical."""
    jc, pc = JC.AttentionGuidedCache(6, 5), PC.AttentionGuidedCache(6, 5)
    for op, key, score in _trace(seed):
        for c in (jc, pc):
            if op == 0:
                c.insert(key, JC.DEVICE if c is jc else PC.DEVICE)
            elif op == 1:
                c.update_importance(key, score)
            else:
                c.lookup(key)
        assert jc.tiers == pc.tiers
    assert jc.I == pc.I and jc.F == pc.F


def test_channel_sim_timeline_equal():
    """The same submissions on both ChannelSims give the same event list."""
    js, ps = JT.ChannelSim(JT.DeviceModel()), PT.ChannelSim(PT.DeviceModel())
    rng = np.random.default_rng(0)
    for i in range(50):
        nbytes, nreq, at = int(rng.integers(1, 1 << 20)), int(rng.integers(1, 9)), float(i) * 1e-4
        for s in (js, ps):
            h = s.submit_io_at(None, nbytes=nbytes, n_requests=nreq, channel="ssd", at=at)
            s.submit_io_at(None, nbytes=nbytes, n_requests=1, channel="pcie", at=at, after=h)
            s.compute_at(None, flops=float(nbytes) * 1e3, hbm_bytes=float(nbytes), tag="c", at=at)
    assert js.events == ps.events
    assert js.busy == ps.busy
