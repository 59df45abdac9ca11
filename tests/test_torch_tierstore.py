"""The port's three-tier prefix store against the JAX package's, on the CPU.

Both stores run the same seeded sequence of inserts (device or host tier,
two tenants sharing a digest, payloads from numpy), importance updates,
lookups, SSD-tier reads and releases, in each payload mode (plan, memory, and
file in ``tmp_path``) and without content addressing. After every operation
they must hold the same state: tiers, log offsets and segments, payloads,
the ``ssd_plan`` and ``ssd_fetch`` results, hit counts, read amplification,
compaction traffic, ``dedup_saved_units``, ``payload_bytes`` and the
per-tenant usage. Everything here is integer and numpy bookkeeping, so the
comparisons are exact.
"""
import tempfile

import numpy as np
import pytest

from repro.core.cache import DEVICE as J_DEVICE
from repro.core.cache import HOST as J_HOST
from repro.storage.tierstore import TieredPrefixStore as JaxStore
from repro_torch.core.cache import DEVICE, HOST, SSD
from repro_torch.storage.tierstore import TieredPrefixStore

UB = 64  # bytes of a unit: 32 uint16 values
SHAPE = (UB // 2,)


def _stores(mode, tmp_path, monkeypatch=None, *, caps=(3, 4, 10), content_addressed=True):
    if mode == "file":
        # the file-mode logs are temporary files: both in tmp_path
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    kw = dict(unit_bytes=UB, segment_units=4, payload_mode=mode,
              unit_shape=SHAPE if mode != "plan" else None, dtype=np.uint16,
              content_addressed=content_addressed)
    return [cls(*caps, **kw) for cls in (JaxStore, TieredPrefixStore)]


def _state(st):
    lay = st.ssd.layout
    ssd_keys = sorted(st.tiers[SSD], key=repr)
    return dict(
        tiers={t: sorted(st.tiers[t], key=repr) for t in st._tier_chain},
        offsets=[lay.offset_of(k) for k in ssd_keys],
        segments=[(s.base, s.capacity, list(s.slots), s.sealed) for s in lay.segments],
        live=lay.live_units(), total=lay.total_bytes,
        hits=dict(st.hits), misses=st.misses,
        usage={t: dict(u) for t, u in st.tenant_usage().items()},
        dedup=st.dedup_saved_units(), payload=st.payload_bytes(),
        digests={d: sorted(t) for d, t in st.digest_tenants.items()},
        amp=st.read_amplification(),
        reads=(st.ssd.stats.bytes_read, st.ssd.stats.requests, st.ssd.stats.units_read),
        compaction=(st.ssd.compaction.bytes_read, st.ssd.compaction.units_read),
        scores=sorted((repr(k), v) for k, v in st.I.items()),
    )


def _key(rng, content_addressed):
    tenant = int(rng.integers(1, 3))
    layer, unit = int(rng.integers(0, 2)), int(rng.integers(0, 8))
    if content_addressed:
        # two digests: "shared" is one prompt both tenants serve
        digest = "shared" if rng.random() < 0.7 else f"own{tenant}"
        return (digest, layer, unit), tenant
    return (tenant, layer, unit), tenant


def _run(stores, seed, n_ops, content_addressed, mode):
    rng = np.random.default_rng(seed)
    for step in range(n_ops):
        op = rng.choice(["insert", "insert", "score", "lookup", "read", "release"],
                        p=[0.3, 0.2, 0.2, 0.15, 0.1, 0.05])
        key, tenant = _key(rng, content_addressed)
        if op == "insert":
            tier = (J_DEVICE, DEVICE) if rng.random() < 0.8 else (J_HOST, HOST)
            payload = rng.integers(0, 2 ** 16, SHAPE, dtype=np.uint16)
            for st, t in zip(stores, tier):
                st.insert(key, t, tenant=tenant, payload=payload)
        elif op == "score":
            score = float(rng.random() * 4)
            for st in stores:
                st.update_importance(key, score)
        elif op == "lookup":
            got = [st.lookup(key, tenant=tenant) for st in stores]
            assert got[0] == got[1], (step, got)
        elif op == "read":
            keys = sorted(stores[1].tiers[SSD], key=repr)
            if keys:
                pick = [keys[i] for i in sorted(rng.choice(len(keys), min(3, len(keys)),
                                                           replace=False))]
                charge = bool(rng.random() < 0.5)
                plans = [st.ssd_plan(pick, charge=charge) for st in stores]
                assert plans[0] == plans[1], (step, plans)
                got = [st.ssd_fetch(pick) for st in stores]
                assert sorted(got[0], key=repr) == sorted(got[1], key=repr)
                for k in got[1]:
                    np.testing.assert_array_equal(got[1][k], got[0][k])
        else:
            digest = key[0] if content_addressed else None
            assert stores[0].release(tenant, digest) == stores[1].release(tenant, digest)
        js, ps = _state(stores[0]), _state(stores[1])
        assert ps == js, (step, op)
        if mode != "plan":
            for k in stores[1]._payload:
                np.testing.assert_array_equal(stores[1].payload_of(k), stores[0].payload_of(k))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["plan", "memory", "file"])
def test_seeded_sequences_match_jax(tmp_path, monkeypatch, mode, seed):
    stores = _stores(mode, tmp_path, monkeypatch)
    try:
        _run(stores, seed, 400, True, mode)
        # the sequence reached every tier, the log's reads and its compaction
        st = stores[1]
        assert st.hits[SSD] > 0 and st.ssd.stats.bytes_read > 0
        assert st.ssd.compaction.units_read > 0
        if mode == "file":
            assert st.ssd.path.startswith(str(tmp_path))
    finally:
        for st in stores:
            st.close()


@pytest.mark.parametrize("mode", ["plan", "memory"])
def test_tenant_keyed_store_matches_jax(tmp_path, mode):
    """content_addressed=False: tenant-keyed keys, no dedup, no refcounts."""
    stores = _stores(mode, tmp_path, content_addressed=False)
    _run(stores, 5, 300, False, mode)
    assert stores[1].dedup_saved_units() == 0 and not stores[1].digest_tenants


def test_dedup_holds_one_payload_copy(tmp_path):
    """Two tenants of one prompt hold one canonical copy of each unit."""
    jst, pst = _stores("memory", tmp_path, caps=(8, 4, 8))
    blob = np.arange(UB // 2, dtype=np.uint16)
    for tenant in (1, 2):
        for u in range(4):
            for st in (jst, pst):
                st.insert(("shared", 0, u), DEVICE, tenant=tenant, payload=blob + u)
    assert pst.payload_bytes() == 4 * UB == jst.payload_bytes()
    assert pst.dedup_saved_units() == 4 == jst.dedup_saved_units()
    np.testing.assert_array_equal(pst.payload_of(("shared", 0, 2)), blob + 2)
    assert not pst.release(1, "shared") and pst.tier_occupancy()[DEVICE] == 4
    assert pst.release(2, "shared") and sum(pst.tier_occupancy().values()) == 0
    assert pst.payload_bytes() == 0


def test_skip_level_demotion_and_promotion_tombstone():
    """A device victim colder than all of host lands in the SSD log; its
    promotion back tombstones the log slot."""
    jst, pst = (cls(1, 1, 8, unit_bytes=UB, segment_units=4) for cls in (JaxStore,
                                                                          TieredPrefixStore))
    for st in (jst, pst):
        st.update_importance(("d", 0, 0), 50.0)
        st.insert(("d", 0, 0), HOST, tenant=1)
        st.update_importance(("d", 0, 1), 5.0)
        st.insert(("d", 0, 1), DEVICE, tenant=1)
        st.update_importance(("d", 0, 2), 9.0)
        st.insert(("d", 0, 2), DEVICE, tenant=1)
    assert pst.contains(("d", 0, 1)) == SSD == jst.contains(("d", 0, 1))
    for st in (jst, pst):
        st.update_importance(("d", 0, 1), 100.0)
        st.insert(("d", 0, 1), DEVICE, tenant=1)
    assert _state(pst) == _state(jst)
    with pytest.raises(KeyError):
        pst.ssd.layout.offset_of(("d", 0, 1))



@pytest.mark.parametrize("pinned_units, moved_before_read", [((2,), True), ((3, 4), False)])
@pytest.mark.parametrize("mode", ["memory", "file"])
def test_pinned_ssd_reads_outlive_drops(tmp_path, monkeypatch, mode, pinned_units,
                                        moved_before_read):
    """Units 2-5 fill one 4-slot segment of the SSD log and drop out of the
    tiers in the order 5, 4, 3, 2 while a read of the pinned units is queued.
    Unit 2 alone pinned: compaction moves it before its read; units 3 and 4
    pinned: their drops wait for the read, and compaction follows it. The
    read returns every pinned unit's bytes, and their slots go after it."""
    _, st = _stores(mode, tmp_path, monkeypatch, caps=(1, 1, 4))
    blob = np.arange(SHAPE[0], dtype=np.uint16)
    for u in range(6):
        st.update_importance(("d", 0, u), 10.0 - u)
        st.insert(("d", 0, u), DEVICE, tenant=1, payload=blob + u)
    pinned = [("d", 0, u) for u in pinned_units]
    assert all(st.contains(k) == SSD for k in pinned)
    st.ssd_pin(pinned)
    u = 6
    while any(k in st.tiers[SSD] for k in pinned):
        st.update_importance(("d", 0, u), 100.0 + u)
        st.insert(("d", 0, u), DEVICE, tenant=1, payload=blob + u)
        u += 1
    assert (st.ssd.compaction.units_read > 0) == moved_before_read
    assert st.ssd.deferred_discards == st.ssd.pending_discards == len(pinned)
    got = st.ssd_fetch(pinned)
    for k in pinned:
        np.testing.assert_array_equal(got[k], blob + k[2])
        with pytest.raises(KeyError):
            st.ssd.layout.offset_of(k)
    assert st.ssd.pending_discards == 0 and not st.ssd._pins
    assert st.ssd.compaction.units_read > 0
    # a pinned key demoted again before its read stays resident after it
    again = sorted(st.tiers[SSD], key=repr)[0]
    st.ssd_pin([again])
    st.ssd.discard(again)
    st.ssd.put(again, st.payload_of(again))
    np.testing.assert_array_equal(st.ssd_fetch([again])[again], st.payload_of(again))
    assert st.ssd.layout.offset_of(again) >= 0 and st.ssd.pending_discards == 0
