"""The port's KV cache (quantizer, tier movers, pool, policy) against the
JAX reference.

* ``quantize_token``: int8 codes equal, scales within 1 ulp (both divide
  absmax by 127 in f32 and round half to even);
* the in-place movers (prefill scatter, demote, promote) against the
  reference's movers on the same pools: int8 planes and bf16 bit patterns
  equal, scales within 1 ulp.  The reference movers run op by op
  (``jax.disable_jit``): under jit, XLA's fused bf16->f32 convert and
  divide can land a code one step off at an exact .5 boundary (1 code in
  16384 on this data), where the op-by-op division -- and PyTorch's --
  rounds the IEEE quotient;
* ``TierConfig.split_pages`` and a scripted sequence of allocations,
  touches, room-making, promotions and releases: the same LRU victims,
  placements, dirty pages and counters on both sides;
* the cold tier: ``delta_seq``/``undelta_seq`` (wrap included), the scheme
  and byte count ``_pack_cold`` picks and ``planes_crc`` equal the
  reference's; demote -> promote round-trips bit-exactly (synchronous,
  asynchronous + ``commit_promotions``, ``promote_many``); a corrupted
  record raises ``ColdPageCorrupt``; and a scripted cold sequence (spill
  to cold in ``make_warm_room``, ``park_pages`` down to cold, prefetch
  scheduling, draining, swap-in scoring, release) gives the reference
  store's placements and counters, with every issued prefetch accounted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import BlockPool as JPool  # noqa: E402
from repro.cache import CachePolicy as JPolicy  # noqa: E402
from repro.cache import TierConfig as JTier  # noqa: E402
from repro.cache import TieredKVStore as JStore  # noqa: E402
from repro.cache import tiers as jtiers  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.kv_cache import quantize_token as j_quantize  # noqa: E402
from repro_torch.cache import BlockPool, CachePolicy, TierConfig  # noqa: E402
from repro_torch.cache import TieredKVStore, tiers  # noqa: E402
from repro_torch.cache.tiers import (TIER_COLD, TIER_WARM,  # noqa: E402
                                     ColdPageCorrupt)
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.convert import leaf_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.kv_cache import quantize_token  # noqa: E402

PS = 16


def _bits(a):
    """Comparable bit patterns of a numpy / torch array (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_planes(jp, tp):
    for name in ("kh", "vh", "k8", "v8"):
        np.testing.assert_array_equal(_bits(tp[name]), _bits(jp[name]),
                                      err_msg=name)
    for name in ("ks", "vs"):
        np.testing.assert_array_max_ulp(tp[name].numpy(),
                                        np.asarray(jp[name]), maxulp=1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_token_matches(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16, 32)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                           # all-zero row: scale 1
    jx = jnp.asarray(x, dtype)
    q_ref, s_ref = j_quantize(jx)
    q, s = quantize_token(leaf_from_numpy(np.asarray(jx)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(s_ref), maxulp=1)
    assert s[0, 0, 0] == 1.0


@pytest.fixture
def pools():
    """One segment's pools [stack=2, 1+6 hot, G=2, 16, 32] / 1+5 warm."""
    rng = np.random.default_rng(3)
    shp_h, shp_w = (2, 7, 2, PS, 32), (2, 6, 2, PS, 32)
    p = {"kh": np.array(jnp.asarray(rng.standard_normal(shp_h),
                                    jnp.bfloat16)),
         "vh": np.array(jnp.asarray(rng.standard_normal(shp_h),
                                    jnp.bfloat16)),
         "k8": rng.integers(-127, 128, shp_w).astype(np.int8),
         "v8": rng.integers(-127, 128, shp_w).astype(np.int8),
         "ks": rng.uniform(0.005, 0.02, shp_w[:4]).astype(np.float32),
         "vs": rng.uniform(0.005, 0.02, shp_w[:4]).astype(np.float32)}
    return p


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: leaf_from_numpy(v) for k, v in p.items()})


def test_demote_mover_matches(pools):
    jp, tp = _both(pools)
    src = np.array([3, 1, 0, 0, 0, 0, 0, 0], np.int32)    # padded with trash
    dst = np.array([2, 5, 0, 0, 0, 0, 0, 0], np.int32)
    with jax.disable_jit():
        jp = jtiers._demote_hot_to_warm(jp, jnp.asarray(src),
                                        jnp.asarray(dst))
    tiers.demote_hot_to_warm(tp, torch.from_numpy(src).long(),
                             torch.from_numpy(dst).long())
    _same_planes(jp, tp)


def test_promote_mover_matches(pools):
    jp, tp = _both(pools)
    src = np.array([4, 2, 0, 0, 0, 0, 0, 0], np.int32)
    dst = np.array([6, 1, 0, 0, 0, 0, 0, 0], np.int32)
    with jax.disable_jit():
        jp = jtiers._promote_warm_to_hot(jp, jnp.asarray(src),
                                         jnp.asarray(dst))
    tiers.promote_warm_to_hot(tp, torch.from_numpy(src).long(),
                              torch.from_numpy(dst).long())
    _same_planes(jp, tp)


def test_scatter_prefill_matches(pools):
    jp, tp = _both(pools)
    rng = np.random.default_rng(5)
    k = np.array(jnp.asarray(rng.standard_normal((2, 2, 3 * PS, 32)),
                             jnp.bfloat16))
    v = np.array(jnp.asarray(rng.standard_normal((2, 2, 3 * PS, 32)),
                             jnp.bfloat16))
    locs = np.array([5, 2, 0], np.int32)        # third page: not kept
    jp = jtiers._scatter_prefill(jp, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(locs))
    tiers.scatter_prefill(tp, leaf_from_numpy(k), leaf_from_numpy(v),
                          torch.from_numpy(locs).long())
    for name in ("kh", "vh"):                   # slot 0 (trash) may differ
        np.testing.assert_array_equal(_bits(tp[name])[:, 1:],
                                      _bits(jp[name])[:, 1:])


@pytest.mark.parametrize("budget", [1 << 14, 300_000, 1 << 20, 5_000_000])
@pytest.mark.parametrize("hot_fraction", [0.25, 0.5, 0.9])
@pytest.mark.parametrize("enable_warm", [True, False])
def test_split_pages_matches(budget, hot_fraction, enable_warm):
    kw = dict(page_size=PS, hbm_budget_bytes=budget,
              hot_fraction=hot_fraction, enable_warm=enable_warm,
              enable_cold=False)
    assert TierConfig(**kw).split_pages(8192, 4608) == \
        JTier(**kw).split_pages(8192, 4608)


def test_geometry_matches():
    jg = JT.paged_geometry(j_reduced(J_ARCHS["qwen2-7b"]), PS)
    tg = T.paged_geometry(reduced(ARCHS["qwen2-7b"]), PS)
    assert (tg.hot_page_bytes, tg.warm_page_bytes, tg.layers_total) == \
        (jg.hot_page_bytes, jg.warm_page_bytes, jg.layers_total)
    full_j = JT.paged_geometry(J_ARCHS["qwen2-7b"], PS)
    full_t = T.paged_geometry(ARCHS["qwen2-7b"], PS)
    assert (full_t.hot_page_bytes, full_t.warm_page_bytes) == \
        (full_j.hot_page_bytes, full_j.warm_page_bytes) == (917504, 473088)


def _state(pool, store):
    return (store.tier.tolist(), store.slot.tolist(), store.n_free_hot,
            store.n_free_warm, sorted(store.drain_dirty()),
            {k: store.stats[k] for k in ("demote_warm", "promote_hot",
                                         "mover_dispatches")},
            {r: list(t) for r, t in pool.tables.items()})


def test_scripted_lru_sequence_matches(pools):
    """Allocations, LRU touches, room-making under protection, a write-page
    promotion and a release give the same victims and placements."""
    jg = JT.paged_geometry(j_reduced(J_ARCHS["qwen2-7b"]), PS)
    tg = T.paged_geometry(reduced(ARCHS["qwen2-7b"]), PS)
    hot, warm, n = 6, 5, 11
    tier_kw = dict(page_size=PS, enable_warm=True, enable_cold=False)
    sides = []
    for Pool, Store, Policy, Tier, geom, extra in (
            (JPool, JStore, JPolicy, JTier, jg, {}),
            (BlockPool, TieredKVStore, CachePolicy, TierConfig, tg,
             {"device": "cpu"})):
        pool = Pool(n, PS)
        store = Store(geom, n, hot_pages=hot, warm_pages=warm, **extra)
        sides.append((pool, store, Policy(Tier(**tier_kw))))
    jp, tp = _both(pools)
    sides[0][1].pools = (jp,)
    for name, t in tp.items():
        sides[1][1].pools[0][name].copy_(t)

    def run(op):
        states = []
        for pool, store, policy in sides:
            with jax.disable_jit():
                op(pool, store, policy)
            states.append(_state(pool, store))
        assert states[0] == states[1], op.__doc__

    def alloc(rid, npg, tick):
        def op(pool, store, policy):
            """alloc"""
            for p in pool.allocate(rid, npg):
                store.place_hot(p)
            pool.touch(rid, tick)
        return op

    run(alloc(0, 2, 1))
    run(alloc(1, 2, 2))
    run(alloc(2, 1, 3))

    def touch0(pool, store, policy):
        """touch rid 0 later than rid 1"""
        pool.touch(0, 4)
    run(touch0)

    def room(pool, store, policy):
        """make room for 3 pages, rid 2 protected: LRU evicts rid 1 first"""
        assert policy.make_hot_room(pool, store, set(pool.table(2)), n=3)
    run(room)
    run(alloc(3, 3, 5))

    def promote(pool, store, policy):
        """bring rid 1's first page back hot after making room"""
        pid = pool.table(1)[0]
        assert policy.make_hot_room(pool, store, set(pool.table(1)))
        store.promote_to_hot(pid)
    run(promote)

    def release(pool, store, policy):
        """retire rid 0"""
        for pid in pool.free_request(0):
            store.release(pid)
    run(release)

    parked = []

    def park(pool, store, policy):
        """park rid 3's hot pages warm (rid 2's stay protected)"""
        parked.append(policy.park_pages(pool, store,
                                        pool.table(2) + pool.table(3),
                                        set(pool.table(2))))
    run(park)
    assert parked[0] == parked[1] > 0

    def refuse(pool, store, policy):
        """with every hot page protected no room can be made"""
        prot = {p for t in pool.tables.values() for p in t}
        assert not policy.make_hot_room(pool, store, prot, n=hot)
    run(refuse)
    for pool, _, _ in sides:
        pool.check()
    sides[1][1].flush_movers()
    _same_planes({k: np.asarray(v) for k, v in sides[0][1].pools[0].items()},
                 sides[1][1].pools[0])


# -- cold tier ----------------------------------------------------------------

def _walk(rng, shape):
    """int8 plane that changes little from token to token (axis -2)."""
    steps = rng.integers(-3, 4, shape)
    steps[..., 0, :] = rng.integers(-100, 100, shape[:-2] + shape[-1:])
    return np.clip(np.cumsum(steps, axis=-2), -127, 127).astype(np.int8)


def _planes():
    rng = np.random.default_rng(11)
    shp = (2, 2, PS, 32)
    const = np.broadcast_to(rng.integers(-127, 128, (2, 2, 1, 32)),
                            shp).astype(np.int8)
    return {"noise": rng.integers(-128, 128, shp).astype(np.int8),
            "zeros": np.zeros(shp, np.int8),
            "walk": _walk(rng, shp),
            "const_rows": const,
            "extremes": rng.choice(np.array([-128, 127, 0], np.int8), shp),
            "full_width_walk": _walk(rng, (28, 4, PS, 128))}


def test_delta_seq_matches_reference_with_wrap():
    x = _planes()["extremes"]               # -128 -> 127 steps wrap mod 256
    d = tiers.delta_seq(x)
    np.testing.assert_array_equal(d, jtiers.delta_seq(x))
    np.testing.assert_array_equal(tiers.undelta_seq(d),
                                  jtiers.undelta_seq(d))
    np.testing.assert_array_equal(tiers.undelta_seq(d), x)
    got = tiers.undelta_seq_(torch.from_numpy(d.copy()))
    np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("use_delta", [True, False])
@pytest.mark.parametrize("kind", sorted(_planes()))
def test_pack_cold_matches_reference(kind, use_delta):
    x8 = _planes()[kind]
    name, obj, nb = tiers._pack_cold(x8, use_delta)
    j_name, _, j_nb = jtiers._pack_cold(x8, use_delta)
    assert (name, nb) == (j_name, j_nb)
    sc = np.random.default_rng(1).uniform(0.01, 0.02,
                                          x8.shape[:-1]).astype(np.float32)
    raw = [[(x8, sc), (x8[::-1].copy(), sc * 2)]]
    assert tiers.planes_crc(raw) == jtiers.planes_crc(raw)
    staged = torch.zeros(-(-x8.size // 512) * 512, dtype=torch.uint8)
    fields = [torch.from_numpy(np.array(a))
              for a in tiers._plane_arrays(name, obj)]
    tiers._unpack_cold(name, fields, staged, x8.shape)
    np.testing.assert_array_equal(
        staged[:x8.size].view(torch.int8).numpy().reshape(x8.shape), x8)


def test_pack_cold_picks_every_scheme():
    names = {tiers._pack_cold(x8)[0] for x8 in _planes().values()}
    assert {"raw", "bdi", "fpc+delta"} <= names, names


def _cold_store(pools, **kw):
    """Port store over the reduced geometry with the fixture's pools; pages
    0-3 placed hot, demoted warm, and their warm slots overwritten with
    planes that pack as raw, bdi and fpc+delta."""
    tg = T.paged_geometry(reduced(ARCHS["qwen2-7b"]), PS)
    store = TieredKVStore(tg, 16, hot_pages=6, warm_pages=5, device="cpu",
                          **kw)
    for name, t in pools.items():
        store.pools[0][name].copy_(leaf_from_numpy(t))
    planes = _planes()
    fill = [("noise", "walk"), ("zeros", "noise"), ("walk", "const_rows"),
            ("extremes", "zeros")]
    for pid, (k, v) in enumerate(fill):
        store.place_hot(pid)
        store.demote_to_warm(pid)
        ws = int(store.slot[pid])
        store.pools[0]["k8"][:, ws] = torch.from_numpy(planes[k])
        store.pools[0]["v8"][:, ws] = torch.from_numpy(planes[v])
    return store


def _warm_planes(store, pid):
    ws = int(store.slot[pid])
    return {n: store.pools[0][n][:, ws].clone()
            for n in ("k8", "ks", "v8", "vs")}


@pytest.mark.parametrize("mode", ["sync", "async", "many"])
def test_cold_round_trip_bit_exact(pools, mode):
    store = _cold_store(pools)
    before = {pid: _warm_planes(store, pid) for pid in range(4)}
    for pid in range(4):
        store.demote_to_cold(pid)
    assert store.tier_counts() == {"hot": 0, "warm": 0, "cold": 4}
    assert store.hbm_bytes_used() == 0 and store.cold_bytes > 0
    cs = store.cold_stats()
    assert cs["raw_bytes_total"] == 4 * store.geom.warm_page_bytes
    assert sum(cs["schemes"].values()) == 8
    assert {"raw", "bdi", "fpc+delta"} <= set(cs["schemes"])
    # a warm slot freed by the demotions is taken by another page first,
    # so the promotions land in other slots than they left
    store.place_hot(9)
    store.demote_to_warm(9)
    if mode == "sync":
        for pid in range(4):
            store.promote_to_warm(pid)
    elif mode == "async":
        for pid in range(4):
            store.promote_to_warm(pid, async_=True)
        assert store.commit_promotions() == 4
    else:
        assert store.promote_many([9, 0, 1, 2, 3]) == [0, 1, 2, 3]
    for pid in range(4):
        assert store.tier[pid] == TIER_WARM
        got = _warm_planes(store, pid)
        for n in got:
            assert torch.equal(got[n], before[pid][n]), (pid, n)
    st = store.stats
    assert (st["demote_cold"], st["promote_warm"]) == (4, 4)
    assert st["promote_warm_async"] == (0 if mode == "sync" else 4)
    assert store.cold_bytes == 0 and not store.cold and not store.cold_crc


@pytest.mark.parametrize("async_", [False, True])
def test_corrupted_cold_record_raises(pools, async_):
    store = _cold_store(pools)
    store.demote_to_cold(0)
    rec = store.cold[0]
    rec.blob[rec.spans[0][0][-1]] ^= 0xFF       # one byte of the k scales
    free_warm = store.n_free_warm
    if not async_:
        with pytest.raises(ColdPageCorrupt) as e:
            store.promote_to_warm(0)
        assert e.value.pid == 0
        assert store.tier[0] == TIER_COLD and 0 in store.cold
        assert store.n_free_warm == free_warm
    else:
        store.promote_to_warm(0, async_=True)
        with pytest.raises(ColdPageCorrupt):
            store.commit_promotions()


def test_host_budget_refuses_demotion(pools):
    store = _cold_store(pools, host_budget_bytes=6000)
    store.demote_to_cold(1)                 # zeros + noise: under budget
    with pytest.raises(tiers.PoolExhausted, match="host"):
        store.demote_to_cold(0)
    assert store.tier[0] == TIER_WARM


def _cold_state(pool, store, policy):
    return (_state(pool, store), dict(store.stats), dict(policy.stats),
            store.cold_bytes, sorted(store.cold))


def test_scripted_cold_sequence_matches(pools):
    """Spills to cold, parking, prefetch and release on the port and the
    reference store: the same placements, counters and packed bytes."""
    jg = JT.paged_geometry(j_reduced(J_ARCHS["qwen2-7b"]), PS)
    tg = T.paged_geometry(reduced(ARCHS["qwen2-7b"]), PS)
    hot, warm, n = 6, 5, 16
    tier_kw = dict(page_size=PS, enable_warm=True, enable_cold=True)
    sides = []
    for Pool, Store, Policy, Tier, geom, extra in (
            (JPool, JStore, JPolicy, JTier, jg, {}),
            (BlockPool, TieredKVStore, CachePolicy, TierConfig, tg,
             {"device": "cpu"})):
        pool = Pool(n, PS)
        store = Store(geom, n, hot_pages=hot, warm_pages=warm, **extra)
        sides.append((pool, store, Policy(Tier(**tier_kw))))
    jp, tp = _both(pools)
    sides[0][1].pools = (jp,)
    for name, t in tp.items():
        sides[1][1].pools[0][name].copy_(t)

    def run(op):
        states = []
        for side in sides:
            with jax.disable_jit():
                op(*side)
            states.append(_cold_state(*side))
        assert states[0] == states[1], op.__doc__

    def alloc(rid, npg, tick):
        def op(pool, store, policy):
            """alloc"""
            for p in pool.allocate(rid, npg):
                store.place_hot(p)
            pool.touch(rid, tick)
        return op

    def room(protect_rid, n_pages):
        def op(pool, store, policy):
            """make hot room (spilling warm pages cold when warm is full)"""
            assert policy.make_hot_room(pool, store,
                                        set(pool.table(protect_rid)),
                                        n=n_pages)
        return op

    run(alloc(0, 3, 1))
    run(alloc(1, 3, 2))
    run(room(1, 3))                     # rid 0 -> warm
    run(alloc(2, 3, 3))
    run(room(2, 3))                     # rid 1 -> warm, rid 0 spills cold

    def park(pool, store, policy):
        """park rid 2 down the ladder (rid 1 spills cold to make room)"""
        policy.park_pages(pool, store, pool.table(2), set())
    run(park)

    def prefetch(rid):
        def op(pool, store, policy):
            """schedule a request's cold pages, drain, land, score"""
            table = pool.table(rid)
            policy.schedule_prefetch([p for p in table
                                      if store.tier[p] == TIER_COLD])
            policy.drain_prefetch(pool, store, set())
            store.commit_promotions()
            policy.account_swap_in(table, [p for p in table
                                           if store.tier[p] == TIER_COLD])
        return op
    run(prefetch(1))
    run(prefetch(0))                    # spills rid 1's pages back cold

    def release(pool, store, policy):
        """retire rid 2 and rid 1"""
        for rid in (2, 1):
            freed = pool.free_request(rid)
            for pid in freed:
                store.release(pid)
            policy.forget_pages(freed)
    run(release)
    for pool, store, policy in sides:
        pool.check()
        c = policy.stats
        assert c["prefetch_issued"] == (
            c["prefetch_hits"] + c["prefetch_late"] + c["prefetch_wasted"]
            + c["prefetch_outstanding"]) > 0
    assert sides[1][1].stats["demote_cold"] > 0
    _same_planes({k: np.asarray(v) for k, v in sides[0][1].pools[0].items()},
                 sides[1][1].pools[0])
