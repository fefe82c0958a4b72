"""The legacy page-copy KV pool: the JAX ``SELCCKVPool`` and the port's.

Seeded traces of appends and reads run through the JAX pool (legacy
path, ``backend="ref"``) and the port's on the CPU, for fp32 and bf16
pools.  Exact, bit for bit: every ``pool`` and ``cache`` leaf after
every call, every hit mask and every byte a read returns.  Within 2e-5
(fp32 softmax and sums in another order): ``attend`` on live rows (a
row with ``lens == 0`` is zero in the port, as in the Pallas kernel).

Two of the reference's scatters take duplicate indices, which JAX
leaves implementation-defined; its CPU backend applies them in row
order, so the last row wins, and the port makes that explicit (ROADMAP,
"Semantics the port fixed"): rows of one read that share a cache slot,
and append rows that name one (page, offset).  One case pins each.

One difference is the reference's own fault, kept out of the port
(ROADMAP, same list): the reference's reader-bit merge writes page 0's
old word back for every empty row of a read (``idx = max(page, 0)``),
so a read that misses page 0 and has an empty or hit row after it loses
page 0's reader bit.  The harness checks that this is the only way the
two directories part after a read, then gives the JAX pool the merged
word, so the traces go on in step; ``test_reference_drops_page0_bit``
shows the fault on its own.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import coherence as jco  # noqa: E402
from repro.dsm import kvpool as jkv  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.dsm import kvpool as tkv  # noqa: E402


from _torch_threads import _one_thread  # noqa: E402,F401


ATTEND_TOL = 2e-5


def _bits(x):
    """Raw bits of an array or tensor, comparable across packages."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    if x.dtype == np.float32:
        return x.view(np.int32)
    return x


def _geom(dtype, **kw):
    g = dict(n_pages=16, page_size=4, n_kv_heads=2, head_dim=8,
             n_replicas=3, cache_slots=4, dtype=dtype)
    g.update(kw)
    return g


class Twin:
    """One JAX legacy pool and one port legacy pool, driven alike."""

    def __init__(self, **geom):
        self.j = jkv.SELCCKVPool(jkv.KVPoolConfig(**geom))
        self.t = tkv.SELCCKVPool(tkv.KVPoolConfig(**geom), device="cpu")
        self.page0_faults = 0

    def check(self, where=""):
        for side in ("pool", "cache"):
            jd, td = getattr(self.j, side), getattr(self.t, side)
            assert sorted(jd) == sorted(td), side
            for k in jd:
                assert np.array_equal(_bits(jd[k]), _bits(td[k])), \
                    f"{where}: {side}[{k!r}] differs"

    def append(self, replica, pages, offsets, k, v):
        pages = np.asarray(pages, np.int32)
        offsets = np.asarray(offsets, np.int32)
        k = np.asarray(k, np.float32)
        v = np.asarray(v, np.float32)
        assert self.j.append(pages, offsets, jnp.asarray(k),
                             jnp.asarray(v), replica=replica) == 0
        assert self.t.append(pages, offsets, k, v, replica=replica) == 0
        self.check(f"append by {replica}")

    def read(self, replica, pages):
        pages = np.asarray(pages, np.int32)
        before = np.asarray(self.j.pool["words"]).copy()
        kj, vj, hj = self.j.read(replica, pages)
        kt, vt, ht = self.t.read(replica, pages)
        assert np.array_equal(np.asarray(hj), ht), "hit masks differ"
        assert np.array_equal(_bits(kj), _bits(kt)), "k bytes differ"
        assert np.array_equal(_bits(vj), _bits(vt)), "v bytes differ"
        # the directory a read must leave: every miss ORs its bit in
        miss = (pages >= 0) & ~ht
        hi, lo = (np.int32(np.uint32(x)) for x in
                  jco.to_lanes(jco.reader_bit(replica)))
        want = before.copy()
        want[pages[miss], 0] |= hi
        want[pages[miss], 1] |= lo
        got_j = np.asarray(self.j.pool["words"])
        bad = np.flatnonzero((got_j != want).any(axis=1))
        if bad.size:
            # only the reference's page-0 fault may part them: page 0
            # missed, and a later row of the read was empty or a hit
            assert bad.tolist() == [0], bad
            last0 = np.flatnonzero(pages == 0)[-1]
            assert miss[last0] and (~miss[last0 + 1:]).any()
            self.j.pool = dict(self.j.pool, words=jnp.asarray(want))
            self.page0_faults += 1
        assert np.array_equal(self.t.pool["words"].numpy(), want)
        self.check(f"read by {replica}")
        return kt, vt, ht

    def attend(self, q, tbl, lens):
        q = np.asarray(q, np.float32)
        oj = np.asarray(self.j.attend(jnp.asarray(q), np.asarray(tbl),
                                      np.asarray(lens)))
        ot = self.t.attend(torch.from_numpy(q), tbl, lens).numpy()
        live = np.asarray(lens) > 0
        err = float(np.abs(oj[live] - ot[live]).max()) if live.any() \
            else 0.0
        assert err <= ATTEND_TOL, err
        assert not ot[~live].any()
        return ot


DTYPES = ["float32", "bfloat16"]


# ------------------------------------- the cases of tests/test_kvpool.py

@pytest.mark.parametrize("dtype", DTYPES)
def test_miss_hit_invalidate_cycle(dtype):
    tw = Twin(**_geom(dtype, n_pages=64, page_size=8, head_dim=32,
                      n_replicas=2, cache_slots=16))
    rng = np.random.default_rng(0)
    pages = tw.t.allocate(2)
    assert tw.j.allocate(2).tolist() == pages.tolist()
    for t in range(8):
        k = rng.normal(size=(1, 2, 32))
        tw.append(0, [pages[0]], [t], k, k)
    _, _, h1 = tw.read(1, [pages[0]])
    _, _, h2 = tw.read(1, [pages[0]])
    assert not h1[0] and h2[0]
    tw.append(0, [pages[0]], [7], np.ones((1, 2, 32)), np.ones((1, 2, 32)))
    k3, _, h3 = tw.read(1, [pages[0]])
    assert not h3[0]
    assert float(k3[0, 7].float().min()) == 1.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_replicas_have_independent_caches(dtype):
    tw = Twin(**_geom(dtype, n_replicas=2))
    page = int(tw.t.allocate(1)[0])
    tw.j.allocate(1)
    tw.append(0, [page], [0], np.ones((1, 2, 8)), np.ones((1, 2, 8)))
    _, _, h0 = tw.read(0, [page])
    _, _, h1 = tw.read(1, [page])
    assert not h0[0] and not h1[0]
    _, _, h0b = tw.read(0, [page])
    assert h0b[0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_reader_bits_land_in_each_replicas_own_lane(dtype):
    from repro_torch.core import coherence as co
    tw = Twin(**_geom(dtype, n_pages=8, n_replicas=4))
    page = int(tw.t.allocate(1)[0])
    for rep in range(4):
        tw.read(rep, [page])
    hi, lo = tw.t.pool["words"][page].tolist()
    assert co.readers_of(co.from_lanes(hi, lo)) == [0, 1, 2, 3]


@pytest.mark.parametrize("dtype", DTYPES)
def test_append_upgrades_and_evicts_readers(dtype):
    from repro_torch.core import coherence as co
    tw = Twin(**_geom(dtype, n_pages=8, page_size=4, head_dim=8,
                      n_replicas=4, cache_slots=4))
    page = 3
    for rep in (0, 2, 3):
        tw.read(rep, [page])
    one = np.ones((1, 2, 8))
    tw.append(0, [page], [0], one, one)

    def word():
        hi, lo = tw.t.pool["words"][page].tolist()
        return co.from_lanes(hi, lo)
    assert co.writer_of(word()) is None and co.readers_of(word()) == [0]
    assert int(tw.t.pool["append_evictions"]) == 2     # readers 2, 3
    tw.append(0, [page], [1], one, one)               # sole holder now
    assert int(tw.t.pool["append_evictions"]) == 2
    _, _, h2 = tw.read(2, [page])
    assert not h2[0] and co.readers_of(word()) == [0, 2]


def test_replica_cache_honours_pool_dtype():
    for dtype, want in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        cfg = tkv.KVPoolConfig(**_geom(dtype))
        cache = tkv.make_replica_cache(cfg, device="cpu")
        pool = tkv.make_pool(cfg, device="cpu")
        assert cache["k_local"].dtype == want == pool["k_pages"].dtype
        jcache = jkv.make_replica_cache(jkv.KVPoolConfig(**_geom(dtype)))
        for k in jcache:
            assert tuple(cache[k].shape) == jcache[k].shape, k


def test_legacy_guards():
    tw = Twin(**_geom("float32"))
    with pytest.raises(TypeError, match="rounds plane"):
        tw.t.append(np.array([1, 2]), np.array([0, 0]),
                    np.ones((2, 2, 8)), np.ones((2, 2, 8)),
                    replica=np.array([0, 1]))
    with pytest.raises(TypeError, match="rounds plane"):
        tw.j.append(np.array([1, 2]), np.array([0, 0]),
                    jnp.ones((2, 2, 8)), jnp.ones((2, 2, 8)),
                    replica=np.array([0, 1]))
    # a Mesh-backed pool: on one device the legacy leaves are the flat
    # arrays, and an append and a read give the flat pool's results;
    # anything that is not a Mesh raises
    from repro_torch.core.rounds import Mesh
    cfg = tkv.KVPoolConfig(**_geom("float32"))
    pools = [tkv.SELCCKVPool(cfg, device="cpu"),
             tkv.SELCCKVPool(cfg, mesh=Mesh(2, device="cpu"))]
    kv = np.arange(2 * 2 * 8, dtype=np.float32).reshape(2, 2, 8)
    got = []
    for pool in pools:
        page = pool.allocate(2)
        pool.append(page, [0, 1], kv, -kv, replica=1)
        got.append(pool.read(0, page))
        for k in pool.pool:
            assert tuple(pool.pool[k].shape) == tuple(
                pools[0].pool[k].shape), k
    for a, b in zip(*got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for k in pools[0].pool:
        assert torch.equal(pools[0].pool[k], pools[1].pool[k]), k
    with pytest.raises(TypeError, match="Mesh"):
        tkv.SELCCKVPool(cfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        tkv.SELCCKVPool(tkv.KVPoolConfig(**_geom("float32",
                                                 n_replicas=57)),
                        device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_attend_over_pool(dtype):
    tw = Twin(**_geom(dtype, n_pages=64, page_size=8, head_dim=32,
                      n_replicas=2, cache_slots=16))
    rng = np.random.default_rng(3)
    pages = tw.t.allocate(4)
    for t in range(16):
        kv = rng.normal(size=(2, 1, 2, 32))
        tw.append(0, [pages[t // 8]], [t % 8], kv[0], kv[1])
    tw.append(1, [pages[2], pages[2], pages[3]], [0, 1, 0],
              rng.normal(size=(3, 2, 32)), rng.normal(size=(3, 2, 32)))
    q = rng.normal(size=(3, 4, 32))
    tbl = np.array([[pages[0], pages[1]], [pages[2], pages[3]],
                    [pages[0], -1]], np.int32)
    tw.attend(q, tbl, np.array([16, 9, 0], np.int32))


# ----------------------------------------------- traces and the scatters

def _trace(tw, rng, steps, n_pages, page_size, hkv, hd, n_rep, rows=6):
    for _ in range(steps):
        rep = int(rng.integers(0, n_rep))
        if rng.random() < 0.5:
            pages = rng.integers(-1, n_pages, rows)
            offs = rng.integers(0, page_size, rows)
            tw.append(rep, pages, offs, rng.normal(size=(rows, hkv, hd)),
                      rng.normal(size=(rows, hkv, hd)))
        else:
            tw.read(rep, rng.integers(-1, n_pages, rows + 1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mixed_multi_replica_trace(dtype):
    """Four replicas over 24 pages and 5 direct-mapped slots: slot
    conflicts within and across reads, duplicate pages in a read and in
    an append, readers evicted by appends, empty rows."""
    geom = _geom(dtype, n_pages=24, n_replicas=4, cache_slots=5)
    tw = Twin(**geom)
    rng = np.random.default_rng(11)
    _trace(tw, rng, 60, 24, 4, 2, 8, 4)
    assert int(tw.t.pool["append_evictions"]) > 0
    hits = [tw.read(r, np.arange(24))[2].sum() for r in range(4)]
    assert sum(hits) > 0
    q = rng.normal(size=(4, 4, 8))
    tbl = rng.integers(0, 24, (4, 3)).astype(np.int32)
    tw.attend(q, tbl, np.array([12, 5, 1, 0], np.int32))


def test_reads_sharing_a_slot_last_row_wins():
    """Rows 0 and 2 of one read name pages 1 and 5, both on slot 1 of 4:
    both miss, the later row's page is installed; then a read whose last
    row on the slot is a HIT keeps the slot, though an earlier row of
    the same read missed on it."""
    tw = Twin(**_geom("float32", n_replicas=2, cache_slots=4))
    for p in (1, 5, 9):
        tw.append(0, [p], [0], np.full((1, 2, 8), p), np.full((1, 2, 8), -p))
    _, _, hit = tw.read(1, [1, 2, 5])
    assert not hit.any()
    assert tw.t.cache["tag_page"][1, 1].item() == 5
    _, _, hit = tw.read(1, [9, 5])            # 9 misses, then 5 hits
    assert hit.tolist() == [False, True]
    assert tw.t.cache["tag_page"][1, 1].item() == 5
    _, _, hit = tw.read(1, [5, 9])            # 5 hits, then 9 installs
    assert hit.tolist() == [True, False]
    assert tw.t.cache["tag_page"][1, 1].item() == 9


@pytest.mark.parametrize("dtype", DTYPES)
def test_append_duplicate_slot_last_row_wins(dtype):
    """Three rows name (page 2, offset 1): the last row's token is what
    the page holds; the version counts all three rows (and the fourth,
    at another offset), the fill is the largest offset + 1."""
    tw = Twin(**_geom(dtype))
    k = np.arange(4 * 2 * 8, dtype=np.float32).reshape(4, 2, 8)
    tw.append(1, [2, 2, 2, 2], [1, 1, 3, 1], k, -k)
    assert torch.equal(tw.t.pool["k_pages"][2, 1].float(),
                       torch.from_numpy(k[3]).to(tw.t.pool["k_pages"].dtype)
                       .float())
    assert tw.t.pool["page_version"][2].item() == 4
    assert tw.t.pool["page_fill"][2].item() == 4


def test_reference_drops_page0_bit():
    """The reference's merge loses page 0's reader bit when an empty row
    follows the miss; the port keeps it (the module docstring)."""
    tw = Twin(**_geom("float32"))
    pages = np.array([0, -1], np.int32)
    tw.j.read(1, pages)
    tw.t.read(1, pages)
    assert np.asarray(tw.j.pool["words"])[0].tolist() == [0, 0]
    assert tw.t.pool["words"][0].tolist() == [0, 2]


def test_page0_fault_is_repaired_in_traces():
    """The harness meets the fault in a seeded trace and keeps going."""
    tw = Twin(**_geom("bfloat16", n_pages=8, cache_slots=2))
    _trace(tw, np.random.default_rng(5), 40, 8, 4, 2, 8, 3)
    assert tw.page0_faults > 0


# ------------------------------------------------- rounds plane, convert

@pytest.mark.parametrize("dtype", DTYPES)
def test_open_rounds_plane_seeds_the_shadow_pages(dtype):
    tw = Twin(**_geom(dtype))
    rng = np.random.default_rng(2)
    _trace(tw, rng, 12, 16, 4, 2, 8, 3)
    sj = tw.j.open_rounds_plane()
    st = tw.t.open_rounds_plane()
    assert np.array_equal(np.asarray(sj["mem_data"]),
                          st["mem_data"].numpy())
    # the plane now serves the appended bytes
    kj, _, _ = tw.j.read(2, np.arange(16, dtype=np.int32))
    kt, _, _ = tw.t.read(2, np.arange(16, dtype=np.int32))
    assert np.array_equal(_bits(kj), _bits(kt))
    assert np.array_equal(_bits(kt), _bits(tw.t.pool["k_pages"]))
    with pytest.raises(RuntimeError, match="already open"):
        tw.t.open_rounds_plane()
    assert set(tw.t.as_rounds_state()) == set(tw.j.as_rounds_state())


@pytest.mark.parametrize("dtype", DTYPES)
def test_convert_carries_a_legacy_pool(dtype):
    """A JAX legacy pool's numpy leaves become a port pool that
    continues the trace exactly."""
    geom = _geom(dtype, n_replicas=2)
    tw = Twin(**geom)
    rng = np.random.default_rng(8)
    tw.j.allocate(5)
    tw.j.free([1, 3])
    _trace(tw, rng, 10, 16, 4, 2, 8, 2)
    cont = convert.legacy_pool_from_arrays(
        tkv.KVPoolConfig(**geom),
        {k: np.asarray(v) for k, v in tw.j.pool.items()},
        {k: np.asarray(v) for k, v in tw.j.cache.items()},
        alloc_top=tw.j._alloc.top, alloc_freed=tw.j._alloc._freed,
        device="cpu")
    tw.t = cont
    tw.check("after convert")
    assert cont.allocate(3).tolist() == tw.j.allocate(3).tolist()
    _trace(tw, rng, 10, 16, 4, 2, 8, 2)


def _chip_smoke():
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def test_chip_smoke_legacy_phase_on_cpu():
    """``chip_smoke.py``'s phase 3b at a small size on the CPU: its
    oracle agrees with the pool (pages, versions, fills, evictions,
    words, hit masks), the attends with the plain kernel, the CPU twin
    with the run; readers on sequence 0's tail pages get evicted, and
    the recorded calls are the path's (duplicate K2 rows, reader
    bits)."""
    from repro_torch import kernels as K
    cs = _chip_smoke()
    cfg = tkv.KVPoolConfig(n_pages=64, page_size=4, n_kv_heads=2,
                           head_dim=8, n_replicas=4, cache_slots=16)
    res, calls = cs.legacy_phase(torch.device("cpu"), K, cfg,
                                 n_q_heads=4, n_seqs=8, prefill=24,
                                 steps=8)
    assert res["appends"] == 4 + 4 * 8 and res["reads"] == 4 * 8
    assert res["rows_appended"] == 8 * 32
    assert res["append_evictions"] > 0 and 0 < res["hit_rate"] < 1
    words, req = calls["k1"]
    assert req["line"].shape[0] == 2 * 24       # a replica's prefill
    pages, _, req_page, _, bit_lo = calls["k2_last"][0]
    valid = req_page[req_page >= 0]
    assert valid.unique().numel() < valid.numel()
    assert int(bit_lo.max()) == 1                # replica 0's bit
    assert calls["k3"][0].shape == (8, 4, 8)
