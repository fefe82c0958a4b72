"""The sharded coherence plane: the port's ``Mesh`` planes against the
JAX package's sharded planes and against the port's own flat plane.

Exact throughout (integer protocol state; the serve's attend within
1e-4):

* ``_bucket`` against the reference's on seeded requests with caps that
  overflow: buckets, ``order``, ``keep``, the scatter indices and
  ``dropped``; ``distributed_latch_round`` against K1's plain version on
  the flat words;
* the stripe helpers round-trip and ``convert.sharded_state_from_arrays``
  carries a JAX sharded state across;
* the port's 4 shards against its flat plane on the reference's own
  trace (``tests/test_sharded_rounds.py``), write-through and
  write-back, bare and payload, and on a ``bucket_cap`` that overflows;
* the scenarios below (ops, a ``bucket_cap`` overflow, rmw, descent,
  evict, rehome + replicate on the congestion trace, 2PL and TO, the
  serve trace) on the port's ``Mesh`` and on a JAX ``Mesh`` with
  ``Auto`` axes, comparing versions, data, rounds, every telemetry field
  (the ``[S, S]`` occupancy and deferred counts included) and the final
  sharded and unsharded state: one shard here, in process; four in
  ``tests/test_torch_sharded_apps.py``.  (jax 0.9's ``make_mesh`` gives
  ``Explicit`` axes, under which the reference's ``unshard_state``
  fails; a ``Mesh`` built from the devices has ``Auto`` axes and runs
  the reference as written.)
"""

import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402


from _torch_threads import _one_thread  # noqa: E402,F401


ROOT = pathlib.Path(__file__).resolve().parents[1]
N_NODES = 4


# ----------------------------------------------- the packages, side by side

def _jax_add(data, line, x):
    import jax.numpy as jnp
    return data + jnp.where(line[:, None] >= 0, x[:, None], 0)


def _torch_add(data, line, x):
    return data + torch.where(line[:, None] >= 0, x[:, None], 0)


def _jax_chain(d, key):
    return d[:, 1] == 1, d[:, 1] == 2, d[:, 0]


def _torch_chain(d, key):
    return d[:, 1] == 1, d[:, 1] == 2, d[:, 0]


class Pkg:
    """One package's plane surface at ``n_shards`` (0 = the port's flat
    plane)."""

    def __init__(self, name: str, n_shards: int, mesh=None):
        self.name, self.n_shards = name, n_shards
        if name == "jax":
            import jax
            from repro.core import rounds as rp
            from repro.core.rounds import placement
            devs = np.array(jax.devices()[:n_shards])
            assert devs.size == n_shards, "not enough host devices"
            self.mesh = jax.sharding.Mesh(devs, ("shards",))
            self.add, self.chain = _jax_add, _jax_chain
        else:
            from repro_torch.core import rounds as rp
            from repro_torch.core.rounds import placement
            self.mesh = mesh if mesh is not None else (
                rp.Mesh(n_shards, device="cpu") if n_shards else None)
            self.add, self.chain = _torch_add, _torch_chain
        self.rp, self.placement = rp, placement

    @property
    def shards(self) -> int:
        return max(self.n_shards, 1)

    def plane(self, n_lines, **kw):
        cap = kw.pop("bucket_cap", None)
        if self.mesh is None:
            state = self.rp.make_state(N_NODES, n_lines, device="cpu", **kw)
        else:
            state = self.rp.make_sharded_state(N_NODES, n_lines, self.mesh,
                                               **kw)
        return self.rp.DevicePlane.open(state, self.mesh, n_nodes=N_NODES,
                                        bucket_cap=cap, max_rounds=256)


def host(x) -> np.ndarray:
    """A host copy (a CPU tensor's ``numpy()`` shares its memory, and
    the plane updates its leaves in place)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().copy()
    return np.array(x)


def _result(out, tag, res):
    if res.version is not None:
        out[f"{tag}/version"] = host(res.version)
    out[f"{tag}/data"] = host(res.data)
    out[f"{tag}/rounds"] = np.asarray(res.rounds)
    for k in res.telemetry.keys():
        out[f"{tag}/tele/{k}"] = host(res.telemetry[k])
    for k, v in (res.stats or {}).items():
        out[f"{tag}/stats/{k}"] = host(v)


def _state(out, tag, plane):
    state = plane.state
    if getattr(plane.mesh, "ranked", False):     # every rank's slabs
        from repro_torch.core.rounds import gather_state
        state = gather_state(state, plane.mesh)
    for k, v in state.items():
        out[f"{tag}/state/{k}"] = host(v)
    for k, v in plane.flat_state().items():
        out[f"{tag}/flat/{k}"] = host(v)


def sc_ops(pk, out, *, write_back, width, cap, seed):
    """Seeded mixed batches of 10 slots (padded to the shard count) over
    16 lines; with ``cap`` the lines crowd onto 6, so buckets overflow."""
    rng = np.random.default_rng(seed)
    plane = pk.plane(16, write_back=write_back, payload_width=width,
                     bucket_cap=cap)
    hot = 6 if cap else 16
    for b in range(6):
        node = rng.integers(0, N_NODES, 10).astype(np.int32)
        line = rng.integers(-1, hot, 10).astype(np.int32)
        isw = (rng.random(10) < 0.4).astype(np.int32)
        wd = (rng.integers(0, 1 << 20, (10, width)).astype(np.int32)
              if width else None)
        _result(out, f"b{b}", plane.ops(node, line, isw, wd))
        plane.check()
    _state(out, "end", plane)


def sc_rmw(pk, out, *, write_back, seed):
    """Read-modify-writes adding an operand to lane 0, distinct lines a
    batch (the verb's contract), 6 slots over 12 lines."""
    rng = np.random.default_rng(seed)
    plane = pk.plane(12, write_back=write_back, payload_width=2)
    for b in range(4):
        node = rng.integers(0, N_NODES, 6).astype(np.int32)
        line = rng.permutation(12)[:6].astype(np.int32)
        line[b % 6] = -1
        x = rng.integers(1, 100, 6).astype(np.int32)
        _result(out, f"b{b}", plane.rmw(node, line, modify=pk.add,
                                        operands=(x,)))
        plane.check()
    _state(out, "end", plane)


def sc_descent(pk, out, *, seed):
    """Three-level chains (lanes: next line, 1 = leaf, 2 = hop right)
    written by ops, walked by descents from several nodes with writes
    between the walks."""
    rng = np.random.default_rng(seed)
    plane = pk.plane(16, payload_width=2)
    lanes = np.zeros((16, 2), np.int32)
    for i in range(4):
        lanes[i] = (4 + i, 0)            # root -> mid
        lanes[4 + i] = (8 + i, 0)        # mid -> leaf
        lanes[8 + i] = (12 + i, 2 * (i % 2) + (1 - i % 2))
        lanes[12 + i] = (i, 1)           # hop target: a leaf
    plane.ops(np.zeros(16, np.int32), np.arange(16, dtype=np.int32),
              np.ones(16, np.int32), lanes)
    for b in range(3):
        node = rng.integers(0, N_NODES, 6).astype(np.int32)
        root = rng.integers(0, 4, 6).astype(np.int32)
        root[5] = -1
        key = rng.integers(0, 100, 6).astype(np.int32)
        _result(out, f"walk{b}", plane.descent(node, key, root,
                                               transition=pk.chain))
        w = int(rng.integers(4, 8))
        _result(out, f"write{b}", plane.ops(
            np.asarray([b % N_NODES], np.int32), np.asarray([w], np.int32),
            np.ones(1, np.int32), lanes[w:w + 1]))
        plane.check()
    _state(out, "end", plane)


def sc_evict(pk, out, *, write_back, seed):
    """Writes and reads, then evictions of 7 slots (duplicates and pads
    included) under ``bucket_cap=1`` (several passes), on a replica
    plane with two replicated lines."""
    rng = np.random.default_rng(seed)
    plane = pk.plane(8, write_back=write_back, payload_width=2,
                     replicas=True, bucket_cap=1)
    plane.replicate([1, 5])
    for b in range(4):
        node = rng.integers(0, N_NODES, 8).astype(np.int32)
        line = rng.integers(0, 8, 8).astype(np.int32)
        isw = (rng.random(8) < 0.5).astype(np.int32)
        wd = rng.integers(0, 1 << 20, (8, 2)).astype(np.int32)
        _result(out, f"b{b}", plane.ops(node, line, isw, wd))
        en = rng.integers(0, N_NODES, 7).astype(np.int32)
        el = rng.integers(-1, 8, 7).astype(np.int32)
        plane.evict(en, el)
        _state(out, f"evict{b}", plane)
        plane.check()


CONGESTION_TRACE = [
    [(0, 0, 0), (1, 0, 0), (2, 1, 0), (3, 2, 0)],
    [(0, 0, 1), (3, 3, 1), (2, 2, 1)],
    [(1, 0, 0), (2, 0, 0), (0, 4, 0), (2, 1, 1)],
    [(0, 0, 1), (1, 1, 1), (3, 5, 1)],
    [(1, 0, 0), (2, 2, 0), (0, 1, 0), (3, 4, 0)],
    [(2, 3, 1), (1, 5, 1), (0, 2, 1)],
    [(n, l, 0) for n, l in zip(range(4), (0, 1, 2, 3))]
    + [(0, 4, 0), (1, 5, 0)],
]


def sc_rehome(pk, out, *, write_back):
    """``tests/test_congestion.py``'s trace on a home-directory replica
    plane: the hottest lines move mid-stream (``plan_rehome``), two more
    without victims, a read-mostly pick is replicated, and the trace
    reads on from the replicas."""
    s = pk.shards
    plane = pk.plane(8, write_back=write_back, payload_width=2,
                     home_directory=True, replicas=True)
    hits = np.zeros(8, np.int64)
    whits = np.zeros(8, np.int64)
    for b, batch in enumerate(CONGESTION_TRACE + CONGESTION_TRACE[::-1]):
        node, line, isw = (np.asarray([x[i] for x in batch], np.int32)
                           for i in range(3))
        wd = np.asarray([[b * 16 + j + 1, n] if w else [0, 0]
                         for j, (n, _, w) in enumerate(batch)], np.int32)
        res = plane.ops(node, line, isw, wd)
        _result(out, f"b{b}", res)
        hits += host(res.telemetry.line_hits).astype(np.int64)
        whits += host(res.telemetry.line_whits).astype(np.int64)
        if b == 2:
            lines, homes, victims = pk.placement.plan_rehome(
                hits, host(plane.state["home"]), s, max_moves=4)
            out["moved2"] = np.asarray(plane.rehome(lines, homes, victims))
        if b == 4:
            out["moved4"] = np.asarray(plane.rehome(
                np.asarray([0, 3]), np.asarray([2 % s, 1 % s])))
            picks = pk.placement.plan_replication(hits, whits, top_k=3,
                                                  max_write_frac=0.5)
            plane.replicate(picks)
            out["picks"] = np.asarray(picks)
        if b == 9:
            plane.replicate([picks[0]], enable=False)
        _state(out, f"b{b}", plane)
        plane.check()


def _txn_batch(rng, b, g, t, n_gcls):
    glines = np.full((b, g), -1, np.int32)
    for i in range(b):
        k = int(rng.integers(1, g + 1))
        glines[i, :k] = np.sort(rng.choice(n_gcls, k, replace=False))
    valid = (glines >= 0)[:, :, None]
    rmask = ((rng.random((b, g, t)) < 0.4) & valid).astype(np.int32)
    wmask = ((rng.random((b, g, t)) < 0.3) & valid).astype(np.int32)
    ts = rng.permutation(b).astype(np.int32)
    node = rng.integers(0, N_NODES, b).astype(np.int32)
    return node, glines, rmask, wmask, ts


def sc_txn(pk, out, *, algo, seed):
    """Two batches of 10 transactions (padded to the shard count), at
    most 3 GCLs of 2 tuples each over 8 GCLs: dedup losers, no-wait
    retries and TO aborts all occur."""
    rng = np.random.default_rng(seed)
    plane = pk.plane(8, payload_width=2 + 2 * 2)
    for it in range(2):
        res = plane.txn(*_txn_batch(rng, 10, 3, 2, 8), algo=algo)
        for k in ("decision", "exec_step", "retries"):
            out[f"t{it}/{k}"] = host(getattr(res, k))
        out[f"t{it}/iters"] = np.asarray(res.iters)
        out[f"t{it}/rounds"] = np.asarray(res.rounds)
        for k in res.telemetry.keys():
            out[f"t{it}/tele/{k}"] = host(res.telemetry[k])
        plane.check()
    _state(out, "end", plane)


def sc_serve(pk, out, *, dtype="float32"):
    """``tests/test_serve.py``'s mixed trace through a ``ServeLoop`` over
    a mesh-backed pool: tokens, every tick's rounds, each completion's
    KV readback and last attend, the final rounds state."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_serve_side import GEOM, _Side, mixed_trace
    geom = dict(GEOM, dtype=dtype)
    if pk.name == "jax":
        import repro.serve as serve
        from repro.dsm import kvpool
        pool = kvpool.SELCCKVPool(kvpool.KVPoolConfig(**geom), pk.mesh)
    else:
        import repro_torch.serve as serve
        from repro_torch.dsm import kvpool
        pool = kvpool.SELCCKVPool(kvpool.KVPoolConfig(**geom), pk.mesh,
                                  device="cpu")
    pool.open_rounds_plane()
    side = _Side(serve, pool)
    reqs = side.submit(mixed_trace(side.shared))
    while side.loop.has_work():
        side.tick()
    out["rounds"] = np.asarray(side.rounds)
    for r in reqs:
        out[f"r{r.rid}/tokens"] = np.asarray(r.generated)
        out[f"r{r.rid}/k"], out[f"r{r.rid}/v"] = side.readback[r.rid]
        out[f"r{r.rid}/attn"] = side.attn[r.rid]
    out["pages_in_use"] = np.asarray(pool.pages_in_use)
    _state(out, "end", pool.rounds_plane)


def scenarios(group: str) -> dict:
    """name -> (function, keyword arguments); ``group`` 1 or 2 splits
    them between the two JAX subprocesses."""
    one = {}
    for wb in (False, True):
        for width in (0, 3):
            one[f"ops_wb{int(wb)}_w{width}"] = (
                sc_ops, dict(write_back=wb, width=width, cap=None,
                             seed=10 + 2 * wb + width))
        one[f"overflow_wb{int(wb)}"] = (
            sc_ops, dict(write_back=wb, width=2, cap=1, seed=20 + wb))
        one[f"rmw_wb{int(wb)}"] = (sc_rmw, dict(write_back=wb,
                                                seed=30 + wb))
        one[f"evict_wb{int(wb)}"] = (sc_evict, dict(write_back=wb,
                                                    seed=40 + wb))
        one[f"rehome_wb{int(wb)}"] = (sc_rehome, dict(write_back=wb))
    one["descent"] = (sc_descent, dict(seed=50))
    two = {f"txn_{algo}": (sc_txn, dict(algo=algo, seed=60 + i))
           for i, algo in enumerate(("2pl", "to"))}
    two["serve"] = (sc_serve, {})
    return {"1": one, "2": two, "all": {**one, **two}}[group]


def run_scenarios(pk, group: str) -> dict:
    out = {}
    for name, (fn, kw) in scenarios(group).items():
        res = {}
        fn(pk, res, **kw)
        out.update({f"{name}/{k}": v for k, v in res.items()})
    return out


def assert_same(got: dict, want: dict, *, skip=()):
    assert sorted(got) == sorted(want), \
        sorted(set(got).symmetric_difference(want))
    for k in want:
        if any(s in k for s in skip):
            continue
        if k.endswith("/attn"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                       err_msg=k)
        else:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------- routing pieces

@pytest.mark.parametrize("cap", [1, 3, 8])
def test_bucket_matches_jax(cap):
    from repro.core import distributed_rounds as jdr
    from repro_torch.core import distributed_rounds as tdr
    rng = np.random.default_rng(cap)
    reqs = {k: rng.integers(0, 1 << 20, 12).astype(np.int32)
            for k in jdr.FIELDS}
    reqs["line"] = rng.integers(-1, 9, 12).astype(np.int32)
    wd = rng.integers(0, 99, (12, 3)).astype(np.int32)
    dropped = 0
    for home in (None, rng.integers(0, 5, 12).astype(np.int32)):
        jr = jdr._bucket(dict(reqs, wdata=wd), 4, cap,
                         fields=jdr.FIELDS + ("wdata",), home=home)
        tr = tdr._bucket({k: torch.from_numpy(v) for k, v in
                          dict(reqs, wdata=wd).items()}, 4, cap,
                         fields=tdr.FIELDS + ("wdata",),
                         home=None if home is None
                         else torch.from_numpy(home))
        for k in jdr.FIELDS + ("wdata",):
            np.testing.assert_array_equal(host(tr[0][k]),
                                          np.asarray(jr[0][k]), err_msg=k)
        for a, b in zip((tr[1], tr[2], *tr[3], tr[4]),
                        (jr[1], jr[2], *jr[3], jr[4])):
            np.testing.assert_array_equal(host(a), np.asarray(b))
        dropped += int(jr[4])
    assert dropped > 0 or cap > 1


def test_bucket_rows_are_per_source_shard():
    """A leading shard axis buckets each source's row on its own, as
    the reference buckets inside each shard."""
    from repro_torch.core import distributed_rounds as tdr
    rng = np.random.default_rng(5)
    line = torch.from_numpy(rng.integers(-1, 8, (4, 6)).astype(np.int32))
    node = torch.from_numpy(rng.integers(0, 4, (4, 6)).astype(np.int32))
    many = tdr._bucket({"line": line, "node": node}, 4, 2,
                       fields=("line", "node"))
    for s in range(4):
        one = tdr._bucket({"line": line[s], "node": node[s]}, 4, 2,
                          fields=("line", "node"))
        for k in ("line", "node"):
            assert torch.equal(many[0][k][s], one[0][k])
        for a, b in zip((many[1][s], many[2][s], many[3][0][s],
                         many[3][1][s], many[4][s]),
                        (one[1], one[2], *one[3], one[4])):
            assert torch.equal(a, b)


def test_distributed_latch_round_matches_k1():
    """The latch plane at 4 shards: every home's K1 on its slab equals
    K1 on the flat words; stripe and unstripe round-trip."""
    from repro_torch.core import distributed_rounds as tdr
    from repro_torch.core.rounds import Mesh
    from repro_torch.kernels.latch_ops import OP_CAS, OP_FAA, apply_batch
    rng = np.random.default_rng(8)
    flat = torch.from_numpy(rng.integers(0, 3, (32, 2)).astype(np.int32))
    words = tdr.stripe(flat, 4)
    assert torch.equal(tdr.unstripe(words, 4), flat)
    req = {"line": rng.integers(-1, 32, 24),
           "op": rng.choice([OP_CAS, OP_FAA], 24),
           "arg_hi": rng.integers(0, 3, 24), "arg_lo": rng.integers(0, 3, 24),
           "cmp_hi": rng.integers(0, 3, 24), "cmp_lo": rng.integers(0, 3, 24)}
    req = {k: torch.from_numpy(v.astype(np.int32)) for k, v in req.items()}
    new, hi, lo, ok, dropped = tdr.distributed_latch_round(
        words, req, mesh=Mesh(4, device="cpu"))
    # per-home slot order is (source shard, slot): the global slot order
    want = apply_batch(flat, req)
    assert int(dropped) == 0
    assert torch.equal(tdr.unstripe(new, 4), want[0])
    for a, b in zip((hi, lo, ok), want[1:]):
        assert torch.equal(a, b)
    assert tdr.make_sharded_words(32, Mesh(4, device="cpu")).shape == (32, 2)
    with pytest.raises(ValueError, match="divisible"):
        tdr.make_sharded_words(30, Mesh(4, device="cpu"))


def test_mesh_guards():
    from repro_torch.core import rounds as tr
    mesh = tr.Mesh(4, device="cpu")
    assert mesh.shape["shards"] == 4 and mesh.axis_names == ("shards",)
    assert mesh == tr.Mesh(4, device="cpu") != tr.Mesh(2, device="cpu")
    state = tr.make_sharded_state(2, 10, mesh)
    assert state["words"].shape == (12, 2)          # rounded up
    with pytest.raises(TypeError, match="Mesh"):
        tr.DevicePlane.open(state, object())
    with pytest.raises(ValueError, match="divisible"):
        tr.DevicePlane.open(tr.make_state(2, 10, device="cpu"), mesh)
    with pytest.raises(ValueError, match=">= 1"):
        tr.Mesh(0, device="cpu")
    with pytest.raises(ValueError, match="pad_ops"):
        tr.run_rounds_sharded(state, [0], [1], [0], mesh=mesh, n_nodes=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tr.Mesh(4)
    plane = tr.DevicePlane.open(state, mesh)
    assert plane.sharded and plane.n_shards == 4
    assert "sharded x4" in repr(plane)
    with pytest.raises(ValueError, match="home-directory"):
        plane.rehome([0], [1])


def test_stripe_round_trip_and_convert():
    """A JAX sharded state (gathered leaves) carries across as it is,
    and unshards to the JAX unsharded state."""
    import jax
    from repro.core import rounds as jr
    from repro_torch import convert
    from repro_torch.core import rounds as tr
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("shards",))
    jst = jr.make_sharded_state(4, 8, jmesh, payload_width=2,
                                home_directory=True, replicas=True)
    arrays = {k: np.asarray(v) for k, v in jst.items()}
    rng = np.random.default_rng(2)
    arrays["mem_data"] = rng.integers(0, 99, (8, 2)).astype(np.int32)
    arrays["home"] = rng.permutation(8).astype(np.int32)
    mesh = tr.Mesh(4, device="cpu")
    st = convert.sharded_state_from_arrays(arrays, mesh)
    back = tr.unshard_state(st, mesh)
    want = jr.state.unstripe_state({k: np.asarray(v)
                                    for k, v in arrays.items()}, 4)
    for k in arrays:
        np.testing.assert_array_equal(host(back[k]), np.asarray(want[k]))
    again = tr.shard_state(back, mesh)
    for k in arrays:
        assert torch.equal(again[k], st[k]), k
    with pytest.raises(ValueError, match="divisible"):
        convert.sharded_state_from_arrays(
            {k: v[..., :6] if k == "words" else v
             for k, v in arrays.items()} | {"words": arrays["words"][:6]},
            mesh)


# ---------------------------------------------- port flat vs port sharded

@pytest.mark.parametrize("write_back", [False, True])
@pytest.mark.parametrize("width", [0, 2])
@pytest.mark.parametrize("cap", [None, 1])
def test_four_shards_match_flat_on_reference_trace(write_back, width, cap):
    """``tests/test_sharded_rounds.py``'s TRACE, each batch repeated
    four times (so ``bucket_cap=1`` overflows), on the port's flat plane
    and its 4-shard plane: versions, payloads, per-line hits and the
    unsharded state equal; the 4-shard plane defers under the cap."""
    from test_sharded_rounds import TRACE, _wdata
    from repro_torch.core import rounds as tr
    flat = Pkg("torch", 0).plane(8, write_back=write_back,
                                 payload_width=width)
    shd = Pkg("torch", 4).plane(8, write_back=write_back,
                                payload_width=width, bucket_cap=cap)
    deferred = 0
    for b, batch in enumerate(TRACE):
        node, line, isw = (np.asarray([x[i] for x in batch] * 4, np.int32)
                           for i in range(3))
        wd = np.tile(_wdata(b, batch, width), (4, 1)) if width else None
        rf, rs = flat.ops(node, line, isw, wd), shd.ops(node, line, isw, wd)
        np.testing.assert_array_equal(rs.version, rf.version)
        np.testing.assert_array_equal(rs.data, rf.data)
        np.testing.assert_array_equal(rs.telemetry.line_hits,
                                      rf.telemetry.line_hits)
        np.testing.assert_array_equal(rs.telemetry.line_whits,
                                      rf.telemetry.line_whits)
        assert rs.telemetry.served == rf.telemetry.served
        deferred += rs.telemetry.deferred_total
        shd.check()
    assert (deferred > 0) == (cap == 1)
    got = shd.flat_state()
    for k, v in flat.state.items():
        assert torch.equal(got[k], v), k
    assert isinstance(shd.mesh, tr.Mesh)


@pytest.mark.parametrize("cap", [None, 1])
def test_coherence_round_sharded_matches_flat_round(cap):
    """One sharded round against one flat round on the same slots: with
    room in every bucket the replies and the unsharded state are the
    flat round's; under ``bucket_cap=1`` the overflowed slots come back
    unserved and the rest match the flat round on the slots it sent."""
    from repro_torch.core import rounds as tr
    mesh = tr.Mesh(4, device="cpu")
    rng = np.random.default_rng(9)
    node = torch.from_numpy(rng.integers(0, 4, 16).astype(np.int32))
    line = torch.from_numpy(rng.permutation(32)[:16].astype(np.int32))
    isw = torch.from_numpy((rng.random(16) < 0.5).astype(np.int32))
    wd = torch.from_numpy(rng.integers(0, 99, (16, 3)).astype(np.int32))
    flat = tr.make_state(4, 32, payload_width=3, device="cpu")
    shd = tr.make_sharded_state(4, 32, mesh, payload_width=3)
    shd, served, ver, data = tr.coherence_round_sharded(
        shd, node, line, isw, wd, mesh=mesh, n_nodes=4, bucket_cap=cap)
    if cap is not None:
        assert not served.all()
        line = torch.where(served, line, -1)       # what the round sent
    flat, f_served, f_ver, f_data = tr.coherence_round(
        flat, node, line, isw, wd, n_nodes=4)
    assert torch.equal(served, f_served & (line >= 0))
    assert torch.equal(ver, f_ver) and torch.equal(data, f_data)
    for k, v in tr.unshard_state(shd, mesh).items():
        assert torch.equal(v, flat[k]), k


# ----------------------------------------- the port against JAX's planes

@pytest.mark.parametrize("names", [
    ("ops_wb1_w3", "overflow_wb0", "rmw_wb1", "descent"),
    ("evict_wb1", "rehome_wb1", "txn_to")])
def test_one_shard_matches_jax_in_process(names):
    """Scenarios of every verb on a one-shard JAX plane and a one-shard
    port plane (the sharded drivers at S = 1: the flat round body's
    replica refresh runs inside the home, as in the reference)."""
    for name in names:
        fn, kw = scenarios("all")[name]
        want, got = {}, {}
        fn(Pkg("jax", 1), want, **kw)
        fn(Pkg("torch", 1), got, **kw)
        assert_same(got, want)
