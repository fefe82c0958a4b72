"""The port's B-link tree against the JAX package's, bit for bit.

Same inputs (numpy seeds) through both packages, at the sizes of
``tests/test_device_btree.py`` (fanout 4, 256 lines; 4 nodes):

* the node codec — ``encode`` / ``decode`` equal, ``insert_modify`` and
  ``descend_step`` bit-exact on random node lanes (leaf and internal
  rows, existing and new keys, high-key hops, ``line = -1`` rows);
* ``run_descent`` on a tree of height >= 3 — every returned value, every
  state leaf and the telemetry counters equal;
* ``DeviceBTree`` on a mixed lookup/insert/scan trace, for the
  ``fused``, ``level`` and ``host`` drivers, write-through and
  write-back — after EVERY batch the results, every state leaf,
  ``items()`` and the stats are equal, and ``check_invariants()`` holds;
* ``open`` adopting a state carried from the JAX tree, and rejecting
  foreign states as the reference does.

The JAX side runs with ``backend="ref"``, as its own tests do.  The
port's engine updates its state in place, so it gets its own copy.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import rounds as jr  # noqa: E402
from repro.index import DeviceBTree as JTree  # noqa: E402
from repro.index import codec as jcodec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import rounds as tr  # noqa: E402
from repro_torch.index import DeviceBTree as TTree  # noqa: E402
from repro_torch.index import codec as tcodec  # noqa: E402


from _torch_threads import _one_thread  # noqa: E402,F401


FANOUT = 4
N_NODES = 4
N_LINES = 256
KEYSPACE = 2_000


def _assert_same_state(jstate, tstate, where):
    j = {k: np.asarray(v) for k, v in jstate.items()}
    t = convert.to_numpy(tstate)
    assert sorted(j) == sorted(t), where
    for k in j:
        assert t[k].dtype == j[k].dtype, (where, k)
        np.testing.assert_array_equal(t[k], j[k], err_msg=f"{where}: {k}")


# ----------------------------------------------------------------- codec

def test_codec_encode_decode_equal():
    jc, tc = jcodec.NodeCodec(FANOUT), tcodec.NodeCodec(FANOUT)
    assert (tc.cap, tc.vals_off, tc.width) == (jc.cap, jc.vals_off,
                                               jc.width)
    for kw in (dict(leaf=True), dict(leaf=True, keys=[3, 7, 9],
                                     vals=[30, 70, 90], right=12, high=11),
               dict(leaf=False, keys=[50], vals=[4, 9]),
               dict(leaf=False, keys=[5, 8, 13, 21, 34],
                    vals=[1, 2, 3, 4, 5, 6], right=7, high=40)):
        lanes = tc.encode(**kw)
        np.testing.assert_array_equal(lanes, jc.encode(**kw))
        assert tc.decode(lanes) == tcodec.DecodedNode(
            **vars(jc.decode(lanes)))
    for bad in (dict(leaf=True, keys=[1, 2], vals=[1]),
                dict(leaf=False, keys=[1], vals=[1]),
                dict(leaf=True, keys=list(range(tc.cap + 1)),
                     vals=list(range(tc.cap + 1)))):
        with pytest.raises(ValueError):
            tc.encode(**bad)


def _random_nodes(rng, b, fanout):
    """``b`` node rows: leaf and internal, 0..fanout keys, sorted, some
    with a high key and right link; plus per-row keys that are existing
    keys, new keys, keys at or past the high key, and ``line = -1``."""
    c = tcodec.NodeCodec(fanout)
    rows, keys = [], []
    for i in range(b):
        leaf = bool(rng.random() < 0.5)
        nk = int(rng.integers(0 if leaf else 1, fanout + 1))
        ks = np.sort(rng.choice(1000, nk, replace=False)) + 10
        vs = rng.integers(1, 1 << 20, nk if leaf else nk + 1)
        has_high = bool(rng.random() < 0.5)
        high = int(ks.max(initial=10) + rng.integers(1, 50)) \
            if has_high else None
        right = int(rng.integers(1, 200)) if has_high else \
            int(rng.choice([-1, 5]))
        rows.append(c.encode(leaf=leaf, keys=ks, vals=vs, right=right,
                             high=high))
        pick = rng.random()
        if nk and pick < 0.35:
            keys.append(int(rng.choice(ks)))                # existing
        elif has_high and pick < 0.55:
            keys.append(high + int(rng.integers(0, 3)))     # hop
        else:
            keys.append(int(rng.integers(0, 1100)))        # new
    line = rng.integers(0, 200, b).astype(np.int32)
    line[rng.random(b) < 0.2] = -1
    return (np.stack(rows).astype(np.int32), line,
            np.asarray(keys, np.int32),
            rng.integers(1, 1 << 20, b).astype(np.int32))


@pytest.mark.parametrize("fanout,seed", [(4, 0), (4, 1), (16, 2)])
def test_insert_modify_and_descend_step_bit_exact(fanout, seed):
    rng = np.random.default_rng(seed)
    data, line, keys, vals = _random_nodes(rng, 96, fanout)
    want = np.asarray(jcodec.insert_modify(fanout)(data, line, keys, vals))
    got = tcodec.insert_modify(fanout)(torch.from_numpy(data),
                                       torch.from_numpy(line),
                                       torch.from_numpy(keys),
                                       torch.from_numpy(vals))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != data).any() and (want == data).all(axis=1).any()
    jout = jcodec.descend_step(fanout)(data, keys)
    tout = tcodec.descend_step(fanout)(torch.from_numpy(data),
                                       torch.from_numpy(keys))
    for a, b, name in zip(jout, tout, ("at_leaf", "hop", "nxt")):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
    at_leaf, hop = (np.asarray(x) for x in jout[:2])
    assert hop.any() and at_leaf.any() and (~at_leaf & ~hop).any()
    # the host insert_modify takes numpy, as the host driver passes it
    np.testing.assert_array_equal(
        tcodec.insert_modify(fanout)(data, line, keys, vals).numpy(), want)


# ------------------------------------------------------------- descent

def _jax_tree_state(write_back):
    """A JAX tree of height >= 3, grown by inserts from all four nodes,
    and its state as numpy leaves."""
    t = JTree.create(N_NODES, N_LINES, fanout=FANOUT, write_back=write_back)
    rng = np.random.default_rng(5)
    ks = rng.choice(KEYSPACE, 96, replace=False).astype(np.int32)
    for i in range(0, 96, 24):
        t.insert_batch(ks[i:i + 24], ks[i:i + 24] * 3 + 1,
                       node=(i // 24) % N_NODES)
    assert t.height >= 3
    return t, {k: np.asarray(v) for k, v in t.state.items()}


@pytest.mark.parametrize("write_back", [False, True])
def test_run_descent_matches(write_back):
    from repro.core.rounds.descent import run_descent as jdescent
    jt, state_np = _jax_tree_state(write_back)
    rng = np.random.default_rng(8)
    b = 32
    node = rng.integers(0, N_NODES, b).astype(np.int32)
    key = rng.integers(0, KEYSPACE + 100, b).astype(np.int32)
    root = np.full(b, jt.root, np.int32)
    root[rng.random(b) < 0.15] = -1                  # pad slots
    root[:4] = rng.integers(1, jt.alloc.top, 4)      # start mid-tree
    jout = jdescent({k: v for k, v in state_np.items()}, node, key, root,
                    transition=jcodec.descend_step(FANOUT),
                    n_nodes=N_NODES, max_steps=64, path_cap=8)
    tout = tr.run_descent(convert.to_torch(state_np, "cpu"), node, key,
                          root, transition=tcodec.descend_step(FANOUT),
                          n_nodes=N_NODES, max_steps=64, path_cap=8)
    _assert_same_state(jout[0], tout[0], "descent")
    for i, name in enumerate(("line", "lanes", "levels", "hops", "paths",
                              "path_len"), start=1):
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]),
                                      name)
    assert tout[7] == int(jout[7]) and tout[8] is bool(jout[8]) is True
    for k in jout[9]:
        np.testing.assert_array_equal(tout[9][k].numpy(),
                                      np.asarray(jout[9][k]), k)
    assert int(np.asarray(jout[3]).max()) >= 2       # deep walks ran
    # a bound too small to settle is reported, not hidden
    jout = jdescent(jout[0], node, key, root,
                    transition=jcodec.descend_step(FANOUT),
                    n_nodes=N_NODES, max_steps=1, path_cap=8)
    tout = tr.run_descent(tout[0], node, key, root,
                          transition=tcodec.descend_step(FANOUT),
                          n_nodes=N_NODES, max_steps=1, path_cap=8)
    assert tout[7] == int(jout[7]) == 1
    assert tout[8] is bool(jout[8]) is False
    _assert_same_state(jout[0], tout[0], "cut descent")


# ------------------------------------------------------- the differential

def make_trace(seed: int = 17, batches: int = 8):
    """One deterministic mixed trace: (op, node, payload) tuples; the
    ``tests/test_device_btree.py`` shape with 4 nodes and a
    ``scan_batch`` step."""
    rng = np.random.default_rng(seed)
    trace = []
    for b in range(batches):
        node = int(rng.integers(N_NODES))
        kind = ("insert", "insert", "lookup", "scan")[b % 4]
        if kind == "insert":
            ks = rng.integers(0, KEYSPACE, size=12)
            vs = rng.integers(1, 1 << 20, size=12)
            trace.append(("insert", node, ks.astype(np.int32),
                          vs.astype(np.int32)))
        elif kind == "lookup":
            ks = rng.integers(0, KEYSPACE, size=10)
            trace.append(("lookup", node, ks.astype(np.int32)))
        else:
            starts = rng.integers(0, KEYSPACE, size=3).astype(np.int32)
            trace.append(("scan", node, starts, int(rng.integers(3, 12))))
    return trace


@pytest.mark.parametrize("driver,write_back", [
    ("fused", False), ("fused", True), ("level", False), ("level", True),
    ("host", False), ("host", True)])
def test_tree_matches_jax_after_every_batch(driver, write_back):
    kw = dict(fanout=FANOUT, write_back=write_back, driver=driver)
    jt = JTree.create(N_NODES, N_LINES, **kw)
    tt = TTree.create(N_NODES, N_LINES, device="cpu", **kw)
    _assert_same_state(jt.state, tt.state, "create")
    for step in make_trace(seed=17 + write_back):
        kind, node = step[:2]
        if kind == "insert":
            jt.insert_batch(step[2], step[3], node=node)
            tt.insert_batch(step[2], step[3], node=node)
        elif kind == "lookup":
            jv, jf = jt.lookup_batch(step[2], node=node)
            tv, tf = tt.lookup_batch(step[2], node=node)
            np.testing.assert_array_equal(tv, jv)
            np.testing.assert_array_equal(tf, jf)
        else:
            assert tt.scan_batch(step[2], step[3], node=node) == \
                jt.scan_batch(step[2], step[3], node=node)
        where = f"{driver} wb={write_back} after {kind}"
        _assert_same_state(jt.state, tt.state, where)
        assert (tt.root, tt.height, tt.alloc.top) == \
            (jt.root, jt.height, jt.alloc.top), where
        assert tt.stats == jt.stats, where
        assert tt.items() == [(int(k), int(v)) for k, v in jt.items()]
        tt.check_invariants()
    assert tt.stats["splits"] > 0 and tt.height >= 3


# ------------------------------------------------------------- metadata

def test_open_adopts_jax_state_and_rejects_foreign_states():
    jt = JTree.create(N_NODES, 64, fanout=4)
    jt.insert_batch(np.asarray([5, 9, 1, 30, 17, 2], np.int32),
                    np.asarray([50, 90, 10, 300, 170, 20], np.int32))
    state_np = {k: np.asarray(v) for k, v in jt.state.items()}
    tt = TTree.open(convert.to_torch(state_np, "cpu"), n_nodes=N_NODES)
    assert (tt.root, tt.height, tt.alloc.top, tt.codec) == \
        (jt.root, jt.height, jt.alloc.top, tcodec.NodeCodec(4))
    jt2 = JTree.open(jt.state, n_nodes=N_NODES)
    _assert_same_state(jt2.state, tt.state, "open")
    g, f = tt.lookup_batch([9, 5, 2, 4])
    assert f.tolist() == [True, True, True, False]
    assert g[:3].tolist() == [90, 50, 20]
    tt.check_invariants()
    with pytest.raises(ValueError, match="payload"):
        TTree.open(tr.make_state(2, 8, device="cpu"))    # no data plane
    with pytest.raises(ValueError, match="magic"):
        TTree.open(tr.make_state(2, 8, payload_width=16, device="cpu"))
    forged = tr.make_state(2, 8, payload_width=16, device="cpu")
    tr.DevicePlane.open(forged).ops(
        [0], [0], [1], np.asarray([[0x0B713EE, 1, 9, 1, 2] + [0] * 11],
                                  np.int32))
    with pytest.raises(ValueError, match="width"):
        TTree.open(forged)


@pytest.mark.parametrize("seed", [0, 4])
def test_btree_kv_batches_match(seed):
    from repro.apps import workloads as jwl
    from repro_torch.apps import workloads as twl
    for kw in (dict(), dict(read_ratio=1.0, r_slots=256),
               dict(zipf_theta=0.0, n_keys=1 << 16)):
        want = jwl.btree_kv_batches(jwl.BTreeBatchConfig(**kw), seed=seed)
        got = twl.btree_kv_batches(twl.BTreeBatchConfig(**kw), seed=seed)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _chip_smoke():
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def test_chip_smoke_btree_phase_on_cpu():
    """``chip_smoke.py``'s phase 5 at a small size on the CPU: the tree
    image it loads is a B-link tree the JAX package's ``DeviceBTree``
    adopts (its invariants hold, every key is found with its value), and
    the phase's own checks against the oracle pass."""
    cs = _chip_smoke()
    img, root, height, top = cs.btree_image(3000, 512)
    state = dict(jr.make_state(4, 512, payload_width=img.shape[1]))
    state["mem_data"] = img
    jt = JTree.open(state, n_nodes=4)
    assert (jt.root, jt.height, jt.alloc.top) == (root, height, top)
    jt.check_invariants()
    assert jt.items() == [(k, 7 * k + 1) for k in range(3000)]
    res = cs.btree_phase(torch.device("cpu"), n_keys=3000, n_lines=512,
                         slots=64, c_batches=2, a_batches=1, scan_keys=8,
                         scan_count=30, split_keys=256, split_batch=64,
                         split_lines=256)
    assert res["height"] == height == 4
    assert res["ycsb_c"]["rounds_per_batch"] == [height, height]
    assert res["ycsb_a"]["upserts"] > 0 and res["splits"]["splits"] > 0
