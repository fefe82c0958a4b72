"""The port's round engine and drivers against the JAX package's.

Random op traces (numpy seed, duplicate (node, line) slots, -1 pads,
cross-node contention, evictions) go through both packages'
``coherence_round`` / ``evict_lines``.  Every state leaf and every
``served`` / ``version`` / ``data`` output must be bit-identical after
EVERY round, in write-through and write-back, at payload widths 0, 64
and 512, at 2, 4 and 40 nodes (40 crosses the lo/hi lane split at node
32).  The drivers ``run_rounds`` and ``run_rmw`` (with the pool's token
splice) must agree exactly too, telemetry included.  The port's engine
updates its state in place, so it runs on its own copy of the inputs.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import coherence as jco  # noqa: E402
from repro.core import rounds as jr  # noqa: E402
from repro.dsm import kvpool as jkv  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import coherence as tco  # noqa: E402
from repro_torch.core import rounds as tr  # noqa: E402
from repro_torch.core.rounds.driver import run_rmw, run_rounds  # noqa: E402
from repro_torch.dsm import kvpool as tkv  # noqa: E402


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _assert_same_state(jstate, tstate, where):
    j, t = _np(jstate), convert.to_numpy(tstate)
    assert sorted(j) == sorted(t), where
    for k in j:
        assert t[k].dtype == j[k].dtype, (where, k)
        np.testing.assert_array_equal(t[k], j[k], err_msg=f"{where}: {k}")


def _ops(rng, n_nodes, n_lines, r, width):
    """One round's slots: few hot lines so (node, line) duplicates and
    cross-node contention are frequent; ~15% of slots are -1 pads."""
    node = rng.integers(0, n_nodes, r).astype(np.int32)
    line = rng.integers(0, max(2, n_lines // 4), r).astype(np.int32)
    line[rng.random(r) < 0.15] = -1
    isw = (rng.random(r) < 0.4).astype(np.int32)
    wdata = rng.integers(-2**31, 2**31, (r, width)).astype(np.int32)
    return node, line, isw, wdata


@pytest.mark.parametrize("write_back,width,n_nodes", [
    (False, 0, 2), (False, 64, 4), (False, 512, 40),
    (True, 0, 40), (True, 64, 2), (True, 512, 4),
])
def test_round_by_round_bit_exact(write_back, width, n_nodes):
    n_lines, r = 16, 12
    rng = np.random.default_rng(100 + width + n_nodes)
    kw = dict(write_back=write_back, payload_width=width)
    jstate = jr.make_state(n_nodes, n_lines, **kw)
    tstate = tr.make_state(n_nodes, n_lines, device="cpu", **kw)
    _assert_same_state(jstate, tstate, "fresh")
    for step in range(14):
        node, line, isw, wdata = _ops(rng, n_nodes, n_lines, r, width)
        jstate, jsv, jver, jdata = jr.coherence_round(
            jstate, jnp.asarray(node), jnp.asarray(line), jnp.asarray(isw),
            jnp.asarray(wdata) if width else None, n_nodes=n_nodes)
        tstate, tsv, tver, tdata = tr.coherence_round(
            tstate, torch.from_numpy(node), torch.from_numpy(line),
            torch.from_numpy(isw), torch.from_numpy(wdata) if width
            else None, n_nodes=n_nodes)
        where = f"round {step}"
        np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv), where)
        np.testing.assert_array_equal(tver.numpy(), np.asarray(jver), where)
        np.testing.assert_array_equal(tdata.numpy(), np.asarray(jdata),
                                      where)
        _assert_same_state(jstate, tstate, where)
        if step % 4 == 3:                      # evict a few copies
            en = rng.integers(0, n_nodes, 5).astype(np.int32)
            el = rng.integers(-1, n_lines // 4, 5).astype(np.int32)
            jstate = jr.evict_lines(jstate, jnp.asarray(en),
                                    jnp.asarray(el))
            tstate = tr.evict_lines(tstate, torch.from_numpy(en),
                                    torch.from_numpy(el))
            _assert_same_state(jstate, tstate, f"evict after {step}")
        tr.check_invariants(tstate)


def test_replica_and_home_leaves_carry_through():
    """The flat engine refreshes replica images at every boundary and
    carries the home directory untouched, as the reference does."""
    n_nodes, n_lines, width = 4, 8, 16
    rng = np.random.default_rng(5)
    kw = dict(payload_width=width, home_directory=True, replicas=True)
    jstate = {k: np.array(v) for k, v in
              jr.make_state(n_nodes, n_lines, **kw).items()}
    jstate["replica"][::2] = True
    tstate = convert.to_torch(jstate, "cpu")
    for step in range(8):
        node, line, isw, wdata = _ops(rng, n_nodes, n_lines, 10, width)
        jstate, *_ = jr.coherence_round(
            jstate, jnp.asarray(node), jnp.asarray(line), jnp.asarray(isw),
            jnp.asarray(wdata), n_nodes=n_nodes)
        tstate, *_ = tr.coherence_round(
            tstate, torch.from_numpy(node), torch.from_numpy(line),
            torch.from_numpy(isw), torch.from_numpy(wdata),
            n_nodes=n_nodes)
        _assert_same_state(jstate, tstate, f"round {step}")
        en = np.asarray([node[0], -1], np.int32)
        el = np.asarray([line[0], 3], np.int32)
        jstate = jr.evict_lines(jstate, jnp.asarray(en), jnp.asarray(el))
        tstate = tr.evict_lines(tstate, torch.from_numpy(en),
                                torch.from_numpy(el))
        _assert_same_state(jstate, tstate, f"evict {step}")


def test_lane_spec_nodes_at_the_lane_split():
    """Nodes 0, 31, 32 and 55: the lo lane's sign bit, the first hi-lane
    reader and the last encodable node."""
    nodes = np.asarray([0, 31, 32, 55], np.int32)
    jhi, jlo = jco.bit_lanes(jnp.asarray(nodes))
    thi, tlo = tco.bit_lanes(torch.from_numpy(nodes))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(
        tco.writer_field_hi(torch.from_numpy(nodes)).numpy(),
        np.asarray(jco.writer_field_hi(jnp.asarray(nodes))))
    rng = np.random.default_rng(1)
    cs = rng.integers(0, 2, (56, 24)).astype(np.int8)    # S holders
    cs[:, ::3] = 0
    cs[nodes[np.arange(8) % 4], np.arange(0, 24, 3)] = 2  # one M each
    want = np.asarray(jco.directory_from_state(jnp.asarray(cs)))
    got = tco.directory_from_state(torch.from_numpy(cs)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tco.writer_of_hi(torch.from_numpy(got[:, 0])).numpy(),
        np.asarray(jco.writer_of_hi(jnp.asarray(want[:, 0]))))
    for n in (0, 57):
        with pytest.raises(ValueError, match="not encodable"):
            tr.make_state(n, 4, device="cpu")


@pytest.mark.parametrize("write_back", [False, True])
def test_run_rounds_matches(write_back):
    n_nodes, n_lines, width, r = 4, 16, 32, 24
    rng = np.random.default_rng(3)
    kw = dict(write_back=write_back, payload_width=width)
    jstate = jr.make_state(n_nodes, n_lines, **kw)
    tstate = tr.make_state(n_nodes, n_lines, device="cpu", **kw)
    for step in range(3):
        node, line, isw, wdata = _ops(rng, n_nodes, n_lines, r, width)
        jout = jr.run_rounds(jstate, node, line, isw, wdata,
                             n_nodes=n_nodes)
        tout = run_rounds(tstate, node, line, isw, wdata, n_nodes=n_nodes)
        jstate, tstate = jout[0], tout[0]
        _assert_same_state(jstate, tstate, f"batch {step}")
        for a, b in zip(jout[1:3], tout[1:3]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert tout[3] == int(jout[3]) and tout[4] == bool(jout[4])
        assert tout[4] and tout[3] > 1            # contention took spins
        for k in jout[5]:
            np.testing.assert_array_equal(tout[5][k].numpy(),
                                          np.asarray(jout[5][k]), k)
    # a bound too small to serve everything is reported, not hidden
    node, line, isw, wdata = _ops(rng, n_nodes, n_lines, r, width)
    jout = jr.run_rounds(jstate, node, line, isw, wdata, n_nodes=n_nodes,
                         max_rounds=1)
    tout = run_rounds(tstate, node, line, isw, wdata, n_nodes=n_nodes,
                      max_rounds=1)
    assert tout[3] == int(jout[3]) == 1
    assert tout[4] == bool(jout[4]) is False


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_rmw_append_splice_matches(dtype):
    """``run_rmw`` with the pool's token splice: duplicate-page rows
    carry group totals, -1 rows are padding; versions, bytes, rounds,
    all-served and telemetry are exact."""
    jcfg = jkv.KVPoolConfig(n_pages=12, page_size=4, n_kv_heads=2,
                            head_dim=4, n_replicas=3, dtype=dtype)
    tcfg = tkv.KVPoolConfig(n_pages=12, page_size=4, n_kv_heads=2,
                            head_dim=4, n_replicas=3, dtype=dtype)
    width = jkv.page_lanes(jcfg)
    assert tkv.page_lanes(tcfg) == width
    jstate = jr.make_state(3, 12, payload_width=width)
    tstate = tr.make_state(3, 12, payload_width=width, device="cpu")
    rng = np.random.default_rng(9)
    for step in range(4):
        b = 8
        pages = rng.integers(0, 6, b).astype(np.int32)
        pages[rng.random(b) < 0.2] = -1
        node = (pages % 3).astype(np.int32)    # one replica per page
        offs = rng.integers(0, 4, b).astype(np.int32)
        k_new = (rng.integers(-30, 31, (b, 2, 4)) / 32).astype(np.float32)
        v_new = (rng.integers(-30, 31, (b, 2, 4)) / 32).astype(np.float32)
        jout = jr.run_rmw(jstate, jnp.asarray(node), jnp.asarray(pages),
                          (jnp.asarray(offs), jnp.asarray(k_new),
                           jnp.asarray(v_new)),
                          modify=jkv._append_splice(jcfg), n_nodes=3)
        tout = run_rmw(tstate, node, pages,
                       tuple(torch.from_numpy(a) for a in
                             (offs, k_new, v_new)),
                       modify=tkv._append_splice(tcfg), n_nodes=3)
        jstate, tstate = jout[0], tout[0]
        _assert_same_state(jstate, tstate, f"append {step}")
        for a, b_ in zip(jout[1:3], tout[1:3]):
            np.testing.assert_array_equal(b_.numpy(), np.asarray(a))
        assert tout[3] == int(jout[3]) and tout[4] == bool(jout[4])
        for k in jout[5]:
            np.testing.assert_array_equal(tout[5][k].numpy(),
                                          np.asarray(jout[5][k]), k)


def test_plane_facade_matches():
    """DevicePlane.ops/rmw/evict return the reference's PlaneResult
    fields and telemetry, and leave the same state."""
    n_nodes, n_lines, width = 4, 16, 8
    rng = np.random.default_rng(21)
    jp = jr.DevicePlane.open(jr.make_state(n_nodes, n_lines,
                                           payload_width=width))
    tp = tr.DevicePlane.open(tr.make_state(n_nodes, n_lines,
                                           payload_width=width,
                                           device="cpu"))
    for step in range(3):
        node, line, isw, wdata = _ops(rng, n_nodes, n_lines, 10, width)
        jres = jp.ops(node, line, isw, wdata)
        tres = tp.ops(node, line, isw, wdata)
        np.testing.assert_array_equal(tres.version, jres.version)
        np.testing.assert_array_equal(tres.data, jres.data)
        assert tres.rounds == jres.rounds
        for k, v in jres.telemetry.items():
            np.testing.assert_array_equal(tres.telemetry[k], v, k)
        jp.evict(node[:3], line[:3])
        tp.evict(node[:3], line[:3])
        _assert_same_state(jp.state, tp.state, f"step {step}")
    tp.check()
    with pytest.raises(RuntimeError, match="not served"):
        tp.ops(np.asarray([0, 1], np.int32), np.asarray([2, 2], np.int32),
               np.asarray([1, 1], np.int32), max_rounds=1)
