"""The sharded plane's callers and the JAX 4-shard oracle.

* ``DeviceBTree`` and ``DeviceTxnEngine`` over the port's 4-shard plane
  against the same over its flat plane;
* the scenarios of ``tests/test_torch_sharded.py`` (ops, a
  ``bucket_cap`` overflow, rmw, descent, evict, rehome + replicate, 2PL
  and TO, the serve trace over a mesh-backed pool) on the port's
  ``Mesh(4)`` against the JAX package's 4-shard plane, exactly (the
  serve's attend within 1e-4), in two subprocesses that force four host
  devices, build a JAX ``Mesh`` with ``Auto`` axes and write their
  results to an ``.npz``;
* ``chip_smoke.py``'s ``sharded_phase`` rehearsed at small sizes.
"""

import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from test_torch_sharded import (ROOT, Pkg, assert_same,  # noqa: E402
                                run_scenarios)


from _torch_threads import _one_thread  # noqa: E402,F401


def test_tree_and_txn_engine_on_four_shards_match_flat():
    """``DeviceBTree`` (inserts with splits, lookups, a scan) and
    ``DeviceTxnEngine`` over a 4-shard plane answer as over the flat
    plane, and their final images are equal."""
    from repro_torch.apps import DeviceTxnConfig, DeviceTxnEngine
    from repro_torch.core import rounds as tr
    from repro_torch.index import DeviceBTree
    mesh = tr.Mesh(4, device="cpu")
    rng = np.random.default_rng(4)
    keys = rng.permutation(96).astype(np.int32)
    vals = rng.integers(1, 1 << 20, 96).astype(np.int32)
    trees = [DeviceBTree.create(4, 128, fanout=4, device="cpu"),
             DeviceBTree.create(4, 126, fanout=4, mesh=mesh)]
    for t in trees:
        for i in range(0, 96, 24):
            t.insert_batch(keys[i:i + 24], vals[i:i + 24], node=i % 4)
        t.check_invariants()
    assert trees[1].plane.n_shards == 4 and trees[1].height >= 3
    assert trees[0].items() == trees[1].items() == sorted(
        zip(keys.tolist(), vals.tolist()))
    probe = rng.integers(0, 120, 32).astype(np.int32)
    got = [t.lookup_batch(probe, node=2) for t in trees]
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)
    assert trees[0].scan_batch([5, 50], 7) == trees[1].scan_batch([5, 50], 7)
    np.testing.assert_array_equal(trees[0]._image(), trees[1]._image())
    opened = DeviceBTree.open(trees[1].state, mesh=mesh)
    assert opened.items() == trees[1].items()
    with pytest.raises(ValueError, match="flat-plane only"):
        DeviceBTree.create(4, 128, mesh=mesh, driver="host")

    w = tr.txn_payload_width(2)
    txns = [(list(rng.choice(24, 3)), list(rng.choice(24, 2)))
            for _ in range(13)]
    cfg = DeviceTxnConfig(algo="to", tuples_per_gcl=2, max_group_lines=3)
    engines = [DeviceTxnEngine(tr.DevicePlane.open(
        tr.make_state(4, 12, payload_width=w, device="cpu")), cfg),
        DeviceTxnEngine(tr.DevicePlane.open(
            tr.make_sharded_state(4, 12, mesh, payload_width=w), mesh), cfg)]
    res = [e.run_batch(1, txns, ts=np.arange(13)[::-1].copy())[0]
           for e in engines]
    for k in ("decision", "exec_step", "retries"):
        np.testing.assert_array_equal(getattr(res[0], k),
                                      getattr(res[1], k))
    assert res[0].iters == res[1].iters and res[0].rounds == res[1].rounds
    np.testing.assert_array_equal(engines[0].final_image(),
                                  engines[1].final_image())
    assert engines[0].stats.commits == engines[1].stats.commits


def _jax_four_shards(group: str, tmp_path) -> dict:
    path = tmp_path / f"jax4_{group}.npz"
    code = textwrap.dedent(f"""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        sys.path.insert(0, {str(ROOT / 'src')!r})
        sys.path.insert(0, {str(ROOT / 'tests')!r})
        import numpy as np
        import test_torch_sharded as T
        out = T.run_scenarios(T.Pkg("jax", 4), {group!r})
        np.savez({str(path)!r}, **out)
        print("JAX4_OK", len(out))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert "JAX4_OK" in proc.stdout, proc.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("group", ["1", "2"])
def test_four_shards_match_jax_four_shard_plane(group, tmp_path):
    """Group 1: ops (write-through and write-back, bare and payload),
    ``bucket_cap`` overflow, rmw, evict, rehome + replicate, descent.
    Group 2: 2PL and TO, and the serve trace over a mesh-backed pool.
    The port's 4 shards against the reference's 4-shard plane."""
    want = _jax_four_shards(group, tmp_path)
    got = run_scenarios(Pkg("torch", 4), group)
    assert_same(got, want)
    if group == "1":
        # the comparisons are not vacuous: overflow deferred, lines
        # moved, replicas served
        assert any(v.sum() > 0 for k, v in want.items()
                   if "overflow" in k and k.endswith("tele/deferred"))
        assert int(want["rehome_wb0/moved4"]) == 2
        assert (want["rehome_wb0/b13/state/home"] != np.arange(8)).any()
        assert any(v.sum() > 0 for k, v in want.items()
                   if "rehome" in k and k.endswith("tele/replica_served"))
        occ = want["ops_wb0_w0/b0/tele/occupancy"]
        assert occ.shape == (4, 4) and occ.sum() > 0


# ------------------------------------------------ chip_smoke's rehearsal

def test_chip_smoke_sharded_phase_on_cpu(monkeypatch):
    """``chip_smoke.py``'s ``sharded_phase`` at small sizes on the CPU:
    the mesh-backed serve hashes equal to the flat serve's, placement
    moves a line, serves replicas and defers under its cap, the tree
    answers the oracle, the transactions equal a flat twin, and the
    latch plane at 4 shards equals K1's plain version."""
    from repro_torch.dsm.kvpool import KVPoolConfig
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cpu = torch.device("cpu")
    cfg = KVPoolConfig(n_pages=256, n_kv_heads=2, head_dim=8)
    flat = cs.serve(cpu, cfg, n_q_heads=4)
    res = cs.sharded_phase(
        cpu, flat, kv_cfg=cfg, n_q_heads=4,
        place=dict(n_lines=64, width=8, batches=4, batch=32), place_cap=2,
        tree=dict(n_keys=3000, n_lines=512, slots=64, c_batches=2,
                  a_batches=1),
        txn=dict(n_gcls=256, batch=64, n_batches=1))
    srv = res["serve"]
    assert srv["shards"] == 4 and np.asarray(srv["occupancy"]).shape == (4, 4)
    assert sum(srv["served_per_home"]) > 0 and srv["deferred"] == 0
    for key in ("placement", "placement_capped"):
        assert res[key]["moved"] >= 1 and res[key]["home_moved"] >= 2
        assert sum(res[key]["replica_served"]) > 0
    assert res["placement"]["bucket_cap"] is None
    assert sum(map(sum, res["placement"]["deferred"])) == 0
    assert res["tree"]["ycsb_a"]["upserts_per_s"] > 0
    assert res["tree"]["upserted_keys_checked"] > 0
    assert set(res["txn"]) >= {"2pl", "to"}
    # the plain versions run on the CPU: no kernel launch to count
    assert res["launches"] == {"latch_ops": 0, "gcl_fetch": 0,
                               "paged_attention": 0}
    assert cs.sharded_latch_check(cpu, n=512, r=64)["max_abs_err"] == 0
