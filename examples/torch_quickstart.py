"""Quickstart on the PyTorch port: the SELCC v2 abstraction layer of
``examples/quickstart.py``, over ``repro_torch``.

Typed GAddrs, scope-guarded latches with a real data plane
(``h.value`` / ``h.store``), lazy release + invalidation in action, the
pluggable backend registry, and a B-link tree over the same API
(paper Table 1 + Sec. 8.1), printing what the reference example prints.
The cluster is the host DES; at the end the same cluster opens a device
plane on ``--device`` (``cuda`` unless ``--device cpu`` is given), where
node 0 writes the GCL's line and node 1 reads it at that version.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.apps import BLinkTree  # noqa: E402
from repro_torch.core import (ClusterConfig, SELCCConfig,  # noqa: E402
                              SELCCLayer, available_protocols)


def run(device=None, say=print, greeting="hello, disaggregated world"):
    """The reference example's flow, its lines through ``say``; returns
    what it saw: the stored and read payloads, the RDMA ops of the
    cache-hit re-read, the tree's lookup and scan, the cache counters,
    the rpc tree's lookup, and the device plane's read of the stored
    line (``plane_versions``: the write's and the read's)."""
    dev = resolve_device(device)
    seen = {}
    say(f"registered protocol backends: {available_protocols()}")
    layer = SELCCLayer(ClusterConfig(n_compute=2, n_memory=2,
                                     threads_per_node=4,
                                     selcc=SELCCConfig(cache_capacity=256)))
    node0, node1 = layer.nodes
    gaddr = layer.allocate()
    say(f"allocated GCL at gaddr={gaddr!r} "
        f"(typed; packs to 0x{gaddr.pack():x})")

    def demo():
        # node 0 writes a real payload under an exclusive scope guard
        h = yield from node0.xlocked(gaddr)
        yield from h.store({"greeting": greeting})
        yield from h.release()
        seen["stored"], seen["version"] = layer.heap.load(gaddr), h.version
        say(f"  node0 stored {layer.heap.load(gaddr)} at v{h.version}; "
            f"latch is released LAZILY (still held globally)")
        # node 1 reads: its acquisition invalidates node 0's copy
        h1 = yield from node1.slocked(gaddr)
        seen["read"] = h1.value
        say(f"  node1 read  {h1.value!r} at v{h1.version} (coherent)")
        yield from h1.release()
        # node 1 reads again: pure LOCAL cache hit — zero RDMA
        before = layer.fabric.stats.total_rdma()
        h1 = yield from node1.slocked(gaddr)
        yield from h1.release()
        after = layer.fabric.stats.total_rdma()
        seen["rdma"] = after - before
        say(f"  node1 re-read: cache hit, RDMA ops used = "
            f"{after - before}")
        # global timestamps via the Atomic API
        ts1 = yield from node0.atomic_faa(layer.allocate(), 1)
        say(f"  Atomic FAA timestamp = {ts1}")

    p = layer.env.process(demo())
    layer.env.run_until_complete([p])

    # ---- a real data structure over the same five calls ------------------
    tree = BLinkTree(layer, node0, fanout=16)

    def tree_demo():
        for i in range(200):
            yield from tree.insert(i, i * i)
        v = yield from tree.lookup(137)
        rng = yield from tree.range_scan(50, 5)
        seen["lookup"], seen["scan"] = v, rng
        say(f"  btree over SELCC: lookup(137)={v}, scan(50,5)={rng}")

    p = layer.env.process(tree_demo())
    layer.env.run_until_complete([p])
    layer.assert_released()           # every scope guard closed
    cs = layer.cache_stats()
    seen["cache"] = cs
    say(f"cache: hits={cs['hits']} misses={cs['misses']} "
        f"hit_rate={cs['hits'] / (cs['hits'] + cs['misses']):.1%}")

    # ---- same app, different backend: resolved via the registry ----------
    rpc_layer = SELCCLayer(ClusterConfig(n_compute=2, n_memory=2,
                                         threads_per_node=4,
                                         protocol="rpc"))
    rpc_tree = BLinkTree(rpc_layer, rpc_layer.nodes[0], fanout=16)

    def rpc_demo():
        for i in range(50):
            yield from rpc_tree.insert(i, -i)
        v = yield from rpc_tree.lookup(42)
        seen["rpc_lookup"] = v
        say(f"  SAME btree code over the 'rpc' strawman: lookup(42)={v}")

    p = rpc_layer.env.process(rpc_demo())
    rpc_layer.env.run_until_complete([p])
    rpc_layer.assert_released()

    # ---- the same cluster sized as a device plane: node 0 writes the
    # GCL's line, node 1 reads it at the written version -----------------
    plane = layer.as_plane(device=dev)
    line = [gaddr.pack() % plane.n_lines]
    wrote = plane.ops([0], line, [1])
    read = plane.ops([1], line, [0])
    seen["plane_versions"] = (int(wrote.version[0]), int(read.version[0]))
    seen["plane"], seen["layer"] = plane, layer
    return seen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
