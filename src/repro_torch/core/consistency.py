"""Consistency checkers for SELCC histories (paper Sec. 7).

Two levels:

1. **Coherence** (per address): version sequences must be contiguous per
   write order, and every read must return a version that some write
   produced; per-thread, per-address observed versions must be monotone.
   (The protocol additionally asserts the strong invariant online: a valid
   S copy always equals the memory image — ``SELCCNode._assert_coherent``.)

2. **Sequential consistency** (cross-address): with the total write order
   per address known (versions), SC holds iff the union of
       program order ∪ reads-from ∪ write-serialization ∪ from-read
   is acyclic.  We build that graph over the recorded history and check
   for cycles — the classical polynomial SC test given a write order.

Histories are lists of ``(thread, op, gaddr, version, t)`` per node, as
recorded by ``SELCCNode`` with ``record_history=True``.
"""

from __future__ import annotations

from collections import defaultdict


class SCViolation(AssertionError):
    pass


def check_coherence(histories: dict) -> None:
    """histories: {node_id: [(thread, op, gaddr, version, t), ...]}"""
    writes = defaultdict(set)          # gaddr -> versions written
    per_thread_last = {}
    for node, hist in histories.items():
        for (thread, op, gaddr, ver, t) in hist:
            if op == "W":
                if ver in writes[gaddr]:
                    raise SCViolation(
                        f"duplicate write version {ver} at {gaddr} "
                        f"(lost-update / atomicity violation)")
                writes[gaddr].add(ver)
            key = (node, thread, gaddr)
            last = per_thread_last.get(key, 0)
            if ver < last:
                raise SCViolation(
                    f"node {node} thread {thread} saw {gaddr} go backwards: "
                    f"v{last} -> v{ver}")
            per_thread_last[key] = ver
    # write versions must be contiguous 1..k (serialized exclusive holders)
    for gaddr, vs in writes.items():
        k = len(vs)
        if vs != set(range(1, k + 1)):
            raise SCViolation(f"non-contiguous write versions at {gaddr}: "
                              f"{sorted(vs)[:10]}...")
    # reads must observe an existing version (or the initial 0)
    for node, hist in histories.items():
        for (thread, op, gaddr, ver, t) in hist:
            if op == "R" and ver != 0 and ver not in writes[gaddr]:
                raise SCViolation(
                    f"read of unwritten version v{ver} at {gaddr}")


def check_sequential_consistency(histories: dict) -> None:
    """Graph-based SC test.  Nodes: events. Edges:
    program order; W(x,v) -> W(x,v+1); W(x,v) -> R(x,v); R(x,v) -> W(x,v+1).
    SC (w.r.t. the observed write serialization) iff acyclic."""
    check_coherence(histories)
    events = []                         # (node, thread, op, gaddr, ver)
    eid = {}
    adj = defaultdict(list)

    def add_edge(a, b):
        if a != b:
            adj[a].append(b)

    prev_of_thread = {}
    writes_by_ver = {}
    reads_of = defaultdict(list)        # (gaddr, ver) -> [event ids]
    for node, hist in histories.items():
        for (thread, op, gaddr, ver, t) in hist:
            e = len(events)
            events.append((node, thread, op, gaddr, ver))
            key = (node, thread)
            if key in prev_of_thread:
                add_edge(prev_of_thread[key], e)      # program order
            prev_of_thread[key] = e
            if op == "W":
                writes_by_ver[(gaddr, ver)] = e
            else:
                reads_of[(gaddr, ver)].append(e)
    for (gaddr, ver), w in writes_by_ver.items():
        nxt = writes_by_ver.get((gaddr, ver + 1))
        if nxt is not None:
            add_edge(w, nxt)                          # write serialization
        for r in reads_of.get((gaddr, ver), ()):      # reads-from
            add_edge(w, r)
            if nxt is not None:
                add_edge(r, nxt)                      # from-read
    # reads of v must also precede w(v+1) even when v==0 (initial value)
    for (gaddr, ver), rs in reads_of.items():
        if ver == 0:
            w1 = writes_by_ver.get((gaddr, 1))
            if w1 is not None:
                for r in rs:
                    add_edge(r, w1)
    _assert_acyclic(adj, len(events), events)


def _assert_acyclic(adj, n, events) -> None:
    WHITE, GRAY, BLACK = 0, 1, 2
    color = [WHITE] * n
    for root in range(n):
        if color[root] != WHITE:
            continue
        stack = [(root, iter(adj.get(root, ())))]
        color[root] = GRAY
        while stack:
            v, it = stack[-1]
            advanced = False
            for u in it:
                if color[u] == GRAY:
                    raise SCViolation(
                        f"cycle through {events[u]} — history is not "
                        f"sequentially consistent")
                if color[u] == WHITE:
                    color[u] = GRAY
                    stack.append((u, iter(adj.get(u, ()))))
                    advanced = True
                    break
            if not advanced:
                color[v] = BLACK
                stack.pop()


def merge_histories(nodes) -> dict:
    return {n.node_id: list(n.history) for n in nodes}
