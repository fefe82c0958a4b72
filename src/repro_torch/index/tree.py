"""DeviceBTree — a concurrent B-link tree served from the flat rounds plane.

Counterpart of ``repro/index/tree.py`` (the paper's Sec. 8.1, Fig. 10
application), over the flat plane or the sharded one (``mesh=``: the
tree's lines home on the mesh's shards, and every plane verb below
routes through them).  Every tree node is one GCL line of a
payload-plane round state, and every structural rule of
the host ``BLinkTree`` maps onto a coherence-plane op sequence:

* **descent** — the whole batched root-to-leaf walk is one
  ``DevicePlane.descent`` (:func:`repro_torch.core.rounds.run_descent`):
  each step issues the S-latch reads of every undone key's current line,
  decodes the node lanes on the device (``codec.descend_step`` — child
  index, right-link hop when ``key >= high`` per Lehman-Yao, at-leaf)
  and advances each key; the insert path's split bookkeeping rides the
  path buffer the same call returns;
* **leaf insert** — a coherent read-modify-write (``DevicePlane.rmw``):
  S-grant read, the sorted insert into the node lanes on the device
  (``codec.insert_modify``), S->X upgrade write;
* **split** — allocate-publish-link: the sibling line is allocated
  (``dsm.LineAllocator``) and PUBLISHED with its full image before the
  overfull node is re-written to link to it, so a concurrent reader
  that lands on the old node sees either the pre-split image or a high
  key routing it right;
* **metadata** — line 0 holds the tree's root/height/fanout/allocator
  top, updated through ordinary coherent writes, so
  :meth:`DeviceBTree.open` can adopt an existing plane.

Two baseline drivers are kept as differential references:

* ``driver="level"`` — one ``ops`` dispatch per level (plus one per
  link hop), the next line computed on the host between dispatches;
  inserts still use the RMW verb;
* ``driver="host"`` — every op batch replayed through a per-round loop
  over ``coherence_round`` with a sync after each round, and the insert
  as a two-phase read/modify/write.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rounds
from ..core.rounds.engine import coherence_round
from ..dsm.address import LineAllocator
from .codec import DecodedNode, NodeCodec

META_LINE = 0
META_MAGIC = 0x0B713EE   # "B(link)tree" plane marker
M_MAGIC, M_ROOT, M_FANOUT, M_HEIGHT, M_TOP = 0, 1, 2, 3, 4
_MAX_LINK_HOPS = 64      # safety bound on level loops and link walks


class DeviceBTree:
    """One B-link tree bound to a rounds payload plane, flat or sharded.

    All public entry points are BATCHED and keyed by the coherence
    ``node`` performing them (default 0) — concurrent clients are
    distinct nodes whose latch traffic contends through the engine."""

    def __init__(self, state, codec: NodeCodec, alloc: LineAllocator, *,
                 mesh=None, axis: str = "shards", n_nodes: int,
                 max_rounds: int = 128, driver: str = "fused"):
        if driver not in ("fused", "level", "host"):
            raise ValueError(f"unknown driver {driver!r}")
        if driver == "host" and mesh is not None:
            raise ValueError("the host-synced baseline driver is "
                             "flat-plane only")
        self.plane = rounds.DevicePlane.open(state, mesh, axis=axis,
                                             n_nodes=n_nodes,
                                             max_rounds=max_rounds)
        self.codec = codec
        self.alloc = alloc
        self.mesh = mesh
        self.axis = axis
        self.n_nodes = n_nodes
        self.max_rounds = max_rounds
        self.driver = driver
        self.root = -1
        self.height = 0
        self.stats = {"splits": 0, "link_hops": 0, "level_steps": 0,
                      "rmw_steps": 0, "descent_served": 0,
                      "descent_deferred": 0}

    @property
    def state(self):
        return self.plane.state

    @state.setter
    def state(self, value):
        self.plane.state = value

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create(cls, n_nodes: int = 4, n_lines: int = 256, *,
               fanout: int = 8, write_back: bool = False, mesh=None,
               axis: str = "shards", max_rounds: int = 128,
               driver: str = "fused", node: int = 0,
               device=None) -> "DeviceBTree":
        """Fresh tree on a fresh plane on ``device`` (``cuda`` unless
        ``"cpu"`` is asked for), or sharded over ``mesh`` on its device:
        builds the payload-plane state, reserves line 0 for metadata, and
        publishes an empty root leaf."""
        codec = NodeCodec(fanout)
        if mesh is None:
            state = rounds.make_state(n_nodes, n_lines,
                                      write_back=write_back,
                                      payload_width=codec.width,
                                      device=device)
        else:
            state = rounds.make_sharded_state(n_nodes, n_lines, mesh, axis,
                                              write_back=write_back,
                                              payload_width=codec.width)
        n_lines = rounds.lines_of(state, mesh, axis)   # sharded: rounded up
        alloc = LineAllocator(n_lines, start=META_LINE + 1)
        tree = cls(state, codec, alloc, mesh=mesh, axis=axis,
                   n_nodes=n_nodes, max_rounds=max_rounds, driver=driver)
        tree.root = int(alloc.alloc(1)[0])
        tree.height = 1
        tree._write_lines([tree.root], [codec.encode(leaf=True)], node)
        tree._write_meta(node)
        return tree

    @classmethod
    def open(cls, state, *, mesh=None, axis: str = "shards",
             n_nodes: int | None = None, max_rounds: int = 128,
             driver: str = "fused", node: int = 0) -> "DeviceBTree":
        """Adopt an existing plane: reads the metadata line through a
        real coherence op and reconstructs codec + allocator from it —
        the state is the whole tree, no side channel."""
        if n_nodes is None:
            n_nodes = state["cache_state"].shape[0]
        width = rounds.payload_width(state)
        if not width:
            raise ValueError("state has no payload plane "
                             "(payload_width=0) — not a tree plane")
        tree = cls(state, NodeCodec(1), LineAllocator(1), mesh=mesh,
                   axis=axis, n_nodes=n_nodes, max_rounds=max_rounds,
                   driver=driver)
        _, meta = tree._ops(np.full(1, node, np.int32),
                            np.full(1, META_LINE, np.int32),
                            np.zeros(1, np.int32))
        meta = meta[0]
        if int(meta[M_MAGIC]) != META_MAGIC:
            raise ValueError("line 0 carries no DeviceBTree metadata "
                             f"(magic {int(meta[M_MAGIC]):#x})")
        codec = NodeCodec(int(meta[M_FANOUT]))
        if codec.width != width:
            raise ValueError(
                f"metadata fanout {codec.fanout} needs payload width "
                f"{codec.width}, state has {width}")
        tree.codec = codec
        tree.root = int(meta[M_ROOT])
        tree.height = int(meta[M_HEIGHT])
        tree.alloc = LineAllocator(tree.plane.n_lines,
                                   start=META_LINE + 1,
                                   top=int(meta[M_TOP]))
        return tree

    # --------------------------------------------------------- plane I/O
    def _ops(self, node, line, isw, wdata=None):
        """One op batch through the plane; returns (versions, data)."""
        if wdata is None:
            wdata = np.zeros((len(line), self.plane.payload_width),
                             np.int32)
        if self.driver == "host":
            return self._ops_host(node, line, isw, wdata)
        res = self.plane.ops(node, line, isw, wdata)
        return res.version, res.data

    def _ops_host(self, node, line, isw, wdata):
        """The host-synced baseline: re-dispatch ``coherence_round``
        from a host loop with a sync after EVERY round."""
        dev = self.plane.device
        node, pending, isw, wdata = (
            torch.as_tensor(np.asarray(x, np.int32)).to(dev)
            for x in (node, line, isw, wdata))
        versions = torch.zeros_like(pending)
        data = torch.zeros_like(wdata)
        for _ in range(self.max_rounds):
            if not bool((pending >= 0).any()):     # the per-round sync
                break
            self.state, served, ver, d = coherence_round(
                self.state, node, pending, isw, wdata,
                n_nodes=self.n_nodes)
            versions = torch.where(served, ver, versions)
            data = torch.where(served[:, None], d, data)
            pending = torch.where(served, -1, pending)
        if bool((pending >= 0).any()):
            raise RuntimeError(
                f"ops not served after {self.max_rounds} rounds")
        return versions.cpu().numpy(), data.cpu().numpy()

    def _rmw_insert(self, node, line, keys, vals):
        """Coherent read-modify-write of one (key, val) per slot (unique
        lines per batch); returns the written node bytes.  Slots are
        padded to the next power of two, as in the reference, so the
        per-leaf sub-batches of ``insert_batch`` take a bounded set of
        shapes."""
        n = len(line)
        cap = 1 << max(n - 1, 0).bit_length()
        if cap != n:
            pad = cap - n
            node = np.concatenate([node, np.zeros(pad, np.int32)])
            line = np.concatenate([line, np.full(pad, -1, np.int32)])
            keys = np.concatenate([keys, np.zeros(pad, np.int32)])
            vals = np.concatenate([vals, np.zeros(pad, np.int32)])
        self.stats["rmw_steps"] += 1
        if self.driver == "host":
            # two-phase baseline: host-synced read, host-dispatched
            # modify, host-synced write
            _, cur = self._ops_host(
                node, line, np.zeros_like(line),
                np.zeros((len(line), self.codec.width), np.int32))
            new = self.codec.insert_modify(cur, line, keys, vals).numpy()
            self._ops_host(node, line, np.ones_like(line), new)
            return new
        res = self.plane.rmw(
            node, line, modify=self.codec.insert_modify,
            operands=(np.asarray(keys, np.int32),
                      np.asarray(vals, np.int32)))
        return res.data

    def _write_lines(self, lines, lane_rows, node: int):
        """Coherent write ops publishing full node images (fresh lines
        and re-links); one batch, heterogeneous lines."""
        lines = np.asarray(lines, np.int32)
        self._ops(np.full(lines.shape, node, np.int32), lines,
                  np.ones(lines.shape, np.int32),
                  np.asarray(lane_rows, np.int32))

    def _write_meta(self, node: int) -> None:
        lanes = np.zeros(self.codec.width, np.int32)
        lanes[M_MAGIC] = META_MAGIC
        lanes[M_ROOT] = self.root
        lanes[M_FANOUT] = self.codec.fanout
        lanes[M_HEIGHT] = self.height
        lanes[M_TOP] = self.alloc.top
        self._write_lines([META_LINE], [lanes], node)

    def _read_lines(self, lines, node: int):
        lines = np.asarray(lines, np.int32)
        _, data = self._ops(np.full(lines.shape, node, np.int32), lines,
                            np.zeros(lines.shape, np.int32))
        return data

    # ------------------------------------------------------------ descent
    def _descend(self, keys, node: int, record_path: bool = False):
        """Batched root-to-leaf walk.  Returns (leaf_lines [B],
        leaf_lanes [B, W], paths) — padded to the next power of two
        (callers slice), as in the reference.

        ``driver="fused"`` runs the whole walk as one
        ``DevicePlane.descent``, paths recorded by its device buffer;
        ``"level"`` / ``"host"`` keep the per-level host loop
        (:meth:`_descend_level`) as differential baselines."""
        keys = np.asarray(keys, np.int32)
        b = keys.shape[0]
        cap = 1 << max(b - 1, 0).bit_length()
        if cap != b:
            keys = np.concatenate([keys, np.zeros(cap - b, np.int32)])
        if self.driver != "fused":
            return self._descend_level(keys, b, node, record_path)
        root = np.full(cap, self.root, np.int32)
        root[b:] = -1                        # pads never present an op
        res = self.plane.descent(
            np.full(cap, node, np.int32), keys, root,
            transition=self.codec.descend_step,
            path_cap=_MAX_LINK_HOPS)
        cur, lanes = res.stats["line"], res.data
        levels, hops = res.stats["levels"], res.stats["hops"]
        paths, plen = res.stats["paths"], res.stats["path_len"]
        # per-key level/hop counts keep the per-level driver's meaning:
        # steps a level-synced walk would have dispatched (deepest live
        # key), and total hops
        live_l, live_h = levels[:b], hops[:b]
        self.stats["level_steps"] += \
            int((live_l + live_h).max(initial=-1) + 1)
        self.stats["link_hops"] += int(live_h.sum())
        self.stats["descent_served"] += res.telemetry.served
        self.stats["descent_deferred"] += res.telemetry.deferred_total
        if not record_path:
            return cur, lanes, []
        path_lists = [[int(x) for x in paths[i, :int(plen[i])]]
                      for i in range(b)]
        path_lists += [[] for _ in range(cap - b)]
        return cur, lanes, path_lists

    def _descend_level(self, keys, b: int, node: int,
                       record_path: bool):
        """The baseline walk: one op dispatch per level (the ``ops``
        verb under ``driver="level"``, host-synced per round under
        ``"host"``), transitions computed on the host in between."""
        cap = keys.shape[0]
        cur = np.full(cap, self.root, np.int32)
        done = np.zeros(cap, bool)
        done[b:] = True                      # pads never present an op
        b = cap
        lanes = np.zeros((b, self.codec.width), np.int32)
        paths: list = [[] for _ in range(b)] if record_path else []
        for _ in range(self.height + _MAX_LINK_HOPS):
            if done.all():
                break
            self.stats["level_steps"] += 1
            d = self._read_lines(np.where(done, -1, cur), node)
            f = self.codec.fields(d)
            hop = (~done & f["has_high"] & (keys >= f["high"])
                   & (f["right"] >= 0))
            at_leaf = ~done & ~hop & f["leaf"]
            desc = ~done & ~hop & ~f["leaf"]
            self.stats["link_hops"] += int(hop.sum())
            # child index: count of keys <= key over the live slots
            occ = np.arange(self.codec.cap)[None, :] < f["nkeys"][:, None]
            ci = np.sum(occ & (f["keys"] <= keys[:, None]), axis=1)
            child = f["vals"][np.arange(b), ci]
            if record_path:
                for i in np.flatnonzero(desc):
                    paths[i].append(int(cur[i]))
            lanes = np.where(at_leaf[:, None], d, lanes)
            nxt = np.where(hop, f["right"], np.where(desc, child, cur))
            done = done | at_leaf
            cur = np.where(done, cur, nxt).astype(np.int32)
        if not done.all():
            raise RuntimeError("descent did not settle (broken links?)")
        return cur, lanes, paths

    # ------------------------------------------------------------- lookup
    def lookup_batch(self, keys, node: int = 0):
        """Batched point lookup.  Returns (values [B] int32, found [B]
        bool) — a missing key reports found=False."""
        keys = np.asarray(keys, np.int32)
        b = keys.shape[0]
        _, lanes, _ = self._descend(keys, node)
        f = self.codec.fields(lanes[:b])
        occ = np.arange(self.codec.cap)[None, :] < f["nkeys"][:, None]
        eq = occ & (f["keys"] == keys[:, None])
        found = eq.any(axis=1)
        slot = np.argmax(eq, axis=1)
        vals = f["vals"][np.arange(b), slot]
        return np.where(found, vals, 0).astype(np.int32), found

    # ------------------------------------------------------------- insert
    def insert_batch(self, keys, vals, node: int = 0) -> None:
        """Batched upsert: descend every key, then drive RMW steps with
        at most one key per leaf per step (the engine's write coalescing
        serializes duplicate (node, line) slots to the LAST payload —
        distinct lines keep every insert exact), and split oversized
        nodes between steps."""
        keys = np.asarray(keys, np.int32)
        vals = np.asarray(vals, np.int32)
        b = keys.shape[0]
        target, _, paths = self._descend(keys, node, record_path=True)
        target = target[:b].copy()
        paths = paths[:b]
        pending = np.ones(b, bool)
        while pending.any():
            sel, seen = [], set()
            for i in np.flatnonzero(pending):
                if int(target[i]) not in seen:
                    seen.add(int(target[i]))
                    sel.append(i)
            sel = np.asarray(sel)
            written = self._rmw_insert(
                np.full(sel.shape, node, np.int32), target[sel],
                keys[sel], vals[sel])
            pending[sel] = False
            for j, i in enumerate(sel):
                nd = self.codec.decode(written[j])
                if nd.nkeys > self.codec.fanout:
                    self._split(int(target[i]), nd, list(paths[i]),
                                node, target, keys, pending)

    def _split(self, line: int, nd: DecodedNode, path: list, node: int,
               target=None, keys=None, pending=None) -> None:
        """Allocate-publish-link split of an overfull node, recursing
        into the parent.  Retargets still-pending same-batch inserts
        that now belong to the new sibling."""
        mid = nd.nkeys // 2
        sep = nd.keys[mid]
        if nd.leaf:
            sib = DecodedNode(leaf=True, keys=nd.keys[mid:],
                              vals=nd.vals[mid:], right=nd.right,
                              high=nd.high)
            left_keys, left_vals = nd.keys[:mid], nd.vals[:mid]
        else:
            sib = DecodedNode(leaf=False, keys=nd.keys[mid + 1:],
                              vals=nd.vals[mid + 1:], right=nd.right,
                              high=nd.high)
            left_keys, left_vals = nd.keys[:mid], nd.vals[:mid + 1]
        sib_line = int(self.alloc.alloc(1)[0])
        # publish the fully-built sibling BEFORE the old node links to
        # it (Lehman-Yao: readers see pre-split image or a high key)
        self._write_lines(
            [sib_line],
            [self.codec.encode(leaf=sib.leaf, keys=sib.keys,
                               vals=sib.vals, right=sib.right,
                               high=sib.high)], node)
        self._write_lines(
            [line],
            [self.codec.encode(leaf=nd.leaf, keys=left_keys,
                               vals=left_vals, right=sib_line,
                               high=sep)], node)
        self.stats["splits"] += 1
        if pending is not None:
            move = pending & (target == line) & (keys >= sep)
            target[move] = sib_line
        if line == self.root:
            new_root = int(self.alloc.alloc(1)[0])
            self._write_lines(
                [new_root],
                [self.codec.encode(leaf=False, keys=[sep],
                                   vals=[line, sib_line])], node)
            self.root = new_root
            self.height += 1
        else:
            self._insert_parent(path, line, sep, sib_line, node,
                                target, keys, pending)
        self._write_meta(node)

    def _insert_parent(self, path: list, child: int, sep: int,
                       sib_line: int, node: int, target, keys,
                       pending) -> None:
        parent = path[-1] if path else self._find_parent(child, sep,
                                                         node)
        above = path[:-1]
        # the recorded parent may itself have split since the descent:
        # walk its right links until sep is in range (Lehman-Yao)
        for _ in range(_MAX_LINK_HOPS):
            nd = self.codec.decode(self._read_lines([parent], node)[0])
            if nd.high is not None and sep >= nd.high and nd.right >= 0:
                parent = int(nd.right)
                self.stats["link_hops"] += 1
                continue
            break
        else:
            raise RuntimeError("parent link walk did not settle")
        written = self._rmw_insert(np.full(1, node, np.int32),
                                   np.asarray([parent], np.int32),
                                   np.asarray([sep], np.int32),
                                   np.asarray([sib_line], np.int32))
        nd = self.codec.decode(written[0])
        if nd.nkeys > self.codec.fanout:
            self._split(parent, nd, above, node, target, keys, pending)

    def _find_parent(self, child: int, sep: int, node: int) -> int:
        """Descend from the CURRENT root to the node whose children
        contain ``child`` — the fallback when a split's recorded path
        predates a root change within the same batch."""
        cur = self.root
        for _ in range(self.height + _MAX_LINK_HOPS):
            nd = self.codec.decode(self._read_lines([cur], node)[0])
            if nd.high is not None and sep >= nd.high and nd.right >= 0:
                cur = int(nd.right)
                continue
            if nd.leaf:
                break
            if child in nd.vals:
                return cur
            cur = int(nd.vals[sum(k <= sep for k in nd.keys)])
        raise RuntimeError(f"no parent found for line {child}")

    # --------------------------------------------------------------- scan
    def range_scan(self, key: int, count: int, node: int = 0):
        """``count`` (key, value) pairs from ``key`` upward, following
        the leaf right-link chain — the single-key form of
        :meth:`scan_batch`."""
        return self.scan_batch([key], count, node=node)[0]

    def scan_batch(self, keys, count: int, node: int = 0):
        """Batched range scan (YCSB E): for each start key, up to
        ``count`` (key, value) pairs from that key upward.  One descent
        finds ALL start leaves; the leaf-chain walk then reads every
        still-collecting scan's next right link in one coherent batch
        per chain step.  Returns a list of per-key pair lists."""
        keys = np.asarray(keys, np.int32)
        b = keys.shape[0]
        _, lanes, _ = self._descend(keys, node)
        lanes = np.asarray(lanes[:b], np.int32)
        out: list = [[] for _ in range(b)]
        collecting = np.ones(b, bool)
        for _ in range(_MAX_LINK_HOPS + count):
            f = self.codec.fields(lanes)
            for i in np.flatnonzero(collecting):
                nk = int(f["nkeys"][i])
                for k, v in zip(f["keys"][i][:nk], f["vals"][i][:nk]):
                    if k >= keys[i] and len(out[i]) < count:
                        out[i].append((int(k), int(v)))
                if len(out[i]) >= count or f["right"][i] < 0:
                    collecting[i] = False
            if not collecting.any():
                break
            nxt = np.where(collecting, f["right"], -1).astype(np.int32)
            step = self._read_lines(nxt, node)
            lanes = np.where(collecting[:, None], step, lanes)
        else:
            raise RuntimeError("leaf chain walk did not settle")
        return out

    # ---------------------------------------------------------- integrity
    def _image(self, state=None) -> np.ndarray:
        """Protocol-fresh per-line bytes from the state: memory image,
        with dirty M holders' cache_data substituted (the flush source
        of truth under write-back).  ``state`` accepts an already
        unsharded state, so one copy serves this and the invariant
        checks."""
        if state is None:
            state = self.plane.flat_state()
        img = state["mem_data"].cpu().numpy().copy()
        if "dirty" in state:
            dirty = state["dirty"].cpu().numpy()            # [N, L]
            nodes, lines = np.nonzero(dirty)
            img[lines] = state["cache_data"].cpu().numpy()[nodes, lines]
        return img

    def items(self) -> list:
        """All (key, value) pairs via the leaf chain of the current
        image — the tree's key->value image for differential tests."""
        img = self._image()
        cur, nd = self.root, None
        for _ in range(self.height + _MAX_LINK_HOPS):
            nd = self.codec.decode(img[cur])
            if nd.leaf:
                break
            cur = int(nd.vals[0])
        out: list = []
        for _ in range(self.alloc.top + 1):
            out.extend(zip(nd.keys, nd.vals))
            if nd.right < 0:
                return out
            cur = nd.right
            nd = self.codec.decode(img[cur])
        raise AssertionError("leaf chain does not terminate")

    def check_invariants(self) -> None:
        """Coherence invariants (incl. data/version agreement) on the
        plane PLUS the B-link structural invariants on the image."""
        state = self.plane.flat_state()
        rounds.check_invariants(state)
        img = self._image(state)
        meta = img[META_LINE]
        assert int(meta[M_MAGIC]) == META_MAGIC
        assert int(meta[M_ROOT]) == self.root
        assert int(meta[M_TOP]) == self.alloc.top
        # level-by-level walk: every node sorted, within capacity,
        # bounded by its high key; levels chain left->right; all leaves
        # at one depth; the leaf chain is globally sorted
        level_head, depth, seen = self.root, 0, set()
        while True:
            depth += 1
            assert depth <= self.height, "deeper than recorded height"
            cur = level_head
            is_leaf = None
            prev_high = None
            for _ in range(self.alloc.top + 1):
                assert META_LINE < cur < self.alloc.top, \
                    f"line {cur} outside the allocated range"
                assert cur not in seen, f"line {cur} reached twice"
                seen.add(cur)
                nd = self.codec.decode(img[cur])
                if is_leaf is None:
                    is_leaf = nd.leaf
                assert nd.leaf == is_leaf, "mixed level"
                assert nd.nkeys <= self.codec.fanout, \
                    "overfull node between batches"
                ks = np.asarray(nd.keys)
                assert (np.diff(ks) > 0).all(), "unsorted node keys"
                if not nd.leaf:
                    assert len(nd.vals) == nd.nkeys + 1
                    assert nd.nkeys >= 1, "empty internal node"
                if nd.high is not None:
                    assert nd.right >= 0, "high key without right link"
                    assert (ks < nd.high).all(), "key >= high"
                if prev_high is not None and nd.nkeys:
                    assert ks[0] >= prev_high, \
                        "right sibling underruns the separator"
                prev_high = nd.high
                if nd.right < 0:
                    assert nd.high is None, "rightmost node with high"
                    break
                cur = int(nd.right)
            else:
                raise AssertionError("level chain does not terminate")
            if is_leaf:
                break
            level_head = int(self.codec.decode(img[level_head]).vals[0])
        assert depth == self.height, "height metadata diverged"
        keys = [k for k, _ in self.items()]
        assert (np.diff(np.asarray(keys)) > 0).all() if len(keys) > 1 \
            else True, "leaf chain not globally sorted"
