"""Fixed node codec: one B-link tree node per GCL payload line.

Counterpart of ``repro/index/codec.py``.  A tree node serializes into
the line's ``payload_width`` int32 lanes (``W = 2 * (fanout + 1) + 6``)::

    lane 0              leaf flag (1 = leaf, 0 = internal)
    lane 1              nkeys
    lane 2              right-link line (-1 = rightmost at this level)
    lane 3              has_high (1 = a high key is present)
    lane 4              high key (valid iff has_high) — Lehman-Yao: a
                        descent holding key >= high follows the right
                        link instead of trusting this node
    lanes 5 .. 5+C-1    keys, ascending (C = fanout + 1: one overflow
                        slot so an insert lands BEFORE the split)
    lanes 5+C .. 5+2C   vals — a leaf uses slots 0..nkeys-1 for
                        values, an internal node slots 0..nkeys for
                        child lines

``encode`` / ``decode`` are host numpy.  :func:`insert_modify` (the
RMW lane transform) and :func:`descend_step` (the descent transition)
are torch functions on ``[B, W]`` int32 tensors, built once per fanout,
that run on whatever device their inputs live on.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

LEAF, NKEYS, RIGHT, HAS_HIGH, HIGH = 0, 1, 2, 3, 4
KEYS_OFF = 5


@dataclass
class DecodedNode:
    """Host-side view of one node line (numpy decode)."""
    leaf: bool
    keys: list = field(default_factory=list)
    vals: list = field(default_factory=list)   # values or child lines
    right: int = -1
    high: int | None = None

    @property
    def nkeys(self) -> int:
        return len(self.keys)


@dataclass(frozen=True)
class NodeCodec:
    """Geometry of the node <-> lane mapping for one fanout."""
    fanout: int

    @property
    def cap(self) -> int:
        """Key slots per node: fanout + 1 (one overflow slot — a node
        holds at most ``fanout`` keys between batches; the extra slot
        absorbs the insert that triggers the split)."""
        return self.fanout + 1

    @property
    def vals_off(self) -> int:
        return KEYS_OFF + self.cap

    @property
    def width(self) -> int:
        """Payload lanes per line (``vals`` has cap + 1 slots: an
        internal node carries nkeys + 1 children)."""
        return self.vals_off + self.cap + 1

    # ------------------------------------------------------------ encode
    def encode(self, *, leaf: bool, keys=(), vals=(), right: int = -1,
               high: int | None = None) -> np.ndarray:
        keys = list(keys)
        vals = list(vals)
        if len(keys) > self.cap:
            raise ValueError(f"{len(keys)} keys exceed cap {self.cap}")
        want = len(keys) if leaf else (len(keys) + 1 if keys or vals
                                       else 0)
        if len(vals) != want:
            raise ValueError(
                f"{'leaf' if leaf else 'internal'} node with "
                f"{len(keys)} keys needs {want} vals, got {len(vals)}")
        lanes = np.zeros(self.width, np.int32)
        lanes[LEAF] = 1 if leaf else 0
        lanes[NKEYS] = len(keys)
        lanes[RIGHT] = right
        lanes[HAS_HIGH] = 0 if high is None else 1
        lanes[HIGH] = 0 if high is None else high
        lanes[KEYS_OFF:KEYS_OFF + len(keys)] = keys
        lanes[self.vals_off:self.vals_off + len(vals)] = vals
        return lanes

    # ------------------------------------------------------------ decode
    def decode(self, lanes) -> DecodedNode:
        lanes = np.asarray(lanes)
        nk = int(lanes[NKEYS])
        leaf = bool(lanes[LEAF])
        nv = nk if leaf else (nk + 1 if nk else 0)
        return DecodedNode(
            leaf=leaf,
            keys=[int(k) for k in lanes[KEYS_OFF:KEYS_OFF + nk]],
            vals=[int(v) for v in
                  lanes[self.vals_off:self.vals_off + nv]],
            right=int(lanes[RIGHT]),
            high=int(lanes[HIGH]) if lanes[HAS_HIGH] else None)

    # -------------------------------------------------- batch accessors
    def fields(self, data) -> dict:
        """Field view of a ``[B, W]`` batch of node lines: numpy arrays
        for a numpy input (the host-side decode), tensors for a tensor
        (what the descent transition reads, on its device)."""
        if not isinstance(data, torch.Tensor):
            data = np.asarray(data)
        return {
            "leaf": data[:, LEAF] == 1,
            "nkeys": data[:, NKEYS],
            "right": data[:, RIGHT],
            "has_high": data[:, HAS_HIGH] == 1,
            "high": data[:, HIGH],
            "keys": data[:, KEYS_OFF:KEYS_OFF + self.cap],
            "vals": data[:, self.vals_off:self.vals_off + self.cap + 1],
        }

    @property
    def insert_modify(self):
        """The RMW lane transform for this geometry (one function per
        fanout)."""
        return insert_modify(self.fanout)

    @property
    def descend_step(self):
        """The descent transition for this geometry (one function per
        fanout — the ``transition`` operand of ``run_descent``)."""
        return descend_step(self.fanout)


def _i32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def insert_modify(fanout: int):
    """Build ``modify(data, line, keys, vals)`` for ``run_rmw``: insert
    one (key, val) per slot into the slot's freshly-read node lanes,
    between the RMW's read and its write.

    Semantics mirror the host ``BLinkTree``: a leaf replaces the value
    when the key exists, else shifts and inserts at the sorted position
    (``count(keys < key)``); an internal node inserts the separator at
    ``count(keys <= sep)`` with the new child at ``pos + 1``.  A
    ``line = -1`` row is a no-op (its operands are padding garbage).
    Callers guarantee at most ONE slot per line per batch — duplicate
    (node, line) write slots would coalesce to the last slot's payload.
    """
    codec = NodeCodec(fanout)
    c, v0, vcap = codec.cap, codec.vals_off, codec.cap + 1

    def modify(data, line, keys, vals):
        data = _i32(data)          # the host baseline passes numpy
        dev = data.device
        line, keys, vals = (_i32(x, dev) for x in (line, keys, vals))
        valid = line >= 0
        leaf = data[:, LEAF] == 1
        nk = data[:, NKEYS]
        karr = data[:, KEYS_OFF:KEYS_OFF + c]          # [B, C]
        varr = data[:, v0:v0 + vcap]                   # [B, C+1]
        j = torch.arange(c, device=dev)
        jv = torch.arange(vcap, device=dev)
        occ = j[None, :] < nk[:, None]
        lt = occ & (karr < keys[:, None])
        le = occ & (karr <= keys[:, None])
        eq = occ & (karr == keys[:, None])
        exists = leaf & eq.any(dim=1)
        # leaf inserts at count(keys < key); internal separator inserts
        # at count(keys <= sep) — the host _child_index rule
        pos = torch.where(leaf, lt.sum(dim=1), le.sum(dim=1))
        # shifted key row: slots < pos keep, slot pos takes the key,
        # slots > pos pull from the left neighbour
        prev_k = torch.cat([karr[:, :1], karr[:, :-1]], dim=1)
        ins_k = torch.where(j[None, :] < pos[:, None], karr,
                            torch.where(j[None, :] == pos[:, None],
                                        keys[:, None], prev_k))
        # value row: a leaf's value rides at pos, an internal child at
        # pos + 1 (slots <= pos keep — the left child stays in place)
        vpos = torch.where(leaf, pos, pos + 1)
        prev_v = torch.cat([varr[:, :1], varr[:, :-1]], dim=1)
        ins_v = torch.where(jv[None, :] < vpos[:, None], varr,
                            torch.where(jv[None, :] == vpos[:, None],
                                        vals[:, None], prev_v))
        # existing leaf key: replace the value in place, no shift
        eq_v = torch.cat([eq, torch.zeros_like(eq[:, :1])], dim=1)
        rep_v = torch.where(eq_v, vals[:, None], varr)
        new_k = torch.where(exists[:, None], karr, ins_k)
        new_v = torch.where(exists[:, None], rep_v, ins_v)
        out = data.clone()
        out[:, NKEYS] = nk + (~exists).to(torch.int32)
        out[:, KEYS_OFF:KEYS_OFF + c] = new_k
        out[:, v0:v0 + vcap] = new_v
        return torch.where(valid[:, None], out, data)

    return modify


@functools.lru_cache(maxsize=None)
def descend_step(fanout: int):
    """Build ``transition(data, key) -> (at_leaf, hop, nxt)`` for
    :func:`repro_torch.core.rounds.run_descent`: the per-key B-link
    descent decision, computed from freshly-read node lanes.

    A key at or past the node's high key follows the right link
    (``hop`` — the Lehman-Yao recovery), a leaf without a pending hop
    terminates (``at_leaf``), and an internal node routes to child
    ``count(keys <= key)``.  ``nxt`` is the slot's next line (right
    link on a hop, child otherwise; garbage where ``at_leaf``)."""
    codec = NodeCodec(fanout)
    c = codec.cap

    def transition(data, key):
        data = _i32(data)
        key = _i32(key, data.device)
        f = codec.fields(data)
        hop = f["has_high"] & (key >= f["high"]) & (f["right"] >= 0)
        at_leaf = f["leaf"] & ~hop
        occ = torch.arange(c, device=data.device)[None, :] \
            < f["nkeys"][:, None]
        ci = (occ & (f["keys"] <= key[:, None])).sum(dim=1)
        child = torch.gather(f["vals"], 1, ci[:, None])[:, 0]
        nxt = torch.where(hop, f["right"], child)
        return at_leaf, hop, nxt

    return transition
