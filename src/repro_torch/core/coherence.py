"""The Fig. 3 latch word, in its host form and its device form.

Counterpart of ``repro/core/coherence.py``: an 8-bit exclusive-holder
byte and a 56-bit reader bitmap in one 64-bit word.

* Host form (the DES and the checkers): the word as one Python int,
  with the MSI peer-event table the DES handlers look transitions up
  in.  These are plain-int functions, copies of the reference's.
* Device form (the rounds engine and the pool): the word split into a
  hi lane (writer byte in bits 31..24, readers 32..55 in bits 23..0) and
  a lo lane (readers 0..31), as int32 tensors.  Lane arithmetic is done
  in int64 and wrapped back to int32 explicitly, so a reader bit 31 or
  a lane sum that reaches 2**31 lands on the same two's-complement bits
  the reference produces.
"""

from __future__ import annotations

import torch

MAX_NODES = 56                     # the paper's compute-node limit
WRITER_SHIFT = 56                  # writer byte: bits 63..56 of the word
READER_MASK = (1 << WRITER_SHIFT) - 1
WORD_MASK = (1 << 64) - 1
FREE = 0                           # latch off: no writer, no readers
LANE_READERS = 32                  # readers 0..31 live in lo
HI_READER_BITS = MAX_NODES - LANE_READERS      # readers 32..55: hi 0..23
WRITER_SHIFT_HI = 24               # writer byte: hi-lane bits 31..24

I, S, M = 0, 1, 2                  # MSI cache states (int8 on device)
STATE_NAMES = ("I", "S", "M")

EV_PEER_RD, EV_PEER_WR, EV_PEER_UPGR = 0, 1, 2
PEER_EVENTS = {"PeerRd": EV_PEER_RD, "PeerWr": EV_PEER_WR,
               "PeerUpgr": EV_PEER_UPGR}

# MSI_ON_PEER[state][event] -> next state for a HOLDER receiving a peer's
# invalidation: readers keep S on PeerRd, a writer downgrades on PeerRd
# (M -> S, after write-back) and releases on PeerWr/PeerUpgr; shared
# copies release on any writer intent.  Row I is the identity.
MSI_ON_PEER = (
    #  PeerRd  PeerWr  PeerUpgr
    (I, I, I),          # from I
    (S, I, I),          # from S
    (S, I, I),          # from M (PeerRd = downgrade, with write-back)
)


def on_peer(state: int, event: int) -> int:
    """Next MSI state for a holder in ``state`` hit by peer ``event``."""
    return MSI_ON_PEER[state][event]


def check_node_capacity(n_nodes: int) -> None:
    """Reject node counts the 64-bit word cannot encode (raised at the
    entry points: lane math cannot raise per element)."""
    if not 0 < n_nodes <= MAX_NODES:
        raise ValueError(
            f"n_nodes={n_nodes} not encodable in the Fig. 3 latch word "
            f"(writer byte + {MAX_NODES}-bit reader bitmap allows "
            f"1..{MAX_NODES} nodes)")


def _check_node(node_id: int) -> None:
    if not 0 <= node_id < MAX_NODES:
        raise ValueError(f"node_id {node_id} out of range [0, {MAX_NODES})")


# ------------------------------------------------ host form: Python ints

def writer_field(node_id: int) -> int:
    """The word value representing 'node_id holds the exclusive latch'."""
    _check_node(node_id)
    return (node_id + 1) << WRITER_SHIFT


def reader_bit(node_id: int) -> int:
    _check_node(node_id)
    return 1 << node_id


def pack(writer: int | None, readers) -> int:
    """Build a latch word. ``writer`` is a node id or None; ``readers`` an
    iterable of node ids."""
    w = 0 if writer is None else (writer + 1)
    word = w << WRITER_SHIFT
    for r in readers:
        word |= reader_bit(r)
    return word


def writer_of(word: int) -> int | None:
    """Node id of the exclusive holder, or None."""
    w = (word >> WRITER_SHIFT) & 0xFF
    return None if w == 0 else w - 1


def readers_of(word: int) -> list[int]:
    bits = word & READER_MASK
    out = []
    i = 0
    while bits:
        if bits & 1:
            out.append(i)
        bits >>= 1
        i += 1
    return out


def has_readers(word: int) -> bool:
    return bool(word & READER_MASK)


def holders_of(word: int) -> list[int]:
    """Every node id that holds the latch in any mode (invalidation
    targets)."""
    w = writer_of(word)
    out = [] if w is None else [w]
    out.extend(r for r in readers_of(word) if r != w)
    return out


def is_free(word: int) -> bool:
    return word == FREE


def faa(word: int, delta: int) -> int:
    """Fetch-and-add on the 64-bit word (wraps at 2**64 like the NIC
    does): returns ``(word + delta) & WORD_MASK``."""
    return (word + delta) & WORD_MASK


def to_lanes(word: int) -> tuple[int, int]:
    return (word >> 32) & 0xFFFFFFFF, word & 0xFFFFFFFF


def from_lanes(hi: int, lo: int) -> int:
    return ((hi & 0xFFFFFFFF) << 32) | (lo & 0xFFFFFFFF)


# --------------------------------------------- device form: int32 lanes

def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 with two's-complement wrap-around."""
    x = x.to(torch.int64)
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def bit_lanes(node: torch.Tensor):
    """Reader-bit lanes ``(hi, lo)`` int32 for node ids (any shape):
    readers 0..31 -> lo bit, 32..55 -> hi bits 0..23.  Callers must
    have passed :func:`check_node_capacity`."""
    node = node.to(torch.int64)
    one = torch.ones_like(node)
    lo = torch.where(node < LANE_READERS,
                     one << node.clamp(0, LANE_READERS - 1), 0)
    hi = torch.where(node >= LANE_READERS,
                     one << (node - LANE_READERS).clamp(
                         0, HI_READER_BITS - 1), 0)
    return wrap_i32(hi), wrap_i32(lo)


def writer_field_hi(node: torch.Tensor) -> torch.Tensor:
    """Hi-lane value for 'node holds the exclusive latch' (lo is 0)."""
    return wrap_i32((node.to(torch.int64) + 1) << WRITER_SHIFT_HI)


def writer_of_hi(hi: torch.Tensor) -> torch.Tensor:
    """Writer node id encoded in a hi lane; -1 = no exclusive holder."""
    return ((hi.to(torch.int64) >> WRITER_SHIFT_HI) & 0xFF).to(
        torch.int32) - 1


def directory_from_state(cache_state: torch.Tensor) -> torch.Tensor:
    """Rebuild the per-line latch words [L, 2] (hi, lo) from MSI cache
    states [N, L]: writer byte from the M holder, reader bits from the
    S holders.  The sums are exact: each node owns one distinct bit."""
    n_nodes = cache_state.shape[0]
    nodes = torch.arange(n_nodes, dtype=torch.int64,
                         device=cache_state.device)
    bhi, blo = (b.to(torch.int64) & 0xFFFFFFFF for b in bit_lanes(nodes))
    is_s = cache_state == S
    lo = torch.where(is_s, blo[:, None], 0).sum(dim=0)
    hi = torch.where(is_s, bhi[:, None], 0).sum(dim=0)
    is_m = cache_state == M
    # the first M holder (at most one exists); argmax over bool raises
    # in torch, so count in int8 — ties resolve to the first index
    writer = is_m.to(torch.int8).argmax(dim=0)
    has_w = is_m.any(dim=0)
    hi = hi + torch.where(has_w, (writer + 1) << WRITER_SHIFT_HI, 0)
    return torch.stack([wrap_i32(hi), wrap_i32(lo)], dim=1)
