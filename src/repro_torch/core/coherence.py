"""The Fig. 3 latch word in its device form: 2 x int32 lanes.

Counterpart of the device half of ``repro/core/coherence.py``: an 8-bit
exclusive-holder byte and a 56-bit reader bitmap in one 64-bit word,
split into a hi lane (writer byte in bits 31..24, readers 32..55 in
bits 23..0) and a lo lane (readers 0..31).  Lane arithmetic is done in
int64 and wrapped back to int32 explicitly, so a reader bit 31 or a
lane sum that reaches 2**31 lands on the same two's-complement bits the
reference produces.
"""

from __future__ import annotations

import torch

MAX_NODES = 56                     # the paper's compute-node limit
WRITER_SHIFT = 56                  # writer byte: bits 63..56 of the word
LANE_READERS = 32                  # readers 0..31 live in lo
HI_READER_BITS = MAX_NODES - LANE_READERS      # readers 32..55: hi 0..23
WRITER_SHIFT_HI = 24               # writer byte: hi-lane bits 31..24

I, S, M = 0, 1, 2                  # MSI cache states (int8 on device)


def check_node_capacity(n_nodes: int) -> None:
    """Reject node counts the 64-bit word cannot encode (raised at the
    entry points: lane math cannot raise per element)."""
    if not 0 < n_nodes <= MAX_NODES:
        raise ValueError(
            f"n_nodes={n_nodes} not encodable in the Fig. 3 latch word "
            f"(writer byte + {MAX_NODES}-bit reader bitmap allows "
            f"1..{MAX_NODES} nodes)")


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
