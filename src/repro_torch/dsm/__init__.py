"""Disaggregated-shared-memory data plane: typed addresses, the line
allocator and the SELCC-coherent KV-page pool."""

from .address import GAddr, LineAllocator, as_gaddr, home_of
from .kvpool import KVPoolConfig, SELCCKVPool

__all__ = ["GAddr", "KVPoolConfig", "LineAllocator", "SELCCKVPool",
           "as_gaddr", "home_of"]
