"""Core of the port: the SELCC protocol over a simulated cluster (the
host DES: SELCC, SEL, GAM and the RPC strawman behind the Table-1 v2
facade ``SELCCLayer``), the latch-word spec, addresses, and the device
rounds plane (``core.rounds``, imported on first use).

Counterpart of ``repro/core/__init__.py``, minus the deprecated shims
``jax_protocol`` and ``latchword``."""

from . import coherence
from .addressing import GAddr, as_gaddr, home_of
from .api import ClusterConfig, SELCCLayer
from .cache import INVALID, MODIFIED, SHARED, NodeCache
from .consistency import (SCViolation, check_coherence,
                          check_sequential_consistency, merge_histories)
from .gam import GAMConfig, GAMMemoryAgent, GAMNode
from .handles import GclHeap, Handle, NodeAPIMixin
from .protocol import (CoherenceError, SELCCConfig, SELCCNode,
                       PEER_RD, PEER_UPGR, PEER_WR)
from .registry import (ProtocolSpec, available_protocols, get_protocol,
                       register_protocol)
from .rpc import RPCLockAgent, RPCNode
from .sel import SELNode
from .simulator import (CostModel, Environment, Event, Fabric, Process,
                        QueueResource, RpcRequest, SXLatch, Store)

__all__ = [
    "coherence", "GAddr", "as_gaddr", "home_of", "ClusterConfig",
    "SELCCLayer",
    "NodeCache", "MODIFIED", "SHARED", "INVALID",
    "SCViolation", "check_coherence", "check_sequential_consistency",
    "merge_histories", "GAMConfig", "GAMMemoryAgent", "GAMNode", "GclHeap",
    "Handle", "NodeAPIMixin", "CoherenceError", "SELCCConfig", "SELCCNode",
    "PEER_RD", "PEER_UPGR", "PEER_WR", "ProtocolSpec",
    "available_protocols", "get_protocol", "register_protocol",
    "RPCLockAgent", "RPCNode", "SELNode", "CostModel", "Environment",
    "Event", "Fabric", "Process", "QueueResource", "RpcRequest",
    "SXLatch", "Store",
    # lazy (see __getattr__): the device plane and the serving pool
    "rounds", "KVPoolConfig", "SELCCKVPool",
]


def __getattr__(name):
    # the device plane and the pool import the DES's neighbours (dsm/,
    # obs/); resolving them lazily keeps the import graph acyclic
    import importlib
    if name == "rounds":
        return importlib.import_module(".rounds", __name__)
    if name in ("KVPoolConfig", "SELCCKVPool"):
        kvpool = importlib.import_module("..dsm.kvpool", __name__)
        return getattr(kvpool, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
