"""Continuous-batching serving engine on the port's coherence plane.

    pool = SELCCKVPool(cfg); pool.open_rounds_plane()      # on cuda
    loop = ServeLoop(pool, ToyLM(cfg), n_slots=8, max_pages=16)
    req = loop.submit([17, 3], max_new=12)
    loop.drain()
    req.generated                      # 12 tokens

Module map (each a counterpart of ``repro/serve``): ``request``
(ServeRequest / bounded RequestQueue), ``slots`` (Slot / SlotManager),
``model`` (the model surface + deterministic ToyLM), ``loop``
(ServeLoop + ServeStats), ``sync`` (SyncBatchServer, the gang-batch
oracle, and the ``write_pages`` shared-prefix loader).
"""

from .loop import ServeLoop, ServeStats
from .model import DecodeOut, DecodeView, ToyLM
from .request import (QueueFull, RequestQueue, RequestState,
                      ServeRequest)
from .slots import Phase, Slot, SlotManager
from .sync import SyncBatchServer, write_pages

__all__ = [
    "DecodeOut", "DecodeView", "Phase", "QueueFull", "RequestQueue",
    "RequestState", "ServeLoop", "ServeRequest", "ServeStats", "Slot",
    "SlotManager", "SyncBatchServer", "ToyLM", "write_pages",
]
