"""Device-resident index structures served from the rounds payload plane.

Counterpart of ``repro/index``: the paper's flagship workload (Sec. 8.1,
Fig. 10), a concurrent B-link tree over the SELCC abstraction, on the
flat device coherence plane.  Tree nodes are GCL lines whose payload
lanes carry a fixed node codec; a batched root-to-leaf descent is one
``DevicePlane.descent`` driving the codec's ``descend_step``, leaf
inserts are coherent read-modify-writes (``DevicePlane.rmw``), and range
scans (``DeviceBTree.scan_batch``) walk the leaf chain in coherent
batches.
"""

from .codec import NodeCodec
from .tree import DeviceBTree

__all__ = ["DeviceBTree", "NodeCodec"]
