"""The paper's applications: the B-link tree over the host DES's
Table-1 facade (``btree.BLinkTree``, a copy of ``repro/apps/btree.py``),
and on the device plane the device batch generators
(``workloads``), the shared txn counters (``txn.TxnStats``) and the gang
transaction engine (``txn_device``).  The device B-link tree is
``repro_torch.index.DeviceBTree``.  The DES transaction engine and the
DES workers of ``repro/apps/{txn,workloads}.py`` are not ported."""

from .btree import BLinkTree
from .txn import TxnStats
from .txn_device import (DeviceTxnConfig, DeviceTxnEngine, encode_txns,
                         host_record_lanes)
from .workloads import (BTreeBatchConfig, TxnBatchConfig, Zipf,
                        btree_kv_batches, device_txn_batches)

__all__ = ["BLinkTree", "BTreeBatchConfig", "DeviceTxnConfig",
           "DeviceTxnEngine", "TxnBatchConfig", "TxnStats", "Zipf",
           "btree_kv_batches", "device_txn_batches", "encode_txns",
           "host_record_lanes"]
