"""The paper's applications on the flat device plane: the device batch
generators (``workloads``), the shared txn counters (``txn.TxnStats``)
and the gang transaction engine (``txn_device``).  The B-link tree is
``repro_torch.index.DeviceBTree``."""

from .txn import TxnStats
from .txn_device import (DeviceTxnConfig, DeviceTxnEngine, encode_txns,
                         host_record_lanes)
from .workloads import (BTreeBatchConfig, TxnBatchConfig, Zipf,
                        btree_kv_batches, device_txn_batches)

__all__ = ["BTreeBatchConfig", "DeviceTxnConfig", "DeviceTxnEngine",
           "TxnBatchConfig", "TxnStats", "Zipf", "btree_kv_batches",
           "device_txn_batches", "encode_txns", "host_record_lanes"]
