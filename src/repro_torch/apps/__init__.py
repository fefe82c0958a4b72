"""The paper's applications, a copy of ``repro/apps``.  Over the host
DES's Table-1 facade (``repro_torch.core.SELCCLayer``): the B-link tree
(``btree.BLinkTree``), the transaction engines (``txn.TxnEngine``: 2PL,
TO, OCC, WAL and partitioned 2PC) and the DES workers of
``workloads`` (micro, YCSB, TPC-C-lite, the backend parity script).  On
the device plane: the batch generators of ``workloads`` (rounds-plane
ops, transaction and B-link-tree key batches), the gang transaction
engine (``txn_device``) and the counters both engines share
(``txn.TxnStats``).  The device B-link tree is
``repro_torch.index.DeviceBTree``."""

from .btree import BLinkTree
from .txn import TxnConfig, TxnEngine, TxnStats
from .txn_device import (DeviceTxnConfig, DeviceTxnEngine, encode_txns,
                         host_record_lanes)
from .workloads import (BTreeBatchConfig, DeviceRoundsConfig, MicroConfig,
                        TPCCConfig, TPCCTables, TxnBatchConfig, YCSBConfig,
                        Zipf, btree_kv_batches, device_rounds_batches,
                        device_txn_batches, micro_worker, parity_worker,
                        tpcc_txn, tpcc_worker, ycsb_worker)

__all__ = ["BLinkTree", "BTreeBatchConfig", "DeviceRoundsConfig",
           "DeviceTxnConfig", "DeviceTxnEngine", "MicroConfig",
           "TPCCConfig", "TPCCTables", "TxnBatchConfig", "TxnConfig",
           "TxnEngine", "TxnStats", "YCSBConfig", "Zipf",
           "btree_kv_batches", "device_rounds_batches",
           "device_txn_batches", "encode_txns", "host_record_lanes",
           "micro_worker", "parity_worker", "tpcc_txn", "tpcc_worker",
           "ycsb_worker"]
