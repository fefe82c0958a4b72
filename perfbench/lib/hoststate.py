"""A plane's final state on the host, for the references' comparisons.

The small leaves (latch words, MSI states, versions) and memory's
payload image are copied whole; the nodes' cached copies (four times
memory's size) are gathered only at the rows a comparison asks for.
"""

from __future__ import annotations

import numpy as np
import torch

ROWS_A_GATHER = 1 << 18


class HostState:
    def __init__(self, state: dict):
        self.words = state["words"].cpu().numpy()
        self.cache_state = state["cache_state"].cpu().numpy()
        self.cache_version = state["cache_version"].cpu().numpy()
        self.mem_version = state["mem_version"].cpu().numpy()
        self.mem_data = state["mem_data"].cpu().numpy()
        self._cache_data = state["cache_data"]

    def cache_rows(self, nodes, lines) -> np.ndarray:
        """``cache_data[nodes[i], lines[i]]`` as a host array."""
        data = self._cache_data
        out = np.empty((len(nodes), data.shape[2]), np.int32)
        for a in range(0, len(nodes), ROWS_A_GATHER):
            n = torch.as_tensor(np.asarray(nodes[a:a + ROWS_A_GATHER]),
                                device=data.device).long()
            ln = torch.as_tensor(np.asarray(lines[a:a + ROWS_A_GATHER]),
                                 device=data.device).long()
            out[a:a + len(n)] = data[n, ln].cpu().numpy()
        return out
