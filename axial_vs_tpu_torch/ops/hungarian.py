"""Linear assignment for Hungarian matching, the exact host path
(counterpart of ``axial_vs_tpu/ops/hungarian.py``: ``_lsap_host`` and
``hungarian_assign(exact=True)``).

The cost matrix goes to the host once per call and scipy's
``linear_sum_assignment`` solves each sample, as the reference does
(`kmax_deeplab/modeling/matcher.py:91`). The JAX package's on-device
auction solver (``exact=False``) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch


def lsap_host(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """cost (B, N, M), valid (B, M) -> (B, M) int64: the query row of each
    valid GT column, -1 for an invalid one."""
    from scipy.optimize import linear_sum_assignment

    b, n, m = cost.shape
    out = np.full((b, m), -1, np.int64)
    for i in range(b):
        cols = np.flatnonzero(valid[i])
        if cols.size == 0:
            continue
        row_ind, col_ind = linear_sum_assignment(cost[i][:, cols])
        out[i, cols[col_ind]] = row_ind
    return out


def hungarian_assign(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Assign each valid GT column one query row, minimizing the total cost.

    cost (B, N, M) rows = queries, columns = GT slots; valid (B, M) bool.
    Returns (B, M) int64 on cost's device: the query of each GT column (-1
    where invalid)."""
    out = lsap_host(cost.detach().float().cpu().numpy(),
                    valid.detach().cpu().numpy())
    return torch.from_numpy(out).to(cost.device)
