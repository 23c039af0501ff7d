"""Depth-aware STQ (DSTQ) (counterpart of
``axial_vs_tpu/evaluation/dstq.py``): deeplab2 semantics, as vendored by
the reference (`MaXTron_Tube-Link/datasets/utils/DSTQ.py`), STQ
(``evaluation/stq.py``) extended with a Depth Quality term. Per threshold
λ, DQ@λ = inlier fraction over valid depth pixels (max(d/d̂, d̂/d) ≤ λ);
DQ = geometric mean over thresholds; DSTQ@λ = (AQ · IoU · DQ@λ)^(1/3)."""
from __future__ import annotations

import collections
from typing import Sequence, Tuple

import numpy as np

from .stq import STQuality


class DSTQuality(STQuality):
    def __init__(self, num_classes: int, things_list: Sequence[int],
                 ignore_label: int, label_bit_shift: int = 16,
                 offset: int = 2 ** 32,
                 depth_threshold: Tuple[float, ...] = (1.25, 1.1)):
        super().__init__(num_classes, things_list, ignore_label,
                         label_bit_shift, offset)
        if not depth_threshold:
            raise ValueError("depth_threshold must be non-empty")
        self.depth_threshold = tuple(depth_threshold)
        self._depth_total = collections.OrderedDict()
        self._depth_inliers = [collections.OrderedDict() for _ in depth_threshold]

    def update_state(self, y_true, y_pred, d_true=None, d_pred=None,
                     sequence_id=0):
        super().update_state(y_true, y_pred, sequence_id)
        if d_true is None or d_pred is None:
            return
        valid = d_true > 0
        total = int(valid.sum())
        valid = np.logical_and(valid, d_pred > 0)
        dt, dp = d_true[valid].astype(np.float64), d_pred[valid].astype(np.float64)
        err = np.maximum(dp / dt, dt / dp) if dt.size else np.zeros(0)
        for ti, thr in enumerate(self.depth_threshold):
            self._depth_inliers[ti][sequence_id] = (
                self._depth_inliers[ti].get(sequence_id, 0)
                + int(np.sum(err <= thr))
            )
        self._depth_total[sequence_id] = self._depth_total.get(sequence_id, 0) + total

    def result(self):
        out = super().result()
        dq_at = {}
        for ti, thr in enumerate(self.depth_threshold):
            total = sum(self._depth_total.values())
            inliers = sum(self._depth_inliers[ti].values())
            dq_at[thr] = inliers / total if total else 0.0
            out[f"DQ@{thr}"] = dq_at[thr]
        dq = float(np.prod(list(dq_at.values())) ** (1 / len(dq_at)))
        out["DQ"] = dq
        for thr in self.depth_threshold:
            out[f"DSTQ@{thr}"] = float(
                (out["AQ"] * out["IoU"] * dq_at[thr]) ** (1 / 3)
            )
        out["DSTQ"] = float((out["AQ"] * out["IoU"] * dq) ** (1 / 3))
        return out
