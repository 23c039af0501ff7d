"""Segmentation and Tracking Quality (STQ), STEP (arXiv:2102.11859)
(counterpart of ``axial_vs_tpu/evaluation/stq.py``).

Same semantics as the deeplab2 numpy port the reference vendors
(`tools/segmentation_and_tracking_quality.py:40-...`, also
`MaXTron_Tube-Link/datasets/utils/STQ.py`): panoptic labels encoded as
``(semantic << label_bit_shift) + instance``;

- SQ: semantic mIoU accumulated in a global confusion matrix (ignore-class
  rows removed so void GT doesn't count, but false positives on void GT are
  dropped too);
- AQ: per GT tube g: (1/|g|) * sum over prediction tubes p of
  ``TPA * IoU_tube(p, g)``, crowd (instance 0) GT regions excluded and not
  penalized; averaged over all GT tubes of all sequences;
- STQ = sqrt(AQ * mIoU).
"""
from __future__ import annotations

import collections
from typing import Sequence

import numpy as np

_EPS = 1e-15


def _accumulate(d, values):
    ids, cnts = np.unique(values, return_counts=True)
    for i, c in zip(ids.tolist(), cnts.tolist()):
        d[i] = d.get(i, 0) + c


class STQuality:
    def __init__(self, num_classes: int, things_list: Sequence[int],
                 ignore_label: int, label_bit_shift: int = 16,
                 offset: int = 2 ** 32):
        self.num_classes = num_classes
        self.things = set(things_list)
        self.ignore_label = ignore_label
        self.shift = label_bit_shift
        self.mask = (1 << label_bit_shift) - 1
        self.offset = offset
        size = num_classes + (1 if ignore_label >= num_classes else 0)
        self.cm_size = size
        self.include = (
            np.arange(num_classes)
            if ignore_label >= num_classes
            else np.array([i for i in range(num_classes) if i != ignore_label])
        )
        self._confusion = {}
        self._preds = {}
        self._gts = {}
        self._inter = {}
        self._length = collections.OrderedDict()

    def update_state(self, y_true: np.ndarray, y_pred: np.ndarray, sequence_id=0):
        y_true = y_true.astype(np.int64)
        y_pred = y_pred.astype(np.int64)
        sem_t = y_true >> self.shift
        sem_p = y_pred >> self.shift
        if self.ignore_label > self.num_classes:
            sem_t = np.where(sem_t != self.ignore_label, sem_t, self.num_classes)
            sem_p = np.where(sem_p != self.ignore_label, sem_p, self.num_classes)

        cm = self._confusion.setdefault(
            sequence_id, np.zeros((self.cm_size, self.cm_size), np.int64)
        )
        flat = sem_t.reshape(-1) * self.cm_size + np.clip(sem_p.reshape(-1), 0, self.cm_size - 1)
        binc = np.bincount(flat, minlength=self.cm_size * self.cm_size)
        cm += binc.reshape(self.cm_size, self.cm_size)
        self._length[sequence_id] = self._length.get(sequence_id, 0) + 1

        preds = self._preds.setdefault(sequence_id, {})
        gts = self._gts.setdefault(sequence_id, {})
        inter = self._inter.setdefault(sequence_id, {})

        inst_t = y_true & self.mask
        label_mask = np.isin(sem_t, list(self.things))
        pred_mask = np.isin(sem_p, list(self.things))
        is_crowd = np.logical_and(inst_t == 0, label_mask)
        label_mask &= ~is_crowd
        pred_mask &= ~is_crowd

        _accumulate(preds, y_pred[pred_mask])
        _accumulate(gts, y_true[label_mask])
        both = label_mask & pred_mask
        _accumulate(inter, y_true[both] * self.offset + y_pred[both])

    def result(self):
        seq_ids = list(self._gts.keys())
        aq_sum = 0.0
        num_tubes = 0
        aq_per_seq = []
        for sid in seq_ids:
            preds, gts, inter = self._preds[sid], self._gts[sid], self._inter[sid]
            outer = 0.0
            for g, g_size in gts.items():
                inner = 0.0
                for p, p_size in preds.items():
                    tpa = inter.get(self.offset * g + p)
                    if tpa:
                        inner += tpa * (tpa / (tpa + (p_size - tpa) + (g_size - tpa)))
                outer += inner / g_size
            aq_sum += outer
            num_tubes += len(gts)
            aq_per_seq.append(outer / max(len(gts), 1))
        aq_mean = aq_sum / max(num_tubes, _EPS)

        total = np.zeros((self.cm_size, self.cm_size), np.int64)
        iou_per_seq = []
        for sid in seq_ids:
            cm = self._confusion[sid].copy()
            keep = np.zeros_like(cm)
            keep[self.include, :] = 1
            cm *= keep
            total += cm
            tp = cm.diagonal()
            fp = cm.sum(0) - tp
            fn = cm.sum(1) - tp
            union = tp + fp + fn
            nz = union[self.include] > 0
            iou_per_seq.append(
                float(
                    np.mean(
                        (tp[self.include][nz] / union[self.include][nz]).astype(np.float64)
                    )
                )
                if nz.any()
                else 0.0
            )
        tp = total.diagonal()
        fp = total.sum(0) - tp
        fn = total.sum(1) - tp
        union = tp + fp + fn
        nz = union[self.include] > 0
        iou_mean = (
            float(np.mean((tp[self.include][nz] / union[self.include][nz]).astype(np.float64)))
            if nz.any()
            else 0.0
        )
        return {
            "STQ": float(np.sqrt(aq_mean * iou_mean)),
            "AQ": float(aq_mean),
            "IoU": iou_mean,
            "AQ_per_seq": aq_per_seq,
            "IoU_per_seq": iou_per_seq,
            "Id_per_seq": seq_ids,
            "Length_per_seq": list(self._length.values()),
        }
