"""VSPW video-semantic-segmentation metrics: mIoU, TC, VC (counterpart of
``axial_vs_tpu/evaluation/vspw_metrics.py``; host numpy). They score the
semantic maps of the VPS and VSS models.

Semantics of the reference's analysis scripts
(`MaXTron_Tube-Link/scripts/test_vspw/{TC_cal.py, VC_perclip.py,
iou_cal.py}`):

- mIoU: confusion-matrix mean IoU with an ignore label, averaged over the
  classes that occur in the ground truth;
- VC_n (video consistency): per sliding window of n frames, the area where
  all n GT maps agree AND all n predictions also keep one common label,
  over the GT-common area;
- TC (temporal consistency): flow-warped mIoU between consecutive frame
  predictions. Flows are supplied by the caller (the reference vendors RAFT
  to produce them; zeros give a static-camera bound).
"""
from __future__ import annotations

import numpy as np


class SemanticIoU:
    def __init__(self, num_classes: int, ignore_label: int = 255):
        self.num_classes = num_classes
        self.ignore = ignore_label
        self.cm = np.zeros((num_classes, num_classes), np.int64)

    def update(self, gt: np.ndarray, pred: np.ndarray):
        keep = gt != self.ignore
        g = gt[keep].astype(np.int64)
        p = np.clip(pred[keep].astype(np.int64), 0, self.num_classes - 1)
        binc = np.bincount(
            g * self.num_classes + p, minlength=self.num_classes ** 2
        )
        self.cm += binc.reshape(self.num_classes, self.num_classes)

    def miou(self) -> float:
        """Reference-exact (`scripts/test_vspw/utils.py:74-80`): classes are
        averaged only when they OCCUR IN GT (row sum > 0); a class that is
        only ever predicted does not enter the mean."""
        tp = self.cm.diagonal().astype(np.float64)
        union = self.cm.sum(0) + self.cm.sum(1) - tp
        isval = self.cm.sum(1) > 0
        if not isval.any():
            return 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = tp / union
        return float(np.nansum(iou * isval) / isval.sum())


def video_consistency(gts, preds, window: int = 8):
    """Reference-exact VC (`scripts/test_vspw/VC_perclip.py:get_common`):
    per sliding window (videos with <= window frames are skipped; the last
    start index is len-window-1 as in the reference), the fraction of the
    GT-static area on which the predictions are ALSO self-consistent
    (prediction-vs-prediction, not prediction-vs-GT). Returns the list of
    per-window accuracies (may contain nan when the GT-static area is
    empty); aggregate with np.nanmean across all videos.

    gts/preds: (V, H, W) int maps.
    """
    v = gts.shape[0]
    if v <= window:
        return None
    accs = []
    for s in range(0, v - window):
        g = gts[s : s + window]
        p = preds[s : s + window]
        gt_common = np.all(g == g[0], axis=0)
        pred_common = np.all(p == p[0], axis=0)
        denom = gt_common.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            accs.append((pred_common & gt_common).sum() / denom)
    return accs


def warp_by_flow(label_map: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Nearest-neighbor warp of an int label map by a (H, W, 2) flow (dx, dy)."""
    h, w = label_map.shape
    ys, xs = np.mgrid[0:h, 0:w]
    src_x = np.clip(np.round(xs + flow[..., 0]).astype(np.int64), 0, w - 1)
    src_y = np.clip(np.round(ys + flow[..., 1]).astype(np.int64), 0, h - 1)
    return label_map[src_y, src_x]


def temporal_consistency(preds, flows, num_classes: int,
                         ignore_label: int = 255) -> float:
    """preds (V, H, W); flows (V-1, H, W, 2) backward flow t+1 -> t.
    TC = mean IoU between warp(pred_t) and pred_{t+1}."""
    metric = SemanticIoU(num_classes, ignore_label)
    for t in range(preds.shape[0] - 1):
        warped = warp_by_flow(preds[t], flows[t])
        metric.update(warped, preds[t + 1])
    return metric.miou()


def warp_nearest_ref(label_map: np.ndarray, flow: np.ndarray,
                     fill: int = 0) -> np.ndarray:
    """Reference-exact nearest warp (`TC_cal.py:13-38` flowwarp).

    The reference normalizes the sampling grid by (size-1) but calls
    ``grid_sample(mode='nearest', align_corners=False)``, which unnormalizes
    by size — net effect: src = (x + flow) * size/(size-1) - 0.5, rounded,
    zeros outside. Replicated verbatim (labels cast to float and back).
    """
    h, w = label_map.shape
    ys, xs = np.mgrid[0:h, 0:w]
    vx = (xs + flow[..., 0]) * (w / max(w - 1, 1)) - 0.5
    vy = (ys + flow[..., 1]) * (h / max(h - 1, 1)) - 0.5
    sx = np.round(vx).astype(np.int64)
    sy = np.round(vy).astype(np.int64)
    valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = np.full_like(label_map, fill)
    out[valid] = label_map[np.clip(sy, 0, h - 1), np.clip(sx, 0, w - 1)][valid]
    return out


def temporal_consistency_ref(preds, flows, num_classes: int) -> float:
    """Reference-exact TC (`TC_cal.py:84-126`): for each consecutive pair,
    warp pred_{t+1} back to frame t by the forward flow t->t+1 and
    accumulate IoU(pred_t, warped) over ALL pairs of ALL videos (call once
    per video on a shared SemanticIoU via `update_pairs`, or once total).

    preds: (V, H, W) int; flows: (V-1, H, W, 2) forward flow (x, y).
    """
    metric = SemanticIoU(num_classes, ignore_label=255)
    update_tc_pairs(metric, preds, flows)
    return metric.miou()


def update_tc_pairs(metric: SemanticIoU, preds, flows) -> None:
    for t in range(preds.shape[0] - 1):
        warped = warp_nearest_ref(preds[t + 1], flows[t])
        metric.update(preds[t], warped)
