"""COCO instance-segmentation AP (counterpart of
``axial_vs_tpu/evaluation/coco_instance.py``; no pycocotools).

Each image is a one-frame "video" of the port's YTVIS evaluator
(``evaluation/ytvis_eval.py``) with COCOeval's crowd rule
(``crowd_iou=True``): greedy matching per image and class at IoU
.50:.05:.95 and 101-point AP. Both tasks are scored, ``segm`` on the masks
and ``bbox`` on the masks' extents, as the reference evaluator scores kMaX's
instances, whose boxes come from the predicted masks.
"""
from __future__ import annotations

import numpy as np

from ..data import mask_rle
from .ytvis_eval import YTVISEvaluator


def mask_to_box(m):
    """The tight [x, y, w, h] around a binary mask (its pixel extents, as
    detectron2's ``BitMasks.get_bounding_boxes``), or None if it is
    empty."""
    ys, xs = np.nonzero(m)
    if len(ys) == 0:
        return None
    x0, x1 = float(xs.min()), float(xs.max()) + 1.0
    y0, y1 = float(ys.min()), float(ys.max()) + 1.0
    return [x0, y0, x1 - x0, y1 - y0]


def instances_to_records(image_id, masks, labels, scores,
                         score_threshold: float = 0.0):
    """Predictions of one image, masks (k, H, W) bool or probabilities (>
    0.5 is in), as records with an RLE and a box; scores under
    ``score_threshold`` are dropped."""
    out = []
    for k in range(len(scores)):
        if scores[k] < score_threshold:
            continue
        m = np.asarray(masks[k] > 0.5, np.uint8)
        out.append(dict(
            video_id=image_id, category_id=int(labels[k]),
            score=float(scores[k]),
            segmentations=[mask_rle.encode(m) if m.any() else None],
            bboxes=[mask_to_box(m)]))
    return out


def gt_to_records(image_id, masks, labels, iscrowd=None):
    """Ground truth of one image, masks (k, H, W), as records."""
    out = []
    for k in range(len(labels)):
        m = np.asarray(masks[k] > 0.5, np.uint8)
        out.append(dict(
            video_id=image_id, category_id=int(labels[k]),
            segmentations=[mask_rle.encode(m)], bboxes=[mask_to_box(m)],
            iscrowd=int(iscrowd[k]) if iscrowd is not None else 0))
    return out


def coco_instance_ap(gt_records, pred_records, tasks=("segm", "bbox")):
    """{task: summary dict} of COCOeval's rules per task (a box task keeps
    the annotation's mask area for its area ranges, as pycocotools does);
    the summary alone where one task is asked for."""
    results = {task: YTVISEvaluator(crowd_iou=True, iou_type=task).evaluate(
        gt_records, pred_records) for task in tasks}
    return results if len(tasks) > 1 else results[tasks[0]]
