"""Image Panoptic Quality (COCO PQ; counterpart of
``axial_vs_tpu/evaluation/pq.py``).

The PQ of one image is the tube PQ of a one-frame window, so both functions
run the port's VPQ core (``evaluation/vpq.py``).
"""
from __future__ import annotations

from typing import Dict

from .vpq import PQStat, vpq_single_video


def pq_compute_single(gt_ids, pred_ids, gt_segments, pred_segments) -> PQStat:
    """gt_ids / pred_ids: (H, W) id maps, 0 = void; the segments {id:
    {"category_id", ["iscrowd"]}}."""
    return vpq_single_video(gt_ids[None], pred_ids[None], gt_segments,
                            pred_segments, nframes=1)


def pq_compute(images, categories: Dict[int, dict]) -> dict:
    """images: iterable of (gt_ids, pred_ids, gt_segments, pred_segments);
    categories {class: {"isthing"}}. Returns {"all", "things", "stuff",
    "per_class"}, each PQ/SQ/RQ and the count of classes "n"."""
    stat = PQStat()
    for gt_ids, pred_ids, gt_segments, pred_segments in images:
        stat += pq_compute_single(gt_ids, pred_ids, gt_segments, pred_segments)
    all_res, per_class = stat.average(categories, None)
    things, _ = stat.average(categories, True)
    stuff, _ = stat.average(categories, False)
    return dict(all=all_res, things=things, stuff=stuff, per_class=per_class)
