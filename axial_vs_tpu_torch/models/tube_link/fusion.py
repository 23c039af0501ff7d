"""MaskFormer fusion-head panoptic modes, the VPS query-carrying variants
(counterpart of ``axial_vs_tpu/models/tube_link/fusion.py``; host numpy).

Port of the reference's fusion head (`MaXTron_Tube-Link/mmdet/models/
seg_heads/panoptic_fusion_heads/maskformer_fusion_head.py:99-265`, dispatch
:527-545): the ``*_with_query`` modes return per-segment query indices that
drive VPS tracking (``models/tube_link/vps.py::TubeLinkVPSInference``).

- ``with_query`` (:99-167, the VIPSeg VPS config's mode): keep queries
  with a non-void argmax class AND score > object_mask_thr; per-pixel
  argmax over score-weighted sigmoid masks; per-query segments dropped
  when mask_area/original_area < iou_thr; stuff written as the class id,
  things as ``cls + (query_index + 1) * INSTANCE_OFFSET``.
- ``sort`` (:168-210): iterate queries by descending score (void-argmax
  queries kept out by `keep`), things gated by object_mask_thr, segment
  ids count up.
- ``sort_with_query`` (:212-265): the sort order with query-derived ids.
- ``sem_seg_only_with_query`` (:267-): semantic argmax of
  einsum('qc,qhw', softmax cls[..., :-1], sigmoid masks) relabeled into
  panoptic form with query ids for things.
- ``sperate_focal`` (:323-386): flattened thing (query x class) top-k and
  the fixed stuff slots, merged in score order.

Every mode works in float64 on the host, after the window's device work.
"""
from __future__ import annotations

import numpy as np

INSTANCE_OFFSET = 1000  # mmdet.core.evaluation.panoptic_utils


def _softmax(x, axis=-1):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def panoptic_with_query(cls_logits, mask_logits, num_things, num_classes,
                        object_mask_thr=0.8, iou_thr=0.8,
                        filter_low_score=False, sort=False):
    """cls_logits (Q, K+1); mask_logits (Q, h, w) raw logits.

    Returns (pan_seg (h, w) int32 — void = num_classes, query_list of
    (query_index, pan_id) for thing segments).
    """
    prob = _softmax(cls_logits.astype(np.float64), -1)
    scores = prob.max(-1)
    labels = prob.argmax(-1)
    masks = _sigmoid(mask_logits.astype(np.float64))
    query_index = np.arange(len(cls_logits))

    if sort:
        keep = labels != num_classes
    else:
        keep = (labels != num_classes) & (scores > object_mask_thr)
    query_index = query_index[keep]
    cur_scores = scores[keep]
    cur_classes = labels[keep]
    cur_masks = masks[keep]

    h, w = mask_logits.shape[-2:]
    pan = np.full((h, w), num_classes, np.int32)
    query_list = []
    if cur_masks.shape[0] == 0:
        return pan, query_list

    cur_prob_masks = cur_scores[:, None, None] * cur_masks
    cur_mask_ids = cur_prob_masks.argmax(0)

    order = np.argsort(-cur_scores) if sort else range(len(cur_classes))
    for k in order:
        pred_class = int(cur_classes[k])
        isthing = pred_class < num_things
        if sort and isthing and cur_scores[k] < object_mask_thr:
            continue
        mask = cur_mask_ids == k
        mask_area = int(mask.sum())
        original_area = int((cur_masks[k] >= 0.5).sum())
        if filter_low_score and not sort:
            mask = mask & (cur_masks[k] >= 0.5)
        if mask_area > 0 and original_area > 0:
            if mask_area / original_area < iou_thr:
                continue
            if not isthing:
                pan[mask] = pred_class
            else:
                qi = int(query_index[k])
                cur_id = pred_class + (qi + 1) * INSTANCE_OFFSET
                pan[mask] = cur_id
                query_list.append((qi, cur_id))
    return pan, query_list


def panoptic_sort(cls_logits, mask_logits, num_things, num_classes,
                  object_mask_thr=0.8, overlap_thr=0.6):
    """The plain ``sort`` mode (:168-210): ids count up in score order."""
    prob = _softmax(cls_logits.astype(np.float64), -1)
    scores = prob.max(-1)
    labels = prob.argmax(-1)
    masks = _sigmoid(mask_logits.astype(np.float64))
    keep = labels != num_classes
    cur_scores = scores[keep]
    cur_classes = labels[keep]
    cur_masks = masks[keep]

    h, w = mask_logits.shape[-2:]
    pan = np.full((h, w), num_classes, np.int32)
    if cur_masks.shape[0] == 0:
        return pan
    cur_prob_masks = cur_scores[:, None, None] * cur_masks
    cur_mask_ids = cur_prob_masks.argmax(0)
    segment_id = 0
    for k in np.argsort(-cur_scores):
        pred_class = int(cur_classes[k])
        isthing = pred_class < num_things
        if isthing and cur_scores[k] < object_mask_thr:
            continue
        mask = cur_mask_ids == k
        mask_area = int(mask.sum())
        original_area = int((cur_masks[k] >= 0.5).sum())
        if mask_area > 0 and original_area > 0:
            if mask_area / original_area < overlap_thr:
                continue
            segment_id += 1
            if not isthing:
                pan[mask] = pred_class
            else:
                pan[mask] = pred_class + segment_id * INSTANCE_OFFSET
    return pan


def panoptic_sem_seg_only_with_query(cls_logits, mask_logits, num_things,
                                     num_classes):
    """Semantic argmax relabeled to panoptic (:267-…): per-pixel class from
    einsum('qc,qhw') of softmax scores (void dropped) x sigmoid masks;
    things get the argmax QUERY's id per class region."""
    prob = _softmax(cls_logits.astype(np.float64), -1)[..., :-1]
    masks = _sigmoid(mask_logits.astype(np.float64))
    seg_logits = np.einsum("qc,qhw->chw", prob, masks)
    sem = seg_logits.argmax(0)  # (h, w) class ids
    # per-pixel responsible query: argmax over q of prob[q, cls]*mask[q]
    pan = np.full(sem.shape, num_classes, np.int32)
    query_list = []
    for cls in np.unique(sem):
        region = sem == cls
        if cls >= num_things:
            pan[region] = cls
            continue
        qscore = prob[:, cls, None, None] * masks  # (Q, h, w)
        qi = int(np.argmax((qscore * region).sum((1, 2))))
        cur_id = int(cls) + (qi + 1) * INSTANCE_OFFSET
        pan[region] = cur_id
        query_list.append((qi, cur_id))
    return pan, query_list


def panoptic_sperate_focal(cls_logits, mask_logits, num_things, num_classes,
                           num_thing_queries, max_per_image=100,
                           object_mask_thr=0.8, overlap_thr=0.6):
    """``sperate_focal`` (`maskformer_fusion_head.py:323-386`,
    panoptic_postprocess_focal_sort_score_sperate): thing candidates are the
    top-``max_per_image`` entries of the flattened (thing queries x thing
    classes) score table (a query may yield several candidates under
    different classes); stuff scores are read off the fixed-slot diagonal
    (slot k <-> stuff class k); candidates merge through the standard
    score-sorted prob-mask-argmax pass with counting segment ids.

    NOTE the reference's own version is bit-rotted and crashes as written —
    `:326` reduces the class axis (``.max(-1)``) that `:329`/`:338` then
    index, so no config can run it; this is the evident K-Net-style intent.
    (``joint_focal`` dispatches to a method that does not exist anywhere in
    the vendored tree, `maskformer_fusion_head.py:531` — dead path, not
    reproduced.)
    """
    prob = _softmax(cls_logits.astype(np.float64), -1)  # (Q, K+1)
    masks = _sigmoid(mask_logits.astype(np.float64))
    q_th = num_thing_queries
    num_stuff = num_classes - num_things

    thing_table = prob[:q_th, :num_things]  # (Q_th, K_th)
    flat = thing_table.reshape(-1)
    k = min(max_per_image, flat.size)
    top = np.argsort(-flat)[:k]
    thing_scores = flat[top]
    thing_masks = masks[top // num_things]
    thing_labels = top % num_things

    stuff_scores = np.asarray([prob[q_th + i, num_things + i]
                               for i in range(num_stuff)])
    stuff_order = np.argsort(-stuff_scores)
    stuff_masks = masks[q_th:q_th + num_stuff][stuff_order]
    stuff_labels = stuff_order + num_things

    total_masks = np.concatenate([thing_masks, stuff_masks], 0)
    total_scores = np.concatenate([thing_scores, stuff_scores[stuff_order]])
    total_labels = np.concatenate([thing_labels, stuff_labels])

    h, w = mask_logits.shape[-2:]
    pan = np.full((h, w), num_classes, np.int32)
    if total_masks.shape[0] == 0:
        return pan
    cur_mask_ids = (total_scores[:, None, None] * total_masks).argmax(0)
    segment_id = 0
    for k in np.argsort(-total_scores):
        pred_class = int(total_labels[k])
        isthing = pred_class < num_things
        if isthing and total_scores[k] < object_mask_thr:
            continue
        mask = cur_mask_ids == k
        mask_area = int(mask.sum())
        original_area = int((total_masks[k] >= 0.5).sum())
        if mask_area > 0 and original_area > 0:
            if mask_area / original_area < overlap_thr:
                continue
            segment_id += 1
            if not isthing:
                pan[mask] = pred_class
            else:
                pan[mask] = pred_class + segment_id * INSTANCE_OFFSET
    return pan


def panoptic_fusion(mode, cls_logits, mask_logits, num_things, num_classes,
                    **kw):
    """Dispatch mirroring the reference's simple_test (:527-545). Returns
    (pan_seg, query_list) — query_list empty for non-query modes."""
    if mode == "with_query":
        return panoptic_with_query(
            cls_logits, mask_logits, num_things, num_classes, **kw)
    if mode == "sort_with_query":
        kw.setdefault("object_mask_thr", 0.3)
        kw.setdefault("iou_thr", kw.pop("overlap_thr", 0.6))
        return panoptic_with_query(
            cls_logits, mask_logits, num_things, num_classes, sort=True, **kw)
    if mode == "sort":
        return panoptic_sort(
            cls_logits, mask_logits, num_things, num_classes, **kw), []
    if mode == "sem_seg_only_with_query":
        return panoptic_sem_seg_only_with_query(
            cls_logits, mask_logits, num_things, num_classes)
    if mode == "sperate_focal":
        return panoptic_sperate_focal(
            cls_logits, mask_logits, num_things, num_classes, **kw), []
    raise ValueError(f"unknown panoptic mode {mode!r}")


def mask2box(masks):
    """(N, h, w) bool -> (N, 4) xyxy float (mmdet ``tensor_mask2box``)."""
    out = np.zeros((len(masks), 4), np.float32)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(ys):
            out[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return out
