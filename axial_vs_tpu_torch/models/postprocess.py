"""Panoptic, semantic and instance inference on device tensors (counterpart
of ``axial_vs_tpu/models/postprocess.py``).

Slots are visited in reorder-score order; the claimed-pixel map, the running
segment counter and the per-class stuff-segment table stay on the device, and
each slot's confidence gate, overlap gate and stuff merge are ``torch.where``
selections, so the loop of N steps never waits for the device (the JAX
package runs the same step as a ``lax.scan``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class PanopticOutput(NamedTuple):
    panoptic_seg: torch.Tensor      # (..., H, W) int32, 0 = void/unassigned
    segment_valid: torch.Tensor     # (N,) bool: the slot opened a new segment
    segment_id: torch.Tensor        # (N,) int32: its id (0 if not valid)
    segment_category: torch.Tensor  # (N,) int32: contiguous class label
    segment_isthing: torch.Tensor   # (N,) bool
    slot_index: torch.Tensor        # (N,) int32: original mask-slot index
    accepted: torch.Tensor          # (N,) bool: the slot contributed pixels


def panoptic_inference(mask_cls, mask_pred, thing_class_mask,
                       pixel_confidence_threshold: float = 0.4,
                       class_threshold_thing: float = 0.7,
                       class_threshold_stuff: float = 0.5,
                       overlap_threshold: float = 0.8,
                       reorder_class_weight: float = 1.0,
                       reorder_mask_weight: float = 1.0) -> PanopticOutput:
    """kMaX panoptic post-processing.

    mask_cls (N, C+1) class logits (last = void); mask_pred (..., H, W, N)
    mask logits, leading dims (e.g. T) allowed: the softmax over slots and
    every gate work on the whole (..., H, W) tube; thing_class_mask (C,)
    bool, on mask_pred's device. The slot arrays follow the visit order."""
    n = mask_pred.shape[-1]
    dev = mask_pred.device
    cls_prob = F.softmax(mask_cls.float(), -1)[..., :-1]
    cls_scores = cls_prob.max(-1).values
    cls_labels = cls_prob.argmax(-1).int()

    mask_scores = F.softmax(mask_pred.float(), -1)
    binary = mask_scores > pixel_confidence_threshold  # (..., H, W, N)
    spatial = tuple(range(binary.ndim - 1))
    pixel_count = binary.sum(spatial, dtype=torch.float32)
    # the scores under the threshold zeroed in place: the values of
    # mask_scores * binary without another full-size tensor
    mask_conf = (mask_scores.masked_fill_(~binary, 0.0).sum(spatial)
                 / pixel_count.clamp_min(1.0))
    del mask_scores
    reorder_score = (cls_scores ** reorder_class_weight
                     * mask_conf ** reorder_mask_weight)
    order = torch.argsort(-reorder_score, stable=True)

    is_thing = thing_class_mask[cls_labels.long()]
    confident = torch.where(is_thing, cls_scores > class_threshold_thing,
                            cls_scores > class_threshold_stuff)
    # slot-major and contiguous: each step reads one slot's mask densely
    binary_by_slot = binary.movedim(-1, 0)[order].contiguous()
    del binary
    labels, things, confs = (t[order] for t in (cls_labels, is_thing, confident))

    panoptic = torch.zeros(mask_pred.shape[:-1], dtype=torch.int32, device=dev)
    counter = torch.zeros((), dtype=torch.int32, device=dev)
    stuff_table = torch.zeros(thing_class_mask.shape[0], dtype=torch.int32,
                              device=dev)
    new_segment = torch.empty(n, dtype=torch.bool, device=dev)
    accepted = torch.empty(n, dtype=torch.bool, device=dev)
    segment_id = torch.empty(n, dtype=torch.int32, device=dev)
    for i in range(n):
        cur = binary_by_slot[i]
        label, thing = labels[i].long(), things[i]
        new_mask = cur & (panoptic == 0)
        orig_n = cur.sum(dtype=torch.float32)
        new_n = new_mask.sum(dtype=torch.float32)
        accept = confs[i] & (new_n > orig_n * overlap_threshold)
        stuff_prev = stuff_table[label]
        merge = accept & ~thing & (stuff_prev > 0)
        new_seg = accept & ~merge
        counter = counter + new_seg.int()
        panoptic = torch.where(new_mask & accept,
                               torch.where(merge, stuff_prev, counter), panoptic)
        stuff_table[label] = torch.where(new_seg & ~thing, counter, stuff_prev)
        new_segment[i] = new_seg
        accepted[i] = accept
        segment_id[i] = torch.where(new_seg, counter, 0)
    return PanopticOutput(
        panoptic_seg=panoptic, segment_valid=new_segment,
        segment_id=segment_id, segment_category=labels,
        segment_isthing=things, slot_index=order.int(), accepted=accepted)


def remap_panoptic_to_dataset_ids(result: PanopticOutput,
                                  contiguous_to_dataset_id, label_divisor: int):
    """Map segment ids to dataset panoptic ids (the video evaluator's
    format): things get ``cat_id * label_divisor + instance_index`` (the
    instance index counts accepted things of that category in acceptance
    order), stuff gets ``cat_id``; unassigned pixels get -1.

    contiguous_to_dataset_id: (C,) int tensor on the result's device.
    Returns (panoptic_ids (..., H, W) int32, per-segment new ids (N,) int32)."""
    valid = result.segment_valid
    n = valid.shape[0]
    cat = result.segment_category
    cat_dataset = contiguous_to_dataset_id[cat.long()].int()
    valid_thing = valid & result.segment_isthing
    same_cat = cat[None, :] == cat[:, None]
    earlier = torch.ones(n, n, dtype=torch.bool, device=valid.device).tril(-1)
    inst_idx = (same_cat & earlier & valid_thing[None, :]).sum(1).int()
    new_ids = torch.where(valid_thing, cat_dataset * label_divisor + inst_idx,
                          torch.where(valid, cat_dataset, 0)).int()
    # lookup over segment ids 1..N; 0 (void) -> -1
    table = torch.full((n + 1,), -1, dtype=torch.int32, device=valid.device)
    table[torch.where(valid, result.segment_id, 0).long()] = torch.where(
        valid, new_ids, -1)
    table[0] = -1
    return table[result.panoptic_seg.long()], new_ids


def semantic_inference(mask_cls, mask_pred):
    """Per-pixel class probabilities: the softmax over slots of mask_pred
    (..., H, W, N) weighting the class softmax of mask_cls (N, C+1) without
    void. Returns (..., H, W, C) f32."""
    cls_prob = F.softmax(mask_cls.float(), -1)[..., :-1]
    mask_prob = F.softmax(mask_pred.float(), -1)
    return torch.einsum("...n,nc->...c", mask_prob, cls_prob)


def instance_inference(mask_cls, mask_pred, thing_class_mask, topk: int,
                       pixel_confidence_threshold: float = 0.4) -> dict:
    """Top-k (slot, class) pairs of the class softmax (without void) of
    mask_cls (N, C+1), their masks from the softmax over slots of mask_pred
    (..., H, W, N). Equal scores are taken in the order of their flat index
    slot * C + class (a stable descending sort), as ``jax.lax.top_k``
    takes them. Returns {"pred_masks" (k, ..., H, W) bool (probability >
    the threshold), "scores" (k,) class score times the mean probability
    inside the mask, "pred_classes" (k,) int32, "is_thing" (k,) bool};
    non-thing classes are kept, flagged, as in the JAX function."""
    num_classes = mask_cls.shape[-1] - 1
    mask_prob = F.softmax(mask_pred.float(), -1)
    scores = F.softmax(mask_cls.float(), -1)[:, :-1]
    ranked = torch.sort(scores.reshape(-1), descending=True, stable=True)
    top_scores, top_index = ranked.values[:topk], ranked.indices[:topk]
    labels = top_index % num_classes
    masks = mask_prob.movedim(-1, 0)[top_index // num_classes]
    binary = masks > pixel_confidence_threshold
    axes = tuple(range(1, masks.ndim))
    mask_score = ((masks * binary).sum(axes)
                  / (binary.sum(axes, dtype=torch.float32) + 1e-6))
    return {"pred_masks": binary, "scores": top_scores * mask_score,
            "pred_classes": labels.int(),
            "is_thing": thing_class_mask[labels]}
