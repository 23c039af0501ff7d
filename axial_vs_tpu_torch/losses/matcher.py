"""Hungarian matcher: the PQ-style similarity cost, batched (counterpart of
``axial_vs_tpu/losses/matcher.py``).

cost = -(mask dice-similarity x class probability), with void pixels masked
out of the prediction before the dice; the matched dice and class
probability are returned as the PQ-loss weights. Everything runs under
``torch.no_grad()`` in f32; only the assignment itself goes to the host
(``ops/hungarian.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.hungarian import hungarian_assign


class MatchResult(NamedTuple):
    assignment: torch.Tensor        # (B, M) int64: query per GT (-1 invalid)
    matched_dice: torch.Tensor      # (B, M) f32 (0 for invalid)
    matched_cls_prob: torch.Tensor  # (B, M) f32 (0 for invalid)


def compute_mask_similarity(pred_masks, gt_masks, masking_void_pixel=True):
    """Dice-style similarity (B, N, M). pred_masks (B, N, S) logits (S =
    every pixel, T folded in); gt_masks (B, M, S) binary."""
    eps = 1e-5
    prob = torch.softmax(pred_masks.float(), 1)  # over the slots
    gt = gt_masks.float()
    if masking_void_pixel:
        prob = prob * (gt.sum(1, keepdim=True) > 0).float()
    intersection = torch.einsum("bns,bms->bnm", prob, gt)
    denom = (prob.sum(-1)[:, :, None] + gt.sum(-1)[:, None, :]) / 2.0
    return intersection / (denom + eps)


def compute_class_similarity(pred_logits, gt_labels):
    """(B, N, M): the predicted probability of each GT's class (void
    excluded)."""
    prob = torch.softmax(pred_logits.float(), -1)[..., :-1]
    idx = gt_labels.long().clamp(0, prob.shape[-1] - 1)
    return torch.gather(prob, 2, idx[:, None, :].expand(-1, prob.shape[1], -1))


def flatten_masks(pred_masks, n: int):
    """(B, [T,] H, W, N) channels-last, or already (B, N, S) -> (B, N, S)."""
    b = pred_masks.shape[0]
    if pred_masks.ndim > 3 or pred_masks.shape[1] != n:
        pred_masks = torch.movedim(pred_masks, -1, 1).reshape(b, n, -1)
    return pred_masks


@torch.no_grad()
def hungarian_match(outputs, targets, masking_void_pixel=True):
    """outputs: "pred_logits" (B, N, C+1), "pred_masks" (B, [T,] H, W, N)
    or (B, N, S); targets: "labels" (B, M), "masks" (B, M, [T,] H, W)
    binary, "valid" (B, M) bool."""
    pred_logits = outputs["pred_logits"]
    b, n = pred_logits.shape[:2]
    pred_masks = flatten_masks(outputs["pred_masks"], n)
    gt_masks = targets["masks"].reshape(b, targets["masks"].shape[1], -1)
    valid = targets["valid"]

    class_sim = compute_class_similarity(pred_logits, targets["labels"])
    mask_sim = compute_mask_similarity(pred_masks, gt_masks,
                                       masking_void_pixel)
    cost = torch.where(valid[:, None, :], -(mask_sim * class_sim),
                       torch.zeros_like(mask_sim))
    assignment = hungarian_assign(cost, valid)
    safe = assignment.clamp_min(0)
    zero = torch.zeros((), device=cost.device)
    matched_dice = torch.where(valid, _gather_matched(mask_sim, safe), zero)
    matched_cls = torch.where(valid, _gather_matched(class_sim, safe), zero)
    return MatchResult(assignment, matched_dice, matched_cls)


def _gather_matched(sim, assignment):
    """sim (B, N, M), assignment (B, M) -> (B, M): sim[b, assignment[b, j], j]."""
    return torch.gather(sim, 1, assignment[:, None, :]).squeeze(1)
