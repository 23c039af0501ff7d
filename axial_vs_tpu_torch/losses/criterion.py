"""PQ-style set criterion for the within-clip model (counterpart of
``axial_vs_tpu/losses/criterion.py``), in f32:

- class loss: focal CE (alpha 0.75, gamma 0) weighted per slot by the
  matched mask dice (``pq_loss_class_weight``);
- mask losses: softmax CE over the mask-slot axis + dice (times the matched
  class probability), void pixels masked;
- pixel-wise instance discrimination: a Gumbel-top-k sample of pixels
  (weighted by inverse GT-mask area), contrastive at temperature 0.3;
- auxiliary semantic CE over a Gumbel-top-k sample of pixels;
- ``process_gt`` scatters the matched GT into the N query slots, gives the
  unmatched slots the void class with weight clamp(IoU with void, eos_coef),
  and builds the void mask and the inverse-area map, under no_grad.

Targets are padded to M GT slots with a validity mask: "labels" (B, M),
"masks" (B, M, T, H, W) binary, "valid" (B, M) bool, and optionally
"semantic_masks" (B, T, H, W) with -1 for void. The Gumbel samples draw
from the ``torch.Generator`` of the step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .matcher import flatten_masks, hungarian_match

_MASKING_CONSTANT = -99999.0


def _divide_no_nan(x, y):
    r = x / y
    return torch.where(torch.isfinite(r), r, torch.zeros_like(r))


def _mean_over_nonzero(loss):
    """Sum over the last axis / its count of non-zeros (at least 1), then
    the mean over the batch."""
    count = (loss != 0.0).sum(-1).float().clamp_min(1.0)
    return _divide_no_nan(loss.sum(-1), count).mean()


def focal_cross_entropy_loss(pred, gt, weight, focal_alpha=0.75,
                             focal_gamma=0.0):
    """pred (B, N, C); gt (B, N) int; weight (B, N)."""
    logp = F.log_softmax(pred.float(), -1)
    gt = gt.long()
    loss = -logp.gather(-1, gt[..., None])[..., 0]
    if focal_gamma != 0.0:
        pt = torch.softmax(pred.float(), -1).gather(-1, gt[..., None])[..., 0]
        loss = (1.0 - pt) ** focal_gamma * loss
    if focal_alpha >= 0:
        is_void = (gt == pred.shape[-1] - 1).float()
        loss = (focal_alpha * (1.0 - is_void)
                + (1 - focal_alpha) * is_void) * loss
    return _mean_over_nonzero(loss * weight)


def softmax_ce_loss(mask_logits, target_masks, pixel_gt_void_mask):
    """CE over the mask-slot axis: mask_logits, target (B, N, S); void
    (B, S)."""
    logp = F.log_softmax(mask_logits.float(), 1)
    loss = -(target_masks * logp).sum(1)
    loss = torch.where(pixel_gt_void_mask, torch.zeros_like(loss), loss)
    return _mean_over_nonzero(loss)


def dice_loss(mask_logits, target_masks, pixel_gt_void_mask, matched_cls_prob,
              masking_void_pixel=True):
    """(B, N, S) inputs: (1 - dice) x class probability, x 0.75 / N."""
    prob = torch.softmax(mask_logits.float(), 1)
    if masking_void_pixel:
        prob = torch.where(pixel_gt_void_mask[:, None, :],
                           torch.zeros_like(prob), prob)
    smooth = 1.0
    intersection = 2 * (prob * target_masks).sum(-1) + smooth
    denom = prob.sum(-1) + target_masks.sum(-1) + smooth
    loss = (1.0 - _divide_no_nan(intersection, denom)) * matched_cls_prob
    return (loss.sum(1) * 0.75 / mask_logits.shape[1]).mean()


def gumbel_topk(generator, logits, k: int):
    """Indices of the k largest of logits + Gumbel noise, drawn from
    ``generator`` (uniform on [1e-20, 1))."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u * (1.0 - 1e-20) + 1e-20
    return torch.topk(logits - torch.log(-torch.log(u)), k, -1).indices


def _sample_logits(inverse_gt_mask_area, pixel_gt_void_mask, temperature):
    return (torch.log(inverse_gt_mask_area) * temperature
            + pixel_gt_void_mask.float() * _MASKING_CONSTANT)


def pixelwise_insdis_loss(generator, pixel_feature, gt_masks,
                          pixel_gt_void_mask, inverse_gt_mask_area,
                          sample_temperature=1.5, sample_k=4096,
                          insdis_temperature=0.3):
    """pixel_feature (B, S, C); gt_masks (B, N, S)."""
    logits = _sample_logits(inverse_gt_mask_area, pixel_gt_void_mask,
                            sample_temperature)
    idx = gumbel_topk(generator, logits, min(sample_k, logits.shape[-1]))
    gt_s = torch.gather(gt_masks, 2,
                        idx[:, None, :].expand(-1, gt_masks.shape[1], -1))
    gt_sim = torch.einsum("bnk,bnj->bkj", gt_s, gt_s)
    gt_sim = gt_sim / gt_sim.sum(1, keepdim=True).clamp_min(1.0)
    feat = pixel_feature.float()
    feat_s = torch.gather(feat, 1, idx[:, :, None].expand(-1, -1,
                                                          feat.shape[-1]))
    pred_sim = torch.einsum("bkc,bjc->bkj", feat_s, feat_s) / insdis_temperature
    loss = -(gt_sim * F.log_softmax(pred_sim, 1)).sum(1)
    return _mean_over_nonzero(loss)


def aux_semantic_loss(generator, pred_logits, gt_semantic, pixel_gt_void_mask,
                      inverse_gt_mask_area, num_classes, sample_temperature=2.0,
                      sample_k=4096):
    """pred_logits (B, S, C+1); gt_semantic (B, S) with ignore =
    num_classes."""
    if sample_k and sample_k > 0:
        logits = _sample_logits(inverse_gt_mask_area, pixel_gt_void_mask,
                                sample_temperature)
        idx = gumbel_topk(generator, logits, min(sample_k, logits.shape[-1]))
        gt_s = torch.gather(gt_semantic, 1, idx)
        pred_s = torch.gather(pred_logits, 1, idx[:, :, None].expand(
            -1, -1, pred_logits.shape[-1]))
    else:
        gt_s, pred_s = gt_semantic, pred_logits
    logp = F.log_softmax(pred_s.float(), -1)
    loss = -logp.gather(-1, gt_s.long().clamp(0, num_classes)[..., None])[..., 0]
    loss = torch.where(gt_s != num_classes, loss, torch.zeros_like(loss))
    return _mean_over_nonzero(loss)


def _scatter_slots(values, assignment, valid, n, fill):
    """(B, N) with values[b, j] at slot assignment[b, j] of each valid j,
    ``fill`` elsewhere."""
    b = values.shape[0]
    out = torch.full((b, n + 1), fill, dtype=values.dtype,
                     device=values.device)
    idx = torch.where(valid, assignment, torch.full_like(assignment, n))
    return out.scatter(1, idx, values)[:, :n]


def process_gt(outputs, targets, match, num_classes, eos_coef=1e-5):
    """Scatter the matched GT into the N query slots (the reference's
    ``criterion.py:328-406``)."""
    b, n = outputs["pred_logits"].shape[:2]
    pred_masks_bns = flatten_masks(outputs["pred_masks"], n)
    s = pred_masks_bns.shape[-1]
    with torch.no_grad():
        gt_masks = targets["masks"].reshape(b, targets["masks"].shape[1], s)
        valid = targets["valid"]
        assignment = match.assignment.clamp_min(0)
        gt = torch.where(valid[:, :, None], gt_masks.float(),
                         torch.zeros((), device=gt_masks.device))
        tgt_masks = torch.zeros(b, n, s, device=gt.device).scatter_add_(
            1, assignment[:, :, None].expand(-1, -1, s), gt)
        tgt_classes = _scatter_slots(targets["labels"].long(), assignment,
                                     valid, n, num_classes)
        cls_w = _scatter_slots(match.matched_cls_prob.clamp_min(eos_coef),
                               assignment, valid, n, 0.0)
        pixel_gt_void = tgt_masks.sum(1) < 1  # (B, S)
        pixel_gt_area = torch.einsum("bns,bn->bs", tgt_masks,
                                     tgt_masks.sum(2))
        inverse_area = s / pixel_gt_area.clamp_min(1.0)
        # unmatched slots: dice weight = IoU with the void region
        prob = torch.softmax(pred_masks_bns.detach().float(), 1)
        void_iou = (torch.einsum("bns,bs->bn", prob, pixel_gt_void.float())
                    / (prob.sum(-1) + 1e-5))
        idx = torch.where(valid, assignment, torch.full_like(assignment, n))
        dice_w = torch.cat([void_iou, void_iou.new_zeros(b, 1)], 1).scatter(
            1, idx, match.matched_dice)[:, :n].clamp_min(eos_coef)
        out = {
            "masks": tgt_masks,
            "labels": tgt_classes,
            "pq_loss_mask_weight": cls_w,
            "pq_loss_class_weight": dice_w,
            "pixel_gt_void_mask": pixel_gt_void,
            "inverse_gt_mask_area": inverse_area,
        }
        if "semantic_masks" in targets:
            sem = targets["semantic_masks"].reshape(b, -1).long()
            out["ground_truth_semantic"] = torch.where(
                sem == -1, torch.full_like(sem, num_classes), sem)
    out["pred_masks_bns"] = pred_masks_bns
    return out


class SetCriterion:
    """The PQ losses of one step; ``weights`` maps a loss name to its
    weight in ``weighted_total``."""

    def __init__(self, num_classes, weights=None, eos_coef=1e-5,
                 share_final_matching=True, pixel_insdis_temperature=1.5,
                 pixel_insdis_sample_k=4096, aux_semantic_temperature=2.0,
                 aux_semantic_sample_k=4096, masking_void_pixel=True,
                 losses=("labels", "masks", "pixels", "aux_semantic")):
        self.num_classes = num_classes
        self.weights = weights or {}
        self.eos_coef = eos_coef
        self.share_final_matching = share_final_matching
        self.pixel_insdis_temperature = pixel_insdis_temperature
        self.pixel_insdis_sample_k = pixel_insdis_sample_k
        self.aux_semantic_temperature = aux_semantic_temperature
        self.aux_semantic_sample_k = aux_semantic_sample_k
        self.masking_void_pixel = masking_void_pixel
        self.losses = losses

    def _losses_for(self, generator, outputs, processed, with_semantic):
        out = {}
        if "labels" in self.losses:
            out["loss_ce"] = focal_cross_entropy_loss(
                outputs["pred_logits"], processed["labels"],
                processed["pq_loss_class_weight"])
        if "masks" in self.losses:
            out["loss_mask"] = softmax_ce_loss(
                processed["pred_masks_bns"], processed["masks"],
                processed["pixel_gt_void_mask"])
            out["loss_dice"] = dice_loss(
                processed["pred_masks_bns"], processed["masks"],
                processed["pixel_gt_void_mask"],
                processed["pq_loss_mask_weight"], self.masking_void_pixel)
        if "pixels" in self.losses and "pixel_feature" in outputs:
            feat = outputs["pixel_feature"]
            out["loss_pixel_insdis"] = pixelwise_insdis_loss(
                generator, feat.reshape(feat.shape[0], -1, feat.shape[-1]),
                processed["masks"], processed["pixel_gt_void_mask"],
                processed["inverse_gt_mask_area"],
                self.pixel_insdis_temperature, self.pixel_insdis_sample_k)
        if (with_semantic and "aux_semantic" in self.losses
                and "aux_semantic_pred" in outputs
                and "ground_truth_semantic" in processed):
            sem = outputs["aux_semantic_pred"]
            out["loss_aux_semantic"] = aux_semantic_loss(
                generator, sem.reshape(sem.shape[0], -1, sem.shape[-1]),
                processed["ground_truth_semantic"],
                processed["pixel_gt_void_mask"],
                processed["inverse_gt_mask_area"], self.num_classes,
                self.aux_semantic_temperature, self.aux_semantic_sample_k)
        return out

    def __call__(self, outputs, targets, generator):
        """outputs: the model's dict; targets: the padded dict (module
        docstring). Returns {loss name: scalar}, the aux layers' losses
        suffixed ``_i``.

        Targets on the ceil(size / 4) grid lose their trailing row or
        column where the model predicts on the floor(size / 4) grid (a
        VALID-stem backbone at a crop that is not a multiple of 4)."""
        gt_sp = tuple(targets["masks"].shape[2:])
        pr_sp = tuple(outputs["pred_masks"].shape[1:-1])
        if len(gt_sp) == len(pr_sp) and gt_sp != pr_sp and all(
                0 <= g - p <= 1 for g, p in zip(gt_sp, pr_sp)):
            sl = (slice(None), slice(None)) + tuple(slice(0, p) for p in pr_sp)
            targets = dict(targets, masks=targets["masks"][sl])
            if "semantic_masks" in targets:
                sem = targets["semantic_masks"]
                targets["semantic_masks"] = sem[
                    (slice(None),) * (sem.ndim - 2)
                    + (slice(0, pr_sp[-2]), slice(0, pr_sp[-1]))]
        match = hungarian_match(outputs, targets, self.masking_void_pixel)
        processed = process_gt(outputs, targets, match, self.num_classes,
                               self.eos_coef)
        losses = self._losses_for(generator, outputs, processed, True)
        for i, aux in enumerate(outputs.get("aux_outputs", [])):
            if not self.share_final_matching:
                match = hungarian_match(aux, targets, self.masking_void_pixel)
            processed_aux = process_gt(aux, targets, match, self.num_classes,
                                       self.eos_coef)
            # the GT semantic is used on the final output only
            aux_losses = self._losses_for(generator, aux, processed_aux, False)
            losses.update({f"{k}_{i}": v for k, v in aux_losses.items()})
        return losses

    def weighted_total(self, losses):
        total = 0.0
        for k, v in losses.items():
            base = k.rsplit("_", 1)[0] if k[-1].isdigit() else k
            if base in self.weights:
                total = total + self.weights[base] * v
        return total
