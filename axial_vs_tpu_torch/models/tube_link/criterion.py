"""Tube-Link (Mask2Former) losses (counterpart of
``axial_vs_tpu/models/tube_link/criterion.py``): a Hungarian assignment on
[class cost x2, point-sampled sigmoid-BCE mask cost x5, dice cost x5], then
for each decoder layer a softmax CE with background weight 0.1, an
uncertainty-sampled point BCE (PointRend-style: of 3x oversampled random
candidates, the 0.75 most uncertain, the rest uniform) and a dice loss, each
over the batch's valid GT count.

Tube masks: predictions (B, T, Q, H, W), GT (B, M, T, H, W); the points are
drawn over each tube's flattened (T, H, W) space. The match cost and every
loss are computed in f32, whatever the outputs' dtype. Every random draw
goes through ``_randint``, in the JAX module's order: per layer the match
points, then for each point sampling its candidates and its uniform rest.

Targets are padded to M GT slots: "labels" (B, M) int, "masks" (B, M, T, H,
W) binary, "valid" (B, M) bool.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.hungarian import hungarian_assign


def _randint(generator, shape, high: int, device):
    """int64 draws, uniform on [0, high), of ``shape`` from ``generator``
    (the criterion's only source of randomness)."""
    return torch.randint(0, high, tuple(shape), generator=generator,
                         device=device)


def _sample_points(masks_flat, point_idx):
    """masks_flat (B, N, S); point_idx (B, P) -> (B, N, P)."""
    return torch.gather(masks_flat, 2, point_idx[:, None, :].expand(
        -1, masks_flat.shape[1], -1))


def _dice_loss(pred, target, eps=1e-3):
    """Naive dice on sampled points: pred sigmoid probabilities (..., P)."""
    num = 2 * (pred * target).sum(-1)
    den = pred.sum(-1) + target.sum(-1)
    return 1 - (num + eps) / (den + eps)


@torch.no_grad()
def uncertainty_point_idx(generator, mask_logits, num_points: int,
                          oversample: float = 3.0, importance: float = 0.75):
    """(B, num_points) indices into the flattened (B, S) ``mask_logits``:
    the ``importance`` fraction from the most uncertain (|logit| smallest)
    of ``oversample`` x random candidates, ties to the earlier candidate as
    ``jax.lax.top_k`` breaks them, the rest uniform."""
    b, s = mask_logits.shape
    n_imp = int(num_points * importance)
    dev = mask_logits.device
    cand = _randint(generator, (b, int(num_points * oversample)), s, dev)
    unc = -torch.gather(mask_logits, 1, cand).abs()
    top = torch.sort(unc, dim=1, descending=True,
                     stable=True).indices[:, :n_imp]
    rand_idx = _randint(generator, (b, num_points - n_imp), s, dev)
    return torch.cat([torch.gather(cand, 1, top), rand_idx], 1)


class TubeLinkCriterion:
    """``stuff_fixed=True`` (the reference's "no-stuff-match" VPS heads):
    queries [0, Q - num_stuff) are matched against the thing GTs only, and
    stuff class k is pinned to query Q - num_stuff + k (dense targets, no
    assignment). ``loss_split=True`` then keeps separate ``thing_`` and
    ``stuff_`` loss keys. ``exact_matching`` picks the assignment's solver:
    scipy on the host, or the device auction (``ops/hungarian.py``)."""

    def __init__(self, num_things, num_stuff=0, cls_weight=2.0, mask_weight=5.0,
                 dice_weight=5.0, bg_cls_weight=0.1, num_points=12544,
                 oversample=3.0, importance=0.75, match_points=12544,
                 exact_matching=True, stuff_fixed=False, loss_split=False):
        self.num_things = num_things
        self.num_stuff = num_stuff
        self.num_classes = num_things + num_stuff
        self.cls_weight = cls_weight
        self.mask_weight = mask_weight
        self.dice_weight = dice_weight
        self.bg_cls_weight = bg_cls_weight
        self.num_points = num_points
        self.oversample = oversample
        self.importance = importance
        self.match_points = match_points
        self.exact_matching = exact_matching
        self.stuff_fixed = stuff_fixed and num_stuff > 0
        self.loss_split = loss_split

    def _weighted(self, loss_cls, loss_mask, loss_dice):
        return {"loss_cls": self.cls_weight * loss_cls,
                "loss_mask": self.mask_weight * loss_mask,
                "loss_dice": self.dice_weight * loss_dice}

    @torch.no_grad()
    def _match(self, generator, cls_pred, masks_flat, gt_flat, gt_labels,
               valid):
        """cls_pred (B, Q, K+1); masks_flat (B, Q, S); gt_flat (B, M, S)."""
        b, q, s = masks_flat.shape
        pts = _randint(generator, (b, min(self.match_points, s)), s,
                       masks_flat.device)
        pm = _sample_points(masks_flat, pts).float()
        gm = _sample_points(gt_flat, pts)
        prob = torch.softmax(cls_pred.float(), -1)
        labels = gt_labels.long().clamp(0, self.num_classes)
        cls_cost = -torch.gather(prob, 2, labels[:, None, :].expand(-1, q, -1))
        bce = (torch.einsum("bqp,bmp->bqm", F.softplus(pm), gm)
               + torch.einsum("bqp,bmp->bqm", F.softplus(-pm) + pm, 1 - gm)
               ) / pm.shape[-1]
        p = torch.sigmoid(pm)
        num = 2 * torch.einsum("bqp,bmp->bqm", p, gm)
        den = p.sum(-1)[:, :, None] + gm.sum(-1)[:, None, :]
        dice_cost = 1 - (num + 1e-3) / (den + 1e-3)
        cost = (self.cls_weight * cls_cost + self.mask_weight * bce
                + self.dice_weight * dice_cost)
        cost = torch.where(valid[:, None, :], cost, torch.zeros_like(cost))
        return hungarian_assign(cost, valid, exact=self.exact_matching)

    def _point_losses(self, generator, slots, gt, present, count):
        """The point BCE and dice of ``slots`` (B, K, S) logits against
        ``gt`` (B, K, S), each slot where ``present`` (B, K), over
        ``count``."""
        b, k, s = slots.shape
        pts = uncertainty_point_idx(
            generator, slots.detach().reshape(-1, s),
            min(self.num_points, s), self.oversample,
            self.importance).reshape(b, k, -1)
        pp = torch.gather(slots, 2, pts).float()
        gp = torch.gather(gt, 2, pts)
        # numerically stable BCE with logits: softplus(-x) for target 1,
        # softplus(x) for target 0
        bce = F.softplus(torch.where(gp > 0, -pp, pp))
        bce = torch.where(present[:, :, None], bce, torch.zeros_like(bce))
        loss_mask = bce.sum() / (count * pp.shape[-1])
        dice = _dice_loss(torch.sigmoid(pp), gp)
        loss_dice = torch.where(present, dice, torch.zeros_like(dice)).sum()
        return loss_mask, loss_dice / count

    def _stuff_dense_loss(self, generator, cls_pred, masks_flat, gt_flat,
                          labels, valid):
        """The pinned stuff slots (no assignment): stuff class k is
        predicted by the k-th of the last ``num_stuff`` queries."""
        q = masks_flat.shape[1]
        ns = self.num_stuff
        dev = masks_flat.device
        labels = labels.long()
        onehot = ((labels[:, :, None] - self.num_things
                   == torch.arange(ns, device=dev)[None, None, :])
                  & valid[:, :, None]
                  & (labels[:, :, None] >= self.num_things))  # (B, M, ns)
        present = onehot.any(1)  # (B, ns)
        stuff_gt = torch.einsum("bmk,bms->bks", onehot.float(),
                                gt_flat).clamp_max(1.0)
        tgt = torch.where(present,
                          torch.arange(ns, device=dev)[None, :] + self.num_things,
                          torch.full_like(present, self.num_classes,
                                          dtype=torch.long))
        loss_cls = self._class_loss(cls_pred[:, q - ns:], tgt)
        num_pos = present.sum().float().clamp_min(1.0)
        loss_mask, loss_dice = self._point_losses(
            generator, masks_flat[:, q - ns:], stuff_gt, present, num_pos)
        return self._weighted(loss_cls, loss_mask, loss_dice)

    def _class_loss(self, cls_pred, tgt):
        """Softmax CE, the background class weighted ``bg_cls_weight``."""
        logp = F.log_softmax(cls_pred.float(), -1)
        ce = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        cls_w = torch.where(tgt == self.num_classes,
                            torch.full_like(ce, self.bg_cls_weight),
                            torch.ones_like(ce))
        return (ce * cls_w).sum() / cls_w.sum().clamp_min(1.0)

    def _layer_loss_matched(self, generator, cls_pred, masks_flat, gt_flat,
                            labels, valid):
        """The matched losses of one layer and its assignment (B, M)."""
        b, q, _ = masks_flat.shape
        assign = self._match(generator, cls_pred, masks_flat, gt_flat, labels,
                             valid)
        safe = assign.clamp_min(0)
        # the assigned slots get the GT labels, the rest background (an
        # invalid GT writes into the dropped column q)
        slot = torch.where(valid, safe, torch.full_like(safe, q))
        tgt = torch.full((b, q + 1), self.num_classes, dtype=torch.long,
                         device=cls_pred.device).scatter(
            1, slot, labels.long())[:, :q]
        loss_cls = self._class_loss(cls_pred, tgt)
        matched = masks_flat[torch.arange(b, device=safe.device)[:, None],
                             safe]  # (B, M, S)
        num_gt = valid.sum().float().clamp_min(1.0)
        loss_mask, loss_dice = self._point_losses(generator, matched, gt_flat,
                                                  valid, num_gt)
        return self._weighted(loss_cls, loss_mask, loss_dice), assign

    def _layer_loss(self, generator, cls_pred, mask_pred, targets):
        """mask_pred (B, T, Q, H, W). Returns the layer's losses and its
        (thing) assignment."""
        b, _, q = mask_pred.shape[:3]
        masks_flat = mask_pred.transpose(1, 2).reshape(b, q, -1)
        gt = targets["masks"].float()
        gt_flat = gt.reshape(b, gt.shape[1], -1)
        valid, labels = targets["valid"].bool(), targets["labels"]
        if not self.stuff_fixed:
            return self._layer_loss_matched(generator, cls_pred, masks_flat,
                                            gt_flat, labels, valid)
        # things: matched over the first Q - num_stuff slots and the thing
        # GTs; stuff: the dense pinned-slot targets (terms of their own)
        q_th = q - self.num_stuff
        th, assign = self._layer_loss_matched(
            generator, cls_pred[:, :q_th], masks_flat[:, :q_th], gt_flat,
            labels, valid & (labels < self.num_things))
        st = self._stuff_dense_loss(generator, cls_pred, masks_flat, gt_flat,
                                    labels, valid)
        if self.loss_split:
            out = {f"thing_{k}": v for k, v in th.items()}
            out.update({f"stuff_{k}": v for k, v in st.items()})
        else:
            out = {k: th[k] + st[k] for k in th}
        return out, assign

    def __call__(self, outputs, targets, generator, return_assign=False):
        """outputs: "cls_preds" [(B, Q, K+1)] and "mask_preds" [(B, T, Q, H,
        W)], one per layer; the last layer's losses keep their names, the
        others are prefixed ``d{i}.``. With ``return_assign`` also the last
        layer's (thing) assignment (B, M): the query of each GT, -1 where
        invalid."""
        losses, assign = {}, None
        n_layers = len(outputs["cls_preds"])
        for i, (cls_pred, mask_pred) in enumerate(
                zip(outputs["cls_preds"], outputs["mask_preds"])):
            out, assign = self._layer_loss(generator, cls_pred, mask_pred,
                                           targets)
            if i == n_layers - 1:
                losses.update(out)
            else:
                losses.update({f"d{i}.{k}": v for k, v in out.items()})
        return (losses, assign) if return_assign else losses

    def total(self, losses):
        return sum(losses.values())

    #: the trainer's interface: the weights are inside the terms
    weighted_total = total
