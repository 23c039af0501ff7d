"""VIPSeg evaluator: clip-wise re-ID stitching + PNG/JSON dump + VPQ
(counterpart of ``axial_vs_tpu/evaluation/vipseg_evaluator.py``).

- ``clip-wise`` results (per-clip panoptic id maps + per-category instance
  embeddings) are stitched into video-consistent ids by class-wise linear
  assignment on mask-embedding cosine distance with a ``cost_limit`` and an
  EMA memory (``mem_weight``) — the reference uses ``lap.lapjv(extend_cost,
  cost_limit)``; we emulate cost_limit exactly with scipy LSAP on a
  block-augmented cost matrix (a standard reduction).
- ``video-wise`` results (already whole-video consistent, from
  models/video_inference.py) skip straight to accumulation.
- Optionally writes panomask PNGs + a predictions JSON compatible with the
  offline metric CLIs, then computes VPQ@{1,2,4,6} and the mean.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..data.panoptic_utils import id2rgb
from .vpq import vpq_compute


def lap_with_cost_limit(cost: np.ndarray, cost_limit: float):
    """Row->col assignment where pairs with cost >= cost_limit stay
    unmatched. Returns (M,) col index per row, -1 if unmatched.

    Equivalent to lap.lapjv(extend_cost=True, cost_limit=...): augment the
    (M, N) matrix to (M+N, N+M) with cost_limit/2 on the dummy diagonal
    blocks so any real match costing more than cost_limit is dominated by
    two dummy assignments.
    """
    m, n = cost.shape
    big = cost_limit / 2.0
    aug = np.full((m + n, n + m), 0.0)
    aug[:m, :n] = cost
    aug[:m, n:] = np.inf
    aug[m:, :n] = np.inf
    np.fill_diagonal(aug[:m, n:], big)
    np.fill_diagonal(aug[m:, :n], big)
    rows, cols = linear_sum_assignment(aug)
    out = np.full(m, -1, np.int64)
    for r, c in zip(rows, cols):
        if r < m and c < n:
            out[r] = c
    return out


class VIPSegEvaluator:
    """Accumulates per-video predictions, stitches ids, computes VPQ."""

    def __init__(self, categories: Dict[int, dict], label_divisor: int = 10000,
                 cost_limit: float = 0.5, mem_weight: float = 0.0,
                 output_dir: str | None = None, num_workers: int = 0):
        self.categories = categories
        self.label_divisor = label_divisor
        self.cost_limit = cost_limit
        self.mem_weight = mem_weight
        self.output_dir = output_dir
        self.num_workers = num_workers  # VPQ's processes (0 or 1: this one)
        self._videos = []  # (gt_ids, pred_ids, gt_segments, pred_segments)

    # -- clip re-ID -----------------------------------------------------------
    def stitch_clips(self, clip_ids, clip_embeddings):
        """clip_ids: list of (T, H, W) id maps in dataset-id format
        (cat*divisor + instance for things, cat for stuff, -1 void);
        clip_embeddings: list of {cat_id: [normalized embedding per instance]}.
        Returns (V, H, W) stitched ids (ref :149-204)."""
        out = []
        mem: Dict[int, list] = {}
        for ids, embs in zip(clip_ids, clip_embeddings):
            if not embs:
                out.append(ids)
                continue
            if not mem:
                mem = {c: list(v) for c, v in embs.items()}
                out.append(ids)
                continue
            new_ids = ids.copy()
            for cls_id, cur_list in embs.items():
                if cls_id not in mem:
                    mem[cls_id] = list(cur_list)
                    continue
                mem_feat = np.stack(mem[cls_id], 0)
                cur_feat = np.stack(cur_list, 0)
                cos = cur_feat @ mem_feat.T
                dist = 1.0 - (cos + 1.0) / 2.0
                match = lap_with_cost_limit(dist, self.cost_limit)
                for cur_idx, mem_idx in enumerate(match):
                    point_id = cls_id * self.label_divisor + cur_idx
                    if mem_idx >= 0:
                        new_id = cls_id * self.label_divisor + mem_idx
                        new_ids[ids == point_id] = new_id
                        upd = (
                            mem[cls_id][mem_idx] * self.mem_weight
                            + cur_list[cur_idx] * (1 - self.mem_weight)
                        )
                        mem[cls_id][mem_idx] = upd / max(np.linalg.norm(upd), 1e-12)
                    else:
                        ins_id = len(mem[cls_id])
                        mem[cls_id].append(cur_list[cur_idx])
                        new_ids[ids == point_id] = cls_id * self.label_divisor + ins_id
            out.append(new_ids)
        return np.concatenate(out, axis=0)

    # -- accumulation ---------------------------------------------------------
    def process_video(self, video_id, pred_ids, pred_segments,
                      gt_ids, gt_segments, frame_names=None):
        """pred_ids/gt_ids: (V, H, W) int id maps (>=1 real ids after
        encoding; the caller maps void/-1 to 0)."""
        pred = np.where(pred_ids < 0, 0, pred_ids + 1)
        gt = np.where(gt_ids < 0, 0, gt_ids + 1)
        pred_segs = {sid + 1: info for sid, info in pred_segments.items()}
        gt_segs = {sid + 1: info for sid, info in gt_segments.items()}
        self._videos.append((gt, pred, gt_segs, pred_segs))

        if self.output_dir and frame_names is not None:
            vdir = os.path.join(self.output_dir, "pan_pred", str(video_id))
            os.makedirs(vdir, exist_ok=True)
            from PIL import Image

            annos = []
            for name, frame in zip(frame_names, pred):
                Image.fromarray(id2rgb(frame)).save(
                    os.path.join(vdir, os.path.basename(name).replace(".jpg", ".png"))
                )
                segs = [
                    {"id": int(s), "category_id": int(info["category_id"])}
                    for s, info in pred_segs.items()
                    if (frame == s).any()
                ]
                annos.append({"file_name": os.path.basename(name), "segments_info": segs})
            with open(os.path.join(vdir, "pred.json"), "w") as f:
                json.dump({"video_id": str(video_id), "annotations": annos}, f)

    def evaluate(self, window_sizes=(1, 2, 4, 6)):
        return vpq_compute(self._videos, self.categories,
                           window_sizes=window_sizes,
                           num_workers=self.num_workers)

    def reset(self):
        """Drop the accumulated videos, for a new evaluation."""
        self._videos = []
