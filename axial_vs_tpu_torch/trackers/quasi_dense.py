"""Quasi-dense embedding tracker, VPS id propagation (counterpart of
``axial_vs_tpu/trackers/quasi_dense.py``; host numpy).

Re-designs `MaXTron_Tube-Link/tracker/qdtrack/quasi_dense_embed_tracker.py:9-137`:
tracks keep EMA ("momentum") embeddings; new detections match by bisoftmax
similarity (softmax over tracks + softmax over detections, averaged) or
cosine similarity, gated by score thresholds and match score, in
descending detection score; unmatched confident detections spawn new
tracks; stale tracks retire after ``memo_tracklet_frames``.
"""
from __future__ import annotations

import numpy as np


def _softmax(x, axis):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / np.maximum(e.sum(axis=axis, keepdims=True), 1e-12)


class QuasiDenseEmbedTracker:
    def __init__(self, init_score_thr=0.35, obj_score_thr=0.3,
                 match_score_thr=0.5, memo_tracklet_frames=10,
                 memo_momentum=0.8, match_metric="bisoftmax"):
        self.init_score_thr = init_score_thr
        self.obj_score_thr = obj_score_thr
        self.match_score_thr = match_score_thr
        self.memo_tracklet_frames = memo_tracklet_frames
        self.memo_momentum = memo_momentum
        self.match_metric = match_metric
        self.reset()

    def reset(self):
        self.num_tracks = 0
        self.tracks = {}  # id -> dict(embed, label, last_frame, score)

    def _memo(self):
        ids = sorted(self.tracks)
        if not ids:
            return np.zeros(0, np.int64), np.zeros((0, 1), np.float32), np.zeros(0)
        embeds = np.stack([self.tracks[i]["embed"] for i in ids])
        labels = np.asarray([self.tracks[i]["label"] for i in ids])
        return np.asarray(ids), embeds, labels

    def match(self, embeds, labels, scores, frame_id):
        """embeds (N, C), labels (N,), scores (N,) -> track ids (N,), -1 for
        dropped detections."""
        n = len(embeds)
        ids = np.full(n, -1, np.int64)
        order = np.argsort(-np.asarray(scores))

        memo_ids, memo_embeds, memo_labels = self._memo()
        if len(memo_ids):
            if self.match_metric == "bisoftmax":
                sim = embeds @ memo_embeds.T
                d2t = _softmax(sim, 1)
                t2d = _softmax(sim, 0)
                match_scores = (d2t + t2d) / 2
            else:  # cosine
                a = embeds / np.maximum(
                    np.linalg.norm(embeds, axis=1, keepdims=True), 1e-12)
                b = memo_embeds / np.maximum(
                    np.linalg.norm(memo_embeds, axis=1, keepdims=True), 1e-12
                )
                match_scores = a @ b.T
        taken = set()
        for di in order:
            if scores[di] < self.obj_score_thr:
                continue
            best_tid = -1
            if len(memo_ids):
                cand = np.argsort(-match_scores[di])
                for mi in cand:
                    if memo_ids[mi] in taken:
                        continue
                    if match_scores[di, mi] <= self.match_score_thr:
                        break
                    if memo_labels[mi] != labels[di]:
                        continue
                    best_tid = int(memo_ids[mi])
                    break
            if best_tid >= 0:
                taken.add(best_tid)
                ids[di] = best_tid
                tr = self.tracks[best_tid]
                tr["embed"] = (
                    (1 - self.memo_momentum) * tr["embed"]
                    + self.memo_momentum * embeds[di]
                )
                tr["last_frame"] = frame_id
                tr["label"] = labels[di]
            elif scores[di] >= self.init_score_thr:
                tid = self.num_tracks
                self.num_tracks += 1
                ids[di] = tid
                self.tracks[tid] = dict(
                    embed=np.array(embeds[di]), label=labels[di],
                    last_frame=frame_id, score=scores[di],
                )
        # retire stale tracks
        for tid in list(self.tracks):
            if frame_id - self.tracks[tid]["last_frame"] > self.memo_tracklet_frames:
                del self.tracks[tid]
        return ids
