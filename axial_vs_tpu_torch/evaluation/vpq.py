"""Video Panoptic Quality (VPQ): tube-matching PQ over sliding windows
(counterpart of ``axial_vs_tpu/evaluation/vpq.py``'s Python path; the
threaded C++ core ``native/vpq_core.cpp`` is not ported yet).

For each window of ``nframes`` consecutive frames, GT and prediction id maps
are stacked into tubes and their intersections counted; same-category tubes
match at IoU > 0.5 (void subtracted from the union), and false positives and
negatives are counted with crowd and void handling. VPQ@k is the PQ over all
windows; VPQ is the mean over the window sizes {1, 2, 4, 6}. A window's
intersection counts are the sums of its frames' counts, so each frame's
``np.unique`` runs once per window size.
"""
from __future__ import annotations

import multiprocessing
from collections import defaultdict
from concurrent.futures import ProcessPoolExecutor
from typing import Dict

import numpy as np

OFFSET = 256 ** 3
VOID = 0


class PQStat:
    __slots__ = ("iou", "tp", "fp", "fn")

    def __init__(self):
        self.iou = defaultdict(float)
        self.tp = defaultdict(int)
        self.fp = defaultdict(int)
        self.fn = defaultdict(int)

    def __iadd__(self, other: "PQStat"):
        for d_self, d_other in zip((self.iou, self.tp, self.fp, self.fn),
                                   (other.iou, other.tp, other.fp, other.fn)):
            for k, v in d_other.items():
                d_self[k] += v
        return self

    def average(self, categories: Dict[int, dict], isthing=None):
        pq = sq = rq = n = 0
        per_class = {}
        for cat_id, info in categories.items():
            if isthing is not None and bool(info.get("isthing", 0)) != isthing:
                continue
            iou, tp = self.iou[cat_id], self.tp[cat_id]
            fp, fn = self.fp[cat_id], self.fn[cat_id]
            if tp + fp + fn == 0:
                per_class[cat_id] = dict(pq=0.0, sq=0.0, rq=0.0)
                continue
            n += 1
            pq_c = iou / (tp + 0.5 * fp + 0.5 * fn)
            sq_c = iou / tp if tp else 0.0
            rq_c = tp / (tp + 0.5 * fp + 0.5 * fn)
            per_class[cat_id] = dict(pq=pq_c, sq=sq_c, rq=rq_c)
            pq += pq_c
            sq += sq_c
            rq += rq_c
        n = max(n, 1)
        return dict(pq=pq / n, sq=sq / n, rq=rq / n, n=n), per_class


def _frame_intersections(gt_ids: np.ndarray, pred_ids: np.ndarray):
    """Per frame: {(gt id, pred id): pixel count}."""
    out = []
    for g, p in zip(gt_ids.astype(np.uint64), pred_ids.astype(np.uint64)):
        labels, counts = np.unique(g * OFFSET + p, return_counts=True)
        out.append({(int(lab // OFFSET), int(lab % OFFSET)): int(c)
                    for lab, c in zip(labels, counts)})
    return out


def vpq_single_video(gt_ids: np.ndarray, pred_ids: np.ndarray,
                     gt_segments: Dict[int, dict],
                     pred_segments: Dict[int, dict], nframes: int,
                     frames=None) -> PQStat:
    """gt_ids/pred_ids: (V, H, W) panoptic id maps, VOID = 0 (encode ids as
    ``ids + 1`` upstream so that -1/void maps to 0). gt_segments: {id:
    {'category_id', 'iscrowd'}}; pred_segments: {id: {'category_id'}}.
    ``frames``: the per-frame intersections, if already counted."""
    stat = PQStat()
    frames = frames or _frame_intersections(gt_ids, pred_ids)
    for start in range(0, len(frames) - nframes + 1):
        inter: dict = defaultdict(int)
        for f in frames[start:start + nframes]:
            for k, c in f.items():
                inter[k] += c

        gt_areas: dict = defaultdict(int)
        pred_areas: dict = defaultdict(int)
        for (g, p), c in inter.items():
            gt_areas[g] += c
            pred_areas[p] += c

        gt_matched, pred_matched = set(), set()
        for (g, p), c in inter.items():
            if g not in gt_segments or p not in pred_segments:
                continue
            ginfo = gt_segments[g]
            if ginfo.get("iscrowd", 0) == 1:
                continue
            if ginfo["category_id"] != pred_segments[p]["category_id"]:
                continue
            union = pred_areas[p] + gt_areas[g] - c - inter.get((VOID, p), 0)
            iou = c / union
            if iou > 0.5:
                cat = ginfo["category_id"]
                stat.tp[cat] += 1
                stat.iou[cat] += iou
                gt_matched.add(g)
                pred_matched.add(p)

        crowd_by_cat = {}
        for g in gt_areas:
            if g == VOID or g in gt_matched or g not in gt_segments:
                continue
            info = gt_segments[g]
            if info.get("iscrowd", 0) == 1:
                crowd_by_cat[info["category_id"]] = g
                continue
            stat.fn[info["category_id"]] += 1

        for p, area in pred_areas.items():
            if p == VOID or p in pred_matched or p not in pred_segments:
                continue
            cat = pred_segments[p]["category_id"]
            ignored = inter.get((VOID, p), 0)
            if cat in crowd_by_cat:
                ignored += inter.get((crowd_by_cat[cat], p), 0)
            if ignored / area > 0.5:
                continue
            stat.fp[cat] += 1
    return stat


def _video_stats(job):
    """One video's PQStat per window size; job: (gt_ids, pred_ids,
    gt_segments, pred_segments, window_sizes)."""
    gt_ids, pred_ids, gt_segments, pred_segments, window_sizes = job
    frames = _frame_intersections(gt_ids, pred_ids)
    return [vpq_single_video(gt_ids, pred_ids, gt_segments, pred_segments, k,
                             frames) for k in window_sizes]


def vpq_compute(videos, categories: Dict[int, dict], window_sizes=(1, 2, 4, 6),
                num_workers: int = 0):
    """videos: iterable of (gt_ids, pred_ids, gt_segments, pred_segments).
    With ``num_workers`` > 1 the videos are counted in that many processes,
    started fresh (``spawn``: the caller may run threads); the stats are
    summed in the videos' order either way, so the result does not depend
    on it. Returns {'vpq': mean over window sizes,
    'per_window': {k: {'all', 'things', 'stuff'}}}."""
    jobs = [(g, p, gs, ps, tuple(window_sizes)) for g, p, gs, ps in videos]
    if num_workers > 1:
        with ProcessPoolExecutor(max_workers=num_workers,
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            per_video = list(ex.map(_video_stats, jobs))
    else:
        per_video = [_video_stats(job) for job in jobs]
    per_window = {}
    for i, nframes in enumerate(window_sizes):
        stat = PQStat()
        for stats in per_video:
            stat += stats[i]
        per_window[nframes] = dict(all=stat.average(categories, None)[0],
                                   things=stat.average(categories, True)[0],
                                   stuff=stat.average(categories, False)[0])
    vpq = float(np.mean([per_window[k]["all"]["pq"] for k in window_sizes]))
    return dict(vpq=vpq, per_window=per_window)
