"""YouTube-VIS AP evaluation of video instance segmentation (counterpart of
``axial_vs_tpu/evaluation/ytvis_eval.py``, numpy only).

The YTVIS devkit's (youtubevos cocoapi ytvoseval) rules: video-track IoU =
sum of per-frame intersections / sum of per-frame unions (absent frames are
empty masks, crowd GTs use the prediction's area as the union), COCO-style
greedy matching per (video, category, area range, maxDet) at IoU
.50:.05:.95, ignore semantics (crowd and out-of-area-range GTs sorted last,
unmatched out-of-range detections ignored), [T, R, K, A, M] accumulation
with 101-point interpolated precision, and the devkit's AP/AR summary.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..data import mask_rle

AREA_RNGS = ((0.0, 1e10), (0.0, 128.0**2), (128.0**2, 256.0**2),
             (256.0**2, 1e10))
AREA_LBLS = ("all", "small", "medium", "large")


def video_iou(pred_segm, gt_segm, iscrowd=False):
    """segm: lists (per frame) of RLE dicts or None."""
    inter = union = 0
    for p, g in zip(pred_segm, gt_segm):
        pm = mask_rle.decode(p) if p else None
        gm = mask_rle.decode(g) if g else None
        if pm is None and gm is None:
            continue
        if pm is None:
            if not iscrowd:
                union += int(gm.sum())
            continue
        if gm is None:
            union += int(pm.sum())
            continue
        inter += int(np.logical_and(pm, gm).sum())
        if iscrowd:
            union += int(pm.sum())
        else:
            union += int(np.logical_or(pm, gm).sum())
    return inter / union if union else 0.0


def video_box_iou(pred_boxes, gt_boxes, iscrowd=False):
    """boxes: lists (per frame) of [x, y, w, h] or None — pycocotools
    bbIoU semantics per frame, aggregated over the video like iou_seq
    (sum of intersections / sum of unions; crowd union = dt area)."""
    inter = union = 0.0
    for p, g in zip(pred_boxes, gt_boxes):
        pa = p[2] * p[3] if p else 0.0
        ga = g[2] * g[3] if g else 0.0
        if p is None and g is None:
            continue
        if p is None:
            if not iscrowd:
                union += ga
            continue
        if g is None:
            union += pa
            continue
        iw = min(p[0] + p[2], g[0] + g[2]) - max(p[0], g[0])
        ih = min(p[1] + p[3], g[1] + g[3]) - max(p[1], g[1])
        i = max(iw, 0.0) * max(ih, 0.0)
        inter += i
        union += pa if iscrowd else pa + ga - i
    return inter / union if union else 0.0


def _avg_area(rec):
    """Devkit avg_area: mean of the non-empty per-frame areas (0 if none).
    Prefers an explicit ``areas`` list (annotation format), else computes
    from the segmentations."""
    areas = rec.get("areas")
    if areas is None and "segmentations" in rec:
        areas = [int(mask_rle.decode(s).sum()) if s else None
                 for s in rec["segmentations"]]
    if areas is None:
        # bbox-only records (pycocotools bbox task: dt area = box area)
        areas = [b[2] * b[3] if b else None for b in rec["bboxes"]]
    vals = [a for a in areas if a]
    return float(np.mean(vals)) if vals else 0.0


class YTVISEvaluator:
    def __init__(self, iou_thrs=None, max_dets=(1, 10, 100),
                 area_rngs=AREA_RNGS, area_lbls=AREA_LBLS,
                 crowd_iou=False, iou_type="segm"):
        # crowd_iou=False reproduces the devkit: its video ``iou_seq``
        # ignores iscrowd entirely; COCOeval-style crowd unions are opt-in
        self.iou_thrs = (np.asarray(iou_thrs) if iou_thrs is not None
                         else np.linspace(0.5, 0.95, 10))
        self.recall_thrs = np.linspace(0.0, 1.0, 101)
        self.max_dets = tuple(max_dets)
        self.area_rngs = tuple(tuple(a) for a in area_rngs)
        self.area_lbls = tuple(area_lbls)
        self.crowd_iou = crowd_iou
        self.iou_type = iou_type  # "segm" | "bbox" (records carry bboxes)

    def _evaluate_vid(self, gt, dt, ious, a_rng, max_det):
        """Port of ``YTVISeval.evaluateVid``. gt/dt carry _id/_area/score;
        ious (D, G) in ORIGINAL gt order."""
        if len(gt) == 0 and len(dt) == 0:
            return None
        t_n = len(self.iou_thrs)
        g_ign0 = np.array([
            1 if (g.get("iscrowd", 0)
                  or g["_area"] < a_rng[0] or g["_area"] > a_rng[1]) else 0
            for g in gt])
        gtind = np.argsort(g_ign0, kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:max_det]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gt]
        ious = ious[:, gtind][dtind[:max_det]] if len(ious) else ious

        G, D = len(gt), len(dt)
        gtm = np.zeros((t_n, G))
        dtm = np.zeros((t_n, D))
        gt_ig = g_ign0[gtind].astype(float)
        dt_ig = np.zeros((t_n, D))
        if len(ious):
            for ti, t in enumerate(self.iou_thrs):
                for di in range(D):
                    iou = min(t, 1 - 1e-10)
                    m = -1
                    for gi in range(G):
                        if gtm[ti, gi] > 0 and not iscrowd[gi]:
                            continue
                        if m > -1 and gt_ig[m] == 0 and gt_ig[gi] == 1:
                            break
                        if ious[di, gi] < iou:
                            continue
                        iou = ious[di, gi]
                        m = gi
                    if m == -1:
                        continue
                    dt_ig[ti, di] = gt_ig[m]
                    dtm[ti, di] = gt[m]["_id"]
                    gtm[ti, m] = dt[di]["_id"]
        out_of_rng = np.array([
            d["_area"] < a_rng[0] or d["_area"] > a_rng[1] for d in dt
        ]).reshape(1, D)
        dt_ig = np.logical_or(
            dt_ig, np.logical_and(dtm == 0, np.repeat(out_of_rng, t_n, 0)))
        return {
            "dtMatches": dtm,
            "dtScores": np.array([d["score"] for d in dt]),
            "gtIgnore": gt_ig,
            "dtIgnore": dt_ig,
        }

    def evaluate(self, gts, preds):
        """gts: list of {video_id, category_id, segmentations[, areas,
        iscrowd]}; preds: list of {video_id, category_id, score,
        segmentations}. Returns the devkit summary metrics."""
        for i, g in enumerate(gts):
            g["_id"] = i + 1
            g["_area"] = _avg_area(g)
        for i, d in enumerate(preds):
            d["_id"] = i + 1
            # pycocotools: bbox-task DETECTION areas are box areas
            # (loadRes), while GT keeps the annotation (segm) area
            if self.iou_type == "bbox" and d.get("bboxes") is not None:
                vals = [b[2] * b[3] for b in d["bboxes"] if b]
                d["_area"] = float(np.mean(vals)) if vals else 0.0
            else:
                d["_area"] = _avg_area(d)

        cats = sorted({g["category_id"] for g in gts})
        videos = sorted({g["video_id"] for g in gts}
                        | {p["video_id"] for p in preds})
        gt_by = defaultdict(list)
        dt_by = defaultdict(list)
        for g in gts:
            gt_by[(g["video_id"], g["category_id"])].append(g)
        for p in preds:
            dt_by[(p["video_id"], p["category_id"])].append(p)

        max_det = max(self.max_dets)
        iou_cache = {}
        for vid in videos:
            for cat in cats:
                gt = gt_by.get((vid, cat), [])
                dt = sorted(dt_by.get((vid, cat), []),
                            key=lambda d: -d["score"])[:max_det]
                ious = np.zeros((len(dt), len(gt)))
                for di, d in enumerate(dt):
                    for gi, g in enumerate(gt):
                        crowd = self.crowd_iou and bool(g.get("iscrowd", 0))
                        if self.iou_type == "bbox":
                            ious[di, gi] = video_box_iou(
                                d["bboxes"], g["bboxes"], iscrowd=crowd)
                        else:
                            ious[di, gi] = video_iou(
                                d["segmentations"], g["segmentations"],
                                iscrowd=crowd)
                iou_cache[(vid, cat)] = ious

        t_n, r_n = len(self.iou_thrs), len(self.recall_thrs)
        k_n, a_n, m_n = len(cats), len(self.area_rngs), len(self.max_dets)
        precision = -np.ones((t_n, r_n, k_n, a_n, m_n))
        recall = -np.ones((t_n, k_n, a_n, m_n))

        for ki, cat in enumerate(cats):
            for ai, a_rng in enumerate(self.area_rngs):
                for mi, md in enumerate(self.max_dets):
                    results = []
                    for vid in videos:
                        gt = gt_by.get((vid, cat), [])
                        dt = sorted(dt_by.get((vid, cat), []),
                                    key=lambda d: -d["score"])[:max_det]
                        r = self._evaluate_vid(
                            gt, dt, iou_cache[(vid, cat)], a_rng, md)
                        if r is not None:
                            results.append(r)
                    if not results:
                        continue
                    scores = np.concatenate(
                        [r["dtScores"][:md] for r in results])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate(
                        [r["dtMatches"][:, :md] for r in results],
                        axis=1)[:, order]
                    dt_ig = np.concatenate(
                        [r["dtIgnore"][:, :md] for r in results],
                        axis=1)[:, order]
                    gt_ig = np.concatenate([r["gtIgnore"] for r in results])
                    npig = int(np.count_nonzero(gt_ig == 0))
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dt_ig))
                    fps = np.logical_and(np.logical_not(dtm),
                                         np.logical_not(dt_ig))
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(tp) else 0
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        q = np.zeros(r_n)
                        inds = np.searchsorted(rc, self.recall_thrs,
                                               side="left")
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q

        def _summ(use_prec, t=None, a=0, m=m_n - 1):
            arr = precision if use_prec else recall
            if use_prec:
                s = arr[:, :, :, a, m] if t is None else arr[[t], :, :, a, m]
            else:
                s = arr[:, :, a, m] if t is None else arr[[t], :, a, m]
            valid = s[s > -1]
            return float(np.mean(valid)) if valid.size else -1.0

        results = {
            "AP": _summ(True),
            "AP50": _summ(True, t=0),
            "AP75": _summ(True, t=5) if t_n > 5 else float("nan"),
            "AP_small": _summ(True, a=1),
            "AP_medium": _summ(True, a=2),
            "AP_large": _summ(True, a=3),
            "per_category_AP": {},
        }
        for mi, md in enumerate(self.max_dets):
            results[f"AR@{md}"] = _summ(False, m=mi)
        for ki, cat in enumerate(cats):
            s = precision[:, :, ki, 0, m_n - 1]
            valid = s[s > -1]
            results["per_category_AP"][cat] = (
                float(np.mean(valid)) if valid.size else -1.0)
        return results
