"""YouTube-VIS data: registration, the training clip mapper and the result
writer (counterpart of ``axial_vs_tpu/data/ytvis.py``).

YTVIS-format JSON (videos, per-video annotations with per-frame RLE
``segmentations``) -> video dicts in the port's catalog; the mapper samples
``num_frames``-long clips within a ``frame_range`` window and builds padded
tube targets; inference results serialize back to the YTVIS submission JSON
(video_id / category_id / score / per-frame RLEs, or None for an empty
frame).
"""
from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from . import mask_rle
from .catalog import DatasetCatalog, MetadataCatalog
from .transforms import build_train_transforms


def load_ytvis_json(json_file: str, image_root: str):
    with open(json_file) as f:
        data = json.load(f)
    anns_by_video = {}
    for ann in data.get("annotations", []) or []:
        anns_by_video.setdefault(ann["video_id"], []).append(ann)
    videos = []
    for vid in data["videos"]:
        videos.append(
            dict(
                video_id=vid["id"],
                file_names=[os.path.join(image_root, f) for f in vid["file_names"]],
                height=vid["height"],
                width=vid["width"],
                length=vid["length"],
                annotations=anns_by_video.get(vid["id"], []),
            )
        )
    cats = {c["id"]: c for c in data.get("categories", [])}
    return videos, cats


def register_ytvis(name, image_root, json_file):
    DatasetCatalog.register(name, lambda: load_ytvis_json(json_file, image_root)[0])
    meta = MetadataCatalog.get(name)
    meta.image_root = image_root
    meta.json_file = json_file
    try:
        with open(json_file) as f:
            cats = sorted(json.load(f).get("categories", []), key=lambda c: c["id"])
        meta.categories = {c["id"]: c for c in cats}
        meta.contiguous_to_dataset_id = [c["id"] for c in cats]
    except FileNotFoundError:
        pass
    return meta


class YTVISClipMapper:
    """video dict -> training clip sample with padded tube targets.

    Clip sampling is the uniform ``frame_range`` window of the JAX mapper:
    a key frame plus ``num_frames - 1`` frames drawn from +-frame_range
    around it, from the mapper's own ``RandomState(seed)``.
    """

    def __init__(self, *, image_size, num_frames=5, frame_range=4,
                 max_instances=100, pixel_mean=(123.675, 116.28, 103.53),
                 pixel_std=(58.395, 57.12, 57.375), min_scale=0.5,
                 max_scale=1.5, seed=0, dataset_id_to_contiguous_id=None):
        self.image_size = tuple(image_size)
        self.num_frames = num_frames
        self.frame_range = frame_range
        self.max_instances = max_instances
        self.pixel_mean = np.asarray(pixel_mean, np.float32)
        self.pixel_std = np.asarray(pixel_std, np.float32)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.rng = np.random.RandomState(seed)
        # dataset category_id -> contiguous [0, K) training label, the
        # inverse of the eval's meta.contiguous_to_dataset_id (YTVIS ids are
        # 1-based, so raw ids would be off by one on every class)
        self.dataset_id_to_contiguous_id = dataset_id_to_contiguous_id

    def _sample_frames(self, length):
        key = self.rng.randint(0, length)
        lo = max(0, key - self.frame_range)
        hi = min(length - 1, key + self.frame_range)
        cands = [i for i in range(lo, hi + 1)]
        if len(cands) >= self.num_frames:
            idxs = sorted(self.rng.choice(cands, self.num_frames, replace=False))
        else:
            idxs = sorted(self.rng.choice(cands, self.num_frames, replace=True))
        return idxs

    def __call__(self, video, dataset=None):
        idxs = self._sample_frames(video["length"])
        tfm = build_train_transforms(self.image_size, self.min_scale, self.max_scale)
        th, tw = self.image_size
        t = self.num_frames
        anns = video["annotations"]
        m = self.max_instances

        images = np.zeros((t, th, tw, 3), np.float32)
        masks = np.zeros((m, t, (th + 3) // 4, (tw + 3) // 4), np.float32)
        labels = np.zeros((m,), np.int32)
        valid = np.zeros((m,), bool)

        for fi, fidx in enumerate(idxs):
            img = np.asarray(Image.open(video["file_names"][fidx]).convert("RGB"))
            if fi == 0:
                tfm.sample(self.rng, img.shape[:2])
            img = tfm.apply_image(img)
            h, w = img.shape[:2]
            x = (img.astype(np.float32) - self.pixel_mean) / self.pixel_std
            images[fi, : min(h, th), : min(w, tw)] = x[:th, :tw]

            for ai, ann in enumerate(anns[:m]):
                seg = ann["segmentations"][fidx]
                if seg is None:
                    continue
                mask = mask_rle.decode(seg)
                mask = tfm.apply_segmentation(mask)
                mask4 = mask[::4, ::4]
                h4, w4 = mask4.shape
                masks[ai, fi, : min(h4, masks.shape[2]), : min(w4, masks.shape[3])] = (
                    mask4[: masks.shape[2], : masks.shape[3]]
                )
                valid[ai] = True
                cid = ann["category_id"]
                if self.dataset_id_to_contiguous_id is not None:
                    cid = self.dataset_id_to_contiguous_id[cid]
                labels[ai] = cid
        return dict(
            images=images,
            targets=dict(labels=labels, masks=masks, valid=valid),
        )


def results_to_ytvis_json(instances_per_video, score_threshold=0.0):
    """instances_per_video: list of (video_id, {masks (k,V,h,w) bool or
    probs, labels, scores}) -> submission-format list."""
    out = []
    for video_id, inst in instances_per_video:
        for k in range(len(inst["scores"])):
            score = float(inst["scores"][k])
            if score < score_threshold:
                continue
            segs = []
            for f in range(inst["masks"].shape[1]):
                mask = np.asarray(inst["masks"][k, f] > 0.5, np.uint8)
                segs.append(mask_rle.encode(mask) if mask.any() else None)
            out.append(
                dict(
                    video_id=int(video_id),
                    category_id=int(inst["labels"][k]),
                    score=score,
                    segmentations=segs,
                )
            )
    return out
