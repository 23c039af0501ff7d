"""VIPSeg video-panoptic dataset: the panoVIPSeg JSON loader, its
registration and the training clip mapper (counterpart of
``axial_vs_tpu/data/vipseg.py``).

The mapper re-designs the reference's
`vipseg_panoptic_maxtron_dataset_mapper.py:58-560`: clip sampling,
clip-consistent augmentation, manual bottom/right padding with
is_real_pixels, RGB->id panoptic GT, video copy-paste augmentation,
4x-strided GT downsampling, instance padding to a fixed slot count.
"""
from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from .catalog import DatasetCatalog, MetadataCatalog
from .panoptic_utils import rgb2id
from .transforms import build_train_transforms


def load_vipseg_video_json(json_file: str, image_root: str, panoptic_root: str):
    """Returns (videos, categories): videos as {'video_id', 'frames':
    [{'image_id', 'file_name', 'pan_seg_file_name', 'segments_info',
    'height', 'width'}]}, categories as {id: category dict}."""
    with open(json_file) as f:
        data = json.load(f)
    cats = {c["id"]: c for c in data.get("categories", [])}
    videos = []
    for vid in data["videos"]:
        anns_by_image = {ann["image_id"]: ann for ann in vid.get("annotations", [])}
        frames = []
        for img in vid["images"]:
            ann = anns_by_image.get(img["id"], {})
            frames.append(dict(
                image_id=img["id"],
                file_name=os.path.join(image_root, vid["video_id"], img["file_name"]),
                pan_seg_file_name=os.path.join(
                    panoptic_root, vid["video_id"], ann.get("file_name", "")),
                segments_info=ann.get("segments_info", []),
                height=img.get("height"),
                width=img.get("width"),
            ))
        videos.append(dict(video_id=vid["video_id"], frames=frames))
    return videos, cats


def register_vipseg_video(name, image_root, panoptic_root, json_file):
    """Register ``name`` in the port's catalogs; returns its metadata."""
    DatasetCatalog.register(
        name, lambda: load_vipseg_video_json(json_file, image_root,
                                             panoptic_root)[0])
    meta = MetadataCatalog.get(name)
    meta.image_root = image_root
    meta.panoptic_root = panoptic_root
    meta.json_file = json_file
    return meta


def set_panoptic_metadata(meta, categories, label_divisor: int = 10000,
                          ignore_label: int = 255):
    """Fill ``meta`` from a list of category dicts ({'id', 'isthing', ...}),
    as the builtin VIPSeg registration does: contiguous ids in the order of
    the dataset ids, thing and stuff maps, the label divisor."""
    cats = sorted(categories, key=lambda c: c["id"])
    meta.categories = {c["id"]: c for c in cats}
    meta.thing_dataset_id_to_contiguous_id = {}
    meta.stuff_dataset_id_to_contiguous_id = {}
    meta.contiguous_to_dataset_id = []
    for i, c in enumerate(cats):
        meta.contiguous_to_dataset_id.append(c["id"])
        if c.get("isthing", 0):
            meta.thing_dataset_id_to_contiguous_id[c["id"]] = i
        else:
            meta.stuff_dataset_id_to_contiguous_id[c["id"]] = i
    meta.label_divisor = label_divisor
    meta.ignore_label = ignore_label
    return meta


class VIPSegClipMapper:
    """video dict -> training sample (numpy) for the train step (a copy of
    the JAX package's mapper: the same draws from the same seed give
    bit-identical images and targets). The sample: "images" (T, H, W, 3)
    f32, normalized, zero outside the real pixels; "targets": "labels"
    (M,) int32, "masks" (M, T, ceil(H / 4), ceil(W / 4)) f32, "valid" (M,)
    bool, "semantic_masks" (T, ceil(H / 4), ceil(W / 4)) int32, -1 void."""

    def __init__(self, *, image_size, num_frames=2, min_scale=0.3, max_scale=1.7,
                 max_instances=128, copy_paste=True, random_reverse=False,
                 pixel_mean=(123.675, 116.28, 103.53),
                 pixel_std=(58.395, 57.12, 57.375), seed=0,
                 category_id_map=None):
        #: dataset category_id -> contiguous train id (ref mapper maps via
        #: metadata thing/stuff_dataset_id_to_contiguous_id); None = identity
        #: (real VIPSeg ids are already contiguous 0..123)
        self.category_id_map = dict(category_id_map or {}) or None
        self.image_size = tuple(image_size)
        self.num_frames = num_frames
        self.max_instances = max_instances
        self.copy_paste = copy_paste
        self.random_reverse = random_reverse
        self.pixel_mean = np.asarray(pixel_mean, np.float32)
        self.pixel_std = np.asarray(pixel_std, np.float32)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.rng = np.random.RandomState(seed)

    # -- clip IO --------------------------------------------------------------
    def _sample_clip(self, video):
        frames = video["frames"]
        t = self.num_frames
        if len(frames) <= t:
            idxs = list(range(len(frames))) + [len(frames) - 1] * (t - len(frames))
        else:
            start = self.rng.randint(0, len(frames) - t + 1)
            idxs = list(range(start, start + t))
        if self.random_reverse and self.rng.rand() < 0.5:
            idxs = idxs[::-1]
        return [frames[i] for i in idxs]

    def _load_clip(self, clip):
        tfm = build_train_transforms(self.image_size, self.min_scale, self.max_scale)
        images, pans, is_real = [], [], []
        for i, frame in enumerate(clip):
            img = np.asarray(Image.open(frame["file_name"]).convert("RGB"))
            if i == 0:
                tfm.sample(self.rng, img.shape[:2])
            img = tfm.apply_image(img)
            pan_rgb = np.asarray(Image.open(frame["pan_seg_file_name"]).convert("RGB"))
            pan = tfm.apply_segmentation(rgb2id(pan_rgb))

            h, w = img.shape[:2]
            th, tw = self.image_size
            pad_img = np.zeros((th, tw, 3), img.dtype)
            pad_img[:h, :w] = img[:th, :tw]
            pad_pan = np.zeros((th, tw), pan.dtype)
            pad_pan[:h, :w] = pan[:th, :tw]
            real = np.zeros((th, tw), bool)
            real[: min(h, th), : min(w, tw)] = True
            images.append(pad_img)
            pans.append(pad_pan)
            is_real.append(real)
        return (
            np.stack(images),
            np.stack(pans),
            np.stack(is_real),
            clip[0]["segments_info"],
        )

    # -- copy-paste -----------------------------------------------------------
    def _video_copy_paste(self, main, other):
        """Paste a random subset of `other`'s segments (always all things)
        over `main` (ref :216-443). Pasted ids become negative."""
        images, pans, real, segs = main
        o_images, o_pans, o_real, o_segs = other
        thing_ids = [s["id"] for s in o_segs if s.get("isthing", True) and not s.get("iscrowd", 0)]
        stuff_ids = [s["id"] for s in o_segs if not s.get("isthing", True) and not s.get("iscrowd", 0)]
        keep_stuff = [i for i in stuff_ids if self.rng.rand() < 0.5]
        paste_ids = set(thing_ids + keep_stuff)
        if not paste_ids:
            return main, []
        paste_mask = np.isin(o_pans, list(paste_ids))  # (T, H, W)
        m3 = paste_mask[..., None]
        images = np.where(m3, o_images, images)
        real = np.where(paste_mask, o_real, real)
        pans = np.where(paste_mask, -o_pans, pans)
        return (images, pans, real, segs), [s for s in o_segs if s["id"] in paste_ids]

    # -- targets --------------------------------------------------------------
    def _build_targets(self, pans, segments_info, pasted_segments):
        """4x-strided GT; instances tracked across the clip by id."""
        t = pans.shape[0]
        pan4 = pans[:, ::4, ::4]
        h4, w4 = pan4.shape[1:]
        m = self.max_instances

        labels = np.full((m,), -1, np.int64)
        masks = np.zeros((m, t, h4, w4), np.float32)
        valid = np.zeros((m,), bool)
        semantic = -np.ones((t, h4, w4), np.int64)

        slot = 0
        stuff_slot_by_class = {}
        for seg_list, sign in ((segments_info, 1), (pasted_segments, -1)):
            for seg in seg_list:
                if seg.get("iscrowd", 0):
                    continue
                sid = sign * seg["id"]
                binary = pan4 == sid
                if not binary.any():
                    continue
                cls = seg["category_id"]
                if self.category_id_map is not None:
                    if cls not in self.category_id_map:
                        continue  # category outside the train label space
                    cls = self.category_id_map[cls]
                semantic[binary] = cls
                if not seg.get("isthing", True) and cls in stuff_slot_by_class:
                    j = stuff_slot_by_class[cls]
                    masks[j] = np.logical_or(masks[j] > 0, binary)
                    continue
                if slot >= m:
                    break
                if not seg.get("isthing", True):
                    stuff_slot_by_class[cls] = slot
                labels[slot] = cls
                masks[slot] = binary
                valid[slot] = True
                slot += 1
        labels = np.where(valid, labels, 0)
        return dict(
            labels=labels.astype(np.int32),
            masks=masks,
            valid=valid,
            semantic_masks=semantic.astype(np.int32),
        )

    def __call__(self, video, dataset=None):
        clip = self._load_clip(self._sample_clip(video))
        pasted = []
        if self.copy_paste and dataset is not None and len(dataset) > 1:
            other_video = dataset[self.rng.randint(0, len(dataset))]
            other = self._load_clip(self._sample_clip(other_video))
            clip, pasted = self._video_copy_paste(clip, other)
        images, pans, is_real, segs = clip

        x = (images.astype(np.float32) - self.pixel_mean) / self.pixel_std
        x = x * is_real[..., None]
        # mark padded GT pixels as -1 so they become void
        pans = np.where(is_real, pans, -1)
        targets = self._build_targets(pans, segs, pasted)
        return dict(images=x, targets=targets)
