"""VIPSeg video-panoptic dataset registration: the panoVIPSeg JSON loader
(counterpart of ``axial_vs_tpu/data/vipseg.py``'s ``load_vipseg_video_json``
and ``register_vipseg_video``; the training clip mapper is not ported)."""
from __future__ import annotations

import json
import os

from .catalog import DatasetCatalog, MetadataCatalog


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
