"""COCO-format panoptic and instance datasets (the kMaX-DeepLab image
pretrain): registration and training mappers (counterpart of
``axial_vs_tpu/data/coco.py``; a copy: the same draws from the same seed
give bit-identical images and targets).

The panoptic JSON gives one record an image; the training mapper is the
video recipe on one frame (ResizeScale, SSD colour jitter, RandomCrop,
flip), manual bottom/right padding, RGB -> id ground truth, optional
copy-paste, and targets padded to a fixed slot count at 4x-strided
resolution. The instance JSON (polygons or RLE) gives records with their
annotations; its mapper rasterises them and fills the same target layout
with thing classes only.
"""
from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image, ImageDraw

from . import mask_rle
from .catalog import DatasetCatalog, MetadataCatalog
from .panoptic_utils import rgb2id
from .transforms import build_train_transforms


def load_coco_panoptic_json(json_file, image_root, panoptic_root):
    """A COCO panoptic JSON -> (records, {category id: category}); a record
    an annotated image: "image_id", "file_name", "pan_seg_file_name",
    "segments_info", "height", "width"."""
    with open(json_file) as f:
        data = json.load(f)
    images = {img["id"]: img for img in data["images"]}
    out = []
    for ann in data["annotations"]:
        img = images[ann["image_id"]]
        out.append(
            dict(
                image_id=ann["image_id"],
                file_name=os.path.join(image_root, img["file_name"]),
                pan_seg_file_name=os.path.join(panoptic_root, ann["file_name"]),
                segments_info=ann["segments_info"],
                height=img["height"],
                width=img["width"],
            )
        )
    return out, {c["id"]: c for c in data.get("categories", [])}


def register_coco_panoptic(name, image_root, panoptic_root, json_file):
    """Register ``name`` in the port's catalogs; its metadata (contiguous
    ids in the order of the dataset ids, thing and stuff maps) is filled
    when the records are first loaded. Label divisor 1000."""
    def loader():
        records, cats = load_coco_panoptic_json(
            json_file, image_root, panoptic_root)
        meta = MetadataCatalog.get(name)
        ordered = sorted(cats.values(), key=lambda c: c["id"])
        meta.categories = {c["id"]: c for c in ordered}
        meta.thing_dataset_id_to_contiguous_id = {}
        meta.stuff_dataset_id_to_contiguous_id = {}
        meta.contiguous_to_dataset_id = []
        for i, c in enumerate(ordered):
            meta.contiguous_to_dataset_id.append(c["id"])
            if c.get("isthing", 0):
                meta.thing_dataset_id_to_contiguous_id[c["id"]] = i
            else:
                meta.stuff_dataset_id_to_contiguous_id[c["id"]] = i
        return records

    DatasetCatalog.register(name, loader)
    meta = MetadataCatalog.get(name)
    meta.image_root = image_root
    meta.panoptic_root = panoptic_root
    meta.json_file = json_file
    meta.label_divisor = 1000
    meta.ignore_label = 255
    return meta


class CocoPanopticMapper:
    """image dict -> padded single-frame training sample (same target format
    as the video mapper with T=1).

    ``copy_paste=True`` (the reference's DEFAULT COCO pretrain recipe,
    `panoptic_kmaxdeeplab_dataset_mapper.py:231-292`) pastes a second
    image's segments over the main one when a ``dataset`` is supplied:
    the paste image is augmented with a HALVED scale range (ref :164,
    ``scale_ratio=0.5``), ALL its thing segments plus a shuffled random
    prefix of all segments are pasted (ref :272-279), pasted ids are
    negated, same-class stuff merges into the main image's slot
    (ref :355-362), and samples whose GT ends up empty or with
    ``valid_pixel_num <= 4096`` are regenerated from a different record
    (ref :386-396). ``copy_paste=False`` reproduces the ``_nocopypaste``
    mapper variant."""

    def __init__(self, *, image_size=(1281, 1281), min_scale=0.2, max_scale=2.0,
                 max_instances=128, pixel_mean=(123.675, 116.28, 103.53),
                 pixel_std=(58.395, 57.12, 57.375), thing_ids=None,
                 copy_paste=True, min_valid_pixels=4096, seed=0):
        self.image_size = tuple(image_size)
        self.max_instances = max_instances
        self.pixel_mean = np.asarray(pixel_mean, np.float32)
        self.pixel_std = np.asarray(pixel_std, np.float32)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.thing_ids = set(thing_ids or [])
        self.copy_paste = copy_paste
        self.min_valid_pixels = min_valid_pixels
        self.rng = np.random.RandomState(seed)

    def _is_thing(self, seg):
        if "isthing" in seg:
            return bool(seg["isthing"])
        return seg["category_id"] in self.thing_ids

    def _read(self, record, scale_ratio=1.0):
        """-> (padded raw image f32, padded pan ids (0 = pad/void),
        is_real, segments_info). Padding is bottom/right with 0s like the
        reference (ref :202-226); ids are >= 1 so 0 never collides."""
        tfm = build_train_transforms(
            self.image_size, self.min_scale * scale_ratio,
            self.max_scale * scale_ratio)
        img = np.asarray(Image.open(record["file_name"]).convert("RGB"))
        tfm.sample(self.rng, img.shape[:2])
        img = tfm.apply_image(img)
        pan = tfm.apply_segmentation(
            rgb2id(np.asarray(
                Image.open(record["pan_seg_file_name"]).convert("RGB")))
        )
        th, tw = self.image_size
        h, w = img.shape[:2]
        pad_img = np.zeros((th, tw, 3), np.float32)
        pad_img[: min(h, th), : min(w, tw)] = img[:th, :tw]
        pad_pan = np.zeros((th, tw), np.int64)
        pad_pan[: min(h, th), : min(w, tw)] = pan[:th, :tw]
        real = np.zeros((th, tw), bool)
        real[: min(h, th), : min(w, tw)] = True
        return pad_img, pad_pan, real, record["segments_info"]

    def _paste(self, main, other):
        """Merge ``other`` onto ``main``: all things + a shuffled random
        prefix of all segments (ref :272-279); pasted ids negated."""
        img, pan, real, segs = main
        o_img, o_pan, o_real, o_segs = other
        all_ids = [s["id"] for s in o_segs if not s.get("iscrowd", 0)]
        always = {s["id"] for s in o_segs
                  if not s.get("iscrowd", 0) and self._is_thing(s)}
        self.rng.shuffle(all_ids)
        keep = self.rng.randint(0, len(all_ids) + 1) if all_ids else 0
        paste_ids = set(all_ids[:keep]) | always
        if not paste_ids:
            return main, []
        pm = np.isin(o_pan, list(paste_ids))
        img = np.where(pm[..., None], o_img, img)
        real = np.where(pm, o_real, real)
        pan = np.where(pm, -o_pan, pan)
        return (img, pan, real, segs), [
            s for s in o_segs if s["id"] in paste_ids]

    def _build_targets(self, pan4, segs, pasted):
        """Slot targets from the merged 4x pan map; same-class stuff from
        the paste image merges into the main slot (ref :305-362).
        Returns (targets, valid_pixel_num)."""
        h4, w4 = pan4.shape
        m = self.max_instances
        labels = np.zeros((m,), np.int32)
        masks = np.zeros((m, h4, w4), np.float32)
        valid = np.zeros((m,), bool)
        semantic = np.full((h4, w4), -1, np.int64)
        slot = 0
        valid_px = 0
        stuff_slot_by_class = {}
        for seg_list, sign in ((segs, 1), (pasted, -1)):
            for seg in seg_list:
                if seg.get("iscrowd", 0):
                    continue
                binary = pan4 == sign * seg["id"]
                n_px = int(binary.sum())
                valid_px += n_px
                if n_px == 0:
                    continue
                cls = seg["category_id"]
                semantic[binary] = cls
                if not self._is_thing(seg) and cls in stuff_slot_by_class:
                    j = stuff_slot_by_class[cls]
                    masks[j] = np.logical_or(masks[j] > 0, binary)
                    continue
                if slot >= m:
                    continue
                if not self._is_thing(seg):
                    stuff_slot_by_class[cls] = slot
                labels[slot] = cls
                masks[slot] = binary
                valid[slot] = True
                slot += 1
        targets = dict(labels=labels, masks=masks, valid=valid,
                       semantic_masks=semantic.astype(np.int32))
        return targets, valid_px

    def __call__(self, record, dataset=None):
        # regeneration threshold scaled down for tiny test fixtures; at the
        # reference's 1281x1281 it equals the reference's 4096 (ref :388)
        h4w4 = ((self.image_size[0] + 3) // 4) * ((self.image_size[1] + 3) // 4)
        thresh = min(self.min_valid_pixels, h4w4 // 4)
        for _attempt in range(20):
            main = self._read(record)
            pasted = []
            if self.copy_paste and dataset is not None and len(dataset) > 1:
                other_rec = dataset[self.rng.randint(0, len(dataset))]
                other = self._read(other_rec, scale_ratio=0.5)
                main, pasted = self._paste(main, other)
            img, pan, real, segs = main
            targets, valid_px = self._build_targets(
                pan[::4, ::4], segs, pasted)
            if targets["valid"].any() and valid_px > thresh:
                break
            if dataset is None or len(dataset) == 0:
                break  # nothing to resample from
            record = dataset[self.rng.randint(0, len(dataset))]
        x = (img - self.pixel_mean) / self.pixel_std
        x = x * real[..., None]
        return dict(images=x, targets=targets)


# ---- COCO instance: registration and training mapper ----------------------

def polygons_to_mask(polygons, height, width):
    """COCO polygon list -> uint8 bitmask (PIL rasterizer — pycocotools'
    frPyObjects is unavailable in this environment; edge handling may
    differ by a sub-pixel on polygon borders)."""
    img = Image.new("1", (width, height), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, np.uint8)


def _ann_to_mask(ann, height, width):
    segm = ann.get("segmentation")
    if isinstance(segm, list):
        return polygons_to_mask(segm, height, width)
    if isinstance(segm, dict):
        return mask_rle.decode(segm).astype(np.uint8)
    return None


def load_coco_instance_json(json_file, image_root):
    """instances_*.json -> (records with each image's annotations,
    {category id: contiguous id}); images whose annotations are all crowd
    are left out."""
    with open(json_file) as f:
        data = json.load(f)
    anns_by_img = {}
    for ann in data.get("annotations", []):
        anns_by_img.setdefault(ann["image_id"], []).append(ann)
    out = []
    for img in data["images"]:
        anns = anns_by_img.get(img["id"], [])
        # reference filters images with only crowd annotations
        # (`instance_kmaxdeeplab_dataset_mapper.py:143-144`)
        if anns and all(a.get("iscrowd", 0) for a in anns):
            continue
        out.append(dict(
            image_id=img["id"],
            file_name=os.path.join(image_root, img["file_name"]),
            height=img["height"], width=img["width"],
            annotations=anns,
        ))
    cats = sorted(c["id"] for c in data.get("categories", []))
    return out, {cid: i for i, cid in enumerate(cats)}


def register_coco_instance(name, image_root, json_file):
    """Register ``name``; "dataset_id_to_contiguous_id" and "thing_ids" are
    set when the records are first loaded."""
    def loader():
        records, cat_map = load_coco_instance_json(json_file, image_root)
        MetadataCatalog.get(name).update(
            dataset_id_to_contiguous_id=cat_map,
            thing_ids=sorted(cat_map),
        )
        return records

    DatasetCatalog.register(name, loader)
    MetadataCatalog.get(name).update(
        image_root=image_root, json_file=json_file, task="instance")


class CocoInstanceMapper:
    """image dict with instance annotations -> padded training sample
    (same target layout as the panoptic mapper; labels are CONTIGUOUS
    thing ids, aux semantic GT = per-pixel contiguous id of the covering
    instance, -1 elsewhere).

    ``copy_paste=True`` (the reference's default instance pretrain recipe,
    `instance_kmaxdeeplab_dataset_mapper.py:286-354`): a second image is
    augmented with a halved scale range, a shuffled random PREFIX of its
    instances is pasted (no all-things rule here, ref :305-309), main
    masks lose occluded pixels and ALL paste-image masks are clipped to
    the pasted region (ref :320-323); empty/low-GT samples regenerate
    (ref :357-366). ``copy_paste=False`` = the ``_nocopypaste`` variant."""

    def __init__(self, *, image_size=(1281, 1281), min_scale=0.2,
                 max_scale=2.0, max_instances=128,
                 pixel_mean=(123.675, 116.28, 103.53),
                 pixel_std=(58.395, 57.12, 57.375),
                 dataset_id_to_contiguous_id=None,
                 copy_paste=True, min_valid_pixels=4096, seed=0):
        self.image_size = tuple(image_size)
        self.max_instances = max_instances
        self.pixel_mean = np.asarray(pixel_mean, np.float32)
        self.pixel_std = np.asarray(pixel_std, np.float32)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.cat_map = dataset_id_to_contiguous_id
        self.copy_paste = copy_paste
        self.min_valid_pixels = min_valid_pixels
        self.rng = np.random.RandomState(seed)

    def _read(self, record, scale_ratio=1.0):
        """-> (padded raw image f32, is_real, full-res padded masks
        (N, th, tw) uint8, contiguous labels list)."""
        tfm = build_train_transforms(
            self.image_size, self.min_scale * scale_ratio,
            self.max_scale * scale_ratio)
        img = np.asarray(Image.open(record["file_name"]).convert("RGB"))
        h0, w0 = img.shape[:2]
        tfm.sample(self.rng, img.shape[:2])
        img = tfm.apply_image(img)
        th, tw = self.image_size
        h, w = img.shape[:2]
        pad_img = np.zeros((th, tw, 3), np.float32)
        pad_img[: min(h, th), : min(w, tw)] = img[:th, :tw]
        real = np.zeros((th, tw), bool)
        real[: min(h, th), : min(w, tw)] = True

        inst_masks, labels = [], []
        for ann in record.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            mask = _ann_to_mask(ann, h0, w0)
            if mask is None:
                continue
            mask = tfm.apply_segmentation(mask)
            pad = np.zeros((th, tw), np.uint8)
            mh, mw = mask.shape[:2]
            pad[: min(mh, th), : min(mw, tw)] = mask[:th, :tw]
            inst_masks.append(pad)
            cid = ann["category_id"]
            labels.append(self.cat_map[cid] if self.cat_map else cid)
        return pad_img, real, inst_masks, labels

    def __call__(self, record, dataset=None):
        th, tw = self.image_size
        h4, w4 = (th + 3) // 4, (tw + 3) // 4
        thresh = min(self.min_valid_pixels, (h4 * w4) // 4)
        for _attempt in range(20):
            img, real, inst_masks, labels = self._read(record)
            if (self.copy_paste and dataset is not None
                    and len(dataset) > 1):
                other_rec = dataset[self.rng.randint(0, len(dataset))]
                o_img, o_real, o_masks, o_labels = self._read(
                    other_rec, scale_ratio=0.5)
                order = list(range(len(o_masks)))
                self.rng.shuffle(order)
                keep = (self.rng.randint(0, len(order) + 1)
                        if order else 0)
                pm = np.zeros((th, tw), bool)
                for i in order[:keep]:
                    pm |= o_masks[i] > 0
                img = np.where(pm[..., None], o_img, img)
                real = np.where(pm, o_real, real)
                # main masks lose occluded pixels; ALL paste-image masks
                # are clipped to the pasted region (ref :320-323)
                inst_masks = [m * (~pm) for m in inst_masks]
                inst_masks += [m * pm for m in o_masks]
                labels = labels + o_labels

            m = self.max_instances
            out_labels = np.zeros((m,), np.int32)
            out_masks = np.zeros((m, h4, w4), np.float32)
            out_valid = np.zeros((m,), bool)
            semantic = np.full((h4, w4), -1, np.int64)
            slot = 0
            valid_px = 0
            for mask, cont in zip(inst_masks, labels):
                m4 = mask[::4, ::4]
                n_px = int((m4 > 0).sum())
                valid_px += n_px
                if n_px == 0 or slot >= m:
                    continue
                out_labels[slot] = cont
                out_masks[slot] = m4 > 0
                out_valid[slot] = True
                semantic[m4 > 0] = cont
                slot += 1
            if out_valid.any() and valid_px > thresh:
                break
            if dataset is None or len(dataset) == 0:
                break
            record = dataset[self.rng.randint(0, len(dataset))]
        x = (img - self.pixel_mean) / self.pixel_std
        x = x * real[..., None]
        return dict(
            images=x,
            targets=dict(labels=out_labels, masks=out_masks,
                         valid=out_valid,
                         semantic_masks=semantic.astype(np.int32)),
        )
