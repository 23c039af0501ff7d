"""Synthetic VIPSeg-format videos from a seed, for the port's benches and
its card smoke run (the layout of the repo's test fixture
``tests/fixtures_vipseg.py``, written the way the builtin registration
reads it).

Each video: a moving thing box (segment 1) and a static thing (segment 4)
over a stuff background (segment 2) on a noise image; jpg frames under
``imgs/<video>/``, panoptic pngs (``id2rgb``) under ``panomasks/<video>/``,
and one ``panoVIPSeg_<split>.json`` per split naming the same videos, with
``num_classes`` categories, the first ``num_things`` of them things (VIPSeg
has 124 and 58).

``write_ytvis_videos`` writes the repo's YouTube-VIS test fixture
(``tests/fixtures_ytvis.py::synthesize_ytvis_videos``) byte for byte: png
frames under ``frames/v<i>/`` and a ``train.json`` with per-frame RLE tubes
of two things, a moving box (category 1) and a static box (category 2), on
4-aligned positions so that the OS4 mask grid holds them exactly.

``write_coco_panoptic`` writes COCO-format panoptic images (png images,
panoptic pngs and one JSON, in the layout ``data/coco.py`` reads) with
COCO's 133 categories, 80 things then 53 stuff.
"""
from __future__ import annotations

import json
import os

import numpy as np

VIPSEG_CLASSES, VIPSEG_THINGS = 124, 58
COCO_CLASSES, COCO_THINGS = 133, 80


def write_vipseg_videos(root: str, lengths=(6, 18), hw=(720, 1280),
                        seed: int = 0, splits=("val",), thing: int = 3,
                        stuff: int = 100, num_classes: int = VIPSEG_CLASSES,
                        num_things: int = VIPSEG_THINGS):
    """Write one video of each length in ``lengths`` under ``root``.
    Returns ((image root, panoptic root, JSON path of the first split),
    the category dicts)."""
    from PIL import Image

    from .panoptic_utils import id2rgb

    rng = np.random.RandomState(seed)
    h, w = hw
    img_root = os.path.join(root, "imgs")
    pan_root = os.path.join(root, "panomasks")
    videos = []
    for v, n_frames in enumerate(lengths):
        vid = f"video{v}"
        os.makedirs(os.path.join(img_root, vid))
        os.makedirs(os.path.join(pan_root, vid))
        base = rng.randint(0, 160, (h, w, 3)).astype(np.uint8)
        images, annotations = [], []
        for f in range(n_frames):
            img, pan = base.copy(), np.full((h, w), 2, np.int32)
            x0, y0 = (40 + 25 * f + 60 * v) % (w - 220), (60 + 12 * f) % (h - 260)
            img[y0:y0 + 240, x0:x0 + 200] = [200, 60 + (10 * f) % 19, 40]
            pan[y0:y0 + 240, x0:x0 + 200] = 1
            img[50:170, w - 260:w - 60] = [30, 200, 180]
            pan[50:170, w - 260:w - 60] = 4
            Image.fromarray(img).save(
                os.path.join(img_root, vid, f"{f:05d}.jpg"), quality=90)
            Image.fromarray(id2rgb(pan)).save(
                os.path.join(pan_root, vid, f"{f:05d}.png"))
            images.append(dict(id=f"{vid}_{f}", file_name=f"{f:05d}.jpg",
                               height=h, width=w))
            annotations.append(dict(
                image_id=f"{vid}_{f}", file_name=f"{f:05d}.png",
                segments_info=[
                    dict(id=1, category_id=thing, iscrowd=0, isthing=True),
                    dict(id=4, category_id=thing, iscrowd=0, isthing=True),
                    dict(id=2, category_id=stuff, iscrowd=0, isthing=False)]))
        videos.append(dict(video_id=vid, images=images,
                           annotations=annotations))
    categories = [dict(id=i, name=f"class{i}", isthing=int(i < num_things))
                  for i in range(num_classes)]
    json_files = [os.path.join(root, f"panoVIPSeg_{s}.json") for s in splits]
    for path in json_files:
        with open(path, "w") as f:
            json.dump(dict(videos=videos, categories=categories), f)
    return (img_root, pan_root, json_files[0]), categories


def write_ytvis_videos(root: str, n_videos: int = 2, n_frames=8,
                       hw=(96, 160), seed: int = 0,
                       compress_level: int | None = None):
    """Write (where absent) the frames and ``train.json`` of ``n_videos``
    YTVIS-format videos of ``n_frames`` frames each (or one length a video,
    a sequence) at ``hw`` under ``<root>/ytvis_<h>x<w>``. The PNGs are
    saved at zlib level ``compress_level`` (None: PIL's default, which
    gives the test fixture's bytes; 0 stores the noisy frames, several
    times faster to write and read at 720x1280). Returns (image root,
    JSON path)."""
    from PIL import Image

    from .mask_rle import encode

    h, w = hw
    lengths = ([n_frames] * n_videos if isinstance(n_frames, int)
               else list(n_frames))
    root = os.path.join(root, f"ytvis_{h}x{w}")
    img_root = os.path.join(root, "frames")
    json_path = os.path.join(root, "train.json")
    rng = np.random.RandomState(seed)

    videos, annotations = [], []
    ann_id = 1
    for v, length in enumerate(lengths):
        os.makedirs(os.path.join(img_root, f"v{v}"), exist_ok=True)
        base = rng.randint(20, 90, (h, w, 3)).astype(np.uint8)
        files, masks1, masks2 = [], [], []
        for f in range(length):
            rel = f"v{v}/{f:03d}.png"
            files.append(rel)
            img = base.copy()
            m1 = np.zeros((h, w), np.uint8)
            m2 = np.zeros((h, w), np.uint8)
            x0, y0 = 8 + 4 * f + 8 * v, 12 + 4 * v  # moves 4 px a frame
            img[y0:y0 + 32, x0:x0 + 40] = [210, 60, 50]
            m1[y0:y0 + 32, x0:x0 + 40] = 1
            img[56:84, 112:148] = [50, 200, 90]  # static, off the mover's track
            m2[56:84, 112:148] = 1
            path = os.path.join(img_root, rel)
            if not os.path.exists(path):
                Image.fromarray(img).save(path, **(
                    {} if compress_level is None
                    else {"compress_level": compress_level}))
            masks1.append(m1)
            masks2.append(m2)
        videos.append(dict(id=v + 1, file_names=files, height=h, width=w,
                           length=length))
        for cat, masks in ((1, masks1), (2, masks2)):
            annotations.append(dict(
                id=ann_id, video_id=v + 1, category_id=cat,
                segmentations=[encode(m) for m in masks],
                areas=[int(m.sum()) for m in masks], iscrowd=0))
            ann_id += 1

    if not os.path.exists(json_path):
        with open(json_path, "w") as fh:
            json.dump(dict(videos=videos, annotations=annotations,
                           categories=[dict(id=1, name="mover"),
                                       dict(id=2, name="sitter")]), fh)
    return img_root, json_path


def write_coco_panoptic(root: str, n_images: int = 3, hw=(480, 640),
                        seed: int = 0):
    """Write ``n_images`` COCO-format panoptic images at ``hw`` under
    ``root``: a stuff background of two classes (top and bottom halves) and
    three thing boxes of drawn classes and places, each segment a flat
    colour with noise; png images under ``images/``, panoptic pngs under
    ``panoptic/`` and ``panoptic.json`` with ``COCO_CLASSES`` categories of
    ids 1-133 (the first ``COCO_THINGS`` things). Returns (image root,
    panoptic root, JSON path)."""
    from PIL import Image

    from .panoptic_utils import id2rgb

    rng = np.random.RandomState(seed)
    h, w = hw
    img_root, pan_root = (os.path.join(root, d) for d in ("images", "panoptic"))
    os.makedirs(img_root)
    os.makedirs(pan_root)
    images, annotations = [], []
    for i in range(n_images):
        pan = np.full((h, w), 1, np.int32)
        pan[h // 2:] = 2
        segments = [dict(id=s, category_id=int(rng.randint(COCO_THINGS + 1,
                                                           COCO_CLASSES + 1)),
                         iscrowd=0) for s in (1, 2)]
        for s in (3, 4, 5):
            bh, bw = rng.randint(h // 8, h // 3), rng.randint(w // 8, w // 3)
            y, x = rng.randint(0, h - bh), rng.randint(0, w - bw)
            pan[y:y + bh, x:x + bw] = s
            segments.append(dict(id=s, category_id=int(rng.randint(
                1, COCO_THINGS + 1)), iscrowd=0))
        colours = rng.randint(0, 256, (6, 3))
        img = np.clip(colours[pan] + rng.randint(-20, 21, (h, w, 3)), 0, 255)
        name = f"{i:012d}.png"
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(img_root, name), compress_level=1)
        Image.fromarray(id2rgb(pan)).save(os.path.join(pan_root, name))
        images.append(dict(id=i, file_name=name, height=h, width=w))
        annotations.append(dict(image_id=i, file_name=name,
                                segments_info=segments))
    categories = [dict(id=c, name=f"class{c}", isthing=int(c <= COCO_THINGS))
                  for c in range(1, COCO_CLASSES + 1)]
    json_file = os.path.join(root, "panoptic.json")
    with open(json_file, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=categories), f)
    return img_root, pan_root, json_file
