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
"""
from __future__ import annotations

import json
import os

import numpy as np

VIPSEG_CLASSES, VIPSEG_THINGS = 124, 58


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
