"""A tiny COCO-format panoptic split for the port's CLI and trainer tests."""
import json

import numpy as np
from PIL import Image


def write_tiny_coco(root, prefix: str) -> str:
    """One 24x32 image with a thing (id 7, category 1) over its left half
    and a stuff segment (id 9, category 3) over its right half, its
    panoptic PNG and JSON under ``root``, registered in the port's catalog
    as ``<prefix>_<root's name>`` (a name starting with ``coco`` is a
    COCO test set to ``Trainer.evaluate``). Returns the name."""
    from axial_vs_tpu_torch.data.coco import register_coco_panoptic

    name = f"{prefix}_{root.name}"
    (root / "imgs").mkdir(parents=True)
    (root / "pans").mkdir()
    rs = np.random.RandomState(0)
    Image.fromarray(rs.randint(0, 256, (24, 32, 3)).astype(np.uint8)).save(
        root / "imgs" / "1.jpg")
    pan = np.zeros((24, 32, 3), np.uint8)
    pan[:, :16, 0], pan[:, 16:, 0] = 7, 9
    Image.fromarray(pan).save(root / "pans" / "1.png")
    with open(root / "panoptic.json", "w") as f:
        json.dump(dict(
            images=[dict(id=1, file_name="1.jpg", height=24, width=32)],
            annotations=[dict(image_id=1, file_name="1.png", segments_info=[
                dict(id=7, category_id=1, iscrowd=0),
                dict(id=9, category_id=3, iscrowd=0)])],
            categories=[dict(id=1, isthing=1), dict(id=3, isthing=0)]), f)
    register_coco_panoptic(name, str(root / "imgs"), str(root / "pans"),
                           str(root / "panoptic.json"))
    return name
