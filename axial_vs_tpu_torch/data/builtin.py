"""Builtin VIPSeg registration into the port's own catalog (counterpart of
the VIPSeg part of ``axial_vs_tpu/data/builtin.py``; the COCO, ADE20k,
Cityscapes and OV-VIPSeg registrations are not ported).

``register_all(root)`` registers ``panoVSPW_vps_video_{train,val}`` for
each split whose JSON lies on disk:

  <root>/VIPSeg/
      imgs/<video_id>/*.jpg
      panomasks/<video_id>/*.png
      panoVIPSeg_{train,val}.json

Importing the module registers under ``$AXIALVS_DATASETS`` (default
``./datasets``), as the JAX module does.
"""
from __future__ import annotations

import json
import os

from .catalog import DatasetCatalog
from .vipseg import register_vipseg_video, set_panoptic_metadata


def register_all(root: str):
    """Register each VIPSeg split found under ``root``; returns the names
    registered by this call."""
    base = os.path.join(root, "VIPSeg")
    names = []
    for split in ("train", "val"):
        json_file = os.path.join(base, f"panoVIPSeg_{split}.json")
        name = f"panoVSPW_vps_video_{split}"
        if not os.path.exists(json_file) or name in DatasetCatalog:
            continue
        meta = register_vipseg_video(
            name, image_root=os.path.join(base, "imgs"),
            panoptic_root=os.path.join(base, "panomasks"),
            json_file=json_file)
        with open(json_file) as f:
            set_panoptic_metadata(meta, json.load(f).get("categories", []))
        names.append(name)
    return names


register_all(os.environ.get("AXIALVS_DATASETS", "datasets"))
