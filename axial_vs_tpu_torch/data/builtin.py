"""Builtin VIPSeg and YouTube-VIS registration into the port's own catalog
(counterpart of the VIPSeg part of ``axial_vs_tpu/data/builtin.py``; the
COCO, ADE20k, Cityscapes and OV-VIPSeg registrations are not ported).

``register_all(root)`` registers ``panoVSPW_vps_video_{train,val}`` for
each split whose JSON lies on disk:

  <root>/VIPSeg/
      imgs/<video_id>/*.jpg
      panomasks/<video_id>/*.png
      panoVIPSeg_{train,val}.json

and the YTVIS-format sets the Tube-Link configs name (the JAX package
registers none: its callers use ``data/ytvis.py::register_ytvis``), in
detectron2's layout: ``ytvis_{2019,2021}_{train,val}`` from
``<root>/ytvis_<year>/{train,valid}.json`` with frames under
``<root>/ytvis_<year>/{train,valid}/JPEGImages``, and ``ovis_{train,val}``
from ``<root>/ovis/annotations_{train,valid}.json`` with frames under
``<root>/ovis/{train,valid}``.

Importing the module registers under ``$AXIALVS_DATASETS`` (default
``./datasets``), as the JAX module does.
"""
from __future__ import annotations

import json
import os

from .catalog import DatasetCatalog
from .vipseg import register_vipseg_video, set_panoptic_metadata
from .ytvis import register_ytvis

#: YTVIS-format sets: name -> (frames, JSON) under the root
_SPLITS = (("train", "train"), ("val", "valid"))
_YTVIS = {f"{d}_{split}": (f"{d}/{folder}/JPEGImages", f"{d}/{folder}.json")
          for d in ("ytvis_2019", "ytvis_2021")
          for split, folder in _SPLITS}
_YTVIS.update({f"ovis_{split}": (f"ovis/{folder}",
                                 f"ovis/annotations_{folder}.json")
               for split, folder in _SPLITS})


def register_all(root: str):
    """Register each VIPSeg and YTVIS-format split found under ``root``;
    returns the names registered by this call."""
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
    for name, (frames, json_file) in _YTVIS.items():
        json_file = os.path.join(root, json_file)
        if not os.path.exists(json_file) or name in DatasetCatalog:
            continue
        register_ytvis(name, os.path.join(root, frames), json_file)
        names.append(name)
    return names


register_all(os.environ.get("AXIALVS_DATASETS", "datasets"))
