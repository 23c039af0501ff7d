"""Builtin dataset registration into the port's own catalog (counterpart of
``axial_vs_tpu/data/builtin.py``; the OV-VIPSeg registration is not
ported).

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

The COCO-format image sets, as the JAX module lays them out:
``coco_2017_{train,val}_panoptic`` from
``<root>/coco/annotations/panoptic_{train,val}2017.json`` (PNGs under
``annotations/panoptic_{split}2017``, images under ``<root>/coco/
{split}2017``) and ``coco_2017_{train,val}_instance`` from
``annotations/instances_{split}2017.json``; ``ade20k_panoptic_{train,val}``
and ``ade20k_instance_{train,val}`` from ``<root>/ADEChallengeData2016/
ade20k_{panoptic,instance}_{split}.json`` (images under ``images/training``
or ``images/validation``, PNGs under ``ade20k_panoptic_{split}``); and
``cityscapes_fine_panoptic_{train,val}`` from ``<root>/cityscapes/gtFine/
cityscapes_panoptic_{split}.json`` (PNGs beside it under
``cityscapes_panoptic_{split}``, images under ``leftImg8bit/{split}``).

Importing the module registers under ``$AXIALVS_DATASETS`` (default
``./datasets``), as the JAX module does.
"""
from __future__ import annotations

import json
import os

from .catalog import DatasetCatalog
from .coco import register_coco_instance, register_coco_panoptic
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


def _coco_format_sets(root: str):
    """{name: ("panoptic", images, PNGs, JSON) or ("instance", images,
    JSON)}: the COCO, ADE20k and Cityscapes sets, paths under ``root``."""
    coco, ade = os.path.join(root, "coco"), os.path.join(
        root, "ADEChallengeData2016")
    city = os.path.join(root, "cityscapes")
    ann = os.path.join(coco, "annotations")
    sets = {}
    for split in ("train", "val"):
        images = os.path.join(coco, f"{split}2017")
        sets[f"coco_2017_{split}_panoptic"] = (
            "panoptic", images, os.path.join(ann, f"panoptic_{split}2017"),
            os.path.join(ann, f"panoptic_{split}2017.json"))
        sets[f"coco_2017_{split}_instance"] = (
            "instance", images, os.path.join(ann, f"instances_{split}2017.json"))
        images = os.path.join(ade, "images/training" if split == "train"
                              else "images/validation")
        sets[f"ade20k_panoptic_{split}"] = (
            "panoptic", images, os.path.join(ade, f"ade20k_panoptic_{split}"),
            os.path.join(ade, f"ade20k_panoptic_{split}.json"))
        sets[f"ade20k_instance_{split}"] = (
            "instance", images,
            os.path.join(ade, f"ade20k_instance_{split}.json"))
        sets[f"cityscapes_fine_panoptic_{split}"] = (
            "panoptic", os.path.join(city, "leftImg8bit", split),
            os.path.join(city, "gtFine", f"cityscapes_panoptic_{split}"),
            os.path.join(city, "gtFine", f"cityscapes_panoptic_{split}.json"))
    return sets


def register_all(root: str):
    """Register each VIPSeg, YTVIS-format and COCO-format split found under
    ``root``; returns the names registered by this call."""
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
    for name, (kind, *paths) in _coco_format_sets(root).items():
        if not os.path.exists(paths[-1]) or name in DatasetCatalog:
            continue
        if kind == "panoptic":
            register_coco_panoptic(name, *paths)
        else:
            register_coco_instance(name, *paths)
        names.append(name)
    return names


register_all(os.environ.get("AXIALVS_DATASETS", "datasets"))
