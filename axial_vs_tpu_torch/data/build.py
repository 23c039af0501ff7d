"""Mapper dispatch: ``cfg.input.dataset_mapper_name`` -> a mapper
(counterpart of ``axial_vs_tpu/data/build.py``).

``dataset_mapper_name: auto`` (the default) resolves from the
meta-architecture and the first training dataset's name, as the JAX
package does. The port has the VIPSeg clip mapper; the COCO, YTVIS and
DVPS mappers are not ported and raise ``NotImplementedError`` naming
themselves.
"""
from __future__ import annotations

from .catalog import MetadataCatalog

#: mapper names of the JAX package that the port does not have yet
_NOT_PORTED = {
    "coco_panoptic_kmaxdeeplab": "the COCO panoptic mapper",
    "coco_panoptic": "the COCO panoptic mapper",
    "coco_instance_kmaxdeeplab": "the COCO instance mapper",
    "coco_instance": "the COCO instance mapper",
    "ytvis": "the YTVIS clip mapper", "ytvis_clip": "the YTVIS clip mapper",
    "dvps": "the DVPS clip mapper", "vipseg_dvps": "the DVPS clip mapper",
    "kitti_step": "the DVPS clip mapper", "vspw": "the DVPS clip mapper",
}


def resolve_mapper_name(cfg) -> str:
    name = cfg.input.dataset_mapper_name
    if name != "auto":
        return name
    arch = cfg.model.meta_architecture
    if arch in ("TubeLinkVIS", "TubeLinkVideoVIS"):
        return "ytvis"
    if arch == "TubeLinkVPS":
        return "dvps"
    train0 = cfg.datasets.train[0] if cfg.datasets.train else ""
    low = train0.lower()
    if low.startswith(("panovspw", "ov_vipseg", "vipseg")):
        return "vipseg_panoptic_mapper"
    if "instance" in low:
        return "coco_instance"
    return "coco_panoptic"


def build_mapper(cfg, seed: int = 0):
    """The training mapper of ``cfg``; its random draws start from
    ``seed``."""
    name = resolve_mapper_name(cfg)
    if name in _NOT_PORTED:
        raise NotImplementedError(f"{_NOT_PORTED[name]} ({name!r}) is not "
                                  "ported")
    if name not in ("vipseg_panoptic_mapper", "vipseg"):
        raise ValueError(f"unknown dataset mapper {name!r}")
    from .vipseg import VIPSegClipMapper

    meta = (MetadataCatalog.get(cfg.datasets.train[0])
            if cfg.datasets.train else {})
    cat_map = dict(meta.get("thing_dataset_id_to_contiguous_id", {}))
    cat_map.update(meta.get("stuff_dataset_id_to_contiguous_id", {}))
    return VIPSegClipMapper(
        image_size=cfg.input.image_size,
        num_frames=cfg.input.num_video_frames,
        min_scale=cfg.input.min_scale,
        max_scale=cfg.input.max_scale,
        max_instances=cfg.model.kmax.trans_dec.num_object_queries,
        random_reverse=cfg.input.random_reverse,
        copy_paste=cfg.input.get("copy_paste", True),
        category_id_map=cat_map or None,
        pixel_mean=cfg.input.pixel_mean,
        pixel_std=cfg.input.pixel_std,
        seed=seed,
    )
