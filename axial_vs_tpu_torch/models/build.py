"""Meta-architecture dispatch: config -> (model, criterion) (counterpart of
``axial_vs_tpu/models/build.py``).

The port builds ``MaXTronWCDeepLab`` (the within-clip (WC) model) and
``KMaXDeepLab`` (the image model, T = 1, with the spatial-only WC module or
without one); ``MaXTronCCDeepLab``: the cross-clip (CC) model, a frozen WC
segmenter of ``input.num_clip_frames`` frames under the CC module of
``model.maxtron.cc``, its clips aligned by the device auction, with the
criterion of the class and mask losses; and the Tube-Link models, each with
the Tube-Link criterion of ``model.tube_link``'s weights and the device
auction (``_tube_criterion``): ``TubeLinkVIS``
(``models/tube_link/detector.py::build_tube_link_vis``), with or without
MaXTron's temporal attention (``model.tube_link.use_temporal_attn``);
``TubeLinkVPS`` (``vps.py::build_tube_link_vps``), ``TubeLinkVideoVIS``
(``cc_detector.py::build_tube_link_video_vis``) and ``ImageMask2Former``
(``image_mask2former.py::build_image_mask2former``), the panoptic ones
splitting ``model.num_classes`` by ``model.num_things`` (all things where it
is unset). A Tube-Link model built for training is f32 throughout (its
weights and its compute), as JAX's registry builds it; for inference it
keeps the yaml's ``model.dtype``. Any other architecture raises
``NotImplementedError`` naming itself.
"""
from __future__ import annotations

import torch

_PORTED = ("MaXTronWCDeepLab", "KMaXDeepLab", "MaXTronCCDeepLab",
           "TubeLinkVIS", "TubeLinkVPS", "TubeLinkVideoVIS",
           "ImageMask2Former")


def criterion_from_config(cfg):
    """The set criterion of ``cfg.model.kmax``'s loss weights and options,
    with exact matching (scipy on the host), as the JAX builder's."""
    from ..losses.criterion import SetCriterion

    kmax = cfg.model.kmax
    weights = {
        "loss_ce": kmax.class_weight,
        "loss_mask": kmax.mask_weight,
        "loss_dice": kmax.dice_weight,
        "loss_pixel_insdis": kmax.insdis_weight,
        "loss_aux_semantic": kmax.aux_semantic_weight,
    }
    return SetCriterion(
        num_classes=cfg.model.num_classes,
        weights=weights,
        eos_coef=kmax.no_object_weight,
        share_final_matching=kmax.share_final_matching,
        pixel_insdis_temperature=kmax.pixel_insdis_temperature,
        pixel_insdis_sample_k=kmax.pixel_insdis_sample_k,
        aux_semantic_temperature=kmax.aux_semantic_temperature,
        aux_semantic_sample_k=kmax.aux_semantic_sample_k,
        masking_void_pixel=kmax.masking_void_pixel,
    )


def _tube_criterion(cfg):
    """The Tube-Link criterion of ``cfg.model.tube_link``'s loss weights,
    matched by the device auction, as the JAX builder's."""
    from .tube_link.criterion import TubeLinkCriterion

    tl = cfg.model.tube_link
    return TubeLinkCriterion(
        num_things=cfg.model.num_classes, cls_weight=tl.cls_weight,
        mask_weight=tl.mask_weight, dice_weight=tl.dice_weight,
        bg_cls_weight=tl.bg_cls_weight, num_points=tl.num_points,
        exact_matching=False)


def _tube_link_builders() -> dict:
    from .tube_link.cc_detector import build_tube_link_video_vis
    from .tube_link.detector import build_tube_link_vis
    from .tube_link.image_mask2former import build_image_mask2former
    from .tube_link.vps import build_tube_link_vps

    return {"TubeLinkVIS": build_tube_link_vis,
            "TubeLinkVPS": build_tube_link_vps,
            "TubeLinkVideoVIS": build_tube_link_video_vis,
            "ImageMask2Former": build_image_mask2former}


def build_model_and_criterion(cfg, train: bool = True,
                              device=torch.device("cuda"),
                              generator: torch.Generator | None = None):
    """(model, criterion) of ``cfg.model.meta_architecture`` on ``device``,
    its weights drawn from ``generator`` (required, on ``device``)."""
    from .kmax import build_segmenter

    arch = cfg.model.meta_architecture
    if arch not in _PORTED:
        raise NotImplementedError(f"meta-architecture {arch!r} is not ported")
    tube_link = _tube_link_builders().get(arch)
    if tube_link is not None:
        if train:
            # JAX's registry builds the Tube-Link models without a dtype:
            # they train with f32 weights and f32 compute, whatever the yaml
            cfg = cfg.clone()
            cfg.model.dtype = "float32"
        model = tube_link(cfg, device, generator)
        return model.train(train), _tube_criterion(cfg)
    if arch == "MaXTronCCDeepLab":
        return _build_maxtron_cc(cfg, train, device, generator)
    num_frames = (cfg.input.num_video_frames
                  if arch == "MaXTronWCDeepLab" else 1)
    model = build_segmenter(cfg, device, generator, num_frames=num_frames,
                            train=train)
    return model, criterion_from_config(cfg)


def _build_maxtron_cc(cfg, train, device, generator):
    """The CC model, as the JAX package builds it: the segmenter for
    inference (its dtype the config's), then the CC module in f32, both
    drawn from ``generator``; the alignment is the auction.
    The CC module is in ``train()`` if ``train``, the segmenter always in
    ``eval()``."""
    from .cc_module import CrossClipTrackingModule
    from .kmax import build_segmenter, materialize
    from .maxtron_cc import MaXTronCCModel

    clip = cfg.input.num_clip_frames
    segmenter = build_segmenter(cfg, device, generator, num_frames=clip)
    cc = cfg.model.maxtron.cc
    cc_module = materialize(CrossClipTrackingModule(
        num_classes=cfg.model.num_classes, num_layers=cc.num_layers,
        num_clip_frames=clip, kernel_sizes=tuple(cc.kernel_sizes),
        atrous_rates=tuple(cc.atrous_rates), attn_drop=cc.attn_drop,
        aspp_drop=cc.aspp_drop, norm_fn=cc.norm_fn,
        device=torch.device("meta")), device, generator, None, train)
    model = MaXTronCCModel(segmenter, cc_module,
                           num_clip_frames=clip).train(train)
    criterion = criterion_from_config(cfg)
    criterion.losses = ("labels", "masks")  # the CC supervises class + mask
    return model, criterion
