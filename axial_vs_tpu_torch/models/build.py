"""Meta-architecture dispatch: config -> (model, criterion) (counterpart of
``axial_vs_tpu/models/build.py``).

The port builds ``MaXTronWCDeepLab`` and ``KMaXDeepLab`` with a within-clip
(WC) model; every other architecture of the JAX registry (the CC stage,
the Tube-Link models, ``ImageMask2Former``) raises ``NotImplementedError``
naming itself.
"""
from __future__ import annotations

import torch

_PORTED = ("MaXTronWCDeepLab", "KMaXDeepLab")


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


def build_model_and_criterion(cfg, train: bool = True,
                              device=torch.device("cuda"),
                              generator: torch.Generator | None = None):
    """(model, criterion) of ``cfg.model.meta_architecture`` on ``device``,
    its weights drawn from ``generator`` (required, on ``device``)."""
    from .kmax import build_segmenter

    arch = cfg.model.meta_architecture
    if arch not in _PORTED:
        raise NotImplementedError(f"meta-architecture {arch!r} is not ported")
    if not cfg.model.maxtron.wc.enable:
        raise NotImplementedError(f"{arch} without the within-clip module is "
                                  "not ported")
    num_frames = (cfg.input.num_video_frames
                  if arch == "MaXTronWCDeepLab" else 1)
    model = build_segmenter(cfg, device, generator, num_frames=num_frames,
                            train=train)
    return model, criterion_from_config(cfg)
