"""Image Mask2Former, Tube-Link's COCO pretrain model, and its builder
(counterpart of ``axial_vs_tpu/models/tube_link/image_mask2former.py`` and
of the ``ImageMask2Former`` entry of ``axial_vs_tpu/models/build.py``).

It is the Mask2Former tube head at ``num_frames=1`` without MaXTron's
temporal attention (so kernel K2 and no K3): each image is a tube of one
frame, and its masks (B, 1, Q, H, W) squeeze to (B, Q, H, W).
"""
from __future__ import annotations

import torch
from torch import nn

from ..kmax import build_backbone, materialize
from .head import Mask2FormerVideoHeadTube
from .vps import num_things_split


class ImageMask2Former(nn.Module):
    def __init__(self, backbone, in_channels: dict,
                 num_things_classes: int = 80, num_stuff_classes: int = 53,
                 num_queries: int = 100, dtype=None, device=None):
        super().__init__()
        self.backbone = backbone
        self.head = Mask2FormerVideoHeadTube(
            in_channels, num_things_classes, num_stuff_classes,
            num_queries=num_queries, num_frames=1,
            use_temporal_attn=False, device=device)
        self.dtype = dtype

    def forward(self, images, return_query: bool = False, generator=None):
        """images (B, H, W, 3) -> {"cls_preds": [(B, Q, K+1)],
        "mask_preds": [(B, Q, H/4, W/4)]} per decoder layer (and the final
        "query" and "mask_features" with ``return_query``). ``generator``
        draws the backbone's drop-path masks (Swin) in ``train()``."""
        x = images if self.dtype is None else images.to(self.dtype)
        out = self.head(self.backbone(x, generator), return_query=return_query)
        out["mask_preds"] = [m[:, 0] for m in out["mask_preds"]]
        return out


def build_image_mask2former(cfg, device=torch.device("cuda"),
                            generator: torch.Generator | None = None):
    """Build ``ImageMask2Former`` from a config tree (``model.backbone``,
    ``model.num_classes`` split by ``model.num_things``, all things where
    it is unset; ``model.tube_link.num_queries``, ``model.dtype``; the head
    at its default widths, as the JAX registry builds it) on ``device``
    (the card unless the caller asks for another), every parameter drawn
    from ``generator`` (required, on ``device``)."""
    dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else None
    num_things, num_stuff = num_things_split(cfg)
    meta = torch.device("meta")
    backbone, channels = build_backbone(cfg, device=meta)
    model = ImageMask2Former(
        backbone, channels, num_things_classes=num_things,
        num_stuff_classes=num_stuff,
        num_queries=cfg.model.tube_link.num_queries, dtype=dtype, device=meta)
    return materialize(model, device, generator, dtype)
