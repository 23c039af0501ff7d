"""Tube-Link offline video instance segmentation with cross-clip (CC)
tracking: the detector and its builder (counterpart of
``axial_vs_tpu/models/tube_link/cc_detector.py`` and of the
``TubeLinkVideoVIS`` entry of ``axial_vs_tpu/models/build.py``).

The frozen within-clip tube detector (backbone + Mask2Former tube head,
``wc_head_wrapper``) runs clip by clip without gradients; each clip's
final decoder queries pass through ``num_cc_layers`` of [trajectory
attention over (clips x queries) tokens, kernel K3 with the clips as its
frames, + 1-D ASPP over the clip axis + LayerNorms]. After each CC layer
``activation_proj`` softmax-pools the queries over the clips into one
video-level class logit, and per-clip mask embeddings give each clip's
masks on that clip's mask features.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers.convbn import Linear
from ...layers.trajectory_attention import TrajectoryAttention
from ...ops.norm import LayerNorm
from ..cc_module import TemporalASPP1D
from ..kmax import build_backbone, materialize
from .head import Mask2FormerVideoHeadTube

# The CC layers' 1-D ASPP over the clip axis, as JAX's defaults.
ASPP_KERNEL_SIZES = (3, 3, 3)
ASPP_ATROUS_RATES = (1, 2, 3)


class TubeLinkCCLayers(nn.Module):
    """CC refinement of per-clip queries (T_clips, Q, C): per layer,
    trajectory attention (8 heads, one ``qkv``) on (1, T*Q, C) with the
    clips as frames, residual, ``attn_norm{i}``; ASPP over the clip axis
    per query, residual, ``conv_norm{i}``. Returns every layer's queries."""

    def __init__(self, channels: int = 256, num_cc_layers: int = 4,
                 device=None):
        super().__init__()
        self.num_cc_layers = num_cc_layers
        for i in range(num_cc_layers):
            setattr(self, f"trajectory_attn{i}", TrajectoryAttention(
                channels, 8, fused_qkv=True, device=device))
            setattr(self, f"attn_norm{i}",
                    LayerNorm(channels, eps=1e-5, device=device))
            setattr(self, f"aspp{i}", TemporalASPP1D(
                channels, ASPP_KERNEL_SIZES, ASPP_ATROUS_RATES,
                norm_fn="ln", device=device))
            setattr(self, f"conv_norm{i}",
                    LayerNorm(channels, eps=1e-5, device=device))

    def forward(self, clip_queries):
        t, q, c = clip_queries.shape
        outs, x = [], clip_queries
        for i in range(self.num_cc_layers):
            tokens = x.reshape(1, t * q, c)
            attn = getattr(self, f"trajectory_attn{i}")(tokens, num_frames=t)
            tokens = getattr(self, f"attn_norm{i}")(tokens + attn)
            per_query = tokens.reshape(t, q, c).transpose(0, 1)  # (Q, T, C)
            per_query = getattr(self, f"conv_norm{i}")(
                per_query + getattr(self, f"aspp{i}")(per_query))
            x = per_query.transpose(0, 1)
            outs.append(x)
        return outs


class TubeLinkVideoVIS(nn.Module):
    """Frozen WC tube detector + CC layers and their heads."""

    def __init__(self, backbone, in_channels: dict,
                 num_things_classes: int = 40, num_queries: int = 100,
                 num_frames: int = 2, num_cc_layers: int = 4,
                 feat_channels: int = 256, use_temporal_attn: bool = True,
                 dtype=None, device=None):
        super().__init__()
        c = feat_channels
        self.num_frames = num_frames
        self.backbone = backbone
        self.wc_head_wrapper = Mask2FormerVideoHeadTube(
            in_channels, num_things_classes, num_queries=num_queries,
            feat_channels=c, num_frames=num_frames,
            use_temporal_attn=use_temporal_attn, device=device)
        self.cc_layers = TubeLinkCCLayers(c, num_cc_layers, device=device)
        self.activation_proj = Linear(c, 1, device=device)
        self.cls_embed = Linear(c, num_things_classes + 1, device=device)
        self.mask_embed1 = Linear(c, c, device=device)
        self.mask_embed2 = Linear(c, c, device=device)
        self.mask_embed3 = Linear(c, c, device=device)
        self.dtype = dtype

    def train(self, mode: bool = True):
        """The frozen detector stays in ``eval()``."""
        super().train(mode)
        self.backbone.eval()
        self.wc_head_wrapper.eval()
        return self

    def forward(self, images, generator=None):
        """images (T_clips * V, H, W, 3), one video of clips of V =
        ``num_frames`` frames -> {"cls_preds": [(1, Q, K+1)] and
        "mask_preds": [(1, T*V, Q, h, w)], one entry per CC layer}.
        ``generator`` goes unused: the CC layers' dropouts are 0."""
        v = self.num_frames
        total = images.shape[0]
        if total % v:
            raise ValueError(f"{total} frames are not a whole number of "
                             f"clips of {v}")
        x = images if self.dtype is None else images.to(self.dtype)
        clip_queries, clip_mask_feats = [], []
        with torch.no_grad():
            for ci in range(total // v):
                out = self.wc_head_wrapper(
                    self.backbone(x[ci * v:(ci + 1) * v]), return_query=True)
                clip_queries.append(out["query"][0])           # (Q, C)
                clip_mask_feats.append(out["mask_features"][0])  # (V, H, W, C)
        queries = torch.stack(clip_queries)      # (T, Q, C)
        mask_feats = torch.stack(clip_mask_feats)  # (T, V, H, W, C)

        cls_list, mask_list = [], []
        for layer_q in self.cc_layers(queries):
            # video-level class: activation-weighted pooling over the clips
            w = F.softmax(self.activation_proj(layer_q).float(), 0)
            pooled = (layer_q.float() * w).sum(0)  # (Q, C)
            cls_list.append(self.cls_embed(pooled.to(layer_q.dtype))[None])
            y = F.relu(self.mask_embed1(layer_q))
            y = self.mask_embed3(F.relu(self.mask_embed2(y)))
            masks = torch.einsum("tqc,tvhwc->tvqhw", y, mask_feats)
            mask_list.append(masks.reshape(1, -1, *masks.shape[2:]))
        return {"cls_preds": cls_list, "mask_preds": mask_list}


def build_tube_link_video_vis(cfg, device=torch.device("cuda"),
                              generator: torch.Generator | None = None):
    """Build ``TubeLinkVideoVIS`` from a config tree (``model.backbone``,
    ``model.num_classes``, ``model.tube_link``'s ``num_queries`` and
    ``use_temporal_attn``, ``model.maxtron.cc.num_layers``,
    ``model.dtype``, ``input.num_clip_frames`` frames a clip; the head at
    its default widths, as the JAX registry builds it) on ``device`` (the
    card unless the caller asks for another), every parameter drawn from
    ``generator`` (required, on ``device``)."""
    tl = cfg.model.tube_link
    dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else None
    meta = torch.device("meta")
    backbone, channels = build_backbone(cfg, device=meta)
    model = TubeLinkVideoVIS(
        backbone, channels, num_things_classes=cfg.model.num_classes,
        num_queries=tl.num_queries, num_frames=cfg.input.num_clip_frames,
        num_cc_layers=cfg.model.maxtron.cc.num_layers,
        use_temporal_attn=tl.use_temporal_attn, dtype=dtype, device=meta)
    return materialize(model, device, generator, dtype)
