"""kMaX-DeepLab / MaXTron within-clip segmenter and its builder (counterpart
of ``axial_vs_tpu/models/kmax.py``).

backbone -> within-clip module -> pixel decoder -> video transformer
decoder, on channels-last frames (B*T, H, W, 3) that are already normalized
and padded. Submodule names follow the upstream detectron2 checkpoint:
``backbone``, ``sem_seg_head.wc_module``, ``sem_seg_head.pixel_decoder``,
``sem_seg_head.predictor``. So far only the within-clip video model with a
ConvNeXt backbone is ported (no image kMaX, no other backbones).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.init import cast_for_inference, init_parameters
from .backbones.convnext import ConvNeXt
from .pixel_decoder import KMaXPixelDecoder
from .transformer_decoder import KMaXTransformerDecoder
from .wc_module import WithinClipTrackingModule


class _Head(nn.Module):
    def __init__(self, wc_module, pixel_decoder, predictor):
        super().__init__()
        self.wc_module = wc_module
        self.pixel_decoder = pixel_decoder
        self.predictor = predictor


class KMaXSegmenter(nn.Module):
    def __init__(self, backbone, wc_module, pixel_decoder, transformer_decoder,
                 dtype=None):
        super().__init__()
        self.backbone = backbone
        self.sem_seg_head = _Head(wc_module, pixel_decoder, transformer_decoder)
        self.dtype = dtype

    def forward(self, images):
        """images (B*T, H, W, 3) -> {"pred_logits" (B, N, K+1), "pred_masks"
        (B, T, H/4, W/4, N), "pred_mask_embeddings" (B, N, 128),
        "pixel_feature", "aux_outputs", "cluster_centers"}."""
        head = self.sem_seg_head
        x = images if self.dtype is None else images.to(self.dtype)
        features = head.wc_module(self.backbone(x))
        pano, multi_scale = head.pixel_decoder(features)
        return head.predictor(multi_scale, pano, dtype=self.dtype)


def build_backbone(cfg, device=None):
    name = cfg.model.backbone.name
    if not name.startswith("convnext"):
        raise NotImplementedError(f"backbone {name!r} is not ported yet")
    c = cfg.model.backbone.convnext
    if c.use_grn:
        raise NotImplementedError("ConvNeXtV2 (GRN) is not ported yet")
    backbone = ConvNeXt(depths=tuple(c.depths), dims=tuple(c.dims),
                        layer_scale_init_value=c.layer_scale_init_value,
                        out_features=tuple(cfg.model.backbone.out_features),
                        device=device)
    channels = {f"res{i + 2}": d for i, d in enumerate(c.dims)}
    return backbone, channels


def build_segmenter(cfg, device, generator: torch.Generator,
                    num_frames: int | None = None):
    """Build the inference segmenter from a config tree (attribute access,
    the fields of ``axial_vs_tpu.config.get_default_config()``), on
    ``device``, with every parameter drawn from ``generator`` (which must
    live on ``device``). In bf16 the matrices are kept bf16 at rest and the
    vectors f32."""
    w = cfg.model.maxtron.wc
    if not w.enable:
        raise NotImplementedError("only the within-clip model is ported")
    dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else None
    t = num_frames or cfg.input.num_clip_frames
    meta = torch.device("meta")
    backbone, channels = build_backbone(cfg, device=meta)
    wc_module = WithinClipTrackingModule(
        channels, conv_dims=w.conv_dims, nheads=w.nheads,
        dim_feedforward=w.dim_feedforward, num_stages=w.num_stages,
        spatial_layers=w.spatial_layers, temporal_layers=w.temporal_layers,
        temporal_attn_type=w.temporal_attn_type,
        spatial_in_features=tuple(w.spatial_in_features),
        temporal_in_features=tuple(w.temporal_in_features),
        enc_n_points=w.enc_n_points, num_frames=t, device=meta)
    kmax = cfg.model.kmax
    in_features = tuple(sorted(kmax.pixel_dec.in_features, reverse=True))
    pixel_decoder = KMaXPixelDecoder(
        channels, in_features=in_features,
        dec_layers=tuple(kmax.pixel_dec.dec_layers),
        dec_channels=tuple(kmax.pixel_dec.dec_channels),
        layer_types=tuple(kmax.pixel_dec.layer_types), device=meta)
    stage_channels = [s.out_channels for s in pixel_decoder._stages]
    predictor = KMaXTransformerDecoder(
        num_classes=cfg.model.num_classes, in_channels=stage_channels[:3],
        panoptic_channels=stage_channels[-1],
        dec_layers=tuple(kmax.trans_dec.dec_layers),
        num_queries=kmax.trans_dec.num_object_queries, num_frames=t,
        device=meta)
    model = KMaXSegmenter(backbone, wc_module, pixel_decoder, predictor,
                          dtype=dtype)
    model = model.to_empty(device=device)
    init_parameters(model, generator)
    if dtype is not None:
        cast_for_inference(model, dtype)
    return model.eval()
