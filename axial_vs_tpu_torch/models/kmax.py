"""kMaX-DeepLab / MaXTron within-clip segmenter and its builder (counterpart
of ``axial_vs_tpu/models/kmax.py``).

backbone -> within-clip module -> pixel decoder -> video transformer
decoder, on channels-last frames (B*T, H, W, 3) that are already normalized
and padded. Submodule names follow the upstream detectron2 checkpoint:
``backbone``, ``sem_seg_head.wc_module``, ``sem_seg_head.pixel_decoder``,
``sem_seg_head.predictor``. So far only the within-clip video model with a
ConvNeXt or ResNet backbone is ported (no image kMaX, no other backbones).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.init import cast_for_inference, init_parameters
from .backbones.convnext import ConvNeXt
from .backbones.resnet import ResNet
from .backbones.resnet import out_channels as resnet_channels
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

    def forward(self, images, generator=None):
        """images (B*T, H, W, 3) -> {"pred_logits" (B, N, K+1), "pred_masks"
        (B, T, H/4, W/4, N), "pred_mask_embeddings" (B, N, 128),
        "pixel_feature", "aux_outputs", "cluster_centers"}, and in
        ``train()`` with the semantic head "aux_semantic_pred" (B, T, H/4,
        W/4, K+1). ``generator`` draws the dropout and drop-path masks in
        ``train()``."""
        head = self.sem_seg_head
        x = images if self.dtype is None else images.to(self.dtype)
        features = head.wc_module(self.backbone(x, generator), generator)
        pano, semantic, multi_scale = head.pixel_decoder(features, generator)
        return head.predictor(multi_scale, pano, semantic, dtype=self.dtype,
                              generator=generator)


def build_backbone(cfg, device=None, *, block_kernel: str = "dwln"):
    """(backbone, {res*: channels}) for a ``resnet*`` or ``convnext*``
    backbone config. ``block_kernel`` is the ConvNeXt blocks' route at
    inference (``"dwln"``, ``"mlp"`` or ``"block"``, see
    ``backbones/convnext.py``); a ResNet has no such blocks. A ConvNeXt
    takes the config's ``drop_path_rate`` and ``backbone.remat`` (both act
    in ``train()`` only)."""
    name = cfg.model.backbone.name
    out_features = tuple(cfg.model.backbone.out_features)
    if name.startswith("resnet"):
        depth = cfg.model.backbone.resnet.depth
        return (ResNet(depth, out_features, device=device),
                resnet_channels(depth))
    if not name.startswith("convnext"):
        raise NotImplementedError(f"backbone {name!r} is not ported yet")
    c = cfg.model.backbone.convnext
    if c.use_grn:
        raise NotImplementedError("ConvNeXtV2 (GRN) is not ported yet")
    backbone = ConvNeXt(depths=tuple(c.depths), dims=tuple(c.dims),
                        layer_scale_init_value=c.layer_scale_init_value,
                        out_features=out_features, block_kernel=block_kernel,
                        drop_path_rate=c.drop_path_rate,
                        remat=bool(cfg.model.backbone.get("remat", False)),
                        device=device)
    channels = {f"res{i + 2}": d for i, d in enumerate(c.dims)}
    return backbone, channels


def materialize(model: nn.Module, device, generator, dtype,
                train: bool = False):
    """Allocate a model built on the meta device on ``device``, draw every
    parameter from ``generator`` and, for inference in bf16, keep the
    matrices bf16 at rest and the vectors f32. Returns it in eval mode, or
    with ``train`` in train mode with every parameter f32 (the master
    weights; in bf16 the layers cast them at use)."""
    if generator is None:
        raise TypeError("pass a torch.Generator on the model's device: the "
                        "random weights are drawn from it")
    model = model.to_empty(device=device)
    init_parameters(model, generator)
    if train:
        return model.train()
    if dtype is not None:
        cast_for_inference(model, dtype)
    return model.eval()


def build_segmenter(cfg, device=torch.device("cuda"),
                    generator: torch.Generator | None = None,
                    num_frames: int | None = None, *,
                    block_kernel: str = "dwln", train: bool = False):
    """Build the segmenter from a config tree (the port's own,
    ``axial_vs_tpu_torch.config.get_default_config()`` with a yaml of
    ``configs/`` merged in), on ``device`` (the card unless the caller asks
    for another), with every parameter drawn from ``generator`` (required;
    it must live on ``device``). For inference (the default) the model is
    returned in ``eval()``; in bf16 the matrices are kept bf16 at rest and
    the vectors f32. ``block_kernel`` is the ConvNeXt blocks' route at
    inference: ``"dwln"`` (K1 + two Linear layers, the default), ``"mlp"``
    (K1 + K5) or ``"block"`` (K4).

    ``train=True`` returns the model in ``train()`` with every parameter
    f32, and adds the auxiliary semantic head when
    ``kmax.aux_semantic_weight > 0``, as the JAX builder does. In bf16 the
    forward computes in bf16 from those f32 master weights (each layer
    casts its weights at use) with the JAX package's f32 islands
    (softmaxes, norms' statistics, the criterion); a ConvNeXt backbone
    takes its drop path and ``remat`` from the config."""
    w = cfg.model.maxtron.wc
    if not w.enable:
        raise NotImplementedError("only the within-clip model is ported")
    dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else None
    kmax = cfg.model.kmax
    aux_semantic = train and kmax.aux_semantic_weight > 0
    if aux_semantic and not kmax.use_aux_semantic_decoder:
        raise NotImplementedError("the semantic head without its decoder is "
                                  "not ported")
    t = num_frames or cfg.input.num_clip_frames
    meta = torch.device("meta")
    backbone, channels = build_backbone(cfg, device=meta,
                                        block_kernel=block_kernel)
    wc_module = WithinClipTrackingModule(
        channels, conv_dims=w.conv_dims, nheads=w.nheads,
        dim_feedforward=w.dim_feedforward, num_stages=w.num_stages,
        spatial_layers=w.spatial_layers, temporal_layers=w.temporal_layers,
        temporal_attn_type=w.temporal_attn_type,
        spatial_in_features=tuple(w.spatial_in_features),
        temporal_in_features=tuple(w.temporal_in_features),
        enc_n_points=w.enc_n_points, num_frames=t, dropout=w.dropout,
        device=meta)
    in_features = tuple(sorted(kmax.pixel_dec.in_features, reverse=True))
    pixel_decoder = KMaXPixelDecoder(
        channels, in_features=in_features,
        dec_layers=tuple(kmax.pixel_dec.dec_layers),
        dec_channels=tuple(kmax.pixel_dec.dec_channels),
        layer_types=tuple(kmax.pixel_dec.layer_types),
        drop_path_prob=kmax.pixel_dec.drop_path_prob, device=meta)
    stage_channels = [s.out_channels for s in pixel_decoder._stages]
    predictor = KMaXTransformerDecoder(
        num_classes=cfg.model.num_classes, in_channels=stage_channels[:3],
        panoptic_channels=stage_channels[-1],
        dec_layers=tuple(kmax.trans_dec.dec_layers),
        num_queries=kmax.trans_dec.num_object_queries, num_frames=t,
        drop_path_prob=kmax.trans_dec.drop_path_prob,
        aux_semantic=(tuple(channels[in_features[i]] for i in (0, 2, 3))
                      if aux_semantic else None),
        device=meta)
    model = KMaXSegmenter(backbone, wc_module, pixel_decoder, predictor,
                          dtype=dtype)
    return materialize(model, device, generator, dtype, train)
