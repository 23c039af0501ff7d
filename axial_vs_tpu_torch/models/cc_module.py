"""Cross-clip (CC) tracking module (counterpart of
``axial_vs_tpu/models/cc_module.py``).

It runs on the per-clip cluster centers of the frozen segmenter, aligned
across clips, (B, Q, T_clips, C) with B = 1. Each layer takes:

1. trajectory attention over the (t q) tokens with the clips as its frames
   (kernel K3 on the card, ``layers/trajectory_attention.py`` with one
   ``qkv`` projection), a residual and a LayerNorm;
2. a temporal ASPP per query along the clip axis (three dilated 1-D convs of
   3 taps at rates 1, 2, 3 on edge padding, then a LayerNorm + GELU
   projection), a residual and a LayerNorm;
3. the video-level predictor, shared by all layers with the two embedding
   projections: one class logit per query for the whole video (its clips'
   class embeddings pooled by a softmax over clips) and per-clip mask logits
   against that clip's pixel features.

Everything computes in f32: the segmenter's bf16 outputs are cast on entry,
as the JAX package promotes them against its f32 parameters. Names follow
the upstream module (``transformer_trajectory_self_attention_layers``,
``conv_short_aggregate_layers``, ``conv_norms``, ``_predictor``, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.convbn import Conv, ConvBN, Dropout
from ..layers.kmax_layers import add_bias_towards_void
from ..layers.trajectory_attention import TrajectoryAttention
from ..ops.norm import BatchNorm, LayerNorm


class TemporalASPP1D(nn.Module):
    """Three dilated 1-D convs over the clip axis on replicate padding, their
    concatenation, a 1x1 projection with LayerNorm and GELU, and dropout.
    (B, T, C) -> (B, T, C)."""

    def __init__(self, channels: int = 256, kernel_sizes=(3, 3, 3),
                 atrous_rates=(1, 2, 3), dropout_rate: float = 0.0,
                 norm_fn: str = "ln", device=None):
        super().__init__()
        self.pads = [(k - 1) * r // 2 for k, r in zip(kernel_sizes, atrous_rates)]
        for i, (k, r) in enumerate(zip(kernel_sizes, atrous_rates)):
            setattr(self, f"_aspp_conv{i}", Conv(
                channels, channels, k, ndim=1, dilation=r,
                weight_init=("xavier_uniform",), device=device))
        self._proj_conv_bn_act = ConvBN(
            channels * len(self.pads), channels, 1, bias=False,
            norm=None if norm_fn == "none" else norm_fn, act="gelu",
            conv_type="1d", device=device)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, generator=None):
        branches = []
        for i, pad in enumerate(self.pads):
            xp = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate")
            branches.append(getattr(self, f"_aspp_conv{i}")(xp.transpose(1, 2)))
        y = self._proj_conv_bn_act(torch.cat(branches, -1))
        return self.dropout(y, generator)


class MaXTronCCPredictor(nn.Module):
    """Video-level class and per-clip mask prediction. Class and mask
    embeddings (T_clips, N, 256); pixel features (T_clips, V*H, W, 128),
    each clip's V frames stacked along the height. Returns class_logits (1,
    N, K+1) and mask_logits (T_clips*V, H, W, N)."""

    def __init__(self, num_classes: int, num_clip_frames: int, device=None):
        super().__init__()
        self.num_clip_frames = num_clip_frames
        self._transformer_class_activation_head = ConvBN(
            256, 1, 1, bias=True, conv_type="1d", conv_init_std=0.01,
            device=device)
        self._transformer_class_head = ConvBN(
            256, num_classes, 1, bias=True, conv_type="1d", conv_init_std=0.01,
            device=device)
        self._transformer_mask_head = ConvBN(
            256, 128, 1, bias=False, norm="syncbn", conv_type="1d",
            device=device)
        self._pixel_space_mask_batch_norm = BatchNorm(1, scale_init=0.1,
                                                      device=device)

    def forward(self, mask_embeddings, class_embeddings, pixel_feature):
        t = class_embeddings.shape[0]
        activation = self._transformer_class_activation_head(class_embeddings)
        weights = F.softmax(activation.float(), 0)  # over clips, (T, N, 1)
        pooled = (class_embeddings.float() * weights).sum(0, keepdim=True)
        class_logits = add_bias_towards_void(
            self._transformer_class_head(pooled.to(class_embeddings.dtype)))

        mask_kernel = self._transformer_mask_head(mask_embeddings)  # (T, N, 128)
        th, w, c = pixel_feature.shape[1:]
        mask_logits = torch.matmul(pixel_feature.reshape(t, th * w, c),
                                   mask_kernel.transpose(1, 2))
        mask_logits = self._pixel_space_mask_batch_norm(
            mask_logits[..., None])[..., 0]
        v = self.num_clip_frames
        n = mask_logits.shape[-1]
        return {"class_logits": class_logits,
                "mask_logits": mask_logits.reshape(t * v, th // v, w, n)}


class TrajectorySelfAttentionLayer(nn.Module):
    """Trajectory attention over the clips, dropout, a residual and a
    LayerNorm (eps 1e-5). (B, T*Q, C) with T = ``num_frames`` clips."""

    def __init__(self, dim: int = 256, num_heads: int = 8,
                 attn_drop: float = 0.0, device=None):
        super().__init__()
        self.self_attn = TrajectoryAttention(dim, num_heads, fused_qkv=True,
                                             device=device)
        self.dropout = Dropout(attn_drop)
        self.norm = LayerNorm(dim, eps=1e-5, device=device)

    def forward(self, tokens, num_frames: int, generator=None):
        attn = self.self_attn(tokens, num_frames=num_frames)
        return self.norm(tokens + self.dropout(attn, generator))


class CrossClipTrackingModule(nn.Module):
    """The CC module: ``num_layers`` layers of trajectory attention over the
    clips and temporal ASPP, each followed by the shared projections and
    predictor."""

    def __init__(self, num_classes: int, num_layers: int = 6,
                 num_clip_frames: int = 2, kernel_sizes=(3, 3, 3),
                 atrous_rates=(1, 2, 3), attn_drop: float = 0.0,
                 aspp_drop: float = 0.0, norm_fn: str = "ln", dim: int = 256,
                 device=None):
        super().__init__()
        self.transformer_trajectory_self_attention_layers = nn.ModuleList(
            TrajectorySelfAttentionLayer(dim, 8, attn_drop, device=device)
            for _ in range(num_layers))
        self.conv_short_aggregate_layers = nn.ModuleList(
            TemporalASPP1D(dim, kernel_sizes, atrous_rates, aspp_drop, norm_fn,
                           device=device)
            for _ in range(num_layers))
        self.conv_norms = nn.ModuleList(
            LayerNorm(dim, eps=1e-5, device=device) for _ in range(num_layers))
        # one instance of each, shared by every layer
        self._class_embedding_projection = ConvBN(
            dim, 256, 1, bias=False, norm="syncbn", act="gelu", conv_type="1d",
            device=device)
        self._mask_embedding_projection = ConvBN(
            dim, 256, 1, bias=False, norm="syncbn", act="gelu", conv_type="1d",
            device=device)
        self._predictor = MaXTronCCPredictor(num_classes + 1, num_clip_frames,
                                             device=device)

    def forward(self, clip_query, panoptic_features, generator=None):
        """clip_query (1, Q, T_clips, C), the aligned cluster centers;
        panoptic_features (T_clips, V*H, W, 128). Returns {"pred_logits" (1,
        Q, K+1), "pred_masks" (T_clips*V, H, W, Q), "aux_outputs": the
        earlier layers' two}."""
        b, q, t, c = clip_query.shape
        if b != 1:
            raise ValueError("the CC module runs one video at a time")
        x = clip_query.float()
        pixels = panoptic_features.float()
        preds = []
        for attn, aspp, norm in zip(
                self.transformer_trajectory_self_attention_layers,
                self.conv_short_aggregate_layers, self.conv_norms):
            tokens = x.transpose(1, 2).reshape(b, t * q, c)
            tokens = attn(tokens, t, generator)
            per_query = tokens.reshape(b, t, q, c).transpose(1, 2).reshape(
                b * q, t, c)
            per_query = norm(per_query + aspp(per_query, generator))
            x = per_query.reshape(b, q, t, c)

            video_query = x.transpose(1, 2).reshape(b * t, q, c)  # (T, Q, C)
            preds.append(self._predictor(
                self._mask_embedding_projection(video_query),
                self._class_embedding_projection(video_query), pixels))
        return {"pred_logits": preds[-1]["class_logits"],
                "pred_masks": preds[-1]["mask_logits"],
                "aux_outputs": [{"pred_logits": p["class_logits"],
                                 "pred_masks": p["mask_logits"]}
                                for p in preds[:-1]]}
