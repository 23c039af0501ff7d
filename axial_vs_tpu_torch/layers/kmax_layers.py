"""kMaX-DeepLab transformer building blocks (counterpart of
``axial_vs_tpu/layers/kmax_layers.py``), with the training-only auxiliary
semantic head (``ASPP``, ``SemanticPredictor``).

Pixel features are (B, H, W, C), object queries (B, N, C). The k-means
cross-attention assigns every pixel to its argmax mask slot (a hard one-hot)
and averages nothing: it sums the pixels' values per slot. Softmaxes over
similarity logits run in f32. Names follow the upstream modules
(``_pixel_space_head_conv0bnact``, ``_transformer_class_head``,
``_kmeans_query_batch_norm_retrieved_value``, ``_aspp``, ...). The
stochastic layers (the transformer layer's three DropPaths, ASPP's dropout)
draw from the ``generator`` passed to ``forward`` in ``train()``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.act import gelu
from ..ops.norm import BatchNorm
from ..ops.resize import resize_bilinear
from .convbn import ConvBN, Dropout, DropPath


def add_bias_towards_void(class_logits, void_prior_prob: float = 0.9):
    """Shift the last (void) class logit by the log prior."""
    num_classes = class_logits.shape[-1]
    bias = torch.zeros(num_classes, dtype=class_logits.dtype,
                       device=class_logits.device)
    bias[-1] = math.log((num_classes - 1) * void_prior_prob
                        / (1 - void_prior_prob))
    return class_logits + bias


class AttentionOperation(nn.Module):
    """Attention with BN'd similarity logits and BN + gelu on the output.
    query/key (B, L, h, dk), value (B, M, h, dv) -> (B, L, h * dv)."""

    def __init__(self, channels_v: int, num_heads: int, device=None):
        super().__init__()
        self._batch_norm_similarity = BatchNorm(num_heads, device=device)
        self._batch_norm_retrieved_value = BatchNorm(channels_v, device=device)

    def forward(self, query, key, value):
        b, length = query.shape[:2]
        sim = self._batch_norm_similarity(
            torch.einsum("blhd,bmhd->blmh", query, key))
        weights = F.softmax(sim.float(), dim=2).to(value.dtype)
        retrieved = torch.einsum("blmh,bmhd->blhd", weights, value)
        return gelu(self._batch_norm_retrieved_value(
            retrieved.reshape(b, length, -1)))


class KMaXPredictor(nn.Module):
    """Mask and class heads. pixel_feature (B, H, W, C_pixel); mask and class
    embeddings (B, N, 256). Returns class_logits (B, N, K), mask_logits
    (B, H, W, N), the L2-normalised pixel_feature (B, H, W, 128) and the
    128-d mask embeddings."""

    def __init__(self, in_channels: int, num_classes: int, device=None):
        super().__init__()
        self._pixel_space_head_conv0bnact = ConvBN(
            in_channels, in_channels, 5, padding=2, groups=in_channels,
            bias=False, norm="syncbn", act="gelu", conv_init="xavier_uniform",
            device=device)
        self._pixel_space_head_conv1bnact = ConvBN(
            in_channels, 256, 1, bias=False, norm="syncbn", act="gelu",
            device=device)
        self._pixel_space_head_last_convbn = ConvBN(
            256, 128, 1, bias=True, norm="syncbn", conv_init_std=0.01,
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
        x = self._pixel_space_head_conv0bnact(pixel_feature)
        x = self._pixel_space_head_conv1bnact(x)
        x = self._pixel_space_head_last_convbn(x)
        sq = x.float().square().sum(-1, keepdim=True).clamp_min(1e-24)
        pixel_norm = x * torch.rsqrt(sq).to(x.dtype)
        class_logits = add_bias_towards_void(
            self._transformer_class_head(class_embeddings))
        mask_kernel = self._transformer_mask_head(mask_embeddings)
        mask_logits = torch.einsum("bhwc,bnc->bhwn", pixel_norm, mask_kernel)
        mask_logits = self._pixel_space_mask_batch_norm(
            mask_logits[..., None])[..., 0]
        return {"class_logits": class_logits, "mask_logits": mask_logits,
                "pixel_feature": pixel_norm, "mask_embeddings": mask_kernel}


class KMaXTransformerLayer(nn.Module):
    """k-means cross-attention + query self-attention + FFN, at the
    reference's fixed widths: 256-d queries and bottleneck, key depth 128,
    value depth 256, 8 heads, FFN 2048. Each of the three residual branches
    ends in a DropPath of rate ``drop_path_prob``."""

    def __init__(self, num_classes: int, in_channel_pixel: int,
                 drop_path_prob: float = 0.0, device=None):
        super().__init__()
        self._drop_path_kmeans, self._drop_path_attn, self._drop_path_ffn = (
            DropPath(drop_path_prob) for _ in range(3))
        in_channel_query = bottleneck = 256
        self.key_depth, self.value_depth, self.num_heads = 128, 256, 8
        init_std = bottleneck ** -0.5
        dev = dict(device=device)
        self._query_conv1_bn_act = ConvBN(
            in_channel_query, bottleneck, 1, bias=False, norm="syncbn",
            act="gelu", conv_type="1d", **dev)
        self._pixel_conv1_bn_act = ConvBN(
            in_channel_pixel, bottleneck, 1, bias=False, norm="syncbn",
            act="gelu", **dev)
        self._query_qkv_conv_bn = ConvBN(
            bottleneck, self.key_depth * 2 + self.value_depth, 1, bias=False,
            norm="syncbn", conv_type="1d", conv_init_std=init_std, **dev)
        self._pixel_v_conv_bn = ConvBN(
            bottleneck, self.value_depth, 1, bias=False, norm="syncbn",
            conv_init_std=init_std, **dev)
        self._query_self_attention = AttentionOperation(
            self.value_depth, self.num_heads, **dev)
        self._query_conv3_bn = ConvBN(
            self.value_depth, in_channel_query, 1, bias=False, norm="syncbn",
            conv_type="1d", norm_init=0.0, **dev)
        self._query_ffn_conv1_bn_act = ConvBN(
            in_channel_query, 2048, 1, bias=False, norm="syncbn", act="gelu",
            conv_type="1d", **dev)
        self._query_ffn_conv2_bn = ConvBN(
            2048, in_channel_query, 1, bias=False, norm="syncbn",
            conv_type="1d", norm_init=0.0, **dev)
        self._predictor = KMaXPredictor(bottleneck, num_classes, **dev)
        self._kmeans_query_batch_norm_retrieved_value = BatchNorm(
            self.value_depth, **dev)
        self._kmeans_query_conv3_bn = ConvBN(
            self.value_depth, in_channel_query, 1, bias=False, norm="syncbn",
            conv_type="1d", norm_init=0.0, **dev)

    def forward(self, pixel_feature, query_feature, generator=None):
        b, n = query_feature.shape[:2]
        h, kd, vd = self.num_heads, self.key_depth, self.value_depth
        query_space = self._query_conv1_bn_act(query_feature)
        pixel_space = self._pixel_conv1_bn_act(gelu(pixel_feature))

        # k-means cross-attention: hard assignment of each pixel to a slot
        pixel_value = self._pixel_v_conv_bn(pixel_space)
        pred = self._predictor(query_space, query_space, pixel_space)
        mask_logits = pred["mask_logits"].reshape(b, -1, n)  # (B, HW, N)
        assignment = F.one_hot(mask_logits.argmax(-1), n).float()
        kmeans_update = torch.bmm(assignment.transpose(1, 2),
                                  pixel_value.reshape(b, -1, vd).float())
        kmeans_update = self._kmeans_query_batch_norm_retrieved_value(
            kmeans_update.to(query_feature.dtype))
        query_feature = query_feature + self._drop_path_kmeans(
            self._kmeans_query_conv3_bn(kmeans_update), generator)

        # query self-attention
        qkv = self._query_qkv_conv_bn(query_space)
        q = qkv[..., :kd].reshape(b, n, h, kd // h)
        k = qkv[..., kd:2 * kd].reshape(b, n, h, kd // h)
        v = qkv[..., 2 * kd:].reshape(b, n, h, vd // h)
        attn = self._query_conv3_bn(self._query_self_attention(q, k, v))
        query_feature = gelu(query_feature
                             + self._drop_path_attn(attn, generator))

        # FFN
        ffn = self._query_ffn_conv2_bn(self._query_ffn_conv1_bn_act(
            query_feature))
        return gelu(query_feature + self._drop_path_ffn(ffn, generator)), pred


def _conv_bn_act(cin, cout, k=1, act="gelu", device=None, **kw):
    return ConvBN(cin, cout, k, padding=kw.pop("padding", 0), bias=False,
                  norm="syncbn", act=act, device=device, **kw)


def _dw_conv_bn_act(c, device=None):
    return ConvBN(c, c, 5, padding=2, groups=c, bias=False, norm="syncbn",
                  act="gelu", conv_init="xavier_uniform", device=device)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling on (N, H, W, C): a 1x1 branch, three
    3x3 branches at the atrous rates, and image pooling, concatenated and
    projected, then dropout at rate 0.1 in ``train()`` (the JAX module's
    fixed rate)."""

    def __init__(self, in_channels: int, output_channels: int,
                 atrous_rates=(6, 12, 18), device=None):
        super().__init__()
        c = output_channels
        self._aspp_conv0 = _conv_bn_act(in_channels, c, device=device)
        for i, r in enumerate(atrous_rates, 1):
            setattr(self, f"_aspp_conv{i}", _conv_bn_act(
                in_channels, c, 3, padding=r, dilation=r, device=device))
        self._aspp_pool = _conv_bn_act(in_channels, c, device=device)
        self._proj_conv_bn_act = _conv_bn_act(5 * c, c, device=device)
        self._proj_drop = Dropout(0.1)

    def forward(self, x, generator=None):
        results = [getattr(self, f"_aspp_conv{i}")(x) for i in range(4)]
        pooled = self._aspp_pool(x.mean((-3, -2), keepdim=True))
        results.append(resize_bilinear(pooled, x.shape[-3:-1],
                                       align_corners=x.shape[-2] % 2 == 1))
        y = self._proj_conv_bn_act(torch.cat(results, -1))
        return self._proj_drop(y, generator)


class SemanticPredictor(nn.Module):
    """The auxiliary semantic head: ASPP on the OS32 features, then the
    Panoptic-DeepLab decoder fusing the OS8 and OS4 features. Returns
    (N, H4, W4, num_classes) logits (void included)."""

    def __init__(self, in_channels: int, os8_channels: int, os4_channels: int,
                 num_classes: int, device=None):
        super().__init__()
        dev = dict(device=device)
        self._aspp = ASPP(in_channels, 256, **dev)
        self._low_level_projection_os8 = _conv_bn_act(os8_channels, 64, **dev)
        self._low_level_fusion_os8_conv0_bn_act = _dw_conv_bn_act(256 + 64,
                                                                  **dev)
        self._low_level_fusion_os8_conv1_bn_act = _conv_bn_act(256 + 64, 256,
                                                               **dev)
        self._low_level_projection_os4 = _conv_bn_act(os4_channels, 32, **dev)
        self._low_level_fusion_os4_conv0_bn_act = _dw_conv_bn_act(256 + 32,
                                                                  **dev)
        self._low_level_fusion_os4_conv1_bn_act = _conv_bn_act(256 + 32, 256,
                                                               **dev)
        self.conv_block_0 = _dw_conv_bn_act(256, **dev)
        self.conv_block_1 = _conv_bn_act(256, 256, **dev)
        self.final_conv = ConvBN(256, num_classes, 1, bias=True,
                                 conv_init_std=0.01, **dev)

    def forward(self, x, low_features_os8, low_features_os4, generator=None):
        x = self._aspp(x, generator)
        align_corners = x.shape[-2] % 2 == 1
        for proj, conv0, conv1, low in (
                (self._low_level_projection_os8,
                 self._low_level_fusion_os8_conv0_bn_act,
                 self._low_level_fusion_os8_conv1_bn_act, low_features_os8),
                (self._low_level_projection_os4,
                 self._low_level_fusion_os4_conv0_bn_act,
                 self._low_level_fusion_os4_conv1_bn_act, low_features_os4)):
            low = proj(low)
            x = resize_bilinear(x, low.shape[-3:-1], align_corners=align_corners)
            x = conv1(conv0(torch.cat([x, low], -1)))
        return self.final_conv(self.conv_block_1(self.conv_block_0(x)))
