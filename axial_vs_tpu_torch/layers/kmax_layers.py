"""kMaX-DeepLab transformer building blocks, eval path (counterpart of
``axial_vs_tpu/layers/kmax_layers.py``; ASPP and the auxiliary semantic
predictor are training-only and not ported yet).

Pixel features are (B, H, W, C), object queries (B, N, C). The k-means
cross-attention assigns every pixel to its argmax mask slot (a hard one-hot)
and averages nothing: it sums the pixels' values per slot. Softmaxes over
similarity logits run in f32. Names follow the upstream modules
(``_pixel_space_head_conv0bnact``, ``_transformer_class_head``,
``_kmeans_query_batch_norm_retrieved_value``, ...).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.act import gelu
from ..ops.norm import BatchNorm
from .convbn import ConvBN


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
    value depth 256, 8 heads, FFN 2048."""

    def __init__(self, num_classes: int, in_channel_pixel: int, device=None):
        super().__init__()
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

    def forward(self, pixel_feature, query_feature):
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
        query_feature = query_feature + self._kmeans_query_conv3_bn(
            kmeans_update)

        # query self-attention
        qkv = self._query_qkv_conv_bn(query_space)
        q = qkv[..., :kd].reshape(b, n, h, kd // h)
        k = qkv[..., kd:2 * kd].reshape(b, n, h, kd // h)
        v = qkv[..., 2 * kd:].reshape(b, n, h, vd // h)
        attn = self._query_conv3_bn(self._query_self_attention(q, k, v))
        query_feature = gelu(query_feature + attn)

        # FFN
        ffn = self._query_ffn_conv2_bn(self._query_ffn_conv1_bn_act(
            query_feature))
        return gelu(query_feature + ffn), pred
