"""1-D axial attention with relative positional encodings, eval path
(counterpart of ``axial_vs_tpu/layers/axial_attention.py``).

Height-axis then width-axis single-axis attention with query/key/value
relative position embeddings (``MAX_SPAN`` 255) and BatchNorm on the
similarity logits and the retrieved output. At eval both BatchNorms are
per-channel affines and are folded as in the JAX package's
``_BNFoldParams`` path: the similarity BN's scale pre-multiplies the einsum
operands and its bias is dropped (softmax is invariant to it); the retrieved
BN becomes two scaled adds. Names follow the upstream module
(``qkv_transform.conv``, ``_query_rpe._embeddings``, ``_batch_norm_qkv``,
``_batch_norm_similarity``, ``_batch_norm_retrieved_output``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norm import BatchNorm
from .convbn import ConvBN

MAX_SPAN = 255


class RelativePositionalEncoding(nn.Module):
    """(L, M, depth) relative embeddings gathered from a (2*MAX_SPAN-1,
    depth) table."""

    def __init__(self, depth: int, device=None):
        super().__init__()
        self._embeddings = nn.Embedding(MAX_SPAN * 2 - 1, depth, device=device)
        self._embeddings._inits = {"weight": ("trunc_normal", 1.0)}

    def forward(self, length: int):
        if length > MAX_SPAN:
            raise ValueError(f"axis length {length} > MAX_SPAN {MAX_SPAN}")
        idx = torch.arange(length, device=self._embeddings.weight.device)
        idx = idx[None, :] - idx[:, None] + MAX_SPAN - 1
        return self._embeddings.weight[idx]


class AxialAttention(nn.Module):
    """Single-axis attention over (N, L, C)."""

    def __init__(self, in_planes: int, total_key_depth: int = 512,
                 total_value_depth: int = 1024, num_heads: int = 8,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.tk, self.tv = total_key_depth, total_value_depth
        self.qkv_transform = ConvBN(
            in_planes, total_key_depth * 2 + total_value_depth, 1, bias=False,
            conv_type="1d", conv_init_std=in_planes ** -0.5, device=device)
        self._batch_norm_qkv = BatchNorm(total_key_depth * 2 + total_value_depth,
                                         device=device)
        self._batch_norm_similarity = BatchNorm(num_heads * 3, device=device)
        self._batch_norm_retrieved_output = BatchNorm(total_value_depth * 2,
                                                      device=device)
        self._query_rpe = RelativePositionalEncoding(
            total_key_depth // num_heads, device=device)
        self._key_rpe = RelativePositionalEncoding(
            total_key_depth // num_heads, device=device)
        self._value_rpe = RelativePositionalEncoding(
            total_value_depth // num_heads, device=device)

    def forward(self, x):
        n, length, _ = x.shape
        h, tk, tv = self.num_heads, self.tk, self.tv
        qkv = self._batch_norm_qkv(self.qkv_transform(x))
        q = qkv[..., :tk].reshape(n, length, h, tk // h)
        k = qkv[..., tk:2 * tk].reshape(n, length, h, tk // h)
        v = qkv[..., 2 * tk:].reshape(n, length, h, tv // h)
        qr = self._query_rpe(length).to(q.dtype)
        kr = self._key_rpe(length).to(q.dtype)
        vr = self._value_rpe(length)

        s3, _ = self._batch_norm_similarity.folded()
        s3 = s3.to(q.dtype)
        q_c = q * s3[None, None, 0 * h:1 * h, None]
        q_r = q * s3[None, None, 1 * h:2 * h, None]
        k_r = k * s3[None, None, 2 * h:3 * h, None]
        logits = (torch.einsum("nlhd,nmhd->nlmh", q_c, k)
                  + torch.einsum("nlhd,lmd->nlmh", q_r, qr)
                  + torch.einsum("nmhd,lmd->nlmh", k_r, kr))
        weights = F.softmax(logits.float(), dim=2).to(v.dtype)
        content = torch.einsum("nlmh,nmhd->nlhd", weights, v).reshape(n, length, tv)
        rpe = torch.einsum("nlmh,lmd->nlhd", weights,
                           vr.to(weights.dtype)).reshape(n, length, tv)
        s2, b2 = self._batch_norm_retrieved_output.folded()
        s2 = s2.to(content.dtype)
        return (content * s2[:tv] + rpe * s2[tv:]
                + (b2[:tv] + b2[tv:]).to(content.dtype))


class AxialAttention2D(nn.Module):
    """Height-axis then width-axis axial attention on (N, H, W, C), 8 heads,
    key depth ``filters`` and value depth ``2 * filters``."""

    def __init__(self, in_planes: int, filters: int = 512, device=None):
        super().__init__()
        self.tv = 2 * filters
        self._height_axis = AxialAttention(in_planes, filters, self.tv,
                                           device=device)
        self._width_axis = AxialAttention(self.tv, filters, self.tv,
                                          device=device)

    def forward(self, x):
        n, height, width, c = x.shape
        tv = self.tv
        xh = x.permute(0, 2, 1, 3).reshape(n * width, height, c)
        xh = self._height_axis(xh)
        xw = xh.reshape(n, width, height, tv).permute(0, 2, 1, 3)
        xw = self._width_axis(xw.reshape(n * height, width, tv))
        return xw.reshape(n, height, width, tv)
