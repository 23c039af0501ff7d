"""Multi-scale deformable attention module and encoder layer, channels-last
(counterpart of ``axial_vs_tpu/layers/msda_attention.py``).

Names follow the upstream ``MSDeformAttn`` (``sampling_offsets``,
``attention_weights``, ``value_proj``, ``output_proj``) and the deformable
encoder layer (``self_attn``, ``norm1``, ``linear1``, ``linear2``,
``norm2``). The core op is kernel K2 (``ops/msda.py::ms_deform_attn``).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.msda import level_start_index, ms_deform_attn
from ..ops.norm import LayerNorm
from .convbn import Dropout, Linear

_ZERO = ("constant", 0.0)


def reference_points_for_shapes(spatial_shapes: Sequence[Tuple[int, int]],
                                device=None):
    """(S, L, 2) normalized (x, y): each flattened token's own pixel center,
    replicated for every level (valid ratios are 1)."""
    pts = []
    for h, w in spatial_shapes:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        pts.append(torch.stack([xs[None, :].expand(h, w).reshape(-1),
                                ys[:, None].expand(h, w).reshape(-1)], -1))
    ref = torch.cat(pts, 0)
    return ref[:, None, :].expand(ref.shape[0], len(spatial_shapes), 2)


def offset_bias_init(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Directional grid for the sampling-offset bias: head i points along
    angle 2*pi*i/M, scaled to the unit square, point k at distance k+1."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4, device=None):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = Linear(
            d_model, n_heads * n_levels * n_points * 2, weight_init=_ZERO,
            bias_init=("tensor", offset_bias_init(n_heads, n_levels, n_points)),
            device=device)
        self.attention_weights = Linear(
            d_model, n_heads * n_levels * n_points, weight_init=_ZERO,
            bias_init=_ZERO, device=device)
        self.value_proj = Linear(d_model, d_model, device=device)
        self.output_proj = Linear(d_model, d_model, device=device)

    def forward(self, query, input_flatten, spatial_shapes):
        """query, input_flatten (B, S, C); spatial_shapes ((H, W), ...)."""
        return self.output_proj(self.sample(query, input_flatten,
                                            spatial_shapes))

    def sample(self, query, input_flatten, spatial_shapes):
        """The attention before ``output_proj``: (B, Lq, C)."""
        b, lq, c = query.shape
        m, lv, p = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(input_flatten).reshape(b, -1, m, c // m)
        offsets = self.sampling_offsets(query).reshape(b, lq, m, lv, p, 2)
        weights = self.attention_weights(query).reshape(b, lq, m, lv * p)
        weights = F.softmax(weights.float(), -1).reshape(
            b, lq, m, lv, p).to(query.dtype)
        ref = reference_points_for_shapes(spatial_shapes, device=query.device)
        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        locations = (ref[None, :, None, :, None, :]
                     + offsets.float() / normalizer[None, None, None, :, None, :])
        return ms_deform_attn(value.contiguous(), spatial_shapes,
                              level_start_index(spatial_shapes),
                              locations.contiguous(), weights.contiguous())


class MSDeformAttnEncoderLayer(nn.Module):
    """Deformable self-attention + ReLU FFN over flattened multi-level
    tokens, with dropout (rate ``dropout``, in ``train()``) after the
    attention, the FFN's activation and its output."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024, n_levels: int = 3,
                 n_heads: int = 8, n_points: int = 4, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.dropout1, self.dropout2, self.dropout3 = (
            Dropout(dropout) for _ in range(3))
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                      device=device)
        self.norm1 = LayerNorm(d_model, eps=1e-5, device=device)
        self.linear1 = Linear(d_model, d_ffn, device=device)
        self.linear2 = Linear(d_ffn, d_model, device=device)
        self.norm2 = LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, src, pos, spatial_shapes, generator=None):
        attn = self.self_attn(src + pos.to(src.dtype), src, spatial_shapes)
        src = self.norm1(src + self.dropout1(attn, generator))
        y = self.dropout2(F.relu(self.linear1(src)), generator)
        return self.norm2(src + self.dropout3(self.linear2(y), generator))
