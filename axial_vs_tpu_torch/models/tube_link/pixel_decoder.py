"""Tube-Link pixel decoder: fused MSDA + axial-trajectory encoder + FPN,
channels-last (counterpart of ``axial_vs_tpu/models/tube_link/pixel_decoder.py``).

3 encoder levels (res5, res4, res3) projected to C channels, then 6 encoder
layers. Each layer's attention is deformable attention (kernel K2) whose
output, before the output projection, passes on its first 2 levels through
an axial-trajectory ``TemporalEncoder`` (kernel K3) with a gamma-gated
residual (1e-6 at init); then residual, LayerNorm, ReLU FFN, LayerNorm.
Finally an FPN lateral step to res2 and a 3x3 mask-feature conv. With
``use_temporal`` false (the Tube-Link baseline, without MaXTron's attention)
the layers have no temporal encoder and no gamma, and the decoder no
``level_3d_encoding``: deformable attention alone.

Names mirror the JAX tree: ``input_convs.{i}`` / ``input_norms.{i}``
(``input_conv{i}``, ``input_norm{i}``), ``level_encoding``,
``level_3d_encoding``, ``layers.{i}.{attn, norm1, ffn1, ffn2, norm2}``
(``layer{i}_*``), ``lateral_conv``, ``lateral_norm``, ``output_conv``,
``output_norm`` (``*0``) and ``mask_feature``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers.convbn import Conv, Linear
from ...layers.msda_attention import MSDeformAttn
from ...layers.position_embeddings import (position_embedding_sine_2d,
                                           position_embedding_sine_3d)
from ...layers.trajectory_attention import TemporalEncoder
from ...ops.norm import GroupNorm, LayerNorm
from ...ops.resize import resize_bilinear

_XAVIER = ("xavier_uniform",)
LEVELS = ("res5", "res4", "res3")  # encoder levels, low to high resolution
NUM_TEMPORAL_LEVELS = 2  # the first ones (res5, res4) get the temporal encoder


class FusedMSDATrajectoryAttention(MSDeformAttn):
    """Deformable attention whose output on the first
    ``NUM_TEMPORAL_LEVELS`` levels passes through a temporal encoder before
    the output projection (unless ``use_temporal`` is false); returns
    ``query + attention`` (the identity residual)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_points: int = 4, num_temporal_dim: int = 1024,
                 num_frames: int = 2, use_temporal: bool = True, device=None):
        super().__init__(embed_dims, len(LEVELS), num_heads, num_points,
                         device=device)
        self.num_frames = num_frames
        self.use_temporal = use_temporal
        if use_temporal:
            self.gamma = nn.Parameter(torch.empty(embed_dims, device=device))
            self._inits = {"gamma": ("constant", 1e-6)}
            self.temporal_encoder = TemporalEncoder(
                embed_dims, num_temporal_dim, num_heads, num_layers=1,
                device=device)

    def forward(self, query, query_pos, pos_3d, spatial_shapes):
        """query (B*T, S, C), levels flattened low to high resolution;
        query_pos (S, C); pos_3d [(T, H, W, C)] of the temporal levels."""
        out = self.sample(query + query_pos.to(query.dtype), query,
                          spatial_shapes)
        if not self.use_temporal:
            return query + self.output_proj(out)
        pieces = list(torch.split(out, [h * w for h, w in spatial_shapes], 1))
        gamma = self.gamma.to(out.dtype)
        for i, (h, w) in enumerate(spatial_shapes[:NUM_TEMPORAL_LEVELS]):
            upd = self.temporal_encoder(pieces[i], pos_3d[i], self.num_frames,
                                        h, w)
            pieces[i] = pieces[i] + gamma * upd
        return query + self.output_proj(torch.cat(pieces, 1))


class _EncoderLayer(nn.Module):
    def __init__(self, c: int, ffn_dim: int, num_frames: int,
                 use_temporal: bool, device=None):
        super().__init__()
        self.attn = FusedMSDATrajectoryAttention(
            c, num_frames=num_frames, use_temporal=use_temporal, device=device)
        self.norm1 = LayerNorm(c, eps=1e-5, device=device)
        self.ffn1 = Linear(c, ffn_dim, device=device)
        self.ffn2 = Linear(ffn_dim, c, device=device)
        self.norm2 = LayerNorm(c, eps=1e-5, device=device)

    def forward(self, x, pos, pos_3d, shapes):
        x = self.norm1(self.attn(x, pos, pos_3d, shapes))
        return self.norm2(x + self.ffn2(F.relu(self.ffn1(x))))


class TubeLinkPixelDecoder(nn.Module):
    """features {res2..res5: (B*T, H, W, C_in)} -> (mask_feature (B*T, H/4,
    W/4, out_channels), [res5, res4, res3] encoder outputs (B*T, h, w, C))."""

    def __init__(self, in_channels: dict, feat_channels: int = 256,
                 out_channels: int = 256, num_encoder_layers: int = 6,
                 num_frames: int = 2, ffn_dim: int = 1024,
                 use_temporal: bool = True, device=None):
        super().__init__()
        c = feat_channels
        self.num_frames = num_frames
        self.use_temporal = use_temporal
        self.input_convs = nn.ModuleList([
            Conv(in_channels[n], c, 1, weight_init=_XAVIER, device=device)
            for n in LEVELS])
        self.input_norms = nn.ModuleList([
            GroupNorm(c, 32, device=device) for _ in LEVELS])
        self.level_encoding = nn.Parameter(
            torch.empty(len(LEVELS), c, device=device))
        self._inits = {"level_encoding": ("normal", 1.0)}
        if use_temporal:
            self.level_3d_encoding = nn.Parameter(
                torch.empty(NUM_TEMPORAL_LEVELS, c, device=device))
            self._inits["level_3d_encoding"] = ("normal", 1.0)
        self.layers = nn.ModuleList([
            _EncoderLayer(c, ffn_dim, num_frames, use_temporal, device=device)
            for _ in range(num_encoder_layers)])
        self.lateral_conv = Conv(in_channels["res2"], c, 1, weight_init=_XAVIER,
                                 device=device)
        self.lateral_norm = GroupNorm(c, 32, device=device)
        self.output_conv = Conv(c, c, 3, padding=1, weight_init=_XAVIER,
                                device=device)
        self.output_norm = GroupNorm(c, 32, device=device)
        self.mask_feature = Conv(c, out_channels, 3, padding=1,
                                 weight_init=_XAVIER, device=device)

    def forward(self, features: dict):
        t = self.num_frames
        srcs, shapes = [], []
        for conv, norm, name in zip(self.input_convs, self.input_norms,
                                    LEVELS):
            x = features[name]
            srcs.append(norm(conv(x)))
            shapes.append((x.shape[1], x.shape[2]))
        shapes = tuple(shapes)
        bt, c = srcs[0].shape[0], srcs[0].shape[-1]
        dev = srcs[0].device
        pos = torch.cat([
            position_embedding_sine_2d(h, w, c // 2, device=dev).reshape(-1, c)
            + self.level_encoding[i] for i, (h, w) in enumerate(shapes)], 0)
        pos_3d = [
            position_embedding_sine_3d(t, h, w, c // 2, device=dev)
            + self.level_3d_encoding[i]
            for i, (h, w) in enumerate(shapes[:NUM_TEMPORAL_LEVELS])
        ] if self.use_temporal else []

        x = torch.cat([s.reshape(bt, -1, c) for s in srcs], 1)
        for layer in self.layers:
            x = layer(x, pos, pos_3d, shapes)
        outs = [piece.reshape(bt, h, w, c) for piece, (h, w) in zip(
            torch.split(x, [h * w for h, w in shapes], dim=1), shapes)]

        lateral = self.lateral_norm(self.lateral_conv(features["res2"]))
        y = lateral + resize_bilinear(outs[-1], lateral.shape[1:3])
        y = F.relu(self.output_norm(self.output_conv(y)))
        return self.mask_feature(y), outs
