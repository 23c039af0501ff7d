"""Within-clip tracking module: interleaved MSDA + axial-trajectory encoder
(counterpart of ``axial_vs_tpu/models/wc_module.py``).

Per stage: one deformable spatial layer over the flattened tokens of all
levels (batched over B*T frames), then one temporal encoder on the first
``len(temporal_in_features)`` levels. Levels are ordered low to high
resolution (res5 first). Names follow the upstream module: ``input_proj``,
``output_proj`` (1x1 conv + GroupNorm(32)), ``transformer.level_embed_2d``,
``transformer.level_embed_3d``, ``transformer.encoder.spatial_layers`` and
``transformer.encoder.temporal_layers``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..layers.convbn import Conv
from ..layers.msda_attention import MSDeformAttnEncoderLayer
from ..layers.position_embeddings import (position_embedding_sine_2d,
                                          position_embedding_sine_3d)
from ..layers.trajectory_attention import TemporalEncoder
from ..ops.norm import GroupNorm


def _proj_gn(in_ch: int, out_ch: int, device):
    return nn.Sequential(
        Conv(in_ch, out_ch, 1, weight_init=("xavier_uniform",), device=device),
        GroupNorm(out_ch, 32, device=device))


class _Encoder(nn.Module):
    def __init__(self, spatial, temporal):
        super().__init__()
        self.spatial_layers = nn.ModuleList(spatial)
        self.temporal_layers = nn.ModuleList(temporal)


class _Transformer(nn.Module):
    def __init__(self, num_levels, num_temporal_levels, conv_dims, encoder,
                 device):
        super().__init__()
        self.level_embed_2d = nn.Parameter(
            torch.empty(num_levels, conv_dims, device=device))
        self._inits = {"level_embed_2d": ("normal", 1.0)}
        if num_temporal_levels:
            self.level_embed_3d = nn.Parameter(
                torch.empty(num_temporal_levels, conv_dims, device=device))
            self._inits["level_embed_3d"] = ("normal", 1.0)
        self.encoder = encoder


class WithinClipTrackingModule(nn.Module):
    """features {res*: (B*T, H, W, C)} -> the same dict with the spatial
    levels replaced by their tracked versions. ``generator`` draws the
    deformable layers' dropout masks in ``train()``."""

    def __init__(self, in_channels: dict, conv_dims: int = 256, nheads: int = 8,
                 dim_feedforward: int = 1024, num_stages: int = 2,
                 spatial_layers: int = 2, temporal_layers: int = 4,
                 temporal_attn_type: str = "axial_trajectory",
                 spatial_in_features: Sequence[str] = ("res3", "res4", "res5"),
                 temporal_in_features: Sequence[str] = ("res4", "res5"),
                 enc_n_points: int = 4, num_frames: int = 2,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.levels = sorted(spatial_in_features, reverse=True)  # res5 first
        self.num_temporal_levels = (len(temporal_in_features)
                                    if temporal_layers > 0 else 0)
        self.num_frames = num_frames
        self.conv_dims = conv_dims
        c = conv_dims
        self.input_proj = nn.ModuleList([
            _proj_gn(in_channels[n], c, device) for n in self.levels])
        self.output_proj = nn.ModuleList([
            _proj_gn(c, in_channels[n], device) for n in self.levels])
        spatial = [
            MSDeformAttnEncoderLayer(c, dim_feedforward, len(self.levels),
                                     nheads, enc_n_points, dropout,
                                     device=device)
            for _ in range(num_stages if spatial_layers > 0 else 0)]
        per_stage = temporal_layers // num_stages if temporal_layers else 0
        temporal = [
            TemporalEncoder(c, dim_feedforward, nheads, per_stage,
                            temporal_attn_type, device=device)
            for _ in range(num_stages if temporal_layers > 0 else 0)]
        self.num_stages = num_stages
        self.transformer = _Transformer(len(self.levels),
                                        self.num_temporal_levels, c,
                                        _Encoder(spatial, temporal), device)

    def forward(self, features: dict, generator=None):
        t, c = self.num_frames, self.conv_dims
        tr = self.transformer
        srcs, shapes = [], []
        for i, name in enumerate(self.levels):
            x = features[name]
            srcs.append(self.input_proj[i](x))
            shapes.append((x.shape[1], x.shape[2]))
        shapes = tuple(shapes)
        bt = srcs[0].shape[0]
        dev = srcs[0].device

        pos_flat = torch.cat([
            position_embedding_sine_2d(h, w, c // 2, device=dev).reshape(-1, c)
            + tr.level_embed_2d[i]
            for i, (h, w) in enumerate(shapes)], 0)  # (S, C) f32
        pos_3d = [
            position_embedding_sine_3d(t, h, w, c // 2, device=dev)
            + tr.level_embed_3d[i]
            for i, (h, w) in enumerate(shapes[:self.num_temporal_levels])]

        src = torch.cat([s.reshape(bt, -1, c) for s in srcs], 1)  # (B*T, S, C)
        sizes = [h * w for h, w in shapes]
        enc = tr.encoder
        for stage in range(self.num_stages):
            if len(enc.spatial_layers):
                src = enc.spatial_layers[stage](src, pos_flat, shapes,
                                                generator)
            if len(enc.temporal_layers):
                # the temporal levels are the first ones of the token
                # sequence; the updated prefix is concatenated back
                pieces = list(torch.split(src, sizes, dim=1))
                for i in range(self.num_temporal_levels):
                    pieces[i] = enc.temporal_layers[stage](
                        pieces[i], pos_3d[i], t, shapes[i][0], shapes[i][1])
                src = torch.cat(pieces, 1)

        out = dict(features)
        for i, (piece, (h, w)) in enumerate(
                zip(torch.split(src, sizes, dim=1), shapes)):
            out[self.levels[i]] = self.output_proj[i](piece.reshape(bt, h, w, c))
        return out
