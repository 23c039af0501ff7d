"""Sine position embeddings, 2-D and per-frame 3-D, channels-last
(counterpart of ``axial_vs_tpu/layers/position_embeddings.py``).

DETR-style: cumsum-of-ones coordinates normalized to 2*pi, interleaved
sin/cos per axis, channel order [y, x]; the 3-D form adds a z embedding
spread over 2 * num_pos_feats channels. Temperature 10000. No parameters;
computed in f32 on the requested device.
"""
from __future__ import annotations

import math

import torch


TEMPERATURE = 10000.0


def _sincos(coords, num_feats: int):
    dim = torch.arange(num_feats, dtype=torch.float32, device=coords.device)
    dim_t = TEMPERATURE ** (2 * torch.div(dim, 2, rounding_mode="floor")
                            / num_feats)
    pos = coords[..., None] / dim_t
    return torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()],
                       dim=-1).flatten(-2)


def _axis(n: int, device):
    return (torch.arange(1, n + 1, dtype=torch.float32, device=device)
            / (n + 1e-6) * (2 * math.pi))


def position_embedding_sine_2d(height: int, width: int, num_pos_feats: int = 128,
                               device=None):
    """(H, W, 2 * num_pos_feats) f32."""
    pos_y = _sincos(_axis(height, device), num_pos_feats)
    pos_x = _sincos(_axis(width, device), num_pos_feats)
    return torch.cat([
        pos_y[:, None, :].expand(height, width, num_pos_feats),
        pos_x[None, :, :].expand(height, width, num_pos_feats),
    ], dim=-1)


def position_embedding_sine_3d(num_frames: int, height: int, width: int,
                               num_pos_feats: int = 128, device=None):
    """(T, H, W, 2 * num_pos_feats) f32: [y, x] embedding + z embedding."""
    pos_2d = position_embedding_sine_2d(height, width, num_pos_feats, device)
    pos_z = _sincos(_axis(num_frames, device), num_pos_feats * 2)
    return pos_2d[None] + pos_z[:, None, None, :]
