"""Axial-trajectory attention, plain PyTorch (counterpart of
``axial_vs_tpu/layers/trajectory_attention.py``; its opt-in Pallas kernel
``ops/traj_pallas.py`` is not on the within-clip path and is not ported yet).

Two stages: a per-frame spatial softmax aggregates each query's trajectory
through every frame, then a temporal softmax runs along the trajectory with
the query's own-frame aggregation as the query. The axial layer applies it
along the height axis on (B*W, T*H) sequences, then along the width axis on
(B*H, T*W). Softmaxes run in f32. Names follow the upstream within-clip
module (``q``, ``k``, ``v``, ``proj_q``, ``proj_kv``, ``proj``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norm import LayerNorm
from .convbn import Linear


class TrajectoryAttention(nn.Module):
    """Separate q/k/v projections (the within-clip variant) on (B, N, C),
    N = num_frames * n tokens, frame-major."""

    def __init__(self, dim: int, num_heads: int = 8, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(dim, dim, device=device)
        self.k = Linear(dim, dim, device=device)
        self.v = Linear(dim, dim, device=device)
        self.proj_q = Linear(dim, dim, device=device)
        self.proj_kv = Linear(dim, 2 * dim, device=device)
        self.proj = Linear(dim, dim, device=device)

    def forward(self, query, key, value, num_frames: int):
        b, nt, c = query.shape
        f, h = num_frames, self.num_heads
        n, d = nt // f, c // h
        scale = d ** -0.5
        q = self.q(query).reshape(b, nt, h, d)
        k = self.k(key).reshape(b, nt, h, d)
        v = self.v(value).reshape(b, nt, h, d)

        # stage 1: spatial softmax per frame -> per-frame aggregation
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).reshape(b, h, nt, f, n)
        space_attn = F.softmax((scale * logits).float(), -1).to(v.dtype)
        traj = torch.einsum("bhqfn,bfnhd->bqfhd", space_attn,
                            v.reshape(b, f, n, h, d))
        x = traj.reshape(b, nt, f, c)

        # stage 2: temporal attention along the trajectory; the query is
        # token s of frame g's own-frame aggregation (the frame diagonal)
        x_diag = torch.diagonal(x.reshape(b, f, n, f, c), dim1=1, dim2=3)
        x_diag = x_diag.permute(0, 3, 1, 2).reshape(b, nt, c)
        q2 = self.proj_q(x_diag).reshape(b, nt, h, d) * scale
        k2, v2 = self.proj_kv(x).chunk(2, dim=-1)
        k2 = k2.reshape(b, nt, f, h, d)
        v2 = v2.reshape(b, nt, f, h, d)
        t_attn = F.softmax(torch.einsum("bshd,bsfhd->bshf", q2, k2).float(),
                           -1).to(v2.dtype)
        out = torch.einsum("bshf,bsfhd->bshd", t_attn, v2).reshape(b, nt, c)
        return self.proj(out)


class TemporalAxialTrajectoryAttentionLayer(nn.Module):
    """Height-axis then width-axis trajectory attention + ReLU FFN.

    src (B*T, H*W, C); pos (T, H, W, C). Returns (B*T, H*W, C)."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024,
                 num_heads: int = 8, device=None):
        super().__init__()
        self.height_attn = TrajectoryAttention(d_model, num_heads, device=device)
        self.width_attn = TrajectoryAttention(d_model, num_heads, device=device)
        self.norm1 = LayerNorm(d_model, eps=1e-5, device=device)
        self.linear1 = Linear(d_model, d_ffn, device=device)
        self.linear2 = Linear(d_ffn, d_model, device=device)
        self.norm2 = LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, src, pos, num_frames: int, height: int, width: int):
        t, c = num_frames, src.shape[-1]
        b = src.shape[0] // t
        pos = pos.to(src.dtype)[None].expand(b, *pos.shape)

        # (B*T, H*W, C) -> (B*W, T*H, C)
        x = src.reshape(b, t, height, width, c).permute(0, 3, 1, 2, 4)
        x = x.reshape(b * width, t * height, c)
        p = pos.permute(0, 3, 1, 2, 4).reshape(b * width, t * height, c)
        kq = x + p
        x = x + self.height_attn(kq, kq, x, num_frames=t)

        # (B*W, T*H, C) -> (B*H, T*W, C)
        x = x.reshape(b, width, t, height, c).permute(0, 3, 2, 1, 4)
        x = x.reshape(b * height, t * width, c)
        p = p.reshape(b, width, t, height, c).permute(0, 3, 2, 1, 4)
        p = p.reshape(b * height, t * width, c)
        kq = x + p
        x = x + self.width_attn(kq, kq, x, num_frames=t)

        # back to (B*T, H*W, C)
        x = x.reshape(b, height, t, width, c).permute(0, 2, 1, 3, 4)
        x = self.norm1(x.reshape(b * t, height * width, c))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class TemporalEncoder(nn.Module):
    """A stack of axial temporal layers on one feature level."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024, num_heads: int = 8,
                 num_layers: int = 2, temporal_attn_type: str = "axial_trajectory",
                 device=None):
        super().__init__()
        if "axial" not in temporal_attn_type:
            raise NotImplementedError(
                f"temporal attention {temporal_attn_type!r}")
        self.temporal_layers = nn.ModuleList([
            TemporalAxialTrajectoryAttentionLayer(
                d_model, d_ffn, num_heads, device=device)
            for _ in range(num_layers)])

    def forward(self, src, pos, num_frames: int, height: int, width: int):
        for layer in self.temporal_layers:
            src = layer(src, pos, num_frames, height, width)
        return src
