"""Axial-trajectory attention (counterpart of
``axial_vs_tpu/layers/trajectory_attention.py``).

Two stages: a per-frame spatial softmax aggregates each query's trajectory
through every frame, then a temporal softmax runs along the trajectory with
the query's own-frame aggregation as the query. Everything between the
q/k/v projections and the output projection is kernel K3
(``ops/traj.py::trajectory_attention_core``), on every call. The axial layer
applies it along the height axis on (B*W, T*H) sequences, then along the
width axis on (B*H, T*W). Names follow the upstream modules: the
within-clip variant's ``q``, ``k``, ``v`` and the cross-clip variant's one
``qkv``, then ``proj_q``, ``proj_kv``, ``proj``.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..ops.norm import LayerNorm
from ..ops.traj import trajectory_attention_core
from .convbn import Linear


class TrajectoryAttention(nn.Module):
    """Trajectory attention on (B, N, C), N = num_frames * n tokens,
    frame-major. ``fused_qkv=False``: separate q/k/v projections of query,
    key and value (the within-clip variant); ``fused_qkv=True``: one ``qkv``
    projection of query, split in the order q, k, v (the cross-clip
    variant, whose frames are clips)."""

    def __init__(self, dim: int, num_heads: int = 8, fused_qkv: bool = False,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.fused_qkv = fused_qkv
        if fused_qkv:
            self.qkv = Linear(dim, 3 * dim, device=device)
        else:
            self.q = Linear(dim, dim, device=device)
            self.k = Linear(dim, dim, device=device)
            self.v = Linear(dim, dim, device=device)
        self.proj_q = Linear(dim, dim, device=device)
        self.proj_kv = Linear(dim, 2 * dim, device=device)
        self.proj = Linear(dim, dim, device=device)

    def forward(self, query, key=None, value=None, *, num_frames: int):
        if self.fused_qkv:
            q, k, v = (t.contiguous() for t in self.qkv(query).chunk(3, -1))
        else:
            q, k, v = self.q(query), self.k(key), self.v(value)
        out = trajectory_attention_core(
            q, k, v, self.proj_q.weight, self.proj_q.bias, self.proj_kv.weight,
            self.proj_kv.bias, num_frames, self.num_heads)
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
