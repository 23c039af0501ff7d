"""Normalization layers, eval paths (counterpart of ``axial_vs_tpu/ops/norm.py``).

Channels-last: the normalized axis is the last one. Parameter and buffer
names are torch's (``weight``, ``bias``, ``running_mean``, ``running_var``).
The statistics and affines follow the JAX package's formulas, so the two
agree to f32 rounding:

- BatchNorm (eps 1e-3): running stats folded into an f32 affine, applied in
  the input dtype;
- LayerNorm: f32, variance as E[x^2] - E[x]^2;
- GroupNorm (32 groups, eps 1e-5): f32 statistics over spatial axes and the
  channels of a group.
"""
from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-3


def _vector(n, device):
    return nn.Parameter(torch.empty(n, device=device, dtype=torch.float32))


class BatchNorm(nn.Module):
    """Eval-time BatchNorm over the last axis; ``scale_init`` sets gamma."""

    def __init__(self, features: int, scale_init: float = 1.0, device=None):
        super().__init__()
        self.weight = _vector(features, device)
        self.bias = _vector(features, device)
        self.register_buffer("running_mean", torch.empty(
            features, device=device, dtype=torch.float32))
        self.register_buffer("running_var", torch.empty(
            features, device=device, dtype=torch.float32))
        self._inits = {"weight": ("constant", scale_init),
                       "bias": ("constant", 0.0),
                       "running_mean": ("constant", 0.0),
                       "running_var": ("constant", 1.0)}

    def folded(self):
        """(s, b) in f32 with BN(x) = x * s + b."""
        s = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        return s, self.bias - self.running_mean * s

    def forward(self, x):
        s, b = self.folded()
        return x * s.to(x.dtype) + b.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, computed in f32, returned in x's dtype."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _vector(features, device)
        self.bias = _vector(features, device)
        self._inits = {"weight": ("constant", 1.0), "bias": ("constant", 0.0)}

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
        inv = torch.rsqrt(var + self.eps)
        return ((xf - mean) * (inv * self.weight) + self.bias).to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm over (spatial..., C) with C split into ``num_groups``."""

    def __init__(self, features: int, num_groups: int = 32, device=None):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"channels {features} not divisible by "
                             f"groups {num_groups}")
        self.num_groups = num_groups
        self.weight = _vector(features, device)
        self.bias = _vector(features, device)
        self._inits = {"weight": ("constant", 1.0), "bias": ("constant", 0.0)}

    def forward(self, x):
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        spatial = tuple(range(1, x.ndim - 1))
        xf = x.float()
        n_red = (c // g) * xf[0, ..., 0].numel()
        s1 = xf.sum(spatial).reshape(b, g, c // g).sum(-1)
        s2 = xf.square().sum(spatial).reshape(b, g, c // g).sum(-1)
        mean = s1 / n_red
        var = (s2 / n_red - mean.square()).clamp_min(0.0)
        inv = torch.rsqrt(var + 1e-5)
        mean_c = mean.repeat_interleave(c // g, -1)
        inv_c = inv.repeat_interleave(c // g, -1)
        shape = (b,) + (1,) * (x.ndim - 2) + (c,)
        w_c = (inv_c * self.weight).reshape(shape)
        b_c = (self.bias - mean_c * inv_c * self.weight).reshape(shape)
        return (xf * w_c + b_c).to(x.dtype)
