"""Bilinear resize with torch ``F.interpolate`` coordinate rules, channels-last
(counterpart of ``axial_vs_tpu/ops/resize.py``).

Two axis-wise weighted gathers with indices and weights computed on the
host from the static sizes, blended in the input dtype as the JAX package
does:
- align_corners=False: ``src = max(0, (dst + 0.5) * in / out - 0.5)``;
- align_corners=True: ``src = dst * (in - 1) / (out - 1)``;
then ``lo = floor(src)``, ``hi = min(lo + 1, in - 1)``, ``w_hi = src - lo``.
"""
from __future__ import annotations

import numpy as np
import torch


def _axis_weights(in_size: int, out_size: int, align_corners: bool):
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = (np.zeros_like(dst) if out_size == 1
               else dst * (in_size - 1) / (out_size - 1))
    else:
        src = np.maximum((dst + 0.5) * (in_size / out_size) - 0.5, 0.0)
    lo = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


def _interp_axis(x, axis: int, out_size: int, align_corners: bool):
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    lo, hi, w_hi = _axis_weights(in_size, out_size, align_corners)
    x_lo = x.index_select(axis, torch.from_numpy(lo).to(x.device))
    x_hi = x.index_select(axis, torch.from_numpy(hi).to(x.device))
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = torch.from_numpy(w_hi).to(device=x.device, dtype=x.dtype).reshape(shape)
    return x_lo * (1 - w) + x_hi * w


def resize_bilinear(x, size, align_corners: bool = False):
    """Resize the (H, W) axes of a channels-last ``(..., H, W, C)`` tensor."""
    x = _interp_axis(x, x.ndim - 3, int(size[0]), align_corners)
    return _interp_axis(x, x.ndim - 2, int(size[1]), align_corners)
