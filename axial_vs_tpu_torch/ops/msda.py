"""Multi-scale deformable attention core op (kernel K2), forward.

Counterpart of ``axial_vs_tpu/ops/msda.py::ms_deform_attn`` together with
its Pallas reduce ``ops/msda_pallas.py::weighted_corner_reduce_v4``: per
query, bilinear samples at P points per level per head, weighted-summed by
attention weights already softmaxed over levels and points. Semantics are
``F.grid_sample(mode='bilinear', padding_mode='zeros', align_corners=False)``.

The CUDA kernel is ``csrc/msda.cu``; ``ms_deform_attn_plain`` is its plain
PyTorch version, an explicit 4-corner gather. The wrapper takes the plain
version for a tensor on the CPU only; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import native


def level_start_index(spatial_shapes: Sequence[Tuple[int, int]]):
    """Offsets of each level in the flattened S axis."""
    starts, s = [], 0
    for h, w in spatial_shapes:
        starts.append(s)
        s += h * w
    return tuple(starts)


def ms_deform_attn_plain(value, spatial_shapes, level_start, locations,
                         weights):
    """Same contract as ``ms_deform_attn``; f32 arithmetic, output cast to
    value's dtype. Computes the sample coordinate as ``loc * size - 0.5``."""
    b, s, m, d = value.shape
    _, lq, _, num_levels, p, _ = locations.shape
    v_all = value.float().permute(0, 2, 1, 3)  # (B, M, S, D)
    loc = locations.float().permute(0, 2, 1, 3, 4, 5)  # (B, M, Lq, L, P, 2)
    aw = weights.float().permute(0, 2, 1, 3, 4)  # (B, M, Lq, L, P)
    out = torch.zeros(b, m, lq * p, d, dtype=torch.float32, device=value.device)
    for lvl, ((h, w), start) in enumerate(zip(spatial_shapes, level_start)):
        v = v_all[:, :, start:start + h * w]  # (B, M, HW, D)
        ix = loc[:, :, :, lvl, :, 0].reshape(b, m, lq * p) * w - 0.5
        iy = loc[:, :, :, lvl, :, 1].reshape(b, m, lq * p) * h - 0.5
        a = aw[:, :, :, lvl].reshape(b, m, lq * p)
        x0 = torch.floor(ix)
        y0 = torch.floor(iy)
        tx = ix - x0
        ty = iy - y0
        for dy in (0, 1):
            for dx in (0, 1):
                cx = x0 + dx
                cy = y0 + dy
                valid = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
                wgt = (ty if dy else 1 - ty) * (tx if dx else 1 - tx)
                wgt = torch.where(valid, wgt * a, torch.zeros_like(wgt))
                idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
                g = torch.gather(v, 2, idx[..., None].expand(-1, -1, -1, d))
                out = out + g * wgt[..., None]
    out = out.reshape(b, m, lq, p, d).sum(3)  # (B, M, Lq, D)
    return out.permute(0, 2, 1, 3).reshape(b, lq, m * d).to(value.dtype)


def ms_deform_attn(value, spatial_shapes, level_start, locations, weights):
    """value (B, S, M, D), levels flattened along S (row-major per level);
    spatial_shapes ((H_0, W_0), ...) ints; level_start (L,) ints;
    locations (B, Lq, M, L, P, 2) normalized (x, y) f32;
    weights (B, Lq, M, L, P). Returns (B, Lq, M * D) in value's dtype."""
    b, s, m, d = value.shape
    _, lq, _, num_levels, p, two = locations.shape
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    level_start = tuple(int(x) for x in level_start)
    if (two != 2 or num_levels != len(spatial_shapes)
            or level_start != level_start_index(spatial_shapes)
            or s != sum(h * w for h, w in spatial_shapes)):
        raise ValueError("value, spatial_shapes, level_start and locations "
                         "disagree")
    if locations.shape[:3] != (b, lq, m) or weights.shape != (b, lq, m, num_levels, p):
        raise ValueError(f"locations {tuple(locations.shape)} / weights "
                         f"{tuple(weights.shape)} do not match value "
                         f"{tuple(value.shape)}")
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, level_start,
                                    locations, weights)
    if value.device.type != "cuda":
        raise ValueError(f"no kernel for device {value.device}")
    if value.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16:
        raise TypeError("the CUDA kernel takes bf16 value and weights, got "
                        f"{value.dtype} / {weights.dtype}")
    if locations.dtype != torch.float32:
        raise TypeError(f"locations must be f32, got {locations.dtype}")
    for t in (value, locations, weights):
        if t.device != value.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one device")
    levels = (ctypes.c_int * (3 * num_levels))(
        *[x for (h, w), st in zip(spatial_shapes, level_start)
          for x in (h, w, st)])
    out = torch.empty(b, lq, m * d, dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        status = native.library().axvs_msda_fwd(
            value.data_ptr(), locations.data_ptr(), weights.data_ptr(),
            out.data_ptr(), levels, num_levels, b, s, lq, m, d, p, stream)
    native.check(status, "axvs_msda_fwd")
    ms_deform_attn.launches += 1
    return out


#: kernel launches since the count was last set to 0
ms_deform_attn.launches = 0
