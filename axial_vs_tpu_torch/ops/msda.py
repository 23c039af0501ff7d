"""Multi-scale deformable attention core op (kernel K2), forward and
backward.

Counterpart of ``axial_vs_tpu/ops/msda.py::ms_deform_attn`` together with
its Pallas reduce ``ops/msda_pallas.py::weighted_corner_reduce_v4``: per
query, bilinear samples at P points per level per head, weighted-summed by
attention weights already softmaxed over levels and points. Semantics are
``F.grid_sample(mode='bilinear', padding_mode='zeros', align_corners=False)``.

The CUDA kernel is ``csrc/msda.cu``; ``ms_deform_attn_plain`` is its plain
PyTorch version, an explicit 4-corner gather. The wrapper takes the plain
version for a tensor on the CPU only; a CUDA tensor launches the kernel or
raises. On the card the wrapper picks the kernel's path: 16-byte loads of
``VECTOR_BYTES // element size`` channels a lane where D and the pointers
allow, else one channel a lane (a path of the same kernel, not the plain
version).

Under autograd the card's path is ``_MSDeformAttn``, a
``torch.autograd.Function`` (the port of the JAX package's custom VJP
``weighted_corner_reduce_v4_ad``): its forward launches K2; its backward
recomputes ``ms_deform_attn_plain`` from the saved inputs and returns that
function's VJP, the gradients of value, locations and weights. K2's
workspace-free forward saves only its inputs.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import native

#: the dtypes of value and weights the CUDA kernel takes (one for both)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
#: the kernel's vector path: a lane loads this many bytes of a corner, and a
#: row takes at most 32 lanes
VECTOR_BYTES = 16
#: the kernel's row order by dtype: 0, a block holds all heads of a run of
#: tokens (the memory order); 1, a run of tokens of one head. On the layers'
#: own locations, WC and Tube-Link, 0 was the faster in bf16 (64 rows a
#: block, by 3%) and 1 in f32 (32 rows a block, by 2-6%), in CUDA graphs on
#: an H100 80GB HBM3 at 700 W; the order does not change the result
ROW_ORDER = {torch.bfloat16: 0, torch.float32: 1}
#: the profiler range of K2's backward (the plain version's VJP)
BACKWARD_RANGE = "K2 backward (plain VJP)"


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


def vector_path(value, locations, out) -> bool:
    """Whether the kernel's 16-byte path takes these tensors: D a multiple
    of the channels in 16 bytes and at most 32 such lanes a row, value and
    out 16-byte aligned, locations 8-byte aligned."""
    d = value.shape[-1]
    lanes, rem = divmod(d * value.element_size(), VECTOR_BYTES)
    return (rem == 0 and lanes <= 32 and value.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0 and locations.data_ptr() % 8 == 0)


def ms_deform_attn(value, spatial_shapes, level_start, locations, weights):
    """value (B, S, M, D), levels flattened along S (row-major per level);
    spatial_shapes ((H_0, W_0), ...) ints; level_start (L,) ints;
    locations (B, Lq, M, L, P, 2) normalized (x, y) f32;
    weights (B, Lq, M, L, P), on the card in value's dtype (bf16 or f32).
    Returns (B, Lq, M * D) in value's dtype."""
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
    if native.on_cpu([value, locations, weights]):
        return ms_deform_attn_plain(value, spatial_shapes, level_start,
                                    locations, weights)
    if value.dtype not in KERNEL_DTYPES or weights.dtype != value.dtype:
        raise TypeError("the CUDA kernel takes value and weights both bf16 or "
                        f"both f32, got {value.dtype} / {weights.dtype}")
    if locations.dtype != torch.float32:
        raise TypeError(f"locations must be f32, got {locations.dtype}")
    for t in (value, locations, weights):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, locations, weights)):
        return _MSDeformAttn.apply(value, locations, weights, spatial_shapes,
                                   level_start)
    return _launch(value, spatial_shapes, level_start, locations, weights)


def _launch(value, spatial_shapes, level_start, locations, weights):
    """K2 on checked card tensors; counts the launch."""
    b, s, m, d = value.shape
    _, lq, _, num_levels, p, _ = locations.shape
    levels = (ctypes.c_int * (3 * num_levels))(
        *[x for (h, w), st in zip(spatial_shapes, level_start)
          for x in (h, w, st)])
    out = torch.empty(b, lq, m * d, dtype=value.dtype, device=value.device)
    name = "axvs_msda_fwd" + ("" if value.dtype == torch.bfloat16 else "_f32")
    native.launch(name, value.data_ptr(), locations.data_ptr(),
                  weights.data_ptr(), out.data_ptr(), levels, num_levels, b, s,
                  lq, m, d, p, int(vector_path(value, locations, out)),
                  ROW_ORDER[value.dtype], device=value.device)
    ms_deform_attn.launches += 1
    return out


class _MSDeformAttn(torch.autograd.Function):
    """K2 forward; backward = the VJP of ``ms_deform_attn_plain``,
    recomputed from the saved inputs (as ``_v4_ad_bwd`` takes the VJP of
    ``_v4_math``)."""

    @staticmethod
    def forward(ctx, value, locations, weights, spatial_shapes, level_start):
        ctx.save_for_backward(value, locations, weights)
        ctx.levels = (spatial_shapes, level_start)
        return _launch(value, spatial_shapes, level_start, locations, weights)

    @staticmethod
    def backward(ctx, grad_out):
        shapes, starts = ctx.levels
        return (*native.plain_vjp(
            lambda v, loc, w: ms_deform_attn_plain(v, shapes, starts, loc, w),
            ctx.saved_tensors, grad_out, BACKWARD_RANGE), None, None)


#: kernel launches since the count was last set to 0
ms_deform_attn.launches = 0
