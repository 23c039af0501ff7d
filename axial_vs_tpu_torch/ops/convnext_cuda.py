"""Fused 7x7 depthwise conv + LayerNorm of the ConvNeXt block (kernel K1).

Counterpart of ``axial_vs_tpu/ops/convnext_pallas.py::dwconv7x7_layernorm``.
The CUDA kernel is ``csrc/dwconv_ln.cu``; ``dwconv7x7_layernorm_plain`` is
its plain PyTorch version. The wrapper takes the plain version for a tensor
on the CPU only; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import native


def dwconv7x7_layernorm_plain(x, weight, bias, ln_weight, ln_bias,
                              eps: float = 1e-6):
    """x (N, H, W, C); weight (C, 1, 7, 7); bias/ln_* (C,) -> (N, H, W, C)
    in x's dtype: f32 depthwise conv, f32 LayerNorm, one cast at the end."""
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), weight.float(), bias.float(),
                 padding=3, groups=c)
    y = F.layer_norm(y.permute(0, 2, 3, 1), (c,), ln_weight.float(),
                     ln_bias.float(), eps)
    return y.to(x.dtype)


def dwconv7x7_layernorm(x, weight, bias, ln_weight, ln_bias, eps: float = 1e-6):
    """LayerNorm_C(dwconv7x7_same(x) + bias) * ln_weight + ln_bias.

    x (N, H, W, C) bf16 NHWC; weight (C, 1, 7, 7) in torch's depthwise layout;
    bias, ln_weight, ln_bias (C,). Returns (N, H, W, C) in x's dtype."""
    n, h, w, c = x.shape
    if weight.shape != (c, 1, 7, 7):
        raise ValueError(f"weight {tuple(weight.shape)} != ({c}, 1, 7, 7)")
    for t in (bias, ln_weight, ln_bias):
        if t.shape != (c,):
            raise ValueError(f"per-channel parameter {tuple(t.shape)} != ({c},)")
    if x.device.type == "cpu":
        return dwconv7x7_layernorm_plain(x, weight, bias, ln_weight, ln_bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    if c % 2 or c > 2048:
        raise ValueError(f"the CUDA kernel needs an even C <= 2048, got {c}")
    # no-ops when the weights are kept bf16 and the norms f32 (inference)
    weight = weight.to(device=x.device, dtype=torch.bfloat16).contiguous()
    bias, ln_weight, ln_bias = (
        t.to(device=x.device, dtype=torch.float32).contiguous()
        for t in (bias, ln_weight, ln_bias))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = native.library().axvs_dwconv7x7_ln(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            ln_weight.data_ptr(), ln_bias.data_ptr(), out.data_ptr(),
            n, h, w, c, float(eps), stream)
    native.check(status, "axvs_dwconv7x7_ln")
    dwconv7x7_layernorm.launches += 1
    return out


#: kernel launches since the count was last set to 0
dwconv7x7_layernorm.launches = 0
