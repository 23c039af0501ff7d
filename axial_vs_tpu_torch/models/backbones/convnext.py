"""ConvNeXt backbone, channels-last (counterpart of
``axial_vs_tpu/models/backbones/convnext.py``).

Parameter names follow timm's ConvNeXt (``stem.0``/``stem.1``,
``stages.{i}.downsample.{0,1}``, ``stages.{i}.blocks.{j}.{conv_dw, norm,
mlp.fc1, mlp.fc2, gamma}``) plus the detectron2 per-stage output norms
``norm{i}``. The stem is a VALID 4x4/4 conv: trailing rows and columns that
cannot fill a window are dropped (769x1345 -> 192x336). This is the inference
path; the ConvNeXtV2 GRN block is not ported yet.

``block_kernel`` picks a block's route at inference, as the JAX package's env
gates do (``AXIALVS_FUSED_MLP``, ``AXIALVS_FUSED_BLOCK``, the latter winning):
- ``"dwln"`` (the default): kernel K1 (fused 7x7 depthwise conv + LayerNorm),
  then the MLP as two Linear layers;
- ``"mlp"``: K1, then kernel K5 (the MLP tail with layer scale and residual);
- ``"block"``: kernel K4, the whole block in one launch.
The parameters are the same on every route. K1 and K4 take the depthwise
weight tap-major (``ops/convnext_cuda.py::dwconv_taps``): the block takes that
copy, the buffer ``dw_taps``, when it enters eval mode, so weights changed
after ``eval()`` need another ``eval()``. In training mode a block runs
its own modules (``conv_dw``, ``norm``, ``mlp``, ``gamma``) as plain,
differentiable torch ops, as JAX trains through XLA: the kernels have no
backward (and refuse to run where autograd would need one).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...layers.convbn import Conv, Linear
from ...ops.act import gelu
from ...ops.convnext_cuda import (convnext_block_fused, convnext_mlp_residual,
                                  dwconv7x7_layernorm, dwconv_taps)
from ...ops.norm import LayerNorm

BLOCK_KERNELS = ("dwln", "mlp", "block")
_TN02 = ("trunc_normal", 0.02)
_ZERO = ("constant", 0.0)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, weight_init=_TN02, bias_init=_ZERO,
                          device=device)
        self.fc2 = Linear(hidden, dim, weight_init=_TN02, bias_init=_ZERO,
                          device=device)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class ConvNeXtBlock(nn.Module):
    """x + gamma * MLP(LN(dwconv7x7(x))), on (N, H, W, C)."""

    def __init__(self, dim: int, layer_scale_init_value: float = 1e-6,
                 block_kernel: str = "dwln", device=None):
        super().__init__()
        if layer_scale_init_value <= 0:
            raise NotImplementedError("blocks without layer scale")
        if block_kernel not in BLOCK_KERNELS:
            raise ValueError(f"block_kernel {block_kernel!r} not in "
                             f"{BLOCK_KERNELS}")
        self.block_kernel = block_kernel
        self.conv_dw = Conv(dim, dim, 7, padding=3, groups=dim,
                            weight_init=_TN02, device=device)
        self.norm = LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = Mlp(dim, 4 * dim, device=device)
        self.gamma = nn.Parameter(torch.empty(dim, device=device))
        self._inits = {"gamma": ("constant", layer_scale_init_value)}
        # conv_dw's weight tap-major for the kernels: set in eval mode only
        self.register_buffer("dw_taps", None, persistent=False)

    def train(self, mode: bool = True):
        super().train(mode)
        self.dw_taps = (None if mode
                        else dwconv_taps(self.conv_dw.weight.detach()))
        return self

    def forward(self, x):
        if self.training:
            y = self.mlp(self.norm(self.conv_dw(x)))
            return x + y * self.gamma.to(y.dtype)
        route = self.block_kernel
        dw, norm, fc1, fc2 = self.conv_dw, self.norm, self.mlp.fc1, self.mlp.fc2
        if route == "block":
            return convnext_block_fused(
                x, dw.weight, dw.bias, norm.weight, norm.bias, fc1.weight,
                fc1.bias, fc2.weight, fc2.bias, self.gamma, eps=norm.eps,
                taps=self.dw_taps)
        y = dwconv7x7_layernorm(x, dw.weight, dw.bias, norm.weight, norm.bias,
                                eps=norm.eps, taps=self.dw_taps)
        if route == "mlp":
            return convnext_mlp_residual(y, x, fc1.weight, fc1.bias,
                                         fc2.weight, fc2.bias, self.gamma)
        y = self.mlp(y)
        return x + y * self.gamma.to(y.dtype)


class ConvNeXtStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int,
                 layer_scale_init_value: float, downsample: bool,
                 block_kernel: str = "dwln", device=None):
        super().__init__()
        if downsample:
            self.downsample = nn.Sequential(
                LayerNorm(in_dim, eps=1e-6, device=device),
                Conv(in_dim, dim, 2, stride=2, weight_init=_TN02,
                     device=device))
        else:
            self.downsample = nn.Identity()
        self.blocks = nn.Sequential(*[
            ConvNeXtBlock(dim, layer_scale_init_value, block_kernel,
                          device=device)
            for _ in range(depth)])

    def forward(self, x):
        return self.blocks(self.downsample(x))


class ConvNeXt(nn.Module):
    """(N, H, W, 3) -> {"res2".."res5"} at strides 4/8/16/32."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 layer_scale_init_value: float = 1e-6,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 block_kernel: str = "dwln", device=None):
        super().__init__()
        self.out_features = tuple(out_features)
        self.stem = nn.Sequential(
            Conv(3, dims[0], 4, stride=4, weight_init=_TN02,
                 device=device),
            LayerNorm(dims[0], eps=1e-6, device=device))
        self.stages = nn.ModuleList([
            ConvNeXtStage(dims[max(i - 1, 0)], dims[i], depths[i],
                          layer_scale_init_value, downsample=i > 0,
                          block_kernel=block_kernel, device=device)
            for i in range(4)])
        for i in range(4):
            if f"res{i + 2}" in self.out_features:
                self.add_module(f"norm{i}", LayerNorm(dims[i], eps=1e-6,
                                                      device=device))

    def forward(self, x):
        x = self.stem(x)
        out = {}
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if f"res{i + 2}" in self.out_features:
                out[f"res{i + 2}"] = getattr(self, f"norm{i}")(x)
        return out
