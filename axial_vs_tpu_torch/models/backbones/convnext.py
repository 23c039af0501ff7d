"""ConvNeXt backbone, channels-last (counterpart of
``axial_vs_tpu/models/backbones/convnext.py``).

Parameter names follow timm's ConvNeXt (``stem.0``/``stem.1``,
``stages.{i}.downsample.{0,1}``, ``stages.{i}.blocks.{j}.{conv_dw, norm,
mlp.fc1, mlp.fc2, gamma}``) plus the detectron2 per-stage output norms
``norm{i}``. The stem is a VALID 4x4/4 conv: trailing rows and columns that
cannot fill a window are dropped (769x1345 -> 192x336).

``use_grn`` builds ConvNeXtV2: its blocks put Global Response Normalization
(``GRN``, upstream ``grn.gamma`` / ``grn.beta``) between the MLP's GELU and
its second Linear, and have no layer scale. A GRN block runs the
``"dwln"`` route only: GRN's sum over the whole image spans the row tiles
of K5 and K4, as the JAX package gates its fused paths, so the ``"mlp"``
and ``"block"`` routes raise ``NotImplementedError`` for it.

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

Training adds the JAX package's stochastic depth and remat: block k of the
whole network drops its residual branch per sample at rate
``linspace(0, drop_path_rate, sum(depths))[k]``, as ``(y / keep) * mask``;
with ``remat`` each block runs under ``torch.utils.checkpoint`` (its
activations recomputed in the backward, as ``nn.remat`` does). The
drop-path mask is drawn from the step's generator *before* the checkpointed
call and passed in: the recompute replays only the default generators, so a
mask drawn inside would differ between the forward and its recompute.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...layers.convbn import Conv, Linear, drop_path_mask
from ...ops.act import gelu
from ...ops.convnext_cuda import (convnext_block_fused, convnext_mlp_residual,
                                  dwconv7x7_layernorm, dwconv_taps)
from ...ops.norm import LayerNorm

BLOCK_KERNELS = ("dwln", "mlp", "block")
_TN02 = ("trunc_normal", 0.02)
_ZERO = ("constant", 0.0)


class GRN(nn.Module):
    """Global Response Normalization (ConvNeXtV2) on (N, H, W, C): each
    channel's L2 norm over the image, divided by its mean over channels,
    scales x. The sum of squares runs in f32 and the ratio is cast to x's
    dtype; gamma and beta are f32, zero at init (GRN is then the identity),
    and the result is cast back to x's dtype, as in the JAX module."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim, device=device))
        self.beta = nn.Parameter(torch.empty(dim, device=device))
        self._inits = {"gamma": _ZERO, "beta": _ZERO}

    def forward(self, x):
        gx = x.float().square().sum((1, 2), keepdim=True).sqrt()
        nx = gx / (gx.mean(-1, keepdim=True) + 1e-6)
        y = self.gamma.float() * (x * nx.to(x.dtype))
        return (y + self.beta.float() + x).to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, weight_init=_TN02, bias_init=_ZERO,
                          device=device)
        self.fc2 = Linear(hidden, dim, weight_init=_TN02, bias_init=_ZERO,
                          device=device)

    def forward(self, x, grn=None):
        """fc2(gelu(fc1(x))), with ``grn`` applied before fc2 if given."""
        y = gelu(self.fc1(x))
        return self.fc2(y if grn is None else grn(y))


class ConvNeXtBlock(nn.Module):
    """x + gamma * MLP(LN(dwconv7x7(x))), on (N, H, W, C); with ``use_grn``
    (ConvNeXtV2) x + MLP(LN(dwconv7x7(x))), GRN inside the MLP and no
    gamma."""

    def __init__(self, dim: int, layer_scale_init_value: float = 1e-6,
                 block_kernel: str = "dwln", drop_path_rate: float = 0.0,
                 use_grn: bool = False, device=None):
        super().__init__()
        self.drop_path_rate = float(drop_path_rate)
        if layer_scale_init_value <= 0 and not use_grn:
            raise NotImplementedError("blocks without layer scale")
        if block_kernel not in BLOCK_KERNELS:
            raise ValueError(f"block_kernel {block_kernel!r} not in "
                             f"{BLOCK_KERNELS}")
        if use_grn and block_kernel != "dwln":
            raise NotImplementedError(
                f"the {block_kernel!r} route of a GRN (ConvNeXtV2) block: "
                "GRN sums over the whole image, across the kernel's row "
                "tiles; GRN blocks run the 'dwln' route")
        self.block_kernel = block_kernel
        self.conv_dw = Conv(dim, dim, 7, padding=3, groups=dim,
                            weight_init=_TN02, device=device)
        self.norm = LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = Mlp(dim, 4 * dim, device=device)
        self.grn = GRN(4 * dim, device=device) if use_grn else None
        if use_grn:
            self.gamma = None
        else:
            self.gamma = nn.Parameter(torch.empty(dim, device=device))
            self._inits = {"gamma": ("constant", layer_scale_init_value)}
        # conv_dw's weight tap-major for the kernels: set in eval mode only
        self.register_buffer("dw_taps", None, persistent=False)

    def train(self, mode: bool = True):
        super().train(mode)
        self.dw_taps = (None if mode
                        else dwconv_taps(self.conv_dw.weight.detach()))
        return self

    def forward(self, x, keep_mask=None):
        """``keep_mask`` (N, 1, 1, 1) bool, in ``train()`` at a positive
        drop-path rate: the samples whose residual branch is kept."""
        if self.training:
            y = self.mlp(self.norm(self.conv_dw(x)), self.grn)
            if self.gamma is not None:
                y = y * self.gamma.to(y.dtype)
            if keep_mask is not None:
                y = (y / (1.0 - self.drop_path_rate)) * keep_mask.to(y.dtype)
            return x + y
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
        y = self.mlp(y, self.grn)
        return x + (y if self.gamma is None else y * self.gamma.to(y.dtype))


class ConvNeXtStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int,
                 layer_scale_init_value: float, downsample: bool,
                 block_kernel: str = "dwln", drop_path_rates=None,
                 remat: bool = False, use_grn: bool = False, device=None):
        super().__init__()
        if downsample:
            self.downsample = nn.Sequential(
                LayerNorm(in_dim, eps=1e-6, device=device),
                Conv(in_dim, dim, 2, stride=2, weight_init=_TN02,
                     device=device))
        else:
            self.downsample = nn.Identity()
        rates = drop_path_rates if drop_path_rates is not None else [0.0] * depth
        self.blocks = nn.Sequential(*[
            ConvNeXtBlock(dim, layer_scale_init_value, block_kernel,
                          drop_path_rate=rates[j], use_grn=use_grn,
                          device=device)
            for j in range(depth)])
        self.remat = remat

    def forward(self, x, generator=None):
        x = self.downsample(x)
        if not self.training:
            return self.blocks(x)
        for block in self.blocks:
            mask = (drop_path_mask(x, block.drop_path_rate, generator)
                    if block.drop_path_rate > 0 else None)
            x = (checkpoint(block, x, mask, use_reentrant=False)
                 if self.remat else block(x, mask))
        return x


class ConvNeXt(nn.Module):
    """(N, H, W, 3) -> {"res2".."res5"} at strides 4/8/16/32."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 layer_scale_init_value: float = 1e-6,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 block_kernel: str = "dwln", drop_path_rate: float = 0.0,
                 remat: bool = False, use_grn: bool = False, device=None):
        super().__init__()
        rates = np.linspace(0.0, drop_path_rate, sum(depths)).tolist()
        starts = np.cumsum((0,) + tuple(depths)).tolist()
        self.out_features = tuple(out_features)
        self.stem = nn.Sequential(
            Conv(3, dims[0], 4, stride=4, weight_init=_TN02,
                 device=device),
            LayerNorm(dims[0], eps=1e-6, device=device))
        self.stages = nn.ModuleList([
            ConvNeXtStage(dims[max(i - 1, 0)], dims[i], depths[i],
                          layer_scale_init_value, downsample=i > 0,
                          block_kernel=block_kernel,
                          drop_path_rates=rates[starts[i]:starts[i + 1]],
                          remat=remat, use_grn=use_grn, device=device)
            for i in range(4)])
        for i in range(4):
            if f"res{i + 2}" in self.out_features:
                self.add_module(f"norm{i}", LayerNorm(dims[i], eps=1e-6,
                                                      device=device))

    def forward(self, x, generator=None):
        """``generator`` draws the drop-path masks in ``train()``."""
        x = self.stem(x)
        out = {}
        for i, stage in enumerate(self.stages):
            x = stage(x, generator)
            if f"res{i + 2}" in self.out_features:
                out[f"res{i + 2}"] = getattr(self, f"norm{i}")(x)
        return out
