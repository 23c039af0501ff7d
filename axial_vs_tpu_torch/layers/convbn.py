"""Linear, channels-last conv, ConvBN and the stochastic layers DropPath and
Dropout (counterpart of ``axial_vs_tpu/layers/convbn.py``).

Weights keep torch's layouts (Linear (O, I), Conv (O, I / groups, *k)) and
names, so ``state_dict`` keys match the upstream torch modules. The input is
channels-last (NLC / NHWC); a 1x1 conv is a matmul over the last axis.

DropPath and Dropout draw their masks from a ``torch.Generator`` that the
caller passes to ``forward``; they are the identity in ``eval()`` and at
rate 0, and raise in ``train()`` at a positive rate without a generator.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.act import gelu
from ..ops.norm import BatchNorm, LayerNorm


class Linear(nn.Module):
    """Dense layer on the last axis. Default inits are the JAX package's
    ``_dense``: xavier-uniform weight, torch's U(+-1/sqrt(fan_in)) bias;
    ``bias=False`` drops the bias."""

    def __init__(self, in_features: int, out_features: int,
                 weight_init=("xavier_uniform",), bias_init=None,
                 bias: bool = True, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self._inits = {"weight": weight_init}
        if bias:
            self.bias = nn.Parameter(torch.empty(out_features, device=device))
            self._inits["bias"] = bias_init or ("uniform",
                                                1.0 / math.sqrt(in_features))
        else:
            self.bias = None

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class Conv(nn.Module):
    """Conv with torch-layout weights applied to channels-last input.

    ``ndim`` 2: (N, H, W, C) with weight (O, I/groups, k, k); ``ndim`` 1:
    (N, L, C) with weight (O, I, k), stride 1, one group and no padding
    (the caller pads), its k taps ``dilation`` apart."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True, ndim: int = 2,
                 weight_init=("he_normal", None), dilation: int = 1,
                 device=None):
        super().__init__()
        if ndim == 1 and (stride != 1 or groups != 1 or padding != 0):
            raise NotImplementedError("1-D convs of stride 1, one group and "
                                      "no padding only")
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dilation = dilation
        self.pointwise = kernel_size == 1 and stride == 1 and groups == 1
        self.ndim = ndim
        shape = (out_channels, in_channels // groups) + (kernel_size,) * ndim
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        if weight_init[0] == "he_normal":
            weight_init = ("he_normal", in_channels)
        self._inits = {"weight": weight_init}
        if bias:
            self.bias = nn.Parameter(torch.empty(out_channels, device=device))
            self._inits["bias"] = ("constant", 0.0)
        else:
            self.bias = None

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.pointwise:
            return F.linear(x, w.reshape(w.shape[0], w.shape[1]), b)
        if self.ndim == 1:  # (B, L, C) in and out, no padding
            y = F.conv1d(x.transpose(1, 2), w, b, dilation=self.dilation)
            return y.transpose(1, 2)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.stride, self.padding,
                     self.dilation, self.groups)
        # NHWC and dense, as the kernels downstream require (a no-op when
        # the conv already returned channels-last memory)
        return y.permute(0, 2, 3, 1).contiguous()


class ConvBN(nn.Module):
    """Conv (+ BatchNorm) (+ activation), the reference's ConvBN.

    ``conv_init``: he_normal (trunc_normal with std sqrt(2 / in_channels))
    or xavier_uniform; ``conv_init_std`` overrides it with
    trunc_normal(std). ``norm`` is "syncbn" (BatchNorm), "ln" (LayerNorm
    over the channels, eps 1e-6, as the JAX package's ``get_norm``) or None;
    ``norm_init`` sets the BatchNorm's gamma (0.0 for residual-ending convs).
    ``act`` is "gelu" or None."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True, norm=None, act=None, conv_type: str = "2d",
                 conv_init: str = "he_normal", conv_init_std=None,
                 norm_init: float = 1.0, dilation: int = 1, device=None):
        super().__init__()
        if norm not in ("syncbn", "ln", None) or act not in ("gelu", None):
            raise NotImplementedError(f"norm {norm!r}, act {act!r}")
        if norm == "ln" and norm_init != 1.0:
            raise NotImplementedError("norm_init is a BatchNorm option")
        winit = (("trunc_normal", conv_init_std) if conv_init_std is not None
                 else (conv_init, None))
        self.conv = Conv(in_channels, out_channels, kernel_size, stride,
                         padding, groups, bias,
                         ndim=2 if conv_type == "2d" else 1, weight_init=winit,
                         dilation=dilation, device=device)
        self.norm = (BatchNorm(out_channels, scale_init=norm_init,
                               device=device) if norm == "syncbn"
                     else LayerNorm(out_channels, eps=1e-6, device=device)
                     if norm == "ln" else None)
        self.act = act

    def forward(self, x):
        y = self.conv(x)
        if self.norm is not None:
            y = self.norm(y)
        return gelu(y) if self.act else y


def _keep_mask(x, rate: float, shape, generator):
    if generator is None:
        raise TypeError("a stochastic layer in train() at a positive rate "
                        "needs the step's torch.Generator")
    return torch.rand(shape, generator=generator, device=x.device) < 1.0 - rate


def drop_path_mask(x, rate: float, generator):
    """DropPath's per-sample keep mask for ``x``, (N, 1, ...) bool."""
    return _keep_mask(x, rate, (x.shape[0],) + (1,) * (x.ndim - 1), generator)


class DropPath(nn.Module):
    """Per-sample stochastic depth: in ``train()`` each sample of the
    leading axis is kept with probability 1 - rate and scaled by
    1 / (1 - rate)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0:
            return x
        mask = drop_path_mask(x, self.rate, generator)
        return (x / (1.0 - self.rate)) * mask.to(x.dtype)


class Dropout(nn.Module):
    """Element-wise dropout: in ``train()`` each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0:
            return x
        mask = _keep_mask(x, self.rate, x.shape, generator)
        return torch.where(mask, x / (1.0 - self.rate), torch.zeros_like(x))
