"""STDC backbone (STDC1 / STDC2), channels-last (counterpart of
``axial_vs_tpu/models/backbones/stdc.py``).

ConvX (conv -> BatchNorm -> ReLU), CatBottleneck / AddBottleneck with the
short-term dense concat topology, STDC1 (layers 2/2/2) and STDC2 (4/5/3),
base 64, four branches a block, returning strides 4/8/16/32 with channels
64/256/512/1024. As in the JAX module: BatchNorm eps 1e-5 (the torch
default, not the 1e-3 used elsewhere in the port), the stride-2
CatBottleneck's shortcut an ``AvgPool2d(3, 2, 1)`` that counts the
padding, and Kaiming-normal fan-out conv inits (not truncated).

Parameter names are the upstream ``state_dict``'s, as saved after its
constructor wraps slices of ``features`` in another ``Sequential`` (so the
keys keep the original feature index): ``x2.0.0``, ``x4.0.1``,
``x8/x16/x32.0.{k}`` with each block's ``conv_list.{i}.{conv, bn}``,
``avd_layer.{0, 1}`` and the AddBottleneck's ``skip.{0..3}``; these are
the names ``axial_vs_tpu/utils/torch_convert.py::convert_stdc`` reads.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers.convbn import Conv
from ...ops.norm import BatchNorm

STDC_LAYERS = {"stdc1": (2, 2, 2), "stdc2": (4, 5, 3)}
BN_EPS = 1e-5
BRANCHES = 4  # ConvX branches a bottleneck (the reference's block_num)


def _conv(in_ch: int, out_ch: int, k: int, stride: int = 1, groups: int = 1,
          device=None):
    """Bias-free conv, padding k // 2, with the JAX package's init:
    variance_scaling(2.0, "fan_out", "normal")."""
    std = math.sqrt(2.0 / (out_ch * k * k))
    return Conv(in_ch, out_ch, k, stride=stride, padding=k // 2,
                groups=groups, bias=False, weight_init=("normal", std),
                device=device)


def _bn(features: int, device=None):
    return BatchNorm(features, eps=BN_EPS, device=device)


class ConvX(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, device=None):
        super().__init__()
        self.conv = _conv(in_ch, out_ch, kernel, stride, device=device)
        self.bn = _bn(out_ch, device)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _dw_norm(features: int, device=None):
    """3x3 stride-2 depthwise conv + BatchNorm (the avd and skip pieces)."""
    return nn.Sequential(_conv(features, features, 3, 2, features, device),
                         _bn(features, device))


def _branch_channels(out_planes: int) -> Sequence[int]:
    # idx 0 -> out/2, idx 1 -> out/4, ..., the last idx repeats the
    # previous width, so that the concat sums back to out_planes
    chans = []
    for idx in range(BRANCHES):
        if idx == 0:
            chans.append(out_planes // 2)
        elif idx < BRANCHES - 1:
            chans.append(out_planes // (2 ** (idx + 1)))
        else:
            chans.append(out_planes // (2 ** idx))
    return chans


class CatBottleneck(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 device=None):
        super().__init__()
        chans = _branch_channels(out_planes)
        self.stride = stride
        self.conv_list = nn.ModuleList(
            [ConvX(in_planes, chans[0], 1, device=device)]
            + [ConvX(chans[idx - 1], chans[idx], device=device)
               for idx in range(1, BRANCHES)])
        self.avd_layer = _dw_norm(chans[0], device) if stride == 2 else None

    def forward(self, x):
        out1 = self.conv_list[0](x)
        outs = []
        y = out1
        for idx, conv in enumerate(self.conv_list[1:], 1):
            if idx == 1 and self.avd_layer is not None:
                y = self.avd_layer(y)
            y = conv(y)
            outs.append(y)
        if self.stride == 2:
            out1 = F.avg_pool2d(out1.permute(0, 3, 1, 2), 3, 2, 1,
                                count_include_pad=True).permute(0, 2, 3, 1)
        return torch.cat([out1] + outs, -1)


class AddBottleneck(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 device=None):
        super().__init__()
        chans = _branch_channels(out_planes)
        self.conv_list = nn.ModuleList(
            [ConvX(in_planes if idx == 0 else chans[idx - 1], chans[idx],
                   1 if idx == 0 else 3, device=device)
             for idx in range(BRANCHES)])
        self.avd_layer = _dw_norm(chans[0], device) if stride == 2 else None
        self.skip = (nn.Sequential(*_dw_norm(in_planes, device),
                                   _conv(in_planes, out_planes, 1,
                                         device=device),
                                   _bn(out_planes, device))
                     if stride == 2 else None)

    def forward(self, x):
        outs = []
        y = x
        for idx, conv in enumerate(self.conv_list):
            y = conv(y)
            if idx == 0 and self.avd_layer is not None:
                y = self.avd_layer(y)
            outs.append(y)
        if self.skip is not None:
            x = self.skip(x)
        return torch.cat(outs, -1) + x


class STDCNet(nn.Module):
    """(N, H, W, 3) -> {"res2".."res5"} at strides 4/8/16/32 (channels
    64/256/512/1024 at base 64)."""

    def __init__(self, layers: Sequence[int] = (4, 5, 3), base: int = 64,
                 block_type: str = "cat",
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 device=None):
        super().__init__()
        block = CatBottleneck if block_type == "cat" else AddBottleneck
        self.out_features = tuple(out_features)
        self.x2 = nn.Sequential(nn.Sequential(OrderedDict(
            [("0", ConvX(3, base // 2, stride=2, device=device))])))
        self.x4 = nn.Sequential(nn.Sequential(OrderedDict(
            [("1", ConvX(base // 2, base, stride=2, device=device))])))
        idx, in_planes = 2, base
        for i, n_blocks in enumerate(layers):
            planes = base * (2 ** (i + 2))
            blocks = []
            for j in range(n_blocks):
                blocks.append((str(idx), block(in_planes, planes,
                                               2 if j == 0 else 1, device)))
                idx, in_planes = idx + 1, planes
            self.add_module(f"x{8 << i}",
                            nn.Sequential(nn.Sequential(OrderedDict(blocks))))
        self.num_stages = len(layers)

    def forward(self, x, generator=None):
        """``generator`` is unused: STDC has no stochastic layer."""
        x = self.x4(self.x2(x))
        out = {"res2": x}
        for i in range(self.num_stages):
            x = getattr(self, f"x{8 << i}")(x)
            out[f"res{i + 3}"] = x
        return {k: v for k, v in out.items() if k in self.out_features}


def out_channels(base: int = 64) -> dict:
    """Channels of res2..res5."""
    return {"res2": base, **{f"res{i + 3}": base * (4 << i) for i in range(3)}}
