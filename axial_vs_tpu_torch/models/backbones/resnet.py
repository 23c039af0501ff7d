"""ResNet backbone, channels-last (counterpart of
``axial_vs_tpu/models/backbones/resnet.py``).

torchvision's ResNet as detectron2 builds it for the reference: a 7x7/2 stem
and a 3x3/2 max-pool (padded with -inf), then bottleneck blocks (R50 and
deeper; stride on the 3x3) or basic blocks (R18, R34), BatchNorm with
eps 1e-3, outputs res2..res5 at strides 4/8/16/32. Parameter names are
torchvision's (``conv1``, ``bn1``, ``layer{1-4}.{j}.conv{1-3}``,
``bn{1-3}``, ``downsample.{0,1}``), so
``axial_vs_tpu/utils/torch_convert.py::convert_torchvision_resnet`` maps a
port ``state_dict`` to the JAX tree. No dilated res5.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ...layers.convbn import Conv
from ...ops.norm import BatchNorm

NUM_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
              101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
#: std of N(0, 1) truncated to [-2, 2] (the JAX package's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _conv(in_ch: int, out_ch: int, k: int, stride: int = 1, device=None):
    """Bias-free conv, padding k // 2, with the JAX package's init:
    variance_scaling(2.0, "fan_out", "normal")."""
    std = math.sqrt(2.0 / (out_ch * k * k)) / _TRUNC_STD
    return Conv(in_ch, out_ch, k, stride=stride, padding=k // 2, bias=False,
                weight_init=("trunc_normal", std), device=device)


def _downsample(in_ch: int, out_ch: int, stride: int, device):
    if in_ch == out_ch and stride == 1:
        return None
    return nn.Sequential(_conv(in_ch, out_ch, 1, stride, device),
                         BatchNorm(out_ch, device=device))


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, device=None):
        super().__init__()
        self.conv1 = _conv(in_ch, out_ch, 3, stride, device)
        self.bn1 = BatchNorm(out_ch, device=device)
        self.conv2 = _conv(out_ch, out_ch, 3, 1, device)
        self.bn2 = BatchNorm(out_ch, device=device)
        self.downsample = _downsample(in_ch, out_ch, stride, device)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + shortcut)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, width: int, out_ch: int, stride: int = 1,
                 device=None):
        super().__init__()
        self.conv1 = _conv(in_ch, width, 1, 1, device)
        self.bn1 = BatchNorm(width, device=device)
        self.conv2 = _conv(width, width, 3, stride, device)
        self.bn2 = BatchNorm(width, device=device)
        self.conv3 = _conv(width, out_ch, 1, 1, device)
        self.bn3 = BatchNorm(out_ch, device=device)
        self.downsample = _downsample(in_ch, out_ch, stride, device)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + shortcut)


def out_channels(depth: int) -> dict:
    """Channels of res2..res5."""
    first = 64 if depth in (18, 34) else 256
    return {f"res{i + 2}": first << i for i in range(4)}


class ResNet(nn.Module):
    """(N, H, W, 3) -> {"res2".."res5"} at strides 4/8/16/32."""

    def __init__(self, depth: int = 50,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 device=None):
        super().__init__()
        self.out_features = tuple(out_features)
        self.conv1 = _conv(3, 64, 7, 2, device)
        self.bn1 = BatchNorm(64, device=device)
        basic = depth in (18, 34)
        in_ch = 64
        for i, (n_blocks, out_ch) in enumerate(
                zip(NUM_BLOCKS[depth], out_channels(depth).values())):
            blocks = []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(
                    BasicBlock(in_ch, out_ch, stride, device) if basic
                    else Bottleneck(in_ch, 64 << i, out_ch, stride, device))
                in_ch = out_ch
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1)
        y = y.permute(0, 2, 3, 1).contiguous()
        out = {}
        for i in range(4):
            y = getattr(self, f"layer{i + 1}")(y)
            if f"res{i + 2}" in self.out_features:
                out[f"res{i + 2}"] = y
        return out
