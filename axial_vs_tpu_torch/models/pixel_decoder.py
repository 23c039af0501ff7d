"""kMaX axial-attention pixel decoder, channels-last (counterpart of
``axial_vs_tpu/models/pixel_decoder.py``).

Consumes backbone features res5..res2 (low to high resolution), runs a
group of axial or bottleneck residual blocks per stage and fuses each
stage's upsampled output with the next (LayerNorm'ed) backbone level.
Names follow the upstream ``kMaXPixelDecoder`` (``_in_norms``,
``_stages.{i}._blocks.{j}``, ``_resized_fuses.{i}``).
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ..layers.axial_attention import AxialAttention2D
from ..layers.convbn import ConvBN, DropPath
from ..ops.act import gelu
from ..ops.norm import LayerNorm
from ..ops.resize import resize_bilinear


class SingleBlock(nn.Module):
    """gelu -> 1x1 -> (axial attention | 3x3) -> 1x1 (BN gamma 0) ->
    DropPath + shortcut."""

    def __init__(self, in_channels: int, filter_list: Sequence[int],
                 block_type: str, drop_path_prob: float = 0.0, device=None):
        super().__init__()
        self.drop_path = DropPath(drop_path_prob)
        f0, f1, f2 = filter_list
        self._shortcut = (ConvBN(in_channels, f2, 1, bias=False, norm="syncbn",
                                 device=device)
                          if in_channels != f2 else None)
        self._conv1_bn_act = ConvBN(in_channels, f0, 1, bias=False,
                                    norm="syncbn", act="gelu", device=device)
        self.block_type = block_type
        if block_type == "axial":
            self._attention = AxialAttention2D(f0, filters=f1, device=device)
            mid = self._attention.tv
        elif block_type == "bottleneck":
            self._conv2_bn_act = ConvBN(f0, f1, 3, padding=1, bias=False,
                                        norm="syncbn", act="gelu",
                                        device=device)
            mid = f1
        else:
            raise ValueError(f"unknown block type {block_type!r}")
        self._conv3_bn = ConvBN(mid, f2, 1, bias=False, norm="syncbn",
                                norm_init=0.0, device=device)

    def forward(self, x, generator=None):
        x = gelu(x)
        shortcut = x if self._shortcut is None else self._shortcut(x)
        y = self._conv1_bn_act(x)
        if self.block_type == "axial":
            y = gelu(self._attention(y))
        else:
            y = self._conv2_bn_act(y)
        return self.drop_path(self._conv3_bn(y), generator) + shortcut


class BlockGroup(nn.Module):
    """num_blocks blocks; filters [2f, f, 4f] (axial) or [f, f, 4f]."""

    def __init__(self, in_channels: int, base_filter: int, num_blocks: int,
                 block_type: str, drop_path_prob: float = 0.0, device=None):
        super().__init__()
        bt = block_type.lower()
        filter_list = ([base_filter * 2, base_filter, base_filter * 4]
                       if bt == "axial"
                       else [base_filter, base_filter, base_filter * 4])
        self._blocks = nn.ModuleList()
        for _ in range(num_blocks):
            self._blocks.append(SingleBlock(in_channels, filter_list, bt,
                                            drop_path_prob, device=device))
            in_channels = filter_list[-1]
        self.out_channels = filter_list[-1]

    def forward(self, x, generator=None):
        for block in self._blocks:
            x = block(x, generator)
        return x


class ResizedFuse(nn.Module):
    """Upsample the low-res input (align_corners for odd widths) and add the
    projected high-res input."""

    def __init__(self, low_channels: int, high_channels: int,
                 out_channels: int, device=None):
        super().__init__()
        self._conv_bn_low = (ConvBN(low_channels, out_channels, 1, bias=False,
                                    norm="syncbn", device=device)
                             if low_channels != out_channels else None)
        self._conv_bn_high = (ConvBN(high_channels, out_channels, 1,
                                     bias=False, norm="syncbn", device=device)
                              if high_channels != out_channels else None)

    def forward(self, lowres_x, highres_x):
        align_corners = lowres_x.shape[-2] % 2 == 1
        if self._conv_bn_low is not None:
            lowres_x = self._conv_bn_low(gelu(lowres_x))
        lowres_x = resize_bilinear(lowres_x, highres_x.shape[-3:-1],
                                   align_corners=align_corners)
        if self._conv_bn_high is not None:
            highres_x = self._conv_bn_high(gelu(highres_x))
        return lowres_x + highres_x


class KMaXPixelDecoder(nn.Module):
    """Returns (panoptic features OS4, the semantic head's inputs [OS32,
    OS8, OS4] as the backbone (or WC module) gave them, multi-scale
    features [OS32, OS16, OS8]). ``drop_path_prob`` is every block's
    DropPath rate in ``train()``."""

    def __init__(self, in_channels: dict,
                 in_features: Sequence[str] = ("res5", "res4", "res3", "res2"),
                 dec_layers: Sequence[int] = (1, 5, 1, 1),
                 dec_channels: Sequence[int] = (512, 256, 128, 64),
                 layer_types: Sequence[str] = ("axial", "axial", "bottleneck",
                                               "bottleneck"),
                 drop_path_prob: float = 0.0, device=None):
        super().__init__()
        self.in_features = tuple(in_features)
        n = len(self.in_features)
        self._in_norms = nn.ModuleList([
            LayerNorm(in_channels[f], eps=1e-6, device=device)
            for f in self.in_features])
        self._stages = nn.ModuleList()
        self._resized_fuses = nn.ModuleList()
        ch = in_channels[self.in_features[0]]
        for i in range(n):
            stage = BlockGroup(ch, dec_channels[i], dec_layers[i],
                               layer_types[i], drop_path_prob, device=device)
            self._stages.append(stage)
            if i < n - 1:
                self._resized_fuses.append(ResizedFuse(
                    stage.out_channels, in_channels[self.in_features[i + 1]],
                    dec_channels[i + 1], device=device))
                ch = dec_channels[i + 1]

    def forward(self, features: dict, generator=None):
        out = []
        x = self._in_norms[0](features[self.in_features[0]])
        for i, fuse in enumerate(self._resized_fuses):
            x = self._stages[i](x, generator)
            out.append(x)
            high = self._in_norms[i + 1](features[self.in_features[i + 1]])
            x = fuse(x, high)
        x = self._stages[-1](x, generator)
        semantic = [features[self.in_features[i]] for i in (0, 2, 3)]
        return x, semantic, out
