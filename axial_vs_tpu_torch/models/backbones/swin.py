"""Swin Transformer backbone, channels-last (counterpart of
``axial_vs_tpu/models/backbones/swin.py``).

A 4x4/4 patch embed + LayerNorm, stages of window attention blocks
(W-MSA and shifted SW-MSA in turn, relative position bias, MLP 4x with
GELU), patch merging between stages and a LayerNorm on each output
(res2..res5 at strides 4/8/16/32). Parameter names are the upstream Swin
``state_dict``'s (``patch_embed.proj``, ``patch_embed.norm``,
``layers.{i}.blocks.{j}.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.{i}.downsample.{norm, reduction}``, ``norm{i}``), so
``axial_vs_tpu/utils/torch_convert.py::convert_swin`` maps a port
``state_dict`` to the JAX tree.

As in the JAX module, and where a reading of upstream Swin would differ:

- the patch embed pads ``SAME`` (``pad // 2`` before, the rest after; 13
  pixels pad (1, 2)) where upstream pads only the right and bottom;
- every LayerNorm has eps 1e-5;
- a block pads after ``norm1`` (zeros, not normalized zeros), rolls by
  ``-shift`` and builds the region mask at the padded size, also where the
  padded side equals the window;
- the logits and the bias add stay in the input dtype; the mask (-1e9)
  and the softmax run in f32, cast back to ``v``'s dtype. Window
  attention is plain torch (``torch.matmul`` and a softmax), as XLA
  computes it in the JAX package: no TPU kernel lies under it;
- stochastic depth ``linspace(0, drop_path_rate, sum(depths))``, in
  ``train()`` only, its masks drawn from the step's generator.

The relative position index and the shift masks are constants made from
shapes at forward time (and cached per shape and device), never buffers:
``kmax.py::materialize`` builds on the meta device and fills every
parameter and buffer from an init spec.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...layers.convbn import Conv, DropPath, Linear
from ...ops.norm import LayerNorm
from .convnext import Mlp

_TN02 = ("trunc_normal", 0.02)
_ZERO = ("constant", 0.0)
PATCH = 4
LN_EPS = 1e-5


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B * H/ws * W/ws, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    """The inverse of ``window_partition``."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) int32: the bias table row of each query-key pair."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def shifted_window_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(num_windows, ws*ws, ws*ws) bool, True = blocked: the pairs of a
    shifted window whose pixels come from different regions."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(
        -1, ws * ws)
    return win[:, :, None] != win[:, None, :]


# Constants cached per shape and device. They are made outside inference
# mode even when first asked for inside it: an inference tensor cannot be
# saved for a later backward.

@functools.lru_cache(maxsize=16)
def _index(ws: int, device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(relative_position_index(ws).reshape(-1)
                                .astype(np.int64)).to(device)


@functools.lru_cache(maxsize=64)
def _mask(h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(shifted_window_mask(h, w, ws, shift)).to(
            device)


class WindowAttention(nn.Module):
    """Multi-head self-attention within each window, with the relative
    position bias; on (num_windows * B, ws*ws, C)."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True, device=None):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.qkv = Linear(dim, 3 * dim, weight_init=_TN02, bias_init=_ZERO,
                          bias=qkv_bias, device=device)
        self.proj = Linear(dim, dim, weight_init=_TN02, bias_init=_ZERO,
                           device=device)
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * window_size - 1) ** 2, num_heads, device=device,
            dtype=torch.float32))
        self._inits = {"relative_position_bias_table": _TN02}

    def forward(self, x, mask=None):
        """``mask`` (num_windows, N, N) bool (True = blocked) or None."""
        bnw, n, c = x.shape
        h = self.num_heads
        d = c // h
        qkv = self.qkv(x).reshape(bnw, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (bnw, h, n, d)
        logits = torch.matmul(q * (d ** -0.5), k.transpose(-2, -1))
        bias = self.relative_position_bias_table[
            _index(self.window_size, x.device)].reshape(n, n, h)
        logits = (logits + bias.permute(2, 0, 1)[None].to(logits.dtype)).float()
        if mask is not None:
            nw = mask.shape[0]
            logits = logits.reshape(bnw // nw, nw, h, n, n).masked_fill(
                mask[None, :, None], -1e9).reshape(bnw, h, n, n)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(bnw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    """x + attn(norm1(x)), then x + mlp(norm2(x)), on (B, H, W, C); the
    attention in (shifted) windows of the padded map."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0, device=None):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.drop_path = DropPath(float(drop_path_rate))
        self.norm1 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = WindowAttention(dim, num_heads, window_size, qkv_bias,
                                    device=device)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)

    def forward(self, x, generator=None):
        """``generator`` draws the drop-path masks in ``train()``."""
        _, hh, ww, _ = x.shape
        ws, shift = self.window_size, self.shift
        pad_h, pad_w = (ws - hh % ws) % ws, (ws - ww % ws) % ws
        y = F.pad(self.norm1(x), (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = hh + pad_h, ww + pad_w
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), (1, 2))
            mask = _mask(hp, wp, ws, shift, x.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, hp, wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + self.drop_path(y[:, :hh, :ww], generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class PatchEmbed(nn.Module):
    """4x4/4 conv with SAME padding, then LayerNorm (``patch_norm``)."""

    def __init__(self, embed_dim: int, patch_norm: bool = True, device=None):
        super().__init__()
        self.proj = Conv(3, embed_dim, PATCH, stride=PATCH, weight_init=_TN02,
                         device=device)
        self.norm = (LayerNorm(embed_dim, eps=LN_EPS, device=device)
                     if patch_norm else None)

    def forward(self, x):
        pads = []
        for n in (x.shape[2], x.shape[1]):  # F.pad's order: W, then H
            total = max(-(-n // PATCH) * PATCH - n, 0)
            pads += [total // 2, total - total // 2]
        x = self.proj(F.pad(x, [0, 0] + pads))
        return x if self.norm is None else self.norm(x)


class PatchMerging(nn.Module):
    """2x2 neighbourhood concat (after a bottom/right pad to even sides) ->
    LayerNorm -> bias-free Linear to 2C."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LN_EPS, device=device)
        self.reduction = Linear(4 * dim, 2 * dim, weight_init=_TN02,
                                bias=False, device=device)

    def forward(self, x):
        _, hh, ww, _ = x.shape
        x = F.pad(x, (0, 0, 0, ww % 2, 0, hh % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, drop_path_rates,
                 downsample: bool, device=None):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window_size,
                      shift=0 if j % 2 == 0 else window_size // 2,
                      mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                      drop_path_rate=drop_path_rates[j], device=device)
            for j in range(depth)])
        self.downsample = PatchMerging(dim, device) if downsample else None


class SwinTransformer(nn.Module):
    """(N, H, W, 3) -> {"res2".."res5"} at strides 4/8/16/32, channels C,
    2C, 4C, 8C."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.2,
                 patch_norm: bool = True,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 device=None):
        super().__init__()
        self.out_features = tuple(out_features)
        self.patch_embed = PatchEmbed(embed_dim, patch_norm, device)
        rates = np.linspace(0.0, drop_path_rate, sum(depths)).tolist()
        starts = np.cumsum((0,) + tuple(depths)).tolist()
        self.layers = nn.ModuleList([
            SwinStage(embed_dim << i, depths[i], num_heads[i], window_size,
                      mlp_ratio, qkv_bias, rates[starts[i]:starts[i + 1]],
                      downsample=i < len(depths) - 1, device=device)
            for i in range(len(depths))])
        for i in range(len(depths)):
            if f"res{i + 2}" in self.out_features:
                self.add_module(f"norm{i}", LayerNorm(
                    embed_dim << i, eps=LN_EPS, device=device))

    def forward(self, x, generator=None):
        """``generator`` draws the drop-path masks in ``train()``."""
        x = self.patch_embed(x)
        out = {}
        for i, stage in enumerate(self.layers):
            for block in stage.blocks:
                x = block(x, generator)
            if f"res{i + 2}" in self.out_features:
                out[f"res{i + 2}"] = getattr(self, f"norm{i}")(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return out


def out_channels(embed_dim: int) -> dict:
    """Channels of res2..res5."""
    return {f"res{i + 2}": embed_dim << i for i in range(4)}
