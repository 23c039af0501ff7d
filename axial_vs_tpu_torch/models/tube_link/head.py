"""Mask2Former tube head, channels-last (counterpart of
``axial_vs_tpu/models/tube_link/head.py``).

The Tube-Link pixel decoder, then 9 decoder layers of [masked
cross-attention over one of 3 pyramid levels (cyclic) x all T frames'
tokens, query self-attention, ReLU FFN], each closed by a LayerNorm. The
prediction heads (``post_norm``, ``cls_embed``, ``mask_embed1-3``) are
shared by every layer; each layer's mask prediction, resized to the next
level and thresholded at sigmoid < 0.5, masks the next cross-attention
(rows that would be masked everywhere are left unmasked).

Names mirror the JAX tree: ``pixel_decoder``, ``level_embed``,
``query_feat``, ``query_embed``, ``post_norm``, ``cls_embed``,
``mask_embed{1,2,3}``, ``layers.{i}.{cross_attn, norm1, self_attn, norm2,
ffn1, ffn2, norm3}`` (``layer{i}_*``); attention blocks hold ``q_proj``,
``k_proj``, ``v_proj``, ``out_proj``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...layers.convbn import Linear
from ...layers.position_embeddings import position_embedding_sine_2d
from ...ops.norm import LayerNorm
from ...ops.resize import resize_bilinear
from .pixel_decoder import LEVELS, TubeLinkPixelDecoder


class MaskedMultiheadAttention(nn.Module):
    """Multi-head attention; ``attn_mask`` (B, 1 or h, Lq, Lk) bool, True =
    blocked (logit -1e9). Softmax in f32."""

    def __init__(self, embed_dims: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(embed_dims, embed_dims, device=device)
        self.k_proj = Linear(embed_dims, embed_dims, device=device)
        self.v_proj = Linear(embed_dims, embed_dims, device=device)
        self.out_proj = Linear(embed_dims, embed_dims, device=device)

    def forward(self, query, key, value, attn_mask=None):
        b, lq, c = query.shape
        lk, h = key.shape[1], self.num_heads
        d = c // h
        q = self.q_proj(query).reshape(b, lq, h, d)
        k = self.k_proj(key).reshape(b, lk, h, d)
        v = self.v_proj(value).reshape(b, lk, h, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask, -1e9)
        weights = F.softmax(logits, -1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, lq, c)
        return self.out_proj(out)


class _DecoderLayer(nn.Module):
    def __init__(self, c: int, num_heads: int, ffn_dim: int, device=None):
        super().__init__()
        self.cross_attn = MaskedMultiheadAttention(c, num_heads, device=device)
        self.norm1 = LayerNorm(c, eps=1e-5, device=device)
        self.self_attn = MaskedMultiheadAttention(c, num_heads, device=device)
        self.norm2 = LayerNorm(c, eps=1e-5, device=device)
        self.ffn1 = Linear(c, ffn_dim, device=device)
        self.ffn2 = Linear(ffn_dim, c, device=device)
        self.norm3 = LayerNorm(c, eps=1e-5, device=device)

    def forward(self, query, qpos, memory, memory_pos, attn_mask):
        query = self.norm1(query + self.cross_attn(
            query + qpos, memory + memory_pos, memory, attn_mask))
        qp = query + qpos
        query = self.norm2(query + self.self_attn(qp, qp, query))
        return self.norm3(query + self.ffn2(F.relu(self.ffn1(query))))


class Mask2FormerVideoHeadTube(nn.Module):
    """``num_queries`` counts every query: with ``num_stuff_classes`` > 0
    (the VPS and image models) the caller passes things' queries plus one
    slot per stuff class, and ``cls_embed`` scores ``num_things_classes +
    num_stuff_classes`` classes and the void class."""

    def __init__(self, in_channels: dict, num_things_classes: int = 40,
                 num_stuff_classes: int = 0,
                 num_queries: int = 100, feat_channels: int = 256,
                 out_channels: int = 256, num_decoder_layers: int = 9,
                 num_heads: int = 8, ffn_dim: int = 2048, num_frames: int = 2,
                 use_temporal_attn: bool = True, device=None):
        super().__init__()
        c = feat_channels
        self.num_frames = num_frames
        self.pixel_decoder = TubeLinkPixelDecoder(
            in_channels, c, out_channels, num_frames=num_frames,
            use_temporal=use_temporal_attn, device=device)
        self.level_embed = nn.Parameter(
            torch.empty(len(LEVELS), c, device=device))
        self.query_feat = nn.Parameter(torch.empty(num_queries, c, device=device))
        self.query_embed = nn.Parameter(
            torch.empty(num_queries, c, device=device))
        self._inits = {k: ("normal", 1.0)
                       for k in ("level_embed", "query_feat", "query_embed")}
        self.post_norm = LayerNorm(c, eps=1e-5, device=device)
        self.cls_embed = Linear(
            c, num_things_classes + num_stuff_classes + 1, device=device)
        self.mask_embed1 = Linear(c, c, device=device)
        self.mask_embed2 = Linear(c, c, device=device)
        self.mask_embed3 = Linear(c, out_channels, device=device)
        self.layers = nn.ModuleList([
            _DecoderLayer(c, num_heads, ffn_dim, device=device)
            for _ in range(num_decoder_layers)])

    def _heads(self, query, mask_features, target_hw):
        """query (B, Q, C); mask_features (B, T, H, W, C). Returns cls
        (B, Q, K+1), masks (B, T, Q, H, W) and the next layer's attention
        mask (B, 1, Q, T*h*w), True = blocked."""
        x = self.post_norm(query)
        cls_pred = self.cls_embed(x)
        y = F.relu(self.mask_embed1(x))
        y = self.mask_embed3(F.relu(self.mask_embed2(y)))
        mask_pred = torch.einsum("bqc,bthwc->btqhw", y, mask_features)
        b, t, q = mask_pred.shape[:3]
        am = resize_bilinear(mask_pred.permute(0, 1, 3, 4, 2), target_hw)
        am = am.permute(0, 4, 1, 2, 3).reshape(b, q, -1)  # (B, Q, T*h*w)
        attn_mask = torch.sigmoid(am) < 0.5
        attn_mask = attn_mask & ~attn_mask.all(-1, keepdim=True)
        return cls_pred, mask_pred, attn_mask[:, None]

    def forward(self, features: dict, return_query: bool = False):
        t = self.num_frames
        mask_features, multi_scale = self.pixel_decoder(features)
        bt, c = mask_features.shape[0], mask_features.shape[-1]
        b = bt // t
        dt = mask_features.dtype
        mask_features = mask_features.reshape(b, t, *mask_features.shape[1:])

        memories, memory_pos, level_hw = [], [], []
        for i, feat in enumerate(multi_scale):
            h, w = feat.shape[1:3]
            level_hw.append((h, w))
            memories.append(feat.reshape(b, t * h * w, c)
                            + self.level_embed[i].to(dt))
            pos = position_embedding_sine_2d(h, w, c // 2, device=feat.device)
            memory_pos.append(pos.reshape(1, h * w, c).repeat(1, t, 1).to(dt))

        query = self.query_feat[None].expand(b, -1, -1).to(dt)
        qpos = self.query_embed[None].expand(b, -1, -1).to(dt)
        cls_pred, mask_pred, attn_mask = self._heads(query, mask_features,
                                                     level_hw[0])
        cls_list, mask_list = [cls_pred], [mask_pred]
        for i, layer in enumerate(self.layers):
            lv = i % len(memories)  # the levels take turns
            query = layer(query, qpos, memories[lv], memory_pos[lv], attn_mask)
            cls_pred, mask_pred, attn_mask = self._heads(
                query, mask_features, level_hw[(i + 1) % len(memories)])
            cls_list.append(cls_pred)
            mask_list.append(mask_pred)

        out = {"cls_preds": cls_list, "mask_preds": mask_list}
        if return_query:
            out["query"] = query
            out["mask_features"] = mask_features
        return out
