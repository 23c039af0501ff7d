"""MaXTron video transformer decoder, eval path (counterpart of
``axial_vs_tpu/models/transformer_decoder.py`` with ``num_frames > 1``).

The per-frame pixel features (B*T, H, W, C) are folded into the height
axis, (B, T*H, W, C), so the k-means clustering spans the whole clip, and
the 128-d mask embeddings are returned for cross-clip matching. Auxiliary
predictions are resized per frame to the final resolution. Names follow the
upstream decoder (``_cluster_centers``, ``_kmax_transformer_layers``,
``_class_embedding_projection``, ``_mask_embedding_projection``,
``_predictor``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..layers.convbn import ConvBN
from ..layers.kmax_layers import KMaXPredictor, KMaXTransformerLayer
from ..ops.resize import resize_bilinear


def _fold_time(x, num_frames: int):
    """(B*T, H, W, C) -> (B, T*H, W, C)."""
    bt, h, w, c = x.shape
    return x.reshape(bt // num_frames, num_frames * h, w, c)


class KMaXTransformerDecoder(nn.Module):
    """Dual-path decoder over [OS32, OS16, OS8] pixel features."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 panoptic_channels: int, dec_layers: Sequence[int] = (2, 2, 2),
                 num_queries: int = 128, num_frames: int = 2, device=None):
        super().__init__()
        self.dec_layers = tuple(dec_layers)
        self.num_frames = num_frames
        self.num_queries = num_queries
        self._cluster_centers = nn.Embedding(256, num_queries, device=device)
        self._cluster_centers._inits = {"weight": ("trunc_normal", 1.0)}
        self._kmax_transformer_layers = nn.ModuleList([
            KMaXTransformerLayer(num_classes + 1, in_channels[i],
                                 device=device)
            for i, n in enumerate(self.dec_layers) for _ in range(n)])
        self._class_embedding_projection = ConvBN(
            256, 256, 1, bias=False, norm="syncbn", act="gelu",
            conv_type="1d", device=device)
        self._mask_embedding_projection = ConvBN(
            256, 256, 1, bias=False, norm="syncbn", act="gelu",
            conv_type="1d", device=device)
        self._predictor = KMaXPredictor(panoptic_channels, num_classes + 1,
                                        device=device)

    def forward(self, multi_scale_features, panoptic_features, dtype=None):
        t = self.num_frames
        b = multi_scale_features[0].shape[0] // t
        query = self._cluster_centers.weight.t()[None].expand(
            b, self.num_queries, 256).to(dtype or torch.float32)

        preds = []
        layers = iter(self._kmax_transformer_layers)
        for i, feat in enumerate(multi_scale_features):
            feat = _fold_time(feat, t)
            for _ in range(self.dec_layers[i]):
                query, pred = next(layers)(feat, query)
                preds.append(pred)

        final = self._predictor(self._mask_embedding_projection(query),
                                self._class_embedding_projection(query),
                                _fold_time(panoptic_features, t))

        def unfold(x):  # (B, T*H, W, K) -> (B, T, H, W, K)
            return x.reshape(b, t, x.shape[1] // t, *x.shape[2:])

        th, w = final["mask_logits"].shape[1:3]
        align_corners = w % 2 == 1
        final_hw = (th // t, w)
        aux_outputs = [{
            "pred_logits": p["class_logits"],
            "pred_masks": resize_bilinear(unfold(p["mask_logits"]), final_hw,
                                          align_corners=align_corners),
            "pixel_feature": resize_bilinear(unfold(p["pixel_feature"]),
                                             final_hw,
                                             align_corners=align_corners),
        } for p in preds]
        return {
            "pred_logits": final["class_logits"],
            "pred_masks": unfold(final["mask_logits"]),
            "pixel_feature": unfold(final["pixel_feature"]),
            "aux_outputs": aux_outputs,
            "pred_mask_embeddings": final["mask_embeddings"],  # (B, N, 128)
            "cluster_centers": query,  # (B, N, 256)
        }
