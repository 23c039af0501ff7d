"""kMaX / MaXTron transformer decoder (counterpart of
``axial_vs_tpu/models/transformer_decoder.py``).

The per-frame pixel features (B*T, H, W, C) are folded into the height
axis, (B, T*H, W, C), so the k-means clustering spans the whole clip, and
the 128-d mask embeddings are returned for cross-clip matching. Auxiliary
predictions are resized per frame to the final resolution. Names follow the
upstream decoder (``_cluster_centers``, ``_kmax_transformer_layers``,
``_class_embedding_projection``, ``_mask_embedding_projection``,
``_predictor``, ``_auxiliary_semantic_predictor``). With ``aux_semantic``
the decoder owns the auxiliary semantic head, which runs in ``train()``
only and adds ``aux_semantic_pred`` (B, T, H4, W4, K+1) to the outputs.

At ``num_frames`` 1 (the image kMaX-DeepLab) nothing is folded and, as in
the JAX decoder, the outputs keep the image layout (B, H, W, ...) with no
T axis and carry no ``pred_mask_embeddings`` or ``cluster_centers``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..layers.convbn import ConvBN
from ..layers.kmax_layers import (KMaXPredictor, KMaXTransformerLayer,
                                  SemanticPredictor)
from ..ops.resize import resize_bilinear


def _fold_time(x, num_frames: int):
    """(B*T, H, W, C) -> (B, T*H, W, C)."""
    bt, h, w, c = x.shape
    return x.reshape(bt // num_frames, num_frames * h, w, c)


class KMaXTransformerDecoder(nn.Module):
    """Dual-path decoder over [OS32, OS16, OS8] pixel features."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 panoptic_channels: int, dec_layers: Sequence[int] = (2, 2, 2),
                 num_queries: int = 128, num_frames: int = 2,
                 drop_path_prob: float = 0.0, aux_semantic=None, device=None):
        """``aux_semantic``: None, or the (OS32, OS8, OS4) channels of the
        semantic head's inputs."""
        super().__init__()
        self.dec_layers = tuple(dec_layers)
        self.num_frames = num_frames
        self.num_queries = num_queries
        self._cluster_centers = nn.Embedding(256, num_queries, device=device)
        self._cluster_centers._inits = {"weight": ("trunc_normal", 1.0)}
        self._kmax_transformer_layers = nn.ModuleList([
            KMaXTransformerLayer(num_classes + 1, in_channels[i],
                                 drop_path_prob, device=device)
            for i, n in enumerate(self.dec_layers) for _ in range(n)])
        self._class_embedding_projection = ConvBN(
            256, 256, 1, bias=False, norm="syncbn", act="gelu",
            conv_type="1d", device=device)
        self._mask_embedding_projection = ConvBN(
            256, 256, 1, bias=False, norm="syncbn", act="gelu",
            conv_type="1d", device=device)
        self._predictor = KMaXPredictor(panoptic_channels, num_classes + 1,
                                        device=device)
        self._auxiliary_semantic_predictor = (
            None if aux_semantic is None
            else SemanticPredictor(*aux_semantic, num_classes + 1,
                                   device=device))

    def forward(self, multi_scale_features, panoptic_features,
                semantic_features=None, dtype=None, generator=None):
        t = self.num_frames
        b = multi_scale_features[0].shape[0] // t
        query = self._cluster_centers.weight.t()[None].expand(
            b, self.num_queries, 256).to(dtype or torch.float32)

        preds = []
        layers = iter(self._kmax_transformer_layers)
        for i, feat in enumerate(multi_scale_features):
            feat = _fold_time(feat, t)
            for _ in range(self.dec_layers[i]):
                query, pred = next(layers)(feat, query, generator)
                preds.append(pred)

        final = self._predictor(self._mask_embedding_projection(query),
                                self._class_embedding_projection(query),
                                _fold_time(panoptic_features, t))

        def unfold(x):  # (B, T*H, W, K) -> (B, T, H, W, K); none at T = 1
            return x if t == 1 else x.reshape(b, t, x.shape[1] // t,
                                              *x.shape[2:])

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
        out = {
            "pred_logits": final["class_logits"],
            "pred_masks": unfold(final["mask_logits"]),
            "pixel_feature": unfold(final["pixel_feature"]),
            "aux_outputs": aux_outputs,
        }
        if t > 1:  # per-clip outputs for the cross-clip matching
            out["pred_mask_embeddings"] = final["mask_embeddings"]  # (B, N, 128)
            out["cluster_centers"] = query  # (B, N, 256)
        if self._auxiliary_semantic_predictor is not None and self.training:
            sem = self._auxiliary_semantic_predictor(*semantic_features,
                                                     generator=generator)
            out["aux_semantic_pred"] = (sem if t == 1 else
                                        sem.reshape(b, t, *sem.shape[1:]))
        return out
