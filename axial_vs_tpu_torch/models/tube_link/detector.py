"""Tube-Link video instance segmentation: the detector, its whole-video
inference and its builder (counterpart of
``axial_vs_tpu/models/tube_link/detector.py`` and of the ``TubeLinkVIS``
entry of ``axial_vs_tpu/models/build.py``).

Inference splits the video into tubes (``video_split``), runs one forward
per tube, matches queries across consecutive tubes by a Hungarian
assignment on their cosine similarity (scipy, on the host), averages the
matched class logits over the tubes, concatenates the tube masks and keeps
the top-k (query, class) pairs.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment
from torch import nn

from ..kmax import build_backbone, materialize
from .head import Mask2FormerVideoHeadTube


def video_split(num_frames: int, clip_len: int, overlap: int = 0):
    """Tube index lists covering the video: windows of ``clip_len``
    advancing by ``clip_len - overlap``; the last window is shifted back to
    end exactly at the last frame."""
    if clip_len <= overlap:
        raise ValueError(f"clip_len {clip_len} <= overlap {overlap}")
    step = clip_len - overlap
    tubes = []
    for s in range(0, max(num_frames - overlap, 1), step):
        e = s + clip_len
        if e > num_frames:
            s, e = max(num_frames - clip_len, 0), num_frames
        tubes.append(list(range(s, e)))
        if e >= num_frames:
            break
    return tubes


def match_query_embeds(tgt: np.ndarray, cur: np.ndarray) -> np.ndarray:
    """Hungarian assignment of ``cur``'s queries to ``tgt``'s on cosine
    similarity: ``cur[perm]`` lines up with ``tgt``."""
    cur_n = cur / np.maximum(np.linalg.norm(cur, axis=1, keepdims=True), 1e-12)
    tgt_n = tgt / np.maximum(np.linalg.norm(tgt, axis=1, keepdims=True), 1e-12)
    _, col = linear_sum_assignment((1 - cur_n @ tgt_n.T).T)
    return col


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


class TubeLinkVIS(nn.Module):
    """backbone + Mask2Former tube head over a batch of tubes of T frames."""

    def __init__(self, backbone, in_channels: dict,
                 num_things_classes: int = 40, num_queries: int = 100,
                 num_frames: int = 2, feat_channels: int = 256,
                 out_channels: int = 256, num_decoder_layers: int = 9,
                 num_heads: int = 8, ffn_dim: int = 2048,
                 use_temporal_attn: bool = True, dtype=None, device=None):
        super().__init__()
        self.backbone = backbone
        self.head = Mask2FormerVideoHeadTube(
            in_channels, num_things_classes, num_queries=num_queries,
            feat_channels=feat_channels, out_channels=out_channels,
            num_decoder_layers=num_decoder_layers, num_heads=num_heads,
            ffn_dim=ffn_dim, num_frames=num_frames,
            use_temporal_attn=use_temporal_attn, device=device)
        self.dtype = dtype

    def forward(self, images, return_query: bool = False, generator=None):
        """images (B*T, H, W, 3), B tubes of T frames -> {"cls_preds": [(B,
        Q, K+1)] per layer, "mask_preds": [(B, T, Q, H/4, W/4)], and with
        ``return_query`` "query" (B, Q, C) and "mask_features"}. In
        ``train()`` the backbone's BatchNorm uses the batch's statistics and
        updates its running ones. ``generator``, the training step's, draws
        the backbone's drop-path masks (Swin) in ``train()``."""
        x = images if self.dtype is None else images.to(self.dtype)
        return self.head(self.backbone(x, generator), return_query=return_query)


class TubeLinkVISInference:
    """Whole-video near-online inference: tubes -> linked instance masks."""

    def __init__(self, model: TubeLinkVIS, clip_len: int, overlap: int = 0,
                 topk: int = 30):
        self.model = model
        self.clip_len = clip_len
        self.overlap = overlap
        self.topk = topk

    def tube_forward(self, clip):
        """One tube -> last-layer class logits (Q, K+1), masks (T, Q, h, w)
        and queries (Q, C), as f32 numpy arrays."""
        with torch.inference_mode():
            out = self.model(clip, return_query=True)
        return tuple(x[0].float().cpu().numpy() for x in (
            out["cls_preds"][-1], out["mask_preds"][-1], out["query"]))

    def run_video(self, images):
        """images (V, H, W, 3) preprocessed frames (a tensor on the model's
        device). Returns {"masks" (k, V, h, w) logits, "labels" (k,),
        "scores" (k,)}, in descending score."""
        v = images.shape[0]
        tubes = video_split(v, self.clip_len, self.overlap)
        logits, masks, queries = zip(*(self.tube_forward(images[idx])
                                       for idx in tubes))

        perms = [np.arange(queries[0].shape[0])]
        ref_query = queries[0]
        for query in queries[1:]:
            perms.append(match_query_embeds(ref_query, query))
            ref_query = query[perms[-1]]

        # whole-video masks frame by frame (overlaps: the later tube wins)
        q, (h, w) = queries[0].shape[0], masks[0].shape[-2:]
        video_masks = np.zeros((v, q, h, w), np.float32)
        for idx, m, perm in zip(tubes, masks, perms):
            video_masks[idx] = m[:, perm]
        avg_logits = np.mean([lg[p] for lg, p in zip(logits, perms)], axis=0)

        probs = _softmax(avg_logits)[:, :-1]
        flat = probs.reshape(-1)
        k = min(self.topk, flat.size)
        top = np.argpartition(-flat, k - 1)[:k]
        top = top[np.argsort(-flat[top])]
        labels = top % probs.shape[1]
        slots = top // probs.shape[1]
        return {"masks": video_masks[:, slots].transpose(1, 0, 2, 3),
                "labels": labels.astype(np.int64), "scores": flat[top]}


def build_tube_link_vis(cfg, device=torch.device("cuda"),
                        generator: torch.Generator | None = None):
    """Build ``TubeLinkVIS`` from a config tree (the fields of
    ``config.get_default_config()``: ``model.backbone``,
    ``model.num_classes``, ``model.tube_link`` with ``use_temporal_attn``,
    ``model.dtype``, ``input.num_clip_frames``) on ``device`` (the card
    unless the caller asks for another), every parameter drawn from
    ``generator`` (required, on ``device``). In bf16 the matrices are kept
    bf16 at rest and the vectors f32."""
    tl = cfg.model.tube_link
    dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else None
    meta = torch.device("meta")
    backbone, channels = build_backbone(cfg, device=meta)
    model = TubeLinkVIS(
        backbone, channels, num_things_classes=cfg.model.num_classes,
        num_queries=tl.num_queries,
        num_frames=cfg.input.num_clip_frames,
        feat_channels=tl.feat_channels, out_channels=tl.out_channels,
        num_decoder_layers=tl.num_decoder_layers,
        use_temporal_attn=tl.use_temporal_attn, dtype=dtype, device=meta)
    return materialize(model, device, generator, dtype)
