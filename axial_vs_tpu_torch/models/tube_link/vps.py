"""Tube-Link video panoptic segmentation (VPS): the detector, its
window-streamed inference and its builder (counterpart of
``axial_vs_tpu/models/tube_link/vps.py`` and of the ``TubeLinkVPS`` entry
of ``axial_vs_tpu/models/build.py``).

The Mask2Former tube head runs ``num_thing_queries`` thing queries and one
fixed query slot per stuff class (slot ``num_thing_queries + k`` predicts
stuff class ``num_things_classes + k``, the "no-stuff-match" head). The
thing queries are linked to the previous window's by one attention block
(``ThingQueryLink``) and embedded for tracking (``TrackEmbedHead``).

At test time (``TubeLinkVPSInference``) each window of frames runs one
forward; each frame is fused into a panoptic map that names the query of
every thing segment (``fusion.py``); the window's thing queries are
matched against the tracker's memory by their embeddings
(``trackers/quasi_dense.py``), and each thing segment's id becomes
``class + (track_id + 1) * label_divisor``. The fusion and the tracker run
on the host, in numpy.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...layers.convbn import Linear
from ...ops.norm import LayerNorm
from ...trackers.quasi_dense import QuasiDenseEmbedTracker
from ..kmax import build_backbone, materialize
from .fusion import INSTANCE_OFFSET, panoptic_fusion
from .head import Mask2FormerVideoHeadTube, MaskedMultiheadAttention


TRACK_HEAD_HIDDEN = 1  # ReLU layers before ``fc_out``, as JAX's default


class TrackEmbedHead(nn.Module):
    """Query -> track embedding: ``TRACK_HEAD_HIDDEN`` ReLU layers then
    ``fc_out`` (QuasiDenseMaskEmbedHeadGTMask)."""

    def __init__(self, embed_dim: int = 256, device=None):
        super().__init__()
        for i in range(TRACK_HEAD_HIDDEN):
            setattr(self, f"fc{i}", Linear(embed_dim, embed_dim, device=device))
        self.fc_out = Linear(embed_dim, embed_dim, device=device)

    def forward(self, query):
        for i in range(TRACK_HEAD_HIDDEN):
            query = F.relu(getattr(self, f"fc{i}")(query))
        return self.fc_out(query)


class ThingQueryLink(nn.Module):
    """Attention of the current window's thing queries over themselves and
    the previous window's, then a ReLU FFN, each closed by a LayerNorm.
    ``pre_query=None`` attends over ``[cur, cur]``; a ``pre_query`` of
    length 0 over ``cur`` alone."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8, device=None):
        super().__init__()
        self.link_attn = MaskedMultiheadAttention(embed_dim, num_heads,
                                                  device=device)
        self.norm1 = LayerNorm(embed_dim, eps=1e-5, device=device)
        self.ffn1 = Linear(embed_dim, 4 * embed_dim, device=device)
        self.ffn2 = Linear(4 * embed_dim, embed_dim, device=device)
        self.norm2 = LayerNorm(embed_dim, eps=1e-5, device=device)

    def forward(self, cur_query, pre_query=None):
        if pre_query is None:
            pre_query = cur_query
        ctx = torch.cat([cur_query, pre_query.to(cur_query.dtype)], 1)
        x = self.norm1(cur_query + self.link_attn(cur_query, ctx, ctx))
        return self.norm2(x + self.ffn2(F.relu(self.ffn1(x))))


class TubeLinkVPS(nn.Module):
    """backbone + tube head + thing-query link + track head over a batch of
    windows of T frames. Queries ``[0, num_thing_queries)`` are things,
    the rest one slot per stuff class. ``mlp_only``: the track embeddings
    are the linked queries themselves (the 2-frame variant)."""

    def __init__(self, backbone, in_channels: dict,
                 num_things_classes: int = 19, num_stuff_classes: int = 0,
                 num_thing_queries: int = 100, num_frames: int = 2,
                 use_temporal_attn: bool = True, mlp_only: bool = False,
                 dtype=None, device=None):
        super().__init__()
        self.backbone = backbone
        self.num_thing_queries = num_thing_queries
        self.head = Mask2FormerVideoHeadTube(
            in_channels, num_things_classes, num_stuff_classes,
            num_queries=num_thing_queries + num_stuff_classes,
            num_frames=num_frames, use_temporal_attn=use_temporal_attn,
            device=device)
        c = self.head.query_feat.shape[-1]
        self.thing_link = ThingQueryLink(c, device=device)
        self.track_head = None if mlp_only else TrackEmbedHead(c,
                                                               device=device)
        self.dtype = dtype

    def _embed(self, query):
        return query if self.track_head is None else self.track_head(query)

    def forward(self, images, pre_thing_query=None, generator=None):
        """images (B*T, H, W, 3) -> the head's outputs with the final
        ``query`` and ``mask_features``, and "thing_query" (B, Q_th, C),
        the linked thing queries that the next window takes as
        ``pre_thing_query``; "thing_query_raw", the unlinked ones;
        "track_embeds" of the linked and "track_embeds_raw" of the unlinked
        queries. ``generator`` draws the backbone's drop-path masks (Swin)
        in ``train()``."""
        x = images if self.dtype is None else images.to(self.dtype)
        out = self.head(self.backbone(x, generator), return_query=True)
        thing_query = out["query"][:, :self.num_thing_queries]
        linked = self.thing_link(thing_query, pre_thing_query)
        out["thing_query"] = linked
        out["thing_query_raw"] = thing_query
        out["track_embeds"] = self._embed(linked)
        out["track_embeds_raw"] = self._embed(thing_query)
        return out


def stuff_fixed_assignment(num_thing_queries, num_stuff_classes,
                           num_things_classes):
    """The no-stuff-match rule: stuff class k (contiguous id num_things + k)
    is always predicted by query slot num_thing_queries + k."""
    slots = np.arange(num_stuff_classes) + num_thing_queries
    labels = np.arange(num_stuff_classes) + num_things_classes
    return slots, labels


class TubeLinkVPSInference:
    """Window-streamed VPS: a forward per window, per-frame panoptic fusion
    that keeps each thing segment's query (``panoptic_mode``), and the
    window's thing queries matched to the tracker's memory by their track
    embeddings, each frame's ids rewritten to ``class + (track_id + 1) *
    label_divisor`` (an untracked segment falls to instance 0; stuff ids are
    plain class ids, so they merge across windows). The linked thing
    queries carry from window to window."""

    def __init__(self, model: TubeLinkVPS, *, clip_len: int,
                 num_things_classes: int, num_stuff_classes: int,
                 label_divisor: int | None = None, score_thr: float = 0.3,
                 panoptic_mode: str = "with_query",
                 object_mask_thr: float | None = None, iou_thr: float = 0.8,
                 tracker_kwargs: dict | None = None):
        self.model = model
        self.clip_len = clip_len
        self.num_things = num_things_classes
        self.num_stuff = num_stuff_classes
        self.num_classes = num_things_classes + num_stuff_classes
        self.label_divisor = label_divisor or INSTANCE_OFFSET
        self.score_thr = score_thr
        self.panoptic_mode = panoptic_mode
        self.object_mask_thr = (
            object_mask_thr if object_mask_thr is not None
            else (0.3 if panoptic_mode == "sort_with_query" else 0.8))
        self.iou_thr = iou_thr
        self.tracker = QuasiDenseEmbedTracker(**(tracker_kwargs or {}))
        self._pre_thing_query = None

    def init_memory(self):
        self.tracker.reset()
        self._pre_thing_query = None

    def window_forward(self, images):
        """One window (T, H, W, 3), a tensor on the model's device ->
        last-layer class logits (Q, K+1), masks (T, Q, h, w) and the thing
        queries' track embeddings (Q_th, C) as f32 numpy arrays. The linked
        thing queries stay on the device for the next window; the first
        window links against an empty context."""
        pre = self._pre_thing_query
        if pre is None:
            query_feat = self.model.head.query_feat
            pre = query_feat.new_zeros((1, 0, query_feat.shape[-1]))
        with torch.inference_mode():
            out = self.model(images, pre_thing_query=pre)
        self._pre_thing_query = out["thing_query"]
        return tuple(x[0].float().cpu().numpy() for x in (
            out["cls_preds"][-1], out["mask_preds"][-1], out["track_embeds"]))

    def process_window(self, images, frame_id: int) -> np.ndarray:
        """images (T, H, W, 3) -> (T, h, w) int32 panoptic id maps: void =
        num_classes, stuff = class id, thing = class + (track_id + 1) *
        label_divisor (untracked -> instance 0)."""
        cls_logits, masks, embeds = self.window_forward(images)
        off = self.label_divisor
        n_thing_q = embeds.shape[0]

        pans, qlists = [], []
        for frame_masks in masks:
            pan, qlist = panoptic_fusion(
                self.panoptic_mode, cls_logits, frame_masks, self.num_things,
                self.num_classes, object_mask_thr=self.object_mask_thr,
                iou_thr=self.iou_thr)
            pans.append(pan)
            qlists.append(qlist)

        # the window's thing (query, pan_id) pairs; only thing slots carry
        # track embeddings
        pairs = sorted({(qi, pid) for ql in qlists for qi, pid in ql
                        if qi < n_thing_q})
        if not pairs:
            return np.stack(pans)
        clip_query_inds = np.asarray([p[0] for p in pairs], int)
        clip_pan_ids = np.asarray([p[1] for p in pairs], np.int64)
        clip_labels = (clip_pan_ids % off).astype(int)

        prob = torch.softmax(torch.from_numpy(cls_logits), -1).numpy()
        scores = prob[clip_query_inds, clip_labels]
        track_ids = self.tracker.match(
            embeds[clip_query_inds], clip_labels, scores, frame_id)

        for pan in pans:
            src = pan.copy()
            for idx, pid in enumerate(clip_pan_ids):
                tid = int(track_ids[idx])
                new_inst = tid + 1 if tid >= 0 else 0
                pan[src == pid] = clip_labels[idx] + new_inst * off
        return np.stack(pans)

    def process_window_instance(self, images, frame_id: int,
                                max_per_frame: int = 30,
                                score_thr: float | None = None):
        """VIS-style id carry across windows (the reference's
        ``match_instance``): the window's thing queries scoring above
        ``score_thr`` become each frame's instances, matched against the
        tracker's memory by their embeddings. Returns per frame
        ``{"labels", "scores", "masks" (K, h, w) bool, "track_ids"}``
        (track id -1: unmatched and not started)."""
        cls_logits, masks, embeds = self.window_forward(images)
        n_thing_q = embeds.shape[0]
        thr = self.score_thr if score_thr is None else score_thr

        prob = np.exp(cls_logits - cls_logits.max(-1, keepdims=True))
        prob /= prob.sum(-1, keepdims=True)
        thing_prob = prob[:n_thing_q, :self.num_things]  # (Q_th, K_th)
        scores = thing_prob.max(-1)
        labels = thing_prob.argmax(-1)
        keep = np.nonzero(scores > thr)[0][:max_per_frame]

        track_ids = (self.tracker.match(
            embeds[keep], labels[keep], scores[keep], frame_id)
            if len(keep) else np.zeros((0,), np.int64))
        return [dict(labels=labels[keep].astype(np.int64),
                     scores=scores[keep].astype(np.float32),
                     masks=frame_masks[keep] > 0,
                     track_ids=np.asarray(track_ids, np.int64))
                for frame_masks in masks]


def num_things_split(cfg) -> tuple[int, int]:
    """(things, stuff) of a panoptic config: ``model.num_things`` of
    ``model.num_classes``, all of them things where it is unset."""
    num_things = cfg.model.get("num_things") or cfg.model.num_classes
    return num_things, cfg.model.num_classes - num_things


def build_tube_link_vps(cfg, device=torch.device("cuda"),
                        generator: torch.Generator | None = None):
    """Build ``TubeLinkVPS`` from a config tree (``model.backbone``,
    ``model.num_classes`` and ``model.num_things``, ``model.tube_link``'s
    ``num_queries`` thing queries and ``use_temporal_attn``,
    ``model.dtype``, ``input.num_clip_frames`` frames a window; the head
    at its default widths, as the JAX registry builds it) on ``device``
    (the card unless the caller asks for another), every parameter drawn
    from ``generator`` (required, on ``device``)."""
    tl = cfg.model.tube_link
    dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else None
    num_things, num_stuff = num_things_split(cfg)
    meta = torch.device("meta")
    backbone, channels = build_backbone(cfg, device=meta)
    model = TubeLinkVPS(
        backbone, channels, num_things_classes=num_things,
        num_stuff_classes=num_stuff, num_thing_queries=tl.num_queries,
        num_frames=cfg.input.num_clip_frames,
        use_temporal_attn=tl.use_temporal_attn, dtype=dtype, device=meta)
    return materialize(model, device, generator, dtype)
