"""MaXTron cross-clip (CC) model: the frozen within-clip segmenter and the
cross-clip module (counterpart of ``axial_vs_tpu/models/maxtron_cc.py``).

The segmenter runs the video clip by clip, in ``eval()`` and without
gradients (the JAX package's ``stop_gradient``). It is frozen, as the
reference freezes it (``maxtron_cc_model.py:104-108``): its parameters do
not require grad, so it takes no gradient, and ``engine/optim.py`` puts
none of them in the optimizer, so no update or weight decay moves it; its
BatchNorm statistics stay as loaded, since it never leaves ``eval()``.
Each clip's cluster centers are aligned to the previous clip's slots by a
linear assignment on the cosine cost of their mask embeddings (the device
auction, as the JAX builder fixes it, in training and at inference), and
the CC module, the one part that trains, reasons over the aligned centers
of the whole video.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.hungarian import hungarian_assign
from .cc_module import CrossClipTrackingModule


def _cosine_cost(tgt, cur):
    """1 - cos between each current slot (rows) and each target slot, in the
    embeddings' dtype."""
    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)

    return 1.0 - unit(cur) @ unit(tgt).T


def align_clip_queries(embeddings, centers, exact: bool = True):
    """embeddings (T_clips, N, D), centers (T_clips, N, C): align each clip's
    slots in turn to the previous clip's matched slots (``hungarian_assign``
    on the cosine cost: scipy on the host if ``exact``, else the auction on
    the tensors' device). Returns (aligned centers (T, N, C), perms (T, N)
    int64)."""
    t, n, _ = embeddings.shape
    perms = [torch.arange(n, device=embeddings.device)]
    matched, aligned = embeddings[0], [centers[0]]
    valid = torch.ones(1, n, dtype=torch.bool, device=embeddings.device)
    for i in range(1, t):
        cost = _cosine_cost(matched, embeddings[i])  # (cur, tgt)
        perm = hungarian_assign(cost[None], valid, exact=exact)[0].clamp_min(0)
        perms.append(perm)
        matched = embeddings[i][perm]
        aligned.append(centers[i][perm])
    return torch.stack(aligned), torch.stack(perms)


class MaXTronCCModel(nn.Module):
    """images (T_video, H, W, 3), normalized and padded, T_video a multiple
    of ``num_clip_frames`` -> the CC outputs of the video.

    ``segmenter`` is a within-clip ``KMaXSegmenter`` of ``num_clip_frames``
    frames; it is frozen (``requires_grad`` off) and stays in ``eval()``
    whatever mode the model is put in. The clips are aligned by the
    auction, as the JAX package's builder fixes it."""

    def __init__(self, segmenter, cc_module: CrossClipTrackingModule,
                 num_clip_frames: int = 2):
        super().__init__()
        self.segmenter = segmenter
        self.cc_module = cc_module
        self.num_clip_frames = num_clip_frames
        self.segmenter.requires_grad_(False)
        self.segmenter.eval()

    def train(self, mode: bool = True):
        super().train(mode)
        self.segmenter.eval()
        return self

    @torch.no_grad()
    def clip_outputs(self, images):
        """The frozen segmenter on each clip: per-clip mask embeddings (T,
        N, 128), cluster centers (T, N, 256), pixel features (T, V, H, W,
        128), mask logits (T*V, H, W, N) and class logits (T, N, K+1)."""
        v = self.num_clip_frames
        if images.shape[0] % v:
            raise ValueError(f"{images.shape[0]} frames: pad the video to a "
                             f"multiple of {v}")
        keys = ("pred_mask_embeddings", "cluster_centers", "pixel_feature",
                "pred_masks", "pred_logits")
        outs = {k: [] for k in keys}
        for ci in range(images.shape[0] // v):
            out = self.segmenter(images[ci * v:(ci + 1) * v])
            for k in keys:
                outs[k].append(out[k][0])
        stacked = {k: torch.stack(x) for k, x in outs.items()}
        stacked["pred_masks"] = stacked["pred_masks"].flatten(0, 1)
        return stacked

    def forward(self, images, generator=None):
        """Returns {"pred_logits" (1, N, K+1), "pred_masks" (1, T_video, H/4,
        W/4, N), "aux_outputs", "clip_pred_logits" (T_clips, N, K+1),
        "clip_pred_masks" (T_video, H/4, W/4, N), "clip_perms" (T_clips,
        N)}."""
        clips = self.clip_outputs(images)
        aligned, perms = align_clip_queries(
            clips["pred_mask_embeddings"], clips["cluster_centers"],
            exact=False)
        pix = clips["pixel_feature"]
        t, v, h, w, c = pix.shape
        out = self.cc_module(aligned.transpose(0, 1)[None],
                             pix.reshape(t, v * h, w, c), generator)
        out["pred_masks"] = out["pred_masks"][None]
        out["aux_outputs"] = [{"pred_logits": a["pred_logits"],
                               "pred_masks": a["pred_masks"][None]}
                              for a in out["aux_outputs"]]
        out["clip_pred_logits"] = clips["pred_logits"]
        out["clip_pred_masks"] = clips["pred_masks"]
        out["clip_perms"] = perms
        return out
