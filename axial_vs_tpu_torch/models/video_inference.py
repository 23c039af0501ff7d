"""Near-online (within-clip) video inference (counterpart of
``axial_vs_tpu/models/video_inference.py``'s ``preprocess_frames``,
``match_from_embds`` and ``WCInferencePipeline``).

1. host: aspect-preserving downscale (never upscale) and bottom/right zero
   pad of the normalized frames to the configured size, torch-exact bilinear
   in numpy;
2. the model's device: one forward per clip of T frames (the last clip
   repeats the video's last frame) -> class logits, mask logits at stride 4
   and per-slot mask embeddings;
3. host: video-wise stitching, a Hungarian alignment of consecutive clips'
   slots on the cosine cost of their mask embeddings, and logit averaging;
4. the model's device: the stitched mask logits upsampled to the padded
   size, cropped to the scaled region and resized to the original
   resolution, then ``panoptic_inference`` and the remap to dataset ids.

Only the embeddings, the per-slot results and the final id maps reach the
host. ``CCInferencePipeline`` runs the cross-clip model instead: one
forward of the whole video, whose alignment runs inside the model, then the
same finalize. ``extract_attention`` (needs ``return_attn``) is not ported
yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..ops.resize import resize_bilinear, resize_bilinear_np
from .postprocess import (PanopticOutput, panoptic_inference,
                          remap_panoptic_to_dataset_ids)


def preprocess_frames(frames, pixel_mean, pixel_std, target_size):
    """frames: (T, H, W, 3) uint8/float numpy. Returns (images (T, Ht, Wt, 3)
    float32, scaled_h, scaled_w)."""
    t, h, w, _ = frames.shape
    th, tw = target_size
    align_corners = tw % 2 == 1
    x = ((frames.astype(np.float32) - np.asarray(pixel_mean, np.float32))
         / np.asarray(pixel_std, np.float32))
    scale = min(th / h, tw / w)
    scaled_h, scaled_w = h, w
    if scale < 1:
        if tw / w <= th / h:
            scaled_w, scaled_h = tw, round(h * scale)
        else:
            scaled_h, scaled_w = th, round(w * scale)
        x = resize_bilinear_np(x, (scaled_h, scaled_w), align_corners=align_corners)
    out = np.zeros((t, th, tw, 3), np.float32)
    out[:, :scaled_h, :scaled_w] = x
    return out, scaled_h, scaled_w


def match_from_embds(tgt_embds: np.ndarray, cur_embds: np.ndarray) -> np.ndarray:
    """Permutation aligning the current clip's slots to the previous clip's,
    by cosine cost."""
    cur = cur_embds / np.linalg.norm(cur_embds, axis=1, keepdims=True)
    tgt = tgt_embds / np.linalg.norm(tgt_embds, axis=1, keepdims=True)
    cost = 1 - cur @ tgt.T  # (cur, tgt)
    _, col = linear_sum_assignment(cost.T)  # target x current
    return col


def _to_host(result: PanopticOutput) -> PanopticOutput:
    return PanopticOutput(*(t.cpu().numpy() for t in result))


class WCInferencePipeline:
    """Video-wise MaXTron WC inference: clips -> stitched whole-video
    panoptic ids, on the model's device."""

    def __init__(self, model, *, num_clip_frames, input_size, pixel_mean,
                 pixel_std, thing_class_mask, contiguous_to_dataset_id,
                 label_divisor=10000, pixel_confidence_threshold=0.3,
                 class_threshold_thing=0.2, class_threshold_stuff=0.3,
                 overlap_threshold=0.8, reorder_class_weight=1.0,
                 reorder_mask_weight=1.0, videowise_max_frames=16):
        self.model = model
        self.device = next(model.parameters()).device
        self.num_clip_frames = num_clip_frames
        self.input_size = tuple(input_size)
        self.pixel_mean = pixel_mean
        self.pixel_std = pixel_std
        self.thing_class_mask = torch.as_tensor(
            np.asarray(thing_class_mask, bool), device=self.device)
        self.cont2ds = torch.as_tensor(
            np.asarray(contiguous_to_dataset_id, np.int32), device=self.device)
        self.label_divisor = label_divisor
        # memory bound: longer videos run in windows of this many frames
        # with cross-window slot re-identification (the full-resolution
        # finalize holds several f32 copies of the (T, H, W, N) mask logits)
        self.videowise_max_frames = videowise_max_frames
        self.pp = dict(
            pixel_confidence_threshold=pixel_confidence_threshold,
            class_threshold_thing=class_threshold_thing,
            class_threshold_stuff=class_threshold_stuff,
            overlap_threshold=overlap_threshold,
            reorder_class_weight=reorder_class_weight,
            reorder_mask_weight=reorder_mask_weight,
        )

    @torch.inference_mode()
    def _clip_forward(self, images: np.ndarray):
        """(T, Ht, Wt, 3) host frames -> (logits (N, K+1), masks (T, h4, w4,
        N), embeddings (N, D)) on the device."""
        out = self.model(torch.from_numpy(images).to(self.device))
        return (out["pred_logits"][0], out["pred_masks"][0],
                out["pred_mask_embeddings"][0])

    @torch.inference_mode()
    def _finalize(self, mask_cls, masks, scaled_hw, orig_hw):
        """masks (T, h4, w4, N) stitched over the video -> (dataset ids
        (T, H', W') int32, PanopticOutput), on the device."""
        th, tw = self.input_size
        align_corners = tw % 2 == 1
        masks = resize_bilinear(masks, (th, tw), align_corners=align_corners)
        masks = masks[:, :scaled_hw[0], :scaled_hw[1]]
        if tuple(scaled_hw) != tuple(orig_hw):
            masks = resize_bilinear(masks, orig_hw, align_corners=align_corners)
        result = panoptic_inference(mask_cls, masks, self.thing_class_mask,
                                    **self.pp)
        ids, _ = remap_panoptic_to_dataset_ids(result, self.cont2ds,
                                               self.label_divisor)
        return ids, result

    def _clips(self, images: np.ndarray):
        v, t = images.shape[0], self.num_clip_frames
        for ci in range(math.ceil(v / t)):
            yield images[[min(ci * t + k, v - 1) for k in range(t)]]

    def run_video(self, frames: np.ndarray, orig_hw=None):
        """frames: (V, H, W, 3) uint8 numpy (a whole video, any length).

        Returns (panoptic_ids (V, H', W') int32 numpy, PanopticOutput of
        numpy arrays, per-slot embeddings numpy) with H', W' the original
        resolution. Videos longer than ``videowise_max_frames`` run in
        bounded windows with cross-window slot re-identification."""
        if frames.shape[0] > self.videowise_max_frames:
            return self._run_video_windowed(frames, orig_hw)
        v = frames.shape[0]
        orig_hw = tuple(orig_hw or (frames.shape[1], frames.shape[2]))
        images, scaled_h, scaled_w = preprocess_frames(
            frames, self.pixel_mean, self.pixel_std, self.input_size)
        # every clip is queued on the device before the first embedding is
        # copied back, so the host's matching overlaps the device's work
        outs = [self._clip_forward(clip) for clip in self._clips(images)]
        embds = [e.float().cpu().numpy() for _, _, e in outs]

        perms = [np.arange(embds[0].shape[0])]
        matched = [embds[0]]
        for e in embds[1:]:
            perm = match_from_embds(matched[-1], e)
            perms.append(perm)
            matched.append(e[perm])

        # the padded tube goes through panoptic inference whole (its
        # reorder and overlap statistics count the repeated tail frames),
        # and the id map is trimmed afterwards
        idx = [torch.as_tensor(p, device=self.device) for p in perms]
        stitched = torch.cat([m[..., i] for (_, m, _), i in zip(outs, idx)], 0)
        avg_logits = sum(l[i] for (l, _, _), i in zip(outs, idx)) / len(outs)
        ids, result = self._finalize(avg_logits, stitched, (scaled_h, scaled_w),
                                     orig_hw)
        return ids.cpu().numpy()[:v], _to_host(result), matched[0]

    def _run_video_windowed(self, frames: np.ndarray, orig_hw=None):
        """Whole-video inference in windows of ``videowise_max_frames``
        (rounded down to whole clips): each window runs the video-wise path,
        and thing identities carry across windows by aligning the windows'
        slot embeddings (``match_from_embds``); each canonical slot keeps one
        instance index per category. Stuff ids are category ids and merge by
        construction."""
        v = frames.shape[0]
        t = self.num_clip_frames
        w_len = max(t, self.videowise_max_frames - self.videowise_max_frames % t)
        orig_hw = orig_hw or (frames.shape[1], frames.shape[2])
        cont2ds = self.cont2ds.cpu().numpy()
        div = self.label_divisor
        registry: dict = {}   # (cat_ds, canonical slot) -> instance index
        next_inst: dict = {}  # cat_ds -> next instance index
        canon_embds = first_embds = last_result = None
        out_ids = []
        for start in range(0, v, w_len):
            ids, result, embds = self.run_video(frames[start:start + w_len],
                                                orig_hw)
            last_result = result
            n = embds.shape[0]
            if canon_embds is None:
                perm = np.arange(n)
                first_embds = embds
            else:
                perm = match_from_embds(canon_embds, embds)
            canon_embds = embds[perm]
            inv_perm = np.empty(n, int)
            inv_perm[perm] = np.arange(n)

            # window-local thing ids (cat * div + window instance) -> global
            id_map = {}
            win_inst: dict = {}
            for si in np.argsort(result.segment_id):  # acceptance order
                if not result.segment_valid[si] or not result.segment_isthing[si]:
                    continue
                cat_ds = int(cont2ds[int(result.segment_category[si])])
                w_idx = win_inst.get(cat_ds, 0)
                win_inst[cat_ds] = w_idx + 1
                key = (cat_ds, int(inv_perm[int(result.slot_index[si])]))
                if key not in registry:
                    registry[key] = next_inst.get(cat_ds, 0)
                    next_inst[cat_ds] = registry[key] + 1
                id_map[cat_ds * div + w_idx] = cat_ds * div + registry[key]
            if id_map:
                remapped = ids.copy()
                for s_id, d_id in id_map.items():
                    remapped[ids == s_id] = d_id
                ids = remapped
            out_ids.append(ids)
        return np.concatenate(out_ids, axis=0), last_result, first_embds

    def run_video_clipwise(self, frames: np.ndarray, orig_hw=None):
        """Clip-wise inference: each clip gets its own panoptic result, and
        the evaluator's re-identification
        (``evaluation/vipseg_evaluator.py::VIPSegEvaluator.stitch_clips``)
        recovers whole-video identities.

        Returns (clip ids, a list of (T, H', W') int32 numpy; clip
        embeddings, a list of {contiguous category: [normalized embedding
        of each accepted thing]})."""
        orig_hw = tuple(orig_hw or (frames.shape[1], frames.shape[2]))
        images, scaled_h, scaled_w = preprocess_frames(
            frames, self.pixel_mean, self.pixel_std, self.input_size)
        clip_ids, clip_embs = [], []
        for clip in self._clips(images):
            logits, masks, embds = self._clip_forward(clip)
            ids, result = self._finalize(logits, masks, (scaled_h, scaled_w),
                                         orig_hw)
            result = _to_host(result)
            embds = embds.float().cpu().numpy()
            embs_by_cat: dict = {}
            for ok, thing, cat, slot in zip(
                    result.segment_valid, result.segment_isthing,
                    result.segment_category, result.slot_index):
                if ok and thing:
                    e = embds[slot]
                    embs_by_cat.setdefault(int(cat), []).append(
                        e / max(np.linalg.norm(e), 1e-12))
            clip_ids.append(ids.cpu().numpy())
            clip_embs.append(embs_by_cat)
        return clip_ids, clip_embs


class CCInferencePipeline(WCInferencePipeline):
    """Whole-video inference through ``models/maxtron_cc.py::
    MaXTronCCModel``: the model runs the frozen segmenter clip by clip, the
    alignment of the clips' slots and the CC module; this pipeline
    preprocesses the frames, repeats the last frame up to a whole clip, runs
    one forward of the whole video (never in windows: the CC module reasons
    over all the clips at once, so ``videowise_max_frames`` does not apply)
    and the WC finalize, and trims the ids to the video's frames. The
    finalize holds the mask logits of every frame at the frame size, so
    the card's memory bounds the video's length."""

    @torch.inference_mode()
    def _video_forward(self, images: np.ndarray):
        """(T, Ht, Wt, 3) host frames, T a multiple of the clip length ->
        (class logits (N, K+1), mask logits (T, h4, w4, N)) on the device."""
        out = self.model(torch.from_numpy(images).to(self.device))
        return out["pred_logits"][0], out["pred_masks"][0]

    def run_video(self, frames: np.ndarray, orig_hw=None):
        """frames: (V, H, W, 3) uint8 numpy, a whole video. Returns
        (panoptic ids (V, H', W') int32 numpy, PanopticOutput of numpy
        arrays, None): the padded tube goes through panoptic inference
        whole, and the ids are trimmed afterwards."""
        v, t = frames.shape[0], self.num_clip_frames
        orig_hw = tuple(orig_hw or (frames.shape[1], frames.shape[2]))
        images, scaled_h, scaled_w = preprocess_frames(
            frames, self.pixel_mean, self.pixel_std, self.input_size)
        pad = (-v) % t
        if pad:
            images = np.concatenate([images] + [images[-1:]] * pad, 0)
        logits, masks = self._video_forward(images)
        ids, result = self._finalize(logits, masks, (scaled_h, scaled_w),
                                     orig_hw)
        return ids.cpu().numpy()[:v], _to_host(result), None
