"""Whole-dataset VIPSeg evaluation of a WC or a CC model (counterpart of
``axial_vs_tpu/engine/evaluator_loop.py::evaluate_vipseg``; the YTVIS and
COCO-panoptic loops are not ported yet)."""
from __future__ import annotations

import numpy as np
from PIL import Image

from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..data.panoptic_utils import rgb2id
from ..evaluation.stq import STQuality
from ..evaluation.vipseg_evaluator import VIPSegEvaluator
from ..models.video_inference import WCInferencePipeline


def _gt_video(video, ds_to_cont, thing_mask, divisor):
    """GT id maps of one video from its panoptic PNGs: cat * divisor +
    segment id for things, cat for stuff, -1 elsewhere (contiguous cats)."""
    gt_frames, gt_segments = [], {}
    for f in video["frames"]:
        pan = rgb2id(np.asarray(Image.open(f["pan_seg_file_name"]).convert("RGB")))
        out = np.full(pan.shape, -1, np.int64)
        for seg in f["segments_info"]:
            cat = ds_to_cont.get(seg["category_id"], None)
            if cat is None:
                continue
            gid = (cat * divisor + seg["id"]
                   if seg.get("isthing", thing_mask[cat]) else cat)
            out[pan == seg["id"]] = gid
            gt_segments[int(gid)] = {"category_id": int(cat),
                                     "iscrowd": int(seg.get("iscrowd", 0))}
        gt_frames.append(out)
    return np.stack(gt_frames), gt_segments


def _thing_mask(meta) -> np.ndarray:
    mask = np.zeros((len(meta.contiguous_to_dataset_id),), bool)
    for ci in meta.thing_dataset_id_to_contiguous_id.values():
        mask[ci] = True
    return mask


def wc_pipeline(cfg, model, name: str, pipeline_cls) -> WCInferencePipeline:
    """The video-wise pipeline ``evaluate_vipseg`` runs on the model's
    device (``pipeline_cls``: the WC pipeline or ``CCInferencePipeline``):
    the config's clip length, input size, normalisation and video test
    thresholds, and the classes of the dataset ``name``."""
    meta = MetadataCatalog.get(name)
    test = cfg.model.maxtron.test
    return pipeline_cls(
        model,
        num_clip_frames=cfg.input.num_clip_frames,
        input_size=cfg.input.image_size,
        pixel_mean=cfg.input.pixel_mean,
        pixel_std=cfg.input.pixel_std,
        thing_class_mask=_thing_mask(meta),
        contiguous_to_dataset_id=np.asarray(meta.contiguous_to_dataset_id),
        label_divisor=meta.label_divisor,
        pixel_confidence_threshold=test.pixel_confidence_threshold,
        class_threshold_thing=test.class_threshold_thing,
        class_threshold_stuff=test.class_threshold_stuff,
        overlap_threshold=test.overlap_threshold,
        reorder_class_weight=test.reorder_class_weight,
        reorder_mask_weight=test.reorder_mask_weight,
    )


def evaluate_vipseg(cfg, model, max_videos: int | None = None,
                    compute_stq: bool = False, pipeline_cls=None):
    """Video-wise inference over ``cfg.datasets.test[0]`` of the port's
    catalog, on the model's device, and its VPQ (the mean over windows
    {1, 2, 4, 6}) against the GT panoptic PNGs; with ``compute_stq`` also
    STQ. ``pipeline_cls`` picks the pipeline: ``WCInferencePipeline`` by
    default, ``CCInferencePipeline`` for a ``MaXTronCCModel``. Returns the
    evaluator's dict ({'vpq', 'per_window'}, plus 'stq')."""
    name = cfg.datasets.test[0]
    videos = DatasetCatalog.get(name)
    meta = MetadataCatalog.get(name)
    thing_mask = _thing_mask(meta)
    num_classes = len(thing_mask)
    divisor = meta.label_divisor
    test = cfg.model.maxtron.test

    pipeline = wc_pipeline(cfg, model, name,
                           pipeline_cls or WCInferencePipeline)
    evaluator = VIPSegEvaluator(
        categories={i: {"isthing": int(thing_mask[i])} for i in range(num_classes)},
        label_divisor=divisor, cost_limit=test.cost_limit,
        mem_weight=test.mem_weight, output_dir=cfg.output_dir)
    stq = STQuality(num_classes,
                    [ci for ci in range(num_classes) if thing_mask[ci]],
                    ignore_label=255) if compute_stq else None
    ds_to_cont = {ds: i for i, ds in enumerate(meta.contiguous_to_dataset_id)}
    max_ds = max(ds_to_cont) + 1
    ds_lookup = np.full((max_ds + 1,), 255, np.int64)
    for ds, ci in ds_to_cont.items():
        ds_lookup[ds] = ci

    def stq_encode(ids, cats_are_dataset):
        cat = np.where(ids >= divisor, ids // divisor, np.maximum(ids, 0))
        if cats_are_dataset:
            cat = ds_lookup[np.clip(cat, 0, max_ds)]
        sem = np.where(ids < 0, 255, cat)
        inst = np.where(ids >= divisor, ids % divisor, 0)
        return (sem.astype(np.int64) << stq.shift) + inst

    for video in videos[: max_videos or len(videos)]:
        frames = np.stack([np.asarray(Image.open(f["file_name"]).convert("RGB"))
                           for f in video["frames"]])
        pred_ids, _, _ = pipeline.run_video(frames)

        # prediction segments keyed by the dataset-encoded ids of
        # remap_panoptic_to_dataset_ids, categories mapped back to contiguous
        pred_segments = {}
        for sid in np.unique(pred_ids):
            if sid < 0:
                continue
            cat_ds = sid // divisor if sid >= divisor else sid
            pred_segments[int(sid)] = {
                "category_id": int(ds_to_cont.get(int(cat_ds), int(cat_ds)))}
        gt_ids, gt_segments = _gt_video(video, ds_to_cont, thing_mask, divisor)
        evaluator.process_video(
            video["video_id"], pred_ids, pred_segments, gt_ids, gt_segments,
            frame_names=[f["file_name"] for f in video["frames"]])
        if stq is not None:
            for gt_f, pr_f in zip(gt_ids, pred_ids):
                stq.update_state(stq_encode(gt_f, False), stq_encode(pr_f, True),
                                 sequence_id=video["video_id"])

    results = evaluator.evaluate()
    if stq is not None:
        results["stq"] = stq.result()
    return results
