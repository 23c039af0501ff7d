"""Whole-dataset evaluation loops (counterpart of
``axial_vs_tpu/engine/evaluator_loop.py``): ``evaluate_vipseg`` (VPQ and
STQ of a WC or a CC model), ``evaluate_ytvis`` (YTVIS AP/AR of a Tube-Link
VIS model, and its submission JSON) and ``evaluate_coco_panoptic`` (PQ of
the image kMaX-DeepLab on a COCO-format panoptic split)."""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..data.panoptic_utils import rgb2id
from ..evaluation.stq import STQuality
from ..evaluation.vipseg_evaluator import VIPSegEvaluator
from ..models.video_inference import WCInferencePipeline, _to_host


def _gt_image(record, ds_to_cont, thing_mask, divisor):
    """GT ids of one image or frame from its panoptic PNG: cat * divisor +
    segment id for things, cat for stuff, -1 elsewhere (contiguous cats);
    and its segments {id: {"category_id", "iscrowd"}}."""
    pan = rgb2id(np.asarray(Image.open(record["pan_seg_file_name"])
                            .convert("RGB")))
    out = np.full(pan.shape, -1, np.int64)
    segments = {}
    for seg in record["segments_info"]:
        cat = ds_to_cont.get(seg["category_id"], None)
        if cat is None:
            continue
        gid = (cat * divisor + seg["id"]
               if seg.get("isthing", thing_mask[cat]) else cat)
        out[pan == seg["id"]] = gid
        segments[int(gid)] = {"category_id": int(cat),
                              "iscrowd": int(seg.get("iscrowd", 0))}
    return out, segments


def _gt_video(video, ds_to_cont, thing_mask, divisor):
    """``_gt_image`` of each frame: the (V, H, W) ids and the segments of
    the whole video."""
    gt_frames, gt_segments = [], {}
    for f in video["frames"]:
        ids, segments = _gt_image(f, ds_to_cont, thing_mask, divisor)
        gt_frames.append(ids)
        gt_segments.update(segments)
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


def host_threads() -> int:
    """Threads for the host's resizes: the CPUs this process may run on."""
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


def upsample_instances(logits: np.ndarray, scaled_hw, out_hw) -> np.ndarray:
    """(k, V, h, w) OS4 mask logits of a padded input -> (k, V, H, W) bool
    masks at the video's size ``out_hw``: the region of the scaled frame
    cropped, a sigmoid, PIL's bilinear resize of each (instance, frame) on
    the host, as the JAX loop does (the reference interpolates before its
    fusion), then the submission's threshold, probability > 0.5, which the
    JAX loop takes in ``results_to_ytvis_json`` (the same masks). An
    instance a thread (PIL resizes without the GIL). The output is k V H W
    bytes: 0.99 GB for 30 instances over 36 frames of 720x1280 (the JAX
    loop keeps the f32 probabilities, 3.98 GB)."""
    k, v = logits.shape[:2]
    oh, ow = out_hw
    h4, w4 = (scaled_hw[0] + 3) // 4, (scaled_hw[1] + 3) // 4
    probs = 1.0 / (1.0 + np.exp(-logits))
    masks = np.zeros((k, v, oh, ow), bool)

    def instance(ki):
        for fi in range(v):
            np.greater(np.asarray(Image.fromarray(probs[ki, fi][:h4, :w4])
                                  .resize((ow, oh), Image.BILINEAR)),
                       0.5, out=masks[ki, fi])

    with ThreadPoolExecutor(max(1, min(k, host_threads()))) as pool:
        list(pool.map(instance, range(k)))
    return masks


def evaluate_ytvis(cfg, model, max_videos: int | None = None,
                   format_only_path: str | None = None):
    """Whole-video VIS evaluation of a ``TubeLinkVIS`` ``model`` over
    ``cfg.datasets.test[0]`` of the port's catalog (registered by
    ``data/ytvis.py::register_ytvis``), on the model's device: per video
    the frames decoded and preprocessed, ``TubeLinkVISInference.run_video``
    (tubes of ``model.tube_link.clip_len``, top ``test_topk``), the
    instances upsampled to the video's size and thresholded
    (``upsample_instances``), their labels mapped to dataset ids and
    written by ``results_to_ytvis_json`` (video by video, so that one
    video's masks are held at a time: the JAX loop holds every video's
    probabilities). With ``format_only_path`` the
    submission JSON goes there. Where the split has annotations, the YTVIS
    devkit's AP/AR (``YTVISEvaluator``). Returns {"num_videos",
    "num_predictions"[, "results_json"], AP/AR fields}."""
    from ..data.ytvis import results_to_ytvis_json
    from ..evaluation.ytvis_eval import YTVISEvaluator
    from ..models.tube_link.detector import TubeLinkVIS, TubeLinkVISInference
    from ..models.video_inference import preprocess_frames

    if not isinstance(model, TubeLinkVIS):
        raise NotImplementedError(
            f"evaluate_ytvis runs a TubeLinkVIS model, not "
            f"{type(model).__name__}")
    name = cfg.datasets.test[0]
    videos = DatasetCatalog.get(name)[:max_videos]
    cont_to_ds = list(MetadataCatalog.get(name).get(
        "contiguous_to_dataset_id", []))
    tl = cfg.model.tube_link
    pipeline = TubeLinkVISInference(model, clip_len=tl.clip_len,
                                    overlap=tl.overlap, topk=tl.test_topk)
    device = next(model.parameters()).device

    preds, gt_records = [], []
    for video in videos:
        frames = np.stack([np.asarray(Image.open(p).convert("RGB"))
                           for p in video["file_names"]])
        images, scaled_h, scaled_w = preprocess_frames(
            frames, cfg.input.pixel_mean, cfg.input.pixel_std,
            cfg.input.image_size)
        result = pipeline.run_video(torch.from_numpy(images).to(device))
        up = upsample_instances(result["masks"], (scaled_h, scaled_w),
                                (video["height"], video["width"]))
        labels = (np.asarray([cont_to_ds[int(c)] for c in result["labels"]])
                  if cont_to_ds else result["labels"])
        preds += results_to_ytvis_json([(video["video_id"], dict(
            masks=up, labels=labels, scores=result["scores"]))])
        del up
        for ann in video.get("annotations", []):
            gt_records.append(dict(
                video_id=video["video_id"], category_id=ann["category_id"],
                segmentations=ann.get("segmentations"),
                areas=ann.get("areas"), iscrowd=ann.get("iscrowd", 0)))

    out = {"num_videos": len(videos), "num_predictions": len(preds)}
    if format_only_path:
        with open(format_only_path, "w") as f:
            json.dump(preds, f)
        out["results_json"] = format_only_path
    if gt_records:
        out.update(YTVISEvaluator().evaluate(gt_records, preds))
    return out


def evaluate_coco_panoptic(cfg, model, max_images: int | None = None):
    """Image panoptic PQ of the image kMaX-DeepLab ``model`` over the
    COCO-format panoptic split ``cfg.datasets.test[0]`` of the port's
    catalog (COCO, ADE20k and Cityscapes share the format;
    ``data/coco.py::register_coco_panoptic``), on the model's device. Per
    image, as the JAX loop: the forward at the padded ``input.image_size``;
    the mask logits upsampled bilinearly to that size, cropped to the
    scaled image, upsampled to the original size (``align_corners`` where
    the padded width is odd); ``panoptic_inference`` with
    ``model.kmax.test``'s thresholds; the segments encoded as cat *
    label_divisor + segment id (things) or cat (stuff) and held against the
    GT PNG by PQ (``evaluation/pq.py``). The upsampled masks (128 x H x W
    f32: 0.84 GB at 1281x1281) stay on the device and are freed image by
    image. Returns {"all", "things", "stuff", "per_class"}."""
    from ..evaluation.pq import pq_compute
    from ..models.postprocess import panoptic_inference
    from ..models.video_inference import preprocess_frames
    from ..ops.resize import resize_bilinear

    name = cfg.datasets.test[0]
    records = DatasetCatalog.get(name)[:max_images]
    meta = MetadataCatalog.get(name)
    thing_mask = _thing_mask(meta)
    ds_to_cont = {ds: i for i, ds in enumerate(meta.contiguous_to_dataset_id)}
    divisor = meta.label_divisor
    test = cfg.model.kmax.test
    size = tuple(cfg.input.image_size)
    align_corners = size[1] % 2 == 1
    device = next(model.parameters()).device
    things = torch.from_numpy(thing_mask).to(device)

    images = []
    for rec in records:
        if "pan_seg_file_name" not in rec:
            raise ValueError(f"{name!r} has no panoptic PNGs: "
                             "evaluate_coco_panoptic scores panoptic splits")
        frame = np.asarray(Image.open(rec["file_name"]).convert("RGB"))
        oh, ow = frame.shape[:2]
        x, scaled_h, scaled_w = preprocess_frames(
            frame[None], cfg.input.pixel_mean, cfg.input.pixel_std, size)
        with torch.inference_mode():
            out = model(torch.from_numpy(x).to(device))
            logits, masks = out["pred_logits"][0], out["pred_masks"][0]
            del out
            masks = resize_bilinear(masks, size, align_corners=align_corners)
            masks = resize_bilinear(masks[:scaled_h, :scaled_w], (oh, ow),
                                    align_corners=align_corners)
            result = panoptic_inference(
                logits, masks, things,
                pixel_confidence_threshold=test.pixel_confidence_threshold,
                class_threshold_thing=test.class_threshold_thing,
                class_threshold_stuff=test.class_threshold_stuff,
                overlap_threshold=test.overlap_threshold,
                reorder_class_weight=test.reorder_class_weight,
                reorder_mask_weight=test.reorder_mask_weight)
            del masks
        result = _to_host(result)
        pan = result.panoptic_seg
        pred = np.full(pan.shape, -1, np.int64)
        pred_segments = {}
        for valid, sid, cat, isthing in zip(
                result.segment_valid, result.segment_id,
                result.segment_category, result.segment_isthing):
            if not valid:
                continue
            gid = int(cat) * divisor + int(sid) if isthing else int(cat)
            pred[pan == sid] = gid
            pred_segments[gid] = {"category_id": int(cat)}
        gt, gt_segments = _gt_image(rec, ds_to_cont, thing_mask, divisor)
        # void = 0 for the PQ core: every id moves up by one
        images.append((gt + 1, pred + 1,
                       {g + 1: v for g, v in gt_segments.items()},
                       {p + 1: v for p, v in pred_segments.items()}))
    return pq_compute(images, {i: {"isthing": int(t)}
                               for i, t in enumerate(thing_mask)})
