"""Benchmark: MaXTron WC training steps on one card (the port of the repo's
``tools/bench_train.py``).

By default the model of ``configs/vipseg/maxtron_wc_r50.yaml`` (ResNet-50,
the within-clip module, 124 classes, f32) with exact matching; with
``--backbone convnext_large`` the reference's headline config,
``configs/vipseg/maxtron_wc_convnext_large.yaml`` (ConvNeXt-L, bf16 compute
on f32 master weights, drop path 0.4), with ``remat`` on as the JAX tool
sets it. ``--dtype`` overrides the yaml's dtype, ``--matching auction``
takes the device auction (the JAX tool's ``exact_matching=False``). Random
weights from a seed, at 713x713 crops, T = 2, one clip a step, with 24 GT
segments: labels, masks, ``valid`` and ``semantic_masks`` drawn from
``np.random.RandomState(0)`` as the JAX tool draws them, and its criterion
weights. Each step is the port's ``engine/train_step.py::train_step``: the
forward in train(), the set criterion, the backward (K2's and K3's through
their autograd Functions) and one AdamW update. ``--iters`` consecutive
steps after one warm-up step are timed with CUDA events. Prints one JSON
line: steps/s, the first (warm-up) and last total loss, the matching, the
dtype and the peak memory. With ``--profile`` one more step runs under
``torch.profiler`` and the line gains "profile": the step's parts in ms
(CUDA events between them), the device's busy time (the sum of its
kernels' times) and idle share, the device time of K2's and K3's kernels
and of their backward ranges, and the matching's range. With
``--with-loader`` the same number of steps then run on batches of the
port's VIPSeg clip mapper and loader (6 worker processes, copy-paste on)
over 4 synthetic 720x1280 videos of 6 frames, and the line gains the
loaded steps/s and the loader's overhead against the synthetic batch.

    python3 -m axial_vs_tpu_torch.tools.bench_train [--iters 5]
        [--size 713 713] [--backbone resnet50|convnext_large]
        [--dtype float32|bfloat16] [--matching exact|auction]
        [--with-loader] [--profile] [--device cuda]

``run(device="cpu", image_size=...)`` runs the same at a small size on the
CPU, timed on the host clock.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from ..config import load_config
from ..engine.lr_schedule import tf2_warmup_poly_lr
from ..engine.optim import build_optimizer
from ..engine.train_step import train_step
from ..losses.criterion import SetCriterion
from ..models.kmax import build_segmenter
from ..ops import hungarian, msda, traj

#: each backbone's yaml and the JAX tool's overrides
YAMLS = {"resnet50": ("vipseg/maxtron_wc_r50.yaml", []),
         "convnext_large": ("vipseg/maxtron_wc_convnext_large.yaml",
                            ["model.backbone.remat", True])}
YAML = YAMLS["resnet50"][0]
CLIP_FRAMES, CLIPS, GT_SEGMENTS = 2, 1, 24
#: the loader's videos: count, frames, size; its workers and prefetch
LOADER_VIDEOS, LOADER_FRAMES, LOADER_HW = 4, 6, (720, 1280)
LOADER_WORKERS, LOADER_PREFETCH = 6, 4
#: the JAX tool's criterion weights (``tools/bench_train.py:62-66``)
LOSS_WEIGHTS = {"loss_ce": 3.0, "loss_mask": 0.3, "loss_dice": 3.0,
                "loss_pixel_insdis": 1.0, "loss_aux_semantic": 1.0}


def train_config(image_size=(713, 713), backbone: str = "resnet50",
                 dtype: str | None = None):
    """``backbone``'s yaml (``YAMLS``) at ``image_size``, T = 2, in
    ``dtype`` (default the yaml's: f32 for R50, bf16 for ConvNeXt-L)."""
    yaml, extra = YAMLS[backbone]
    opts = ["input.image_size", list(image_size),
            "input.num_clip_frames", CLIP_FRAMES, *extra]
    if dtype is not None:
        opts += ["model.dtype", dtype]
    return load_config(yaml, opts)


def synthetic_batch(num_classes: int, image_size, device,
                    frames: int = CLIP_FRAMES):
    """The JAX tool's batch: targets then frames from RandomState(0); one
    clip of ``frames`` frames (a cross-clip video: 8)."""
    b, t, m = CLIPS, frames, GT_SEGMENTS
    h4, w4 = ((s + 3) // 4 for s in image_size)
    rs = np.random.RandomState(0)
    targets = {
        "labels": rs.randint(0, num_classes, (b, m)),
        "masks": (rs.rand(b, m, t, h4, w4) > 0.8).astype(np.float32),
        "valid": np.ones((b, m), bool),
        "semantic_masks": rs.randint(-1, num_classes, (b, t, h4, w4)),
    }
    images = rs.randn(b * t, *image_size, 3).astype(np.float32)
    return {"images": torch.from_numpy(images).to(device),
            "targets": {k: torch.from_numpy(v).to(device)
                        for k, v in targets.items()}}


def build(cfg, device, matching: str = "exact"):
    """(model, criterion, optimizer, scheduler) of the bench; ``matching``
    "exact" (scipy on the host) or "auction" (on the device)."""
    if matching not in ("exact", "auction"):
        raise ValueError(f"matching {matching!r}: exact or auction")
    model = build_segmenter(cfg, device,
                            torch.Generator(device=device).manual_seed(0),
                            num_frames=CLIP_FRAMES, train=True)
    criterion = SetCriterion(cfg.model.num_classes, weights=LOSS_WEIGHTS,
                             exact_matching=matching == "exact")
    optimizer, scheduler = build_optimizer(cfg, model, tf2_warmup_poly_lr(
        cfg.solver.base_lr, cfg.solver.max_iter))
    return model, criterion, optimizer, scheduler


def _device_us(event, self_only=False):
    """An event's device time in us (the attribute's name varies across
    torch versions)."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    return next(getattr(event, n) for n in names if hasattr(event, n))


def profile_step(parts, batch, gen) -> dict:
    """One ``train_step`` on the card under ``torch.profiler``: the parts'
    ms from CUDA events, the kernels' summed device time against the step,
    and K2's and K3's forward kernels and backward ranges."""
    marks = []

    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        mark("start")
        train_step(*parts, batch, gen, mark=mark)
        torch.cuda.synchronize()
    phases = {name: round(marks[i - 1][1].elapsed_time(ev), 4)
              for i, (name, ev) in enumerate(marks) if i}
    step_ms = marks[0][1].elapsed_time(marks[-1][1])
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_us(e, True) for e in kernels) / 1e3

    def kernel_ms(part):
        return round(sum(_device_us(e, True) for e in kernels
                         if part in e.key) / 1e3, 4)

    def range_ms(name):
        return round(sum(_device_us(e) for e in prof.events()
                         if e.name == name) / 1e3, 4)

    return {"phase_ms": phases, "step_ms": round(step_ms, 4),
            "device_busy_ms": round(busy, 4),
            "device_idle_share": round(1 - busy / step_ms, 4),
            "K2_forward_ms": kernel_ms("msda"),
            "K3_forward_ms": kernel_ms("traj_stage"),
            "K2_backward_ms": range_ms(msda.BACKWARD_RANGE),
            "K3_backward_ms": range_ms(traj.BACKWARD_RANGE),
            "matching_ms": range_ms(hungarian.MATCHING_RANGE),
            "note": "one step under the profiler, which slows the host"}


def _timed_steps(parts, batches, gen, iters: int, cuda: bool):
    """``iters`` steps on ``next(batches)``: their ms (CUDA events on the
    card, the host clock on the CPU) and the last total loss."""
    times, last = [], None
    for _ in range(iters):
        batch = next(batches)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            last = train_step(*parts, batch, gen)["total_loss"]
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            last = train_step(*parts, batch, gen)["total_loss"]
            times.append((time.perf_counter() - t0) * 1e3)
    return times, last


def loader_batches(cfg, image_size, device, root: str):
    """(loader, batches on ``device``): the port's VIPSeg clip mapper
    (copy-paste on) and loader over ``LOADER_VIDEOS`` synthetic videos
    written under ``root``, as the JAX tool's ``--with-loader`` sets them."""
    from ..data.loader import ClipDataLoader, device_prefetch, to_device
    from ..data.synthetic import write_vipseg_videos
    from ..data.vipseg import VIPSegClipMapper, load_vipseg_video_json

    paths, _ = write_vipseg_videos(root, (LOADER_FRAMES,) * LOADER_VIDEOS,
                                   LOADER_HW, splits=("train",))
    videos, _ = load_vipseg_video_json(paths[2], paths[0], paths[1])
    mapper = VIPSegClipMapper(
        image_size=image_size, num_frames=CLIP_FRAMES,
        max_instances=GT_SEGMENTS, copy_paste=True, seed=1,
        pixel_mean=cfg.input.pixel_mean, pixel_std=cfg.input.pixel_std)
    loader = ClipDataLoader(videos, mapper, batch_size=CLIPS,
                            num_workers=LOADER_WORKERS,
                            prefetch=LOADER_PREFETCH, seed=1,
                            pin_memory=device.type == "cuda")
    return loader, device_prefetch(iter(loader),
                                   lambda b: to_device(b, device))


def run(image_size=(713, 713), iters: int = 5, device: str = "cuda",
        profile: bool = False, backbone: str = "resnet50",
        dtype: str | None = None, matching: str = "exact",
        with_loader: bool = False) -> dict:
    """One warm-up step, then ``iters`` timed steps; returns the JSON
    line's fields."""
    dev = torch.device(device)
    cfg = train_config(image_size, backbone, dtype)
    parts = build(cfg, dev, matching)
    batch = synthetic_batch(cfg.model.num_classes, image_size, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    cuda = dev.type == "cuda"
    first = train_step(*parts, batch, gen)["total_loss"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    times, last = _timed_steps(parts, itertools.repeat(batch), gen, iters,
                               cuda)
    last = first if last is None else last
    out = {
        "metric": "VIPSeg WC training steps/sec/card "
                  f"({cfg.model.backbone.name}, {image_size[0]}x"
                  f"{image_size[1]}, T={CLIP_FRAMES}, {cfg.model.dtype})",
        "value": round(iters / (sum(times) / 1e3), 4) if times else None,
        "unit": "steps/sec",
        "ms_per_step_median": (round(statistics.median(times), 4)
                               if times else None),
        "ms_per_step_min": round(min(times), 4) if times else None,
        "ms_per_step_max": round(max(times), 4) if times else None,
        "loss_first": round(first, 4),
        "loss_last": round(last, 4),
        "backbone": cfg.model.backbone.name,
        "remat": bool(cfg.model.backbone.get("remat", False)),
        "matching": matching,
        "dtype": cfg.model.dtype,
        "peak_memory_gib": (round(torch.cuda.max_memory_allocated(dev)
                                  / 2 ** 30, 3) if cuda else None),
        "iters": iters, "image_size": list(image_size),
        "num_frames": CLIP_FRAMES, "gt_segments": GT_SEGMENTS,
        "timer": "cuda events" if cuda else "host clock",
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
    }
    if with_loader:
        with tempfile.TemporaryDirectory() as root:
            loader, batches = loader_batches(cfg, image_size, dev,
                                             os.path.join(root, "vipseg"))
            try:
                train_step(*parts, next(batches), gen)  # the workers start
                loaded, _ = _timed_steps(parts, batches, gen, iters, cuda)
            finally:
                batches.close()
                loader.close()
        out["loaded_steps_per_sec"] = round(iters / (sum(loaded) / 1e3), 4)
        out["loaded_ms_per_step_median"] = round(statistics.median(loaded), 4)
        out["loader_overhead_pct"] = round(
            (sum(loaded) - sum(times)) / sum(times) * 100.0, 1)
    if profile:
        if not cuda:
            raise ValueError("the profile reads the card's kernels")
        out["profile"] = profile_step(parts, batch, gen)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--size", type=int, nargs=2, default=(713, 713),
                    metavar=("H", "W"))
    ap.add_argument("--backbone", choices=sorted(YAMLS), default="resnet50")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                    help="default: the yaml's")
    ap.add_argument("--matching", choices=("exact", "auction"),
                    default="exact")
    ap.add_argument("--with-loader", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(run(tuple(a.size), a.iters, a.device,
                         profile=a.profile, backbone=a.backbone,
                         dtype=a.dtype, matching=a.matching,
                         with_loader=a.with_loader)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
