"""Benchmark: MaXTron within-clip VIPSeg inference throughput on one card
(the port of the repo's ``bench.py``).

Builds ``bench.py``'s configuration from the port's own config (ConvNeXt-L
by default, or ``--backbone resnet50``; 124 VIPSeg classes, bf16, 2-frame
clips at 769x1345), with random weights drawn from a seed, and times
``--iters`` forwards of ``--batch-clips`` clips after two warm-up forwards,
each with CUDA events. Prints one JSON line: frames/s at the median clip
time (``value``), the median and the spread of the per-forward times, and
the shape of the run.

    python3 -m axial_vs_tpu_torch.tools.bench [--backbone convnext_large]
        [--size 769 1345] [--iters 20] [--batch-clips 1]
        [--block-kernel {dwln,mlp,block}] [--device cuda]

``run(device="cpu", ...)`` runs the same at a small size on the CPU, timed
on the host clock.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..config import load_config
from ..models.kmax import build_segmenter

CLIP_FRAMES = 2


def bench_config(backbone: str = "convnext_large", image_size=(769, 1345),
                 clip_frames: int = CLIP_FRAMES):
    """The configuration ``bench.py`` builds: the default config with its
    overrides (``bench.py:90-109``)."""
    over = ["model.backbone.name", backbone, "model.num_classes", 124,
            "model.dtype", "bfloat16", "input.image_size", list(image_size),
            "input.num_clip_frames", clip_frames,
            "model.maxtron.wc.enable", True]
    if backbone == "convnext_large":
        over += ["model.backbone.convnext.depths", [3, 3, 27, 3],
                 "model.backbone.convnext.dims", [192, 384, 768, 1536],
                 "model.backbone.convnext.drop_path_rate", 0.0,
                 "model.backbone.convnext.use_scan", True]
    return load_config(opts=over)


def run(backbone: str = "convnext_large", image_size=(769, 1345),
        iters: int = 20, batch_clips: int = 1, block_kernel: str = "dwln",
        device: str = "cuda") -> dict:
    """Time the clip forward; returns the JSON line's fields."""
    dev = torch.device(device)
    cfg = bench_config(backbone, image_size, CLIP_FRAMES)
    model = build_segmenter(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                            num_frames=CLIP_FRAMES, block_kernel=block_kernel)
    frames = batch_clips * CLIP_FRAMES
    images = torch.from_numpy(np.random.RandomState(0).randn(
        frames, *image_size, 3).astype(np.float32)).to(dev)
    cuda = dev.type == "cuda"
    times = []
    with torch.inference_mode():
        for _ in range(2):  # warm-up: library and allocator choices
            model(images)
        for _ in range(iters):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                model(images)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                model(images)
                times.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(times)
    batch = f", B={batch_clips} clips" if batch_clips > 1 else ""
    return {
        "metric": "VIPSeg within-clip inference frames/sec/card "
                  f"({backbone}, {image_size[0]}x{image_size[1]}, "
                  f"T={CLIP_FRAMES}{batch}, bf16, {block_kernel})",
        "value": round(frames / (median / 1e3), 4),
        "unit": "frames/sec",
        "ms_per_forward_median": round(median, 4),
        "ms_per_forward_min": round(min(times), 4),
        "ms_per_forward_max": round(max(times), 4),
        "iters": iters, "backbone": backbone, "image_size": list(image_size),
        "num_frames": CLIP_FRAMES, "batch_clips": batch_clips,
        "block_kernel": block_kernel, "dtype": cfg.model.dtype,
        "timer": "cuda events" if cuda else "host clock",
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backbone", default="convnext_large",
                    choices=("convnext_large", "resnet50"))
    ap.add_argument("--size", type=int, nargs=2, default=(769, 1345),
                    metavar=("H", "W"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch-clips", type=int, default=1)
    ap.add_argument("--block-kernel", default="dwln",
                    choices=("dwln", "mlp", "block"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.backbone, tuple(a.size), a.iters, a.batch_clips,
                         a.block_kernel, a.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
