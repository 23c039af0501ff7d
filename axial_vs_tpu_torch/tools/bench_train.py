"""Benchmark: MaXTron WC training steps on one card (the port of the repo's
``tools/bench_train.py``).

The model of ``configs/vipseg/maxtron_wc_r50.yaml`` (ResNet-50, the
within-clip module, 124 classes, f32) with random weights from a seed, at
713x713 crops, T = 2, one clip a step, with 24 GT segments: labels, masks,
``valid`` and ``semantic_masks`` drawn from ``np.random.RandomState(0)`` as
the JAX tool draws them, and its criterion weights. Each step is the port's
``engine/train_step.py::train_step``: the forward in train(), the set
criterion with exact Hungarian matching on the host, the backward (K2's and
K3's through their autograd Functions) and one AdamW update. ``--iters``
consecutive steps after one warm-up step are timed with CUDA events. Prints
one JSON line: steps/s, the first (warm-up) and last total loss, the
matching, the dtype and the peak memory. With ``--profile`` one more step
runs under ``torch.profiler`` and the line gains "profile": the step's
parts in ms (CUDA events between them), the device's busy time (the sum of
its kernels' times) and idle share, and the device time of K2's and K3's
kernels and of their backward ranges.

    python3 -m axial_vs_tpu_torch.tools.bench_train [--iters 5]
        [--size 713 713] [--profile] [--device cuda]

``run(device="cpu", image_size=...)`` runs the same at a small size on the
CPU, timed on the host clock.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..config import load_config
from ..engine.lr_schedule import tf2_warmup_poly_lr
from ..engine.optim import build_optimizer
from ..engine.train_step import train_step
from ..losses.criterion import SetCriterion
from ..models.kmax import build_segmenter
from ..ops import msda, traj

YAML = "vipseg/maxtron_wc_r50.yaml"
CLIP_FRAMES, CLIPS, GT_SEGMENTS = 2, 1, 24
#: the JAX tool's criterion weights (``tools/bench_train.py:62-66``)
LOSS_WEIGHTS = {"loss_ce": 3.0, "loss_mask": 0.3, "loss_dice": 3.0,
                "loss_pixel_insdis": 1.0, "loss_aux_semantic": 1.0}


def train_config(image_size=(713, 713)):
    """The yaml's model at ``image_size``, T = 2, in f32 (the yaml's dtype,
    the default)."""
    return load_config(YAML, ["input.image_size", list(image_size),
                              "input.num_clip_frames", CLIP_FRAMES])


def synthetic_batch(num_classes: int, image_size, device):
    """The JAX tool's batch: targets then frames from RandomState(0)."""
    b, t, m = CLIPS, CLIP_FRAMES, GT_SEGMENTS
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


def build(cfg, device):
    """(model, criterion, optimizer, scheduler) of the bench."""
    model = build_segmenter(cfg, device,
                            torch.Generator(device=device).manual_seed(0),
                            num_frames=CLIP_FRAMES, train=True)
    criterion = SetCriterion(cfg.model.num_classes, weights=LOSS_WEIGHTS)
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
            "note": "one step under the profiler, which slows the host"}


def run(image_size=(713, 713), iters: int = 5, device: str = "cuda",
        profile: bool = False) -> dict:
    """One warm-up step, then ``iters`` timed steps; returns the JSON
    line's fields."""
    dev = torch.device(device)
    cfg = train_config(image_size)
    parts = build(cfg, dev)
    batch = synthetic_batch(cfg.model.num_classes, image_size, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    cuda = dev.type == "cuda"
    first = train_step(*parts, batch, gen)["total_loss"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    times, last = [], first
    for _ in range(iters):
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
    backbone = cfg.model.backbone.name
    out = {
        "metric": "VIPSeg WC training steps/sec/card "
                  f"({backbone}, {image_size[0]}x{image_size[1]}, "
                  f"T={CLIP_FRAMES}, {cfg.model.dtype})",
        "value": round(iters / (sum(times) / 1e3), 4),
        "unit": "steps/sec",
        "ms_per_step_median": round(statistics.median(times), 4),
        "ms_per_step_min": round(min(times), 4),
        "ms_per_step_max": round(max(times), 4),
        "loss_first": round(first, 4),
        "loss_last": round(last, 4),
        "matching": "exact",
        "dtype": cfg.model.dtype,
        "peak_memory_gib": (round(torch.cuda.max_memory_allocated(dev)
                                  / 2 ** 30, 3) if cuda else None),
        "iters": iters, "image_size": list(image_size),
        "num_frames": CLIP_FRAMES, "gt_segments": GT_SEGMENTS,
        "timer": "cuda events" if cuda else "host clock",
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
    }
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
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(run(tuple(a.size), a.iters, a.device,
                         profile=a.profile)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
