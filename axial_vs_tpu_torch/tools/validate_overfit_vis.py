"""End-to-end learning check of the Tube-Link VIS training path: overfit a
2-video synthetic YouTube-VIS fixture until whole-video AP on its own
videos reaches the target (the port of the repo's
``tools/validate_overfit_vis.py``).

The real loop runs: the YTVIS clip mapper, called on each fixture video in
turn from one seeded ``RandomState`` (one clip a video a step, no loader
workers), ``train_step`` with ``TubeLinkCriterion`` (exact matching, 512
points) and AdamW (weight decay 0.05 on every parameter, no clip) on a
poly schedule that decays to 0 within the run; and every ``--eval-every``
steps the real inference path (``evaluate_ytvis``: ``TubeLinkVISInference``,
the cross-tube query matching, the YTVIS devkit's AP). The fixture: 2
videos of 8 frames at 96x160 with two instance classes, written by
``data/synthetic.py::write_ytvis_videos``. The model: R18, 8 queries, 64
channels, 3 decoder layers of 4 heads, 2-frame tubes; its pixel decoder
keeps 8 heads, so K3 (the trajectory attention kernel) runs at heads of 8
on the card.

Pass rule: AP >= ``--target`` at the final eval; the run stops early only
after two evals in a row at the target. Each eval prints one JSON line, the
run a last one with the curve; the exit code is 0 iff it passed.

    python3 -m axial_vs_tpu_torch.tools.validate_overfit_vis [--steps 800] \\
        [--eval-every 100] [--target 0.9] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

#: the fixture: videos, frames each, frame size
FIXTURE_VIDEOS, FIXTURE_FRAMES, FIXTURE_HW = 2, 8, (96, 160)
#: the JAX tool's model and loss: classes, tube frames, queries, channels,
#: decoder layers and heads, FFN width, sampled points
NUM_CLASSES, TUBE, QUERIES, CHANNELS = 2, 2, 8, 64
DECODER_LAYERS, DECODER_HEADS, FFN_DIM, POINTS = 3, 4, 256, 512


def fixture(out: str) -> str:
    """Write the fixture under ``out`` (once) and register it in the port's
    catalog; returns the dataset name."""
    from ..data.catalog import DatasetCatalog
    from ..data.synthetic import write_ytvis_videos
    from ..data.ytvis import register_ytvis

    root = os.path.abspath(os.path.join(out, "fixture"))
    name = f"ytvis_overfit_fixture_{zlib.crc32(root.encode()):08x}"
    if name not in DatasetCatalog:
        register_ytvis(name, *write_ytvis_videos(
            root, FIXTURE_VIDEOS, FIXTURE_FRAMES, FIXTURE_HW))
    return name


def overfit_config(name: str, out: str):
    """The JAX tool's configuration over the port's defaults, its eval on
    the fixture ``name``."""
    from ..config import get_default_config

    cfg = get_default_config()
    cfg.model.meta_architecture = "TubeLinkVIS"
    cfg.model.backbone.name = "resnet18"
    cfg.model.backbone.resnet.depth = 18
    cfg.model.num_classes = NUM_CLASSES
    cfg.input.image_size = list(FIXTURE_HW)
    cfg.input.num_clip_frames = cfg.input.num_video_frames = TUBE
    tl = cfg.model.tube_link
    tl.num_queries, tl.feat_channels, tl.out_channels = QUERIES, CHANNELS, CHANNELS
    tl.num_decoder_layers = DECODER_LAYERS
    tl.clip_len, tl.overlap, tl.test_topk = TUBE, 0, 2
    cfg.output_dir = out
    cfg.datasets.test = [name]
    return cfg


def build_model(cfg, device, generator):
    """The JAX tool's ``TubeLinkVIS`` (4 decoder heads, FFN 256) in train
    mode, its weights drawn from ``generator``."""
    from ..models.kmax import build_backbone, materialize
    from ..models.tube_link.detector import TubeLinkVIS

    meta = torch.device("meta")
    backbone, channels = build_backbone(cfg, device=meta)
    tl = cfg.model.tube_link
    model = TubeLinkVIS(
        backbone, channels, num_things_classes=cfg.model.num_classes,
        num_queries=tl.num_queries, num_frames=TUBE,
        feat_channels=tl.feat_channels, out_channels=tl.out_channels,
        num_decoder_layers=tl.num_decoder_layers, num_heads=DECODER_HEADS,
        ffn_dim=FFN_DIM, device=meta)
    return materialize(model, device, generator, None, train=True)


def batches(name: str):
    """Endless batches: one mapped clip of each fixture video, stacked as
    the loader stacks them (images (B*T, H, W, 3), targets (B, ...))."""
    from ..data.catalog import DatasetCatalog
    from ..data.ytvis import YTVISClipMapper

    videos = DatasetCatalog.get(name)
    mapper = YTVISClipMapper(
        image_size=FIXTURE_HW, num_frames=TUBE, frame_range=7,
        max_instances=4, min_scale=1.0, max_scale=1.0, seed=0,
        dataset_id_to_contiguous_id={1: 0, 2: 1})
    while True:
        samples = [mapper(v) for v in videos]
        targets = samples[0]["targets"]
        yield {"images": torch.from_numpy(np.concatenate(
                   [s["images"] for s in samples])),
               "targets": {k: torch.from_numpy(np.stack(
                   [s["targets"][k] for s in samples])) for k in targets}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--target", type=float, default=0.9)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=None,
                    help="fixture directory (default: a new temporary "
                         "directory)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ..data.loader import to_device
    from ..engine.evaluator_loop import evaluate_ytvis
    from ..engine.lr_schedule import tf2_warmup_poly_lr
    from ..engine.train_step import train_step
    from ..models.tube_link.criterion import TubeLinkCriterion

    args = parse_args(argv)
    out = args.out or tempfile.mkdtemp(prefix="validate_overfit_vis_")
    device = torch.device(args.device)
    name = fixture(out)
    cfg = overfit_config(name, out)
    model = build_model(cfg, device,
                        torch.Generator(device=device).manual_seed(0))
    criterion = TubeLinkCriterion(num_things=NUM_CLASSES, num_points=POINTS,
                                  match_points=POINTS)
    # poly decay to 0 within the run, so that the backbone's BatchNorm
    # running statistics settle on the final weights and the eval-mode
    # forward matches the train-mode one
    optimizer = torch.optim.AdamW(model.parameters(), lr=1.0,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.05)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, tf2_warmup_poly_lr(args.lr, args.steps, warmup_iters=0))
    gen = torch.Generator(device=device).manual_seed(0)
    data = batches(name)
    curve, hits, t0 = [], 0, time.time()
    for step in range(1, args.steps + 1):
        losses = train_step(model, criterion, optimizer, scheduler,
                            to_device(next(data), device), gen)
        if step % args.eval_every and step != args.steps:
            continue
        model.eval()
        try:
            res = evaluate_ytvis(cfg, model)
        finally:
            model.train()
        ap = float(res.get("AP", -1.0))
        curve.append({
            "step": step, "loss": round(losses["total_loss"], 3),
            "AP": round(ap, 4), "AP50": round(float(res.get("AP50", -1.0)), 4),
            "AP75": round(float(res.get("AP75", -1.0)), 4),
            "loss_terms": {k: round(v, 3) for k, v in sorted(losses.items())
                           if k != "total_loss" and not k.startswith("d")}})
        print(json.dumps(curve[-1]), flush=True)
        hits = hits + 1 if ap >= args.target else 0
        if hits >= 2:
            break
    final = curve[-1]["AP"] if curve else -1.0
    print(json.dumps({
        "metric": "Tube-Link VIS overfit 2-video fixture train->infer->AP",
        "curve": [{k: c[k] for k in ("step", "loss", "AP")} for c in curve],
        "final_ap": final, "target": args.target,
        "minutes": round((time.time() - t0) / 60.0, 2),
        "passed": final >= args.target}), flush=True)
    return 0 if final >= args.target else 1


if __name__ == "__main__":
    sys.exit(main())
