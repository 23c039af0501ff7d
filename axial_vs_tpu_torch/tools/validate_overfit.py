"""End-to-end learning check of the within-clip (WC) training path: overfit
a 2-video synthetic VIPSeg fixture until VPQ on its own videos reaches the
target (the port of the repo's ``tools/validate_overfit.py``, its loop
``:168-429``).

The real loop runs: the VIPSeg clip mapper and a synchronous loader
(``num_workers=0``, one seeded draw order), ``train_step`` with the
auction matcher and AdamW on a poly schedule that decays to 0 within the
run, and every ``--eval-every`` steps the real inference path
(``evaluate_vipseg``: ``WCInferencePipeline``, the VIPSeg evaluator's
re-ID, VPQ). The fixture: 2 videos of 8 frames at 96x160, a thing (class
0) and a stuff (class 1), written by ``data/synthetic.py``. The model: R18
at 97x161, 2-frame clips, a WC module of 2 spatial and 2 temporal layers
of 64 channels in 8 heads of 8, 16 queries, one k-means layer a stage:
the JAX tool's, on every device (K3, the trajectory attention kernel, takes
heads of 8 on the card).

Pass rule: VPQ >= ``--target`` at the final eval; the run stops early only
after two evals in a row at the target. Each eval prints one JSON line, the
run a last one with the curve; the exit code is 0 iff it passed.
``--save-weights`` writes the trained segmenter's ``state_dict``, which
``validate_overfit_cc.py`` trains its cross-clip module on.

    python3 -m axial_vs_tpu_torch.tools.validate_overfit [--steps 800] \\
        [--eval-every 100] [--target 0.9] [--save-weights PATH] \\
        [--device cuda]

``--dissect`` (the JAX tool's stage-by-stage trace of video 0) and its
threshold-margin probe are not ported.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import zlib

import torch

#: the fixture: videos, frames each, frame size; its contiguous classes
#: (thing 0, stuff 1) and the label divisor of its metadata
FIXTURE_VIDEOS, FIXTURE_FRAMES, FIXTURE_HW = 2, 8, (96, 160)
NUM_CLASSES, LABEL_DIVISOR = 2, 1000
CLIP_FRAMES, IMAGE_SIZE, QUERIES = 2, (97, 161), 16
#: the JAX tool's WC heads (the plain trajectory attention takes any width)
WC_HEADS = 8


def fixture(out: str) -> str:
    """Write the fixture under ``out`` (once) and register it in the port's
    catalog; returns the dataset name."""
    from ..data.catalog import DatasetCatalog
    from ..data.synthetic import write_vipseg_videos
    from ..data.vipseg import register_vipseg_video, set_panoptic_metadata

    root = os.path.abspath(os.path.join(out, "fixture"))
    name = f"vipseg_overfit_fixture_{zlib.crc32(root.encode()):08x}"
    if name in DatasetCatalog:
        return name
    paths = (os.path.join(root, "imgs"), os.path.join(root, "panomasks"),
             os.path.join(root, "panoVIPSeg_val.json"))
    if not os.path.exists(paths[2]):
        write_vipseg_videos(root, (FIXTURE_FRAMES,) * FIXTURE_VIDEOS,
                            FIXTURE_HW, seed=0, thing=0, stuff=1,
                            num_classes=NUM_CLASSES, num_things=1)
    with open(paths[2]) as f:
        categories = json.load(f)["categories"]
    set_panoptic_metadata(register_vipseg_video(name, *paths), categories,
                          label_divisor=LABEL_DIVISOR)
    return name


def overfit_config(name: str, out: str, video_frames: int = CLIP_FRAMES):
    """The JAX tool's small WC configuration over the port's defaults, its
    eval on the fixture ``name``."""
    from ..config import get_default_config

    cfg = get_default_config()
    cfg.model.backbone.name = "resnet18"
    cfg.model.backbone.resnet.depth = 18
    cfg.model.num_classes = NUM_CLASSES
    cfg.input.image_size = list(IMAGE_SIZE)
    cfg.input.num_clip_frames = CLIP_FRAMES
    cfg.input.num_video_frames = video_frames
    wc = cfg.model.maxtron.wc
    wc.enable, wc.conv_dims, wc.dim_feedforward = True, 64, 128
    wc.nheads = WC_HEADS
    wc.spatial_layers = wc.temporal_layers = 2
    cfg.model.kmax.trans_dec.num_object_queries = QUERIES
    cfg.model.kmax.pixel_dec.dec_channels = [64, 48, 32, 16]
    cfg.model.kmax.trans_dec.dec_layers = [1, 1, 1]
    cfg.output_dir = out
    cfg.datasets.test = [name]
    return cfg


def fixture_loader(name: str, cfg, batch_size: int, scale=(1.0, 1.0)):
    """The synchronous seeded loader over the fixture's videos."""
    from ..data.catalog import DatasetCatalog
    from ..data.loader import ClipDataLoader
    from ..data.vipseg import VIPSegClipMapper

    mapper = VIPSegClipMapper(
        image_size=tuple(cfg.input.image_size),
        num_frames=cfg.input.num_video_frames,
        max_instances=cfg.model.kmax.trans_dec.num_object_queries,
        min_scale=scale[0], max_scale=scale[1], copy_paste=False, seed=0)
    return ClipDataLoader(DatasetCatalog.get(name), mapper,
                          batch_size=batch_size, num_workers=0, prefetch=2,
                          seed=0)


def run_curve(model, criterion, optimizer, scheduler, loader, evaluate,
              steps: int, eval_every: int, target: float, device):
    """Train ``steps`` steps, evaluating (``evaluate()`` -> the evaluator's
    results) every ``eval_every`` and at the last step; prints each eval's
    JSON line and stops after two evals in a row at ``target``. Returns the
    curve and the minutes it took."""
    from ..data.loader import to_device
    from ..engine.train_step import train_step

    gen = torch.Generator(device=device).manual_seed(0)
    curve, hits, t0 = [], 0, time.time()
    batches = iter(loader)
    try:
        for step in range(1, steps + 1):
            losses = train_step(model, criterion, optimizer, scheduler,
                                to_device(next(batches), device), gen)
            if step % eval_every and step != steps:
                continue
            model.eval()
            try:
                res = evaluate()
            finally:
                model.train()
            vpq, pw = float(res["vpq"]), res.get("per_window") or {}
            curve.append({
                "step": step, "loss": round(losses["total_loss"], 3),
                "vpq": round(vpq, 4),
                "things_pq": {k: round(v["things"]["pq"], 3)
                              for k, v in pw.items()},
                "stuff_pq": {k: round(v["stuff"]["pq"], 3)
                             for k, v in pw.items()},
                "loss_terms": {k: round(v, 3) for k, v in sorted(losses.items())
                               if k != "total_loss" and not k[-1].isdigit()}})
            print(json.dumps(curve[-1]), flush=True)
            hits = hits + 1 if vpq >= target else 0
            if hits >= 2:
                break
    finally:
        loader.close()
    return curve, (time.time() - t0) / 60.0


def report(metric: str, curve, target: float, minutes: float) -> int:
    """Print the run's last JSON line; 0 iff the final VPQ reached
    ``target``."""
    final = curve[-1]["vpq"] if curve else 0.0
    print(json.dumps({
        "metric": metric,
        "curve": [{k: c[k] for k in ("step", "loss", "vpq")} for c in curve],
        "final_vpq": final, "target": target, "minutes": round(minutes, 2),
        "passed": final >= target}), flush=True)
    return 0 if final >= target else 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--target", type=float, default=0.9)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--jitter", type=float, nargs=2, default=[1.0, 1.0],
                    metavar=("MIN", "MAX"),
                    help="train-time random-scale range (1.0 1.0 = off)")
    ap.add_argument("--head-mult", type=float, default=1.0,
                    help="solver.prediction_head_multiplier: the reference's "
                         "0.1 is tuned for fine-tuning; from scratch the mask "
                         "norm's gamma (the masks' softmax temperature) must "
                         "grow at the full lr to cross the 0.4 pixel "
                         "threshold within the run")
    ap.add_argument("--ce-weight", type=float, default=3.0,
                    help="loss_ce weight (the reference's 3.0)")
    ap.add_argument("--out", default=None,
                    help="fixture and eval dumps (default: a new temporary "
                         "directory)")
    ap.add_argument("--save-weights", default=None, metavar="PATH",
                    help="after the run, torch.save the trained segmenter's "
                         "state_dict to PATH (validate_overfit_cc.py reads it)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ..engine.evaluator_loop import evaluate_vipseg
    from ..engine.lr_schedule import tf2_warmup_poly_lr
    from ..engine.optim import build_optimizer
    from ..losses.criterion import SetCriterion
    from ..models.kmax import build_segmenter

    args = parse_args(argv)
    out = args.out or tempfile.mkdtemp(prefix="validate_overfit_")
    device = torch.device(args.device)
    name = fixture(out)
    cfg = overfit_config(name, out)
    cfg.solver.base_lr = args.lr
    cfg.solver.prediction_head_multiplier = args.head_mult
    # poly decay to 0 within the run: as the lr anneals the weights settle,
    # so the BatchNorm running statistics (momentum 0.01) catch up with them
    # and the eval-mode forward matches the train-mode one
    cfg.solver.warmup_iters = 0
    cfg.solver.max_iter = args.steps

    model = build_segmenter(cfg, device,
                            torch.Generator(device=device).manual_seed(0),
                            num_frames=CLIP_FRAMES, train=True)
    criterion = SetCriterion(
        NUM_CLASSES, weights={"loss_ce": args.ce_weight, "loss_mask": 0.3,
                              "loss_dice": 3.0, "loss_pixel_insdis": 1.0,
                              "loss_aux_semantic": 1.0},
        pixel_insdis_sample_k=256, aux_semantic_sample_k=256,
        exact_matching=False)
    optimizer, scheduler = build_optimizer(cfg, model, tf2_warmup_poly_lr(
        args.lr, args.steps, warmup_iters=0))
    loader = fixture_loader(name, cfg, batch_size=2, scale=args.jitter)
    curve, minutes = run_curve(
        model, criterion, optimizer, scheduler, loader,
        lambda: evaluate_vipseg(cfg, model), args.steps, args.eval_every,
        args.target, device)
    if args.save_weights:
        torch.save(model.state_dict(), args.save_weights)
        print(f"saved the trained segmenter's state_dict to "
              f"{args.save_weights}", flush=True)
    return report("overfit 2-video fixture train->infer->VPQ", curve,
                  args.target, minutes)


if __name__ == "__main__":
    sys.exit(main())
