"""End-to-end learning check of the cross-clip (CC) stage: train only the CC
module on a frozen, already overfit within-clip (WC) segmenter until
whole-video VPQ on the training fixture reaches the target (the port of
the repo's ``tools/validate_overfit_cc.py``).

The reference's CC recipe (``maxtron_cc_model.py:104-108``): the segmenter
(``validate_overfit.py``'s, or the JAX WC tool's ``--save-params`` pickle,
read through ``utils/convert.py::wc_to_cc``)
runs frozen clip by clip, each clip's cluster centers are aligned to the
previous clip's by the device auction, and only the CC module trains: the
criterion's class and mask losses (weights 3.0 / 0.3 / 3.0, the auction
matcher) on one 8-frame video a step, AdamW at weight decay 0.05 on the CC
module alone, ``tf2_warmup_poly_lr(lr, steps, 0)``. Inference is the real
CC path: ``CCInferencePipeline`` (one forward of the whole video) through
``evaluate_vipseg``. The fixture, configuration, loader, JSON lines and
pass rule are ``validate_overfit.py``'s.

    python3 -m axial_vs_tpu_torch.tools.validate_overfit_cc \\
        [--wc-weights PATH] [--steps 300] [--eval-every 50] [--device cuda]

Without the ``--wc-weights`` file, ``validate_overfit.py`` runs first
(800 steps, an eval every 100) and writes it; if it misses its target,
this tool stops with its exit code.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import zipfile

import torch

from . import validate_overfit as wc_tool

#: the JAX CC tool's criterion weights and AdamW weight decay
LOSS_WEIGHTS = {"loss_ce": 3.0, "loss_mask": 0.3, "loss_dice": 3.0}
WEIGHT_DECAY = 0.05
VIDEO_FRAMES = 8  # one training video a step: 4 clips of 2 frames


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--target", type=float, default=0.9)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=None,
                    help="fixture, WC weights and eval dumps (default: a new "
                         "temporary directory)")
    ap.add_argument("--wc-weights", default=None, metavar="PATH",
                    help="the trained WC segmenter: its state_dict "
                         "(validate_overfit.py --save-weights) or the JAX "
                         "tool's pickle (tools/validate_overfit.py "
                         "--save-params); default OUT/wc_weights.pt, "
                         "trained first if absent")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ..engine.evaluator_loop import evaluate_vipseg
    from ..engine.lr_schedule import tf2_warmup_poly_lr
    from ..losses.criterion import SetCriterion
    from ..models.build import build_model_and_criterion
    from ..models.video_inference import CCInferencePipeline
    from ..utils.convert import load_into, wc_to_cc

    args = parse_args(argv)
    out = args.out or tempfile.mkdtemp(prefix="validate_overfit_cc_")
    wc_weights = args.wc_weights or os.path.join(out, "wc_weights.pt")
    if not os.path.exists(wc_weights):
        print(f"{wc_weights} missing: training the WC stage first "
              "(validate_overfit.py)", flush=True)
        rc = wc_tool.main(["--steps", "800", "--eval-every", "100",
                           "--out", out, "--save-weights", wc_weights,
                           "--device", args.device])
        if rc != 0:
            print("the WC stage missed its target; stopping", flush=True)
            return rc
    device = torch.device(args.device)
    name = wc_tool.fixture(out)
    cfg = wc_tool.overfit_config(name, out, VIDEO_FRAMES)
    cfg.model.meta_architecture = "MaXTronCCDeepLab"
    model, _ = build_model_and_criterion(
        cfg, train=True, device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    if zipfile.is_zipfile(wc_weights):
        wc = torch.load(wc_weights, map_location="cpu", weights_only=True)
    else:  # the JAX tool's --save-params pickle
        with open(wc_weights, "rb") as f:
            wc = pickle.load(f)
    load_into(model, wc_to_cc(wc, model.state_dict()))
    criterion = SetCriterion(wc_tool.NUM_CLASSES, weights=LOSS_WEIGHTS,
                             losses=("labels", "masks"), exact_matching=False)
    optimizer = torch.optim.AdamW(model.cc_module.parameters(), lr=1.0,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=WEIGHT_DECAY)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, tf2_warmup_poly_lr(args.lr, args.steps, 0))
    loader = wc_tool.fixture_loader(name, cfg, batch_size=1)
    curve, minutes = wc_tool.run_curve(
        model, criterion, optimizer, scheduler, loader,
        lambda: evaluate_vipseg(cfg, model, pipeline_cls=CCInferencePipeline),
        args.steps, args.eval_every, args.target, device)
    return wc_tool.report(
        "CC-stage overfit (frozen WC) train->infer->video VPQ", curve,
        args.target, minutes)


if __name__ == "__main__":
    sys.exit(main())
