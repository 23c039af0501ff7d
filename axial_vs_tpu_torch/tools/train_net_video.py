"""Video training and evaluation CLI on one card (the port of the repo's
``tools/train_net_video.py``).

    python3 -m axial_vs_tpu_torch.tools.train_net_video \\
        --config-file configs/vipseg/maxtron_wc_r50.yaml \\
        [--resume] [--eval-only] [--format-only PATH] [--device cuda] \
        [--opts KEY VALUE ...]

The config is the port's (``config.load_config``: defaults, the yaml with
its ``_BASE_`` chain, then the ``--opts`` overrides). Datasets are the
port's builtin VIPSeg and YTVIS-format registrations (``data/builtin.py``,
under ``$AXIALVS_DATASETS``, default ``./datasets``). Training runs
``engine/trainer.py::Trainer``, its eval hook ``Trainer.evaluate`` on
``datasets.test[0]`` every ``test.eval_period`` steps (0 turns it off);
``--resume`` continues from the latest checkpoint of
``<output_dir>/checkpoints``. ``--eval-only`` evaluates after restoring the
checkpoint with ``--resume`` or ``model.weights``: a ``ytvis*`` or
``ovis*`` test set (or ``--format-only``) through ``evaluate_ytvis``, which
writes the YTVIS submission JSON to the ``--format-only`` path; a
``coco*``, ``ade20k*`` or ``cityscapes_fine*`` test set through
``evaluate_coco_panoptic`` (the image kMaX-DeepLab's PQ; it does not train
here yet: ``Trainer.train`` refuses its COCO mappers); any other through
``evaluate_vipseg``. A Tube-Link VIS config trains and evaluates (YTVIS
sets).
``--distributed`` raises: the port trains on one card.
"""
from __future__ import annotations

import argparse
import os

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--format-only", default=None, metavar="PATH",
                    help="with --eval-only: write the YTVIS submission JSON "
                         "to PATH (through evaluate_ytvis)")
    ap.add_argument("--distributed", action="store_true",
                    help="not supported: the port trains on one card")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    return ap.parse_args(argv)


def setup(args):
    """The port's config of ``--config-file`` (a path, or one under the
    repo's ``configs/``) with ``--opts``."""
    from ..config import load_config

    path = args.config_file
    return load_config(os.path.abspath(path) if os.path.exists(path)
                       else path, args.opts)


def main(argv=None, eval_kwargs=None):
    """Run the CLI; returns the evaluation results (``--eval-only``) or the
    ``Trainer`` after training. ``eval_kwargs`` are passed to the
    evaluation loop (e.g. ``max_videos``)."""
    args = parse_args(argv)
    if args.distributed:
        raise NotImplementedError("--distributed: the port trains on one "
                                  "card (no DDP)")
    cfg = setup(args)
    from ..data import builtin  # noqa: F401  (dataset registration)
    from ..engine.trainer import Trainer

    test_name = cfg.datasets.test[0] if cfg.datasets.test else None
    wants_eval = args.eval_only or cfg.test.eval_period > 0
    if wants_eval and test_name is None:
        raise ValueError("evaluation needs datasets.test (or set "
                         "test.eval_period 0)")
    trainer = Trainer(cfg, device=torch.device(args.device))
    kwargs = dict(eval_kwargs or {})
    if args.format_only:
        kwargs["format_only_path"] = args.format_only
    if args.eval_only:
        trainer.resume_or_load(resume=args.resume)
        results = trainer.evaluate(**kwargs)
        print(results)
        return results
    trainer.train(resume=args.resume,
                  eval_fn=(lambda: trainer.evaluate(**kwargs))
                  if wants_eval else None)
    return trainer


if __name__ == "__main__":
    main()
