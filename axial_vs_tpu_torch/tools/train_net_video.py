"""Video training and evaluation CLI on one card (the port of the repo's
``tools/train_net_video.py``).

    python3 -m axial_vs_tpu_torch.tools.train_net_video \\
        --config-file configs/vipseg/maxtron_wc_r50.yaml \\
        [--resume] [--eval-only] [--device cuda] [--opts KEY VALUE ...]

The config is the port's (``config.load_config``: defaults, the yaml with
its ``_BASE_`` chain, then the ``--opts`` overrides). Datasets are the
port's builtin VIPSeg registrations (``data/builtin.py``, under
``$AXIALVS_DATASETS``, default ``./datasets``). Training runs
``engine/trainer.py::Trainer``, its eval hook ``evaluate_vipseg`` on
``datasets.test[0]`` every ``test.eval_period`` steps (0 turns it off);
``--resume`` continues from the latest checkpoint of
``<output_dir>/checkpoints``. ``--eval-only`` evaluates VIPSeg only (the
YTVIS and COCO evaluators are not ported and raise), after restoring the
checkpoint with ``--resume`` or ``model.weights``. ``--distributed`` raises:
the port trains on one card.
"""
from __future__ import annotations

import argparse
import os

import torch

#: test-dataset prefixes of evaluators the port does not have
_NOT_PORTED_EVAL = ("ytvis", "ovis", "coco", "ade20k", "cityscapes_fine")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--eval-only", action="store_true")
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
    ``Trainer`` after training. ``eval_kwargs`` are passed to
    ``evaluate_vipseg`` (e.g. ``max_videos``)."""
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
    if wants_eval and test_name.startswith(_NOT_PORTED_EVAL):
        raise NotImplementedError(f"the evaluator of {test_name!r} is not "
                                  "ported (VIPSeg only)")
    trainer = Trainer(cfg, device=torch.device(args.device))
    kwargs = dict(eval_kwargs or {})
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
