"""Trainer: config -> model and criterion -> mapper and loader -> optimizer
and schedule -> loop, on one card (counterpart of
``axial_vs_tpu/engine/trainer.py``; no data-parallel mesh: one device, no
DDP).

Each step is ``engine/train_step.py::train_step``, its dropout, drop-path
and Gumbel draws from one explicit generator on the device, seeded from
``cfg.seed + 1`` and saved in every checkpoint. Checkpoints
(``engine/checkpoint.py``, under ``<output_dir>/checkpoints``) come every
``solver.checkpoint_period`` steps, at the end, and at a SIGTERM
(preemption: the loop saves and stops). The eval hook calls ``eval_fn``
every ``test.eval_period`` steps, switching to the intervals of
``test.dynamic_eval_intervals`` past their milestones, and at the end;
``Trainer.evaluate`` is the VIPSeg hook (``evaluate_vipseg``).

A resumed run restores the model (with its BatchNorm statistics), the
optimizer, the schedule, the generator and the step. With a synchronous
loader (``dataloader.num_workers`` 0) it also replays the data order, by
drawing and dropping the batches that the restored steps trained on, so
that a resumed run takes the steps of an uninterrupted one; worker loaders
deliver batches in arrival order and are not replayed.
"""
from __future__ import annotations

import bisect
import os
import pickle
import zipfile

import torch

from ..data.build import build_mapper
from ..data.catalog import DatasetCatalog
from ..data.loader import ClipDataLoader, device_prefetch, to_device
from ..models.build import build_model_and_criterion
from ..utils import convert
from .checkpoint import CheckpointManager
from .logger import MetricsLogger, setup_logger
from .lr_schedule import tf2_warmup_poly_lr
from .optim import build_optimizer
from .train_step import train_step

#: seconds a loader worker may take to deliver a batch before the loop raises
LOADER_TIMEOUT_S = 120.0


class Trainer:
    def __init__(self, cfg, device=torch.device("cuda")):
        self.cfg = cfg
        self.device = torch.device(device)
        self.logger = setup_logger(output_dir=cfg.output_dir)
        self.model, self.criterion = build_model_and_criterion(
            cfg, train=True, device=self.device,
            generator=torch.Generator(device=self.device).manual_seed(cfg.seed))

        datasets = []
        for name in cfg.datasets.train:
            datasets.extend(DatasetCatalog.get(name))
        self.dataset = datasets
        self.loader = ClipDataLoader(
            datasets, build_mapper(cfg, seed=cfg.dataloader.seed),
            batch_size=cfg.solver.ims_per_batch,
            num_workers=cfg.dataloader.num_workers,
            prefetch=cfg.dataloader.prefetch, seed=cfg.dataloader.seed,
            timeout=LOADER_TIMEOUT_S,
            pin_memory=self.device.type == "cuda") if datasets else None

        sol = cfg.solver
        self.optimizer, self.scheduler = build_optimizer(
            cfg, self.model, tf2_warmup_poly_lr(
                sol.base_lr, sol.max_iter, warmup_iters=sol.warmup_iters,
                power=sol.poly_power))
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.step = 0
        self.ckpt = CheckpointManager(os.path.join(cfg.output_dir,
                                                   "checkpoints"))
        self.metrics = MetricsLogger(cfg.output_dir)
        #: seconds the last ``train`` took to shut its loader down
        self.loader_close_s = None

    # -- state ---------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: dict):
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])

    def save(self):
        return self.ckpt.save(self.step, self.state_dict())

    def load_weights(self, path: str):
        """Initial weights: a checkpoint directory of this trainer (the
        model of its latest step), a ``torch.save`` file (a port
        ``state_dict``, or a checkpoint with one under "model"), or a
        pickle of a JAX parameter tree as numpy ({"params",
        "batch_stats"}, or the params alone: the JAX trainer's form),
        mapped through ``utils/convert.py``. Every key must match."""
        if os.path.isdir(path):
            state = CheckpointManager(path).restore()
            if state is None:
                raise FileNotFoundError(f"no checkpoint in {path}")
            self.model.load_state_dict(state["model"])
        elif zipfile.is_zipfile(path):
            state = torch.load(path, map_location="cpu", weights_only=True)
            self.model.load_state_dict(state.get("model", state))
        else:
            with open(path, "rb") as f:
                tree = pickle.load(f)
            if "params" not in tree:
                tree = {"params": tree}
            stats = tree.get("batch_stats") or {}
            sd = convert.convert_variables({"params": tree["params"],
                                            "batch_stats": stats})
            if not stats:  # params only: keep the model's statistics
                own = self.model.state_dict()
                sd.update({k: own[k].cpu().numpy() for k in own
                           if k not in sd})
            convert.load_into(self.model, sd)
        self.logger.info(f"loaded weights from {path}")

    def resume_or_load(self, resume: bool):
        """With ``resume`` and a checkpoint, restore the latest; otherwise
        load ``cfg.model.weights`` if set."""
        state = self.ckpt.restore() if resume else None
        if state is not None:
            self.load_state_dict(state)
            self.logger.info(f"resumed from step {self.step}")
        elif self.cfg.model.weights:
            self.load_weights(self.cfg.model.weights)

    # -- eval hook -------------------------------------------------------------
    def evaluate(self, **kwargs):
        """``evaluate_vipseg`` on ``cfg.datasets.test[0]`` with the model in
        eval mode; the model returns to train mode."""
        from .evaluator_loop import evaluate_vipseg

        self.model.eval()
        try:
            return evaluate_vipseg(self.cfg, self.model, **kwargs)
        finally:
            self.model.train()

    # -- loop ------------------------------------------------------------------
    def _batches(self, skip: int):
        if self.loader is None:
            raise RuntimeError(f"no training data: {self.cfg.datasets.train} "
                               "is not registered or empty")
        it = iter(self.loader)
        if self.loader.num_workers == 0:
            for _ in range(skip):  # replay the data order of the restored steps
                next(it)
        return device_prefetch(it, lambda b: to_device(b, self.device))

    def train(self, resume: bool = False, max_iter: int | None = None,
              eval_fn=None, dynamic_eval_intervals=None):
        """Train from the restored (or initial) step to ``max_iter`` (default
        ``solver.max_iter``). ``eval_fn()`` -> results is called at the eval
        hook's steps (module docstring); ``dynamic_eval_intervals``
        [(milestone, interval), ...] defaults to the config's. Returns the
        last step's losses."""
        self.resume_or_load(resume)
        cfg = self.cfg
        max_iter = max_iter or cfg.solver.max_iter
        if dynamic_eval_intervals is None:
            dynamic_eval_intervals = cfg.test.get("dynamic_eval_intervals",
                                                  None) or None
        milestones, intervals = [0], [cfg.test.eval_period]
        for m, iv in sorted(dynamic_eval_intervals or []):
            milestones.append(int(m))
            intervals.append(int(iv))
        losses = None
        self.ckpt.install_preemption_hook()
        batches = self._batches(self.step)
        try:
            for step in range(self.step, max_iter):
                batch = next(batches)
                losses = train_step(self.model, self.criterion, self.optimizer,
                                    self.scheduler, batch, self.generator)
                self.step = step + 1
                preempted = self.ckpt.preempted
                if self.step % self.metrics.log_every == 0 or preempted:
                    self.metrics.log(self.step, losses, self.logger)
                if (self.step % cfg.solver.checkpoint_period == 0
                        or self.step == max_iter or preempted):
                    self.save()
                period = intervals[bisect.bisect(milestones, self.step) - 1]
                if eval_fn is not None and (self.step % period == 0
                                            or self.step == max_iter):
                    self.logger.info(f"eval @ {self.step}: {eval_fn()}")
                if preempted:
                    self.logger.warning("preemption signal: checkpoint saved, "
                                        "exiting")
                    break
        finally:
            batches.close()
            self.loader_close_s = (self.loader.close() if self.loader
                                   else None)
            self.ckpt.remove_preemption_hook()
        return losses
