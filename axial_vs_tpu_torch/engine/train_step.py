"""One training step (counterpart of ``axial_vs_tpu/engine/train_step.py``):
the forward in ``train()`` (BatchNorm on batch statistics, updating its
running statistics), the criterion (the set criterion of the kMaX models,
or the Tube-Link criterion of ``TubeLinkVIS``), the weighted total, the
backward, one optimizer update and one schedule step."""
from __future__ import annotations

import torch


def train_step(model, criterion, optimizer, scheduler, batch, generator,
               mark=None):
    """batch: {"images": (B*T, H, W, 3), "targets": {...}} (the targets of
    ``losses/criterion.py`` or ``models/tube_link/criterion.py``);
    ``generator`` draws the step's dropout, drop-path, Gumbel and point
    samples. Returns every loss and "total_loss" as
    Python floats, read from the device once. ``mark(name)``, if given, is
    called after each part of the step ("forward", "criterion",
    "backward", "optimizer"), e.g. to record a CUDA event there.

    A parameter of the optimizer that the loss does not reach gets a zero
    gradient, so that the update decays it as the JAX step does (its
    gradient there is zero). A frozen parameter (``requires_grad`` off:
    the cross-clip model's segmenter) is in no optimizer group, so it gets
    no gradient and no update."""
    mark = mark or (lambda name: None)
    model.train()
    optimizer.zero_grad(set_to_none=True)
    outputs = model(batch["images"], generator=generator)
    mark("forward")
    losses = criterion(outputs, batch["targets"], generator)
    total = criterion.weighted_total(losses)
    mark("criterion")
    total.backward()
    mark("backward")
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()
    scheduler.step()
    mark("optimizer")
    names = [*losses, "total_loss"]
    values = torch.stack([v.detach().float() for v in (*losses.values(), total)])
    return dict(zip(names, values.tolist()))
