"""LR schedules (counterpart of ``axial_vs_tpu/engine/lr_schedule.py``):
functions of the optimizer step (0 for the first update) that give the
base learning rate, computed in f32 as the JAX schedules are (near the end
of a poly schedule 1 - step / max_iters loses digits in f32)."""
from __future__ import annotations

import numpy as np

_F = np.float32


def tf2_warmup_poly_lr(base_lr: float, max_iters: int, warmup_iters: int = 1000,
                       warmup_factor: float = 0.001, power: float = 0.9,
                       constant_ending: float = 0.0):
    """TF2/deeplab2 warmup poly LR (`train_net_utils.py:34-85`): linear
    warmup from ``warmup_factor`` to 1 over ``warmup_iters``, then
    (1 - step / max_iters)^power decay, with an optional constant ending."""

    def schedule(step: int) -> float:
        s = _F(step)
        alpha = np.clip(s / _F(max(warmup_iters, 1)), _F(0), _F(1))
        if step < warmup_iters:
            return float(_F(base_lr) * (_F(warmup_factor) * (1 - alpha)
                                         + alpha))
        poly = np.maximum(_F(1) - s / _F(max_iters), _F(0)) ** _F(power)
        if constant_ending > 0 and poly < constant_ending:
            return float(_F(base_lr) * _F(constant_ending))
        return float(_F(base_lr) * poly)

    return schedule


def step_lr(base_lr: float, milestones, gamma: float = 0.1,
            warmup_iters: int = 500, warmup_ratio: float = 0.001):
    """mmcv-style step LR with linear warmup (the Tube-Link schedules,
    `configs/video/_base_/schedules/mask2former_schedules_iter.py:1-32`)."""
    ms = sorted(milestones)

    def schedule(step: int) -> float:
        if step < warmup_iters:
            alpha = np.clip(_F(step) / _F(max(warmup_iters, 1)), _F(0), _F(1))
            return float(_F(base_lr) * (_F(warmup_ratio) * (1 - alpha)
                                         + alpha))
        return float(_F(base_lr) * _F(gamma) ** _F(sum(step >= m for m in ms)))

    return schedule
