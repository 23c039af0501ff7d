"""AdamW with the reference's per-parameter LR multipliers and weight-decay
rules (counterpart of ``axial_vs_tpu/engine/optim.py``; the reference's
``train_net_video.py:117-226``).

The JAX package matches its rules against flax paths; ``param_rules``
matches the same rules against the port's ``state_dict`` names, which
differ where a module owns a norm (``bn1``, ``downsample.1``,
``_in_norms.0``, ``input_proj.0.1``, ``stem.1``, the cross-clip module's
``conv_norms.{i}``, the Tube-Link pixel decoder's ``input_norms.{i}``) and
in the ConvNeXt layout (``stem``, ``stages.{i}.downsample``,
``stages.{i}.blocks.{j}``). ``tests/test_torch_train.py`` (the WC model),
``tests/test_torch_cc_train.py`` (the CC module) and
``tests/test_torch_tube_link_train.py`` (``TubeLinkVIS``) hold every
parameter's (lr_mult, wd) equal to JAX's for the same parameter.

Only parameters that require grad are optimized: a frozen module (the
segmenter of the cross-clip model) is in no group, so neither its
gradient nor weight decay moves it, as the JAX CC tool masks it out of
AdamW (``tools/validate_overfit_cc.py:155-165``).

The update is torch's AdamW, one parameter group per distinct (lr_mult,
wd): p -= lr * lr_mult * (m_hat / (sqrt(v_hat) + eps) + wd * p), with lr
from the schedule at the step (a ``LambdaLR`` over groups whose base LR is
their multiplier), after the optional global-norm gradient clip.
"""
from __future__ import annotations

import re
from typing import Callable

import torch

_HEAD_NAMES = ("class_embedding_projection", "mask_embedding_projection",
               "transformer_mask_head", "transformer_class_head",
               "pixel_space_mask_batch_norm")
#: port modules that are norms but whose name holds no "norm"
_NORM_OWNER = re.compile(
    r"(^|\.)(bn\d|layer\d\.\d+\.downsample\.1|(_in|input)_norms\.\d+|"
    r"(input|output)_proj\.\d+\.1|stem\.1|stages\.\d+\.downsample\.0|"
    r"conv_norms\.\d+)$")


def param_rules(cfg):
    """Returns name -> (lr_mult, weight_decay) for the port's ``state_dict``
    parameter names."""
    sol = cfg.solver
    base_wd = sol.weight_decay
    ld = sol.get("layer_decay", None)

    def rule(name: str):
        p = name.lower()
        lr_mult, wd = 1.0, base_wd
        if p.startswith("backbone."):
            lr_mult *= sol.backbone_multiplier
        if ld is not None and ld.enabled:
            lr_mult *= layer_decay_scale(p, ld.decay_rate, ld.num_layers,
                                         ld.decay_type)
        if "spatial_layer" in p or "level_embed_2d" in p:
            lr_mult *= sol.spatial_multiplier
        if "temporal_layers" in p or "level_embed_3d" in p:
            lr_mult *= sol.temporal_multiplier
        if any(k in p for k in _HEAD_NAMES):
            lr_mult *= sol.prediction_head_multiplier
        owner, _, leaf = p.rpartition(".")
        if "relative_position_bias_table" in p or "absolute_pos_embed" in p:
            wd = 0.0
        if "norm" in owner.rpartition(".")[2] or _NORM_OWNER.search(owner):
            wd = 0.0  # parameters of a BatchNorm, LayerNorm or GroupNorm
        if "_rpe" in p or "cluster_centers" in p or "level_embed" in p:
            wd = 0.0
        if leaf in ("bias", "gamma"):  # biases; ConvNeXt layer scale
            wd = 0.0
        return lr_mult, wd

    return rule


def convnext_layer_id(name: str, num_layers: int) -> int:
    """Layer id for ConvNeXt layer-wise LR decay (the reference's
    `mmdet/core/optimizers/layer_decay_optimizer_constructor.py:10-50`,
    get_layer_id_for_convnext) on the port's names: ``backbone.stem``,
    ``backbone.stages.{i}.downsample``, ``backbone.stages.{i}.blocks.{j}``.
    Ids run 0..num_layers + 1."""
    if not name.startswith("backbone."):
        return num_layers + 1
    tail = name[len("backbone."):]
    if tail.startswith("stem."):
        return 0
    m = re.match(r"stages\.(\d)\.(downsample|blocks\.(\d+))\.", tail)
    if not m:
        return num_layers + 1
    stage = int(m.group(1))
    if m.group(2) == "downsample":
        return {1: 2, 2: 3, 3: num_layers}[stage]
    if stage in (0, 1):
        return stage + 1
    return 3 + int(m.group(3)) // 3 if stage == 2 else num_layers


def convnext_stage_id(name: str, num_layers: int) -> int:
    """Stage id for 'stage_wise' decay (`...:53-77`)."""
    if not name.startswith("backbone."):
        return num_layers - 1
    tail = name[len("backbone."):]
    if tail.startswith("stem.") or re.match(r"stages\.\d\.downsample\.", tail):
        return 0
    m = re.match(r"stages\.(\d)\.", tail)
    return int(m.group(1)) + 1 if m else num_layers - 1


def layer_decay_scale(name: str, decay_rate: float, num_layers: int,
                      decay_type: str = "layer_wise") -> float:
    """LR scale decay_rate^(N - layer_id - 1), N = num_layers + 2
    (`layer_decay_optimizer_constructor.py:98,131`)."""
    n = num_layers + 2
    if decay_type == "stage_wise":
        layer_id = convnext_stage_id(name, n)
    else:
        layer_id = convnext_layer_id(name, num_layers)
    return decay_rate ** (n - layer_id - 1)


class AdamW(torch.optim.AdamW):
    """torch's AdamW, first clipping the gradients to a global norm of
    ``clip_norm`` (unless None) as the JAX chain's
    ``optax.clip_by_global_norm`` does: g * clip_norm / |g| where |g| is at
    least clip_norm."""

    def __init__(self, groups, clip_norm=None, **kwargs):
        super().__init__(groups, **kwargs)
        self.clip_norm = clip_norm

    @torch.no_grad()
    def step(self, closure=None):
        if self.clip_norm is not None:
            grads = [p.grad for g in self.param_groups for p in g["params"]
                     if p.grad is not None]
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                self.clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        return super().step(closure)


def build_optimizer(cfg, model: torch.nn.Module, lr_schedule: Callable):
    """(optimizer, scheduler) for ``model``'s parameters that require grad:
    an ``AdamW`` with one group per distinct (lr_mult, wd) of
    ``param_rules`` (each group keeps its ``lr_mult`` and parameter
    ``names``), and a ``LambdaLR`` that sets each group's LR to lr_mult x
    ``lr_schedule(step)``; call its ``step()`` after each optimizer step."""
    if cfg.solver.optimizer.lower() != "adamw":
        raise NotImplementedError(f"optimizer {cfg.solver.optimizer!r} is "
                                  "not ported")
    rule = param_rules(cfg)
    groups = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        group = groups.setdefault(rule(name), {"params": [], "names": []})
        group["params"].append(p)
        group["names"].append(name)
    param_groups = [{**g, "lr": lr_mult, "lr_mult": lr_mult,
                     "weight_decay": wd}
                    for (lr_mult, wd), g in groups.items()]
    clip = cfg.solver.clip_gradients
    optimizer = AdamW(param_groups, clip_norm=clip.clip_value if clip.enabled
                      else None, betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lr_schedule)
    return optimizer, scheduler
