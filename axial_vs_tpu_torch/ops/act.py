"""Activation helpers (counterpart of ``axial_vs_tpu/ops/act.py``).

GELU precision policy, as in the JAX package: the tanh form for bf16
activations, the exact erf otherwise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x):
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
