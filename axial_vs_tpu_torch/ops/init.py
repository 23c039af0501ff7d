"""Parameter initializers (counterpart of ``axial_vs_tpu/ops/init.py``).

Each parameter-owning module of the port records an init spec per
parameter; ``init_parameters`` fills the whole model from one explicit
``torch.Generator``, on the generator's device. Specs:

- ``("trunc_normal", std)``: N(0, 1) truncated to [-2, 2], times std (timm's
  ``trunc_normal_tf_``, no renormalisation);
- ``("he_normal", in_channels)``: trunc_normal with std sqrt(2 / in_channels);
- ``("xavier_uniform",)``: U(-a, a), a = sqrt(6 / (fan_in + fan_out)) over
  torch's (O, I, *k) layout;
- ``("normal", std)``; ``("uniform", bound)``: U(-bound, bound);
- ``("constant", value)``; ``("tensor", values)``: a fixed host array.
"""
from __future__ import annotations

import math

import torch

_SQRT2 = math.sqrt(2.0)


def _norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / _SQRT2))


@torch.no_grad()
def init_tensor_(t: torch.Tensor, spec, generator: torch.Generator):
    kind = spec[0]
    if kind in ("trunc_normal", "he_normal"):
        std = spec[1] if kind == "trunc_normal" else math.sqrt(2.0 / spec[1])
        # inverse-CDF sampling of the standard normal truncated to [-2, 2]
        lo, hi = _norm_cdf(-2.0), _norm_cdf(2.0)
        t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
        t.erfinv_().mul_(_SQRT2 * std).clamp_(-2.0 * std, 2.0 * std)
    elif kind == "xavier_uniform":
        receptive = math.prod(t.shape[2:]) if t.ndim > 2 else 1
        fan_in, fan_out = t.shape[1] * receptive, t.shape[0] * receptive
        a = math.sqrt(6.0 / (fan_in + fan_out))
        t.uniform_(-a, a, generator=generator)
    elif kind == "normal":
        t.normal_(0.0, spec[1], generator=generator)
    elif kind == "uniform":
        t.uniform_(-spec[1], spec[1], generator=generator)
    elif kind == "constant":
        t.fill_(spec[1])
    elif kind == "tensor":
        t.copy_(torch.as_tensor(spec[1], dtype=t.dtype).reshape(t.shape))
    else:
        raise ValueError(f"unknown init {spec!r}")


def init_parameters(model: torch.nn.Module, generator: torch.Generator):
    """Fill every parameter and buffer from its init spec
    (``module._inits[name]``), in module order. Raises if one has none."""
    done = set()
    for module in model.modules():
        for name, spec in getattr(module, "_inits", {}).items():
            t = getattr(module, name)
            init_tensor_(t, spec, generator)
            done.add(id(t))
    missing = [n for n, t in list(model.named_parameters())
               + list(model.named_buffers()) if id(t) not in done]
    if missing:
        raise RuntimeError(f"no init spec for {missing[:5]}")
    return model


def cast_for_inference(model: torch.nn.Module, dtype: torch.dtype):
    """Keep matrices and conv kernels (ndim >= 2) in ``dtype`` at rest, and
    vectors (biases, norm parameters, running stats) in f32, as the JAX
    bench does for bf16 inference."""
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2:
                p.data = p.data.to(dtype)
    return model
