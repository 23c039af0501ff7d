"""The ConvNeXt block's kernels: K1, K5 and K4.

- K1 ``dwconv7x7_layernorm``: fused 7x7 depthwise conv + LayerNorm, the
  counterpart of ``axial_vs_tpu/ops/convnext_pallas.py::dwconv7x7_layernorm``
  (CUDA kernel ``csrc/dwconv_ln.cu``).
- K5 ``convnext_mlp_residual``: the block's MLP tail with layer scale and
  residual, the counterpart of ``convnext_pallas.py::convnext_mlp_residual``
  (``csrc/convnext_mlp.cu``).
- K4 ``convnext_block_fused``: the whole block, the counterpart of
  ``convnext_pallas.py::convnext_block_fused`` (``csrc/convnext_block.cu``).

Each ``*_plain`` function is its kernel's plain PyTorch version, at the TPU
kernel's rounding points: f32 products of the working-dtype operands, f32
LayerNorm and tanh-form GELU, and casts to the working dtype where the kernel
casts. A wrapper takes the plain version for a tensor on the CPU only; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import native

#: the MLP kernels' limit on C (and C, the hidden width multiples of 16:
#: 32-byte rows for the tensor maps and whole 16-deep products)
MLP_MAX_C = 1536
#: the dtypes K1, K2 and K3 take on the card (K4 and K5 take bf16 only)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def dwconv7x7_layernorm_plain(x, weight, bias, ln_weight, ln_bias,
                              eps: float = 1e-6):
    """x (N, H, W, C); weight (C, 1, 7, 7); bias/ln_* (C,) -> (N, H, W, C)
    in x's dtype: f32 depthwise conv, f32 LayerNorm, one cast at the end."""
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), weight.float(), bias.float(),
                 padding=3, groups=c)
    y = F.layer_norm(y.permute(0, 2, 3, 1), (c,), ln_weight.float(),
                     ln_bias.float(), eps)
    return y.to(x.dtype)


def dwconv_taps(weight, dtype=None):
    """The depthwise weight (C, 1, 7, 7) tap-major: (7, 7, C), contiguous, in
    ``dtype`` (the weight's own by default), ``taps[dy, dx, c] ==
    weight[c, 0, dy, dx]``. K1 and K4 take their taps in this layout, so that
    a warp's tap loads are coalesced; the ConvNeXt block keeps this copy."""
    c = weight.shape[0]
    return weight.reshape(c, 49).t().reshape(7, 7, c).to(
        dtype or weight.dtype).contiguous()


def _card_taps(weight, taps, x):
    """``taps``, or ``dwconv_taps(weight)`` when None, on x's device in x's
    dtype: no-ops for the copy a block keeps."""
    if taps is None:
        taps = dwconv_taps(weight)
    return taps.to(device=x.device, dtype=x.dtype).contiguous()


def _check_channel_vectors(c, *vectors):
    for t in vectors:
        if t.shape != (c,):
            raise ValueError(f"per-channel parameter {tuple(t.shape)} != ({c},)")


def _check_dw_params(c, weight, taps, bias, ln_weight, ln_bias):
    if weight.shape != (c, 1, 7, 7):
        raise ValueError(f"weight {tuple(weight.shape)} != ({c}, 1, 7, 7)")
    if taps is not None and taps.shape != (7, 7, c):
        raise ValueError(f"taps {tuple(taps.shape)} != (7, 7, {c})")
    _check_channel_vectors(c, bias, ln_weight, ln_bias)


def dwconv7x7_layernorm(x, weight, bias, ln_weight, ln_bias, eps: float = 1e-6,
                        taps=None):
    """LayerNorm_C(dwconv7x7_same(x) + bias) * ln_weight + ln_bias.

    x (N, H, W, C) NHWC, bf16 or f32 on the card; weight (C, 1, 7, 7) in
    torch's depthwise layout; bias, ln_weight, ln_bias (C,). Returns (N, H,
    W, C) in x's dtype. On the card the kernel takes the weight tap-major:
    ``taps`` (``dwconv_taps(weight)``, as the ConvNeXt block keeps it), or,
    when None, a copy made here for this call."""
    n, h, w, c = x.shape
    _check_dw_params(c, weight, taps, bias, ln_weight, ln_bias)
    if native.on_cpu([x]):
        return dwconv7x7_layernorm_plain(x, weight, bias, ln_weight, ln_bias, eps)
    native.refuse_grad(x, weight, bias, ln_weight, ln_bias)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernel takes bf16 or f32 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    if c % 2 or c > 2048:
        raise ValueError(f"the CUDA kernel needs an even C <= 2048, got {c}")
    taps = _card_taps(weight, taps, x)
    # no-ops when the norms are kept f32
    bias, ln_weight, ln_bias = (
        t.to(device=x.device, dtype=torch.float32).contiguous()
        for t in (bias, ln_weight, ln_bias))
    out = torch.empty_like(x)
    name = "axvs_dwconv7x7_ln" + ("" if x.dtype == torch.bfloat16 else "_f32")
    native.launch(name, x.data_ptr(), taps.data_ptr(), bias.data_ptr(),
                  ln_weight.data_ptr(), ln_bias.data_ptr(), out.data_ptr(),
                  n, h, w, c, float(eps), device=x.device)
    dwconv7x7_layernorm.launches += 1
    return out


def _gelu_tanh_f32(h):
    """The TPU kernels' GELU: tanh form, in f32, whatever the input dtype."""
    return 0.5 * h * (1.0 + torch.tanh(0.7978845608028654
                                       * (h + 0.044715 * h * h * h)))


def convnext_mlp_residual_plain(x, shortcut, w1, b1, w2, b2, gamma):
    """Same contract as ``convnext_mlp_residual``: the weights cast to x's
    dtype, f32 products and sums, h cast to x's dtype before the second
    product, one cast at the end."""
    dt, c = x.dtype, x.shape[-1]
    xf = x.reshape(-1, c).float()
    h = _gelu_tanh_f32(xf @ w1.to(dt).float().T + b1.float())
    acc = b2.float() + h.to(dt).float() @ w2.to(dt).float().T
    out = shortcut.reshape(-1, c).float() + gamma.float() * acc
    return out.to(dt).reshape(x.shape)


def _mlp_operands(x, w1, b1, w2, b2, gamma):
    """Checks the MLP's shapes; on the card also the kernel's limits, and
    returns the weights as bf16 and the vectors as f32, contiguous."""
    c, hidden = x.shape[-1], w1.shape[0]
    if w1.shape != (hidden, c) or w2.shape != (c, hidden) or b1.shape != (hidden,):
        raise ValueError(f"fc1 {tuple(w1.shape)} / fc2 {tuple(w2.shape)} / b1 "
                         f"{tuple(b1.shape)} do not match C={c}")
    _check_channel_vectors(c, b2, gamma)
    if native.on_cpu([x]):
        return None
    if c % 16 or not 16 <= c <= MLP_MAX_C or hidden % 16:
        raise ValueError(f"the CUDA kernel takes C a multiple of 16 in [16, "
                         f"{MLP_MAX_C}] and a hidden width a multiple of 16; "
                         f"got C={c}, hidden={hidden}")
    # no-ops for matrices kept bf16 and vectors kept f32 at rest (inference)
    w1, w2 = (t.to(device=x.device, dtype=torch.bfloat16).contiguous()
              for t in (w1, w2))
    b1, b2, gamma = (t.to(device=x.device, dtype=torch.float32).contiguous()
                     for t in (b1, b2, gamma))
    return w1, b1, w2, b2, gamma


def _check_card_tensors(*tensors):
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16 activations, got {t.dtype}")
        if t.device != tensors[0].device or not t.is_contiguous():
            raise ValueError("activations must be contiguous and on one device")


def _check_aligned(*tensors):
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the CUDA kernel needs 16-byte aligned tensors")


def convnext_mlp_residual(x, shortcut, w1, b1, w2, b2, gamma):
    """shortcut + gamma * (gelu_tanh(x @ w1^T + b1) @ w2^T + b2).

    x, shortcut (..., C) bf16; w1 (hidden, C) and w2 (C, hidden): the
    ``mlp.fc1`` / ``mlp.fc2`` Linear weights in torch's (out, in) layout;
    b1 (hidden,), b2 and gamma (C,). Returns (..., C) in x's dtype. On the
    card the hidden activation goes through a (rows, hidden) bf16 workspace
    allocated here."""
    if shortcut.shape != x.shape:
        raise ValueError(f"shortcut {tuple(shortcut.shape)} != x "
                         f"{tuple(x.shape)}")
    ops = _mlp_operands(x, w1, b1, w2, b2, gamma)
    if ops is None:
        return convnext_mlp_residual_plain(x, shortcut, w1, b1, w2, b2, gamma)
    native.refuse_grad(x, shortcut, w1, b1, w2, b2, gamma)
    _check_card_tensors(x, shortcut)
    w1, b1, w2, b2, gamma = ops
    c = x.shape[-1]
    rows = x.numel() // c
    out = torch.empty_like(x)
    hidden = torch.empty(rows, w1.shape[0], dtype=x.dtype, device=x.device)
    _check_aligned(x, shortcut, w1, w2, out)
    native.launch("axvs_convnext_mlp", x.data_ptr(), shortcut.data_ptr(),
                  w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  gamma.data_ptr(), out.data_ptr(), hidden.data_ptr(), rows, c,
                  w1.shape[0], device=x.device)
    convnext_mlp_residual.launches += 1
    return out


def convnext_block_fused_plain(x, weight, bias, ln_weight, ln_bias,
                               w1, b1, w2, b2, gamma, eps: float = 1e-6):
    """Same contract as ``convnext_block_fused``: K1's plain version, then
    K5's, so the normalised tile is rounded to x's dtype in between, as the
    TPU kernel stores it in its bf16 scratch."""
    y = dwconv7x7_layernorm_plain(x, weight, bias, ln_weight, ln_bias, eps)
    return convnext_mlp_residual_plain(y, x, w1, b1, w2, b2, gamma)


def convnext_block_fused(x, weight, bias, ln_weight, ln_bias, w1, b1, w2, b2,
                         gamma, eps: float = 1e-6, taps=None):
    """The whole ConvNeXt block at inference:
    ``x + gamma * (gelu_tanh(LN(dwconv7x7(x) + bias) @ w1^T + b1) @ w2^T + b2)``.

    x (N, H, W, C) bf16 NHWC; weight (C, 1, 7, 7); bias, ln_weight, ln_bias,
    b2, gamma (C,); w1 (hidden, C), b1 (hidden,), w2 (C, hidden) in torch's
    layouts; ``taps`` as for ``dwconv7x7_layernorm``. Returns (N, H, W, C) in
    x's dtype. On the card the normalised tile and the hidden activation go
    through bf16 workspaces allocated here."""
    n, h, w, c = x.shape
    _check_dw_params(c, weight, taps, bias, ln_weight, ln_bias)
    ops = _mlp_operands(x, w1, b1, w2, b2, gamma)
    if ops is None:
        return convnext_block_fused_plain(x, weight, bias, ln_weight, ln_bias,
                                          w1, b1, w2, b2, gamma, eps)
    native.refuse_grad(x, weight, bias, ln_weight, ln_bias, w1, b1, w2, b2,
                       gamma)
    _check_card_tensors(x)
    w1, b1, w2, b2, gamma = ops
    taps = _card_taps(weight, taps, x)
    bias, ln_weight, ln_bias = (
        t.to(device=x.device, dtype=torch.float32).contiguous()
        for t in (bias, ln_weight, ln_bias))
    out, normed = torch.empty_like(x), torch.empty_like(x)
    hidden = torch.empty(n * h * w, w1.shape[0], dtype=x.dtype, device=x.device)
    _check_aligned(x, w1, w2, out)
    native.launch("axvs_convnext_block", x.data_ptr(), taps.data_ptr(),
                  bias.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(),
                  w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  gamma.data_ptr(), out.data_ptr(), normed.data_ptr(),
                  hidden.data_ptr(), n, h, w, c, w1.shape[0], float(eps),
                  device=x.device)
    convnext_block_fused.launches += 1
    return out


#: kernel launches since the count was last set to 0
dwconv7x7_layernorm.launches = 0
convnext_mlp_residual.launches = 0
convnext_block_fused.launches = 0
