"""MSDA's table-then-gather-then-reduce pieces (kernels K6, K7, K8).

Counterparts of the three remaining Pallas kernels of
``axial_vs_tpu/ops/msda_pallas.py``, same names and contracts:

- ``weighted_corner_reduce_multi(gs, w)`` (K6): N gathered corner rows
  ``gs[s]`` (R, 4D) and sample-major slot weights ``w`` (R, 4N) to
  ``out[r, d] = fold_k sum_s bf16(g_s[r, k*D + d] * w[r, s*4 + k])``: each
  product rounded to the input dtype, then summed in f32.
- ``weighted_corner_reduce_v5(gs, w, p, slot_major=False)`` (K7): L arrays
  (R, P*4D) holding P samples side by side (sample ``si = l*P + p`` at lanes
  ``p*4D + k*D + d`` of array ``l``), the weights rounded to bf16 and the
  products taken in f32; column ``si*4 + k``, or ``k*N + si`` when
  ``slot_major``. With ``p=1`` it is ``weighted_corner_reduce_v4``.
- ``pack_corner_table(v, width, n_heads)`` (K8): one level's packed 2x2
  corner table, ``out[b, s, m*4D + k*D + d] = v[b, (s + off_k) mod S,
  m*D + d]`` with ``off = (0, 1, W, W+1)``, exactly the roll-based build
  (``pack_corner_table_ref``); the TPU kernel left junk in wrapped rows.

``fold_k`` is ``((a_0 + a_1) + a_2) + a_3`` in f32 over the per-slot sums,
then one rounding to the output dtype. The CUDA kernels are
``csrc/msda_reduce.cu``; each ``*_plain`` function is its kernel's plain
PyTorch version and rounds at the same points. A wrapper takes the plain
version for CPU tensors only; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import native

#: input arrays one launch of K6 or K7 takes (the kernels' pointer struct)
MAX_INPUTS = 16
#: K8's limit on M*D: a block stages at least two rows of each input run
PACK_MAX_ROW = 16384


def fold_slots(acc, d: int):
    """(R, 4D) per-slot sums -> (R, D): ((a_0 + a_1) + a_2) + a_3."""
    return ((acc[:, :d] + acc[:, d:2 * d]) + acc[:, 2 * d:3 * d]) + acc[:, 3 * d:]


def _repeat_slots(w, cols, d: int):
    """The 4 slot weights of one sample, each repeated over its D lanes."""
    return w[:, cols].repeat_interleave(d, dim=1)


def weighted_corner_reduce_multi_plain(gs: Sequence[torch.Tensor], w):
    """Same contract as ``weighted_corner_reduce_multi``."""
    d = gs[0].shape[1] // 4
    acc = torch.zeros(gs[0].shape[0], 4 * d, dtype=torch.float32,
                      device=gs[0].device)
    for si, g in enumerate(gs):
        acc = acc + (g * _repeat_slots(w, slice(4 * si, 4 * si + 4), d)).float()
    return fold_slots(acc, d).to(gs[0].dtype)


def weighted_corner_reduce_v5_plain(gs: Sequence[torch.Tensor], w, p: int,
                                    slot_major: bool = False):
    """Same contract as ``weighted_corner_reduce_v5``."""
    n = len(gs) * p
    d = gs[0].shape[1] // (4 * p)
    wf = w.to(torch.bfloat16).float()
    acc = torch.zeros(gs[0].shape[0], 4 * d, dtype=torch.float32,
                      device=gs[0].device)
    for lvl, g in enumerate(gs):
        gf = g.float()
        for pi in range(p):
            si = lvl * p + pi
            cols = [k * n + si if slot_major else si * 4 + k for k in range(4)]
            acc = acc + gf[:, pi * 4 * d:(pi + 1) * 4 * d] * _repeat_slots(
                wf, cols, d)
    return fold_slots(acc, d).to(gs[0].dtype)


def pack_corner_table_plain(v, width: int, n_heads: int = 8):
    """Same contract as ``pack_corner_table``: the roll-based build."""
    b, s, md = v.shape
    v4 = v.reshape(b, s, n_heads, md // n_heads)
    rolled = [torch.roll(v4, -o, dims=1) for o in (0, 1, width, width + 1)]
    return torch.cat(rolled, dim=-1).reshape(b, s, 4 * md)


def _check_rows(gs, w, lanes: int, n_cols: int):
    """Shapes of the reduces' inputs: gs (R, lanes) each, w (R, n_cols)."""
    if not gs or lanes % 4:
        raise ValueError(f"{len(gs)} arrays of {lanes} lanes")
    r = gs[0].shape[0]
    for g in gs:
        if g.dim() != 2 or tuple(g.shape) != (r, lanes):
            raise ValueError(f"gathered rows {tuple(g.shape)}, want {(r, lanes)}")
    if tuple(w.shape) != (r, n_cols):
        raise ValueError(f"weights {tuple(w.shape)}, want {(r, n_cols)}")


def _check_kernel_inputs(gs, w, d: int):
    if len(gs) > MAX_INPUTS:
        raise ValueError(f"{len(gs)} input arrays, the kernel takes at most "
                         f"{MAX_INPUTS}")
    if d % 8:
        raise ValueError(f"D = {d}: the kernel takes D a multiple of 8")
    for t in (*gs, w):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    for g in gs:
        if g.data_ptr() % 16:
            raise ValueError("gathered rows must be 16-byte aligned")


def weighted_corner_reduce_multi(gs: Sequence[torch.Tensor], w):
    """gs: N gathered corner rows (R, 4D); w (R, 4N) sample-major slot
    weights -> (R, D) in gs' dtype. bf16 on the card."""
    gs = list(gs)
    _check_rows(gs, w, gs[0].shape[-1] if gs else 0, 4 * len(gs))
    if native.on_cpu([*gs, w]):
        return weighted_corner_reduce_multi_plain(gs, w)
    native.refuse_grad(*gs, w)
    r, d = gs[0].shape[0], gs[0].shape[1] // 4
    _check_kernel_inputs(gs, w, d)
    out = torch.empty(r, d, dtype=torch.bfloat16, device=w.device)
    native.launch("axvs_corner_reduce_multi", native.pointers(gs), len(gs),
                  w.data_ptr(), out.data_ptr(), r, d, device=w.device)
    weighted_corner_reduce_multi.launches += 1
    return out


def weighted_corner_reduce_v5(gs: Sequence[torch.Tensor], w, p: int,
                              slot_major: bool = False):
    """gs: L arrays (R, P*4D) of P merged samples each; w (R, 4LP) slot
    weights, rounded to bf16 first -> (R, D) in gs' dtype. bf16 gathered
    rows on the card."""
    gs = list(gs)
    if p < 1:
        raise ValueError(f"p = {p}")
    lanes = gs[0].shape[-1] if gs else 0
    if lanes % (4 * p):
        raise ValueError(f"{lanes} lanes do not hold {p} samples")
    _check_rows(gs, w, lanes, 4 * p * len(gs))
    if native.on_cpu([*gs, w]):
        return weighted_corner_reduce_v5_plain(gs, w, p, slot_major)
    native.refuse_grad(*gs, w)
    r, d = gs[0].shape[0], lanes // (4 * p)
    w = w.to(torch.bfloat16)
    _check_kernel_inputs(gs, w, d)
    out = torch.empty(r, d, dtype=torch.bfloat16, device=w.device)
    native.launch("axvs_corner_reduce_v5", native.pointers(gs), len(gs), p,
                  w.data_ptr(), out.data_ptr(), r, d, int(slot_major),
                  device=w.device)
    weighted_corner_reduce_v5.launches += 1
    return out


def pack_corner_table(v, width: int, n_heads: int = 8):
    """v (B, S, M*D), one level of S = H*W pixels, row-major, W = ``width``
    -> (B, S, M*4D) with lanes (m, k, d). On the card v is bf16 with rows
    contiguous, M*D at most ``PACK_MAX_ROW``; its batch rows may lie apart
    (a level's slice of the whole value). The kernel copies tiles of rows
    through shared memory (``csrc/msda_reduce.cu``)."""
    if v.dim() != 3 or v.shape[2] % n_heads or width < 1:
        raise ValueError(f"v {tuple(v.shape)}, {n_heads} heads, width {width}")
    if native.on_cpu([v]):
        return pack_corner_table_plain(v, width, n_heads)
    native.refuse_grad(v)
    b, s, md = v.shape
    d = md // n_heads
    if v.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16, got {v.dtype}")
    if (v.stride(2) != 1 or v.stride(1) != md or v.stride(0) % 8
            or v.data_ptr() % 16 or d % 8):
        raise ValueError("v needs contiguous 16-byte-aligned rows and D a "
                         f"multiple of 8 (strides {v.stride()}, D = {d})")
    if md > PACK_MAX_ROW:
        raise ValueError(f"M*D = {md}: the kernel stages rows of at most "
                         f"{PACK_MAX_ROW} values")
    out = torch.empty(b, s, 4 * md, dtype=v.dtype, device=v.device)
    native.launch("axvs_pack_corner_table", v.data_ptr(), out.data_ptr(), b,
                  s, v.stride(0), n_heads, d, width, device=v.device)
    pack_corner_table.launches += 1
    return out


#: kernel launches since each count was last set to 0
weighted_corner_reduce_multi.launches = 0
weighted_corner_reduce_v5.launches = 0
pack_corner_table.launches = 0
