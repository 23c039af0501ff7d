#!/usr/bin/env python3
"""Drive the PyTorch port (``axial_vs_tpu_torch``) once on one CUDA card.

Phases, in order; any failure exits non-zero before the last line:
  1. device  - require CUDA, print the card's name and power limit, TF32 off
  2. build   - compile the hand-written kernels from ``axial_vs_tpu_torch/csrc``
  3. K1      - dwconv7x7+LayerNorm kernel against its plain version, in bf16
               and in f32 (the four ConvNeXt-L stage shapes), timed beside
               the conv2d + layer_norm library chain
  4. K2      - deformable-attention kernel against its plain version, bf16
               and f32, at the WC shape with uniform locations and at a
               ragged shape, timed eager and in a CUDA graph
  5. K3      - trajectory-attention kernel against its plain version, bf16
               and f32, timed eager and in a CUDA graph; its two stages'
               device time at the widest rows (torch.profiler)
  6. K5, K4  - the fused ConvNeXt MLP tail and the fused ConvNeXt block
               against their plain versions at the four ConvNeXt-L stage
               shapes, beside the default route's eager chain, per stage
  7. WC slice - the ConvNeXt-L within-clip (WC) forward at 769x1345, T=2,
               bf16, random weights from a seed: 3 clips, finite outputs,
               and the kernel launch counts of that run
  8. WC reference - the same weights on a small clip, the card's bf16 run
               and the card's f32 run (K1-K3 in f32) against an f32 run of
               the plain versions on the CPU
  8b. R50 f32 - the ResNet-50 WC model of configs/vipseg/maxtron_wc_r50.yaml
               in f32, its dtype there: one 769x1345 clip, finite f32
               outputs, K2 and K3 launch counts, ms a clip, peak memory
  8c. train r50 f32 - 3 steps of the port's ``train_step`` on the R50 WC
               model of the same yaml in f32 at 713x713, T=2, on
               ``tools/bench_train.py``'s batch: finite losses and
               gradients, K2 and K3 launched per step as in 8b (their
               autograd Functions), non-zero gradients of the MSDA and
               trajectory projections, BatchNorm statistics and parameters
               moved; K2's and K3's backward against autograd of their
               plain versions at the first step's inputs; ms per step and
               peak memory
  8d. train convnext_large bf16 - 3 steps of ``train_step`` on the
               ConvNeXt-L WC model of configs/vipseg/
               maxtron_wc_convnext_large.yaml at full depth and width: bf16
               compute on f32 master weights, drop path 0.4, remat, the
               device auction, on the same batch: finite losses, K2 and K3
               launched in bf16 per step, every parameter and gradient f32,
               non-zero gradients where every step reaches, BatchNorm
               statistics moved; K2's and K3's bf16 forward and backward
               against their plain versions at the first step's inputs; ms
               per step, peak memory, and one profiled step (the parts and
               the auction's device time)
  8e. trainer - the port's ``train_net_video`` entry (the function) on the
               R50 WC yaml in bf16 at 321x321 over two synthetic 720x1280
               videos registered by ``data/builtin.py``, 2 worker loader
               processes: 2 steps with a checkpoint, a fresh Trainer's
               restored state equal to the saved one, ``--resume`` to step
               4 with the eval hook (``evaluate_vipseg`` once), the loaders
               shut down within their timeout, and the launch counts
  9. VIPSeg eval - the same model built on the fused-block route (K4):
               ``evaluate_vipseg`` on two synthetic 720x1280 VIPSeg-format
               videos (6 and 18 frames), VPQ@{1,2,4,6} and STQ in [0, 1],
               the id maps, and the launch counts of that run
 10. mlp route - one clip through the model built on the K1 + K5 route
 11. fused references - both fused routes on the small clip against the
               f32 CPU run of the plain versions
 12. Tube-Link slice - the Tube-Link R50 VIS inference at 360x640, tubes of
               5 frames, bf16, random weights from a seed: a 15-frame video
               (3 tubes) through ``TubeLinkVISInference.run_video``, 30
               instances, and the launch counts of that run
 13. Tube-Link reference - the pixel decoder on a small tube, the card's
               bf16 run against an f32 run of the plain versions on the CPU
 13b. K2 model inputs - K2 on the arguments of the first K2 call of the WC
               slice's and the Tube-Link path's warm-up (bf16 as captured,
               and in f32), against its plain version, timed eager and in a
               CUDA graph per clip and per tube
 14. MSDA bench - ``axial_vs_tpu_torch.tools.bench_msda`` at the WC shape:
               one checking pass over its six formulations (each against
               ``prod``, K2), their launch counts and ms per layer; K6, K7
               and K8 against their plain versions at the WC and ragged
               shapes, with their times (eager and in CUDA graphs; K8 per
               level and per layer), bounds and library calls (an einsum
               for K6/K7, one advanced-index gather for K8)
 15. probes - the four probe tools of ``axial_vs_tpu_torch/tools`` at their
               default shapes, each variant checked against its plain
               version: ``bench_pallas_bw`` (P4: copy and 12-input sum at
               338,688 rows, bitwise; the column gather over 4 tables,
               bitwise), ``exp_vmem_gather`` (P2: the slab gather with 1, 4
               and 8 query rows a group at tube_l0 and kmax_l0, 1 bf16 ulp,
               bitwise expected; each beside its byte bound and its L2
               floor, the rows it reads over the L2 rate of P4's copy of
               one slab in a CUDA graph; ``embedding_bag`` beside it),
               ``exp_dwconv_variants`` (P1: 8
               variants and K1 at ConvNeXt-L stages 0 and 2, 1 bf16 ulp; K1
               2; noln beside a depthwise ``conv2d``) and ``bench_overlap``
               (P3: vpu 1 ulp, mxu 2 ulp, both, interleave, and the overlap
               efficiency); their launches, times, bounds, plain versions'
               and library calls' times
The line before the last is one JSON object with each kernel's route,
source, launches, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.

Usage, from the repository root: ``python3 chip_smoke.py``
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

T, H, W = 2, 769, 1345  # 2-frame clips at the VIPSeg eval size
CONVNEXT_L_DEPTHS = (3, 3, 27, 3)
CONVNEXT_L_BLOCKS = sum(CONVNEXT_L_DEPTHS)  # K1, K4 or K5 calls per clip
KERNEL_SHAPES_K1 = [  # (N, H, W, C): the four ConvNeXt-L stages at 769x1345
    (2, 192, 336, 192), (2, 96, 168, 384), (2, 48, 84, 768), (2, 24, 42, 1536),
    (1, 37, 53, 200),  # odd H and W, C not a power of two
]
WC_LEVELS = ((24, 42), (48, 84), (96, 168))  # res5, res4, res3 at 769x1345
TL_T, TL_H, TL_W = 5, 360, 640  # Tube-Link: 5-frame tubes at the YTVIS size
TL_VIDEO = 3 * TL_T             # frames of the driven video: 3 tubes
#: K3 at every trajectory-attention shape of both paths, (B', f, n): the
#: height axis runs on (b*W, T*H) rows, the width axis on (b*H, T*W)
K3_WC = {"res5 H": (42, 2, 24), "res5 W": (24, 2, 42),  # res5 24x42
         "res4 H": (84, 2, 48), "res4 W": (48, 2, 84)}  # res4 48x84
K3_TL = {"res5 H": (20, 5, 12), "res5 W": (12, 5, 20),  # res5 12x20
         "res4 H": (40, 5, 23), "res4 W": (23, 5, 40)}  # res4 23x40, N=115
K2_WC_CALLS = 2  # per clip: 2 stages x 1 deformable encoder layer
K2_TL_CALLS = 6  # per tube: 6 pixel-decoder encoder layers
K3_WC_CALLS = 4  # per clip: 2 stages x 2 temporal layers, per shape
K3_TL_CALLS = 6  # per tube: 6 encoder layers x 1 temporal layer, per shape
#: published peaks of one H100 SXM (dense): bf16 tensor cores, f32 CUDA
#: cores, device memory
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def bf16_ulp(x: float) -> float:
    """One bf16 unit in the last place at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def bound_ms(flops: float, nbytes: float, peak: float, f32_flops: float = 0.0):
    """(least ms, what bounds it): the larger of the operations over the
    peak rate of their type and the bytes over the memory rate. Work of two
    types (``flops`` at ``peak`` and ``f32_flops`` on the CUDA cores) may
    overlap, so the slower type alone bounds the operations."""
    t_ops = max(flops / peak, f32_flops / PEAK_F32) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def f32_bound(want) -> float:
    """The f32 instantiations' bound on |kernel - plain|:
    ``native.F32_REL_BOUND`` of max|out| (f32 sums in other orders)."""
    from axial_vs_tpu_torch.ops.native import F32_REL_BOUND

    return F32_REL_BOUND * want.float().abs().max().item()


def full_f32(torch):
    """f32 matrix products and convolutions in full f32, not TF32, stated
    here for the f32 cases (the plain versions run cuBLAS and cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def counted_kernels():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from axial_vs_tpu_torch.ops.convnext_cuda import (
        convnext_block_fused, convnext_mlp_residual, dwconv7x7_layernorm)
    from axial_vs_tpu_torch.ops.msda import ms_deform_attn
    from axial_vs_tpu_torch.ops.msda_reduce import (
        pack_corner_table, weighted_corner_reduce_multi,
        weighted_corner_reduce_v5)
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core
    from axial_vs_tpu_torch.tools import bench_overlap, bench_pallas_bw
    from axial_vs_tpu_torch.tools.exp_dwconv_variants import dwconv_variant
    from axial_vs_tpu_torch.tools.exp_vmem_gather import slab_gather

    return {"K1": dwconv7x7_layernorm, "K2": ms_deform_attn,
            "K3": trajectory_attention_core, "K4": convnext_block_fused,
            "K5": convnext_mlp_residual, "K6": weighted_corner_reduce_multi,
            "K7": weighted_corner_reduce_v5, "K8": pack_corner_table,
            "P1": dwconv_variant, "P2": slab_gather,
            **bench_overlap.counted_kernels(),
            **bench_pallas_bw.counted_kernels()}


def expect(**launches):
    """Wanted launch counts of a run: the ones given, every other kernel 0."""
    return {k: launches.get(k, 0) for k in counted_kernels()}


def reset_counts():
    for fn in counted_kernels().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counted_kernels().items()}


@contextlib.contextmanager
def first_msda_call(box: dict, key: str):
    """While active, the arguments of the first K2 call that an MSDA layer
    makes (``layers/msda_attention.py``: the WC module's and the Tube-Link
    pixel decoder's) are kept in ``box[key]``, tensors copied to the host
    (off the card's peak memory); every call still runs the wrapper, and
    its launch count."""
    import torch

    from axial_vs_tpu_torch.layers import msda_attention as layer

    real = layer.ms_deform_attn

    def capture(*args, **kwargs):
        if key not in box:
            box[key] = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
        return real(*args, **kwargs)

    layer.ms_deform_attn = capture
    try:
        yield
    finally:
        layer.ms_deform_attn = real


def cuda_ms(torch, fn, launches: int = 10, repeats: int = 5) -> float:
    """Median device time of one call, from CUDA events around a run of
    back-to-back calls (after a warm-up run)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "runs only on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    # stated explicitly: f32 matmuls and convs in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build():
    from axial_vs_tpu_torch.ops import native

    t0 = time.perf_counter()
    native.library()
    log(f"build: {time.perf_counter() - t0:.3f} s "
        f"(nvcc {native.build_info['seconds']:.3f} s) -> "
        f"{native.build_info['path']}")
    for line in native.build_info["log"].splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling", "wgmma",
                                   "arning")):
            log(f"  ptxas: {line.strip()}")


def _dwln_chain(F, x, wt, b, lw, lb):
    """K1's function as two library calls in x's dtype, a yardstick the port
    never calls: cuDNN's depthwise conv on the NHWC tensor, then
    ``F.layer_norm``."""
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), wt, b, padding=3, groups=c)
    return F.layer_norm(y.permute(0, 2, 3, 1), (c,), lw, lb, 1e-6)


def phase_k1(torch, gen):
    import torch.nn.functional as F

    from axial_vs_tpu_torch.ops.convnext_cuda import (
        dwconv7x7_layernorm, dwconv7x7_layernorm_plain, dwconv_taps)
    from axial_vs_tpu_torch.tools.timing import graph_ms

    dev = torch.device("cuda")
    full_f32(torch)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    times = {torch.bfloat16: [], torch.float32: []}
    for dtype in (torch.bfloat16, torch.float32):
        # f32 at the four stage shapes only (the f32 ConvNeXt's), bf16 at all
        shapes = KERNEL_SHAPES_K1 if dtype == torch.bfloat16 else KERNEL_SHAPES_K1[:4]
        for n, h, w, c in shapes:
            def r(*shape, scale=1.0, dtype=torch.float32):
                return (torch.randn(*shape, generator=gen, device=dev) * scale
                        ).to(dtype)

            x = r(n, h, w, c, dtype=dtype)
            wt = r(c, 1, 7, 7, scale=0.1, dtype=dtype)
            b, lw, lb = r(c, scale=0.1), 1.0 + r(c, scale=0.1), r(c, scale=0.1)
            taps = dwconv_taps(wt)  # the copy a ConvNeXt block keeps
            got = dwconv7x7_layernorm(x, wt, b, lw, lb, taps=taps)
            want = dwconv7x7_layernorm_plain(x, wt, b, lw, lb)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            if dtype == torch.bfloat16:
                # f32 sums reassociated, both rounded once
                bound, stated = 2 * bf16_ulp(scale), "2 bf16 ulp"
            else:
                bound, stated = f32_bound(want), "F32_REL_BOUND"
            def kernel():
                return dwconv7x7_layernorm(x, wt, b, lw, lb, taps=taps)

            ms = cuda_ms(torch, kernel)
            g_ms = graph_ms(kernel, "cuda", 10)
            plain_ms = cuda_ms(torch, lambda: dwconv7x7_layernorm_plain(
                x, wt, b, lw, lb))
            vecs = [t.to(dtype) for t in (b, lw, lb)]
            chain_ms = cuda_ms(torch, lambda: _dwln_chain(F, x, wt, *vecs))
            log(f"K1 {str(dtype)[6:]} {(n, h, w, c)}: max_abs_err {err:.6g} "
                f"(bound {stated} of max|out| {scale:.4g} = {bound:.6g}); "
                f"kernel {ms:.4f} ms ({g_ms:.4f} in a CUDA graph), plain "
                f"{plain_ms:.4f} ms, conv2d + layer_norm chain {chain_ms:.4f} ms")
            if not (err <= bound and got.dtype == dtype):
                raise AssertionError(f"K1 {dtype} disagrees at {(n, h, w, c)}")
            worst[dtype] = max(worst[dtype], err)
            times[dtype].append((ms, plain_ms, chain_ms, g_ms))
    # per clip: each stage's time times its number of blocks
    per_clip = {dt: [sum(d * t[i] for d, t in zip(CONVNEXT_L_DEPTHS, ts))
                     for i in (0, 1, 2, 3)] for dt, ts in times.items()}
    per_stage = {dt: {f"stage{i}": {"calls": d, "ms": t[0], "graph_ms": t[3],
                                    "chain_ms": t[2]}
                      for i, (d, t) in enumerate(zip(CONVNEXT_L_DEPTHS, ts))}
                 for dt, ts in times.items()}
    # work per clip: 49 f32 multiply-adds and ~10 LayerNorm operations per
    # output element on the CUDA cores; x read once, out written once
    elems = sum(d * math.prod(shape)
                for d, shape in zip(CONVNEXT_L_DEPTHS, KERNEL_SHAPES_K1))
    bounds = {}
    for dt, size in ((torch.bfloat16, 2), (torch.float32, 4)):
        weights = sum(d * shape[-1] * (49 * size + 3 * 4)
                      for d, shape in zip(CONVNEXT_L_DEPTHS, KERNEL_SHAPES_K1))
        bounds[dt] = bound_ms((2 * 49 + 10) * elems, 2 * size * elems + weights,
                              PEAK_F32)
        log(f"K1 {str(dt)[6:]} per clip (3/3/27/3 calls at the stage shapes): "
            f"kernel {per_clip[dt][0]:.4f} ms ({per_clip[dt][3]:.4f} in CUDA "
            f"graphs), plain {per_clip[dt][1]:.4f} ms, "
            f"conv2d + layer_norm chain {per_clip[dt][2]:.4f} ms, "
            f"bound {bounds[dt][0]:.4f} ms ({bounds[dt][1]})")
    f32 = torch.float32
    return {"max_abs_err": worst[torch.bfloat16],
            "ms": per_clip[torch.bfloat16][0],
            "plain_ms": per_clip[torch.bfloat16][1],
            "bound_ms": bounds[torch.bfloat16][0],
            "bound_by": bounds[torch.bfloat16][1], "library_ms": None,
            "chain_ms": per_clip[torch.bfloat16][2],
            "graph_ms": per_clip[torch.bfloat16][3],
            "per": "WC clip (36 calls)",
            "per_stage": per_stage[torch.bfloat16],
            "f32": {"max_abs_err": worst[f32], "ms": per_clip[f32][0],
                    "plain_ms": per_clip[f32][1], "bound_ms": bounds[f32][0],
                    "bound_by": bounds[f32][1], "chain_ms": per_clip[f32][2],
                    "graph_ms": per_clip[f32][3],
                    "per_stage": per_stage[f32]}}


def _msda_inputs(torch, gen, b, shapes, lq, m, d, p, lo, hi,
                 dtype=None):
    dev = torch.device("cuda")
    dtype = dtype or torch.bfloat16
    s = sum(h * w for h, w in shapes)
    value = torch.randn(b, s, m, d, generator=gen, device=dev).to(dtype)
    loc = lo + (hi - lo) * torch.rand(b, lq, m, len(shapes), p, 2,
                                      generator=gen, device=dev)
    logits = torch.randn(b, lq, m, len(shapes) * p, generator=gen, device=dev)
    weights = logits.softmax(-1).reshape(b, lq, m, len(shapes), p).to(dtype)
    return value, loc, weights


def _msda_work(value, loc, weights, calls: int):
    """(bound ms, what bounds it, MB a call, L2 corner-sector MB a call) of
    ``calls`` K2 calls: each input read once and the output written once;
    2 f32 operations per corner per channel (the weighted bilinear sum).
    The sector volume counts every corner of every row in 32-byte sectors,
    L1 hits not subtracted: computed from the shapes, for the log only."""
    b, lq, m, nl, p, _ = loc.shape
    d, size = value.shape[-1], value.element_size()
    nbytes = sum(x.numel() * x.element_size() for x in (value, loc, weights)) \
        + b * lq * m * d * size
    flops = 2 * 4 * d * loc[..., 0].numel()
    bound, by = bound_ms(calls * flops, calls * nbytes, PEAK_F32)
    sectors = b * lq * m * 4 * nl * p * math.ceil(d * size / 32) * 32
    return bound, by, nbytes / 1e6, sectors / 1e6


def _k2_case(torch, label, value, shapes, loc, weights, calls):
    """K2 against its plain version on these inputs (2 bf16 ulp or
    F32_REL_BOUND of max|out|), timed eager, in a CUDA graph and plain;
    returns (max_abs_err, the times of ``calls`` calls)."""
    from axial_vs_tpu_torch.ops.msda import (
        level_start_index, ms_deform_attn, ms_deform_attn_plain)
    from axial_vs_tpu_torch.tools.timing import graph_ms

    dtype = value.dtype
    starts = level_start_index(shapes)
    got = ms_deform_attn(value, shapes, starts, loc, weights)
    want = ms_deform_attn_plain(value, shapes, starts, loc, weights)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dtype == torch.bfloat16:
        # f32 sums on both sides, rounded once
        bound, stated = 2 * bf16_ulp(scale), "2 bf16 ulp"
    else:
        bound, stated = f32_bound(want), "F32_REL_BOUND"

    def kernel():
        return ms_deform_attn(value, shapes, starts, loc, weights)

    ms = cuda_ms(torch, kernel)
    g_ms = graph_ms(kernel, "cuda", 10)
    plain_ms = cuda_ms(torch, lambda: ms_deform_attn_plain(
        value, shapes, starts, loc, weights), launches=3)
    log(f"K2 {str(dtype)[6:]} {label} value {tuple(value.shape)} "
        f"locations {tuple(loc.shape)}: max_abs_err {err:.6g} (bound "
        f"{stated} of max|out| {scale:.4g} = {bound:.6g}); kernel "
        f"{ms:.4f} ms ({g_ms:.4f} in a CUDA graph), plain {plain_ms:.4f} ms")
    if not (err <= bound and got.dtype == dtype
            and torch.isfinite(got.float()).all()):
        raise AssertionError(f"K2 {dtype} disagrees on the {label} case")
    clip_bound, by, mb, sector_mb = _msda_work(value, loc, weights, calls)
    entry = {"ms": calls * ms, "plain_ms": calls * plain_ms,
             "graph_ms": calls * g_ms, "bound_ms": clip_bound, "bound_by": by}
    log(f"K2 {str(dtype)[6:]} {label}, {calls} calls: kernel "
        f"{calls * ms:.4f} ms ({calls * g_ms:.4f} in CUDA graphs), plain "
        f"{calls * plain_ms:.4f} ms, bound {clip_bound:.4f} ms ({by}, "
        f"{mb:.1f} MB a call to and from device memory; every corner of "
        f"every row, L1 hits not subtracted, is {sector_mb:.1f} MB of "
        f"32-byte sectors a call, computed from the shapes)")
    return err, entry


def phase_k2(torch, gen):
    """K2 on drawn inputs: the WC shape with locations uniform in [-0.1,
    1.1] (no two queries share corners), and a ragged shape."""
    cases = [
        # the WC shape: B*T frames, res5/res4/res3 tokens as queries
        ("wc uniform", 2, WC_LEVELS, sum(h * w for h, w in WC_LEVELS), 8, 32,
         4, -0.1, 1.1),
        # ragged: D > 32 and not a multiple of 32, odd levels, locations
        # straddling the border
        ("ragged", 1, ((5, 7), (3, 4), (2, 3)), 37, 3, 40, 3, -0.2, 1.2),
    ]
    result = {}  # per dtype: the worst error, the wc case's per-clip entry
    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        for name, b, shapes, lq, m, d, p, lo, hi in cases:
            value, loc, weights = _msda_inputs(torch, gen, b, shapes, lq, m, d,
                                               p, lo, hi, dtype)
            err, entry = _k2_case(torch, name, value, shapes, loc, weights,
                                  K2_WC_CALLS)
            worst = max(worst, err)
            if name == "wc uniform":
                result[dtype] = {"uniform": entry}
        result[dtype]["max_abs_err"] = worst
    return result


def phase_k2_model(torch, captured: dict, drawn: dict):
    """K2 on the layers' own inputs, captured from the first K2 call of the
    WC slice's warm-up clip and of the Tube-Link warm-up tube (bf16; in f32
    the same locations with value and weights cast), each against its plain
    version and timed. Returns K2's entry of the kernels line."""
    result = {dtype: dict(drawn[dtype]) for dtype in drawn}
    for key, calls, per in (("wc", K2_WC_CALLS, "clip"),
                            ("tube-link", K2_TL_CALLS, "tube")):
        value, shapes, _, loc, weights = captured[key]
        loc = loc.cuda()
        for dtype in (torch.bfloat16, torch.float32):
            v, w = (t.to("cuda", dtype).contiguous() for t in (value, weights))
            label = (f"{key} model inputs" if dtype == torch.bfloat16 else
                     f"{key} model locations, value and weights cast to f32")
            err, entry = _k2_case(torch, label, v, shapes, loc, w, calls)
            result[dtype][per] = entry
            result[dtype]["max_abs_err"] = max(result[dtype]["max_abs_err"],
                                               err)
    bf16, f32 = result[torch.bfloat16], result[torch.float32]
    return {**bf16["clip"], "library_ms": None, "max_abs_err": bf16["max_abs_err"],
            "per": f"WC clip ({K2_WC_CALLS} calls), the layer's own inputs",
            "uniform": bf16["uniform"], "tube": bf16["tube"],
            "f32": {**f32["clip"], "max_abs_err": f32["max_abs_err"],
                    "uniform": f32["uniform"], "tube": f32["tube"]}}


def _traj_inputs(torch, gen, b, f, n, c=256, dtype=None):
    """q, k, v (b, f*n, c) ~ N(0, 1); proj_q / proj_kv at their
    xavier-uniform and U(+-1/sqrt(c)) inits, matrices in ``dtype`` (bf16
    unless given)."""
    def u(*shape, bound):
        return (torch.rand(*shape, generator=gen, device="cuda") * 2 - 1) * bound

    dtype = dtype or torch.bfloat16
    q, k, v = (torch.randn(b, f * n, c, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    wq = u(c, c, bound=(6 / (2 * c)) ** 0.5).to(dtype)
    wkv = u(2 * c, c, bound=(6 / (3 * c)) ** 0.5).to(dtype)
    return q, k, v, wq, u(c, bound=c ** -0.5), wkv, u(2 * c, bound=c ** -0.5)


def _traj_work(b, f, n, c=256, size=2):
    """(FLOPs, bytes) of one call: stage 1, proj_q, proj_kv; q, k, v read
    once, out written once, the stage-2 weights read once, ``size`` bytes
    an element."""
    nt = f * n
    flops = 4 * b * nt * nt * c + 2 * b * nt * c * c + 4 * f * b * nt * c * c
    return flops, size * (4 * b * nt * c + 3 * c * c)


def kernel_split_ms(torch, fn, match: str, calls: int = 10):
    """Device ms a call of each kernel whose name holds ``match`` among
    those ``calls`` calls of ``fn`` launch, from ``torch.profiler``; empty
    where the profiler records no device time."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0)
        name = re.search(r"\w*" + match + r"\w*", evt.key)
        if us and name:
            split[name.group(0)] = split.get(name.group(0), 0.0) + us / 1e3 / calls
    return split


def phase_k3(torch, gen):
    from axial_vs_tpu_torch.ops.traj import (
        TRAJ_ULPS, trajectory_attention_core, trajectory_attention_core_plain)
    from axial_vs_tpu_torch.tools.timing import graph_ms

    cases = [("wc " + k, v) for k, v in K3_WC.items()]
    cases += [("tube-link " + k, v) for k, v in K3_TL.items()]
    cases += [("f=3 small n", (3, 3, 7))]
    full_f32(torch)
    worst, times, stages = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        for name, (b, f, n) in cases:
            args = _traj_inputs(torch, gen, b, f, n, dtype=dtype)
            got = trajectory_attention_core(*args, f, 8)
            want = trajectory_attention_core_plain(*args, f, 8)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            if dtype == torch.bfloat16:
                bound, stated = TRAJ_ULPS * bf16_ulp(scale), f"{TRAJ_ULPS} bf16 ulp"
            else:
                bound, stated = f32_bound(want), "F32_REL_BOUND"
            def kernel():
                return trajectory_attention_core(*args, f, 8)

            ms = cuda_ms(torch, kernel)
            g_ms = graph_ms(kernel, "cuda", 10)
            plain_ms = cuda_ms(torch, lambda: trajectory_attention_core_plain(
                *args, f, 8), launches=3)
            log(f"K3 {tag} {name} (B'={b}, f={f}, n={n}, N={f * n}): "
                f"max_abs_err {err:.6g} (bound {stated} of max|out| "
                f"{scale:.4g} = {bound:.6g}, {bound / scale:.4g} of "
                f"max|out|); kernel {ms:.4f} ms ({g_ms:.4f} in a CUDA "
                f"graph), plain {plain_ms:.4f} ms")
            if not (err <= bound and torch.isfinite(got.float()).all()
                    and got.dtype == dtype):
                raise AssertionError(f"K3 {tag} disagrees on the {name} case")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            times[(dtype, name)] = (ms, plain_ms, g_ms)
            if name in ("wc res4 W", "tube-link res4 W"):  # the widest rows
                split = kernel_split_ms(torch, kernel, "traj_stage")
                stages[(dtype, name)] = split
                log(f"K3 {tag} {name}, device ms a call by kernel "
                    f"(torch.profiler): " + (", ".join(
                        f"{k} {v:.4f}" for k, v in sorted(split.items()))
                        or "no device time recorded"))
    totals = {}
    for dtype, size in ((torch.bfloat16, 2), (torch.float32, 4)):
        for path, shapes, calls in (("wc", K3_WC, K3_WC_CALLS),
                                    ("tube-link", K3_TL, K3_TL_CALLS)):
            ms, plain, g_ms = (calls * sum(times[(dtype, f"{path} {k}")][i]
                                           for k in shapes) for i in (0, 1, 2))
            flops, nbytes = (calls * sum(_traj_work(*s, size=size)[i]
                                         for s in shapes.values())
                             for i in (0, 1))
            # f32 runs its products on the CUDA cores
            peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
            bound, by = bound_ms(flops, nbytes, peak)
            totals[(dtype, path)] = (ms, plain, bound, by, g_ms)
            log(f"K3 {str(dtype)[6:]} per {'clip' if path == 'wc' else 'tube'} "
                f"on the {path} path ({calls * len(shapes)} calls): kernel "
                f"{ms:.4f} ms ({g_ms:.4f} in CUDA graphs), plain {plain:.4f} "
                f"ms, bound {bound:.4f} ms "
                f"({by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    ms, plain, bound, by, g_ms = totals[(torch.bfloat16, "tube-link")]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "graph_ms")
    return {"max_abs_err": worst[torch.bfloat16], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "graph_ms": g_ms,
            "per": "Tube-Link tube (24 calls)",
            "stages_ms_per_call": {f"{str(d)[6:]} {k}": v
                                   for (d, k), v in stages.items()},
            "wc_clip": dict(zip(keys, totals[(torch.bfloat16, "wc")])),
            "f32": {"max_abs_err": worst[torch.float32],
                    "tube": dict(zip(keys, totals[(torch.float32, "tube-link")])),
                    "wc_clip": dict(zip(keys, totals[(torch.float32, "wc")]))}}


def _mlp_params(torch, gen, c):
    """The block MLP's parameters at unit-variance-preserving scales, bf16
    matrices in torch's (out, in) layout; gamma ~ U(-1, 1), so that the
    residual does not hide the kernel's work (at the upstream 1e-6 it would)."""
    def r(*shape, scale):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    w1 = r(4 * c, c, scale=c ** -0.5).bfloat16()
    w2 = r(c, 4 * c, scale=(4 * c) ** -0.5).bfloat16()
    gamma = torch.rand(c, generator=gen, device="cuda") * 2 - 1
    return w1, r(4 * c, scale=0.1), w2, r(c, scale=0.1), gamma


def _default_chain(F, gelu, y, x, w1, b1, w2, b2, gamma):
    """The default route's MLP tail, as ``ConvNeXtBlock`` runs it eagerly:
    F.linear, gelu, F.linear, then the scaled residual."""
    h = gelu(F.linear(y, w1, b1.to(y.dtype)))
    return x + F.linear(h, w2, b2.to(y.dtype)) * gamma.to(y.dtype)


def _mlp_work(n, h, w, c, block: bool):
    """(bf16 tensor-core FLOPs, f32 FLOPs, bytes) of one K5 or K4 call: x
    (and for K5 the shortcut) read once, out written once, the bf16 weights
    and f32 vectors read once; K4 adds the 7x7 taps and the LayerNorm."""
    p = n * h * w
    flops = 16 * p * c * c
    if block:
        return (flops, (2 * 49 + 10) * p * c,
                2 * p * c * 2 + 16 * c * c + 49 * c * 2 + 9 * c * 4)
    return flops, 0, 3 * p * c * 2 + 16 * c * c + 6 * c * 4


def phase_k4_k5(torch, gen):
    """K5 and K4 at the four ConvNeXt-L stage shapes. Returns their result
    dicts, per clip (36 calls)."""
    import torch.nn.functional as F

    from axial_vs_tpu_torch.ops.act import gelu
    from axial_vs_tpu_torch.ops.convnext_cuda import (
        convnext_block_fused, convnext_block_fused_plain, convnext_mlp_residual,
        convnext_mlp_residual_plain, dwconv7x7_layernorm, dwconv_taps)

    rows = {"K5": [], "K4": []}
    for n, h, w, c in KERNEL_SHAPES_K1[:4]:
        x, sc = (torch.randn(n, h, w, c, generator=gen, device="cuda").bfloat16()
                 for _ in range(2))
        wt = (torch.randn(c, 1, 7, 7, generator=gen, device="cuda") * 0.1).bfloat16()
        dw = (wt, *(torch.randn(c, generator=gen, device="cuda") * 0.1
                    + (1.0 if i == 1 else 0.0) for i in range(3)))
        mlp = _mlp_params(torch, gen, c)
        taps = dwconv_taps(wt)  # the copy a ConvNeXt block keeps
        cases = {
            "K5": (lambda: convnext_mlp_residual(x, sc, *mlp),
                   lambda: convnext_mlp_residual_plain(x, sc, *mlp),
                   lambda: _default_chain(F, gelu, x, sc, *mlp)),
            "K4": (lambda: convnext_block_fused(x, *dw, *mlp, taps=taps),
                   lambda: convnext_block_fused_plain(x, *dw, *mlp),
                   lambda: _default_chain(F, gelu, dwconv7x7_layernorm(
                       x, *dw, taps=taps), x, *mlp)),
        }
        for key, (kernel, plain, chain) in cases.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            bound = 2 * bf16_ulp(scale)  # f32 sums reassociated, same casts
            ms = cuda_ms(torch, kernel)
            plain_ms = cuda_ms(torch, plain, launches=3)
            chain_ms = cuda_ms(torch, chain)
            work = _mlp_work(n, h, w, c, key == "K4")
            call_bound, by = bound_ms(work[0], work[2], PEAK_BF16, work[1])
            log(f"{key} {(n, h, w, c)}: max_abs_err {err:.6g} (bound 2 bf16 ulp "
                f"of max|out| {scale:.4g} = {bound:.6g}); kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, default route's chain {chain_ms:.4f} "
                f"ms, bound {call_bound:.4f} ms ({by}, {work[0] / 1e9:.1f} "
                f"GFLOP, {work[2] / 1e6:.1f} MB)")
            if not (err <= bound and torch.isfinite(got.float()).all()):
                raise AssertionError(f"{key} disagrees at {(n, h, w, c)}")
            rows[key].append((err, ms, plain_ms, chain_ms, call_bound, by))
    out = {}
    for key, r in rows.items():
        ms, plain_ms, chain_ms, bound = (
            sum(d * t[i] for d, t in zip(CONVNEXT_L_DEPTHS, r)) for i in (1, 2, 3, 4))
        by = {t[5] for t in r}
        log(f"{key} per clip (3/3/27/3 calls at the stage shapes): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, default route's chain "
            f"{chain_ms:.4f} ms, bound {bound:.4f} ms ({'/'.join(sorted(by))})")
        per_stage = {f"stage{i}": {"calls": d, "ms": t[1], "plain_ms": t[2],
                                   "default_route_ms": t[3], "bound_ms": t[4]}
                     for i, (d, t) in enumerate(zip(CONVNEXT_L_DEPTHS, r))}
        out[key] = {"max_abs_err": max(t[0] for t in r), "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": "operations" if by == {"operations"} else "bytes",
                    "library_ms": None, "default_route_ms": chain_ms,
                    "per": f"WC clip ({CONVNEXT_L_BLOCKS} calls)",
                    "per_stage": per_stage}
    return out["K5"], out["K4"]


def wc_convnext_large_config():
    """The configuration ``bench.py`` builds by default, from the port's own
    config (``tools/bench.py::bench_config``: the repo's default config with
    bench.py's overrides): ConvNeXt-L, the within-clip module, the kMaX
    decoders, 124 VIPSeg classes, bf16, and the default input normalisation
    and video test thresholds that ``evaluate_vipseg`` reads."""
    from axial_vs_tpu_torch.tools.bench import bench_config

    return bench_config("convnext_large", (H, W), T)


def wc_r50_config():
    """``configs/vipseg/maxtron_wc_r50.yaml`` over the repo's default
    config, from the port's own config: ResNet-50, the within-clip module
    of 2 stages, the kMaX decoders, 124 VIPSeg classes, and f32, the
    default dtype (the yaml sets none); its 769x1345 frames, 2-frame clips,
    pixel mean and std and thresholds."""
    from axial_vs_tpu_torch.config import load_config

    return load_config("vipseg/maxtron_wc_r50.yaml")


OUTPUT_SHAPES = {  # one clip of T frames at H x W
    "pred_logits": (1, 128, 125),
    "pred_masks": (1, T, 192, 336, 128),
    "pred_mask_embeddings": (1, 128, 128),
}
OUTPUTS = tuple(OUTPUT_SHAPES)
#: bound on max |card - reference| / max |reference| for each output. The
#: card runs bf16 against an f32 reference, and bf16 alone drifts: on the
#: host of an NVIDIA H100 80GB HBM3 (700 W), the plain versions run in bf16
#: on its CPU were 0.035 of scale off the f32 run on pred_masks at the
#: upstream inits, about as far as the card's run was.
REFERENCE_BOUND = 0.1
#: the same bound for the card's f32 run (K1, K2, K3 in f32) against the
#: CPU's: both sum in f32 in other orders, which moved the outputs by at
#: most 3.3e-6 of scale on an NVIDIA H100 80GB HBM3 (700 W); a k-means
#: assignment of the transformer decoder near a tie may flip and move one
#: cluster by one pixel's feature, so the bound leaves room for that. A
#: hundredth of the bf16 bound.
F32_REFERENCE_BOUND = 1e-3


def phase_slice(torch, captured: dict):
    """Returns the launch counts of the 3-clip run; the warm-up clip's first
    K2 call's arguments go to ``captured["wc"]``."""
    from axial_vs_tpu_torch.models.kmax import build_segmenter

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_segmenter(wc_convnext_large_config(), dev,
                            torch.Generator(device=dev).manual_seed(0),
                            num_frames=T)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"slice: built ConvNeXt-L WC segmenter, {n_params} parameters, "
        f"{time.perf_counter() - t0:.2f} s")
    clips = []
    for seed in (1, 2, 3):  # distinct seeded inputs
        g = torch.Generator(device=dev).manual_seed(seed)
        clips.append(torch.randn(T, H, W, 3, generator=g, device=dev))

    with torch.inference_mode():
        t0 = time.perf_counter()
        with first_msda_call(captured, "wc"):
            model(clips[0])  # warm-up (cuDNN/cuBLAS selection, allocator)
        torch.cuda.synchronize()
        log(f"slice: warm-up clip {time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = [model(x) for x in clips]
        end.record()
        end.synchronize()
        launches = read_counts()
    ms = start.elapsed_time(end)
    for i, out in enumerate(outs):
        for k, shape in OUTPUT_SHAPES.items():
            v = out[k]
            if tuple(v.shape) != shape or v.dtype != torch.bfloat16:
                raise AssertionError(f"clip {i} {k}: {tuple(v.shape)} "
                                     f"{v.dtype}, want {shape} bf16")
            if not torch.isfinite(v.float()).all():
                raise AssertionError(f"clip {i} {k}: non-finite values")
    # at the upstream inits the residual BatchNorm gammas are 0, so only the
    # masks depend on the pixels; the logits are the same for every clip
    if torch.equal(outs[0]["pred_masks"], outs[1]["pred_masks"]):
        raise AssertionError("distinct clips gave identical pred_masks")
    log(f"slice: 3 clips of {T}x{H}x{W}: outputs finite, shapes "
        f"{[OUTPUT_SHAPES[k] for k in OUTPUTS]}")
    want = expect(K1=CONVNEXT_L_BLOCKS * 3, K2=2 * 3, K3=4 * K3_WC_CALLS * 3)
    log(f"slice: launches in the 3-clip run: {launches} (want {want})")
    log(f"slice (informational): {3 * T / (ms / 1000):.3f} frames/s "
        f"({ms / 3:.2f} ms per clip, CUDA events, batch of 1 clip, eager); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches}")
    return model, launches


def phase_reference(torch, models, f32: bool = False):
    """A small clip through copies of the models on the card (bf16,
    kernels) and in f32 on the CPU (the kernels' plain versions), once per
    ``(route, model)`` in ``models``; with ``f32``, also the first model
    in f32 on the card (K1, K2 and K3 in f32), with its launch counts. The models share their weights, so one
    CPU run of the first one's route is the reference of all (the fused
    routes compute the same function: K1 then K5 is K4). In the copies the
    ConvNeXt layer scales (1e-6 at init) are set to 0.1, so that the block
    kernels' work reaches the outputs; K2's does at the upstream inits.
    Returns {route: {output: max |diff| / max |ref|}}."""
    import copy

    from axial_vs_tpu_torch.models.backbones.convnext import ConvNeXtBlock

    def scaled(model):
        card = copy.deepcopy(model)
        with torch.no_grad():
            for m in card.modules():
                if isinstance(m, ConvNeXtBlock):
                    m.gamma.fill_(0.1)
        return card

    first = models[0][1].state_dict()
    for route, model in models[1:]:
        if any(not torch.equal(v, first[k]) for k, v in model.state_dict().items()):
            raise AssertionError(f"the {route} model's weights differ")
    ref_model = scaled(models[0][1]).float().cpu()
    ref_model.dtype = None
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(T, 129, 193, 3, generator=g, device="cuda")
    with torch.inference_mode():
        want = ref_model(x.cpu())
    del ref_model
    runs = [(route, "bf16", model, REFERENCE_BOUND) for route, model in models]
    if f32:  # the first model's route once more, in f32 on the card
        runs.append((models[0][0], "f32", models[0][1], F32_REFERENCE_BOUND))
    results = {}
    for route, dtype, model, bound in runs:
        card_model = scaled(model)
        if dtype == "f32":
            full_f32(torch)
            card_model = card_model.float()
            card_model.dtype = None
            reset_counts()
        with torch.inference_mode():
            got = card_model(x)
        torch.cuda.synchronize()
        del card_model
        if dtype == "f32":
            launches = read_counts()
            want_launches = expect(K1=CONVNEXT_L_BLOCKS, K2=2, K3=4 * K3_WC_CALLS)
            if launches != want_launches or got["pred_masks"].dtype != torch.float32:
                raise AssertionError(f"f32 reference: launches {launches}, want "
                                     f"{want_launches}; {got['pred_masks'].dtype}")
        worst = {}
        for k in OUTPUTS:
            a, b = got[k].float().cpu(), want[k]
            if a.shape != b.shape:
                raise AssertionError(f"reference {k}: {a.shape} != {b.shape}")
            worst[k] = ((a - b).abs().max() / b.abs().max().clamp_min(1e-6)).item()
        log(f"reference, {route} route (129x193 clip, card {dtype} vs CPU f32 "
            "plain versions): max |diff| / max |ref| " + ", ".join(
                f"{k} {v:.4g}" for k, v in worst.items())
            + f"; bound {bound}")
        for k, v in worst.items():
            if not v <= bound:
                raise AssertionError(f"reference {route} {dtype} {k}: {v:.4g} "
                                     f"> {bound}")
        results[f"{route} {dtype}"] = worst
    return results


def phase_r50_f32(torch):
    """The R50 WC model of ``configs/vipseg/maxtron_wc_r50.yaml`` in f32,
    its dtype there: one 769x1345 clip of T frames after a warm-up, finite
    f32 outputs, K2 and K3 (f32) launch counts, ms a clip and peak memory.
    Returns the launch counts."""
    from axial_vs_tpu_torch.models.kmax import build_segmenter

    dev = torch.device("cuda")
    full_f32(torch)
    t0 = time.perf_counter()
    model = build_segmenter(wc_r50_config(), dev,
                            torch.Generator(device=dev).manual_seed(0),
                            num_frames=T)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"r50 f32: built ResNet-50 WC segmenter, {n_params} parameters, "
        f"{time.perf_counter() - t0:.2f} s")
    x = torch.randn(T, H, W, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    with torch.inference_mode():
        model(x)  # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = model(x)
        end.record()
        end.synchronize()
        launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    shapes = {k: tuple(out[k].shape) for k in OUTPUTS}
    masks = shapes["pred_masks"]
    if (shapes["pred_logits"] != OUTPUT_SHAPES["pred_logits"]
            or masks[:2] != (1, T) or masks[-1] != 128
            or any(out[k].dtype != torch.float32
                   or not torch.isfinite(out[k]).all() for k in OUTPUTS)):
        raise AssertionError(f"r50 f32: outputs {shapes}, want f32 and finite")
    want = expect(K2=2, K3=4 * K3_WC_CALLS)
    ms = start.elapsed_time(end)
    log(f"r50 f32: one {T}x{H}x{W} clip, f32 outputs finite, shapes "
        f"{list(shapes.values())}; launches {launches} (want {want})")
    log(f"r50 f32 (informational): {ms:.2f} ms per clip ({T / (ms / 1000):.3f} "
        f"frames/s, CUDA events, eager); peak memory {peak:.3f} GiB")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches}")
    del model
    torch.cuda.empty_cache()
    return launches


TRAIN_HW = (713, 713)  # tools/bench_train.py's crops
TRAIN_STEPS = 3
#: bound on max |Function - plain| / max |plain| for each input's gradient
#: of K2's and K3's autograd Functions against autograd of their plain
#: versions, on the card in f32, at the inputs of the first K2 and K3 call
#: of the first training step. Both backward passes are the plain version's
#: VJP on the same inputs; they differ only by the order of the gradient
#: scatters' atomic f32 adds: measured 2.2e-7 (K2's value gradient) and 0
#: for every other input on an NVIDIA H100 80GB HBM3 at 700 W.
TRAIN_GRAD_BOUND = 1e-4
#: the same bound in bf16, where the plain VJP's scatters add bf16 values
#: atomically: 8 bf16 ulps of the gradient's max
TRAIN_GRAD_BOUND_BF16 = 8 * 2.0 ** -8
#: the projections of the MSDA and trajectory layers whose weights must get
#: non-zero gradients
TRAIN_PROJECTIONS = ("self_attn.value_proj.weight",
                     "self_attn.sampling_offsets.weight",
                     "self_attn.attention_weights.weight", "attn.q.weight",
                     "attn.k.weight", "attn.v.weight", "attn.proj_q.weight",
                     "attn.proj_kv.weight")


@contextlib.contextmanager
def first_train_calls(box: dict):
    """While active, the arguments of the first K2 and the first K3 call
    of the WC module's layers are kept in ``box["K2"]`` and ``box["K3"]``
    (detached copies on the card, with each tensor's ``requires_grad``),
    and every call's device and (kernel, first input's dtype) are kept in
    ``box["devices"]`` and ``box["dtypes"]``."""
    import torch

    from axial_vs_tpu_torch.layers import msda_attention, trajectory_attention

    sites = ((msda_attention, "ms_deform_attn", "K2"),
             (trajectory_attention, "trajectory_attention_core", "K3"))
    box["devices"], box["dtypes"] = [], []

    def wrap(real, key):
        def call(*args, **kwargs):
            box["devices"].append(args[0].device.type)
            box["dtypes"].append((key, str(args[0].dtype)[6:]))
            if key not in box:
                box[key] = tuple(
                    _Leaf((a.detach().clone(), a.requires_grad))
                    if torch.is_tensor(a) else a for a in args)
            return real(*args, **kwargs)
        return call

    reals = [getattr(mod, name) for mod, name, _ in sites]
    for (mod, name, key), real in zip(sites, reals):
        setattr(mod, name, wrap(real, key))
    try:
        yield
    finally:
        for (mod, name, _), real in zip(sites, reals):
            setattr(mod, name, real)


class _Leaf(tuple):
    """A captured tensor argument: (tensor, requires_grad)."""


def _function_grads(torch, fn, args, seed):
    """(output, gradients) of ``fn`` at ``args`` (tensors as ``_Leaf``)
    against a seeded N(0, 1) cotangent, by autograd."""
    leaves = [a[0].clone().requires_grad_(a[1]) if isinstance(a, _Leaf) else a
              for a in args]
    wanted = [t for t in leaves if torch.is_tensor(t) and t.requires_grad]
    with torch.enable_grad():
        out = fn(*leaves)
        ct = torch.randn(out.shape, device=out.device,
                         generator=torch.Generator(device=out.device)
                         .manual_seed(seed)).to(out.dtype)
        return out.detach(), torch.autograd.grad(out, wanted, ct)


def _check_train_backward(torch, captured):
    """K2's and K3's autograd Functions against autograd of their plain
    versions at the captured inputs: the forward (kernel against plain;
    f32: ``F32_REL_BOUND`` of max|out|, bf16: 2 bf16 ulp for K2 and
    ``TRAJ_ULPS`` for K3) and each input's gradient, max |diff| / max |ref|
    (``TRAIN_GRAD_BOUND`` in f32, ``TRAIN_GRAD_BOUND_BF16`` in bf16)."""
    from axial_vs_tpu_torch.ops.msda import ms_deform_attn, ms_deform_attn_plain
    from axial_vs_tpu_torch.ops.traj import (TRAJ_ULPS,
                                             trajectory_attention_core,
                                             trajectory_attention_core_plain)

    out = {}
    for key, fn, plain, ulps in (
            ("K2", ms_deform_attn, ms_deform_attn_plain, 2),
            ("K3", trajectory_attention_core, trajectory_attention_core_plain,
             TRAJ_ULPS)):
        got, g_got = _function_grads(torch, fn, captured[key], 7)
        want, g_want = _function_grads(torch, plain, captured[key], 7)
        bf16 = got.dtype == torch.bfloat16
        fwd_bound = (ulps * bf16_ulp(want.float().abs().max().item()) if bf16
                     else f32_bound(want))
        grad_bound = TRAIN_GRAD_BOUND_BF16 if bf16 else TRAIN_GRAD_BOUND
        rel = [((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()
               for a, b in zip(g_got, g_want)]
        out[key] = {"dtype": str(got.dtype)[6:],
                    "forward_max_abs_err":
                        (got.float() - want.float()).abs().max().item(),
                    "forward_bound": fwd_bound, "grad_max_rel_err": rel,
                    "bound": grad_bound,
                    "grad_dtypes": [str(g.dtype)[6:] for g in g_got]}
        log(f"train backward {key} {out[key]['dtype']}: forward |kernel - "
            f"plain| {out[key]['forward_max_abs_err']:.3g} (bound "
            f"{fwd_bound:.3g}); gradients of its {len(rel)} inputs "
            f"({', '.join(out[key]['grad_dtypes'])}), max |Function - "
            f"plain| / max |plain| " + ", ".join(f"{r:.3g}" for r in rel)
            + f"; bound {grad_bound}")
        if not (out[key]["forward_max_abs_err"] <= fwd_bound
                and all(r <= grad_bound for r in rel)
                and all(a.dtype == b.dtype for a, b in zip(g_got, g_want))):
            raise AssertionError(f"train backward {key}: {out[key]}")
    return out


def phase_train_r50_f32(torch, card: str):
    """``TRAIN_STEPS`` steps of the port's ``train_step`` on the R50 WC model
    of ``configs/vipseg/maxtron_wc_r50.yaml`` in f32 at full width and
    depth, on ``tools/bench_train.py``'s batch (713x713, T = 2, one clip,
    24 GT segments). Checks each step's losses, launches and gradients, the
    BatchNorm statistics and the parameters after the first step, and K2's
    and K3's backward at the first step's inputs. Returns the launch counts
    of the steps and the backward check."""
    from axial_vs_tpu_torch.engine.train_step import train_step
    from axial_vs_tpu_torch.tools import bench_train

    dev = torch.device("cuda")
    full_f32(torch)
    t0 = time.perf_counter()
    cfg = bench_train.train_config(TRAIN_HW)
    parts = bench_train.build(cfg, dev)
    model = parts[0]
    batch = bench_train.synthetic_batch(cfg.model.num_classes, TRAIN_HW, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"train r50 f32: built the training model, {n_params} parameters, "
        f"{time.perf_counter() - t0:.2f} s")
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    torch.cuda.reset_peak_memory_stats()
    totals = {k: 0 for k in counted_kernels()}
    captured, ms = {}, []
    for step in range(TRAIN_STEPS):
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with first_train_calls(captured) if step == 0 else contextlib.nullcontext():
            start.record()
            losses = train_step(*parts, batch, gen)
            end.record()
            end.synchronize()
        ms.append(start.elapsed_time(end))
        launches = read_counts()
        for k, v in launches.items():
            totals[k] += v
        want = expect(K2=2, K3=4 * K3_WC_CALLS)
        grads = [p.grad for p in model.parameters()]
        finite = bool(torch.stack([g.isfinite().all() for g in grads]).all())
        flat = {n: p.grad.abs().max().item() for n, p in model.named_parameters()
                if n.endswith(TRAIN_PROJECTIONS)}
        log(f"train r50 f32 step {step}: total_loss {losses['total_loss']:.6g}"
            f", {len(losses) - 1} losses; launches {launches} (want {want}); "
            f"gradients finite {finite}; {len(flat)} MSDA and trajectory "
            f"projection weights, min max|grad| {min(flat.values()):.3g}; "
            f"{ms[-1]:.2f} ms")
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"train step {step}: losses {losses}")
        # 2 MSDA layers x 3 projections; 2 stages x 2 temporal layers x 2
        # axes x 5 trajectory projections
        if launches != want or not finite or len(flat) != 2 * 3 + 8 * 5:
            raise AssertionError(f"train step {step}: launches {launches}, "
                                 f"finite {finite}, {len(flat)} projections")
        if not min(flat.values()) > 0:
            raise AssertionError(f"train step {step}: zero projection grads "
                                 f"{[n for n, v in flat.items() if v == 0]}")
        if step == 0:
            if set(captured["devices"]) != {"cuda"}:  # never on the CPU
                raise AssertionError(f"K2/K3 called on {captured['devices']}")
            moved = [n for n, b in model.named_buffers()
                     if n in stats0 and not torch.equal(b, stats0[n])]
            changed = [n for n, p in model.named_parameters()
                       if not torch.equal(p, params0[n])]
            stuck = [n for n in flat if n not in changed]
            log(f"train r50 f32 step 0: {len(moved)} of {len(stats0)} "
                f"BatchNorm statistics moved; {len(changed)} of "
                f"{len(params0)} parameter tensors changed (all of the "
                f"projections: {not stuck})")
            if len(moved) != len(stats0) or stuck or 2 * len(changed) < len(params0):
                raise AssertionError("train step 0: statistics or parameters "
                                     "did not move")
            del params0, stats0
    peak = torch.cuda.max_memory_allocated() / 2**30
    del parts, model, batch
    torch.cuda.empty_cache()
    backward = _check_train_backward(torch, captured)
    del captured
    torch.cuda.empty_cache()
    med = statistics.median(ms)
    log(f"train r50 f32 ({card}): {TRAIN_STEPS} steps at "
        f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, T={T}, 1 clip, 24 GT segments: ms per "
        f"step {', '.join(f'{t:.2f}' for t in ms)} (median {med:.2f}, "
        f"{1e3 / med:.4f} steps/s, CUDA events, eager, first step included); "
        f"peak memory {peak:.3f} GiB; launches {totals}")
    return totals, backward


@contextlib.contextmanager
def first_auction_call(box: dict):
    """While active, the first ``auction_assign`` call's (cost, valid) are
    kept in ``box["auction"]`` (copies on the card)."""
    from axial_vs_tpu_torch.ops import hungarian

    real = hungarian.auction_assign

    def call(cost, valid, *args, **kwargs):
        box.setdefault("auction", (cost.clone(), valid.clone()))
        return real(cost, valid, *args, **kwargs)

    hungarian.auction_assign = call
    try:
        yield
    finally:
        hungarian.auction_assign = real


#: the auction's largest gap to the optimum of one sample, relative to
#: max(|optimum|, 1): the JAX package's bound (``tests/test_hungarian.py``)
AUCTION_GAP_BOUND = 8e-3


def check_auction(torch, cost, valid) -> dict:
    """The auction's assignment on the card against the same auction on a
    CPU copy (bitwise), checked one-to-one (each valid GT column one query,
    no query twice, invalid columns -1), and its gap to scipy's optimum
    (``lsap_host``) per sample within ``AUCTION_GAP_BOUND``."""
    from axial_vs_tpu_torch.ops.hungarian import auction_assign, lsap_host

    got = auction_assign(cost, valid).cpu()
    want = auction_assign(cost.cpu(), valid.cpu())
    c, v, a = cost.cpu().numpy(), valid.cpu().numpy(), got.numpy()
    best = lsap_host(c, v)
    one_to_one, gaps = True, []
    for i in range(c.shape[0]):
        cols = np.flatnonzero(v[i])
        rows = a[i, cols]
        one_to_one &= bool((a[i, ~v[i]] == -1).all() and (rows >= 0).all()
                           and len(set(rows.tolist())) == len(rows))
        if not one_to_one:
            break
        opt = float(c[i][best[i, cols], cols].sum())
        gaps.append((float(c[i][rows, cols].sum()) - opt) / max(abs(opt), 1.0))
    out = {"equal_to_cpu": bool(torch.equal(got, want)),
           "one_to_one": one_to_one, "gap": max(gaps, default=0.0),
           "valid_columns": int(v.sum())}
    if not (out["equal_to_cpu"] and one_to_one
            and out["gap"] <= AUCTION_GAP_BOUND):
        raise AssertionError(f"auction on the card: {out}")
    return out


def measure_auction(torch, cost, valid, calls: int = 3):
    """The auction on one step's cost matrix: ``check_auction``, then ms a
    call between CUDA events (median of ``calls``, host launch gaps
    included), and one call under ``torch.profiler``: its kernels' count
    and summed device time."""
    from axial_vs_tpu_torch.ops.hungarian import auction_assign

    check = check_auction(torch, cost, valid)
    ms = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        auction_assign(cost, valid)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        auction_assign(cost, valid)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in kernels) / 1e3
    return {"ms": statistics.median(ms), "kernels": len(kernels),
            "kernel_ms": busy, "shape": list(cost.shape), **check}


#: parameter names of the ConvNeXt-L backbone that every step reaches
#: (block 0 of stage 0 has drop-path rate 0; the stem and the output norms)
ALWAYS_REACHED = ("backbone.stem.", "backbone.stages.0.blocks.0.",
                  "backbone.norm")


def phase_train_convnext_large_bf16(torch, card: str):
    """``TRAIN_STEPS`` steps of ``train_step`` on the ConvNeXt-L WC model of
    ``configs/vipseg/maxtron_wc_convnext_large.yaml`` at full depth and
    width: bf16 compute on f32 master weights, drop path 0.4, remat on, the
    device auction, on ``tools/bench_train.py``'s batch (713x713, T = 2,
    one clip, 24 GT segments). Checks each step's losses, launches (K2 and
    K3 in bf16), gradients (every parameter f32 with an f32 gradient,
    finite; non-zero for the MSDA and trajectory projections and for the
    backbone tensors every step reaches), the BatchNorm statistics, and
    K2's and K3's bf16 forward and backward at the first step's inputs.
    One more step runs under the profiler for the parts and the auction's
    device time. Returns the launch counts of the steps and the backward
    check."""
    from axial_vs_tpu_torch.engine.train_step import train_step
    from axial_vs_tpu_torch.tools import bench_train

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = bench_train.train_config(TRAIN_HW, "convnext_large")
    c = cfg.model.backbone
    if not (c.remat and c.convnext.drop_path_rate == 0.4
            and cfg.model.dtype == "bfloat16"
            and tuple(c.convnext.depths) == CONVNEXT_L_DEPTHS):
        raise AssertionError(f"not the headline config: {c}, "
                             f"{cfg.model.dtype}")
    parts = bench_train.build(cfg, dev, "auction")
    model = parts[0]
    batch = bench_train.synthetic_batch(cfg.model.num_classes, TRAIN_HW, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    dtypes = {p.dtype for p in model.parameters()}
    n_params = sum(p.numel() for p in model.parameters())
    log(f"train convnext_large bf16: built the training model, {n_params} "
        f"parameters in {dtypes}, {time.perf_counter() - t0:.2f} s")
    if dtypes != {torch.float32}:
        raise AssertionError(f"master weights not f32: {dtypes}")
    stats0 = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    torch.cuda.reset_peak_memory_stats()
    totals = {k: 0 for k in counted_kernels()}
    captured, ms = {}, []
    for step in range(TRAIN_STEPS):
        box = captured if step == 0 else {}
        unreached = []

        def mark(name):
            if name == "backward":
                unreached.extend(n for n, p in model.named_parameters()
                                 if p.grad is None)

        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with first_train_calls(box), first_auction_call(box):
            start.record()
            losses = train_step(*parts, batch, gen, mark=mark)
            end.record()
            end.synchronize()
        ms.append(start.elapsed_time(end))
        launches = read_counts()
        for k, v in launches.items():
            totals[k] += v
        want = expect(K2=2, K3=4 * K3_WC_CALLS)
        grads = {n: p.grad for n, p in model.named_parameters()}
        finite = bool(torch.stack([g.isfinite().all()
                                   for g in grads.values()]).all())
        grad_dtypes = {g.dtype for g in grads.values()}
        zero = [n for n, g in grads.items()
                if n not in unreached and not g.any()]
        must = [n for n in grads if n.endswith(TRAIN_PROJECTIONS)
                or n.startswith(ALWAYS_REACHED)]
        kernel_dtypes = sorted(set(box["dtypes"]))
        log(f"train convnext_large bf16 step {step}: total_loss "
            f"{losses['total_loss']:.6g}, {len(losses) - 1} losses; launches "
            f"{launches} (want {want}), dtypes {kernel_dtypes}; gradients "
            f"finite {finite}, {grad_dtypes}; {len(unreached)} tensors not "
            f"reached, {len(zero)} reached with an exactly zero gradient; "
            f"{len(must)} always reached; {ms[-1]:.2f} ms")
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"train step {step}: losses {losses}")
        if (launches != want or not finite or grad_dtypes != {torch.float32}
                or kernel_dtypes != [("K2", "bfloat16"), ("K3", "bfloat16")]):
            raise AssertionError(f"train step {step}: launches {launches}, "
                                 f"finite {finite}, {grad_dtypes}, "
                                 f"{kernel_dtypes}")
        dead = [n for n in must if n in unreached or n in zero]
        if dead:
            raise AssertionError(f"train step {step}: no gradient for {dead}")
        if step == 0:
            if set(captured["devices"]) != {"cuda"}:
                raise AssertionError(f"K2/K3 called on {captured['devices']}")
            moved = [n for n, b in model.named_buffers()
                     if n in stats0 and not torch.equal(b, stats0[n])]
            log(f"train convnext_large bf16 step 0: {len(moved)} of "
                f"{len(stats0)} BatchNorm statistics moved")
            if len(moved) != len(stats0):
                raise AssertionError("train step 0: statistics did not move")
            del stats0
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile = bench_train.profile_step(parts, batch, gen)
    auction = measure_auction(torch, *captured.pop("auction"))
    del parts, model, batch
    torch.cuda.empty_cache()
    backward = _check_train_backward(torch, captured)
    del captured
    torch.cuda.empty_cache()
    med = statistics.median(ms)
    log(f"train convnext_large bf16 ({card}): {TRAIN_STEPS} steps at "
        f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, T={T}, 1 clip, 24 GT segments, remat, "
        f"drop path 0.4, auction: ms per step "
        f"{', '.join(f'{t:.2f}' for t in ms)} (median {med:.2f}, "
        f"{1e3 / med:.4f} steps/s, CUDA events, eager, first step included); "
        f"peak memory {peak:.3f} GiB; launches {totals}")
    log(f"train convnext_large bf16, one profiled step ({card}): "
        f"{json.dumps(profile)}")
    log(f"train convnext_large bf16, the auction alone on step 0's cost "
        f"{auction['shape']} ({card}): {auction['ms']:.4f} ms a call between "
        f"CUDA events; {auction['kernels']} kernels, {auction['kernel_ms']:.4f}"
        f" ms of device time (the rest of the call is launch gaps); "
        f"equal to the CPU auction {auction['equal_to_cpu']}, one-to-one "
        f"{auction['one_to_one']} over {auction['valid_columns']} columns, "
        f"gap to scipy's optimum {auction['gap']:.3g} (bound "
        f"{AUCTION_GAP_BOUND})")
    return totals, backward


#: the trainer phase: crop, worker processes, steps, checkpoint step, and
#: frames of each of its two synthetic videos
TRAINER_HW, TRAINER_WORKERS, TRAINER_STEPS, TRAINER_CKPT = (321, 321), 2, 4, 2
TRAINER_FRAMES = (6, 4)


def _trainer_args(root: str, max_iter: int, eval_period: int):
    """``train_net_video``'s arguments: the R50 WC yaml in bf16 at
    ``TRAINER_HW``, one clip a step, ``TRAINER_WORKERS`` workers."""
    opts = {"model.dtype": "bfloat16",
            "input.image_size": f"[{TRAINER_HW[0]},{TRAINER_HW[1]}]",
            "solver.ims_per_batch": 1, "solver.max_iter": max_iter,
            "solver.checkpoint_period": TRAINER_CKPT,
            "dataloader.num_workers": TRAINER_WORKERS,
            "test.eval_period": eval_period,
            "output_dir": os.path.join(root, "out")}
    return (["--config-file", "configs/vipseg/maxtron_wc_r50.yaml", "--opts"]
            + [str(x) for kv in opts.items() for x in kv])


def _states_equal(torch, a: dict, b: dict) -> bool:
    def same(x, y):
        if torch.is_tensor(x):
            return torch.is_tensor(y) and torch.equal(x.cpu(), y.cpu())
        if isinstance(x, dict):
            return (isinstance(y, dict) and x.keys() == y.keys()
                    and all(same(x[k], y[k]) for k in x))
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(map(same, x, y))
        return x == y
    return same(a, b)


def phase_trainer(torch, root: str):
    """The port's ``train_net_video`` entry (the function) on the R50 WC
    yaml in bf16 at ``TRAINER_HW``, over synthetic 720x1280 VIPSeg videos
    registered by ``data/builtin.py``: ``TRAINER_CKPT`` steps with a
    checkpoint, then a fresh ``Trainer`` restores it (the state must equal
    the saved one exactly), then ``--resume`` runs to step
    ``TRAINER_STEPS`` with the eval hook (``evaluate_vipseg`` once, one
    video). Both runs load with ``TRAINER_WORKERS`` worker processes, which
    must stop within the loader's timeout. Returns the launch counts."""
    from axial_vs_tpu_torch.data import builtin
    from axial_vs_tpu_torch.data.synthetic import write_vipseg_videos
    from axial_vs_tpu_torch.engine import evaluator_loop
    from axial_vs_tpu_torch.engine.trainer import LOADER_TIMEOUT_S, Trainer
    from axial_vs_tpu_torch.tools import train_net_video

    t0 = time.perf_counter()
    write_vipseg_videos(os.path.join(root, "VIPSeg"), TRAINER_FRAMES, EVAL_HW,
                        seed=1, splits=("train", "val"))
    names = builtin.register_all(root)
    if names != ["panoVSPW_vps_video_train", "panoVSPW_vps_video_val"]:
        raise AssertionError(f"registered {names}")
    calls = []
    real = evaluator_loop.evaluate_vipseg

    def counted(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    evaluator_loop.evaluate_vipseg = counted
    reset_counts()
    try:
        first = train_net_video.main(_trainer_args(root, TRAINER_CKPT, 0))
        saved = first.state_dict()
        close_s = [first.loader_close_s]
        del first
        fresh = Trainer(train_net_video.setup(train_net_video.parse_args(
            _trainer_args(root, TRAINER_STEPS, TRAINER_STEPS))))
        fresh.resume_or_load(resume=True)
        equal = _states_equal(torch, saved, fresh.state_dict())
        log(f"trainer: the restored state of step {fresh.step} equals the "
            f"saved one: {equal}")
        if not equal or fresh.step != TRAINER_CKPT:
            raise AssertionError("the restored state differs from the saved")
        del fresh, saved
        second = train_net_video.main(
            ["--resume"] + _trainer_args(root, TRAINER_STEPS, TRAINER_STEPS),
            eval_kwargs={"max_videos": 1})
        close_s.append(second.loader_close_s)
    finally:
        evaluator_loop.evaluate_vipseg = real
    launches = read_counts()
    steps = second.ckpt.all_steps()
    clips = TRAINER_FRAMES[0] // T  # the one evaluated video
    want = expect(K2=K2_WC_CALLS * (TRAINER_STEPS + clips),
                  K3=4 * K3_WC_CALLS * (TRAINER_STEPS + clips))
    log(f"trainer: {TRAINER_STEPS} steps at {TRAINER_HW[0]}x{TRAINER_HW[1]} "
        f"in bf16, resumed at step {TRAINER_CKPT}, checkpoints {steps}, "
        f"evaluate_vipseg called {len(calls)} time(s); loaders closed in "
        f"{', '.join(f'{c:.3f}' for c in close_s)} s (timeout "
        f"{LOADER_TIMEOUT_S} s); launches {launches} (want {want}); "
        f"{time.perf_counter() - t0:.1f} s")
    if (second.step != TRAINER_STEPS or steps != [TRAINER_CKPT, TRAINER_STEPS]
            or len(calls) != 1 or launches != want
            or not all(c is not None and c < LOADER_TIMEOUT_S
                       for c in close_s)):
        raise AssertionError("the trainer phase failed its checks")
    del second
    torch.cuda.empty_cache()
    return launches


EVAL_HW = (720, 1280)      # VIPSeg's common frame size
EVAL_LENGTHS = (6, 18)     # frames per video; 18 > 16 takes the windowed path
EVAL_CLIPS = 3 + 8 + 1     # clips of 2: 6 frames; windows of 16 and 2 frames
VIPSEG_CLASSES, VIPSEG_THINGS = 124, 58
EVAL_THING, EVAL_STUFF = 3, 100  # the synthetic videos' categories


def write_vipseg_videos(root: str, seed: int = 0):
    """Synthetic VIPSeg-format videos from a seed, as the repo's test
    fixture draws them (``axial_vs_tpu_torch/data/synthetic.py``): one of
    each of ``EVAL_LENGTHS`` frames at ``EVAL_HW``, and a panoVIPSeg JSON
    with 124 categories (0-57 things, as many as VIPSeg has). Returns the
    roots and the JSON path, and the categories."""
    from axial_vs_tpu_torch.data.synthetic import write_vipseg_videos as write

    return write(root, EVAL_LENGTHS, EVAL_HW, seed, thing=EVAL_THING,
                 stuff=EVAL_STUFF, num_classes=VIPSEG_CLASSES,
                 num_things=VIPSEG_THINGS)


#: share of the pixels on which the card's id map must equal the CPU's: a
#: pixel whose slot probability lies within f32 rounding of the pixel
#: threshold may flip
FINALIZE_AGREEMENT = 0.999


def check_finalize(torch, cfg, model, name: str):
    """The finalize of ``evaluate_vipseg``'s pipeline (resize to the frame
    size, panoptic inference, dataset-id remap) on the card against the
    same pipeline on the CPU, on clip outputs drawn from a seed at the
    eval's sizes: blob-shaped mask logits and 24 slots of a confident class,
    so that segments are accepted, merged and rejected."""
    import torch.nn.functional as F

    from axial_vs_tpu_torch.engine.evaluator_loop import wc_pipeline

    card = wc_pipeline(cfg, model, name)
    host = wc_pipeline(cfg, torch.nn.Linear(1, 1), name)  # only its finalize runs
    g = torch.Generator().manual_seed(8)
    _, n, k = OUTPUT_SHAPES["pred_logits"]
    logits = torch.randn(n, k, generator=g) * 2
    logits[torch.arange(24), torch.randint(0, k - 1, (24,), generator=g)] += 10
    coarse = torch.randn(T, n, 24, 42, generator=g) * 4
    masks = F.interpolate(coarse, size=OUTPUT_SHAPES["pred_masks"][2:4],
                          mode="bilinear").permute(0, 2, 3, 1).contiguous()
    got, _ = card._finalize(logits.cuda(), masks.cuda(), EVAL_HW, EVAL_HW)
    want, _ = host._finalize(logits, masks, EVAL_HW, EVAL_HW)
    got = got.cpu()
    agree = (got == want).double().mean().item()
    segments = [len(torch.unique(ids[ids >= 0])) for ids in (got, want)]
    log(f"eval: finalize of drawn outputs at {T}x{EVAL_HW[0]}x{EVAL_HW[1]}, card "
        f"against CPU: {segments[0]} and {segments[1]} segments, id maps equal "
        f"on {agree:.6f} of the pixels (bound {FINALIZE_AGREEMENT})")
    if tuple(got.shape) != (T,) + EVAL_HW or min(segments) < 3 \
            or not agree >= FINALIZE_AGREEMENT:
        raise AssertionError("the card's finalize disagrees with the CPU's")


def phase_eval(torch, root: str):
    """``evaluate_vipseg`` over the two synthetic videos with the full-size
    model on the fused-block route. Returns the model and the launch
    counts."""
    from PIL import Image

    from axial_vs_tpu_torch.data.vipseg import (register_vipseg_video,
                                                set_panoptic_metadata)
    from axial_vs_tpu_torch.engine.evaluator_loop import evaluate_vipseg
    from axial_vs_tpu_torch.models.kmax import build_segmenter
    from axial_vs_tpu_torch.models.video_inference import WCInferencePipeline

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    paths, categories = write_vipseg_videos(os.path.join(root, "vipseg"))
    name = "chip_smoke_vipseg_val"
    set_panoptic_metadata(register_vipseg_video(name, *paths), categories)
    cfg = wc_convnext_large_config()
    cfg.datasets.test = [name]
    cfg.output_dir = os.path.join(root, "eval_out")
    log(f"eval: wrote {len(EVAL_LENGTHS)} videos of {EVAL_LENGTHS} frames at "
        f"{EVAL_HW[0]}x{EVAL_HW[1]}, {time.perf_counter() - t0:.2f} s")
    model = build_segmenter(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                            num_frames=T, block_kernel="block")
    with torch.inference_mode():
        model(torch.zeros(T, H, W, 3, device=dev))  # warm-up, not counted
    torch.cuda.synchronize()

    # CUDA events around each clip forward and each finalize (informational)
    spans = {"_clip_forward": [], "_finalize": []}
    originals = {k: getattr(WCInferencePipeline, k) for k in spans}

    def timed(key):
        def wrapper(self, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = originals[key](self, *args, **kwargs)
            end.record()
            spans[key].append((start, end))
            return out
        return wrapper

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for key in spans:
        setattr(WCInferencePipeline, key, timed(key))
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = evaluate_vipseg(cfg, model, compute_stq=True)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for key, fn in originals.items():
            setattr(WCInferencePipeline, key, fn)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    forward_ms, finalize_ms = (sum(a.elapsed_time(b) for a, b in spans[k])
                               for k in ("_clip_forward", "_finalize"))

    values = {"vpq": res["vpq"], "stq": res["stq"]["STQ"],
              **{f"vpq@{k}": res["per_window"][k]["all"]["pq"]
                 for k in sorted(res["per_window"])}}
    if set(res["per_window"]) != {1, 2, 4, 6}:
        raise AssertionError(f"windows {sorted(res['per_window'])}")
    for k, v in values.items():
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            raise AssertionError(f"eval: {k} = {v}")
    n_segments = 0
    for v, n_frames in enumerate(EVAL_LENGTHS):
        vdir = os.path.join(cfg.output_dir, "pan_pred", f"video{v}")
        pngs = sorted(p for p in os.listdir(vdir) if p.endswith(".png"))
        maps = [np.asarray(Image.open(os.path.join(vdir, p))) for p in pngs]
        if len(maps) != n_frames or any(m.shape != EVAL_HW + (3,) for m in maps):
            raise AssertionError(f"video{v}: id maps {[m.shape for m in maps]}")
        with open(os.path.join(vdir, "pred.json")) as f:
            n_segments += sum(len(a["segments_info"]) for a in json.load(f)["annotations"])
    frames = sum(EVAL_LENGTHS)
    # at the upstream inits no class passes its threshold, so the id maps
    # above are all void; the finalize is held to the CPU on drawn outputs
    check_finalize(torch, cfg, model, name)
    want = expect(K2=2 * EVAL_CLIPS, K3=4 * K3_WC_CALLS * EVAL_CLIPS,
                  K4=CONVNEXT_L_BLOCKS * EVAL_CLIPS)
    log("eval: " + ", ".join(f"{k} {v:.6g}" for k, v in values.items())
        + f"; id maps ({frames} frames) of {EVAL_HW[0]}x{EVAL_HW[1]}, "
        f"{n_segments} predicted segment-frames")
    log(f"eval: launches in the evaluation: {launches} (want {want})")
    total_ms = start.elapsed_time(end)
    log(f"eval (informational): {frames / wall:.3f} frames/s wall "
        f"({wall:.3f} s; CUDA events {total_ms:.2f} ms), forward "
        f"{forward_ms / EVAL_CLIPS:.2f} ms per clip ({EVAL_CLIPS} clips, "
        f"{forward_ms / total_ms:.3f} of the evaluation), finalize "
        f"{finalize_ms:.2f} ms in {len(spans['_finalize'])} calls "
        f"({finalize_ms / total_ms:.3f} of it), peak memory {peak:.3f} GiB")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches}")
    return model, launches


def phase_mlp_route(torch):
    """One clip through the full-size model built on the K1 + K5 route.
    Returns the model and the launch counts."""
    from axial_vs_tpu_torch.models.kmax import build_segmenter

    dev = torch.device("cuda")
    model = build_segmenter(wc_convnext_large_config(), dev,
                            torch.Generator(device=dev).manual_seed(0),
                            num_frames=T, block_kernel="mlp")
    x = torch.randn(T, H, W, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    with torch.inference_mode():
        model(x)  # warm-up, not counted
        torch.cuda.synchronize()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = model(x)
        end.record()
        end.synchronize()
        launches = read_counts()
    for k, shape in OUTPUT_SHAPES.items():
        v = out[k]
        if tuple(v.shape) != shape or not torch.isfinite(v.float()).all():
            raise AssertionError(f"mlp route {k}: {tuple(v.shape)}, want "
                                 f"{shape}, finite")
    want = expect(K1=CONVNEXT_L_BLOCKS, K2=2, K3=4 * K3_WC_CALLS,
                  K5=CONVNEXT_L_BLOCKS)
    log(f"mlp route: one {T}x{H}x{W} clip, outputs finite, shapes "
        f"{[OUTPUT_SHAPES[k] for k in OUTPUTS]}; launches {launches} (want "
        f"{want}); {start.elapsed_time(end):.2f} ms (informational)")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches}")
    return model, launches


def tube_link_r50_config():
    """The configuration ``tools/bench_tube_link.py`` builds (the repo's
    default config with its overrides, ``:38-44``), from the port's own
    config: ResNet-50, the fused MSDA + axial-trajectory pixel decoder, the
    Mask2Former tube head (100 queries, 9 layers, 256 channels), 40 YTVIS-19
    classes, 5-frame tubes, bf16."""
    from axial_vs_tpu_torch.config import load_config

    return load_config(opts=[
        "model.meta_architecture", "TubeLinkVIS",
        "model.backbone.name", "resnet50", "model.num_classes", 40,
        "model.dtype", "bfloat16", "model.tube_link.clip_len", TL_T,
        "input.num_clip_frames", TL_T])


TL_MASK_HW = (90, 160)  # res2 of 360x640
#: bound on max |card - reference| / max |reference| for the pixel
#: decoder's outputs (mask_feature and the res5/res4/res3 encoder levels),
#: card bf16 against CPU f32. bf16 alone drifts: the plain versions run in
#: bf16 on a CPU were 0.010-0.015 of scale off the f32 run (gamma 0.5), and
#: every run prints that drift beside the card's. The bound leaves about 3x.
TL_REFERENCE_BOUND = 0.05


def phase_tube_link(torch, captured: dict):
    """The Tube-Link R50 VIS path on a 15-frame 360x640 video (3 tubes of
    5) through ``run_video``. Returns the model and the launch counts; the
    warm-up tube's first K2 call's arguments go to
    ``captured["tube-link"]``."""
    from axial_vs_tpu_torch.models.tube_link.detector import (
        TubeLinkVISInference, build_tube_link_vis)

    dev = torch.device("cuda")
    cfg = tube_link_r50_config()
    t0 = time.perf_counter()
    model = build_tube_link_vis(cfg, dev,
                                torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"tube-link: built R50 TubeLinkVIS, {n_params} parameters, "
        f"{time.perf_counter() - t0:.2f} s")
    tl = cfg.model.tube_link
    pipeline = TubeLinkVISInference(model, clip_len=tl.clip_len,
                                    overlap=tl.overlap, topk=tl.test_topk)
    videos = [torch.randn(TL_VIDEO, TL_H, TL_W, 3, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(s))
              for s in (5, 6)]

    with torch.inference_mode():
        t0 = time.perf_counter()
        with first_msda_call(captured, "tube-link"):
            model(videos[0][:TL_T])  # warm-up (cuDNN/cuBLAS selection, allocator)
        torch.cuda.synchronize()
        log(f"tube-link: warm-up tube {time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = pipeline.run_video(videos[0])
        end.record()
        end.synchronize()
        launches = read_counts()
        video_ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated() / 2**30
        other = pipeline.run_video(videos[1])
        # the forward alone, tube after tube (informational)
        tubes = [videos[1][i:i + TL_T] for i in range(0, TL_VIDEO, TL_T)]
        start.record()
        outs = [model(x, return_query=True) for x in tubes]
        end.record()
        end.synchronize()
    tube_ms = start.elapsed_time(end) / len(tubes)

    n_inst = tl.test_topk
    want_shape = (n_inst, TL_VIDEO) + TL_MASK_HW
    for name, r in (("video 1", res), ("video 2", other)):
        if r["masks"].shape != want_shape or not np.isfinite(r["masks"]).all():
            raise AssertionError(f"{name} masks {r['masks'].shape}, want "
                                 f"{want_shape}, finite")
        labels, scores = r["labels"], r["scores"]
        if (labels.shape != (n_inst,) or labels.min() < 0
                or labels.max() >= cfg.model.num_classes
                or not np.isfinite(scores).all()
                or not np.all(scores[:-1] >= scores[1:])):
            raise AssertionError(f"{name}: labels {labels}, scores {scores}")
    for out in outs:
        for k, shape in (("cls_preds", (1, 100, 41)),
                         ("mask_preds", (1, TL_T, 100) + TL_MASK_HW)):
            v = out[k][-1]
            if tuple(v.shape) != shape or v.dtype != torch.bfloat16 or not \
                    torch.isfinite(v.float()).all():
                raise AssertionError(f"tube {k}: {tuple(v.shape)} {v.dtype}")
    if np.array_equal(res["masks"], other["masks"]):
        raise AssertionError("distinct videos gave identical masks")
    want = expect(K2=6 * 3, K3=4 * K3_TL_CALLS * 3)
    log(f"tube-link: {TL_VIDEO}x{TL_H}x{TL_W} video in 3 tubes: {n_inst} "
        f"instances, masks {want_shape} finite, labels in [0, "
        f"{cfg.model.num_classes}), distinct videos give distinct masks")
    log(f"tube-link: launches in the 3-tube run: {launches} (want {want})")
    log(f"tube-link (informational): forward {TL_T / (tube_ms / 1000):.3f} "
        f"frames/s ({tube_ms:.2f} ms per tube, CUDA events, eager); "
        f"run_video {TL_VIDEO / (video_ms / 1000):.3f} frames/s "
        f"({video_ms:.2f} ms for 3 tubes, with the host-side matching); "
        f"peak memory {peak:.3f} GiB")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches}")
    return model, launches


def _pixel_decoder_outputs(model, x):
    mask_feature, levels = model.head.pixel_decoder(model.backbone(x))
    return {"mask_feature": mask_feature,
            **{k: v for k, v in zip(("res5", "res4", "res3"), levels)}}


def phase_tube_link_reference(torch, model):
    """A 5x96x160 tube through a copy of the model on the card (bf16,
    kernels) and in f32 on the CPU (the plain versions). In the copy the
    pixel decoder's gammas (1e-6 at init) are set to 0.5, so that K3's
    branch reaches the outputs. The head's outputs pass a sigmoid < 0.5
    threshold, where bf16 may flip single mask bits, so they are checked
    for shape and finiteness only."""
    import copy

    from axial_vs_tpu_torch.models.tube_link.pixel_decoder import (
        FusedMSDATrajectoryAttention)

    dev = torch.device("cuda")
    card_model = copy.deepcopy(model)
    with torch.no_grad():
        for m in card_model.modules():
            if isinstance(m, FusedMSDATrajectoryAttention):
                m.gamma.fill_(0.5)
    ref_model = copy.deepcopy(card_model).float().cpu()
    bf16_model = copy.deepcopy(card_model).cpu()
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(TL_T, 96, 160, 3, generator=g, device=dev)
    with torch.inference_mode():
        got = _pixel_decoder_outputs(card_model, x.bfloat16())
        head = card_model(x, return_query=True)
        want = _pixel_decoder_outputs(ref_model, x.cpu())
        cpu_bf16 = _pixel_decoder_outputs(bf16_model, x.cpu().bfloat16())
    for k in ("cls_preds", "mask_preds", "query"):
        for v in (head[k] if isinstance(head[k], list) else [head[k]]):
            if not torch.isfinite(v.float()).all():
                raise AssertionError(f"tube-link reference: {k} not finite")

    def rel(a, b):
        if a.shape != b.shape:
            raise AssertionError(f"{a.shape} != {b.shape}")
        return ((a.float().cpu() - b).abs().max()
                / b.abs().max().clamp_min(1e-6)).item()

    worst = {k: rel(got[k], want[k]) for k in want}
    drift = {k: rel(cpu_bf16[k], want[k]) for k in want}
    log("tube-link reference (5x96x160 tube, gamma 0.5, card bf16 vs CPU "
        "f32 plain versions): max |diff| / max |ref| " + ", ".join(
            f"{k} {v:.4g}" for k, v in worst.items())
        + f"; bound {TL_REFERENCE_BOUND}; CPU bf16 plain versions vs the "
        "same f32 run: " + ", ".join(f"{k} {v:.4g}" for k, v in drift.items()))
    for k, v in worst.items():
        if not v <= TL_REFERENCE_BOUND:
            raise AssertionError(f"tube-link reference {k}: {v:.4g} > "
                                 f"{TL_REFERENCE_BOUND}")


#: bounds of the MSDA bench's variants against ``prod`` (K2), in bf16 ulps
#: of max|prod|. K2 rounds nothing before its f32 sum; the table variants
#: round each slot weight (bilinear times attention weight) to bf16, and
#: ``pallas_v3`` each product too; ``sample_loop`` accumulates 12 samples
#: in bf16. ``giant_gather_only`` sums unweighted rows: not the op's value.
MSDA_BENCH_ULPS = {"pallas_v3": 4, "pallas_v4": 4, "pallas_v5": 4,
                   "sample_loop": 16}
#: launches of one checking pass over the six variants: prod runs K2; the
#: five table variants K8 once per level; v3 K6; v4 and v5 K7 once each
MSDA_BENCH_LAUNCHES = {"K2": 1, "K6": 1, "K7": 2, "K8": 15}


def _reduce_cases(torch, gen, bm):
    """K6 and K7 inputs: the bench's own gathered rows at the WC shape, and
    random rows at a ragged shape (R no multiple of 32, N = 6 samples in
    L = 2 levels of P = 3, D = 40). Yields (name, samples, merged, w)."""
    args = (*bm.build_inputs(np.random.RandomState(0), device="cuda"),
            bm.SHAPES)
    flat, idx, wgt = bm.table(*args)
    samples = bm.sample_gathers(flat, idx)
    merged_gathers = lambda: bm.level_gathers(  # noqa: E731  (pallas_v5's)
        flat, idx, len(bm.SHAPES), bm.P)
    log("msda bench parts at the WC shape (informational, CUDA events): "
        f"_prep (3 K8 launches, the cat, indices and weights) "
        f"{cuda_ms(torch, lambda: bm.table(*args), launches=3):.4f} ms; "
        f"{len(samples)} sample gathers "
        f"{cuda_ms(torch, lambda: bm.sample_gathers(flat, idx), launches=3):.4f}"
        f" ms; {len(bm.SHAPES)} merged gathers "
        f"{cuda_ms(torch, merged_gathers, launches=3):.4f} ms")
    merged = [torch.cat(samples[lvl * bm.P:(lvl + 1) * bm.P], dim=1)
              for lvl in range(len(bm.SHAPES))]
    yield "wc", samples, merged, wgt
    del samples, merged
    r, n, p, d = 1001, 6, 3, 40
    samples = [torch.randn(r, 4 * d, generator=gen, device="cuda").bfloat16()
               for _ in range(n)]
    w = torch.randn(r, 4 * n, generator=gen, device="cuda").bfloat16()
    yield "ragged", samples, [torch.cat(samples[i:i + p], dim=1)
                              for i in range(0, n, p)], w


def phase_msda_bench(torch, gen):
    """The MSDA bench at the WC shape (``bench_msda.run``): one checking pass
    over its six formulations, counted, each held to ``prod`` within
    ``MSDA_BENCH_ULPS``; then each variant's ms per layer. K6 and K7 are
    held to their plain versions within 1 bf16 ulp of max|out| (both sum the
    same terms in f32 in the same order) and K8 bitwise, at the WC shape and
    a ragged one. Returns the checking pass's launch counts, K6-K8's
    result dicts and each variant's ms per layer."""
    from axial_vs_tpu_torch.ops.msda import level_start_index
    from axial_vs_tpu_torch.ops.msda_reduce import (
        pack_corner_table, pack_corner_table_plain,
        weighted_corner_reduce_multi, weighted_corner_reduce_multi_plain,
        weighted_corner_reduce_v5, weighted_corner_reduce_v5_plain)
    from axial_vs_tpu_torch.tools import bench_msda as bm
    from axial_vs_tpu_torch.tools.timing import graph_ms

    shape = (f"levels {bm.SHAPES}, B={bm.B} M={bm.M} D={bm.D} P={bm.P}, "
             f"{bm.B * bm.M * sum(h * w for h, w in bm.SHAPES)} rows")
    reset_counts()
    checked = bm.run(iters=0)
    launches = read_counts()
    scale = checked["prod"]["max_abs"]
    for name, r in checked.items():
        ulps = MSDA_BENCH_ULPS.get(name)
        bound = None if ulps is None else ulps * bf16_ulp(scale)
        log(f"msda bench {name}: max |diff| vs prod {r['max_abs_diff']:.6g} "
            + (f"(bound {ulps} bf16 ulp of max|prod| {scale:.4g} = {bound:.6g})"
               if bound is not None else "(not compared)")
            + f"; launches {r['launches']}")
        if bound is not None and not r["max_abs_diff"] <= bound:
            raise AssertionError(f"msda bench {name} disagrees with prod")
    want = expect(**MSDA_BENCH_LAUNCHES)
    log(f"msda bench: launches in the checking pass: {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches}")
    timed = bm.run(iters=20)
    for name, r in timed.items():
        log(f"msda bench {name}: {r['ms']:.4f} ms per layer ({shape}; CUDA "
            "events over 20 calls)")

    results = {}
    for case, samples, merged, w in _reduce_cases(torch, gen, bm):
        r, d = samples[0].shape[0], samples[0].shape[1] // 4
        p = merged[0].shape[1] // (4 * d)
        kernels = {
            "K6": (lambda: weighted_corner_reduce_multi(samples, w),
                   lambda: weighted_corner_reduce_multi_plain(samples, w)),
            "K7": (lambda: weighted_corner_reduce_v5(samples, w, 1),
                   lambda: weighted_corner_reduce_v5_plain(samples, w, 1)),
            "K7 p": (lambda: weighted_corner_reduce_v5(merged, w, p),
                     lambda: weighted_corner_reduce_v5_plain(merged, w, p)),
        }
        times = {}
        for key, (kernel, plain) in kernels.items():
            got, want_out = kernel(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want_out.float()).abs().max().item()
            bound = bf16_ulp(want_out.float().abs().max().item())
            log(f"{key}{'=' + str(p) if key == 'K7 p' else ''} {case} (R={r}, "
                f"N={len(samples)}, D={d}): max_abs_err {err:.6g} (bound 1 "
                f"bf16 ulp of max|out| = {bound:.6g})")
            if not err <= bound:
                raise AssertionError(f"{key} disagrees on the {case} case")
            if case == "wc":
                times[key] = (err, cuda_ms(torch, kernel),
                              cuda_ms(torch, plain, launches=3),
                              graph_ms(kernel, "cuda", 10))
        if case != "wc":
            continue
        # each input read once, the output written once; a multiply and an
        # add per gathered element on the CUDA cores
        nbytes = (sum(g.numel() for g in samples) + w.numel() + r * d) * 2
        flops = 2 * sum(g.numel() for g in samples)
        bound, by = bound_ms(0, nbytes, PEAK_BF16, flops)
        stacked = torch.stack(samples, dim=1).reshape(r, len(samples), 4, d)
        w3 = w.reshape(r, len(samples), 4)
        lib = lambda: torch.einsum("rnkd,rnk->rd", stacked, w3)  # noqa: E731
        lib_err = (lib().float() - kernels["K7"][1]().float()).abs().max().item()
        lib_ms = cuda_ms(torch, lib)
        lib_graph_ms = graph_ms(lib, "cuda", 10)
        del stacked
        log(f"MSDA reduce at the WC shape, per call (CUDA graph in brackets): "
            f"K6 {times['K6'][1]:.4f} ({times['K6'][3]:.4f}) ms (plain "
            f"{times['K6'][2]:.4f}), K7 p=1 {times['K7'][1]:.4f} "
            f"({times['K7'][3]:.4f}) ms (plain {times['K7'][2]:.4f}), K7 p={p} "
            f"{times['K7 p'][1]:.4f} ({times['K7 p'][3]:.4f}) ms (plain "
            f"{times['K7 p'][2]:.4f}); bound {bound:.4f} ms ({by}, "
            f"{nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP f32); library "
            f"call einsum('rnkd,rnk->rd') on pre-stacked rows {lib_ms:.4f} "
            f"({lib_graph_ms:.4f}) ms, max |diff| {lib_err:.6g} against K7's "
            "plain version")
        for key, t in (("K6", times["K6"]), ("K7", times["K7"])):
            results[key] = {"max_abs_err": t[0], "ms": t[1], "plain_ms": t[2],
                            "graph_ms": t[3], "bound_ms": bound, "bound_by": by,
                            "library_ms": lib_ms, "library_graph_ms": lib_graph_ms,
                            "library_err": lib_err, "per": "MSDA layer (1 call)"}
        results["K7"].update(p4_ms=times["K7 p"][1], p4_plain_ms=times["K7 p"][2],
                             p4_graph_ms=times["K7 p"][3],
                             max_abs_err=max(times["K7"][0], times["K7 p"][0]))
    del samples, merged, w

    # K8 on each level's slice of the whole value (batch rows apart), as
    # _prep calls it, beside one advanced-index gather (bm.corner_gather),
    # eager and in CUDA graphs; then bitwise at a ragged pair of levels
    levels = bm.pack_levels(iters=20)
    for level, r in levels.items():
        if not (r["equal"] and r["library_equal"]):
            raise AssertionError(f"K8 or the library gather differs from the "
                                 f"roll build at {level}")
    value, _, _ = bm.build_inputs(np.random.RandomState(0), device="cuda")
    v = value.reshape(value.shape[0], value.shape[1], -1)
    plain_ms = sum(
        cuda_ms(torch, lambda st=st, h=h, w=w: pack_corner_table_plain(
            v[:, st:st + h * w], w, bm.M), launches=3)
        for (h, w), st in zip(bm.SHAPES, level_start_index(bm.SHAPES)))
    layer = levels.pop("layer")
    bound, by = bound_ms(0, layer["nbytes"], PEAK_BF16)
    for level, r in levels.items():
        log(f"K8 level {level}: bitwise equal to the roll build and to the "
            f"library gather; kernel {r['ms']:.4f} ms, {r['graph_ms']:.4f} in "
            f"a CUDA graph; library {r['library_ms']:.4f} ms, "
            f"{r['library_graph_ms']:.4f} in a graph; bound "
            f"{bound_ms(0, r['nbytes'], PEAK_BF16)[0]:.4f} ms "
            f"({r['nbytes'] / 1e6:.2f} MB)")
    log(f"K8 per layer (3 calls): kernel {layer['ms']:.4f} ms, "
        f"{layer['graph_ms']:.4f} in CUDA graphs ({bound / layer['graph_ms']:.3f}"
        f" of the bound); plain (the roll + cat chain) {plain_ms:.4f} ms; "
        f"library call (one advanced-index gather, bitwise equal) "
        f"{layer['library_ms']:.4f} ms, {layer['library_graph_ms']:.4f} in "
        f"graphs; bound {bound:.4f} ms ({by}, {layer['nbytes'] / 1e6:.2f} MB)")
    results["K8"] = {"max_abs_err": 0.0, "ms": layer["ms"],
                     "graph_ms": layer["graph_ms"], "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": layer["library_ms"],
                     "library_graph_ms": layer["library_graph_ms"],
                     "per": "MSDA layer (3 calls)",
                     "levels": {k: {t: r[t] for t in ("ms", "graph_ms",
                                                      "library_ms",
                                                      "library_graph_ms")}
                                for k, r in levels.items()}}
    ragged = torch.randn(2, 5 * 517 + 12, 3 * 40, generator=gen,
                         device="cuda").bfloat16()
    start = 0
    for h, w in ((5, 517), (3, 4)):
        vl = ragged[:, start:start + h * w]
        start += h * w
        got = pack_corner_table(vl, w, 3)
        want_out = pack_corner_table_plain(vl, w, 3)
        torch.cuda.synchronize()
        if not torch.equal(got, want_out):
            raise AssertionError(f"K8 differs from the roll build at level "
                                 f"{(h, w)} (ragged)")
    log("K8 ragged levels ((5, 517), (3, 4)), M=3, D=40: bitwise equal to the "
        "roll build")
    del value, v, ragged
    torch.cuda.empty_cache()
    return launches, {k: results[k] for k in ("K6", "K7", "K8")}, {
        name: r["ms"] for name, r in timed.items()}


#: timed calls of each probe variant in the probes phase (after its checking
#: call and one warm-up)
PROBE_ITERS = 10
#: P1's two stages (the JAX tool's defaults) and its eight kernel variants
PROBE_STAGES = ("stage0", "stage2")


def _probe_p4(torch, bw):
    """P4 at its defaults: copy and sum12 at 338,688 rows, then the gather
    over the JAX tool's four tables; all bitwise equal to the plain
    versions. Returns the P4 entries."""
    streams = bw.run(iters=PROBE_ITERS)
    tables = bw.run(iters=PROBE_ITERS, gather=True)
    for name, r in {**streams, **tables}.items():
        log(f"P4 {name}: max_abs_err {r['max_abs_diff']:.6g} (bitwise); "
            f"kernel {r['ms']:.4f} ms, {r['graph_ms']:.4f} in a CUDA graph "
            f"({r['nbytes'] / r['graph_ms'] / 1e6:.1f} GB/s), plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f} "
            f"({r['library_graph_ms']:.4f} in a graph)"
            + (f", {r['elems'] / r['graph_ms'] / 1e6:.2f} G elems/s"
               if "elems" in r else ""))
        if r["max_abs_diff"] != 0 or (r["library_diff"] not in (None, 0.0)):
            raise AssertionError(f"P4 {name} differs from its plain version")
    entries = {}
    for key, r, per in (("P4-copy", streams["copy"], "338,688 x 128 bf16"),
                        ("P4-sum12", streams["sum12"],
                         "12 arrays of 338,688 x 128 bf16"),
                        ("P4-gather", tables["S=16384 float32"],
                         "S=16384 f32 table, (16384, 128) int32 indices")):
        bound, by = bound_ms(0, r["nbytes"], PEAK_BF16)
        entries[key] = {"max_abs_err": r["max_abs_diff"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": bound,
                        "bound_by": by, "library_ms": r["library_ms"],
                        "graph_ms": r["graph_ms"],
                        "library_graph_ms": r["library_graph_ms"], "per": per}
    entries["P4-sum12"]["library"] = "eager chain of 11 bf16 torch.add"
    shares = {k: bound_ms(0, r["nbytes"], PEAK_BF16)[0] / r["graph_ms"]
              for k, r in tables.items()}
    entries["P4-gather"].update(
        tables_graph_ms={k: r["graph_ms"] for k, r in tables.items()},
        tables_library_graph_ms={k: r["library_graph_ms"]
                                 for k, r in tables.items()},
        tables_bound_share=shares)
    log("P4 share of the bound (CUDA graph): " + ", ".join(
        f"{k} {e['bound_ms'] / e['graph_ms']:.3f}" for k, e in entries.items())
        + "; the gather at each table: " + ", ".join(
            f"{k} {v:.3f}" for k, v in shares.items()))
    log("P4 gather against torch.gather, both in CUDA graphs: " + ", ".join(
        f"{k} {r['graph_ms']:.4f} vs {r['library_graph_ms']:.4f} ms "
        f"({'no slower' if r['graph_ms'] <= r['library_graph_ms'] else 'SLOWER'})"
        for k, r in tables.items()))
    return entries


#: P4's copy of one kmax_l0 slab (16128 x 128 bf16, 4.13 MB) that reads the
#: card's L2 rate: L2 holds it and its output across the back-to-back calls
#: of a CUDA graph, L2_RATE_ITERS of them. A copy of twice the rows, still
#: in L2, gives the marginal rate, without the fixed cost of a launch.
L2_RATE_ROWS, L2_RATE_ITERS = 16128, 50


def _l2_rate(torch, bw):
    """(bytes a ms, ms a call, marginal bytes a ms): this card's L2 rate,
    P4's ``scale_copy`` of ``L2_RATE_ROWS`` rows in a CUDA graph, the bytes
    it reads and writes over its time; and the extra bytes of a copy of
    twice the rows over its extra time. Each copy is checked bitwise
    against its plain version first and counts ``L2_RATE_ITERS`` + 2 P4-copy
    launches (check, warm-up, captured)."""
    from axial_vs_tpu_torch.tools.timing import graph_ms

    rng = np.random.RandomState(0)
    ms, nbytes = [], []
    for rows in (L2_RATE_ROWS, 2 * L2_RATE_ROWS):
        x = torch.from_numpy(rng.randn(rows, 128).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        if not torch.equal(bw.scale_copy(x), bw.scale_copy_plain(x)):
            raise AssertionError(f"P4 copy differs from its plain version at "
                                 f"{rows} rows")
        ms.append(graph_ms(lambda: bw.scale_copy(x), "cuda", L2_RATE_ITERS))
        nbytes.append(2 * x.numel() * x.element_size())
    return (nbytes[0] / ms[0], ms[0],
            (nbytes[1] - nbytes[0]) / (ms[1] - ms[0]) if ms[1] > ms[0] else None)


def _probe_p2(torch, vg, bw):
    """P2 at tube_l0 and kmax_l0: xla (the plain version) and the kernel with
    1, 4 and 8 query rows a group, each within 1 bf16 ulp of xla (bitwise
    expected); each variant's share of the byte bound and of the L2 floor
    (the rows read over the L2 rate of ``_l2_rate``), eager and in graphs;
    ``embedding_bag`` beside them at kmax_l0."""
    res = vg.run(iters=PROBE_ITERS)
    rate, copy_ms, marginal = _l2_rate(torch, bw)
    log(f"P2 L2 rate: P4 copy of {L2_RATE_ROWS} x 128 bf16 "
        f"({2 * L2_RATE_ROWS * 128 * 2 / 1e6:.2f} MB read + written) "
        f"{copy_ms:.4f} ms in a CUDA graph of {L2_RATE_ITERS} calls: "
        f"{rate / 1e9:.3f} TB/s, a launch's fixed cost included; marginal "
        f"rate from a copy of twice the rows: "
        + (f"{marginal / 1e9:.3f} TB/s" if marginal else "not measured")
        + " (the L2 floor below uses the first)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bounds, floors = {}, {}
    for shape, by_variant in res.items():
        s, nq, p, _ = vg.SHAPES[shape]
        bounds[shape] = bound_ms(0, vg.nbytes(s, nq, p), PEAK_BF16,
                                 2 * nq * p * 128)
        floors[shape] = vg.row_bytes(nq, p) / rate
        log(f"P2 {shape} (S={s}, NQ={nq}, P={p}): byte bound "
            f"{bounds[shape][0]:.4f} ms ({vg.nbytes(s, nq, p) / 1e6:.2f} MB at "
            f"{PEAK_BYTES / 1e12:.2f} TB/s, {bounds[shape][1]}); L2 floor "
            f"{floors[shape]:.4f} ms ({vg.row_bytes(nq, p) / 1e6:.2f} MB of "
            f"rows at the L2 rate)")
        for variant, r in by_variant.items():
            kind = "bitwise" if r["max_abs_diff"] == 0 else "NOT bitwise"
            line = (f"P2 {shape} {variant}: max |diff| vs xla "
                    f"{r['max_abs_diff']:.6g} ({kind}; bound 1 bf16 ulp = "
                    f"{r['bound']:.6g}); {r['ms']:.4f} ms, {r['graph_ms']:.4f} "
                    f"in a CUDA graph ({r['points'] / r['graph_ms'] / 1e3:.0f} "
                    f"M rows/s)")
            if variant != "xla":
                u = int(variant.split("_u")[1])
                threads, blocks = vg.launch_shape(nq, u, p, sms)
                line += (f"; {threads} threads x {blocks} blocks on {sms} SMs; "
                         f"share of the byte bound {bounds[shape][0] / r['ms']:.3f}"
                         f" ({bounds[shape][0] / r['graph_ms']:.3f} in a graph), "
                         f"of the L2 floor {floors[shape] / r['graph_ms']:.3f} "
                         f"in a graph")
            log(line)
            if not r["max_abs_diff"] <= r["bound"]:
                raise AssertionError(f"P2 {variant} disagrees at {shape}")
    kmax = res["kmax_l0"]
    kernel = [kmax[v] for v in ("pl_u1", "pl_u4", "pl_u8")]
    s, nq, p, _ = vg.SHAPES["kmax_l0"]
    bound, by = bounds["kmax_l0"]
    mean_graph = statistics.mean(r["graph_ms"] for r in kernel)
    log(f"P2 kmax_l0 kernel, mean of pl_u1/u4/u8: {mean_graph:.4f} ms in a "
        f"graph, {bound / mean_graph:.3f} of its byte bound ("
        + ("at least" if bound / mean_graph >= 0.5 else "under")
        + f" half), {floors['kmax_l0'] / mean_graph:.3f} of its L2 floor")
    # the same weighted gather as one library call: embedding_bag over bags
    # of P rows, the weights cast to the slab's dtype (the call takes them in
    # the weight's dtype)
    from axial_vs_tpu_torch.tools.timing import graph_ms

    idx, w, slab = vg.build_inputs(np.random.RandomState(0), s, nq, p,
                                   device="cuda")
    wb = w.to(slab.dtype)
    lib = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
        idx, slab, mode="sum", per_sample_weights=wb)
    try:
        lib_err = (lib().float() - vg.slab_gather_plain(idx, w, slab).float()
                   ).abs().max().item()
    except RuntimeError as refused:  # the yardstick only; no kernel's check
        lib_ms = lib_graph_ms = lib_err = None
        log(f"P2 library call embedding_bag refused bf16 on torch "
            f"{torch.__version__}: {refused}")
    else:
        lib_ms, lib_graph_ms = cuda_ms(torch, lib), graph_ms(lib, "cuda",
                                                            PROBE_ITERS)
        log(f"P2 kmax_l0 library call embedding_bag(mode='sum', bf16 "
            f"per_sample_weights): {lib_ms:.4f} ms, {lib_graph_ms:.4f} in a "
            f"CUDA graph, max |diff| {lib_err:.6g} from slab_gather_plain; the "
            f"kernel (mean of pl_u1/u4/u8) {mean_graph:.4f} in a graph")
    del idx, w, slab, wb
    return {"max_abs_err": max(r["max_abs_diff"] for r in kernel),
            "ms": statistics.mean(r["ms"] for r in kernel),
            "plain_ms": kmax["xla"]["ms"], "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms, "library_graph_ms": lib_graph_ms,
            "library_err": lib_err,
            "library": "embedding_bag(mode='sum', per_sample_weights in bf16)",
            "graph_ms": mean_graph,
            "plain_graph_ms": kmax["xla"]["graph_ms"],
            "l2_rate_tbs": rate / 1e9, "l2_floor_ms": floors["kmax_l0"],
            "l2_marginal_tbs": marginal and marginal / 1e9,
            "per": "one kmax_l0 call (S=16128, NQ=21168, P=4), mean of "
                   "pl_u1/u4/u8",
            "tube_l0": {"bound_ms": bounds["tube_l0"][0],
                        "l2_floor_ms": floors["tube_l0"],
                        "plain_ms": res["tube_l0"]["xla"]["ms"]},
            "variants_ms": {shape: {v: r["ms"] for v, r in rv.items()}
                            for shape, rv in res.items()},
            "variants_graph_ms": {shape: {v: r["graph_ms"]
                                          for v, r in rv.items()}
                                  for shape, rv in res.items()}}


def _probe_p1(torch, dv):
    """P1 at stages 0 and 2: K1 (``ship``, its taps made once a stage) and
    the 8 variants, each against its plain version (1 bf16 ulp; K1 2), with
    the plain versions' times at stage 0, and noln's function as one library
    call (a depthwise ``conv2d``) beside noln at both stages, eager and in
    CUDA graphs. The kernels-line entry is noln at stage 0."""
    from axial_vs_tpu_torch.tools.timing import graph_ms

    res = dv.run(stages=PROBE_STAGES, iters=PROBE_ITERS)
    for stage, by_variant in res.items():
        for variant, r in by_variant.items():
            vs_ship = ("--" if r["diff_vs_ship"] is None
                       else f"{r['diff_vs_ship']:.6g}")
            log(f"P1 {stage} {variant}: max_abs_err {r['max_abs_diff']:.6g} "
                f"(bound {r['bound']:.6g}), vs ship {vs_ship}; {r['ms']:.4f} ms"
                f", {r['graph_ms']:.4f} in a CUDA graph "
                f"({r['flops'] / r['graph_ms'] / 1e9:.2f} TFLOP/s)")
            if not r["max_abs_diff"] <= r["bound"]:
                raise AssertionError(f"P1 {variant} disagrees at {stage}")
    library, plain, bounds = {}, {}, {}
    for stage in PROBE_STAGES:
        shape = dv.STAGES[stage]
        args = dv.build_inputs(np.random.RandomState(0), shape, "cuda")
        if stage == "stage0":
            plain = {v: cuda_ms(torch, lambda v=v: dv.plain_version(v)(*args),
                                launches=2, repeats=1) for v in dv.VARIANTS}
        # the noln function as one library call: a depthwise conv2d on the
        # channels-last view (cuDNN, bf16 out)
        x_nchw = args[0].permute(0, 3, 1, 2)
        conv = lambda: torch.nn.functional.conv2d(  # noqa: E731
            x_nchw, args[1], args[2].bfloat16(), padding=3, groups=shape[3])
        err = (conv().permute(0, 2, 3, 1).float() - dv.plain_version("noln")(
            *args).float()).abs().max().item()
        library[stage] = (cuda_ms(torch, conv), graph_ms(conv, "cuda", PROBE_ITERS),
                          err)
        elems = math.prod(shape)
        bounds[stage] = bound_ms(0, 4 * elems + shape[3] * (49 * 2 + 12),
                                 PEAK_BF16, 2 * 49 * elems)
        noln = res[stage]["noln"]
        log(f"P1 {stage} {shape}: noln {noln['ms']:.4f} ms, "
            f"{noln['graph_ms']:.4f} in a CUDA graph, against the library call "
            f"conv2d (noln's function) {library[stage][0]:.4f} ms, "
            f"{library[stage][1]:.4f} in a graph (max |diff| {err:.6g} from "
            f"noln's plain version); ship {res[stage]['ship']['graph_ms']:.4f} "
            f"in a graph; bound {bounds[stage][0]:.4f} ms ({bounds[stage][1]})")
        del args, x_nchw
    log("P1 stage0 plain versions: " + ", ".join(
        f"{v} {t:.2f}" for v, t in plain.items()) + " ms")
    from axial_vs_tpu_torch.ops import native

    mix = dv.instruction_mix(native.build_info["path"])
    for variant, counts in (mix or {}).items():
        log(f"P1 {variant} SASS (static: instructions in the code, a loop "
            "counted once): " + ", ".join(f"{k} {n}" for k, n in counts.items()))
    if mix is None:
        log("P1 SASS census: not measured (no cuobjdump beside nvcc)")
    noln = res["stage0"]["noln"]
    return {"max_abs_err": max(r["max_abs_diff"] for rv in res.values()
                               for v, r in rv.items() if v != "ship"),
            "ms": noln["ms"], "graph_ms": noln["graph_ms"],
            "plain_ms": plain["noln"], "bound_ms": bounds["stage0"][0],
            "bound_by": bounds["stage0"][1],
            "library_ms": library["stage0"][0],
            "library_graph_ms": library["stage0"][1],
            "library": "depthwise conv2d, noln's function",
            "per": f"one stage-0 noln call {dv.STAGES['stage0']}",
            "stage2": {"ms": res["stage2"]["noln"]["ms"],
                       "graph_ms": res["stage2"]["noln"]["graph_ms"],
                       "library_ms": library["stage2"][0],
                       "library_graph_ms": library["stage2"][1],
                       "bound_ms": bounds["stage2"][0]},
            "instruction_mix": mix,
            "variants_ms": {stage: {v: r["ms"] for v, r in rv.items()}
                            for stage, rv in res.items()},
            "variants_graph_ms": {stage: {v: r["graph_ms"]
                                          for v, r in rv.items()}
                                  for stage, rv in res.items()}}


def _probe_p3(torch, ov):
    """P3 at its defaults (27 tiles of (672, 768)): vpu, mxu, both and
    interleave against the plain versions, the overlap efficiency, and the
    mxu work's library call, eager and in a CUDA graph."""
    from axial_vs_tpu_torch.tools.timing import graph_ms

    res = ov.run(iters=PROBE_ITERS)
    summary = res.pop("summary")
    for name, r in res.items():
        log(f"P3 {name}: " + ", ".join(
            f"{k} max |diff| {d:.6g} (bound {r['bound'][k]:.6g})"
            for k, d in r["diff"].items())
            + f"; {r['ms']:.4f} ms, {r['graph_ms']:.4f} in a CUDA graph")
        if not r["ok"]:
            raise AssertionError(f"P3 {name} disagrees with its plain version")
    x, t, w1, w2 = ov.build_inputs(np.random.RandomState(0), device="cuda")
    lib = ov.library_mxu(t, w1, w2)
    want = ov.mxu_work(t, w1, w2).float()
    lib_err = (lib().float() - want).abs().max().item()
    lib_ms = cuda_ms(torch, lib)
    lib_graph_ms = graph_ms(lib, "cuda", PROBE_ITERS)
    plain = {"P3-vpu": lambda: ov.overlap_vpu_plain(x),
             "P3-mxu": lambda: ov.overlap_mxu_plain(t, w1, w2),
             "P3-both": lambda: ov.overlap_both_plain(x, t, w1, w2),
             "P3-interleave": lambda: ov.overlap_interleave_plain(x, t, w1, w2)}
    mxu_flops, vpu_flops = ov.flops()
    # bytes read once and written once: the mxu kernels read the (27 x 672,
    # 768) copy of t that mxu_operands makes, and the two weights
    out_bytes = 2 * ov.TILES * x.numel()
    mxu_bytes = (2 * ov.TILES * t.numel() + 2 * (w1.numel() + w2.numel())
                 + out_bytes)
    bounds = {"P3-vpu": bound_ms(0, 2 * x.numel() + out_bytes, PEAK_BF16,
                                 vpu_flops),
              "P3-mxu": bound_ms(mxu_flops, mxu_bytes, PEAK_BF16),
              "P3-both": bound_ms(mxu_flops, mxu_bytes + 2 * x.numel()
                                  + out_bytes, PEAK_BF16, vpu_flops)}
    bounds["P3-interleave"] = bounds["P3-both"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row_tiles = -(-ov.TILES * ov.TOKENS // 128)  # the GEMM core's 128-row tiles
    gemm_tiles = (row_tiles * -(-4 * ov.C // 128), row_tiles * -(-ov.C // 192))
    tv, tm, tb = (res[k]["graph_ms"] for k in ("vpu", "mxu", "both"))
    graph_efficiency = (tv + tm - tb) / min(tv, tm)  # run()'s definition
    log(f"P3 on {sms} SMs, {ov.TILES} tiles: sum={summary['sum']:.4f}  "
        f"max={summary['max']:.4f}  both={summary['both']:.4f}  "
        f"overlap_efficiency={summary['overlap_efficiency']:.3f} (eager; from "
        f"the CUDA-graph times {graph_efficiency:.3f}); the GEMM phases' {gemm_tiles[0]} and {gemm_tiles[1]} output "
        f"tiles run on min(tiles, SMs) = {min(gemm_tiles[0], sms)} and "
        f"{min(gemm_tiles[1], sms)} persistent blocks, one an SM (their "
        f"rings take more than half an SM's shared memory); mxu library call "
        f"(two torch.matmul over the tiles) {lib_ms:.4f} ms, {lib_graph_ms:.4f}"
        f" in a CUDA graph, max |diff| {lib_err:.6g} from the plain version; "
        f"bounds (whole card) "
        + ", ".join(f"{k} {b[0]:.4f} ms ({b[1]})" for k, b in bounds.items()))
    entries = {}
    for key, name in (("P3-vpu", "vpu"), ("P3-mxu", "mxu"), ("P3-both", "both"),
                      ("P3-interleave", "interleave")):
        entries[key] = {
            "max_abs_err": max(res[name]["diff"].values()),
            "ms": res[name]["ms"], "graph_ms": res[name]["graph_ms"],
            "plain_ms": cuda_ms(torch, plain[key], launches=3, repeats=1),
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "library_ms": lib_ms if key == "P3-mxu" else None,
            "per": f"{ov.TILES} tiles of (672, 768); the plain "
                   "version computes one tile and broadcasts it"}
    entries["P3-mxu"]["library_graph_ms"] = lib_graph_ms
    entries["P3-both"].update(overlap_efficiency=summary["overlap_efficiency"],
                              graph_overlap_efficiency=graph_efficiency, sms=sms)
    return entries


def phase_probes(torch):
    """The probe tools' ``run`` at their default shapes, counted as one
    path: every variant checked against its plain version within the
    tool's bound. Returns the path's launch counts and the P entries."""
    from axial_vs_tpu_torch.tools import (bench_overlap, bench_pallas_bw,
                                          exp_dwconv_variants,
                                          exp_vmem_gather)

    reset_counts()
    t0 = time.perf_counter()
    results = _probe_p4(torch, bench_pallas_bw)
    results["P2"] = _probe_p2(torch, exp_vmem_gather, bench_pallas_bw)
    results["P1"] = _probe_p1(torch, exp_dwconv_variants)
    results.update(_probe_p3(torch, bench_overlap))
    launches = read_counts()
    # a checking call; eager: a warm-up and the timed calls; CUDA graph: a
    # warm-up and the captured calls (the graph's replays are not counted)
    calls = 3 + 2 * PROBE_ITERS
    want = expect(
        K1=len(PROBE_STAGES) * (calls + 1),  # ship: the reference call too
        P1=len(PROBE_STAGES) * len(exp_dwconv_variants.VARIANTS) * calls,
        P2=len(exp_vmem_gather.SHAPES) * 3 * calls,
        **{k: calls for k in bench_overlap.counted_kernels()},
        # P4's copy also reads the L2 rate for P2 (_l2_rate)
        **{"P4-copy": calls + 2 * (L2_RATE_ITERS + 2), "P4-sum12": calls,
           "P4-gather": len(bench_pallas_bw.GATHER_CASES) * calls})
    log(f"probes: {time.perf_counter() - t0:.1f} s; launches {launches} "
        f"(want {want})")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches}")
    torch.cuda.empty_cache()
    return launches, results


def main() -> int:
    import torch

    card = phase_device(torch)
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"K1": phase_k1(torch, gen)}
    k2_drawn = phase_k2(torch, gen)
    results["K3"] = phase_k3(torch, gen)
    captured = {}  # the first K2 call's arguments of each model path
    results["K5"], results["K4"] = phase_k4_k5(torch, gen)
    paths = {}
    model, paths["wc_3_clips"] = phase_slice(torch, captured)
    phase_reference(torch, [("dwln", model)], f32=True)
    del model
    paths["r50_f32_1_clip"] = phase_r50_f32(torch)
    paths["train_r50_f32_3_steps"], train_backward = phase_train_r50_f32(
        torch, card)
    paths["train_convnext_large_bf16_3_steps"], train_backward_bf16 = (
        phase_train_convnext_large_bf16(torch, card))
    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        paths["trainer_4_steps"] = phase_trainer(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        block_model, paths["vipseg_eval_2_videos"] = phase_eval(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mlp_model, paths["mlp_route_1_clip"] = phase_mlp_route(torch)
    phase_reference(torch, [("block", block_model), ("mlp", mlp_model)])
    del block_model, mlp_model
    torch.cuda.empty_cache()
    model, paths["tube_link_3_tubes"] = phase_tube_link(torch, captured)
    phase_tube_link_reference(torch, model)
    del model
    torch.cuda.empty_cache()
    results["K2"] = phase_k2_model(torch, captured, k2_drawn)
    del captured
    torch.cuda.empty_cache()
    paths["msda_bench"], reduces, variant_ms = phase_msda_bench(torch, gen)
    results.update(reduces)
    paths["probes"], probes = phase_probes(torch)
    results.update(probes)
    kernels = []
    ops = "axial_vs_tpu/ops/"
    for key, name, source, replaces in (
            ("K1", "dwconv7x7_layernorm", "dwconv_ln.cu",
             ops + "convnext_pallas.py:109"),
            ("K2", "ms_deform_attn", "msda.cu", ops + "msda_pallas.py:130"),
            ("K3", "trajectory_attention_core", "traj.cu",
             ops + "traj_pallas.py:164"),
            ("K4", "convnext_block_fused", "convnext_block.cu",
             ops + "convnext_pallas.py:318"),
            ("K5", "convnext_mlp_residual", "convnext_mlp.cu",
             ops + "convnext_pallas.py:178"),
            ("K6", "weighted_corner_reduce_multi", "msda_reduce.cu",
             ops + "msda_pallas.py:68"),
            ("K7", "weighted_corner_reduce_v5", "msda_reduce.cu",
             ops + "msda_pallas.py:225"),
            ("K8", "pack_corner_table", "msda_reduce.cu",
             ops + "msda_pallas.py:287"),
            ("P1", "dwconv_variant", "dwconv_variants.cu",
             "tools/exp_dwconv_variants.py:224"),
            ("P2", "slab_gather", "slab_gather.cu",
             "tools/exp_vmem_gather.py:86"),
            ("P3-vpu", "overlap_vpu", "overlap.cu", "tools/bench_overlap.py:81"),
            ("P3-mxu", "overlap_mxu", "overlap.cu", "tools/bench_overlap.py:81"),
            ("P3-both", "overlap_both", "overlap.cu",
             "tools/bench_overlap.py:81"),
            ("P3-interleave", "overlap_interleave", "overlap.cu",
             "tools/bench_overlap.py:81"),
            ("P4-copy", "scale_copy", "bandwidth.cu",
             "tools/bench_pallas_bw.py:40"),
            ("P4-sum12", "sum_n", "bandwidth.cu", "tools/bench_pallas_bw.py:53"),
            ("P4-gather", "column_gather", "bandwidth.cu",
             "tools/bench_pallas_bw.py:89")):
        by_path = {path: counts[key] for path, counts in paths.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"axial_vs_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **results[key], **({"train_backward": train_backward[key],
                                "train_backward_bf16":
                                    train_backward_bf16[key]}
                               if key in train_backward else {})})
    log("msda bench, ms per layer: " + ", ".join(
        f"{k} {v:.4f}" for k, v in variant_ms.items()))
    log(card)  # as nvidia-smi gives it: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
