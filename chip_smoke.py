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
               and f32, at the WC, Tube-Link and CC shapes (f = 3, 9, 24,
               64 clips of 128 queries, and a ragged f = 13), timed eager
               and in a CUDA graph, each CC shape beside its bound; its two
               stages' device time at the widest rows (torch.profiler); and
               at head widths 8 and 16 (64 channels at a Tube-Link row),
               each beside its bound
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
 11b. CC eval - the cross-clip model of configs/vipseg/
               maxtron_cc_convnext_large.yaml at full width (the ConvNeXt-L
               WC segmenter in bf16 under the 6-layer CC module in f32),
               random weights from seed 0: ``evaluate_vipseg`` with
               ``CCInferencePipeline`` on the two synthetic videos (3 and 9
               clips: K3 in f32 at f = 3 and 9), VPQ@{1,2,4,6} and STQ in
               [0, 1], the id maps and the launch counts; the CC module of
               the 9-clip video on the card against the CPU on the same
               inputs (bound 1e-3); the first clip pair's device auction
               on the card equal to the CPU's; frames/s, the parts' ms,
               the alignment's ms and kernels a pair, peak memory a video
 11c. train cc convnext_large - 3 steps of ``train_step`` on the CC model
               of the same yaml at full width (``build_model_and_criterion(
               train=True)``: the frozen bf16 ConvNeXt-L segmenter, the f32
               CC module, the config's criterion and optimizer) on one
               synthetic 8-frame video at 713x713 with 24 GT segments:
               finite losses, K3 in f32 at f = 4 clips 6 times a step on
               the card beside the segmenter's launches, finite f32
               gradients of every CC parameter (the trajectory
               projections' non-zero), the optimizer holding only the CC
               module, the segmenter bitwise unchanged and the CC module
               moved; K3's f32 backward at the first step's inputs against
               autograd of its plain version; ms a step and its parts, the
               alignment's kernels a pair (step 0's first, again), peak memory
 12. Tube-Link slice - the Tube-Link R50 VIS inference at 360x640, tubes of
               5 frames, bf16, random weights from a seed: a 15-frame video
               (3 tubes) through ``TubeLinkVISInference.run_video``, 30
               instances, and the launch counts of that run
 13. Tube-Link reference - the pixel decoder on a small tube, the card's
               bf16 run against an f32 run of the plain versions on the CPU
 13a. ytvis eval - ``evaluate_ytvis`` on two synthetic 720x1280 YTVIS
               videos (15 and 36 frames, with ground truth) for both
               Tube-Link R50 configurations at full width (bf16, 360x640
               tubes of 5, random weights from seed 0), each built by the
               registry: with MaXTron's temporal attention (K2 and K3) and
               the baseline without it (K2 only, no K3 launch); finite
               AP/AR, 30 predictions a video, the launch counts; frames/s,
               the forward's, host upsample's and RLE's shares, the JSON's
               size, peak device and host memory
 13b. overfit heads of 8 - the port's WC overfit tool
               (``tools/validate_overfit.py``, 64 channels in 8 heads of 8,
               the JAX tool's) for one step and one eval: K3 at head width
               8, under autograd in the step
 13c. K2 model inputs - K2 on the arguments of the first K2 call of the WC
               slice's and the Tube-Link path's warm-up (bf16 as captured,
               and in f32), against its plain version, timed eager and in a
               CUDA graph per clip and per tube
 13d. train tube-link - 3 steps of ``train_step`` on the Tube-Link VIS
               model of configs/ytvis19/tube_link_maxtron_wc_r50.yaml at full
               width (R50, 100 queries, 9 decoder layers, 40 classes, f32,
               AdamW with clip 0.01, the device auction), built with its
               criterion by the registry, on 7 tubes of 5 frames at 512x512
               a step (the yaml's 8 do not fit in 80 GB) from the config's
               YTVIS mapper over two synthetic
               720x1280 videos: JAX's 30 loss names, finite; K2 and K3
               launched each step; the parameters moved; step 0's auction
               against the CPU's; K2's and K3's forward and backward at the
               first calls against their plain versions; ms a step, the
               matching's share and peak memory
 13e. tube-link train reference - one step of the narrow model of
               tests/test_torch_tube_link_train.py (64 channels: K3 at heads
               of 8) on the card and on the CPU from the same weights,
               batch, draws and points: losses and gradients within bounds
               (the gradients beside the CPU's own move at 1 +- 2^-22)
 13f. overfit vis - the port's Tube-Link VIS overfit tool
               (``tools/validate_overfit_vis.py``) for 2 steps and one eval:
               the first K2 and K3 call (d = 8) of the steps against the
               plain versions forward and backward, and of the eval forward
 13g. tube-link vps - the Tube-Link VPS R50 of configs/vipseg/
               tube_link_vps_r50.yaml at full width (58 thing + 66 stuff
               classes, 100 + 66 queries, f32, windows of 5), built by the
               registry (the head's residual branches scaled by 0.1, so
               that its queries stay apart): a synthetic 15-frame 720x1280
               video through ``preprocess_frames`` at 512x512, 3 windows of
               ``TubeLinkVPSInference.process_window`` and of
               ``process_window_instance``, at the defaults and at zero
               thresholds: the id convention, a thing track carried across
               windows, the launch counts; the first window on the card
               against the CPU (logits, masks, track embeddings 1e-3; id
               maps 0.999 of the pixels; the CPU's head masked by the
               card's attention masks); K2 on the layer's own first call
 13h. cc vis - the cross-clip Tube-Link VIS R50 of configs/ytvis21/
               tube_link_maxtron_cc_r50.yaml at full width (100 queries, 40
               classes, clips of 5, 4 CC layers, f32), built by the
               registry: 360x640 videos of 15 and 60 frames (K3 in the CC
               layers at n = 100, f = 3 and 12), every CC layer's outputs,
               the launch counts; K3's first CC-layer call of each video
               against its plain version, beside its bound; a 15-frame
               video at 180x320 on the card against the CPU (1e-3, the
               card's attention masks)
 13i. image m2f - the image Mask2Former R50 of configs/image/
               mask2former_r50_coco_panoptic_50e.yaml at full width (80 +
               53 classes, 100 queries, f32): one 1024x1024 image (K2
               only), every layer's outputs, the launch counts; the image
               on the card against the CPU (1e-3, the card's attention
               masks); K2 on the layer's own first call
 13j. coco eval - the image kMaX-DeepLab of configs/coco/
               kmax_convnext_large.yaml at full width (ConvNeXt-L, the
               spatial-only WC module, bf16, 1281x1281, 133 classes, 128
               queries), built by the registry: one image's forward timed
               (median and spread); ``evaluate_coco_panoptic`` on three
               synthetic COCO-format 480x640 images, its PQ dict, images/s,
               the forward's and the panoptic loop's shares, the launch
               counts (K1 36, K2 2 an image); the first K1 call at each
               stage's shape and the first K2 call, on their own inputs,
               against their plain versions
 13k. convnextv2 - configs/coco/kmax_convnextv2_large.yaml (GRN blocks on
               the "dwln" route), its GRN gamma and beta drawn: one image,
               the launch counts, the forward's time and its GRNs' alone; a
               GRN block's first K1 call against its plain version
 13l. kmax r50 reference - configs/coco/kmax_r50.yaml (the image model
               without the WC module, f32): one 641x641 image on the card
               against the CPU (1e-3 of max |ref|); no kernel launches
 13m. swin-l vis - the main path of the Swin slice: configs/ytvis21/
               tube_link_maxtron_wc_swin_l.yaml as it stands (Swin-L 192,
               2/2/18/2, heads 6-48, window 12; bf16; 100 queries; temporal
               attention), built by the registry: a 15-frame 360x640 video
               in tubes of 5 through ``run_video`` (K2 18 / K3 72), ms a
               tube (median and spread), peak memory; K2's and K3's first
               calls (bf16) against their plain versions; ``evaluate_ytvis``
               on 13a's two synthetic videos: AP/AR finite, frames/s, the
               forward's share, the launch counts
 13n. swin-l vis train - 3 ``train_step``s of the same yaml built for
               training (f32 throughout, as JAX's registry trains Tube-Link;
               drop path 0.3; the auction at m = 100) on 3 tubes of 5 at
               512x512 (the yaml's 8 outgrow the card), one batch and one
               seed a step: finite losses and gradients, the loss not
               rising, K2 6 / K3 24 a step, ms a step, the matching's share,
               peak memory
 13o. tube-link vps backbones - configs/vipseg/tube_link_vps_{stdc1,stdc2,
               swin_b}.yaml at full width: a synthetic 15-frame video at
               512x512 in 3 windows of ``process_window`` each (zero
               thresholds): the id convention, the launch counts, the
               window forward's ms
 13p. swin-l images - configs/coco/kmax_instance_swin_large.yaml (one
               1281x1281 bf16 image, SAME-padded patch embed, no kernel
               launch; ``instance_inference``) and configs/image/
               mask2former_swin_l_384_in21k_coco_panoptic_100e.yaml (one
               1024x1024 bf16 image, K2 6; panoptic fusion): ms a forward,
               peak memory
 13q. swin/stdc reference - the Swin-L backbone on a 513x513 frame and the
               STDC2 backbone on a 512x512 frame, f32, the card against the
               CPU within 1e-4 of max |ref|
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
#: K3 in the cross-clip (CC) module, (B', f, n): one video's 128 queries
#: with the clips as frames, at 3, 9 (the 6- and 18-frame videos of the CC
#: eval), 24 and 64 clips; and a ragged f > 8
K3_CC = {"f=3": (1, 3, 128), "f=9": (1, 9, 128), "f=24": (1, 24, 128),
         "f=64": (1, 64, 128)}
K3_CC_RAGGED = (2, 13, 37)
#: K3 at the narrow head widths, (B', f, n, C, heads): the Tube-Link res4 W
#: rows at 64 channels in 8 heads of 8 (the WC overfit tool's module) and 4
#: heads of 16 (the Tube-Link overfit tool's)
K3_NARROW = {"d=8": (23, 5, 40, 64, 8), "d=16": (23, 5, 40, 64, 4)}
CC_LAYERS = 6  # K3 calls per video in the CC module, at f = clips
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


class Laps:
    """Wall seconds between marks of one phase, logged as they are taken
    (informational: where a phase's time goes)."""

    def __init__(self, phase: str):
        self.phase, self.t = phase, time.perf_counter()

    def __call__(self, what: str):
        now = time.perf_counter()
        log(f"{self.phase}: {what} {now - self.t:.1f} s")
        self.t = now


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
    from axial_vs_tpu_torch.ops.convnext_cuda import dwconv_taps

    dev = torch.device("cuda")
    full_f32(torch)
    cases = {torch.bfloat16: [], torch.float32: []}
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
            # the tap-major copy a ConvNeXt block keeps
            cases[dtype].append(_k1_case(
                torch, "drawn", (x, wt, b, lw, lb),
                {"eps": 1e-6, "taps": dwconv_taps(wt)}))
    # per clip: each stage's case times its number of blocks
    bf16 = _k1_per("bf16 WC clip", cases[torch.bfloat16][:4],
                   CONVNEXT_L_DEPTHS)
    bf16["max_abs_err"] = max(c["max_abs_err"]
                              for c in cases[torch.bfloat16])
    return {**bf16, "library_ms": None,
            "f32": _k1_per("f32 WC clip", cases[torch.float32],
                           CONVNEXT_L_DEPTHS)}


def _k1_per(label: str, cases, depths):
    """K1's entry per ``label`` (a clip or an image) from one case at each
    stage's shape (``_k1_case``): each stage's times and work times its
    number of blocks, the bound from the summed work."""
    total = {k: sum(d * c[k] for d, c in zip(depths, cases))
             for k in ("ms", "graph_ms", "plain_ms", "chain_ms", "flops",
                       "bytes")}
    bound_t, by = bound_ms(total["flops"], total["bytes"], PEAK_F32)
    log(f"K1 {label} ({'/'.join(map(str, depths))} calls at the stage "
        f"shapes): kernel {total['ms']:.4f} ms ({total['graph_ms']:.4f} in "
        f"CUDA graphs), plain {total['plain_ms']:.4f} ms, conv2d + "
        f"layer_norm chain {total['chain_ms']:.4f} ms, bound {bound_t:.4f} "
        f"ms ({by})")
    return {"per": f"{label} ({sum(depths)} calls)",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": total["ms"], "graph_ms": total["graph_ms"],
            "plain_ms": total["plain_ms"], "chain_ms": total["chain_ms"],
            "bound_ms": bound_t, "bound_by": by,
            "per_stage": {f"stage{i}": {"calls": d, **c}
                          for i, (d, c) in enumerate(zip(depths, cases))}}


def _k1_case(torch, label: str, args, kwargs):
    """K1 on these arguments (moved to the card; ``kwargs`` holds ``eps``
    and ``taps``) against its plain version (2 bf16 ulp or F32_REL_BOUND
    of max|out|), timed eager, in a CUDA graph and plain, beside the
    conv2d + layer_norm chain and the bound. Returns its entry, with the
    flops and bytes the bound counts."""
    import torch.nn.functional as F

    from axial_vs_tpu_torch.ops.convnext_cuda import (
        dwconv7x7_layernorm, dwconv7x7_layernorm_plain)
    from axial_vs_tpu_torch.tools.timing import graph_ms

    dev = torch.device("cuda")
    args = [a.to(dev) for a in args]
    kwargs = {k: v.to(dev) if torch.is_tensor(v) else v
              for k, v in kwargs.items()}
    x = args[0]

    def kernel():
        return dwconv7x7_layernorm(*args, **kwargs)

    got = kernel()
    want = dwconv7x7_layernorm_plain(*args, eps=kwargs["eps"])
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if x.dtype == torch.bfloat16:
        bound, stated = 2 * bf16_ulp(scale), "2 bf16 ulp"
    else:
        bound, stated = f32_bound(want), "F32_REL_BOUND"
    ms = cuda_ms(torch, kernel)
    g_ms = graph_ms(kernel, "cuda", 10)
    plain_ms = cuda_ms(torch, lambda: dwconv7x7_layernorm_plain(
        *args, eps=kwargs["eps"]))
    vecs = [v.to(x.dtype) for v in args[2:5]]
    chain_ms = cuda_ms(torch, lambda: _dwln_chain(F, x, args[1], *vecs))
    elems, size, c = x.numel(), x.element_size(), x.shape[-1]
    flops = (2 * 49 + 10) * elems
    nbytes = 2 * size * elems + c * (49 * args[1].element_size() + 3 * 4)
    bound_t, by = bound_ms(flops, nbytes, PEAK_F32)
    log(f"K1 {str(x.dtype)[6:]} {label} {tuple(x.shape)}: max_abs_err "
        f"{err:.6g} (bound {stated} of max|out| "
        f"{scale:.4g} = {bound:.6g}); kernel {ms:.4f} ms ({g_ms:.4f} in a "
        f"CUDA graph), plain {plain_ms:.4f} ms, conv2d + layer_norm chain "
        f"{chain_ms:.4f} ms, bound {bound_t:.4f} ms ({by})")
    if not (err <= bound and got.dtype == x.dtype
            and torch.isfinite(got.float()).all()):
        raise AssertionError(f"K1 {x.dtype} disagrees on the {label} call "
                             f"at {tuple(x.shape)}")
    return {"shape": list(x.shape), "max_abs_err": err, "ms": ms,
            "graph_ms": g_ms, "plain_ms": plain_ms, "chain_ms": chain_ms,
            "bound_ms": bound_t, "bound_by": by, "flops": flops,
            "bytes": nbytes}


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
    cases += [("cc " + k, v) for k, v in K3_CC.items()]
    cases += [("cc ragged f=13", K3_CC_RAGGED)]
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

            # the CC shapes reach 8192 tokens: fewer timed calls there
            runs = (3, 3, 1, 3) if name.startswith("cc") else (10, 5, 3, 5)
            ms = cuda_ms(torch, kernel, runs[0], runs[1])
            g_ms = graph_ms(kernel, "cuda", 10)
            plain_ms = cuda_ms(torch, lambda: trajectory_attention_core_plain(
                *args, f, 8), runs[2], runs[3])
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
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "graph_ms")
    cc_shapes = {}
    for dtype, size in ((torch.bfloat16, 2), (torch.float32, 4)):
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        for k, shape in K3_CC.items():
            ms, plain, g_ms = times[(dtype, "cc " + k)]
            flops, nbytes = _traj_work(*shape, size=size)
            bound, by = bound_ms(flops, nbytes, peak)
            cc_shapes[f"{str(dtype)[6:]} {k}"] = dict(zip(keys, (
                ms, plain, bound, by, g_ms)))
            log(f"K3 {str(dtype)[6:]} CC shape {k} (B'=1, n=128): kernel "
                f"{ms:.4f} ms ({g_ms:.4f} in a CUDA graph), plain "
                f"{plain:.4f} ms, bound {bound:.4f} ms ({by}: "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
                f"{bound / g_ms:.3f} of the bound in a graph")
    # the CC module of a 9-clip video: CC_LAYERS calls at f = 9, in f32
    ms, plain, g_ms = (CC_LAYERS * times[(torch.float32, "cc f=9")][i]
                       for i in (0, 1, 2))
    flops, nbytes = (CC_LAYERS * _traj_work(*K3_CC["f=9"], size=4)[i]
                     for i in (0, 1))
    bound, by = bound_ms(flops, nbytes, PEAK_F32)
    cc_video = dict(zip(keys, (ms, plain, bound, by, g_ms)))
    log(f"K3 f32 per 9-clip video in the CC module ({CC_LAYERS} calls): "
        f"kernel {ms:.4f} ms ({g_ms:.4f} in CUDA graphs), plain {plain:.4f} "
        f"ms, bound {bound:.4f} ms ({by})")
    narrow = phase_k3_narrow(torch, gen)
    ms, plain, bound, by, g_ms = totals[(torch.bfloat16, "tube-link")]
    return {"max_abs_err": worst[torch.bfloat16], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "graph_ms": g_ms,
            "per": "Tube-Link tube (24 calls)",
            "stages_ms_per_call": {f"{str(d)[6:]} {k}": v
                                   for (d, k), v in stages.items()},
            "wc_clip": dict(zip(keys, totals[(torch.bfloat16, "wc")])),
            "cc_shapes": cc_shapes, "cc_video_9_clips_f32": cc_video,
            "narrow_heads": narrow,
            "f32": {"max_abs_err": worst[torch.float32],
                    "tube": dict(zip(keys, totals[(torch.float32, "tube-link")])),
                    "wc_clip": dict(zip(keys, totals[(torch.float32, "wc")]))}}


def phase_k3_narrow(torch, gen):
    """K3 at head widths 8 and 16 (``K3_NARROW``), bf16 and f32, against
    its plain version within phase 5's bounds; eager and in a CUDA graph,
    beside the bound worked out as for the 32-wide rows. Returns each
    case's entry."""
    from axial_vs_tpu_torch.ops.traj import (
        TRAJ_ULPS, trajectory_attention_core, trajectory_attention_core_plain)
    from axial_vs_tpu_torch.tools.timing import graph_ms

    out = {}
    for dtype, size in ((torch.bfloat16, 2), (torch.float32, 4)):
        tag = str(dtype)[6:]
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        for name, (b, f, n, c, h) in K3_NARROW.items():
            args = _traj_inputs(torch, gen, b, f, n, c=c, dtype=dtype)

            def kernel():
                return trajectory_attention_core(*args, f, h)

            got = kernel()
            want = trajectory_attention_core_plain(*args, f, h)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            if dtype == torch.bfloat16:
                bound, stated = TRAJ_ULPS * bf16_ulp(scale), f"{TRAJ_ULPS} bf16 ulp"
            else:
                bound, stated = f32_bound(want), "F32_REL_BOUND"
            if not (err <= bound and torch.isfinite(got.float()).all()
                    and got.dtype == dtype):
                raise AssertionError(f"K3 {tag} {name} disagrees: {err}")
            ms = cuda_ms(torch, kernel)
            g_ms = graph_ms(kernel, "cuda", 10)
            plain_ms = cuda_ms(torch, lambda: trajectory_attention_core_plain(
                *args, f, h), 3, 5)
            flops, nbytes = _traj_work(b, f, n, c=c, size=size)
            b_ms, by = bound_ms(flops, nbytes, peak)
            out[f"{tag} {name}"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by, "graph_ms": g_ms,
                "shape": [b, f, n, c, h]}
            log(f"K3 {tag} {name} (B'={b}, f={f}, n={n}, C={c}, {h} heads): "
                f"max_abs_err {err:.6g} (bound {stated} of max|out| "
                f"{scale:.4g} = {bound:.6g}); kernel {ms:.4f} ms ({g_ms:.4f} "
                f"in a CUDA graph), plain {plain_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP, "
                f"{nbytes / 1e6:.2f} MB), {b_ms / g_ms:.3f} of the bound in "
                f"a graph")
    return out


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


def _kernel_and_plain():
    """K2's and K3's wrapper, plain version and forward bound in bf16 ulps
    of max|out| (f32: ``F32_REL_BOUND``)."""
    from axial_vs_tpu_torch.ops.msda import ms_deform_attn, ms_deform_attn_plain
    from axial_vs_tpu_torch.ops.traj import (TRAJ_ULPS,
                                             trajectory_attention_core,
                                             trajectory_attention_core_plain)

    return {"K2": (ms_deform_attn, ms_deform_attn_plain, 2),
            "K3": (trajectory_attention_core, trajectory_attention_core_plain,
                   TRAJ_ULPS)}


def _check_train_backward(torch, captured, keys=("K2", "K3")):
    """The autograd Functions of ``keys`` (K2, K3; each must be in
    ``captured``, else ``KeyError``) against autograd of their plain
    versions at the captured inputs: the forward (kernel against plain;
    f32: ``F32_REL_BOUND`` of max|out|, bf16: 2 bf16 ulp for K2 and
    ``TRAJ_ULPS`` for K3) and each input's gradient, max |diff| / max |ref|
    (``TRAIN_GRAD_BOUND`` in f32, ``TRAIN_GRAD_BOUND_BF16`` in bf16)."""
    out = {}
    for key in keys:
        fn, plain, ulps = _kernel_and_plain()[key]
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
#: max(|optimum|, 1): the JAX package's bound (``tests/test_hungarian.py``),
#: or the auction's own guarantee of m * eps over m columns where that is
#: larger
AUCTION_GAP_BOUND = 8e-3


def auction_gap_bound(columns: int) -> float:
    from axial_vs_tpu_torch.ops.hungarian import AUCTION_EPS

    return max(AUCTION_GAP_BOUND, columns * AUCTION_EPS)


def check_auction(torch, cost, valid) -> dict:
    """The auction's assignment on the card against the same auction on a
    CPU copy (bitwise), checked one-to-one (each valid GT column one query,
    no query twice, invalid columns -1), and its gap to scipy's optimum
    (``lsap_host``) per sample within ``auction_gap_bound`` of its valid
    columns."""
    from axial_vs_tpu_torch.ops.hungarian import auction_assign, lsap_host

    got = auction_assign(cost, valid).cpu()
    want = auction_assign(cost.cpu(), valid.cpu())
    c, v, a = cost.cpu().numpy(), valid.cpu().numpy(), got.numpy()
    best = lsap_host(c, v)
    one_to_one, gaps, within = True, [], True
    for i in range(c.shape[0]):
        cols = np.flatnonzero(v[i])
        rows = a[i, cols]
        one_to_one &= bool((a[i, ~v[i]] == -1).all() and (rows >= 0).all()
                           and len(set(rows.tolist())) == len(rows))
        if not one_to_one:
            break
        opt = float(c[i][best[i, cols], cols].sum())
        gaps.append((float(c[i][rows, cols].sum()) - opt) / max(abs(opt), 1.0))
        within &= gaps[-1] <= auction_gap_bound(len(cols))
    out = {"equal_to_cpu": bool(torch.equal(got, want)),
           "one_to_one": one_to_one, "gap": max(gaps, default=0.0),
           "gap_bound": auction_gap_bound(int(v.sum(1).max())),
           "valid_columns": int(v.sum())}
    if not (out["equal_to_cpu"] and one_to_one and within):
        raise AssertionError(f"auction on the card: {out}")
    return out


def measure_auction(torch, cost, valid, calls: int = 3):
    """The auction on one cost matrix: ``check_auction``, then ms a call
    between CUDA events (median of ``calls``, host launch gaps included),
    and one call under ``torch.profiler``: its kernels' count and summed
    device time."""
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
    # the device's activity alone: the host's ops are not needed to count
    # kernels, and recording them slows the profiler's bookkeeping
    acts = [torch.profiler.ProfilerActivity.CUDA]
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
    lap = Laps("train convnext_large bf16")
    profile = bench_train.profile_step(parts, batch, gen)
    lap("the profiled step")
    auction = measure_auction(torch, *captured.pop("auction"))
    lap("the auction's check and measurement")
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
        f"{auction['gap_bound']:.3g})")
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
    from axial_vs_tpu_torch.models.video_inference import WCInferencePipeline

    card = wc_pipeline(cfg, model, name, WCInferencePipeline)
    host = wc_pipeline(cfg, torch.nn.Linear(1, 1), name,  # only its finalize runs
                       WCInferencePipeline)
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


CC_CLIPS = 3 + 9  # clips of 2 frames in the CC eval: the 6- and 18-frame videos
CC_PAIRS = 2 + 8  # aligned clip pairs in it


def cc_convnext_large_config():
    """``configs/vipseg/maxtron_cc_convnext_large.yaml`` over the repo's
    default config, from the port's own config: the ConvNeXt-L WC segmenter
    in bf16 (769x1345, 2-frame clips, 124 classes, 128 queries) under the
    6-layer CC module."""
    from axial_vs_tpu_torch.config import load_config

    return load_config("vipseg/maxtron_cc_convnext_large.yaml")


def widen_cc_predictor(torch, model):
    """At its own inits the CC predictor keeps every slot void and every
    mask under the pixel threshold, so that the finalize would see no
    segment. As ``tests/test_torch_cc.py`` does: the class head x100 with
    the void logit's bias at -20, and the mask norm's scale 3."""
    pred = model.cc_module._predictor
    with torch.no_grad():
        pred._transformer_class_head.conv.weight.mul_(100.0)
        pred._transformer_class_head.conv.bias[-1] = -20.0
        pred._pixel_space_mask_batch_norm.weight.fill_(3.0)


def cuda_spans(torch, spans: list, fn):
    """``fn`` with CUDA events recorded around each call, appended to
    ``spans`` as (start, end)."""
    def wrapper(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out
    return wrapper


def phase_cc_eval(torch, root: str, card: str):
    """``evaluate_vipseg`` with ``CCInferencePipeline`` over the two
    synthetic videos with the full-size CC model (its predictor widened so
    that segments are accepted): one forward of each whole video (the
    segmenter clip by clip, the device auction between clips, the CC
    module with K3 in f32 at f = clips), its VPQ and STQ in [0, 1], its id
    maps with at least one segment, and its launch counts. Then the
    6-frame video's ids against the CPU pipeline's finalize of the same
    model outputs, the CC module of the 9-clip video on the card against a
    CPU run on the same inputs, and the first pair's auction on the card
    against the CPU's. Returns the launch counts."""
    import copy

    from axial_vs_tpu_torch.data.vipseg import (register_vipseg_video,
                                                set_panoptic_metadata)
    from axial_vs_tpu_torch.engine.evaluator_loop import (evaluate_vipseg,
                                                          wc_pipeline)
    from axial_vs_tpu_torch.models import maxtron_cc
    from axial_vs_tpu_torch.models.build import build_model_and_criterion
    from axial_vs_tpu_torch.models.video_inference import CCInferencePipeline

    dev = torch.device("cuda")
    paths, categories = write_vipseg_videos(os.path.join(root, "vipseg"))
    name = "chip_smoke_vipseg_cc_val"
    set_panoptic_metadata(register_vipseg_video(name, *paths), categories)
    cfg = cc_convnext_large_config()
    cfg.datasets.test = [name]
    cfg.output_dir = os.path.join(root, "cc_eval_out")
    t0 = time.perf_counter()
    model, criterion = build_model_and_criterion(
        cfg, train=False, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    log(f"cc eval: built {type(model).__name__} from "
        f"maxtron_cc_convnext_large.yaml in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"parameters, {cfg.model.maxtron.cc.num_layers} CC layers, losses "
        f"{criterion.losses})")
    widen_cc_predictor(torch, model)
    with torch.inference_mode():  # warm-up, not counted
        model.segmenter(torch.zeros(T, H, W, 3, device=dev))
    torch.cuda.synchronize()

    # CUDA events around the parts of each video's forward (informational),
    # each video's peak memory and ids, the finalize's inputs of the 6-frame
    # video and the CC module's inputs of the 9-clip video (host copies),
    # and the first pair's auction cost
    spans = {k: [] for k in ("clip_outputs", "align", "cc_module",
                             "_finalize", "run_video")}
    peaks, ids, finals, cc_inputs, box = [], {}, {}, {}, {}

    def timed(key, fn):
        return cuda_spans(torch, spans[key], fn)

    real_cc = model.cc_module.forward

    def cc_forward(clip_query, pixels, *args):
        if clip_query.shape[2] == 9:
            cc_inputs["9 clips"] = (clip_query.cpu(), pixels.cpu())
        return timed("cc_module", real_cc)(clip_query, pixels, *args)

    def finalize(self, logits, masks, *hw):
        if len(masks) == EVAL_LENGTHS[0]:
            finals[len(masks)] = (logits.cpu(), masks.cpu(), *hw)
        return timed("_finalize", originals["_finalize"])(self, logits,
                                                          masks, *hw)

    def run_video(self, frames, *args):
        torch.cuda.reset_peak_memory_stats()
        out = originals["run_video"](self, frames, *args)
        peaks.append((len(frames), torch.cuda.max_memory_allocated() / 2**30))
        ids[len(frames)] = out[0]
        return out

    originals = {k: getattr(CCInferencePipeline, k)
                 for k in ("_finalize", "run_video")}
    real_align = maxtron_cc.align_clip_queries
    lap = Laps("cc eval")
    reset_counts()
    CCInferencePipeline._finalize = finalize
    CCInferencePipeline.run_video = timed("run_video", run_video)
    maxtron_cc.align_clip_queries = timed("align", real_align)
    model.clip_outputs = timed("clip_outputs", model.clip_outputs)
    model.cc_module.forward = cc_forward
    try:
        with first_auction_call(box):
            t0 = time.perf_counter()
            res = evaluate_vipseg(cfg, model, compute_stq=True,
                                  pipeline_cls=CCInferencePipeline)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for key, fn in originals.items():
            setattr(CCInferencePipeline, key, fn)
        maxtron_cc.align_clip_queries = real_align
        del model.clip_outputs, model.cc_module.forward
    launches = read_counts()
    lap("set-up and the evaluation")
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}

    values = {"vpq": res["vpq"], "stq": res["stq"]["STQ"],
              **{f"vpq@{k}": res["per_window"][k]["all"]["pq"]
                 for k in sorted(res["per_window"])}}
    if set(res["per_window"]) != {1, 2, 4, 6}:
        raise AssertionError(f"windows {sorted(res['per_window'])}")
    for k, v in values.items():
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            raise AssertionError(f"cc eval: {k} = {v}")
    n_segments = []
    for v, n_frames in enumerate(EVAL_LENGTHS):
        vdir = os.path.join(cfg.output_dir, "pan_pred", f"video{v}")
        pngs = sorted(p for p in os.listdir(vdir) if p.endswith(".png"))
        if len(pngs) != n_frames:
            raise AssertionError(f"cc eval video{v}: {len(pngs)} id maps")
        with open(os.path.join(vdir, "pred.json")) as f:
            n_segments.append(sum(len(a["segments_info"])
                                  for a in json.load(f)["annotations"]))
    if min(n_segments) < 1:
        raise AssertionError(f"cc eval: segment-frames {n_segments}: no "
                             "segment was accepted")
    want = expect(K1=CONVNEXT_L_BLOCKS * CC_CLIPS, K2=K2_WC_CALLS * CC_CLIPS,
                  K3=4 * K3_WC_CALLS * CC_CLIPS + CC_LAYERS * len(EVAL_LENGTHS))
    log("cc eval: " + ", ".join(f"{k} {v:.6g}" for k, v in values.items())
        + f"; predicted segment-frames {n_segments} in the videos of "
        f"{EVAL_LENGTHS} frames")
    log(f"cc eval: launches in the evaluation: {launches} (want {want})")
    frames = sum(EVAL_LENGTHS)
    total = ms["run_video"]
    log(f"cc eval (informational, {card}): {frames / wall:.3f} frames/s wall "
        f"({wall:.3f} s for {frames} frames; CUDA events {total:.2f} ms in "
        f"run_video); segmenter {ms['clip_outputs'] / CC_CLIPS:.2f} ms per "
        f"clip ({ms['clip_outputs'] / total:.3f} of run_video); alignment "
        f"{ms['align'] / CC_PAIRS:.2f} ms per clip pair ({CC_PAIRS} pairs, "
        f"{ms['align'] / total:.3f} of it); CC module "
        f"{ms['cc_module'] / len(EVAL_LENGTHS):.2f} ms per video "
        f"({ms['cc_module'] / total:.3f} of it); finalize "
        f"{ms['_finalize'] / len(EVAL_LENGTHS):.2f} ms per video "
        f"({ms['_finalize'] / total:.3f} of it); peak memory "
        + ", ".join(f"{g:.3f} GiB at {n} frames" for n, g in peaks))
    (n0, g0), (n1, g1) = peaks
    per_frame = (g1 - g0) / (n1 - n0)
    capacity = torch.cuda.get_device_properties(0).total_memory / 2**30
    if per_frame > 0:
        log(f"cc eval (informational): peak memory grows {per_frame:.4f} GiB "
            f"a frame; a line through the two peaks reaches the card's "
            f"{capacity:.2f} GiB at {int(n1 + (capacity - g1) / per_frame)} "
            f"frames")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches}")

    # the 6-frame video's ids against the CPU pipeline's finalize (resize,
    # panoptic inference, id remap, trim) of the card's model outputs
    n = EVAL_LENGTHS[0]
    host = wc_pipeline(cfg, torch.nn.Linear(1, 1), name, CCInferencePipeline)
    want_ids = host._finalize(*finals.pop(n))[0][:n]
    got_ids = torch.from_numpy(ids[n])
    agree = (got_ids == want_ids).double().mean().item()
    segments = [len(torch.unique(x[x >= 0])) for x in (got_ids, want_ids)]
    log(f"cc eval: the {n}-frame video's ids against the CPU's finalize of "
        f"the card's outputs: {segments[0]} and {segments[1]} segments, id "
        f"maps equal on {agree:.6f} of the pixels (bound "
        f"{FINALIZE_AGREEMENT})")
    if got_ids.shape != want_ids.shape or min(segments) < 1 \
            or not agree >= FINALIZE_AGREEMENT:
        raise AssertionError("the card's CC ids disagree with the CPU's")
    del finals, want_ids, got_ids
    lap("the CPU's finalize")

    # the CC module (K3 in f32 at f = 9) against a CPU run on the same inputs
    query, pixels = cc_inputs["9 clips"]
    with torch.inference_mode():
        args = (query.to(dev), pixels.to(dev))
        got = model.cc_module(*args)
        want_out = copy.deepcopy(model.cc_module).cpu()(query, pixels)
        cc_ms = cuda_ms(torch, lambda: model.cc_module(*args), launches=3,
                        repeats=3)
    log(f"cc eval (informational): the CC module alone on the 9-clip video's "
        f"inputs, warm: {cc_ms:.2f} ms a call (CUDA events)")
    errs = {}
    pairs = [("", got, want_out)] + [
        (f"aux{i} ", g, w) for i, (g, w) in enumerate(zip(
            got["aux_outputs"], want_out["aux_outputs"]))]
    for tag, g, w in pairs:
        for k in ("pred_logits", "pred_masks"):
            ref = w[k].float()
            errs[tag + k] = ((g[k].float().cpu() - ref).abs().max().item()
                             / ref.abs().max().item())
    worst = max(errs.values())
    log(f"cc eval: the card's CC module on the 9-clip video's inputs against "
        f"the CPU's (plain K3): max |diff| / max |ref| {worst:.3g} over "
        f"{len(errs)} outputs (bound {F32_REFERENCE_BOUND}); pred_logits "
        f"{errs['pred_logits']:.3g}, pred_masks {errs['pred_masks']:.3g}")
    if not worst <= F32_REFERENCE_BOUND:
        raise AssertionError(f"the card's CC module disagrees: {errs}")
    del got, want_out, cc_inputs, args
    lap("the CC module against the CPU")

    # the alignment's auction on the first pair's cost, card against CPU
    cost, valid = box["auction"]
    auction = measure_auction(torch, cost, valid, calls=1)
    lap("the auction's check and measurement")
    log(f"cc eval, the auction alone on the first clip pair's cost "
        f"{list(cost.shape)} ({card}): {auction['ms']:.2f} ms a call between "
        f"CUDA events; {auction['kernels']} kernels, "
        f"{auction['kernel_ms']:.2f} ms of device time; equal to the CPU "
        f"auction {auction['equal_to_cpu']}, one-to-one "
        f"{auction['one_to_one']}, gap to scipy's optimum {auction['gap']:.3g}")
    del model
    torch.cuda.empty_cache()
    return launches


#: the CC training phase: frames of its one video a step (4 clips of 2), K3
#: calls a step in f32 at f = clips (one a CC layer) and in bf16 in the
#: segmenter (16 a clip), the alignment's clip pairs a step
CC_TRAIN_FRAMES = 8
CC_TRAIN_CLIPS = CC_TRAIN_FRAMES // T
CC_TRAIN_PAIRS = CC_TRAIN_CLIPS - 1
#: the CC module's trajectory projections, whose gradients must be non-zero
CC_TRAJ_PROJECTIONS = ("self_attn.qkv.weight", "self_attn.proj_q.weight",
                       "self_attn.proj_kv.weight", "self_attn.proj.weight")


@contextlib.contextmanager
def traj_calls(box: dict, key):
    """While active, every K3 call of the trajectory layers is kept in
    ``box["calls"]`` as (device, dtype, frames), and the arguments of the
    first call for each ``key(args)`` that is not None in ``box[key(args)]``
    (detached copies on the card as ``_Leaf``, with each tensor's
    ``requires_grad``); every call still runs the wrapper."""
    import torch

    from axial_vs_tpu_torch.layers import trajectory_attention

    real = trajectory_attention.trajectory_attention_core
    box.setdefault("calls", [])

    def call(*args, **kwargs):
        box["calls"].append((args[0].device.type, str(args[0].dtype)[6:],
                             int(args[7])))
        name = key(args)
        if name is not None and name not in box:
            box[name] = tuple(_Leaf((a.detach().clone(), a.requires_grad))
                              if torch.is_tensor(a) else a for a in args)
        return real(*args, **kwargs)

    trajectory_attention.trajectory_attention_core = call
    try:
        yield
    finally:
        trajectory_attention.trajectory_attention_core = real


#: the residual-ending BatchNorms of the segmenter's k-means layers, whose
#: gamma the upstream init sets to 0
KMAX_RESIDUAL_NORMS = ("_query_conv3_bn.norm.weight",
                       "_query_ffn_conv2_bn.norm.weight",
                       "_kmeans_query_conv3_bn.norm.weight")


#: the gamma ``wake_cc_segmenter`` gives them. The k-means update sums the
#: pixel features of each cluster, so the centers grow with the pixels: at
#: 713x713 a gamma of 1 makes them so large that the CC module's first
#: trajectory softmax is one-hot in f32 (its ``proj_q`` gradient 0 on the
#: card), 0.1 reaches |976|, 0.01 |84.5| with every clip's centers apart
#: (a CPU run of this model at 713x713)
KMAX_RESIDUAL_GAMMA = 0.01


def wake_cc_segmenter(torch, model):
    """At its own inits the segmenter's k-means layers end each residual
    branch with a BatchNorm of gamma 0, so every clip's cluster centers are
    the learned queries, the same for every clip: the CC module would see
    one clip repeated, its temporal softmax could not depend on the query
    (``proj_q``'s gradient exactly 0) and the alignment would have nothing
    to align. As a trained segmenter has, those gammas are set non-zero
    (``KMAX_RESIDUAL_GAMMA``), so that the centers depend on the clip."""
    with torch.no_grad():
        for n, p in model.segmenter.named_parameters():
            if n.endswith(KMAX_RESIDUAL_NORMS):
                p.fill_(KMAX_RESIDUAL_GAMMA)


def phase_train_cc_convnext_large(torch, card: str):
    """``TRAIN_STEPS`` steps of ``train_step`` on the CC model of
    ``configs/vipseg/maxtron_cc_convnext_large.yaml`` at full width, built
    by ``build_model_and_criterion(train=True)``: the frozen bf16
    ConvNeXt-L segmenter (3/3/27/3 blocks of 192-1536, ``eval()``, 2-frame
    clips) under the 6-layer f32 CC module (256 channels, 128 queries, 124
    classes), the device auction between clips, the config's criterion
    (class and mask losses, exact matching) and ``build_optimizer`` (the
    yaml's schedule without its warm-up), the segmenter's k-means gammas
    woken (``wake_cc_segmenter``), on
    ``tools/bench_train.py``'s batch over one video of 8 frames at 713x713
    with 24 GT segments. Checks each step's losses and launches (K3 in f32
    at f = 4 clips, 6 a step, only on card tensors, beside the segmenter's
    K1, K2 and bf16 K3), every CC parameter's gradient (f32, finite;
    non-zero for the trajectory projections), the segmenter bitwise
    unchanged and the CC module moved after the steps, and K3's f32
    backward at the first step's inputs against autograd of its plain
    version. Prints ms a step and its parts (CUDA events), the
    alignment's kernels a pair (``torch.profiler`` over step 0's first
    pair, again; a step has three) and peak memory. Returns the launch counts of the
    steps and the backward check."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.engine.lr_schedule import tf2_warmup_poly_lr
    from axial_vs_tpu_torch.engine.optim import build_optimizer
    from axial_vs_tpu_torch.engine.train_step import train_step
    from axial_vs_tpu_torch.models import maxtron_cc
    from axial_vs_tpu_torch.models.build import build_model_and_criterion
    from axial_vs_tpu_torch.tools import bench_train

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = load_config("vipseg/maxtron_cc_convnext_large.yaml",
                      ["input.image_size", list(TRAIN_HW),
                       "solver.ims_per_batch", 1])
    c = cfg.model.backbone.convnext
    if not (tuple(c.depths) == CONVNEXT_L_DEPTHS and c.dims[-1] == 1536
            and cfg.model.dtype == "bfloat16"
            and cfg.model.maxtron.cc.num_layers == CC_LAYERS
            and cfg.input.num_video_frames == CC_TRAIN_FRAMES
            and cfg.model.kmax.trans_dec.num_object_queries == 128):
        raise AssertionError(f"not the CC ConvNeXt-L yaml: {cfg.model}")
    model, criterion = build_model_and_criterion(
        cfg, train=True, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    # the yaml's poly schedule without its warm-up: its first LRs (4e-8, a
    # tenth of it in the heads) are under half an ulp of a gamma at 1, so
    # three steps would leave some CC tensors in place
    sol = cfg.solver
    optimizer, scheduler = build_optimizer(cfg, model, tf2_warmup_poly_lr(
        sol.base_lr, sol.max_iter, warmup_iters=0, power=sol.poly_power))
    parts = (model, criterion, optimizer, scheduler)
    batch = bench_train.synthetic_batch(cfg.model.num_classes, TRAIN_HW, dev,
                                        frames=CC_TRAIN_FRAMES)
    gen = torch.Generator(device=dev).manual_seed(1)
    held = {n for g in optimizer.param_groups for n in g["names"]}
    cc_names = {f"cc_module.{n}" for n, _ in model.cc_module.named_parameters()}
    log(f"train cc convnext_large: built the CC training model, "
        f"{sum(p.numel() for p in model.segmenter.parameters()) / 1e6:.1f} M "
        f"frozen segmenter parameters, "
        f"{sum(p.numel() for p in model.cc_module.parameters()) / 1e6:.2f} M "
        f"CC parameters (the optimizer holds {len(held)} tensors), losses "
        f"{criterion.losses}, {time.perf_counter() - t0:.2f} s")
    if held != cc_names or model.segmenter.training or not model.training:
        raise AssertionError("the optimizer holds other than the CC module, "
                             "or the segmenter is not frozen in eval()")
    wake_cc_segmenter(torch, model)
    seg0 = {n: v.clone() for n, v in model.segmenter.state_dict().items()}
    cc0 = {n: v.clone() for n, v in model.cc_module.state_dict().items()}
    with torch.inference_mode():  # warm-up of the segmenter, not counted
        model.segmenter(torch.zeros(T, *TRAIN_HW, 3, device=dev))
    torch.cuda.synchronize()

    # CUDA events around the step's parts (informational)
    spans = {k: [] for k in ("segmenter", "alignment", "cc_forward")}

    def timed(key, fn):
        return cuda_spans(torch, spans[key], fn)

    align_in = {}

    def align(embeddings, centers, *args, **kwargs):
        align_in.setdefault("args", (embeddings.clone(), centers.clone()))
        return real_align(embeddings, centers, *args, **kwargs)

    real_align = maxtron_cc.align_clip_queries
    maxtron_cc.align_clip_queries = timed("alignment", align)
    model.clip_outputs = timed("segmenter", model.clip_outputs)
    model.cc_module.forward = timed("cc_forward", model.cc_module.forward)
    torch.cuda.reset_peak_memory_stats()
    totals = {k: 0 for k in counted_kernels()}
    captured, ms, steps = {}, [], []
    want = expect(K1=CONVNEXT_L_BLOCKS * CC_TRAIN_CLIPS,
                  K2=K2_WC_CALLS * CC_TRAIN_CLIPS,
                  K3=4 * K3_WC_CALLS * CC_TRAIN_CLIPS + CC_LAYERS)
    want_calls = sorted(
        [(dev.type, "bfloat16", T)] * (4 * K3_WC_CALLS * CC_TRAIN_CLIPS)
        + [(dev.type, "float32", CC_TRAIN_CLIPS)] * CC_LAYERS)
    try:
        for step in range(TRAIN_STEPS):
            box = captured if step == 0 else {}
            marks = {}

            def mark(name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks[name] = ev

            for v in spans.values():
                v.clear()
            reset_counts()
            with traj_calls(box, lambda a: "K3" if a[0].dtype == torch.float32
                            else None):  # the CC module's first call
                mark("start")
                losses = train_step(*parts, batch, gen, mark=mark)
                torch.cuda.synchronize()
            launches = read_counts()
            for k, v in launches.items():
                totals[k] += v
            ms.append(marks["start"].elapsed_time(marks["optimizer"]))
            span = {k: sum(a.elapsed_time(b) for a, b in v)
                    for k, v in spans.items()}
            steps.append({
                **span,
                "criterion": marks["forward"].elapsed_time(marks["criterion"]),
                "backward": marks["criterion"].elapsed_time(marks["backward"]),
                "optimizer": marks["backward"].elapsed_time(
                    marks["optimizer"])})
            cc_grads = {n: p.grad for n, p in model.named_parameters()
                        if n in cc_names}
            finite = all(g is not None and g.dtype == torch.float32
                         and bool(g.isfinite().all()) for g in cc_grads.values())
            proj = {n: g.abs().max().item() for n, g in cc_grads.items()
                    if g is not None and n.endswith(CC_TRAJ_PROJECTIONS)}
            seg_grads = [p for p in model.segmenter.parameters()
                         if p.grad is not None]
            calls = sorted(box["calls"])
            log(f"train cc convnext_large step {step}: total_loss "
                f"{losses['total_loss']:.6g}, {len(losses) - 1} losses; "
                f"launches {launches} (want {want}); K3 calls (device, dtype, "
                f"frames) {sorted(set(calls))}, {calls.count(want_calls[-1])} "
                f"of them f32 at f={CC_TRAIN_CLIPS}; CC gradients f32 and "
                f"finite {finite}, {len(proj)} trajectory projections, min "
                f"max|grad| {min(proj.values()):.3g}; {len(seg_grads)} "
                f"segmenter gradients; {ms[-1]:.2f} ms")
            if not all(math.isfinite(v) for v in losses.values()):
                raise AssertionError(f"train cc step {step}: losses {losses}")
            if (launches != want or calls != want_calls or not finite
                    or len(proj) != 4 * CC_LAYERS or seg_grads):
                raise AssertionError(
                    f"train cc step {step}: launches {launches}, K3 calls "
                    f"{sorted(set(calls))}, finite {finite}, {len(proj)} "
                    f"projections, {len(seg_grads)} segmenter gradients")
            if not min(proj.values()) > 0:
                raise AssertionError(f"train cc step {step}: zero projection "
                                     f"grads {[n for n, v in proj.items() if v == 0]}")
    finally:
        maxtron_cc.align_clip_queries = real_align
        del model.clip_outputs, model.cc_module.forward
    peak = torch.cuda.max_memory_allocated() / 2**30
    reached = {n for n, p in model.cc_module.named_parameters()
               if p.grad is not None and p.grad.any()}
    changed_seg = [n for n, v in model.segmenter.state_dict().items()
                   if not torch.equal(v, seg0[n])]
    moved = {n for n, v in model.cc_module.state_dict().items()
             if not torch.equal(v, cc0[n])}
    stats = {n for n in cc0 if "running" in n}
    log(f"train cc convnext_large after {TRAIN_STEPS} steps: {len(changed_seg)}"
        f" of {len(seg0)} segmenter tensors changed; {len(moved)} of "
        f"{len(cc0)} CC module tensors moved (every one of the {len(reached)} "
        f"with a non-zero gradient: {reached <= moved}; BatchNorm statistics "
        f"{len(stats & moved)} of {len(stats)})")
    if changed_seg or not reached <= moved or stats - moved:
        raise AssertionError(f"train cc: segmenter changed {changed_seg[:5]}, "
                             f"CC not moved {sorted(reached - moved)[:5]} "
                             f"{sorted(stats - moved)}")
    del seg0, cc0
    # the profiler's bookkeeping takes about 16 s a pair of 75,800 kernels:
    # step 0's first pair alone, again
    lap = Laps("train cc convnext_large")
    embeddings, centers = align_in.pop("args")
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        real_align(embeddings[:2], centers[:2], exact=False)
        torch.cuda.synchronize()
    pair_kernels = sum(1 for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
    del prof
    lap(f"step 0's first clip pair aligned again under the profiler "
        f"({pair_kernels} kernels)")
    del parts, model, batch, optimizer, scheduler
    torch.cuda.empty_cache()
    args = captured.pop("K3")
    if args[7] != CC_TRAIN_CLIPS:
        raise AssertionError(f"the captured K3 call has f = {args[7]}")
    backward = _check_train_backward(torch, {"K3": args}, ("K3",))
    # K3's autograd Function at these inputs, warm: the kernel forward alone
    # and the forward with the plain-VJP backward
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core
    plain_args = [a[0] if isinstance(a, _Leaf) else a for a in args]
    with torch.no_grad():
        fwd = cuda_ms(torch, lambda: trajectory_attention_core(*plain_args),
                      launches=5, repeats=3)
    both = cuda_ms(torch, lambda: _function_grads(
        torch, trajectory_attention_core, args, 7), launches=5, repeats=3)
    backward["K3"].update(forward_ms=fwd, forward_backward_ms=both)
    log(f"train cc convnext_large, K3 f32 at f={CC_TRAIN_CLIPS}, n=128 "
        f"({card}): the kernel forward {fwd:.4f} ms, forward and plain-VJP "
        f"backward {both:.4f} ms a call (CUDA events, warm, the inputs' "
        f"copies included)")
    del captured, args, plain_args
    med = statistics.median(ms)
    part_ms = {k: statistics.median(s[k] for s in steps) for k in steps[0]}
    log(f"train cc convnext_large ({card}): {TRAIN_STEPS} steps of one "
        f"{CC_TRAIN_FRAMES}-frame video at {TRAIN_HW[0]}x{TRAIN_HW[1]} "
        f"({CC_TRAIN_CLIPS} clips, {CC_TRAIN_PAIRS} aligned pairs), 24 GT "
        f"segments: ms per step {', '.join(f'{t:.2f}' for t in ms)} (median "
        f"{med:.2f}, CUDA events, eager, first step included); median parts "
        + ", ".join(f"{k} {v:.2f} ms ({v / med:.3f})"
                    for k, v in part_ms.items())
        + f"; the alignment's first pair {pair_kernels} kernels (about "
        f"{CC_TRAIN_PAIRS * pair_kernels} a step of {CC_TRAIN_PAIRS} pairs); "
        f"peak memory "
        f"{peak:.3f} GiB; launches {totals}")
    return totals, backward


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


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, on the host in f32."""
    got, want = (np.asarray(x.float().cpu() if hasattr(x, "float") else x,
                            np.float32) for x in (got, want))
    if got.shape != want.shape:
        raise AssertionError(f"{got.shape} != {want.shape}")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


#: the gamma that ``open_decoder_gammas`` gives the Tube-Link pixel
#: decoder's trajectory branches in a card-against-CPU comparison
K3_GAMMA = 0.5


def open_decoder_gammas(torch, model):
    """Set the gammas of the Tube-Link pixel decoder's trajectory branches
    (1e-6 at init, so that K3's output reaches the outputs scaled by 1e-6)
    to ``K3_GAMMA``, so that a wrong K3 shows in a comparison of the whole
    model's outputs. Raises if the model has no such branch."""
    from axial_vs_tpu_torch.models.tube_link.pixel_decoder import (
        FusedMSDATrajectoryAttention)

    branches = [m for m in model.modules()
                if isinstance(m, FusedMSDATrajectoryAttention)]
    if not branches:
        raise AssertionError("no trajectory branch in the pixel decoder")
    with torch.no_grad():
        for m in branches:
            m.gamma.fill_(K3_GAMMA)


def phase_tube_link_reference(torch, model):
    """A 5x96x160 tube through a copy of the model on the card (bf16,
    kernels) and in f32 on the CPU (the plain versions). In the copy the
    pixel decoder's gammas are opened (``open_decoder_gammas``), so that
    K3's branch reaches the outputs. The head's outputs pass a sigmoid <
    0.5 threshold, where bf16 may flip single mask bits, so they are
    checked for shape and finiteness only."""
    import copy

    dev = torch.device("cuda")
    card_model = copy.deepcopy(model)
    open_decoder_gammas(torch, card_model)
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

    worst = {k: rel_err(got[k], want[k]) for k in want}
    drift = {k: rel_err(cpu_bf16[k], want[k]) for k in want}
    log(f"tube-link reference (5x96x160 tube, gamma {K3_GAMMA}, card bf16 "
        "vs CPU f32 plain versions): max |diff| / max |ref| " + ", ".join(
            f"{k} {v:.4g}" for k, v in worst.items())
        + f"; bound {TL_REFERENCE_BOUND}; CPU bf16 plain versions vs the "
        "same f32 run: " + ", ".join(f"{k} {v:.4g}" for k, v in drift.items()))
    for k, v in worst.items():
        if not v <= TL_REFERENCE_BOUND:
            raise AssertionError(f"tube-link reference {k}: {v:.4g} > "
                                 f"{TL_REFERENCE_BOUND}")


#: the YTVIS eval phase's videos: frames of each, at the YTVIS size
YTVIS_VIDEOS, YTVIS_HW = (15, 36), (720, 1280)


class HostPeak:
    """While active, the process's peak resident memory (GiB), sampled from
    ``/proc/self/statm`` every 20 ms by a thread; ``base`` is the resident
    memory on entry (what earlier phases left), so ``peak - base`` is what
    the work inside needed on top of it."""

    def __enter__(self):
        import threading

        self._stop = threading.Event()
        page = os.sysconf("SC_PAGE_SIZE")

        def rss():
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * page / 2**30

        self.base = self.peak = rss()

        def sample():
            while True:
                self.peak = max(self.peak, rss())
                if self._stop.wait(0.02):
                    return

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def phase_ytvis_eval(torch, root: str):
    """``evaluate_ytvis`` on two synthetic 720x1280 YTVIS videos (15 and
    36 frames, ground truth from ``data/synthetic.py::write_ytvis_videos``)
    for both Tube-Link R50 configurations at full width, bf16, 360x640
    tubes of 5, random weights from seed 0: with MaXTron's temporal
    attention (K2 and K3) and without it (the baseline: K2 only), each
    built by the registry (``build_model_and_criterion``). Checks finite
    AP/AR, the predictions and the launch counts; logs frames/s, the
    forward's share (CUDA events), the host upsample's and RLE's shares,
    the JSON's size, the host threads and peak device and host memory.
    Returns the launch counts of each run."""
    import axial_vs_tpu_torch.data.ytvis as ytvis
    from axial_vs_tpu_torch.data.synthetic import write_ytvis_videos
    from axial_vs_tpu_torch.engine import evaluator_loop
    from axial_vs_tpu_torch.models.build import build_model_and_criterion
    from axial_vs_tpu_torch.models.tube_link.detector import (
        TubeLinkVISInference, video_split)

    laps = Laps("ytvis eval")
    dev = torch.device("cuda")
    name = "ytvis_chip_smoke_val"
    # stored PNGs (zlib level 0): the noisy frames compress little, and
    # PIL's default level 6 took 10.6 s for these 51 frames on the host of
    # an H100 machine
    meta = ytvis.register_ytvis(name, *write_ytvis_videos(
        root, len(YTVIS_VIDEOS), YTVIS_VIDEOS, hw=YTVIS_HW, compress_level=0))
    # the model's 40 classes are YTVIS-2019's category ids 1-40; the
    # synthetic ground truth is in categories 1 and 2
    meta.contiguous_to_dataset_id = list(
        range(1, tube_link_r50_config().model.num_classes + 1))
    laps(f"wrote {len(YTVIS_VIDEOS)} videos of {YTVIS_VIDEOS} frames at "
         f"{YTVIS_HW[0]}x{YTVIS_HW[1]}; {evaluator_loop.host_threads()} host "
         f"threads for the upsample (os.cpu_count() {os.cpu_count()})")
    tubes = sum(len(video_split(v, TL_T)) for v in YTVIS_VIDEOS)
    frames = sum(YTVIS_VIDEOS)
    spans, host = [], {"upsample": 0.0, "rle": 0.0}

    def host_timed(key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                host[key] += time.perf_counter() - t0
        return wrapper

    real = (TubeLinkVISInference.tube_forward,
            evaluator_loop.upsample_instances, ytvis.results_to_ytvis_json)
    out = {}
    try:
        TubeLinkVISInference.tube_forward = cuda_spans(torch, spans, real[0])
        evaluator_loop.upsample_instances = host_timed("upsample", real[1])
        ytvis.results_to_ytvis_json = host_timed("rle", real[2])
        for label, temporal in (("temporal", True), ("baseline", False)):
            cfg = tube_link_r50_config()
            cfg.merge_from_list([
                "model.tube_link.use_temporal_attn", temporal,
                "input.image_size", [TL_H, TL_W], "datasets.test", [name]])
            model, criterion = build_model_and_criterion(
                cfg, train=False, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
            assert not (criterion.exact_matching or model.training)
            with torch.inference_mode():  # warm-up tube (kernel selection)
                model(torch.zeros(TL_T, TL_H, TL_W, 3, device=dev))
            torch.cuda.synchronize()
            spans.clear()
            host.update(upsample=0.0, rle=0.0)
            path = os.path.join(root, f"results_{label}.json")
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            with HostPeak() as peak:
                res = evaluator_loop.evaluate_ytvis(cfg, model,
                                                    format_only_path=path)
            wall = time.perf_counter() - t0
            launches = read_counts()
            fwd = sum(a.elapsed_time(b) for a, b in spans) / 1e3
            dev_peak = torch.cuda.max_memory_allocated() / 2**30
            want = expect(K2=K2_TL_CALLS * tubes,
                          K3=4 * K3_TL_CALLS * tubes if temporal else 0)
            fields = {k: v for k, v in res.items()
                      if k not in ("results_json", "per_category_AP")}
            k = cfg.model.tube_link.test_topk
            biggest = k * max(YTVIS_VIDEOS) * YTVIS_HW[0] * YTVIS_HW[1]
            log(f"ytvis eval {label} (use_temporal_attn {temporal}): "
                f"{frames} frames in {tubes} tubes, {wall:.2f} s, "
                f"{frames / wall:.3f} frames/s; forward {fwd:.2f} s "
                f"({fwd / wall:.3f}, CUDA events, {len(spans)} tubes), host "
                f"upsample {host['upsample']:.2f} s "
                f"({host['upsample'] / wall:.3f}), RLE {host['rle']:.2f} s "
                f"({host['rle'] / wall:.3f}); results JSON "
                f"{os.path.getsize(path) / 2**20:.2f} MiB, "
                f"{res['num_predictions']} predictions; peak device "
                f"{dev_peak:.3f} GiB, host RSS {peak.base:.3f} GiB before "
                f"the eval, its peak {peak.peak - peak.base:.3f} GiB above "
                f"that (the largest video's masks {biggest / 2**30:.3f} GiB, "
                f"its f32 probabilities {4 * biggest / 2**30:.3f}); AP/AR "
                + json.dumps(fields))
            log(f"ytvis eval {label}: launches {launches} (want {want})")
            if launches != want:
                raise AssertionError(f"ytvis eval {label}: launches {launches}")
            if (res["num_videos"] != len(YTVIS_VIDEOS)
                    or res["num_predictions"] != k * len(YTVIS_VIDEOS)
                    or not all(math.isfinite(v) for v in fields.values()
                               if isinstance(v, float))
                    or not all(math.isfinite(v) for v in
                               res["per_category_AP"].values())):
                raise AssertionError(f"ytvis eval {label}: {res}")
            out[label] = launches
            del model
            torch.cuda.empty_cache()
            laps(label)
    finally:
        (TubeLinkVISInference.tube_forward, evaluator_loop.upsample_instances,
         ytvis.results_to_ytvis_json) = real
    return out


@contextlib.contextmanager
def overfit_calls(box: dict):
    """While active, each K3 call of the trajectory layers appends (head
    width, whether it runs under autograd: grad mode on and an input that
    requires grad) to ``box["K3 calls"]``, and the arguments of the first
    K2 and the first K3 call under autograd and outside it are kept in
    ``box[(key, grad)]`` (detached copies on the card as ``_Leaf``, as
    ``first_train_calls`` keeps them)."""
    import torch

    from axial_vs_tpu_torch.layers import msda_attention, trajectory_attention

    sites = ((msda_attention, "ms_deform_attn", "K2"),
             (trajectory_attention, "trajectory_attention_core", "K3"))
    box["K3 calls"] = []

    def wrap(real, key):
        def call(*args, **kwargs):
            grad = torch.is_grad_enabled() and any(
                getattr(a, "requires_grad", False) for a in args)
            if key == "K3":
                box["K3 calls"].append((args[0].shape[-1] // int(args[8]),
                                        grad))
            if (key, grad) not in box:
                box[(key, grad)] = tuple(
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


def _check_forward(torch, captured):
    """The kernels of ``captured`` (K2, K3: the arguments of a call, tensors
    as ``_Leaf``) against their plain versions at those arguments, outside
    autograd, within the bounds of ``_check_train_backward``'s forward."""
    out = {}
    with torch.no_grad():
        for key, args in captured.items():
            fn, plain, ulps = _kernel_and_plain()[key]
            leaves = [a[0] if isinstance(a, _Leaf) else a for a in args]
            got, want = fn(*leaves), plain(*leaves)
            err = (got.float() - want.float()).abs().max().item()
            bound = (ulps * bf16_ulp(want.float().abs().max().item())
                     if got.dtype == torch.bfloat16 else f32_bound(want))
            out[key] = {"dtype": str(got.dtype)[6:], "max_abs_err": err,
                        "bound": bound,
                        "shape": list(leaves[0].shape)}
            log(f"forward {key} {out[key]['dtype']} at "
                f"{out[key]['shape']}: |kernel - plain| {err:.3g} (bound "
                f"{bound:.3g})")
            if not (err <= bound and torch.isfinite(got.float()).all()):
                raise AssertionError(f"forward {key}: {out[key]}")
    return out


def check_overfit_tool(torch, label: str, main, argv, want=None,
                       grad_calls=None):
    """``main(argv)``, an overfit tool's steps and one eval on the card
    (``--target 0``), under ``overfit_calls``: exit 0, K3 at head width 8
    only, every K3 call launched, some under autograd, K2 launched (and,
    where given, exactly the launches ``want`` and ``grad_calls`` K3 calls
    under autograd). Then holds K2 and K3 on the first call of each in the
    steps (forward and the autograd backward, ``_check_train_backward``)
    and in the eval (``_check_forward``) to their plain versions. Returns
    the launch counts and, by kernel, those checks."""
    box = {}
    reset_counts()
    with overfit_calls(box):
        rc = main(argv)
    launches = read_counts()
    calls = box["K3 calls"]
    widths = sorted({d for d, _ in calls})
    grads = sum(g for _, g in calls)
    log(f"{label}: rc {rc}, {len(calls)} K3 calls at head widths {widths}, "
        f"{grads} under autograd; launches {launches} (want {want})")
    if (rc != 0 or widths != [8] or not grads or launches["K2"] == 0
            or launches["K3"] != len(calls)
            or (want is not None and launches != want)
            or (grad_calls is not None and grads != grad_calls)):
        raise AssertionError(f"{label}: rc {rc}, calls {calls}, launches "
                             f"{launches}")
    log(f"{label}, the steps' first K2 and K3 calls (d = 8):")
    step = _check_train_backward(torch, {k: box[(k, True)]
                                         for k in ("K2", "K3")})
    log(f"{label}, the eval's first K2 and K3 calls (d = 8):")
    evals = _check_forward(torch, {k: box[(k, False)] for k in ("K2", "K3")})
    return launches, {k: {"step": step[k], "eval": evals[k]}
                      for k in ("K2", "K3")}


def phase_overfit_heads(torch, root: str):
    """The port's WC overfit tool for one step and one eval on the card
    (``tools/validate_overfit.py``, the JAX tool's module: 64 channels in
    8 heads of 8): K3 runs at head width 8, under autograd in the step;
    ``check_overfit_tool``'s checks."""
    from axial_vs_tpu_torch.tools import validate_overfit

    return check_overfit_tool(
        torch, "overfit tool, one step and one eval", validate_overfit.main,
        ["--steps", "1", "--eval-every", "1", "--target", "0", "--out", root,
         "--device", "cuda"])


#: the Tube-Link training phase (``configs/ytvis19/tube_link_maxtron_wc_
#: r50.yaml`` at full width): its steps, and the frames of the synthetic
#: 720x1280 YTVIS videos its mapper samples 5-frame tubes from
TL_TRAIN_YAML = "ytvis19/tube_link_maxtron_wc_r50.yaml"
TL_TRAIN_STEPS = 3
#: tubes a step: the yaml's ``solver.ims_per_batch`` is 8, whose forward
#: alone outgrew the card's 80 GB (77.76 GiB allocated at the criterion of
#: the first layer); the largest batch that fits (peak 69.157 GiB at 7,
#: 59.387 at 6, 49.668 at 5 on an NVIDIA H100 80GB HBM3)
TL_TRAIN_BATCH = 7
TL_TRAIN_VIDEOS = (12, 9)
#: launches of one Tube-Link training step: one forward of the pixel
#: decoder over every tube of the batch (6 encoder layers; K3 on 2 levels x
#: the H and W axes each); the backward is the plain versions' VJP
TL_TRAIN_K2, TL_TRAIN_K3 = K2_TL_CALLS, 4 * K3_TL_CALLS
#: JAX's loss names: the 9 decoder layers' (d0. - d8.) and the last one's
TL_LOSS_NAMES = sorted([f"d{i}.{k}" for i in range(9)
                        for k in ("loss_cls", "loss_mask", "loss_dice")]
                       + ["loss_cls", "loss_mask", "loss_dice"])


@contextlib.contextmanager
def matching_spans(torch, spans: list):
    """While active, each assignment of the Tube-Link criterion
    (``hungarian_assign``, the profiler range ``matching``) is bracketed by
    CUDA events, kept in ``spans`` as (start, end)."""
    from axial_vs_tpu_torch.models.tube_link import criterion

    real = criterion.hungarian_assign

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    criterion.hungarian_assign = timed
    try:
        yield
    finally:
        criterion.hungarian_assign = real


def phase_train_tube_link(torch, root: str, card: str):
    """``TL_TRAIN_STEPS`` steps of ``train_step`` on the Tube-Link VIS model
    of ``configs/ytvis19/tube_link_maxtron_wc_r50.yaml`` at full width (R50,
    100 queries, 9 decoder layers, 256 channels, 40 classes, f32, AdamW with
    clip 0.01, the device auction), built with its criterion by the
    registry, on batches of ``TL_TRAIN_BATCH`` tubes of 5 frames at
    512x512 (the yaml's 8 outgrow the card) that the
    config's YTVIS mapper (multiscale 0.5-1.5) cuts from two synthetic
    720x1280 videos (``write_ytvis_videos``), loaded before the steps.
    Checks each step's 30 losses (JAX's names) finite, the launches (K2
    and K3 each step), finite gradients, the parameters moved; the first
    step's auction against the CPU's (``check_auction``); and K2's and
    K3's forward and backward at the first step's first calls against
    their plain versions. Logs ms a step (CUDA events, median of steps 2
    and 3), the matching's share (CUDA events around each assignment) and
    the peak memory. Returns the launch counts and the backward check."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.data.build import build_mapper
    from axial_vs_tpu_torch.data.catalog import DatasetCatalog
    from axial_vs_tpu_torch.data.loader import ClipDataLoader, to_device
    from axial_vs_tpu_torch.data.synthetic import write_ytvis_videos
    from axial_vs_tpu_torch.data.ytvis import register_ytvis
    from axial_vs_tpu_torch.engine.lr_schedule import tf2_warmup_poly_lr
    from axial_vs_tpu_torch.engine.optim import build_optimizer
    from axial_vs_tpu_torch.engine.train_step import train_step
    from axial_vs_tpu_torch.models.build import build_model_and_criterion

    laps = Laps("train tube-link")
    dev = torch.device("cuda")
    full_f32(torch)
    log(f"train tube-link: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"of the card held by earlier phases")
    name = "ytvis_chip_smoke_train"
    register_ytvis(name, *write_ytvis_videos(
        root, len(TL_TRAIN_VIDEOS), TL_TRAIN_VIDEOS, hw=YTVIS_HW,
        compress_level=0))
    cfg = load_config(TL_TRAIN_YAML, ["datasets.train", [name],
                                      "datasets.test", [], "output_dir", root])
    if cfg.solver.ims_per_batch != 8:
        raise AssertionError(f"the yaml trains {cfg.solver.ims_per_batch} "
                             "tubes a step, not 8")
    cfg.solver.ims_per_batch = TL_TRAIN_BATCH
    sol, tl = cfg.solver, cfg.model.tube_link
    queries = tl.num_queries
    if not (cfg.model.backbone.name == "resnet50" and tl.num_queries == 100
            and tl.num_decoder_layers == 9 and tl.feat_channels == 256
            and cfg.model.num_classes == 40 and cfg.model.dtype == "float32"
            and cfg.input.num_video_frames == TL_T
            and list(cfg.input.image_size) == [512, 512]
            and sol.clip_gradients.enabled
            and sol.clip_gradients.clip_value == 0.01):
        raise AssertionError(f"not the yaml's full-width config: {cfg}")
    model, criterion = build_model_and_criterion(
        cfg, train=True, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    if criterion.exact_matching or not model.training:
        raise AssertionError("want the auction and a model in train()")
    optimizer, scheduler = build_optimizer(cfg, model, tf2_warmup_poly_lr(
        sol.base_lr, sol.max_iter, warmup_iters=sol.warmup_iters,
        power=sol.poly_power))
    loader = ClipDataLoader(DatasetCatalog.get(name), build_mapper(cfg),
                            batch_size=sol.ims_per_batch, num_workers=0)
    it = iter(loader)
    batches = [to_device(next(it), dev) for _ in range(TL_TRAIN_STEPS)]
    shapes = {k: list(v.shape) for k, v in batches[0]["targets"].items()}
    gts = [int(b["targets"]["valid"].sum()) for b in batches]
    laps(f"wrote {TL_TRAIN_VIDEOS} frames at {YTVIS_HW[0]}x{YTVIS_HW[1]}, "
         f"built the model ({sum(p.numel() for p in model.parameters())} "
         f"parameters) and mapped {TL_TRAIN_STEPS} batches: images "
         f"{list(batches[0]['images'].shape)}, targets {shapes}, valid GTs "
         f"{gts}")
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    totals = {k: 0 for k in counted_kernels()}
    captured, ms, match_ms, parts = {}, [], [], []
    want = expect(K2=TL_TRAIN_K2, K3=TL_TRAIN_K3)
    for step, batch in enumerate(batches):
        box, spans, marks = captured if step == 0 else {}, [], []

        def mark(name):
            marks.append((name, torch.cuda.Event(enable_timing=True)))
            marks[-1][1].record()

        reset_counts()
        with (first_train_calls(box), matching_spans(torch, spans),
              first_auction_call(box) if step == 0 else contextlib.nullcontext()):
            mark("start")
            losses = train_step(model, criterion, optimizer, scheduler, batch,
                                gen, mark=mark)
            marks[-1][1].synchronize()
        ms.append(marks[0][1].elapsed_time(marks[-1][1]))
        match_ms.append(sum(a.elapsed_time(b) for a, b in spans))
        parts.append({name: round(marks[i - 1][1].elapsed_time(ev), 2)
                      for i, (name, ev) in enumerate(marks) if i})
        launches = read_counts()
        for k, v in launches.items():
            totals[k] += v
        finite = bool(torch.stack([p.grad.isfinite().all()
                                   for p in model.parameters()]).all())
        names = sorted(k for k in losses if k != "total_loss")
        log(f"train tube-link step {step}: total_loss "
            f"{losses['total_loss']:.6g}, {len(names)} losses; launches "
            f"{launches} (want {want}); gradients finite {finite}; "
            f"{len(spans)} assignments, {match_ms[-1]:.2f} ms of "
            f"{ms[-1]:.2f} ms; parts (CUDA events) {parts[-1]}")
        if (names != TL_LOSS_NAMES or launches != want or not finite
                or not all(math.isfinite(v) for v in losses.values())
                or len(spans) != 10 or set(box["devices"]) != {"cuda"}):
            raise AssertionError(f"train tube-link step {step}: {losses}, "
                                 f"launches {launches}, finite {finite}")
    changed = [n for n, p in model.named_parameters()
               if not torch.equal(p, params0[n])]
    log(f"train tube-link: {len(changed)} of {len(params0)} parameter "
        f"tensors moved")
    if 2 * len(changed) < len(params0):
        raise AssertionError("train tube-link: the parameters did not move")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, optimizer, batches, params0
    torch.cuda.empty_cache()
    laps("the steps")
    auction = check_auction(torch, *captured.pop("auction"))
    log(f"train tube-link, step 0's first auction (cost {auction['valid_columns']}"
        f" valid columns of {queries}): {json.dumps(auction)}")
    backward = _check_train_backward(torch, captured)
    del captured
    torch.cuda.empty_cache()
    laps("the auction's and the kernels' checks")
    step_ms = statistics.median(ms[1:])
    share = statistics.median(m / s for m, s in zip(match_ms[1:], ms[1:]))
    log(f"train tube-link ({card}): {TL_TRAIN_STEPS} steps of "
        f"{TL_TRAIN_BATCH} tubes of "
        f"{TL_T} frames at 512x512, f32: ms per step "
        f"{', '.join(f'{t:.2f}' for t in ms)} (median of steps 2-3 "
        f"{step_ms:.2f}, CUDA events, eager); matching ms per step "
        f"{', '.join(f'{t:.2f}' for t in match_ms)} (10 auctions of "
        f"{queries} columns, share of the step {share:.4f}, median of "
        f"steps 2-3); peak memory {peak:.3f} GiB; launches {totals}")
    return totals, backward


#: the Tube-Link reference step: the narrow model of
#: ``tests/test_torch_tube_link_train.py`` (R18, 64 channels: K3 at heads of
#: 8, 2 decoder layers, 8 queries, 5 classes, 64x64 tubes of 2, 2 tubes)
TL_REF_OPTS = ["model.backbone.name", "resnet18",
               "model.backbone.resnet.depth", 18, "model.num_classes", 5,
               "model.tube_link.num_queries", 8,
               "model.tube_link.feat_channels", 64,
               "model.tube_link.out_channels", 64,
               "model.tube_link.num_decoder_layers", 2,
               "input.num_clip_frames", 2, "input.num_video_frames", 2,
               "input.image_size", [64, 64], "datasets.train", []]
#: bounds of the card's f32 step against the CPU's on the same weights,
#: batch, draws and points: each loss, relative; each parameter's gradient
#: within ``TL_REF_GRAD_BOUND`` of its max on the CPU, or within
#: ``TL_REF_JITTER`` times as far as the CPU's own gradient moves when the
#: frames are scaled by 1 +- 2^-22 (a few f32 ulps: at 64x64 the early
#: ResNet layers' gradients move by up to 2.7% of their max so on the CPU
#: alone), or, for a gradient that is zero in exact arithmetic (a key bias
#: of a softmax attention), below ``TL_REF_GRAD_NOISE`` of the step's
#: largest gradient on both devices
TL_REF_LOSS_BOUND = 1e-4
TL_REF_GRAD_BOUND = 1e-3
TL_REF_JITTER = 8
TL_REF_GRAD_NOISE = 1e-6


class CriterionReplay:
    """Records the Tube-Link criterion's random match points (``_randint``
    outside the point sampling) and its sampled loss points
    (``uncertainty_point_idx``) in one run, and replays them in another:
    then both runs sample the same points, though the |logit| ranking of
    the uncertain points may break near-ties apart on two devices."""

    def __init__(self):
        self.draws, self.points = [], []

    @contextlib.contextmanager
    def record(self):
        from axial_vs_tpu_torch.models.tube_link import criterion as mod

        real = (mod._randint, mod.uncertainty_point_idx)
        inside = []

        def points(*args, **kwargs):
            inside.append(True)
            try:
                out = real[1](*args, **kwargs)
            finally:
                inside.pop()
            self.points.append(out.cpu())
            return out

        def draw(*args, **kwargs):
            out = real[0](*args, **kwargs)
            if not inside:
                self.draws.append(out.cpu())
            return out

        mod._randint, mod.uncertainty_point_idx = draw, points
        try:
            yield
        finally:
            mod._randint, mod.uncertainty_point_idx = real

    @contextlib.contextmanager
    def replay(self):
        from axial_vs_tpu_torch.models.tube_link import criterion as mod

        real = (mod._randint, mod.uncertainty_point_idx)
        draws, points = iter(self.draws), iter(self.points)

        def draw(generator, shape, high, device):
            out = next(draws)
            assert tuple(out.shape) == tuple(shape), (out.shape, shape)
            return out.to(device)

        mod._randint = draw
        mod.uncertainty_point_idx = lambda g, logits, *a, **k: next(
            points).to(logits.device)
        try:
            yield
        finally:
            mod._randint, mod.uncertainty_point_idx = real


def phase_tube_link_train_reference(torch):
    """One ``train_step`` of the narrow Tube-Link model (``TL_REF_OPTS``)
    on the card in f32 (K2, K3 at heads of 8) and on the CPU (their plain
    versions), from the same weights on the same batch, the CPU replaying
    the card's draws and sampled points, both matched exactly (scipy: the
    auction on equal costs is held to the CPU's in ``phase_train_tube_link``);
    and two more CPU steps on the frames scaled by 1 +- 2^-22, for how far
    the CPU's own gradients move. Checks every loss and every parameter's
    gradient (``TL_REF_*``). Returns the card run's launch counts."""
    import copy

    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.engine.lr_schedule import tf2_warmup_poly_lr
    from axial_vs_tpu_torch.engine.optim import build_optimizer
    from axial_vs_tpu_torch.engine.train_step import train_step
    from axial_vs_tpu_torch.models.build import build_model_and_criterion

    full_f32(torch)
    cfg = load_config(TL_TRAIN_YAML, TL_REF_OPTS)
    sol = cfg.solver
    model, criterion = build_model_and_criterion(
        cfg, train=True, device=torch.device("cpu"),
        generator=torch.Generator().manual_seed(0))
    criterion.exact_matching = True
    rs = np.random.RandomState(0)
    b, t, m, hw = 2, 2, 4, 16
    images = torch.from_numpy(
        rs.randn(b * t, 4 * hw, 4 * hw, 3).astype(np.float32))
    targets = {"labels": torch.from_numpy(rs.randint(0, 5, (b, m))),
               "masks": torch.from_numpy(
                   (rs.rand(b, m, t, hw, hw) > 0.6).astype(np.float32)),
               "valid": torch.tensor([[True, False, False, False],
                                      [True, True, True, False]])}
    replay = CriterionReplay()

    def step(where, scale=1.0):
        net = copy.deepcopy(model).to(where)
        opt, sched = build_optimizer(cfg, net, tf2_warmup_poly_lr(
            sol.base_lr, sol.max_iter, warmup_iters=sol.warmup_iters,
            power=sol.poly_power))
        grads = {}
        for n, p in net.named_parameters():  # the gradient before the clip
            p.register_hook(lambda g, n=n: grads.__setitem__(n, g.cpu()))
        with replay.record() if where == "cuda" else replay.replay():
            losses = train_step(net, criterion, opt, sched,
                                {"images": (images * scale).to(where),
                                 "targets": {k: v.to(where) for k, v in
                                             targets.items()}},
                                torch.Generator(device=where).manual_seed(1))
        return losses, grads

    reset_counts()
    got, g_got = step("cuda")
    launches = read_counts()
    want, g_want = step("cpu")
    moved = [step("cpu", np.float32(1 + e))[1] for e in (2 ** -22, -2 ** -22)]
    loss_err = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                   for k in want)
    noise = TL_REF_GRAD_NOISE * max(g.abs().max().item()
                                    for g in g_want.values())
    plain, jittery, noisy, bad, worst = 0, [], [], [], (0.0, "")
    for n, w in g_want.items():
        err = (g_got[n] - w).abs().max().item()
        rel = err / max(w.abs().max().item(), 1e-30)
        jitter = max((g[n] - w).abs().max().item() for g in moved)
        if rel <= TL_REF_GRAD_BOUND:
            plain += 1
            worst = max(worst, (rel, n))
        elif err <= TL_REF_JITTER * jitter:
            jittery.append(f"{n} {rel:.3g} ({err / max(jitter, 1e-30):.2f}x)")
        elif max(g_got[n].abs().max().item(), w.abs().max().item()) <= noise:
            noisy.append(n)
        else:
            bad.append(f"{n} {rel:.3g}")
    log(f"tube-link train reference, card f32 against CPU f32: {len(want)} "
        f"losses, max relative |diff| {loss_err:.3g} (bound "
        f"{TL_REF_LOSS_BOUND}); {len(g_want)} gradients: {plain} within "
        f"{TL_REF_GRAD_BOUND} of their max (the largest {worst[0]:.3g}, "
        f"{worst[1]}), {len(jittery)} within {TL_REF_JITTER}x the CPU's own "
        f"move at 1 +- 2^-22 (|diff| / max, |diff| / move): {jittery}; "
        f"{len(noisy)} zero in exact arithmetic, below {noise:.3g}; "
        f"{len(replay.draws)} draws and {len(replay.points)} point sets "
        f"replayed; launches {launches}")
    if (sorted(got) != sorted(want) or loss_err > TL_REF_LOSS_BOUND or bad
            or len(g_got) != len(g_want)
            or launches != expect(K2=TL_TRAIN_K2, K3=TL_TRAIN_K3)):
        raise AssertionError(f"tube-link train reference: losses {got} / "
                             f"{want}, gradients {bad}, launches {launches}")
    return launches


#: launches of the VIS overfit tool's two steps and one eval of its two
#: 8-frame videos in tubes of 2 (each step and tube: K2 6, K3 24)
OVERFIT_VIS_STEPS, OVERFIT_VIS_TUBES = 2, 2 * 4


def phase_overfit_vis(torch, root: str):
    """The port's Tube-Link VIS overfit tool (``tools/validate_overfit_vis.
    py``: R18, 64 channels, the pixel decoder's 8 heads of 8) for
    ``OVERFIT_VIS_STEPS`` steps and one eval on the card: K3 at head width
    8, under autograd in the steps; ``check_overfit_tool``'s checks, with
    the launches of the steps and the eval's tubes."""
    from axial_vs_tpu_torch.tools import validate_overfit_vis

    runs = OVERFIT_VIS_STEPS + OVERFIT_VIS_TUBES
    return check_overfit_tool(
        torch, f"overfit vis tool, {OVERFIT_VIS_STEPS} steps and one eval",
        validate_overfit_vis.main,
        ["--steps", str(OVERFIT_VIS_STEPS), "--eval-every",
         str(OVERFIT_VIS_STEPS), "--target", "0", "--out", root,
         "--device", "cuda"],
        want=expect(K2=TL_TRAIN_K2 * runs, K3=TL_TRAIN_K3 * runs),
        grad_calls=TL_TRAIN_K3 * OVERFIT_VIS_STEPS)


# ---- Tube-Link VPS, cross-clip VIS and image Mask2Former -----------------

VPS_YAML = "vipseg/tube_link_vps_r50.yaml"
VPS_FRAMES, VPS_SOURCE_HW = 15, (720, 1280)  # 3 windows of 5 at VIPSeg's size
#: the VPS stream at zero thresholds: random weights pass none of the
#: defaults' gates (the fusion's 0.8 and the tracker's 0.3 / 0.35, over
#: softmaxes of 125 classes), so without these no segment or track exists
VPS_ZERO = dict(object_mask_thr=0.0, iou_thr=0.0, tracker_kwargs=dict(
    init_score_thr=0.0, obj_score_thr=0.0, match_score_thr=0.0))
#: bound on max |card - CPU| / max |CPU| of f32 outputs: both sides in f32
#: (TF32 off), the kernels within F32_REL_BOUND (1e-4) of their plain
#: versions, the rest cuDNN / cuBLAS against the CPU's sums in other
#: orders through 9 decoder layers
CARD_CPU_BOUND = 1e-3
#: share of the card's VPS id-map pixels equal to the CPU's on one window
VPS_ID_AGREEMENT = 0.999
#: most of the tube head's attention-mask bits in which the CPU's own masks
#: may differ from the card's in a card-against-CPU run: mask logits within
#: the f32 noise of 0 flip single bits (3-24 of millions a run on an H100);
#: a divergence that moves many logits across 0 flips far more
MASK_FLIP_SHARE = 1e-5
K2_TUBE = K2_TL_CALLS        # K2 calls a Tube-Link forward: 6 MSDA layers
K3_TUBE = 4 * K3_TL_CALLS    # K3 calls a tube: 6 layers x 2 levels x 2 axes
CC_VIS_YAML = "ytvis21/tube_link_maxtron_cc_r50.yaml"
CC_VIS_FRAMES = (15, 60)     # 3 clips of 5 (the yaml's video) and 12 clips
CC_VIS_QUERIES = 100
#: the CC VIS card-against-CPU video: 15 frames at half the driven height
#: and width (at 360x640 the CPU's plain versions took 45 s of the phase's
#: 48 on the H100's host)
CC_VIS_REF_HW = (180, 320)
IMAGE_YAML = "image/mask2former_r50_coco_panoptic_50e.yaml"


def vipseg_like_video(n: int, hw, seed: int):
    """n uint8 frames at hw: a background of blocks of colour (the stuff,
    80 pixels at 720x1280) and four squares of 80-180 pixels that move 8
    pixels a frame (the things)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    block, step = h // 9, w // 160
    bg = rng.integers(0, 256, (h // block + 1, w // block + 1, 3),
                      dtype=np.uint8)
    frames = np.repeat(np.repeat(bg, block, 0), block, 1)[None, :h, :w]
    frames = frames.repeat(n, 0)
    for _ in range(4):
        size = int(rng.integers(h // 9, h // 4))
        y = int(rng.integers(0, h - size))
        x = int(rng.integers(0, w - size - step * n))
        colour = rng.integers(0, 256, 3, dtype=np.uint8)
        for i in range(n):
            frames[i, y:y + size, x + step * i:x + step * i + size] = colour
    return frames


def check_vps_ids(maps, pipe, label: str):
    """The reference convention: void = num_classes, stuff and untracked
    things < num_classes, tracked things cls + (track + 1) * divisor with
    cls < num_things."""
    off = pipe.label_divisor
    for m in maps:
        if not (((m <= pipe.num_classes) | (m % off < pipe.num_things))
                & (m >= 0)).all():
            raise AssertionError(f"vps {label}: ids outside the convention: "
                                 f"{np.unique(m)[:20]}")


#: the factor on the tube head's residual branches in the VPS phase
VPS_WAKE = 0.1


def wake_tube_head(torch, head, scale: float = VPS_WAKE):
    """Scale the residual branches of the tube head's decoder layers (the
    attentions' ``out_proj`` and ``ffn2``) by ``scale``. At the drawn
    weights the 9 layers pull every query to one (mean cosine 0.995
    between queries after 3 layers, measured on the CPU), so that one query
    wins every pixel and no thing segment reaches the tracker; scaled, each
    query keeps its identity and the stream has segments and tracks."""
    with torch.no_grad():
        for layer in head.layers:
            for lin in (layer.cross_attn.out_proj, layer.self_attn.out_proj,
                        layer.ffn2):
                lin.weight.mul_(scale)


@contextlib.contextmanager
def shared_attention_masks(card_head, cpu_head, flips: list, label: str):
    """While active, the CPU's tube head masks its cross-attention with the
    card head's masks, call by call in the order the card made them (run
    the card first). Each mask is ``sigmoid(mask logit) < 0.5``: where a
    logit lies within the f32 noise of 0 the two devices may block other
    keys, and the layers after differ by far more than their sums' noise
    (the CC VIS model at 15x96x160 on an H100: 27 bits of the last
    layer's masks, 1e-3-5e-3 of max |ref| from the third layer on).
    ``flips`` gets, per call, the bits where the CPU's own mask differed;
    on exit, raises if they exceed ``MASK_FLIP_SHARE`` of the bits."""
    masks, bits = [], [0]
    real_card, real_cpu = card_head._heads, cpu_head._heads

    def card(*args):
        out = real_card(*args)
        masks.append(out[2].cpu())
        return out

    def cpu(*args):
        cls_pred, mask_pred, own = real_cpu(*args)
        theirs = masks.pop(0)
        flips.append(int((own != theirs).sum()))
        bits[0] += theirs.numel()
        return cls_pred, mask_pred, theirs

    card_head._heads, cpu_head._heads = card, cpu
    try:
        yield
    finally:
        del card_head._heads, cpu_head._heads
    share = sum(flips) / max(bits[0], 1)
    log(f"{label}: the CPU's own attention masks differ from the card's in "
        f"{sum(flips)} of {bits[0]} bits ({share:.3g}, bound "
        f"{MASK_FLIP_SHARE}) over {len(flips)} head calls: {flips}")
    if not (share <= MASK_FLIP_SHARE and not masks):
        raise AssertionError(f"{label}: attention masks diverge")


def recorded_forwards(pipe, box: list):
    """``pipe.window_forward`` keeping each window's outputs in ``box``."""
    real = pipe.window_forward

    def forward(images):
        box.append(real(images))
        return box[-1]

    pipe.window_forward = forward
    return pipe


def build_vps(torch, yaml: str, dev):
    """The Tube-Link VPS model of ``yaml`` at full width for inference,
    random weights from seed 0, built by the registry, and a synthetic
    ``VPS_FRAMES``-frame 720x1280 video preprocessed to the yaml's size in
    windows of its clip length on ``dev``. Returns (cfg, model, the
    pipeline's keywords, windows)."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.models.build import build_model_and_criterion
    from axial_vs_tpu_torch.models.tube_link.vps import num_things_split
    from axial_vs_tpu_torch.models.video_inference import preprocess_frames

    cfg = load_config(yaml)
    num_things, num_stuff = num_things_split(cfg)
    model, _ = build_model_and_criterion(
        cfg, train=False, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    t = cfg.input.num_clip_frames
    images, _, _ = preprocess_frames(
        vipseg_like_video(VPS_FRAMES, VPS_SOURCE_HW, 0), cfg.input.pixel_mean,
        cfg.input.pixel_std, cfg.input.image_size)
    windows = [torch.from_numpy(images[i:i + t]).to(dev)
               for i in range(0, VPS_FRAMES, t)]
    return cfg, model, dict(clip_len=t, num_things_classes=num_things,
                            num_stuff_classes=num_stuff), windows


def counted_run(torch, model, fn):
    """``fn()`` once, the kernels' counts set to 0 just before and read just
    after, peak memory from 0, CUDA events around each call of
    ``model.forward``. Returns (fn's result, launches, each forward's ms,
    peak GiB, wall s)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spans = []
    reset_counts()
    t0 = time.perf_counter()
    model.forward = cuda_spans(torch, spans, model.forward)
    try:
        out = fn()
    finally:
        del model.forward
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    return (out, launches, [a.elapsed_time(b) for a, b in spans],
            torch.cuda.max_memory_allocated() / 2**30, wall)


def image_forward(torch, model, x, capture=None):
    """One warm-up forward of ``x`` (inside the context ``capture`` if
    given), then one forward through ``counted_run``, both in inference
    mode."""
    with torch.inference_mode(), capture or contextlib.nullcontext():
        model(x)

    def forward():
        with torch.inference_mode():
            return model(x)

    return counted_run(torch, model, forward)


def phase_vps(torch, card: str):
    """The Tube-Link VPS R50 of ``VPS_YAML`` at full width (58 thing + 66
    stuff classes, 100 + 66 queries, f32, windows of 5), random weights
    from seed 0, built by the registry, its decoder layers' residual
    branches scaled by ``VPS_WAKE`` (``wake_tube_head``): a synthetic
    15-frame 720x1280
    video through ``preprocess_frames`` at the yaml's 512x512, streamed in
    3 windows by ``TubeLinkVPSInference.process_window`` and then
    ``process_window_instance``, at the defaults and at zero thresholds.
    Checks the id convention, the instances, that a thing track started in
    the first window carries into a later one (zero thresholds) and the
    launch counts; the first window on the card against the CPU on the
    same weights with the pixel decoder's gammas opened
    (``open_decoder_gammas``, so that K3 reaches the outputs): logits,
    masks, track embeddings within ``CARD_CPU_BOUND`` and the id maps'
    agreement, the CPU's head masked by the card's attention masks
    (``shared_attention_masks``). K2 and K3 on the layers' own first call
    (f32). Returns the launch counts and K2's and K3's entries."""
    import copy

    from axial_vs_tpu_torch.models.tube_link.vps import TubeLinkVPSInference

    laps = Laps("tube-link vps")
    dev = torch.device("cuda")
    cfg, model, kw, windows = build_vps(torch, VPS_YAML, dev)
    wake_tube_head(torch, model.head)
    t, q = kw["clip_len"], cfg.model.tube_link.num_queries
    num_things, num_stuff = kw["num_things_classes"], kw["num_stuff_classes"]
    laps(f"built ({num_things} + {num_stuff} classes, {q} + {num_stuff} "
         f"queries, {sum(p.numel() for p in model.parameters())} "
         f"parameters), {VPS_FRAMES} frames preprocessed to "
         f"{len(windows)} windows of {tuple(windows[0].shape)}")
    captured = {}
    with first_msda_call(captured, "vps"), traj_calls(
            captured, lambda a: "vps K3"):  # warm-up window
        TubeLinkVPSInference(model, **kw).window_forward(windows[0])

    def streams():
        runs = {}
        for label, extra in (("defaults", {}), ("zero thresholds", VPS_ZERO)):
            pipe = TubeLinkVPSInference(model, **kw, **extra)
            pipe.init_memory()
            w0 = time.perf_counter()
            maps, started = [], []
            for i, window in enumerate(windows):
                maps.append(pipe.process_window(window, i))
                started.append(pipe.tracker.num_tracks)
            pan_s = time.perf_counter() - w0
            carried = sorted(tid for tid, tr in pipe.tracker.tracks.items()
                             if tid < started[0] and tr["last_frame"] >= 1)
            pipe.init_memory()
            thr = None if label == "defaults" else 0.0
            inst = [pipe.process_window_instance(w, i, score_thr=thr)
                    for i, w in enumerate(windows)]
            runs[label] = (maps, started, carried, inst, pan_s)
        return runs

    # the model's forward alone, without the window's copy to the host
    runs, launches, fwd_ms, peak, wall = counted_run(torch, model, streams)
    n_fwd = 4 * len(windows)
    want = expect(K2=K2_TUBE * n_fwd, K3=K3_TUBE * n_fwd)
    mask_hw = tuple(s // 4 for s in cfg.input.image_size)

    conv = TubeLinkVPSInference(model, **kw)  # the id convention's numbers
    off = conv.label_divisor
    for label, (maps, started, carried, inst, pan_s) in runs.items():
        check_vps_ids(maps, conv, label)
        for m in maps:
            if m.shape != (t,) + mask_hw:
                raise AssertionError(f"vps {label}: id map {m.shape}")
        n_seg = [len(np.unique(m[m != conv.num_classes])) for m in maps]
        things = [sorted(set((m[m >= off] // off).ravel().tolist()))
                  for m in maps]
        n_inst = [len(frame["labels"]) for w in inst for frame in w]
        for w in inst:
            for frame in w:
                k = len(frame["labels"])
                if (frame["masks"].shape != (k,) + mask_hw
                        or frame["masks"].dtype != bool
                        or frame["track_ids"].shape != (k,)
                        or (k and frame["labels"].max() >= num_things)):
                    raise AssertionError(f"vps {label} instances: {frame}")
        log(f"tube-link vps {label}: {len(windows)} windows of {t}, "
            f"segments a window {n_seg}, thing instance ids a window "
            f"{[len(x) for x in things]}, tracks after each window {started}, "
            f"tracks of window 0 carried on {carried}; instances a frame "
            f"{sorted(set(n_inst))}; process_window {pan_s:.2f} s for "
            f"{VPS_FRAMES} frames")
        if label == "zero thresholds":
            inst_ids = [set(w[0]["track_ids"].tolist()) - {-1} for w in inst]
            if not (min(n_seg) > 0 and carried and started[0] > 0
                    and inst_ids[0] & inst_ids[1]):
                raise AssertionError(
                    f"vps at zero thresholds: segments {n_seg}, carried "
                    f"{carried}, instance track ids {inst_ids}")
    log(f"tube-link vps: launches {launches} (want {want}) over {n_fwd} "
        f"window forwards; model forward {statistics.median(fwd_ms):.2f} ms "
        f"a window (median, CUDA events, {len(fwd_ms)} windows, without "
        f"the copy to the host), the streams "
        f"{wall:.2f} s ({4 * VPS_FRAMES / wall:.3f} frames/s with the "
        f"host's fusion and tracker); peak memory {peak:.3f} GiB; {card}")
    if launches != want:
        raise AssertionError(f"vps launch counts {launches}")
    laps("stream")

    # the first window on the card and on the CPU, zero thresholds, K3's
    # branch opened
    open_decoder_gammas(torch, model)
    outs, flips, cpu_model = {}, [], copy.deepcopy(model).cpu()
    with shared_attention_masks(model.head, cpu_model.head, flips,
                                "tube-link vps card vs CPU"):
        for side, m, x in (("card", model, windows[0]),
                           ("cpu", cpu_model, windows[0].cpu())):
            box = []
            pipe = recorded_forwards(
                TubeLinkVPSInference(m, **kw, **VPS_ZERO), box)
            pipe.init_memory()
            ids = pipe.process_window(x, 0)
            outs[side] = (box[0], ids)
    errs = {k: rel_err(g, w) for k, g, w in zip(
        ("logits", "masks", "track_embeds"), outs["card"][0], outs["cpu"][0])}
    agree = float((outs["card"][1] == outs["cpu"][1]).mean())
    log(f"tube-link vps card vs CPU (the first window, f32 both, zero "
        f"thresholds, gamma {K3_GAMMA}): max |diff| / max |ref| "
        + ", ".join(f"{k} {v:.4g}" for k, v in errs.items())
        + f" (bound {CARD_CPU_BOUND}); id-map pixels equal {agree:.6f} "
        f"(need {VPS_ID_AGREEMENT}); the card's attention masks taken")
    if not (max(errs.values()) <= CARD_CPU_BOUND
            and agree >= VPS_ID_AGREEMENT):
        raise AssertionError("vps card vs CPU disagree")
    laps("card vs CPU")

    value, shapes, _, loc, weights = captured["vps"]
    _, k2 = _k2_case(torch, "vps window model inputs (f32)",
                     value.to(dev), shapes, loc.to(dev), weights.to(dev),
                     K2_TUBE)
    k3 = _k3_model_case(torch, "vps window", captured["vps K3"])
    return launches, k2, k3


def _k3_model_case(torch, label: str, args):
    """K3 on a layer's own inputs (``args`` as ``traj_calls`` keeps them)
    against its plain version within F32_REL_BOUND of max|out| in f32 or
    ``TRAJ_ULPS`` bf16 ulp in bf16, timed eager, in a CUDA graph and plain,
    beside its bound. Returns its entry."""
    from axial_vs_tpu_torch.ops.traj import (TRAJ_ULPS,
                                             trajectory_attention_core,
                                             trajectory_attention_core_plain)
    from axial_vs_tpu_torch.tools.timing import graph_ms

    args = [a[0] if isinstance(a, _Leaf) else a for a in args]
    f, heads = int(args[7]), int(args[8])
    got = trajectory_attention_core(*args)
    want = trajectory_attention_core_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    bf16 = got.dtype == torch.bfloat16
    bound = (TRAJ_ULPS * bf16_ulp(want.float().abs().max().item()) if bf16
             else f32_bound(want))

    def kernel():
        return trajectory_attention_core(*args)

    ms = cuda_ms(torch, kernel)
    g_ms = graph_ms(kernel, "cuda", 10)
    plain_ms = cuda_ms(torch, lambda: trajectory_attention_core_plain(*args),
                       launches=3)
    b, nt, c = args[0].shape
    flops, nbytes = _traj_work(b, f, nt // f, c, size=2 if bf16 else 4)
    bound_t, by = bound_ms(flops, nbytes, PEAK_BF16 if bf16 else PEAK_F32)
    log(f"K3 {str(got.dtype)[6:]} {label}, the layer's own inputs (B'={b}, "
        f"f={f}, n={nt // f}, {heads} heads of {c // heads}): max_abs_err "
        f"{err:.6g} (bound {f'{TRAJ_ULPS} bf16 ulp' if bf16 else 'F32_REL_BOUND'}"
        f" of max|out| = {bound:.6g}); "
        f"kernel {ms:.4f} ms ({g_ms:.4f} in a CUDA graph), plain "
        f"{plain_ms:.4f} ms, bound {bound_t:.4f} ms ({by}: "
        f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
        f"{bound_t / g_ms:.3f} of the bound in a graph")
    if not (err <= bound and torch.isfinite(got).all()):
        raise AssertionError(f"K3 disagrees on the {label} call")
    return {"max_abs_err": err, "ms": ms, "graph_ms": g_ms,
            "plain_ms": plain_ms, "bound_ms": bound_t, "bound_by": by}


def phase_cc_vis(torch, card: str):
    """The cross-clip Tube-Link VIS R50 of ``CC_VIS_YAML`` at full width
    (100 queries, 40 classes, clips of 5, 4 CC layers, f32), random weights
    from seed 0, built by the registry: synthetic 360x640 videos of 15 and
    60 frames (3 and 12 clips; K3 in the CC layers at n = 100, f = 3 and
    12). Checks every CC layer's outputs and the launch counts; K3's first
    CC-layer call of each video, and the segmenter's first K2 and K3 call
    of the 15-frame video, against their plain versions and beside their
    bounds; a 15-frame video at ``CC_VIS_REF_HW`` on the card against the
    CPU on the same weights with the pixel decoder's gammas opened
    (``open_decoder_gammas``), the CPU's head masked by the card's
    attention masks (``shared_attention_masks``). Returns the launch counts
    and K2's and K3's entries."""
    import copy

    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.models.build import build_model_and_criterion

    laps = Laps("cc vis")
    dev = torch.device("cuda")
    cfg = load_config(CC_VIS_YAML)
    model, _ = build_model_and_criterion(
        cfg, train=False, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    v, layers = cfg.input.num_clip_frames, cfg.model.maxtron.cc.num_layers
    k = cfg.model.num_classes
    videos = [torch.randn(n, TL_H, TL_W, 3, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(s))
              for s, n in enumerate(CC_VIS_FRAMES)]

    def which(args):  # a CC layer's call is one row of f x queries tokens
        f = int(args[7])
        cc = tuple(args[0].shape[:2]) == (1, f * CC_VIS_QUERIES)
        return f"{'layer' if cc else 'segmenter'} f={f}"

    captured = {}
    with torch.inference_mode(), first_msda_call(captured, "K2"), traj_calls(
            captured, which):
        model(videos[0])  # warm-up (kernel selection, allocator)
    torch.cuda.synchronize()
    laps("built and warmed up")

    launches, video_ms = None, []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for video in videos:
        clips = video.shape[0] // v
        before = read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.inference_mode(), traj_calls(captured, which):
            start.record()
            out = model(video)
            end.record()
        end.synchronize()
        video_ms.append(start.elapsed_time(end))
        got = {key: n - before[key] for key, n in read_counts().items()}
        want = expect(K2=K2_TUBE * clips, K3=K3_TUBE * clips + layers)
        log(f"cc vis: {video.shape[0]}-frame video ({clips} clips): "
            f"{video_ms[-1]:.2f} ms (CUDA events), launches {got} (want "
            f"{want})")
        if got != want:
            raise AssertionError(f"cc vis launch counts {got}")
        for name, shape in (("cls_preds", (1, CC_VIS_QUERIES, k + 1)),
                            ("mask_preds", (1, video.shape[0], CC_VIS_QUERIES)
                             + TL_MASK_HW)):
            if len(out[name]) != layers:
                raise AssertionError(f"cc vis {name}: {len(out[name])} layers")
            for x in out[name]:
                if (tuple(x.shape) != shape or x.dtype != torch.float32
                        or not torch.isfinite(x).all()):
                    raise AssertionError(f"cc vis {name} {tuple(x.shape)}")
        del out
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"cc vis: {sum(CC_VIS_FRAMES)} frames in {len(videos)} videos, "
        + ", ".join(f"{n / (ms / 1e3):.3f} frames/s at {n}"
                    for n, ms in zip(CC_VIS_FRAMES, video_ms))
        + f"; peak memory {peak:.3f} GiB; {card}")
    keys = [f"layer f={n // v}" for n in CC_VIS_FRAMES] + [f"segmenter f={v}"]
    if sorted(captured) != sorted(keys + ["K2", "calls"]):
        raise AssertionError(f"cc vis: K3 calls kept {sorted(captured)}")
    k3 = {key: _k3_model_case(torch, "cc vis " + key, captured[key])
          for key in keys}
    value, shapes, _, loc, weights = captured["K2"]
    _, k2 = _k2_case(torch, f"cc vis segmenter {CC_VIS_FRAMES[0]}-frame "
                     "video inputs (f32)", value.to(dev), shapes,
                     loc.to(dev), weights.to(dev), K2_TUBE)
    del captured
    laps("videos")

    x = torch.randn(CC_VIS_FRAMES[0], *CC_VIS_REF_HW, 3,
                    generator=torch.Generator().manual_seed(9))
    open_decoder_gammas(torch, model)
    flips, cpu_model = [], copy.deepcopy(model).cpu()
    with torch.inference_mode(), shared_attention_masks(
            model.wc_head_wrapper, cpu_model.wc_head_wrapper, flips,
            "cc vis card vs CPU"):
        card_out = model(x.to(dev))
        cpu_out = cpu_model(x)
    errs = {name: max(rel_err(g, w) for g, w in zip(card_out[name],
                                                    cpu_out[name]))
            for name in ("cls_preds", "mask_preds")}
    log(f"cc vis card vs CPU ({CC_VIS_FRAMES[0]}x{CC_VIS_REF_HW[0]}x"
        f"{CC_VIS_REF_HW[1]}, f32 both, gamma {K3_GAMMA}, every CC layer): "
        f"max |diff| / max |ref| "
        + ", ".join(f"{k} {v:.4g}" for k, v in errs.items())
        + f" (bound {CARD_CPU_BOUND}); the card's attention masks taken")
    if max(errs.values()) > CARD_CPU_BOUND:
        raise AssertionError("cc vis card vs CPU disagree")
    laps("card vs CPU")
    return launches, k2, k3


def build_image_model(torch, yaml: str, dev):
    """The image model of ``yaml`` at full width for inference, random
    weights from seed 0, built by the registry, and one random image of the
    yaml's size on ``dev``. Returns (cfg, model, image)."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.models.build import build_model_and_criterion

    cfg = load_config(yaml)
    model, _ = build_model_and_criterion(
        cfg, train=False, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    x = torch.randn(1, *cfg.input.image_size, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    return cfg, model, x


def phase_image_m2f(torch, card: str):
    """The image Mask2Former R50 of ``IMAGE_YAML`` at full width (80 thing +
    53 stuff classes, 100 queries, f32), random weights from seed 0, built
    by the registry: one 1024x1024 image (K2 only). Checks every layer's
    outputs and the launch counts; the image on the card against the CPU
    on the same weights (the CPU's head masked by the card's attention
    masks); K2 on the layer's own first call. Returns the launch counts
    and K2's entry."""
    import copy

    dev = torch.device("cuda")
    cfg, model, x = build_image_model(torch, IMAGE_YAML, dev)
    hw = tuple(cfg.input.image_size)
    captured = {}
    out, launches, (fwd_ms,), peak, _ = image_forward(
        torch, model, x, first_msda_call(captured, "image"))
    want = expect(K2=K2_TUBE)
    classes = cfg.model.num_classes + 1
    q = cfg.model.tube_link.num_queries
    for name, shape in (("cls_preds", (1, q, classes)),
                        ("mask_preds", (1, q, hw[0] // 4, hw[1] // 4))):
        for y in out[name]:
            if (tuple(y.shape) != shape or y.dtype != torch.float32
                    or not torch.isfinite(y).all()):
                raise AssertionError(f"image m2f {name} {tuple(y.shape)}")
    log(f"image m2f: one {hw[0]}x{hw[1]} image, {len(out['cls_preds'])} "
        f"layers of (1, {q}, {classes}) logits and (1, {q}, {hw[0] // 4}, "
        f"{hw[1] // 4}) masks, finite; {fwd_ms:.2f} ms (CUDA "
        f"events); launches {launches} (want {want}); peak memory "
        f"{peak:.3f} GiB; {card}")
    if launches != want:
        raise AssertionError(f"image m2f launch counts {launches}")
    del out

    flips, cpu_model = [], copy.deepcopy(model).cpu()
    with torch.inference_mode(), shared_attention_masks(
            model.head, cpu_model.head, flips, "image m2f card vs CPU"):
        card_out = model(x)
        cpu_out = cpu_model(x.cpu())
    errs = {name: max(rel_err(g, w) for g, w in zip(card_out[name],
                                                    cpu_out[name]))
            for name in ("cls_preds", "mask_preds")}
    log(f"image m2f card vs CPU (the image, f32 both, every layer): max "
        f"|diff| / max |ref| "
        + ", ".join(f"{k} {v:.4g}" for k, v in errs.items())
        + f" (bound {CARD_CPU_BOUND}); the card's attention masks taken")
    if max(errs.values()) > CARD_CPU_BOUND:
        raise AssertionError("image m2f card vs CPU disagree")
    value, shapes, _, loc, weights = captured["image"]
    _, k2 = _k2_case(torch, f"image m2f {hw[0]}x{hw[1]} model inputs (f32)",
                     value.to(dev), shapes, loc.to(dev), weights.to(dev),
                     K2_TUBE)
    return launches, k2


# ---- image kMaX-DeepLab: COCO eval, ConvNeXtV2, card against CPU ---------

COCO_YAML = "coco/kmax_convnext_large.yaml"      # ConvNeXt-L + spatial WC
COCO_V2_YAML = "coco/kmax_convnextv2_large.yaml"  # ConvNeXtV2-L (GRN) + WC
COCO_R50_YAML = "coco/kmax_r50.yaml"              # R50, no WC module
COCO_IMAGES, COCO_HW = 3, (480, 640)  # the synthetic COCO-format split
IMAGE_FORWARDS = 5  # timed forwards of one image
#: the R50 card-against-CPU input, padded as the eval pads: the CPU's f32
#: R50 at 1281x1281 would take most of the phase
COCO_REF_SIZE = (641, 641)
#: the std of the drawn GRN gamma and beta of the ConvNeXtV2 phase (zero at
#: init, which makes GRN the identity)
GRN_STD = 0.1


@contextlib.contextmanager
def dwln_calls(box: dict):
    """While active, the arguments of the first K1 call at each input shape
    that a ConvNeXt block makes (``models/backbones/convnext.py``) are kept
    in ``box[shape]`` as (args, kwargs), tensors copied to the host; every
    call still runs the wrapper, and its launch count."""
    import torch

    from axial_vs_tpu_torch.models.backbones import convnext

    real = convnext.dwconv7x7_layernorm

    def capture(*args, **kwargs):
        key = tuple(args[0].shape)
        if key not in box:
            box[key] = (tuple(a.detach().cpu() for a in args),
                        {k: v.detach().cpu() if torch.is_tensor(v) else v
                         for k, v in kwargs.items()})
        return real(*args, **kwargs)

    convnext.dwconv7x7_layernorm = capture
    try:
        yield
    finally:
        convnext.dwconv7x7_layernorm = real


def _image_forward_ms(torch, model, x, n: int = IMAGE_FORWARDS):
    """Device ms of each of ``n`` forwards of one image (CUDA events)."""
    times = []
    with torch.inference_mode():
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return times


def phase_coco_eval(torch, root: str, card: str):
    """The image kMaX-DeepLab of ``COCO_YAML`` at full width (ConvNeXt-L,
    the spatial-only WC module, bf16, 1281x1281, 133 classes, 128 queries),
    random weights from seed 0, built by the registry: the forward of one
    image timed (CUDA events, ``IMAGE_FORWARDS`` runs: median and spread);
    ``evaluate_coco_panoptic`` on ``COCO_IMAGES`` synthetic COCO-format
    images of 480x640 (``data/synthetic.py::write_coco_panoptic``), its PQ
    dict finite and in [0, 1], images/s, the forward's share (CUDA events
    around each forward) and the panoptic loop's (host clock), peak memory
    and the launch counts (K1 36 and K2 2 an image); the first K1 call at each stage's shape and the first K2
    call of the model, on their own inputs, against their plain versions.
    Returns the launch counts and K1's and K2's entries."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.data.coco import register_coco_panoptic
    from axial_vs_tpu_torch.data.synthetic import write_coco_panoptic
    from axial_vs_tpu_torch.engine.evaluator_loop import evaluate_coco_panoptic
    from axial_vs_tpu_torch.models import postprocess
    from axial_vs_tpu_torch.models.build import build_model_and_criterion

    laps = Laps("coco eval")
    dev = torch.device("cuda")
    name = "coco_chip_smoke_val"
    register_coco_panoptic(name, *write_coco_panoptic(
        os.path.join(root, "coco"), COCO_IMAGES, COCO_HW))
    cfg = load_config(COCO_YAML, ["datasets.test", [name]])
    model, _ = build_model_and_criterion(
        cfg, train=False, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    size = tuple(cfg.input.image_size)
    depths = tuple(cfg.model.backbone.convnext.depths)
    x = torch.randn(1, *size, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    k1_calls, captured = {}, {}
    with torch.inference_mode(), dwln_calls(k1_calls), first_msda_call(
            captured, "K2"):
        out = model(x)  # warm-up, not counted
    torch.cuda.synchronize()
    k, q = cfg.model.num_classes, cfg.model.kmax.trans_dec.num_object_queries
    # the image layout: (1, H/4, W/4, queries) masks (320x320 at 1281 from
    # the VALID stem), no T axis
    logits, masks = out["pred_logits"], out["pred_masks"]
    if not (tuple(logits.shape) == (1, q, k + 1) and masks.ndim == 4
            and masks.shape[0] == 1 and masks.shape[-1] == q
            and torch.isfinite(logits.float()).all()
            and torch.isfinite(masks.float()).all()):
        raise AssertionError(f"coco eval outputs {tuple(logits.shape)} "
                             f"{tuple(masks.shape)}")
    log(f"coco eval: outputs (1, {q}, {k + 1}) logits and "
        f"{tuple(masks.shape)} masks, finite")
    del out, logits, masks
    laps("built and warmed up")
    times = _image_forward_ms(torch, model, x)
    log(f"coco eval: forward of one {size[0]}x{size[1]} image (bf16, "
        f"ConvNeXt-L + spatial WC): median {statistics.median(times):.3f} ms, "
        f"min {min(times):.3f}, max {max(times):.3f} over {len(times)} runs "
        f"(CUDA events); {card}")

    spans, loop_s = [], []
    model.forward = cuda_spans(torch, spans, model.forward)
    real_loop = postprocess.panoptic_inference

    def timed_loop(*args, **kwargs):  # host clock, synchronized
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_loop(*args, **kwargs)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t)
        return out

    postprocess.panoptic_inference = timed_loop
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        pq = evaluate_coco_panoptic(cfg, model)
        torch.cuda.synchronize()
    finally:
        postprocess.panoptic_inference = real_loop
        del model.forward
    wall = time.perf_counter() - t0
    launches = read_counts()
    forward_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = expect(K1=CONVNEXT_L_BLOCKS * COCO_IMAGES,
                  K2=K2_WC_CALLS * COCO_IMAGES)
    log(f"coco eval: evaluate_coco_panoptic on {COCO_IMAGES} {COCO_HW[0]}x"
        f"{COCO_HW[1]} images in {wall:.3f} s ({COCO_IMAGES / wall:.3f} "
        f"images/s), the forwards {forward_s:.3f} s of it ({forward_s / wall:.3f};"
        f" CUDA events), the panoptic loops {sum(loop_s):.3f} s "
        f"({sum(loop_s) / wall:.3f}; host clock, synchronized), peak memory "
        f"{peak:.3f} GiB; PQ "
        + json.dumps({p: pq[p] for p in ("all", "things", "stuff")})
        + f"; launches {launches} (want {want}); {card}")
    if launches != want or len(spans) != COCO_IMAGES:
        raise AssertionError(f"coco eval launch counts {launches}")
    for part in ("all", "things", "stuff"):
        for key in ("pq", "sq", "rq"):
            v = pq[part][key]
            if not (math.isfinite(v) and 0.0 <= v <= 1.0):
                raise AssertionError(f"coco eval {part} {key} = {v}")
    laps("evaluate_coco_panoptic")
    if len(k1_calls) != len(depths):
        raise AssertionError(f"coco eval: K1 at {len(k1_calls)} shapes")
    k1 = _k1_per(f"bf16 {size[0]}x{size[1]} image", [
        _k1_case(torch, f"coco stage{i}, the block's own inputs", *call)
        for i, call in enumerate(k1_calls.values())], depths)
    value, shapes, _, loc, weights = captured["K2"]
    _, k2 = _k2_case(torch, f"coco {size[0]}x{size[1]} image model inputs",
                     value.to(dev), shapes, loc.to(dev), weights.to(dev),
                     K2_WC_CALLS)
    laps("K1 and K2 on the model's inputs")
    return launches, k1, k2


def phase_convnextv2(torch, card: str):
    """The image kMaX-DeepLab of ``COCO_V2_YAML`` at full width
    (ConvNeXtV2-L: every block's GRN after its GELU, no layer scale; the
    spatial-only WC module, bf16, 1281x1281), random weights from seed 0,
    its GRN gamma and beta drawn N(0, ``GRN_STD``^2) so that GRN is not the
    identity: one image, finite outputs, the launch counts (K1 36, K2 2),
    the forward's time (``IMAGE_FORWARDS`` runs) and the 36 GRNs' alone;
    the first K1 call of a GRN block on its own inputs against its plain
    version. Returns the launch counts and K1's entry."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.models.backbones.convnext import GRN
    from axial_vs_tpu_torch.models.build import build_model_and_criterion

    dev = torch.device("cuda")
    cfg = load_config(COCO_V2_YAML)
    model, _ = build_model_and_criterion(
        cfg, train=False, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    grns = [m for m in model.modules() if isinstance(m, GRN)]
    draw = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        for m in grns:
            m.gamma.normal_(0.0, GRN_STD, generator=draw)
            m.beta.normal_(0.0, GRN_STD, generator=draw)
    if len(grns) != CONVNEXT_L_BLOCKS or any(
            b.block_kernel != "dwln" for s in model.backbone.stages
            for b in s.blocks):
        raise AssertionError(f"convnextv2: {len(grns)} GRN blocks")
    size = tuple(cfg.input.image_size)
    x = torch.randn(1, *size, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    with torch.inference_mode():
        model(x)  # warm-up
    torch.cuda.synchronize()
    k1_calls = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.inference_mode(), dwln_calls(k1_calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = model(x)
        end.record()
    end.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = expect(K1=CONVNEXT_L_BLOCKS, K2=K2_WC_CALLS)
    finite = all(torch.isfinite(out[k].float()).all()
                 for k in ("pred_logits", "pred_masks"))
    log(f"convnextv2: one {size[0]}x{size[1]} image through ConvNeXtV2-L "
        f"({len(grns)} GRN blocks, gamma and beta N(0, {GRN_STD}^2)) + "
        f"spatial WC, bf16: {start.elapsed_time(end):.3f} ms (CUDA events), "
        f"outputs finite {finite}, peak memory {peak:.3f} GiB, launches "
        f"{launches} (want {want}); {card}")
    if launches != want or not finite:
        raise AssertionError(f"convnextv2 launch counts {launches}")
    del out
    times = _image_forward_ms(torch, model, x)
    # GRN alone (plain ops) at each stage's 4C hidden shape, times its blocks
    depths = cfg.model.backbone.convnext.depths
    grn_ms = 0.0
    for stage, (n, h, w, c), d in zip(model.backbone.stages, k1_calls,
                                      depths):
        grn = stage.blocks[0].grn
        y = torch.randn(n, h, w, 4 * c, device=dev, generator=draw).bfloat16()
        with torch.inference_mode():
            grn_ms += d * cuda_ms(torch, lambda: grn(y), launches=5,
                                  repeats=3)
        del y
    log(f"convnextv2: forward median {statistics.median(times):.3f} ms, min "
        f"{min(times):.3f}, max {max(times):.3f} over {len(times)} runs (CUDA "
        f"events); its {len(grns)} GRNs alone (plain ops, at each stage's 4C hidden "
        f"shape times its blocks) {grn_ms:.3f} ms; {card}")
    first = next(iter(k1_calls.values()))
    k1 = _k1_case(torch, "convnextv2 GRN block, its own inputs", *first)
    return launches, k1


def phase_kmax_r50_reference(torch, card: str):
    """The image kMaX-DeepLab of ``COCO_R50_YAML`` (R50 without the WC
    module, f32, 133 classes, 128 queries) at full width, random weights
    from seed 0: one ``COCO_REF_SIZE`` image on the card (no kernel of the
    port runs on this path: every launch count 0) and on the CPU from the
    same weights, logits and masks within ``CARD_CPU_BOUND`` of max |ref|.
    Returns the launch counts."""
    import copy

    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.models.build import build_model_and_criterion

    dev = torch.device("cuda")
    full_f32(torch)
    cfg = load_config(COCO_R50_YAML)
    model, _ = build_model_and_criterion(
        cfg, train=False, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    if model.sem_seg_head.wc_module is not None or model.dtype is not None:
        raise AssertionError("kmax r50: expected the f32 model without WC")
    x = torch.randn(1, *COCO_REF_SIZE, 3,
                    generator=torch.Generator().manual_seed(4))
    reset_counts()
    with torch.inference_mode():
        card_out = model(x.to(dev))
    torch.cuda.synchronize()
    launches = read_counts()
    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        cpu_out = cpu_model(x)
    errs = {k: rel_err(card_out[k], cpu_out[k])
            for k in ("pred_logits", "pred_masks")}
    log(f"kmax r50 card vs CPU ({COCO_REF_SIZE[0]}x{COCO_REF_SIZE[1]}, f32 "
        f"both, no WC module): max |diff| / max |ref| "
        + ", ".join(f"{k} {v:.4g}" for k, v in errs.items())
        + f" (bound {CARD_CPU_BOUND}); launches {launches}; {card}")
    if max(errs.values()) > CARD_CPU_BOUND or launches != expect():
        raise AssertionError("kmax r50 card vs CPU disagree")
    return launches

# ---- Swin and STDC: Swin-L Tube-Link VIS, its training, VPS, images -----

SWIN_VIS_YAML = "ytvis21/tube_link_maxtron_wc_swin_l.yaml"
#: the Swin-L training phase's tubes a step: the yaml's
#: ``solver.ims_per_batch`` is 8; in f32 on an NVIDIA H100 80GB HBM3 5
#: tubes ran out of memory (77.41 GiB allocated), 4 peaked at 76.154 GiB
#: when run alone, 3 at 59.256: 3 leave the whole run's allocator room
SWIN_TRAIN_BATCH = 3
SWIN_TRAIN_STEPS = 3
VPS_BACKBONE_YAMLS = ("vipseg/tube_link_vps_stdc1.yaml",
                      "vipseg/tube_link_vps_stdc2.yaml",
                      "vipseg/tube_link_vps_swin_b.yaml")
KMAX_SWIN_YAML = "coco/kmax_instance_swin_large.yaml"
M2F_SWIN_YAML = "image/mask2former_swin_l_384_in21k_coco_panoptic_100e.yaml"
#: the backbone references' inputs: Swin-L at a side off a multiple of 4
#: and of the window (12), STDC2 at the VPS yaml's size
SWIN_REF_HW, STDC_REF_HW = (513, 513), (512, 512)
#: bound on max |card - CPU| / max |CPU| of the backbones in f32 (TF32 off)
BACKBONE_REF_BOUND = 1e-4


#: the std of the Swin backbone's biases drawn for the training phase
SWIN_BIAS_STD = 0.02


def wake_swin_biases(torch, backbone, std: float = SWIN_BIAS_STD):
    """Draw every bias of a Swin backbone (zero at the upstream init, as
    JAX's) from N(0, std^2), as a trained checkpoint's are non-zero. At
    zero biases each padded patch of a crop is the zero vector in every
    layer's LayerNorm, whose backward at a zero-variance row multiplies by
    1 / sqrt(eps) = 316, block after block: in both packages alike, as
    ``tests/test_torch_backbones.py::test_swin_gradients_at_padded_patches``
    pins (5.5e4x at 8 blocks of width 32; Swin-L has 24)."""
    gen = torch.Generator(device=next(backbone.parameters()).device)
    gen.manual_seed(2)
    with torch.no_grad():
        for name, p in backbone.named_parameters():
            if name.endswith(".bias"):
                p.normal_(0.0, std, generator=gen)


def swin_l_vis_config(opts=()):
    """``SWIN_VIS_YAML`` as it stands (with ``opts``), checked to be the
    paper's Swin-L MaXTron Tube-Link VIS: Swin-L (192; 2/2/18/2; heads
    6-48; window 12), bf16, 100 queries, 40 classes, temporal attention."""
    from axial_vs_tpu_torch.config import load_config

    cfg = load_config(SWIN_VIS_YAML, list(opts))
    s, tl = cfg.model.backbone.swin, cfg.model.tube_link
    if not (cfg.model.backbone.name == "swin_large" and s.embed_dim == 192
            and list(s.depths) == [2, 2, 18, 2]
            and list(s.num_heads) == [6, 12, 24, 48] and s.window_size == 12
            and cfg.model.dtype == "bfloat16" and tl.num_queries == 100
            and tl.use_temporal_attn and cfg.model.num_classes == 40
            and tl.clip_len == TL_T):
        raise AssertionError(f"not the Swin-L VIS yaml: {cfg.model}")
    return cfg


def _ms_stats(times) -> str:
    return (f"median {statistics.median(times):.2f} ms, min {min(times):.2f},"
            f" max {max(times):.2f} ({len(times)} runs, CUDA events)")


def phase_swin_vis(torch, root: str, card: str):
    """The main path of the Swin slice: ``SWIN_VIS_YAML`` as it stands
    (Swin-L, bf16, 100 queries, temporal attention), random weights from
    seed 0, built by the registry. A 15-frame 360x640 video in tubes of 5
    through ``TubeLinkVISInference.run_video``: 30 instances, finite,
    distinct labels in range, and the launch counts; ms a tube (CUDA
    events around each forward), peak memory. K2's and K3's first calls
    (bf16, the warm-up tube) against their plain versions. Then
    ``evaluate_ytvis`` on the two synthetic 720x1280 videos phase 13a
    writes (15 and 36 frames): finite AP/AR, frames/s, the forward's share
    and the launch counts. Returns the launch counts of the video and of
    the eval, and K2's and K3's entries."""
    import axial_vs_tpu_torch.data.ytvis as ytvis
    from axial_vs_tpu_torch.data.synthetic import write_ytvis_videos
    from axial_vs_tpu_torch.engine import evaluator_loop
    from axial_vs_tpu_torch.models.backbones.swin import SwinTransformer
    from axial_vs_tpu_torch.models.build import build_model_and_criterion
    from axial_vs_tpu_torch.models.tube_link.detector import (
        TubeLinkVISInference, video_split)

    laps = Laps("swin-l vis")
    dev = torch.device("cuda")
    name = "ytvis_chip_smoke_swin_val"
    cfg = swin_l_vis_config(["input.image_size", [TL_H, TL_W],
                             "datasets.test", [name]])
    model, _ = build_model_and_criterion(
        cfg, train=False, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    if not (isinstance(model.backbone, SwinTransformer)
            and model.dtype == torch.bfloat16 and not model.training):
        raise AssertionError("swin-l vis: not the bf16 Swin-L model")
    tl = cfg.model.tube_link
    pipeline = TubeLinkVISInference(model, clip_len=tl.clip_len,
                                    overlap=tl.overlap, topk=tl.test_topk)
    video = torch.randn(TL_VIDEO, TL_H, TL_W, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
    captured = {}
    with (torch.inference_mode(), first_msda_call(captured, "swin"),
          traj_calls(captured, lambda a: "swin K3")):
        model(video[:TL_T])  # warm-up tube (kernel selection, allocator)
    torch.cuda.synchronize()
    laps(f"built ({sum(p.numel() for p in model.parameters())} parameters) "
         f"and warmed up")
    res, launches, tube_ms, peak, _ = counted_run(
        torch, model, lambda: pipeline.run_video(video))
    n_inst = tl.test_topk
    want_shape = (n_inst, TL_VIDEO) + TL_MASK_HW
    labels, scores = res["labels"], res["scores"]
    if (res["masks"].shape != want_shape or not np.isfinite(res["masks"]).all()
            or labels.shape != (n_inst,) or labels.min() < 0
            or labels.max() >= cfg.model.num_classes
            or not np.isfinite(scores).all()
            or not np.all(scores[:-1] >= scores[1:])):
        raise AssertionError(f"swin-l vis: masks {res['masks'].shape}, "
                             f"labels {labels}, scores {scores}")
    want = expect(K2=K2_TUBE * 3, K3=K3_TUBE * 3)
    log(f"swin-l vis: {TL_VIDEO}x{TL_H}x{TL_W} video in 3 tubes of {TL_T}, "
        f"bf16: {n_inst} instances, masks {want_shape} finite; a tube's "
        f"forward {_ms_stats(tube_ms)}; peak memory {peak:.3f} GiB; launches "
        f"{launches} (want {want}); {card}")
    if launches != want:
        raise AssertionError(f"swin-l vis launch counts {launches}")
    value, shapes, _, loc, weights = captured["swin"]
    _, k2 = _k2_case(torch, "swin-l vis tube model inputs", value.to(dev),
                     shapes, loc.to(dev), weights.to(dev), K2_TUBE)
    k3 = _k3_model_case(torch, "swin-l vis tube", captured["swin K3"])
    del captured
    laps("the video and the kernels' checks")

    meta = ytvis.register_ytvis(name, *write_ytvis_videos(
        root, len(YTVIS_VIDEOS), YTVIS_VIDEOS, hw=YTVIS_HW, compress_level=0))
    meta.contiguous_to_dataset_id = list(range(1, cfg.model.num_classes + 1))
    tubes = sum(len(video_split(v, TL_T)) for v in YTVIS_VIDEOS)
    frames = sum(YTVIS_VIDEOS)
    spans = []
    real = TubeLinkVISInference.tube_forward
    reset_counts()
    t0 = time.perf_counter()
    TubeLinkVISInference.tube_forward = cuda_spans(torch, spans, real)
    try:
        ev = evaluator_loop.evaluate_ytvis(
            cfg, model, format_only_path=os.path.join(root, "swin.json"))
    finally:
        TubeLinkVISInference.tube_forward = real
    wall = time.perf_counter() - t0
    eval_launches = read_counts()
    fwd = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    want = expect(K2=K2_TUBE * tubes, K3=K3_TUBE * tubes)
    fields = {k: v for k, v in ev.items()
              if k not in ("results_json", "per_category_AP")}
    log(f"swin-l vis ytvis eval: {frames} frames in {tubes} tubes, "
        f"{wall:.2f} s, {frames / wall:.3f} frames/s; forward {fwd:.2f} s "
        f"({fwd / wall:.3f} of the wall, CUDA events); launches "
        f"{eval_launches} (want {want}); AP/AR " + json.dumps(fields))
    if (eval_launches != want or ev["num_videos"] != len(YTVIS_VIDEOS)
            or ev["num_predictions"] != n_inst * len(YTVIS_VIDEOS)
            or not all(math.isfinite(v) for v in fields.values()
                       if isinstance(v, float))):
        raise AssertionError(f"swin-l vis ytvis eval: {ev}")
    laps("ytvis eval")
    return launches, eval_launches, k2, k3


def phase_train_swin_vis(torch, root: str, card: str,
                         batch: int = SWIN_TRAIN_BATCH,
                         steps: int = SWIN_TRAIN_STEPS):
    """``steps`` steps of ``train_step`` on ``SWIN_VIS_YAML`` built for
    training by the registry: f32 weights and compute (the yaml is bf16;
    JAX's registry trains Tube-Link in f32), drop path 0.3, AdamW with the
    yaml's clip, the auction at m = 100; ``batch`` tubes of 5 frames at
    512x512 a step (the yaml's 8 outgrow the card) that the YTVIS mapper
    cuts from two synthetic 720x1280 videos; the backbone's biases drawn
    (``wake_swin_biases``). Every step takes the same
    batch and a generator seeded alike (the drop-path masks, the sampled
    points), so that the loss moves with the weights alone: it must not
    rise over the steps. Checks finite losses and gradients, the launches
    (K2 and K3 a step, f32 under autograd), every parameter f32 and most
    of them moved. Logs ms a step, the matching's share and peak memory.
    Returns the launch counts."""
    from axial_vs_tpu_torch.data.build import build_mapper
    from axial_vs_tpu_torch.data.catalog import DatasetCatalog
    from axial_vs_tpu_torch.data.loader import ClipDataLoader, to_device
    from axial_vs_tpu_torch.data.synthetic import write_ytvis_videos
    from axial_vs_tpu_torch.data.ytvis import register_ytvis
    from axial_vs_tpu_torch.engine.lr_schedule import tf2_warmup_poly_lr
    from axial_vs_tpu_torch.engine.optim import build_optimizer
    from axial_vs_tpu_torch.engine.train_step import train_step
    from axial_vs_tpu_torch.models.build import build_model_and_criterion

    laps = Laps("swin-l vis train")
    dev = torch.device("cuda")
    full_f32(torch)
    name = f"ytvis_chip_smoke_swin_train_{batch}"
    register_ytvis(name, *write_ytvis_videos(
        root, len(TL_TRAIN_VIDEOS), TL_TRAIN_VIDEOS, hw=YTVIS_HW,
        compress_level=0))
    cfg = swin_l_vis_config(["datasets.train", [name], "datasets.test", [],
                             "output_dir", root])
    sol = cfg.solver
    if not (sol.ims_per_batch == 8 and list(cfg.input.image_size) == [512, 512]
            and cfg.input.num_video_frames == TL_T
            and cfg.model.backbone.swin.drop_path_rate > 0):
        raise AssertionError(f"not the yaml's training config: {cfg.input}")
    sol.ims_per_batch = batch
    model, criterion = build_model_and_criterion(
        cfg, train=True, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    wake_swin_biases(torch, model.backbone)
    dtypes = {p.dtype for p in model.parameters()}
    if (criterion.exact_matching or not model.training
            or model.dtype is not None or dtypes != {torch.float32}):
        raise AssertionError(f"swin-l vis train: want the f32 model in "
                             f"train() and the auction, got {dtypes}")
    optimizer, scheduler = build_optimizer(cfg, model, tf2_warmup_poly_lr(
        sol.base_lr, sol.max_iter, warmup_iters=sol.warmup_iters,
        power=sol.poly_power))
    loader = ClipDataLoader(DatasetCatalog.get(name), build_mapper(cfg),
                            batch_size=batch, num_workers=0)
    data = to_device(next(iter(loader)), dev)
    laps(f"built ({sum(p.numel() for p in model.parameters())} f32 "
         f"parameters), images {list(data['images'].shape)}, "
         f"{int(data['targets']['valid'].sum())} valid GTs")
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    want = expect(K2=TL_TRAIN_K2, K3=TL_TRAIN_K3)
    totals = {k: 0 for k in counted_kernels()}
    ms, match_ms, losses_by_step = [], [], []
    for step in range(steps):
        spans, marks = [], []

        def mark(what):
            marks.append((what, torch.cuda.Event(enable_timing=True)))
            marks[-1][1].record()

        reset_counts()
        with matching_spans(torch, spans):
            mark("start")
            losses = train_step(model, criterion, optimizer, scheduler, data,
                                torch.Generator(device=dev).manual_seed(1),
                                mark=mark)
            marks[-1][1].synchronize()
        ms.append(marks[0][1].elapsed_time(marks[-1][1]))
        match_ms.append(sum(a.elapsed_time(b) for a, b in spans))
        launches = read_counts()
        for k, v in launches.items():
            totals[k] += v
        finite = bool(torch.stack([p.grad.isfinite().all()
                                   for p in model.parameters()]).all())
        losses_by_step.append(losses["total_loss"])
        names = sorted(k for k in losses if k != "total_loss")
        log(f"swin-l vis train step {step}: total_loss "
            f"{losses['total_loss']:.8g}, lr {scheduler.get_last_lr()[0]:.4g}"
            f"; launches {launches} (want {want}); gradients finite "
            f"{finite}; {len(spans)} assignments, {match_ms[-1]:.2f} ms of "
            f"{ms[-1]:.2f} ms")
        if (names != TL_LOSS_NAMES or launches != want or not finite
                or not all(math.isfinite(v) for v in losses.values())):
            raise AssertionError(f"swin-l vis train step {step}: {losses}")
    moved = sum(not torch.equal(p, params0[n])
                for n, p in model.named_parameters())
    peak = torch.cuda.max_memory_allocated() / 2**30
    share = statistics.median(m / s for m, s in zip(match_ms, ms))
    log(f"swin-l vis train ({card}): {steps} steps of {batch} tubes of "
        f"{TL_T} frames at 512x512, f32, one batch and one seed a step: "
        f"total_loss {', '.join(f'{v:.8g}' for v in losses_by_step)}; ms a "
        f"step {', '.join(f'{t:.2f}' for t in ms)} (median "
        f"{statistics.median(ms):.2f}, CUDA events, eager), matching "
        f"{', '.join(f'{t:.2f}' for t in match_ms)} ms (share {share:.4f}); "
        f"peak memory {peak:.3f} GiB; {moved} of {len(params0)} parameter "
        f"tensors moved")
    if not (all(b <= a for a, b in zip(losses_by_step, losses_by_step[1:]))
            and 2 * moved >= len(params0)):
        raise AssertionError("swin-l vis train: the loss rose or the "
                             "parameters did not move")
    del model, optimizer, params0, data
    torch.cuda.empty_cache()
    return totals


def phase_vps_backbones(torch, card: str):
    """The Tube-Link VPS models of ``VPS_BACKBONE_YAMLS`` (STDC1 and STDC2
    in f32, Swin-B in bf16, each at full width, random weights from seed
    0, built by the registry): a synthetic 15-frame 720x1280 video
    preprocessed to the yaml's 512x512, streamed in 3 windows of 5 by
    ``TubeLinkVPSInference.process_window`` at zero thresholds. Checks the
    id maps' shape and convention and the launch counts; logs the window
    forward's ms (CUDA events around ``model.forward``) and peak memory.
    Returns the launch counts."""
    from axial_vs_tpu_torch.models.tube_link.vps import TubeLinkVPSInference

    dev = torch.device("cuda")
    totals = {k: 0 for k in counted_kernels()}
    for yaml in VPS_BACKBONE_YAMLS:
        cfg, model, kw, windows = build_vps(torch, yaml, dev)
        t = kw["clip_len"]
        pipe = TubeLinkVPSInference(model, **kw, **VPS_ZERO)
        pipe.window_forward(windows[0])  # warm-up

        def stream():
            pipe.init_memory()
            return [pipe.process_window(w, i) for i, w in enumerate(windows)]

        maps, launches, fwd_ms, peak, _ = counted_run(torch, model, stream)
        want = expect(K2=K2_TUBE * len(windows), K3=K3_TUBE * len(windows))
        check_vps_ids(maps, pipe, yaml)
        hw = tuple(s // 4 for s in cfg.input.image_size)
        segments = [len(np.unique(m[m != pipe.num_classes])) for m in maps]
        log(f"vps backbones {yaml} ({cfg.model.backbone.name}, "
            f"{cfg.model.dtype}, {sum(p.numel() for p in model.parameters())}"
            f" parameters): {len(windows)} windows of {t}, id maps "
            f"{[m.shape for m in maps][0]}, segments a window {segments}; the "
            f"window forward {_ms_stats(fwd_ms)}"
            f"; peak memory {peak:.3f} GiB; launches {launches} (want "
            f"{want}); {card}")
        if launches != want or any(m.shape != (t,) + hw for m in maps):
            raise AssertionError(f"vps backbones {yaml}: {launches}")
        for k, v in launches.items():
            totals[k] += v
        del model, pipe, windows
        torch.cuda.empty_cache()
    return totals


def phase_swin_images(torch, card: str):
    """One image each through two Swin-L image models at full width,
    random weights from seed 0, built by the registry: ``KMAX_SWIN_YAML``
    (kMaX-DeepLab, bf16, 1281x1281: the patch embed pads SAME by (1, 2);
    no kernel of the port runs on this path) and its instance inference;
    ``M2F_SWIN_YAML`` (Mask2Former, bf16, 1024x1024: K2) and its panoptic
    fusion at zero thresholds. Checks shapes, finite values and the launch
    counts; logs each forward's ms (CUDA events; a warm-up first) and peak
    memory. Returns the launch counts."""
    from axial_vs_tpu_torch.models.postprocess import instance_inference
    from axial_vs_tpu_torch.models.tube_link.fusion import (INSTANCE_OFFSET,
                                                            panoptic_fusion)
    from axial_vs_tpu_torch.models.tube_link.vps import num_things_split

    dev = torch.device("cuda")
    totals = {k: 0 for k in counted_kernels()}
    for yaml, k2 in ((KMAX_SWIN_YAML, 0), (M2F_SWIN_YAML, K2_TUBE)):
        cfg, model, x = build_image_model(torch, yaml, dev)
        hw = tuple(cfg.input.image_size)
        if model.dtype != torch.bfloat16 or not cfg.model.backbone.name.startswith(
                "swin_large"):
            raise AssertionError(f"swin-l images {yaml}: not bf16 Swin-L")
        out, launches, (fwd_ms,), peak, _ = image_forward(torch, model, x)
        t0 = time.perf_counter()
        if yaml == KMAX_SWIN_YAML:
            classes = cfg.model.num_classes
            with torch.inference_mode():
                inst = instance_inference(
                    out["pred_logits"][0], out["pred_masks"][0],
                    torch.ones(classes, dtype=torch.bool, device=dev),
                    cfg.model.kmax.test.test_topk_per_image)
            torch.cuda.synchronize()
            k = cfg.model.kmax.test.test_topk_per_image
            ok = (tuple(inst["pred_masks"].shape)
                  == (k,) + tuple(out["pred_masks"].shape[1:3])
                  and bool(torch.isfinite(inst["scores"]).all())
                  and int(inst["pred_classes"].max()) < classes)
            what = (f"instance_inference: {k} instances, masks "
                    f"{tuple(inst['pred_masks'].shape)}")
        else:
            num_things, _ = num_things_split(cfg)
            pan, _ = panoptic_fusion(
                "with_query", out["cls_preds"][-1][0].float().cpu().numpy(),
                out["mask_preds"][-1][0].float().cpu().numpy(), num_things,
                cfg.model.num_classes, object_mask_thr=0.0, iou_thr=0.0)
            ok = (pan.shape == (hw[0] // 4, hw[1] // 4)
                  and bool(((pan >= 0) & (pan <= cfg.model.num_classes)
                            | (pan % INSTANCE_OFFSET < num_things)).all()))
            what = (f"panoptic fusion: map {pan.shape}, "
                    f"{len(np.unique(pan))} segments")
        post_s = time.perf_counter() - t0
        finite = all(bool(torch.isfinite(v.float()).all()) for v in (
            [out["pred_logits"], out["pred_masks"]] if "pred_logits" in out
            else out["cls_preds"] + out["mask_preds"]))
        want = expect(K2=k2)
        log(f"swin-l images {yaml} ({hw[0]}x{hw[1]}, bf16): forward "
            f"{fwd_ms:.2f} ms (CUDA events, "
            f"after a warm-up), outputs finite {finite}; {what} in "
            f"{post_s:.3f} s; peak memory {peak:.3f} GiB; launches "
            f"{launches} (want {want}); {card}")
        if not (ok and finite and launches == want):
            raise AssertionError(f"swin-l images {yaml}")
        for key, v in launches.items():
            totals[key] += v
        del model, out
        torch.cuda.empty_cache()
    return totals


def phase_backbone_reference(torch, card: str):
    """The Swin-L backbone of ``SWIN_VIS_YAML`` on one ``SWIN_REF_HW``
    frame and the STDC2 backbone of ``VPS_BACKBONE_YAMLS[1]`` on one
    ``STDC_REF_HW`` frame, in f32 (TF32 off), random weights from seed 0:
    the card against a CPU copy, each output within
    ``BACKBONE_REF_BOUND`` of max |ref|. No kernel of the port runs here.
    Returns the launch counts."""
    import copy

    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.models.kmax import build_backbone, materialize

    dev = torch.device("cuda")
    full_f32(torch)
    reset_counts()
    for yaml, hw in ((SWIN_VIS_YAML, SWIN_REF_HW),
                     (VPS_BACKBONE_YAMLS[1], STDC_REF_HW)):
        cfg = load_config(yaml)
        backbone, channels = build_backbone(cfg, device=torch.device("meta"))
        backbone = materialize(backbone, dev, torch.Generator(
            device=dev).manual_seed(0), None)
        x = torch.randn(1, *hw, 3, generator=torch.Generator().manual_seed(4))
        with torch.inference_mode():
            card_out = backbone(x.to(dev))
            cpu_out = copy.deepcopy(backbone).cpu()(x)
        errs = {k: rel_err(card_out[k], cpu_out[k]) for k in cpu_out}
        log(f"backbone reference {cfg.model.backbone.name} ({hw[0]}x{hw[1]}, "
            f"f32 both): outputs " + ", ".join(
                f"{k} {tuple(v.shape)}" for k, v in cpu_out.items())
            + "; max |diff| / max |ref| " + ", ".join(
                f"{k} {v:.4g}" for k, v in errs.items())
            + f" (bound {BACKBONE_REF_BOUND}); {card}")
        if not (max(errs.values()) <= BACKBONE_REF_BOUND
                and list(cpu_out) == list(channels)):
            raise AssertionError(f"backbone reference {yaml} disagrees")
        del backbone, card_out, cpu_out
    launches = read_counts()
    if launches != expect():
        raise AssertionError(f"backbone reference launches {launches}")
    torch.cuda.empty_cache()
    return launches


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
    lap = Laps("probes")
    results = _probe_p4(torch, bench_pallas_bw)
    lap("P4")
    results["P2"] = _probe_p2(torch, exp_vmem_gather, bench_pallas_bw)
    lap("P2")
    results["P1"] = _probe_p1(torch, exp_dwconv_variants)
    lap("P1")
    results.update(_probe_p3(torch, bench_overlap))
    lap("P3")
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


#: wall seconds of each phase of this run, in order (informational)
PHASE_SECONDS = {}


def timed_phase(name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept in ``PHASE_SECONDS[name]``."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0
        log(f"phase {name}: {PHASE_SECONDS[name]:.1f} s")


def in_temp_dir(prefix: str, fn):
    """``fn(root)`` in a fresh temporary directory ``root``, removed after."""
    root = tempfile.mkdtemp(prefix=prefix)
    try:
        return fn(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    import torch

    t_start = time.perf_counter()
    card = phase_device(torch)
    timed_phase("build", phase_build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"K1": timed_phase("K1", phase_k1, torch, gen)}
    k2_drawn = timed_phase("K2", phase_k2, torch, gen)
    results["K3"] = timed_phase("K3", phase_k3, torch, gen)
    captured = {}  # the first K2 call's arguments of each model path
    results["K5"], results["K4"] = timed_phase("K4/K5", phase_k4_k5, torch,
                                               gen)
    paths = {}
    model, paths["wc_3_clips"] = timed_phase("slice", phase_slice, torch,
                                             captured)
    timed_phase("reference dwln", phase_reference, torch, [("dwln", model)],
                True)
    del model
    paths["r50_f32_1_clip"] = timed_phase("r50 f32", phase_r50_f32, torch)
    paths["train_r50_f32_3_steps"], train_backward = timed_phase(
        "train r50 f32", phase_train_r50_f32, torch, card)
    paths["train_convnext_large_bf16_3_steps"], train_backward_bf16 = (
        timed_phase("train convnext_large bf16",
                    phase_train_convnext_large_bf16, torch, card))
    paths["trainer_4_steps"] = timed_phase(
        "trainer", in_temp_dir, "chip_smoke_trainer_",
        lambda root: phase_trainer(torch, root))
    block_model, paths["vipseg_eval_2_videos"] = timed_phase(
        "eval", in_temp_dir, "chip_smoke_",
        lambda root: phase_eval(torch, root))
    mlp_model, paths["mlp_route_1_clip"] = timed_phase(
        "mlp route", phase_mlp_route, torch)
    timed_phase("reference block/mlp", phase_reference, torch,
                [("block", block_model), ("mlp", mlp_model)])
    del block_model, mlp_model
    torch.cuda.empty_cache()
    paths["cc_eval_2_videos"] = timed_phase(
        "cc eval", in_temp_dir, "chip_smoke_cc_",
        lambda root: phase_cc_eval(torch, root, card))
    paths["train_cc_convnext_large_3_steps"], train_backward_cc = timed_phase(
        "train cc convnext_large", phase_train_cc_convnext_large, torch, card)
    model, paths["tube_link_3_tubes"] = timed_phase(
        "tube-link", phase_tube_link, torch, captured)
    timed_phase("tube-link reference", phase_tube_link_reference, torch, model)
    del model
    torch.cuda.empty_cache()
    ytvis = timed_phase("ytvis eval", in_temp_dir, "chip_smoke_ytvis_",
                        lambda root: phase_ytvis_eval(torch, root))
    paths["ytvis_eval_temporal_2_videos"] = ytvis["temporal"]
    paths["ytvis_eval_baseline_2_videos"] = ytvis["baseline"]
    paths["overfit_wc_8_heads_1_step"], overfit_checks = timed_phase(
        "overfit heads of 8", in_temp_dir, "chip_smoke_overfit_",
        lambda root: phase_overfit_heads(torch, root))
    results["K2"] = timed_phase("K2 model inputs", phase_k2_model, torch,
                                captured, k2_drawn)
    del captured
    torch.cuda.empty_cache()
    paths["train_tube_link_3_steps"], train_backward_tl = timed_phase(
        "train tube-link", in_temp_dir, "chip_smoke_tl_train_",
        lambda root: phase_train_tube_link(torch, root, card))
    paths["tube_link_train_reference"] = timed_phase(
        "tube-link train reference", phase_tube_link_train_reference, torch)
    paths["overfit_vis_2_steps"], overfit_vis_checks = timed_phase(
        "overfit vis", in_temp_dir, "chip_smoke_overfit_vis_",
        lambda root: phase_overfit_vis(torch, root))
    (paths["tube_link_vps_12_windows"], results["K2"]["vps_window_f32"],
     results["K3"]["vps_window_f32"]) = timed_phase(
        "tube-link vps", phase_vps, torch, card)
    (paths["cc_vis_2_videos"], results["K2"]["cc_vis_segmenter_f32"],
     results["K3"]["cc_vis_f32"]) = timed_phase(
        "cc vis", phase_cc_vis, torch, card)
    paths["image_m2f_1_image"], results["K2"]["image_m2f_f32"] = timed_phase(
        "image m2f", phase_image_m2f, torch, card)
    torch.cuda.empty_cache()
    (paths["coco_eval_3_images"], results["K1"]["coco_image"],
     results["K2"]["coco_image"]) = timed_phase(
        "coco eval", in_temp_dir, "chip_smoke_coco_",
        lambda root: phase_coco_eval(torch, root, card))
    torch.cuda.empty_cache()
    (paths["convnextv2_1_image"],
     results["K1"]["convnextv2_grn_block"]) = timed_phase(
        "convnextv2", phase_convnextv2, torch, card)
    torch.cuda.empty_cache()
    paths["kmax_r50_reference"] = timed_phase(
        "kmax r50 reference", phase_kmax_r50_reference, torch, card)
    torch.cuda.empty_cache()
    (paths["swin_l_vis_3_tubes"], paths["swin_l_ytvis_eval_2_videos"],
     results["K2"]["swin_l_vis_tube"],
     results["K3"]["swin_l_vis_tube"]) = timed_phase(
        "swin-l vis", in_temp_dir, "chip_smoke_swin_",
        lambda root: phase_swin_vis(torch, root, card))
    torch.cuda.empty_cache()
    paths["train_swin_l_vis_3_steps"] = timed_phase(
        "swin-l vis train", in_temp_dir, "chip_smoke_swin_train_",
        lambda root: phase_train_swin_vis(torch, root, card))
    paths["vps_stdc1_stdc2_swin_b_9_windows"] = timed_phase(
        "tube-link vps backbones", phase_vps_backbones, torch, card)
    paths["swin_l_images"] = timed_phase("swin-l images", phase_swin_images,
                                         torch, card)
    paths["swin_stdc_reference"] = timed_phase(
        "swin/stdc reference", phase_backbone_reference, torch, card)
    torch.cuda.empty_cache()
    paths["msda_bench"], reduces, variant_ms = timed_phase(
        "msda bench", phase_msda_bench, torch, gen)
    results.update(reduces)
    paths["probes"], probes = timed_phase("probes", phase_probes, torch)
    results.update(probes)
    log(f"seconds by phase (wall, {time.perf_counter() - t_start:.1f} s in "
        f"all): " + json.dumps({k: round(v, 1)
                                for k, v in PHASE_SECONDS.items()}))
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
                               if key in train_backward else {}),
            **({"train_backward_cc_f32": train_backward_cc[key]}
               if key in train_backward_cc else {}),
            **({"overfit_wc_8_heads": overfit_checks[key]}
               if key in overfit_checks else {}),
            **({"train_backward_tube_link_f32": train_backward_tl[key],
                "overfit_vis_8_heads": overfit_vis_checks[key]}
               if key in train_backward_tl else {})})
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
