#!/usr/bin/env python3
"""Drive the PyTorch port (``axial_vs_tpu_torch``) once on one CUDA card.

Phases, in order; any failure exits non-zero before the last line:
  1. device  - require CUDA, print the card's name and power limit, pin TF32
  2. build   - compile the hand-written kernels from ``axial_vs_tpu_torch/csrc``
  3. K1      - dwconv7x7+LayerNorm kernel against its plain version
  4. K2      - deformable-attention kernel against its plain version
  5. K3      - trajectory-attention kernel against its plain version
  6. WC slice - the ConvNeXt-L within-clip (WC) forward at 769x1345, T=2,
               bf16, random weights from a seed: 3 clips, finite outputs,
               and the kernel launch counts of that run
  7. WC reference - the same weights on a small clip, the card's bf16 run
               against an f32 run of the plain versions on the CPU
  8. Tube-Link slice - the Tube-Link R50 VIS inference at 360x640, tubes of
               5 frames, bf16, random weights from a seed: a 15-frame video
               (3 tubes) through ``TubeLinkVISInference.run_video``, 30
               instances, and the launch counts of that run
  9. Tube-Link reference - the pixel decoder on a small tube, the card's
               bf16 run against an f32 run of the plain versions on the CPU
The line before the last is one JSON object with each kernel's route,
source, launches, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.

Usage, from the repository root: ``python3 chip_smoke.py``
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

T, H, W = 2, 769, 1345  # 2-frame clips at the VIPSeg eval size
CONVNEXT_L_DEPTHS = (3, 3, 27, 3)
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


def bound_ms(flops: float, nbytes: float, peak: float):
    """(least ms, what bounds it): the larger of the operations over the
    peak rate of their type and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")


def phase_k1(torch, gen):
    from axial_vs_tpu_torch.ops.convnext_cuda import (
        dwconv7x7_layernorm, dwconv7x7_layernorm_plain)

    dev = torch.device("cuda")
    worst = 0.0
    times = []
    for n, h, w, c in KERNEL_SHAPES_K1:
        def r(*shape, scale=1.0, dtype=torch.float32):
            return (torch.randn(*shape, generator=gen, device=dev) * scale
                    ).to(dtype)

        x = r(n, h, w, c, dtype=torch.bfloat16)
        wt = r(c, 1, 7, 7, scale=0.1, dtype=torch.bfloat16)
        b, lw, lb = r(c, scale=0.1), 1.0 + r(c, scale=0.1), r(c, scale=0.1)
        got = dwconv7x7_layernorm(x, wt, b, lw, lb)
        want = dwconv7x7_layernorm_plain(x, wt, b, lw, lb)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        bound = 2 * bf16_ulp(scale)  # f32 sums reassociated, both rounded once
        ms = cuda_ms(torch, lambda: dwconv7x7_layernorm(x, wt, b, lw, lb))
        plain_ms = cuda_ms(torch, lambda: dwconv7x7_layernorm_plain(
            x, wt, b, lw, lb))
        log(f"K1 {(n, h, w, c)}: max_abs_err {err:.6g} (bound 2 bf16 ulp of "
            f"max|out| {scale:.4g} = {bound:.6g}); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        if not err <= bound:
            raise AssertionError(f"K1 disagrees at {(n, h, w, c)}")
        worst = max(worst, err)
        times.append((ms, plain_ms))
    # per clip: each stage's time times its number of blocks
    per_clip = [sum(d * t[i] for d, t in zip(CONVNEXT_L_DEPTHS, times))
                for i in (0, 1)]
    # work per clip: 49 f32 multiply-adds and ~10 LayerNorm operations per
    # output element on the CUDA cores; x read once, out written once
    elems = sum(d * math.prod(shape)
                for d, shape in zip(CONVNEXT_L_DEPTHS, KERNEL_SHAPES_K1))
    weights = sum(d * shape[-1] * (49 * 2 + 3 * 4)
                  for d, shape in zip(CONVNEXT_L_DEPTHS, KERNEL_SHAPES_K1))
    bound, by = bound_ms((2 * 49 + 10) * elems, 4 * elems + weights, PEAK_F32)
    log(f"K1 per clip (3/3/27/3 calls at the stage shapes): kernel "
        f"{per_clip[0]:.4f} ms, plain {per_clip[1]:.4f} ms, bound "
        f"{bound:.4f} ms ({by})")
    return {"max_abs_err": worst, "ms": per_clip[0], "plain_ms": per_clip[1],
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "per": "WC clip (36 calls)"}


def _msda_inputs(torch, gen, b, shapes, lq, m, d, p, lo, hi):
    dev = torch.device("cuda")
    s = sum(h * w for h, w in shapes)
    value = torch.randn(b, s, m, d, generator=gen, device=dev).bfloat16()
    loc = lo + (hi - lo) * torch.rand(b, lq, m, len(shapes), p, 2,
                                      generator=gen, device=dev)
    logits = torch.randn(b, lq, m, len(shapes) * p, generator=gen, device=dev)
    weights = logits.softmax(-1).reshape(b, lq, m, len(shapes), p).bfloat16()
    return value, loc, weights


def phase_k2(torch, gen):
    from axial_vs_tpu_torch.ops.msda import (
        level_start_index, ms_deform_attn, ms_deform_attn_plain)

    cases = [
        # the WC shape: B*T frames, res5/res4/res3 tokens as queries
        ("wc", 2, WC_LEVELS, sum(h * w for h, w in WC_LEVELS), 8, 32, 4,
         -0.1, 1.1),
        # ragged: D > 32 and not a multiple of 32, odd levels, locations
        # straddling the border
        ("ragged", 1, ((5, 7), (3, 4), (2, 3)), 37, 3, 40, 3, -0.2, 1.2),
    ]
    result = None
    for name, b, shapes, lq, m, d, p, lo, hi in cases:
        value, loc, weights = _msda_inputs(torch, gen, b, shapes, lq, m, d, p,
                                           lo, hi)
        starts = level_start_index(shapes)
        got = ms_deform_attn(value, shapes, starts, loc, weights)
        want = ms_deform_attn_plain(value, shapes, starts, loc, weights)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        bound = 2 * bf16_ulp(scale)  # f32 sums on both sides, rounded once
        ms = cuda_ms(torch, lambda: ms_deform_attn(value, shapes, starts, loc,
                                                   weights))
        plain_ms = cuda_ms(torch, lambda: ms_deform_attn_plain(
            value, shapes, starts, loc, weights), launches=3)
        log(f"K2 {name} value {tuple(value.shape)} locations "
            f"{tuple(loc.shape)}: max_abs_err {err:.6g} (bound 2 bf16 ulp of "
            f"max|out| {scale:.4g} = {bound:.6g}); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        if not err <= bound:
            raise AssertionError(f"K2 disagrees on the {name} case")
        if result is None:  # per clip: the WC module calls it twice
            # each input read once, the output written once; 2 f32
            # operations per corner per channel (the weighted bilinear sum)
            nbytes = sum(x.numel() * x.element_size()
                         for x in (value, loc, weights)) + b * lq * m * d * 2
            flops = 2 * 4 * d * loc[..., 0].numel()
            bound, by = bound_ms(2 * flops, 2 * nbytes, PEAK_F32)
            result = {"max_abs_err": err, "ms": 2 * ms, "plain_ms": 2 * plain_ms,
                      "bound_ms": bound, "bound_by": by, "library_ms": None,
                      "per": "WC clip (2 calls)"}
            log(f"K2 per clip (2 calls at the wc shape): kernel {2 * ms:.4f} "
                f"ms, plain {2 * plain_ms:.4f} ms, bound {bound:.4f} ms "
                f"({by}, {nbytes / 1e6:.1f} MB per call)")
        result["max_abs_err"] = max(result["max_abs_err"], err)
    return result


def _traj_inputs(torch, gen, b, f, n, c=256):
    """q, k, v (b, f*n, c) ~ N(0, 1); proj_q / proj_kv at their
    xavier-uniform and U(+-1/sqrt(c)) inits, matrices bf16."""
    def u(*shape, bound):
        return (torch.rand(*shape, generator=gen, device="cuda") * 2 - 1) * bound

    q, k, v = (torch.randn(b, f * n, c, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    wq = u(c, c, bound=(6 / (2 * c)) ** 0.5).bfloat16()
    wkv = u(2 * c, c, bound=(6 / (3 * c)) ** 0.5).bfloat16()
    return q, k, v, wq, u(c, bound=c ** -0.5), wkv, u(2 * c, bound=c ** -0.5)


def _traj_work(b, f, n, c=256):
    """(FLOPs, bytes) of one call: stage 1, proj_q, proj_kv; q, k, v read
    once, out written once, the bf16 stage-2 weights read once."""
    nt = f * n
    flops = 4 * b * nt * nt * c + 2 * b * nt * c * c + 4 * f * b * nt * c * c
    return flops, 8 * b * nt * c + 6 * c * c


def phase_k3(torch, gen):
    from axial_vs_tpu_torch.ops.traj import (
        TRAJ_ULPS, trajectory_attention_core, trajectory_attention_core_plain)

    cases = [("wc " + k, v) for k, v in K3_WC.items()]
    cases += [("tube-link " + k, v) for k, v in K3_TL.items()]
    cases += [("f=3 small n", (3, 3, 7))]
    worst, times = 0.0, {}
    for name, (b, f, n) in cases:
        args = _traj_inputs(torch, gen, b, f, n)
        got = trajectory_attention_core(*args, f, 8)
        want = trajectory_attention_core_plain(*args, f, 8)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        bound = TRAJ_ULPS * bf16_ulp(scale)
        ms = cuda_ms(torch, lambda: trajectory_attention_core(*args, f, 8))
        plain_ms = cuda_ms(torch, lambda: trajectory_attention_core_plain(
            *args, f, 8), launches=3)
        log(f"K3 {name} (B'={b}, f={f}, n={n}, N={f * n}): max_abs_err "
            f"{err:.6g} (bound {TRAJ_ULPS} bf16 ulp of max|out| {scale:.4g} = "
            f"{bound:.6g}, {bound / scale:.4g} of max|out|); kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms")
        if not (err <= bound and torch.isfinite(got.float()).all()):
            raise AssertionError(f"K3 disagrees on the {name} case")
        worst = max(worst, err)
        times[name] = (ms, plain_ms)
    totals = {}
    for path, shapes, calls in (("wc", K3_WC, K3_WC_CALLS),
                                ("tube-link", K3_TL, K3_TL_CALLS)):
        ms, plain = (calls * sum(times[f"{path} {k}"][i] for k in shapes)
                     for i in (0, 1))
        flops, nbytes = (calls * sum(_traj_work(*s)[i] for s in shapes.values())
                         for i in (0, 1))
        bound, by = bound_ms(flops, nbytes, PEAK_BF16)
        totals[path] = (ms, plain, bound, by)
        log(f"K3 per {'clip' if path == 'wc' else 'tube'} on the {path} path "
            f"({calls * len(shapes)} calls): kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound:.4f} ms ({by}: {flops / 1e9:.2f} "
            f"GFLOP, {nbytes / 1e6:.1f} MB)")
    ms, plain, bound, by = totals["tube-link"]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "per": "Tube-Link tube (24 calls)",
            "wc_clip": dict(zip(("ms", "plain_ms", "bound_ms"),
                                totals["wc"][:3]))}


def wc_convnext_large_config():
    """The configuration ``bench.py`` builds by default (the repo's default
    config with bench.py's overrides), as plain objects: ConvNeXt-L, the
    within-clip module, the kMaX decoders, 124 VIPSeg classes, bf16."""
    from types import SimpleNamespace as N

    return N(
        input=N(num_clip_frames=T, image_size=[H, W]),
        model=N(
            dtype="bfloat16", num_classes=124,
            backbone=N(name="convnext_large",
                       out_features=["res2", "res3", "res4", "res5"],
                       convnext=N(depths=list(CONVNEXT_L_DEPTHS),
                                  dims=[192, 384, 768, 1536],
                                  layer_scale_init_value=1e-6,
                                  use_grn=False)),
            maxtron=N(wc=N(enable=True, nheads=8, dim_feedforward=1024,
                           conv_dims=256, num_stages=2, spatial_layers=2,
                           temporal_layers=4,
                           temporal_attn_type="axial_trajectory",
                           spatial_in_features=["res3", "res4", "res5"],
                           temporal_in_features=["res4", "res5"],
                           enc_n_points=4)),
            kmax=N(pixel_dec=N(in_features=["res2", "res3", "res4", "res5"],
                               dec_layers=[1, 5, 1, 1],
                               dec_channels=[512, 256, 128, 64],
                               layer_types=["axial", "axial", "bottleneck",
                                            "bottleneck"]),
                   trans_dec=N(dec_layers=[2, 2, 2],
                               num_object_queries=128))))


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


def phase_slice(torch):
    """Returns the launch counts of the 3-clip run."""
    from axial_vs_tpu_torch.models.kmax import build_segmenter
    from axial_vs_tpu_torch.ops.convnext_cuda import dwconv7x7_layernorm
    from axial_vs_tpu_torch.ops.msda import ms_deform_attn
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core

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
        model(clips[0])  # warm-up (cuDNN/cuBLAS selection, allocator)
        torch.cuda.synchronize()
        log(f"slice: warm-up clip {time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        dwconv7x7_layernorm.launches = 0
        ms_deform_attn.launches = 0
        trajectory_attention_core.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = [model(x) for x in clips]
        end.record()
        end.synchronize()
        launches = {"K1": dwconv7x7_layernorm.launches,
                    "K2": ms_deform_attn.launches,
                    "K3": trajectory_attention_core.launches}
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
    want = {"K1": sum(CONVNEXT_L_DEPTHS) * 3, "K2": 2 * 3,
            "K3": 4 * K3_WC_CALLS * 3}
    log(f"slice: launches in the 3-clip run: {launches} (want {want})")
    log(f"slice (informational): {3 * T / (ms / 1000):.3f} frames/s "
        f"({ms / 3:.2f} ms per clip, CUDA events, batch of 1 clip, eager); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches}")
    return model, launches


def phase_reference(torch, model):
    """A small clip through a copy of the model on the card (bf16, kernels)
    and in f32 on the CPU (the kernels' plain versions). In the copy the
    ConvNeXt layer scales (1e-6 at init) are set to 0.1, so that K1's
    branch reaches the outputs; K2's does at the upstream inits."""
    import copy

    from axial_vs_tpu_torch.models.backbones.convnext import ConvNeXtBlock

    dev = torch.device("cuda")
    card_model = copy.deepcopy(model)
    with torch.no_grad():
        for m in card_model.modules():
            if isinstance(m, ConvNeXtBlock):
                m.gamma.fill_(0.1)
    ref_model = copy.deepcopy(card_model).float().cpu()
    ref_model.dtype = None
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(T, 129, 193, 3, generator=g, device=dev)
    with torch.inference_mode():
        got = card_model(x)
        want = ref_model(x.cpu())
    worst = {}
    for k in OUTPUTS:
        a, b = got[k].float().cpu(), want[k]
        if a.shape != b.shape:
            raise AssertionError(f"reference {k}: {a.shape} != {b.shape}")
        worst[k] = ((a - b).abs().max() / b.abs().max().clamp_min(1e-6)).item()
    log("reference (129x193 clip, card bf16 vs CPU f32 plain versions): "
        "max |diff| / max |ref| " + ", ".join(
            f"{k} {v:.4g}" for k, v in worst.items())
        + f"; bound {REFERENCE_BOUND}")
    for k, v in worst.items():
        if not v <= REFERENCE_BOUND:
            raise AssertionError(f"reference {k}: {v:.4g} > {REFERENCE_BOUND}")


def tube_link_r50_config():
    """The configuration ``tools/bench_tube_link.py`` builds (the repo's
    default config with its overrides), as plain objects: ResNet-50, the
    fused MSDA + axial-trajectory pixel decoder, the Mask2Former tube head
    (100 queries, 9 layers, 256 channels), 40 YTVIS-19 classes, 5-frame
    tubes, bf16."""
    from types import SimpleNamespace as N

    return N(
        input=N(num_clip_frames=TL_T),
        model=N(
            meta_architecture="TubeLinkVIS", dtype="bfloat16", num_classes=40,
            backbone=N(name="resnet50",
                       out_features=["res2", "res3", "res4", "res5"],
                       resnet=N(depth=50)),
            tube_link=N(num_queries=100, feat_channels=256, out_channels=256,
                        num_decoder_layers=9, clip_len=TL_T, overlap=0,
                        use_temporal_attn=True, test_topk=30)))


TL_MASK_HW = (90, 160)  # res2 of 360x640
#: bound on max |card - reference| / max |reference| for the pixel
#: decoder's outputs (mask_feature and the res5/res4/res3 encoder levels),
#: card bf16 against CPU f32. bf16 alone drifts: the plain versions run in
#: bf16 on a CPU were 0.010-0.015 of scale off the f32 run (gamma 0.5), and
#: every run prints that drift beside the card's. The bound leaves about 3x.
TL_REFERENCE_BOUND = 0.05


def phase_tube_link(torch):
    """The Tube-Link R50 VIS path on a 15-frame 360x640 video (3 tubes of
    5) through ``run_video``. Returns the model and the launch counts."""
    from axial_vs_tpu_torch.models.tube_link.detector import (
        TubeLinkVISInference, build_tube_link_vis)
    from axial_vs_tpu_torch.ops.convnext_cuda import dwconv7x7_layernorm
    from axial_vs_tpu_torch.ops.msda import ms_deform_attn
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core

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
        model(videos[0][:TL_T])  # warm-up (cuDNN/cuBLAS selection, allocator)
        torch.cuda.synchronize()
        log(f"tube-link: warm-up tube {time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        for counted in (dwconv7x7_layernorm, ms_deform_attn,
                        trajectory_attention_core):
            counted.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = pipeline.run_video(videos[0])
        end.record()
        end.synchronize()
        launches = {"K1": dwconv7x7_layernorm.launches,
                    "K2": ms_deform_attn.launches,
                    "K3": trajectory_attention_core.launches}
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
    want = {"K1": 0, "K2": 6 * 3, "K3": 4 * K3_TL_CALLS * 3}
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


def main() -> int:
    import torch

    card = phase_device(torch)
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = phase_k1(torch, gen)
    k2 = phase_k2(torch, gen)
    k3 = phase_k3(torch, gen)
    model, wc = phase_slice(torch)
    phase_reference(torch, model)
    del model
    torch.cuda.empty_cache()
    model, tube = phase_tube_link(torch)
    phase_tube_link_reference(torch, model)
    kernels = []
    for key, k, name, source, replaces in (
            ("K1", k1, "dwconv7x7_layernorm", "dwconv_ln.cu",
             "convnext_pallas.py:82"),
            ("K2", k2, "ms_deform_attn", "msda.cu", "msda_pallas.py:120"),
            ("K3", k3, "trajectory_attention_core", "traj.cu",
             "traj_pallas.py:145")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"axial_vs_tpu_torch/csrc/{source}",
            "replaces": f"axial_vs_tpu/ops/{replaces}",
            "launches": wc[key] + tube[key],
            "launches_by_path": {"wc_3_clips": wc[key],
                                 "tube_link_3_tubes": tube[key]},
            **k})
    log(card)  # as nvidia-smi gives it: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
