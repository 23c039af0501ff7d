#!/usr/bin/env python3
"""Drive the PyTorch port (``axial_vs_tpu_torch``) once on one CUDA card.

Phases, in order; any failure exits non-zero before the last line:
  1. device  - require CUDA, print the card's name and power limit, pin TF32
  2. build   - compile the hand-written kernels from ``axial_vs_tpu_torch/csrc``
  3. K1      - dwconv7x7+LayerNorm kernel against its plain version
  4. K2      - deformable-attention kernel against its plain version
  5. slice   - the ConvNeXt-L within-clip (WC) forward at 769x1345, T=2,
               bf16, random weights from a seed: 3 clips, finite outputs,
               and the kernel launch counts of that run
  6. reference - the same weights on a small clip, the card's bf16 run
               against an f32 run of the plain versions on the CPU
The line before the last is one JSON object with each kernel's route,
source, launches, error and times; the last line is
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

T, H, W = 2, 769, 1345  # 2-frame clips at the VIPSeg eval size
CONVNEXT_L_DEPTHS = (3, 3, 27, 3)
KERNEL_SHAPES_K1 = [  # (N, H, W, C): the four ConvNeXt-L stages at 769x1345
    (2, 192, 336, 192), (2, 96, 168, 384), (2, 48, 84, 768), (2, 24, 42, 1536),
    (1, 37, 53, 200),  # odd H and W, C not a power of two
]
WC_LEVELS = ((24, 42), (48, 84), (96, 168))  # res5, res4, res3 at 769x1345


def log(msg: str) -> None:
    print(msg, flush=True)


def bf16_ulp(x: float) -> float:
    """One bf16 unit in the last place at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


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
    log(f"K1 per clip (3/3/27/3 calls at the stage shapes): kernel "
        f"{per_clip[0]:.4f} ms, plain {per_clip[1]:.4f} ms")
    return {"max_abs_err": worst, "ms": per_clip[0], "plain_ms": per_clip[1]}


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
            result = {"max_abs_err": err, "ms": 2 * ms, "plain_ms": 2 * plain_ms}
            log(f"K2 per clip (2 calls at the wc shape): kernel {2 * ms:.4f} "
                f"ms, plain {2 * plain_ms:.4f} ms")
        result["max_abs_err"] = max(result["max_abs_err"], err)
    return result


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
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = [model(x) for x in clips]
        end.record()
        end.synchronize()
        launches = {"K1": dwconv7x7_layernorm.launches,
                    "K2": ms_deform_attn.launches}
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
    log(f"slice: launches in the 3-clip run: K1 {launches['K1']} (want "
        f"{sum(CONVNEXT_L_DEPTHS) * 3}), K2 {launches['K2']} (want {2 * 3})")
    log(f"slice (informational): {3 * T / (ms / 1000):.3f} frames/s "
        f"({ms / 3:.2f} ms per clip, CUDA events, batch of 1 clip, eager); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if launches != {"K1": sum(CONVNEXT_L_DEPTHS) * 3, "K2": 2 * 3}:
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


def main() -> int:
    import torch

    card = phase_device(torch)
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = phase_k1(torch, gen)
    k2 = phase_k2(torch, gen)
    model, launches = phase_slice(torch)
    phase_reference(torch, model)
    kernels = [
        {"name": "dwconv7x7_layernorm", "route": "cuda",
         "source": "axial_vs_tpu_torch/csrc/dwconv_ln.cu",
         "replaces": "axial_vs_tpu/ops/convnext_pallas.py:82",
         "launches": launches["K1"], **k1},
        {"name": "ms_deform_attn", "route": "cuda",
         "source": "axial_vs_tpu_torch/csrc/msda.cu",
         "replaces": "axial_vs_tpu/ops/msda_pallas.py:120",
         "launches": launches["K2"], **k2},
    ]
    log(card)  # as nvidia-smi gives it: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
