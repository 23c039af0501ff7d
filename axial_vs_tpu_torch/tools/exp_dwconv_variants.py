"""Probe: where a dwconv7x7 + LayerNorm kernel loses its time, on one CUDA
card (P1).

Counterpart of the JAX package's ``tools/exp_dwconv_variants.py``. ``ship``
is the port's K1 (``ops/convnext_cuda.py::dwconv7x7_layernorm``); the eight
variants are one CUDA kernel templated on the variant
(``csrc/dwconv_variants.cu``), each with K1's layout turned a quarter (a
thread's 4 pixels run down a column, so that its taps arrive dx-major) and
differing from K1 otherwise only in what its name says. Each sums its 49
taps (numbered dx-major, dy-minor) in its JAX body's order, which its plain
version (``dwconv_variant_plain``) reproduces in f32:

  noln     bias, then the 49-product chain; no LayerNorm (the LN's share)
  tree     the 49 products by ``_k_tree``'s pairwise tree, then the bias
  bf16mul  products rounded to bf16, f32 chain from the bias
  f32once  the input staged in f32 in shared memory, each column the
           block reads converted once (a column a dx)
  dxpart   7 dy-chains, one per dx, tree-combined, then bias + that
  acc2     taps round-robin over 2 accumulators, then the bias
  acc4     the same over 4
  dxonce   dxpart over f32once's staged input

Weights are bf16 in torch's (C, 1, 7, 7) layout, as K1 takes them: the JAX
tool's f32 draw ``randn(7, 7, 1, C) * 0.1`` is rounded to bf16 once, so
``ship`` and the variants see the same weights. On the card both kernels
read them tap-major, (7, 7, C): ``run`` makes that copy
(``ops/convnext_cuda.py::dwconv_taps``) once a stage, outside the timed
calls, and passes it as ``taps=``, as the ConvNeXt block passes its own.
Bias and LayerNorm parameters are f32 (ones and zeros for the norm, as the
JAX tool's main).
Each variant is checked against its plain version (max |diff|, bound 1 bf16
ulp of max|out|: the kernel may contract a product and its sum into an FMA)
and against ``ship`` (information), then timed with CUDA events over
back-to-back calls and over the replay of a CUDA graph of them. The stages
are ConvNeXt-L's at 769x1345 (VALID stem). ``instruction_mix`` counts the
built kernels' SASS by class (FMAs, bf16 unpacking, loads, moves), what
their times alone cannot show.

Run: python3 -m axial_vs_tpu_torch.tools.exp_dwconv_variants [--iters 30]
     [--stages stage0 stage2] [--variants ship noln ...] [--device cuda]
"""
from __future__ import annotations

import argparse
import re
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import native
from ..ops.convnext_cuda import (dwconv7x7_layernorm, dwconv7x7_layernorm_plain,
                                 dwconv_taps)
from .timing import bf16_ulp, graph_ms, max_diff, require_device, time_ms

STAGES = {
    "stage0": (2, 192, 336, 192),
    "stage1": (2, 96, 168, 384),
    "stage2": (2, 48, 84, 768),
    "stage3": (2, 24, 42, 1536),
}
DEFAULT_STAGES = ("stage0", "stage2")
#: kernel variant -> its index in csrc/dwconv_variants.cu
VARIANTS = {"noln": 0, "tree": 1, "bf16mul": 2, "f32once": 3, "dxpart": 4,
            "acc2": 5, "acc4": 6, "dxonce": 7}
MAX_C = 1536
#: the kernel's grid takes N and H up to this
MAX_NH = 65535
EPS = 1e-6


def _taps(xp, k, h: int, w: int):
    """The 49 (dy, dx) taps' (input slice, weight) pairs in the JAX
    variants' order: dx-major, dy-minor."""
    for dx in range(7):
        for dy in range(7):
            yield xp[:, dy:dy + h, dx:dx + w], k[dy * 7 + dx]


def _tree(products):
    """``_k_tree``'s pairwise tree, as a binary counter: adjacent pairs
    first, the odd one carried to the end of each round."""
    stack = []  # (count, partial sum), counts strictly decreasing
    for p in products:
        count = 1
        while stack and stack[-1][0] == count:
            c, s = stack.pop()
            p, count = s + p, count + c
        stack.append((count, p))
    total = stack.pop()[1]
    while stack:
        total = stack.pop()[1] + total
    return total


def _layer_norm(acc, ln_w, ln_b, eps):
    """``_ln`` of the JAX tool: f32 mean, mean of squared deviations."""
    mean = acc.mean(-1, keepdim=True)
    var = (acc - mean).square().mean(-1, keepdim=True)
    return (acc - mean) * torch.rsqrt(var + eps) * ln_w + ln_b


def dwconv_variant_plain(x, weight, bias, ln_w, ln_b, variant: str,
                         eps: float = EPS, taps=None):
    """Same contract as ``dwconv_variant``: f32 products (bf16 for
    ``bf16mul``) summed in the variant's order, one cast at the end. The
    weights come from ``taps`` (7, 7, C) when given, else from ``weight``."""
    n, h, w, c = x.shape
    k = (weight.reshape(c, 49).T if taps is None
         else taps.reshape(49, c)).float()  # (49, C), tap dy * 7 + dx
    b = bias.float()
    if variant == "bf16mul":
        xp = F.pad(x.to(torch.bfloat16), (0, 0, 3, 3, 3, 3))
        acc = b.expand(n, h, w, c)
        for xs, kk in _taps(xp, k.to(torch.bfloat16), h, w):
            acc = acc + (xs * kk).float()
    else:
        xp = F.pad(x.float(), (0, 0, 3, 3, 3, 3))
        if variant in ("noln", "f32once"):
            acc = b.expand(n, h, w, c)
            for xs, kk in _taps(xp, k, h, w):
                acc = acc + xs * kk
        elif variant == "tree":
            acc = _tree(xs * kk for xs, kk in _taps(xp, k, h, w)) + b
        elif variant in ("dxpart", "dxonce"):
            taps = list(_taps(xp, k, h, w))
            parts = []
            for dx in range(7):
                xs, kk = taps[dx * 7]
                p = xs * kk
                for xs, kk in taps[dx * 7 + 1:dx * 7 + 7]:
                    p = p + xs * kk
                parts.append(p)
            acc = b + (((parts[0] + parts[1]) + (parts[2] + parts[3]))
                       + ((parts[4] + parts[5]) + parts[6]))
        elif variant in ("acc2", "acc4"):
            accs = [None] * int(variant[-1])
            for t, (xs, kk) in enumerate(_taps(xp, k, h, w)):
                i = t % len(accs)
                accs[i] = xs * kk if accs[i] is None else accs[i] + xs * kk
            acc = accs[0]
            for a in accs[1:]:
                acc = acc + a
            acc = acc + b
        else:
            raise ValueError(f"unknown variant {variant!r}")
    if variant != "noln":
        acc = _layer_norm(acc, ln_w.float(), ln_b.float(), eps)
    return acc.to(x.dtype)


def _check_variant_args(x, weight, bias, ln_w, ln_b, variant, taps):
    """The variants' contract, on the CPU as on the card: ValueError for an
    unknown variant, a shape, or what the kernel does not take."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} is not NHWC")
    n, h, _, c = x.shape
    if weight.shape != (c, 1, 7, 7) or any(t.shape != (c,)
                                           for t in (bias, ln_w, ln_b)):
        raise ValueError(f"weight {tuple(weight.shape)} or a vector does not "
                         f"match C={c}")
    if taps is not None and taps.shape != (7, 7, c):
        raise ValueError(f"taps {tuple(taps.shape)} != (7, 7, {c})")
    if c % 8 or not 0 < c <= MAX_C or n > MAX_NH or h > MAX_NH:
        raise ValueError(f"the kernel takes C a multiple of 8 up to {MAX_C} "
                         f"and N, H up to {MAX_NH}, got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous NHWC and 16-byte aligned")


def dwconv_variant(x, weight, bias, ln_w, ln_b, variant: str,
                   eps: float = EPS, taps=None):
    """One of the eight variants of dwconv7x7 + bias (+ LayerNorm) on x (N,
    H, W, C) NHWC; weight (C, 1, 7, 7); bias, ln_w, ln_b (C,). bf16 x and
    weights on the card, C a multiple of 8 up to 1536, N and H up to 65535.
    The kernel takes the weight tap-major: ``taps`` (``dwconv_taps(weight)``)
    or, when None, a copy made here for this call."""
    _check_variant_args(x, weight, bias, ln_w, ln_b, variant, taps)
    n, h, w, c = x.shape
    if native.on_cpu([x, weight, bias, ln_w, ln_b]):
        return dwconv_variant_plain(x, weight, bias, ln_w, ln_b, variant, eps,
                                    taps)
    taps = dwconv_taps(weight) if taps is None else taps
    if x.dtype != torch.bfloat16 or taps.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 x and weights, got "
                        f"{x.dtype} and {taps.dtype}")
    taps = taps.to(x.device).contiguous()
    if taps.data_ptr() % 16:
        raise ValueError("taps must be 16-byte aligned")
    bias, ln_w, ln_b = (t.float().contiguous() for t in (bias, ln_w, ln_b))
    out = torch.empty_like(x)
    native.launch("axvs_dwconv_variant", x.data_ptr(), taps.data_ptr(),
                  bias.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                  out.data_ptr(), n, h, w, c, float(eps), VARIANTS[variant],
                  device=x.device)
    dwconv_variant.launches += 1
    return out


#: kernel launches since the count was last set to 0
dwconv_variant.launches = 0


def run_variant(x, weight, bias, ln_w, ln_b, variant: str, eps: float = EPS,
                taps=None):
    """``ship`` (the port's K1) or one of the eight variants; ``taps``, the
    weight tap-major, as both kernels take it (made for the call when
    None)."""
    if variant == "ship":
        return dwconv7x7_layernorm(x, weight, bias, ln_w, ln_b, eps, taps=taps)
    return dwconv_variant(x, weight, bias, ln_w, ln_b, variant, eps, taps)


def plain_version(variant: str):
    """The plain PyTorch version of ``run_variant(..., variant)``."""
    if variant == "ship":
        return dwconv7x7_layernorm_plain
    return lambda *a, eps=EPS: dwconv_variant_plain(*a, variant, eps)


def build_inputs(rng, shape, device="cpu"):
    """x bf16 (N, H, W, C), weight (C, 1, 7, 7) bf16 from the JAX tool's
    ``randn(7, 7, 1, C) * 0.1``, bias ``randn(C) * 0.1``, LayerNorm ones and
    zeros, in the JAX tool's order of draws."""
    n, h, w, c = shape
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    k = torch.from_numpy((rng.randn(7, 7, 1, c) * 0.1).astype(np.float32))
    b = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32))
    weight = k.permute(3, 2, 0, 1).contiguous()  # HWIO -> (C, 1, 7, 7)
    return (x.to(device=device, dtype=torch.bfloat16),
            weight.to(device=device, dtype=torch.bfloat16), b.to(device),
            torch.ones(c, device=device), torch.zeros(c, device=device))


def flops(shape) -> int:
    """2 * 49 * N * H * W * C, as the JAX tool counts."""
    n, h, w, c = shape
    return 2 * 49 * n * h * w * c


def run(stages=DEFAULT_STAGES, variants=("ship", *VARIANTS), iters: int = 30,
        device="cuda", sizes=None):
    """Check and time each variant at each stage. Returns {stage: {variant:
    {"max_abs_diff": max |out - its plain version|, "bound": 1 bf16 ulp of
    max|plain| (2 for ship, K1's), "diff_vs_ship": max |out - ship| (None for
    noln), "launches": variant-kernel launches of its checking call, and
    when ``iters`` > 0 "ms" (eager calls) and "graph_ms" (a CUDA-graph
    replay; None on the CPU)}}}. ``sizes`` maps a stage to (N, H, W, C), default
    ``STAGES``."""
    device = require_device(device)
    sizes = sizes or STAGES
    unknown = sorted(set(variants) - {"ship", *VARIANTS})
    if unknown:
        raise ValueError(f"unknown variants {unknown}")
    rng = np.random.RandomState(0)
    results = {}
    with torch.inference_mode():
        for stage in stages:
            args = build_inputs(rng, sizes[stage], device)
            taps = dwconv_taps(args[1])  # once a stage, as a block keeps it
            ship = run_variant(*args, "ship", taps=taps)
            results[stage] = {}
            for variant in variants:
                before = dwconv_variant.launches
                out = run_variant(*args, variant, taps=taps)
                launches = dwconv_variant.launches - before
                err, scale = max_diff(out, plain_version(variant)(*args))
                r = {"max_abs_diff": err,
                     "bound": (2 if variant == "ship" else 1) * bf16_ulp(scale),
                     "diff_vs_ship": (None if variant == "noln"
                                      else max_diff(out, ship)[0]),
                     "launches": launches, "flops": flops(sizes[stage])}
                if iters > 0:
                    call = lambda: run_variant(  # noqa: E731
                        *args, variant, taps=taps)
                    r["ms"] = time_ms(call, device, iters)
                    r["graph_ms"] = graph_ms(call, device, iters)
                results[stage][variant] = r
            del args, taps, ship
    return results


#: SASS opcodes counted by ``instruction_mix``, by class; "unpack" is the
#: bf16-to-f32 unpacking (a 16-bit shift, the high-half mask, a byte
#: permute), matched on its operands
_MIX_CLASSES = {"ffma": ("FFMA",), "fmul_fadd": ("FMUL", "FADD"),
                "load": ("LDG", "LDS"), "move": ("MOV", "IMAD.MOV")}
_UNPACK = re.compile(r"\b(?:PRMT|SHF\.L\.U32 \S+ \S+ 0x10,|IMAD\.U32 \S+ \S+ "
                     r"0x10000,|IMAD\.SHL\.U32 \S+ \S+ 0x10000,|LOP3\.LUT .*"
                     r"0xffff0000)")


def instruction_mix(library_path: str):
    """Static census of the SASS that ``cuobjdump -sass`` shows for K1's
    bf16 kernel of 8 channels (``ship``) and the eight variants in the
    built library: {name: {"total", "ffma", "fmul_fadd", "unpack", "load",
    "move"}}, instructions in the code (not executed ones: a loop counts
    once). None when the toolkit has no ``cuobjdump``."""
    tool = Path(native._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    dump = subprocess.run([str(tool), "-sass", library_path], check=True,
                          capture_output=True, text=True).stdout
    names = {f"dwconv_variant_kernelILi{i}E": v for v, i in VARIANTS.items()}
    names["dwconv7x7_ln_kernelI13__nv_bfloat16Li8ELi4E"] = "ship"
    mix, current = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            current = next((v for k, v in names.items() if k in line), None)
            if current is not None:
                mix[current] = dict.fromkeys(("total", *_MIX_CLASSES,
                                              "unpack"), 0)
            continue
        code = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?(\S+)(.*)",
                        line)
        if current is None or code is None:
            continue
        counts, opcode = mix[current], code.group(1)
        counts["total"] += 1
        counts["unpack"] += bool(_UNPACK.search(opcode + code.group(2)))
        for key, ops in _MIX_CLASSES.items():
            counts[key] += any(opcode == o or opcode.startswith(o + ".")
                               for o in ops)
    return mix


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--stages", nargs="*", default=list(DEFAULT_STAGES),
                    choices=list(STAGES))
    ap.add_argument("--variants", nargs="*", default=["ship", *VARIANTS],
                    choices=["ship", *VARIANTS])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    results = run(args.stages, args.variants, args.iters, device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the host CPU (not a card's time)")
    print(f"dwconv variants probe on {where}")
    for stage, by_variant in results.items():
        for variant, r in by_variant.items():
            tag = "OK" if r["max_abs_diff"] <= r["bound"] else "MISMATCH"
            vs_ship = ("--" if r["diff_vs_ship"] is None
                       else f"{r['diff_vs_ship']:.4f}")
            line = (f"{stage} {STAGES[stage]} {variant:8s}: {tag} max |diff| "
                    f"vs plain {r['max_abs_diff']:.6g} (bound {r['bound']:.6g})"
                    f", vs ship {vs_ship}; launches {r['launches']}")
            if "ms" in r:
                best = r["graph_ms"] or r["ms"]
                line += (f"; {r['ms']:.4f} ms"
                         + (f", {r['graph_ms']:.4f} ms in a CUDA graph"
                            if r["graph_ms"] is not None else "")
                         + f" ({r['flops'] / best / 1e9:.2f} TFLOP/s)")
            print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
