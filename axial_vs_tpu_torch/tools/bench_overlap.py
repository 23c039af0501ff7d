"""Probe: does an SM overlap CUDA-core work with tensor-core work? (P3)

Counterpart of the JAX package's ``tools/bench_overlap.py``. Four kernels
(``csrc/overlap.cu``) at ConvNeXt-L's stage-2 tile at 769x1345 (TH x W x C
= 8 x 84 x 768, TOKENS = 672), each over 27 tiles that read the same
inputs, spread over the whole card (the TPU ran its 27 grid steps one
after another on one core, the card's counterpart of which is the card):

  vpu         49 dependent f32 steps ``acc = acc + x * 0.01(i+1)`` (the
              dwconv's accumulation chain), bf16 out: a thread a 16-byte
              vector
  mxu         ``bf16(bf16(t @ w1) @ w2)``, (672, 768) @ (768, 3072) @
              (3072, 768) a tile (the block's MLP), on the ``wgmma`` GEMM
              core of K4 and K5 (``csrc/convnext_mlp.cuh``), two phases
              through a workspace
  both        the two on independent inputs in the same launches: a fourth
              warpgroup of each GEMM block runs vpu work while the others
              run ``wgmma`` (warp specialisation)
  interleave  the same, the consumer warpgroups running vpu work between
              issuing a K slice's ``wgmma`` and waiting for it

If t(both) ~ max(t_vpu, t_mxu) the units overlap and a fused ConvNeXt
block can hide its depthwise conv under its MLP; if t(both) ~ t_vpu +
t_mxu they serialise. Every SM that runs both or interleave runs both
kinds of work, so the overlap measured is within an SM. The GEMM core
takes K-major operands, so the mxu kernels take ``mxu_operands``: a
(tiles x tokens, C) copy of t and the transposed weights, made once by the
caller (``run`` makes them outside the timed calls), or by the wrapper on
each call when not given. Each kernel is checked
against its plain version (``vpu_work``, ``mxu_work``: max |diff|; bound 1
bf16 ulp of max|out| for vpu, whose f32 chain the kernel may contract into
FMAs, and 2 for mxu, whose hidden layer is rounded to bf16 after a dot
summed in another order, so a few hidden values round the other way), then
timed with CUDA events over back-to-back calls and over the replay of a
CUDA graph of them. ``mxu``'s library call is
two ``torch.matmul``s over the 27 tiles. Inputs come from
``numpy.random.RandomState(0)`` as the JAX tool draws them.

Run: python3 -m axial_vs_tpu_torch.tools.bench_overlap [--iters 50]
     [--variants vpu mxu both interleave] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import native
from .timing import bf16_ulp, graph_ms, max_diff, require_device, time_ms

TH, W, C = 8, 84, 768  # stage 2 at 769x1345: W = 84, so TOKENS = 672
TOKENS = TH * W
TILES = 27
NC = 4  # interleave's row chunks
VARIANTS = ("vpu", "mxu", "both", "interleave")
#: the chain's 49 multipliers, np.float32(0.01 * (i + 1)) as the JAX tool's
STEP_SCALES = [float(np.float32(0.01 * (i + 1))) for i in range(49)]
#: the GEMM core's limits (``csrc/convnext_mlp.cuh``): C a multiple of 16 up
#: to MXU_MAX_C, the hidden width a multiple of 16
MXU_MAX_C = 1536
#: the vpu kernels index the tiles' 16-byte vectors with 32 bits
MAX_VECTORS = 2 ** 31 - 1


def vpu_work(x):
    """(tokens, C) -> bf16: the 49-step f32 chain of ``_vpu_work``."""
    xf = x.float()
    acc = torch.zeros_like(xf)
    for s in STEP_SCALES:
        acc = acc + xf * s
    return acc.to(x.dtype)


def mxu_work(t, w1, w2):
    """``_mxu_work``: f32 sums of bf16 products, the hidden layer rounded to
    t's dtype, the output too."""
    h = (t.float() @ w1.float()).to(t.dtype)
    return (h.float() @ w2.float()).to(t.dtype)


def _tiled(y, tiles: int):
    return y.unsqueeze(0).expand(tiles, *y.shape)


def overlap_vpu_plain(x, tiles: int = TILES):
    return _tiled(vpu_work(x), tiles)


def overlap_mxu_plain(t, w1, w2, tiles: int = TILES):
    return _tiled(mxu_work(t, w1, w2), tiles)


def overlap_both_plain(x, t, w1, w2, tiles: int = TILES):
    return overlap_vpu_plain(x, tiles), overlap_mxu_plain(t, w1, w2, tiles)


overlap_interleave_plain = overlap_both_plain


def _check_bf16(*tensors):
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("inputs must be contiguous and 16-byte aligned")


def _check_tiles(tokens, c, tiles):
    if tokens < 1 or tiles < 1 or tiles > 65535 or (
            tokens * c % 8 or tokens * tiles * c // 8 > MAX_VECTORS):
        raise ValueError(f"the CUDA kernels take 1-65535 tiles of (tokens, C) "
                         f"with tokens * C a multiple of 8 and at most "
                         f"{MAX_VECTORS} vectors of 8 in all; got tokens="
                         f"{tokens}, C={c}, tiles={tiles}")


def _check_mxu_shapes(t, w1, w2, tiles):
    """(tokens, C, hidden); raises ValueError, on the CPU as on the card, on
    shapes that do not chain or that the GEMM core does not take."""
    tokens, c = t.shape
    hidden = w1.shape[1]
    if w1.shape != (c, hidden) or w2.shape != (hidden, c):
        raise ValueError(f"t {tuple(t.shape)}, w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}")
    if c % 16 or c > MXU_MAX_C or hidden % 16 or hidden < 16:
        raise ValueError(f"the CUDA kernels take C a multiple of 16 up to "
                         f"{MXU_MAX_C} and a hidden width a multiple of 16; "
                         f"got C={c}, hidden={hidden}")
    _check_tiles(tokens, c, tiles)
    return tokens, c, hidden


def mxu_operands(t, w1, w2, tiles: int = TILES):
    """The mxu kernels' operands, K-major for the GEMM core: the (tiles x
    tokens, C) rows of every tile's t, w1 transposed (hidden, C) and w2
    transposed (C, hidden), contiguous copies on t's device."""
    rows = t.unsqueeze(0).expand(tiles, *t.shape).reshape(-1, t.shape[1])
    return rows.contiguous(), w1.t().contiguous(), w2.t().contiguous()


def _card_operands(t, w1, w2, tiles, operands):
    """``operands``, checked against t, w1 and w2, or ``mxu_operands``."""
    if operands is None:
        return mxu_operands(t, w1, w2, tiles)
    tokens, c = t.shape
    want = ((tiles * tokens, c), (w1.shape[1], c), (c, w1.shape[1]))
    if tuple(tuple(o.shape) for o in operands) != want:
        raise ValueError(f"operands {[tuple(o.shape) for o in operands]} != "
                         f"{list(want)}")
    return operands


def overlap_vpu(x, tiles: int = TILES):
    """x (tokens, C) -> (tiles, tokens, C): ``vpu_work`` once per tile."""
    _check_tiles(x.shape[0], x.shape[1], tiles)
    if native.on_cpu([x]):
        return overlap_vpu_plain(x, tiles)
    _check_bf16(x)
    out = torch.empty(tiles, *x.shape, dtype=x.dtype, device=x.device)
    native.launch("axvs_overlap_vpu", x.data_ptr(), out.data_ptr(),
                  x.shape[0], x.shape[1], tiles, device=x.device)
    overlap_vpu.launches += 1
    return out


def overlap_mxu(t, w1, w2, tiles: int = TILES, operands=None):
    """t (tokens, C), w1 (C, hidden), w2 (hidden, C) -> (tiles, tokens, C):
    ``mxu_work`` once per tile. ``operands``: ``mxu_operands(t, w1, w2,
    tiles)``, made by the caller once, or here when None."""
    tokens, c, hidden = _check_mxu_shapes(t, w1, w2, tiles)
    if native.on_cpu([t, w1, w2]):
        return overlap_mxu_plain(t, w1, w2, tiles)
    a, w1t, w2t = _card_operands(t, w1, w2, tiles, operands)
    _check_bf16(a, w1t, w2t)
    h = torch.empty(tiles * tokens, hidden, dtype=t.dtype, device=t.device)
    out = torch.empty(tiles, tokens, c, dtype=t.dtype, device=t.device)
    native.launch("axvs_overlap_mxu", a.data_ptr(), w1t.data_ptr(),
                  w2t.data_ptr(), h.data_ptr(), out.data_ptr(), tiles * tokens,
                  c, hidden, device=t.device)
    overlap_mxu.launches += 1
    return out


def _both(x, t, w1, w2, tiles, operands, interleave: bool):
    tokens, c, hidden = _check_mxu_shapes(t, w1, w2, tiles)
    if x.shape != t.shape:
        raise ValueError(f"x {tuple(x.shape)} != t {tuple(t.shape)}")
    if interleave and tokens % NC:
        raise ValueError(f"{tokens} rows do not split into {NC} chunks")
    if native.on_cpu([x, t, w1, w2]):
        return None
    a, w1t, w2t = _card_operands(t, w1, w2, tiles, operands)
    _check_bf16(x, a, w1t, w2t)
    h = torch.empty(tiles * tokens, hidden, dtype=t.dtype, device=t.device)
    ov = torch.empty(tiles, tokens, c, dtype=x.dtype, device=x.device)
    om = torch.empty_like(ov)
    native.launch("axvs_overlap_both", x.data_ptr(), a.data_ptr(),
                  w1t.data_ptr(), w2t.data_ptr(), h.data_ptr(), ov.data_ptr(),
                  om.data_ptr(), tokens, tiles, c, hidden, int(interleave),
                  device=x.device)
    return ov, om


def overlap_both(x, t, w1, w2, tiles: int = TILES, operands=None):
    """The vpu work on x and the mxu work on t in the same launches, a
    fourth warpgroup on the vpu work -> (vpu out, mxu out), each (tiles,
    tokens, C). ``operands`` as for ``overlap_mxu``."""
    out = _both(x, t, w1, w2, tiles, operands, interleave=False)
    if out is None:
        return overlap_both_plain(x, t, w1, w2, tiles)
    overlap_both.launches += 1
    return out


def overlap_interleave(x, t, w1, w2, tiles: int = TILES, operands=None):
    """The same two results, the GEMM's consumer warpgroups running the
    vpu work between issuing their products and waiting for them."""
    out = _both(x, t, w1, w2, tiles, operands, interleave=True)
    if out is None:
        return overlap_interleave_plain(x, t, w1, w2, tiles)
    overlap_interleave.launches += 1
    return out


#: kernel launches since each count was last set to 0
overlap_vpu.launches = 0
overlap_mxu.launches = 0
overlap_both.launches = 0
overlap_interleave.launches = 0


def counted_kernels():
    """The wrappers whose ``launches`` this probe moves."""
    return {"P3-vpu": overlap_vpu, "P3-mxu": overlap_mxu,
            "P3-both": overlap_both, "P3-interleave": overlap_interleave}


def build_inputs(rng, tokens: int = TOKENS, c: int = C, device="cpu"):
    """x, t (tokens, C), w1 (C, 4C) and w2 (4C, C) * 0.02, bf16, in the JAX
    tool's order of draws."""
    def draw(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(device=device, dtype=torch.bfloat16)

    return (draw(tokens, c), draw(tokens, c), draw(c, 4 * c, scale=0.02),
            draw(4 * c, c, scale=0.02))


def flops(tokens: int = TOKENS, c: int = C, tiles: int = TILES):
    """(bf16 tensor-core flops of mxu, f32 flops of vpu) over the tiles."""
    return (tiles * 2 * 2 * tokens * c * 4 * c, tiles * 2 * 49 * tokens * c)


def run(variants=VARIANTS, iters: int = 50, device="cuda", tokens: int = TOKENS,
        c: int = C, tiles: int = TILES):
    """Check and time each variant. Returns {variant: {"diff": {output: max
    |out - plain|}, "bound": {output: its bound}, "ok", "launches": this
    probe's kernel launches of its checking call, and when ``iters`` > 0
    "ms" (eager calls) and "graph_ms" (a CUDA-graph replay; None on the
    CPU)}}, the outputs being "vpu" and/or "mxu"; plus "summary" {sum, max,
    both, overlap_efficiency} when vpu, mxu and both were timed."""
    device = require_device(device)
    unknown = sorted(set(variants) - set(VARIANTS))
    if unknown:
        raise ValueError(f"unknown variants {unknown}")
    x, t, w1, w2 = build_inputs(np.random.RandomState(0), tokens, c, device)
    ops = mxu_operands(t, w1, w2, tiles) if device.type == "cuda" else None
    calls = {"vpu": lambda: (overlap_vpu(x, tiles),),
             "mxu": lambda: (overlap_mxu(t, w1, w2, tiles, ops),),
             "both": lambda: overlap_both(x, t, w1, w2, tiles, ops),
             "interleave": lambda: overlap_interleave(x, t, w1, w2, tiles,
                                                      ops)}
    results = {}
    with torch.inference_mode():
        want = {"vpu": vpu_work(x), "mxu": mxu_work(t, w1, w2)}
        bounds = {k: (1 if k == "vpu" else 2)
                  * bf16_ulp(v.float().abs().max().item())
                  for k, v in want.items()}
        for name in variants:
            before = {k: fn.launches for k, fn in counted_kernels().items()}
            outs = calls[name]()
            launches = {k: fn.launches - before[k]
                        for k, fn in counted_kernels().items()}
            keys = [name] if name in want else ["vpu", "mxu"]
            diff = {k: max_diff(o, _tiled(want[k], tiles))[0]
                    for k, o in zip(keys, outs)}
            results[name] = {"diff": diff,
                             "bound": {k: bounds[k] for k in keys},
                             "ok": all(diff[k] <= bounds[k] for k in keys),
                             "launches": launches}
            if iters > 0:
                results[name]["ms"] = time_ms(calls[name], device, iters)
                results[name]["graph_ms"] = graph_ms(calls[name], device,
                                                     iters)
            del outs
    if iters > 0 and {"vpu", "mxu", "both"} <= set(results):
        tv, tm, tb = (results[k]["ms"] for k in ("vpu", "mxu", "both"))
        results["summary"] = {"sum": tv + tm, "max": max(tv, tm), "both": tb,
                              "overlap_efficiency": (tv + tm - tb) / min(tv, tm)}
    return results


def library_mxu(t, w1, w2, tiles: int = TILES):
    """The library call for ``mxu``: two ``torch.matmul``s over the tiles
    (bf16 in and out, f32 sums), on a (tiles, tokens, C) copy of t built
    here, outside its time. Returns the call."""
    t_tiles = t.unsqueeze(0).expand(tiles, *t.shape).contiguous()
    return lambda: torch.matmul(torch.matmul(t_tiles, w1), w2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    results = run(args.variants, args.iters, device)
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        where = f"{props.name}, {props.multi_processor_count} SMs"
    else:
        where = "the host CPU (not a card's time)"
    print(f"overlap probe on {where}: {TILES} tiles of ({TOKENS}, {C})")
    summary = results.pop("summary", None)
    for name, r in results.items():
        checks = ", ".join(f"{k} {d:.6g} (bound {r['bound'][k]:.6g})"
                           for k, d in r["diff"].items())
        line = (f"{name}: {'OK' if r['ok'] else 'MISMATCH'} max |diff| vs "
                f"plain: {checks}; launches {r['launches']}")
        if "ms" in r:
            line += f"; {r['ms']:.4f} ms ({TILES} tiles)"
            if r["graph_ms"] is not None:
                line += f", {r['graph_ms']:.4f} ms in a CUDA graph"
        print(line)
    if summary:
        print(f"sum={summary['sum']:.4f}  max={summary['max']:.4f}  "
              f"both={summary['both']:.4f}  "
              f"overlap_efficiency={summary['overlap_efficiency']:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
