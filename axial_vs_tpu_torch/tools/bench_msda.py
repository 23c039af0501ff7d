"""Microbenchmark of the MSDA core op's formulations on one CUDA card.

Counterpart of the JAX package's ``tools/bench_msda.py``. It times the
port's production op, ``ops/msda.py::ms_deform_attn`` (K2: the corner
gathers fused into the weighted reduce), against the formulation the JAX
package runs on the TPU: a packed 2x2 corner table (``_prep``, one K8
launch per level), row gathers from it (``index_select``), then a reduce:

  prod              K2
  sample_loop       12 gathers, then a bf16 accumulate in plain PyTorch
  pallas_v3         12 gathers, then K6 (bf16 products, f32 sums)
  pallas_v4         12 gathers, then K7 with p=1 (the v4 reduce)
  pallas_v5         one merged gather per level, (rows, P*4D), then K7 with
                    p=P
  giant_gather_only one gather of rows*12 rows, then an unweighted sum (the
                    floor of any gather-then-reduce formulation)

Each variant runs once to check it (max |diff| against ``prod``, and its
kernel launches), then ``iters`` times between CUDA events. The default
shape is the WC module's at 769x1345 (levels res5, res4, res3), T=2 frames,
8 heads of 32, 4 points, every token a query. Inputs come from
``numpy.random.RandomState(0)`` as the JAX tool draws them.

``--pack`` times K8 alone instead, per level and per layer, beside its
one-call yardstick ``corner_gather``, eager and from a CUDA graph.

Run: python3 -m axial_vs_tpu_torch.tools.bench_msda [--iters 20]
     [--variant NAME ...] [--pack] [--device cuda]
The CPU runs only when asked for (``--device cpu``); its times are the
host's, not a card's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.msda import level_start_index, ms_deform_attn
from ..ops.msda_reduce import (fold_slots, pack_corner_table,
                               pack_corner_table_plain,
                               weighted_corner_reduce_multi,
                               weighted_corner_reduce_v5)
from .timing import graph_ms, require_device, time_ms

SHAPES = ((24, 42), (48, 84), (96, 168))  # res5, res4, res3 at 769x1345
B, M, D, P = 2, 8, 32, 4


def build_inputs(rng, shapes=SHAPES, b=B, m=M, d=D, p=P, device="cpu"):
    """value (B, S, M, D) bf16, locations (B, Lq, M, L, P, 2) f32 in [0, 1)
    and weights (B, Lq, M, L, P) f32, softmaxed over L*P; Lq = S."""
    s = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.randn(b, s, m, d).astype(np.float32))
    loc = torch.from_numpy(rng.rand(b, s, m, len(shapes), p, 2).astype(np.float32))
    logits = torch.from_numpy(
        rng.randn(b, s, m, len(shapes) * p).astype(np.float32))
    aw = logits.softmax(-1).reshape(b, s, m, len(shapes), p)
    return (value.to(device=device, dtype=torch.bfloat16), loc.to(device),
            aw.to(device))


def variant_prod(value, loc, aw, shapes):
    return ms_deform_attn(value, shapes, level_start_index(shapes), loc,
                          aw.to(value.dtype))


def _slot_weights(c0, t, size: int):
    """True corner weights mapped onto the clipped 2-slot window: a corner
    at -1 moves its neighbour's weight into slot 0."""
    w0 = (1.0 - t) * ((c0 >= 0) & (c0 <= size - 1)).float()
    w1 = t * ((c0 + 1 >= 0) & (c0 + 1 <= size - 1)).float()
    shifted = c0 == -1
    return torch.where(shifted, w1, w0), torch.where(shifted, 0.0, w1)


def _prep(value, loc, aw, shapes):
    """The packed corner table ``flat`` (B*S*M, 4D), its row of every
    sample ``idx`` (B, M, Lq, L*P) int32 and the slot weights ``wgt``
    (B, M, Lq, L*P, 4) in value's dtype, as the JAX tool's ``_prep``."""
    b, s, m, d = value.shape
    v = value.reshape(b, s, m * d)
    starts = level_start_index(shapes)
    flat = torch.cat([pack_corner_table(v[:, st:st + h * w], w, m)
                      for (h, w), st in zip(shapes, starts)], dim=1)
    flat = flat.reshape(b * s * m, 4 * d)

    loc_m = loc.permute(0, 2, 1, 3, 4, 5).float()
    aw_m = aw.permute(0, 2, 1, 3, 4).float()
    dev = value.device
    bm_base = (torch.arange(b, dtype=torch.int32, device=dev)[:, None] * (s * m)
               + torch.arange(m, dtype=torch.int32, device=dev)[None, :])
    idx_parts, wgt_parts = [], []
    for lvl, (h, w) in enumerate(shapes):
        l, a = loc_m[:, :, :, lvl], aw_m[:, :, :, lvl]
        ix = l[..., 0] * w - 0.5
        iy = l[..., 1] * h - 0.5
        x0, y0 = torch.floor(ix), torch.floor(iy)
        tx, ty = ix - x0, iy - y0
        wx0, wx1 = _slot_weights(x0, tx, w)
        wy0, wy1 = _slot_weights(y0, ty, h)
        slot_w = torch.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1],
                             dim=-1) * a[..., None]
        wgt_parts.append(slot_w.to(value.dtype))
        xi = x0.clamp(0, w - 1).to(torch.int32)
        yi = y0.clamp(0, h - 1).to(torch.int32)
        idx_parts.append((starts[lvl] + yi * w + xi) * m
                         + bm_base[:, :, None, None])
    return flat, torch.cat(idx_parts, dim=3), torch.cat(wgt_parts, dim=3)


def _query_major(out, b, m, lq, d):
    """(rows, D) in (b, m, q) order -> (B, Lq, M*D)."""
    return out.reshape(b, m, lq, d).permute(0, 2, 1, 3).reshape(b, lq, m * d)


def table(value, loc, aw, shapes):
    """_prep, with the indices as (rows, N) and the weights as (rows, 4N)."""
    b, _, m, d = value.shape
    lq = loc.shape[1]
    flat, idx, wgt = _prep(value, loc, aw, shapes)
    rows, n = b * m * lq, idx.shape[-1]
    return flat, idx.reshape(rows, n), wgt.reshape(rows, 4 * n)


def sample_gathers(flat, idx):
    """One gather of ``rows`` table rows per sample: N arrays (rows, 4D)."""
    return [flat.index_select(0, idx[:, si]) for si in range(idx.shape[1])]


def level_gathers(flat, idx, n_levels: int, p: int):
    """One gather of ``rows * p`` table rows per level, read as
    (rows, p*4D): sample ``lvl*p + pi`` at lanes ``pi*4D + ...``."""
    rows = idx.shape[0]
    by_level = idx.reshape(rows, n_levels, p)
    return [flat.index_select(0, by_level[:, lvl].reshape(-1)).reshape(
        rows, p * flat.shape[1]) for lvl in range(n_levels)]


def variant_sample_loop(value, loc, aw, shapes):
    b, _, m, d = value.shape
    flat, idx, wgt = table(value, loc, aw, shapes)
    acc = torch.zeros(idx.shape[0], 4 * d, dtype=value.dtype, device=value.device)
    for si in range(idx.shape[1]):
        g = flat.index_select(0, idx[:, si])
        acc = acc + g * wgt[:, 4 * si:4 * si + 4].repeat_interleave(d, dim=1)
    return _query_major(fold_slots(acc, d), b, m, loc.shape[1], d)


def variant_pallas_v3(value, loc, aw, shapes):
    b, _, m, d = value.shape
    flat, idx, wgt = table(value, loc, aw, shapes)
    out = weighted_corner_reduce_multi(sample_gathers(flat, idx), wgt)
    return _query_major(out, b, m, loc.shape[1], d)


def variant_pallas_v4(value, loc, aw, shapes):
    b, _, m, d = value.shape
    flat, idx, wgt = table(value, loc, aw, shapes)
    out = weighted_corner_reduce_v5(sample_gathers(flat, idx), wgt, p=1)
    return _query_major(out, b, m, loc.shape[1], d)


def variant_pallas_v5(value, loc, aw, shapes):
    """One gather of rows*P table rows per level, read as (rows, P*4D)."""
    b, _, m, d = value.shape
    p = loc.shape[4]
    flat, idx, wgt = table(value, loc, aw, shapes)
    out = weighted_corner_reduce_v5(level_gathers(flat, idx, len(shapes), p),
                                    wgt, p=p)
    return _query_major(out, b, m, loc.shape[1], d)


def variant_giant_gather_only(value, loc, aw, shapes):
    """The timing floor: one gather of every sample's row, then an
    unweighted sum (not the op's value)."""
    b, _, m, d = value.shape
    flat, idx, _ = table(value, loc, aw, shapes)
    rows, n = idx.shape
    g = flat.index_select(0, idx.reshape(-1)).reshape(rows, n * 4 * d)
    acc = torch.zeros(rows, 4 * d, dtype=value.dtype, device=value.device)
    for si in range(n):
        acc = acc + g[:, si * 4 * d:(si + 1) * 4 * d]
    return _query_major(fold_slots(acc, d), b, m, loc.shape[1], d)


VARIANTS = {
    "prod": variant_prod,
    "sample_loop": variant_sample_loop,
    "pallas_v3": variant_pallas_v3,
    "pallas_v4": variant_pallas_v4,
    "pallas_v5": variant_pallas_v5,
    "giant_gather_only": variant_giant_gather_only,
}


def counted_kernels():
    """The wrappers whose ``launches`` this bench's variants move."""
    return {"K2": ms_deform_attn, "K6": weighted_corner_reduce_multi,
            "K7": weighted_corner_reduce_v5, "K8": pack_corner_table}


def _launches():
    return {k: fn.launches for k, fn in counted_kernels().items()}


def run(variants=None, iters: int = 20, device="cuda", shapes=SHAPES, b: int = B, m: int = M, d: int = D, p: int = P):
    """Check and time each variant. Returns {name: {"max_abs": max |out|,
    "max_abs_diff": max |out - prod|, "launches": {kernel: launches of its
    checking call},
    "ms": ms per MSDA layer (None when ``iters`` is 0)}}. ``prod`` runs
    first as the reference, also when it is not asked for."""
    device = require_device(device)
    names = list(variants or VARIANTS)
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise ValueError(f"unknown variants {unknown}")
    value, loc, aw = build_inputs(np.random.RandomState(0), shapes, b, m, d,
                                  p, device)
    ref = None
    results = {}
    with torch.inference_mode():
        for name in ["prod"] + [n for n in names if n != "prod"]:
            fn = VARIANTS[name]
            before = _launches()
            out = fn(value, loc, aw, shapes)
            launches = {k: v - before[k] for k, v in _launches().items()}
            if ref is None:
                ref = out.float()
            if name not in names:
                continue
            results[name] = {
                "max_abs": out.float().abs().max().item(),
                "max_abs_diff": (out.float() - ref).abs().max().item(),
                "launches": launches,
                "ms": time_ms(lambda fn=fn: fn(value, loc, aw, shapes),
                               device, iters) if iters > 0 else None}
    return results


def corner_gather(v, width: int, m: int):
    """K8's function as one PyTorch call, a yardstick the port never calls:
    the advanced index ``v4[:, sidx, midx]`` is (B, S, M, 4, D), lanes (m,
    k, d), and its reshape to (B, S, M*4D) a view. Returns the call; its
    index tensors are built here, outside its time."""
    b, s, md = v.shape
    offsets = torch.tensor((0, 1, width, width + 1), device=v.device)
    sidx = (torch.arange(s, device=v.device)[:, None, None] + offsets) % s
    midx = torch.arange(m, device=v.device)[None, :, None]
    v4 = v.reshape(b, s, m, md // m)
    return lambda: v4[:, sidx, midx].reshape(b, s, 4 * md)


def pack_levels(iters: int = 20, device="cuda", shapes=SHAPES, b: int = B,
                m: int = M, d: int = D):
    """K8 and its yardstick ``corner_gather`` on each level's slice of the
    bench's value, as ``_prep`` calls K8. Returns {"HxW": {"equal" and
    "library_equal" (bitwise equal to the roll build), "nbytes" (read once
    and written once), and when ``iters`` > 0 "ms", "graph_ms",
    "library_ms", "library_graph_ms" (eager CUDA events over ``iters``
    calls and a CUDA-graph replay of them; graph times None on the
    CPU)}}, and "layer": the same summed over the levels."""
    device = require_device(device)
    value, _, _ = build_inputs(np.random.RandomState(0), shapes, b, m, d,
                               device=device)
    v = value.reshape(b, value.shape[1], m * d)
    results = {}
    with torch.inference_mode():
        for (h, w), st in zip(shapes, level_start_index(shapes)):
            vl = v[:, st:st + h * w]
            kernel = lambda: pack_corner_table(vl, w, m)  # noqa: E731
            lib = corner_gather(vl, w, m)
            want = pack_corner_table_plain(vl, w, m)
            got = kernel()
            r = {"equal": torch.equal(got, want),
                 "library_equal": torch.equal(lib(), want),
                 "nbytes": (vl.numel() + got.numel()) * vl.element_size()}
            if iters > 0:
                r.update(ms=time_ms(kernel, device, iters),
                         graph_ms=graph_ms(kernel, device, iters),
                         library_ms=time_ms(lib, device, iters),
                         library_graph_ms=graph_ms(lib, device, iters))
            results[f"{h}x{w}"] = r
    layer = {}
    for key, first in next(iter(results.values())).items():
        vals = [r[key] for r in results.values()]
        layer[key] = (all(vals) if isinstance(first, bool)
                      else None if first is None else sum(vals))
    results["layer"] = layer
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variant", action="append", default=None,
                    choices=list(VARIANTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pack", action="store_true",
                    help="time K8 and corner_gather per level instead")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the host CPU (not a card's time)")
    if args.pack:
        print(f"K8 per level on {where}: B={B} M={M} D={D}")
        for level, r in pack_levels(max(args.iters, 1), device).items():
            times = {k: (f"{r[k]:.4f} ms" + ("" if r[g] is None else
                                            f", {r[g]:.4f} in a CUDA graph"))
                     for k, g in (("ms", "graph_ms"),
                                  ("library_ms", "library_graph_ms"))}
            print(f"{level}: bitwise equal to the roll build: {r['equal']} "
                  f"(corner_gather {r['library_equal']}); kernel "
                  f"{times['ms']}; corner_gather {times['library_ms']}; "
                  f"{r['nbytes'] / 1e6:.2f} MB")
        return 0
    results = run(args.variant, args.iters, device)
    print(f"MSDA bench on {where}: levels {SHAPES}, B={B} M={M} D={D} P={P}")
    for name, r in results.items():
        print(f"{name}: max |diff| vs prod = {r['max_abs_diff']:.4f}; "
              f"launches {r['launches']}")
        if r["ms"] is not None:
            print(f"{name}: {r['ms']:.4f} ms/layer")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
