"""Probe: a weighted gather from one on-chip slab per query, on one CUDA
card (P2).

Counterpart of the JAX package's ``tools/exp_vmem_gather.py``, which asked
whether a Pallas kernel that keeps a (frame, head, level) slab of MSDA's
corner table in VMEM gathers rows faster than XLA's gather from device
memory. It computes, for each query q,

  out[q] = bf16(sum_p slab[idx[q, p]] * w[q, p])

with f32 products and an f32 sum, first point first (slab bf16 (S, 128),
idx int32 (NQ, P), w f32 (NQ, P)). Variants:

  xla              the plain version: P ``index_select``s and f32
                   multiply-adds (no single PyTorch call computes it)
  pl_u1/_u4/_u8    the CUDA kernel ``csrc/slab_gather.cu`` with 1, 4 or 8
                   query rows a 16-thread group, all P x N row loads of a
                   thread in flight; P from 1 to 8

The card's counterpart of the TPU's VMEM-resident slab is L2: a slab is
0.92 MB (``tube_l0``) or 4.13 MB (``kmax_l0``), which the 50 MB L2 holds
for the whole call, and a block's 227 KB of shared memory does not. So the
kernel gathers through L2: it reads ``row_bytes`` (every sampled row) from
there, against ``nbytes`` (the slab once) of the byte bound. Its block and
grid come from ``launch_shape``, so that the grid fills the card in equal
shares. Shapes: ``tube_l0`` is Tube-Link VIS's level 0
at 360x640 per (frame, head), ``kmax_l0`` the WC module's level at
769x1345 (96x168 = 16128 rows, 21168 queries). Each variant is checked
against ``xla`` (max |diff|), then timed with CUDA events over
back-to-back calls and over the replay of a CUDA graph of them (device
time without the host's launch cost, which is most of a call here). Inputs come from ``numpy.random.RandomState(0)`` as
the JAX tool draws them.

Run: python3 -m axial_vs_tpu_torch.tools.exp_vmem_gather [--iters 20]
     [--shapes tube_l0 kmax_l0] [--variants xla pl_u1 pl_u4 pl_u8]
     [--device cuda]
"""
from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from ..ops import native
from .timing import bf16_ulp, graph_ms, max_diff, require_device, time_ms

#: (slab rows S, queries NQ, points P, lanes)
SHAPES = {
    "tube_l0": (3600, 4760, 4, 128),   # 45x80 level 0, all levels' queries
    "kmax_l0": (16128, 21168, 4, 128),  # 96x168 level, 21168 queries
}
VARIANTS = ("xla", "pl_u1", "pl_u4", "pl_u8")
LANES = 128  # the kernel's row: 16 threads of 16 bytes
#: the kernel's limits: points a query (a template parameter); threads a
#: block, powers of two (16 threads a query row); bytes of a block's row
#: slots in shared memory (threads x P x unroll x 16)
MAX_P, ROW_THREADS, MIN_THREADS, MAX_THREADS = 8, 16, 32, 256
ROW_SLOT_BYTES = 32 * 1024
#: blocks an SM that ``launch_shape`` gives the grid where NQ allows
BLOCKS_PER_SM = 4


def slab_gather_plain(idx, w, slab):
    """Same contract as ``slab_gather``: the JAX tool's ``xla`` variant."""
    acc = torch.zeros(idx.shape[0], slab.shape[1], dtype=torch.float32,
                      device=slab.device)
    for p in range(idx.shape[1]):
        g = slab.index_select(0, idx[:, p])
        acc = acc + g.float() * w[:, p:p + 1].float()
    return acc.to(slab.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def launch_shape(nq: int, unroll: int, p: int, sms: int) -> tuple[int, int]:
    """(threads a block, blocks) of the card's kernel. Threads: the most of
    256, 128, 64 and 32 whose row slots (threads x P x ``unroll`` x 16
    bytes) fit in ``ROW_SLOT_BYTES`` and whose grid, at (threads / 16) x
    ``unroll`` queries a block, still has ``BLOCKS_PER_SM`` blocks on each
    of ``sms`` SMs; 32 where NQ has too few rows for that. Blocks: that
    count rounded up to a multiple of ``sms``. The kernel spreads the NQ
    queries evenly over them, so blocks differ by at most one query and an
    all-resident grid gives each SM as many blocks as any other."""
    threads = MAX_THREADS
    while threads > MIN_THREADS and (
            threads * p * unroll * 16 > ROW_SLOT_BYTES
            or -(-nq // (threads // ROW_THREADS * unroll))
            < BLOCKS_PER_SM * sms):
        threads //= 2
    blocks = -(-nq // (threads // ROW_THREADS * unroll))
    return threads, -(-blocks // sms) * sms


def slab_gather(idx, w, slab, unroll: int = 1):
    """idx (NQ, P) int32 rows of slab in [0, S), w (NQ, P) f32, slab (S, 128)
    -> (NQ, 128) in slab's dtype; ``unroll`` (1, 4 or 8) query rows a
    thread group on the card, where an index outside [0, S) reads a zero
    row. P from 1 to ``MAX_P`` and ``unroll`` raise ValueError outside
    their range, on the CPU as on the card."""
    if (idx.dim() != 2 or w.shape != idx.shape or slab.dim() != 2):
        raise ValueError(f"idx {tuple(idx.shape)}, w {tuple(w.shape)}, slab "
                         f"{tuple(slab.shape)}")
    if not 1 <= idx.shape[1] <= MAX_P:
        raise ValueError(f"P = {idx.shape[1]} points a query: the kernel "
                         f"takes 1 to {MAX_P}")
    if unroll not in (1, 4, 8):
        raise ValueError(f"unroll {unroll}: the kernel has 1, 4 and 8")
    if native.on_cpu([idx, w, slab]):
        return slab_gather_plain(idx, w, slab)
    if (slab.dtype != torch.bfloat16 or idx.dtype != torch.int32
            or w.dtype != torch.float32):
        raise TypeError(f"the CUDA kernel takes a bf16 slab, int32 indices and "
                        f"f32 weights, got {slab.dtype}, {idx.dtype}, {w.dtype}")
    if slab.shape[1] != LANES:
        raise ValueError(f"the CUDA kernel takes rows of {LANES} lanes, got "
                         f"{slab.shape[1]}")
    if not all(t.is_contiguous() for t in (idx, w, slab)) or slab.data_ptr() % 16:
        raise ValueError("inputs must be contiguous, the slab 16-byte aligned")
    out = torch.empty(idx.shape[0], LANES, dtype=slab.dtype, device=slab.device)
    sms = _sm_count(slab.device.index)
    native.launch("axvs_slab_gather", slab.data_ptr(), idx.data_ptr(),
                  w.data_ptr(), out.data_ptr(), slab.shape[0], idx.shape[0],
                  idx.shape[1], unroll,
                  *launch_shape(idx.shape[0], unroll, idx.shape[1], sms),
                  device=slab.device)
    slab_gather.launches += 1
    return out


#: kernel launches since the count was last set to 0
slab_gather.launches = 0


def gather(idx, w, slab, variant: str):
    """One variant of the JAX tool's ``run``: ``xla`` or ``pl_u{1,4,8}``."""
    if variant == "xla":
        return slab_gather_plain(idx, w, slab)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    return slab_gather(idx, w, slab, int(variant.split("_u")[1]))


def build_inputs(rng, s: int, nq: int, p: int, lanes: int = LANES,
                 device="cpu"):
    """slab bf16 (S, lanes), idx int32 (NQ, P), w f32 (NQ, P), in the JAX
    tool's order of draws."""
    slab = torch.from_numpy(rng.randn(s, lanes).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, s, (nq, p)).astype(np.int32))
    w = torch.from_numpy(rng.rand(nq, p).astype(np.float32))
    return idx.to(device), w.to(device), slab.to(device=device,
                                                 dtype=torch.bfloat16)


def nbytes(s: int, nq: int, p: int, lanes: int = LANES) -> int:
    """Bytes of one call: slab, indices and weights read once, the output
    written once."""
    return s * lanes * 2 + nq * p * 8 + nq * lanes * 2


def row_bytes(nq: int, p: int, lanes: int = LANES) -> int:
    """Bytes of the slab rows one call reads, every sampled row once: what
    the kernel moves through L2, against ``nbytes``' slab once."""
    return nq * p * lanes * 2


def run(shapes=tuple(SHAPES), variants=VARIANTS, iters: int = 20,
        device="cuda", sizes=None):
    """Check and time each variant at each shape. Returns {shape: {variant:
    {"max_abs_diff": max |out - xla|, "bound": 1 bf16 ulp of max|xla|,
    "launches": kernel launches of its checking call, "nbytes" (the byte
    bound's bytes), "row_bytes" (the rows read through L2), "points" (NQ x
    P rows), and when ``iters`` > 0 "ms" (eager calls) and "graph_ms" (a
    CUDA-graph replay; None on the CPU)}}}. ``sizes`` maps a shape name to
    (S, NQ, P, lanes), default ``SHAPES``."""
    device = require_device(device)
    sizes = sizes or SHAPES
    unknown = sorted(set(variants) - set(VARIANTS))
    if unknown:
        raise ValueError(f"unknown variants {unknown}")
    rng = np.random.RandomState(0)
    results = {}
    with torch.inference_mode():
        for name in shapes:
            s, nq, p, lanes = sizes[name]
            idx, w, slab = build_inputs(rng, s, nq, p, lanes, device)
            ref = slab_gather_plain(idx, w, slab)
            results[name] = {}
            for variant in variants:
                before = slab_gather.launches
                out = gather(idx, w, slab, variant)
                err, scale = max_diff(out, ref)
                r = {"max_abs_diff": err, "bound": bf16_ulp(scale),
                     "launches": slab_gather.launches - before,
                     "nbytes": nbytes(s, nq, p, lanes),
                     "row_bytes": row_bytes(nq, p, lanes), "points": nq * p}
                if iters > 0:
                    call = lambda: gather(idx, w, slab, variant)  # noqa: E731
                    r["ms"] = time_ms(call, device, iters)
                    r["graph_ms"] = graph_ms(call, device, iters)
                results[name][variant] = r
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES),
                    choices=list(SHAPES))
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    results = run(args.shapes, args.variants, args.iters, device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the host CPU (not a card's time)")
    print(f"slab gather probe on {where}")
    for name, by_variant in results.items():
        s, nq, p, _ = SHAPES[name]
        for variant, r in by_variant.items():
            tag = ("OK" if r["max_abs_diff"] <= r["bound"] else "MISMATCH")
            line = (f"{name} (S={s}, NQ={nq}, P={p}) {variant:6s}: {tag} max "
                    f"|diff| vs xla {r['max_abs_diff']:.6g} (bound "
                    f"{r['bound']:.6g}); launches {r['launches']}")
            if "ms" in r:
                line += f"; {r['ms']:.4f} ms"
                if r["graph_ms"] is not None:
                    line += f", {r['graph_ms']:.4f} ms in a CUDA graph"
                best = r["graph_ms"] or r["ms"]
                line += f" ({r['points'] / best / 1e3:.0f}M rows/s)"
            print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
