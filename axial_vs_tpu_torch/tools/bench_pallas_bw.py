"""Probe: streaming bandwidth and a column gather on one CUDA card (P4).

Counterpart of the JAX package's ``tools/bench_pallas_bw.py``, which asked
whether a hand-written kernel streams device memory as fast as the
compiler's fusions. Its three Pallas kernels are CUDA kernels here
(``csrc/bandwidth.cu``), each with a plain PyTorch version:

  scale_copy     ``out = 2 * x``, bf16 (rows, 128)            (``pallas_copy``)
  sum_n          12 bf16 (rows, 128) inputs summed in f32 in order, one bf16
                 rounding                                    (``pallas_sum12``)
  column_gather  ``out[i, j] = t[idx[i, j], j]``, int32 indices, f32 or
                 bf16 table, held on chip: slices of 8 columns in CTAs'
                 shared memory, a slice over 128 KB in row ranges
                                                         (``vmem_gather``)

Each is checked against its plain version before it is timed (max |diff|;
all three are exact), then timed with CUDA events over back-to-back calls
and over the replay of a CUDA graph of them (device time without the
host's launch cost, which dominates the gather's small tables), beside the library call that computes the same function: ``x * 2``, the
eager chain of 11 bf16 ``torch.add``s that the JAX tool's ``xla_sum12``
writes (no single call sums 12 arrays in f32), and ``torch.gather``. The
default rows are the WC MSDA's rows at 769x1345 (2 * 21168 * 8 = 338,688),
86.7 MB per array; ``--gather`` sweeps the JAX tool's four tables. Inputs
come from ``numpy.random.RandomState(0)`` as the JAX tool draws them.

Run: python3 -m axial_vs_tpu_torch.tools.bench_pallas_bw [--rows 338688]
     [--iters 20] [--gather] [--device cuda]
The CPU runs only when asked for (``--device cpu``); its times are the
host's, not a card's.
"""
from __future__ import annotations

import argparse
import functools
from typing import Sequence

import numpy as np
import torch

from ..ops import native
from .timing import graph_ms, max_diff, require_device, time_ms

ROWS, LANES = 338688, 128
N_SUM = 12
#: the JAX tool's gather cases: (table rows S, table dtype)
GATHER_CASES = ((4096, torch.float32), (1024, torch.float32),
                (16384, torch.float32), (4096, torch.bfloat16))
MAX_INPUTS = 16  # inputs one sum_n launch takes (the kernel's pointer struct)
#: the gather kernel's table: column slices of GATHER_W columns, a slice in
#: at most GATHER_RANGES row ranges of at most GATHER_CTA_BYTES, one a CTA
GATHER_W, GATHER_RANGES, GATHER_CTA_BYTES = 8, 8, 128 * 1024


def gather_max_rows(dtype) -> int:
    """The most table rows the gather kernel holds: 32768 in f32, 65536 in
    bf16."""
    return GATHER_RANGES * (GATHER_CTA_BYTES // (GATHER_W * dtype.itemsize))


def scale_copy_plain(x):
    return x * 2


def sum_n_plain(xs: Sequence[torch.Tensor]):
    acc = xs[0].float()
    for x in xs[1:]:
        acc = acc + x.float()
    return acc.to(xs[0].dtype)


def column_gather_plain(t, idx):
    return torch.gather(t, 0, idx.long())


def _check_bf16_vectors(tensors):
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16 or t.numel() % 8:
            raise ValueError("inputs must be contiguous, 16-byte aligned and "
                             "a multiple of 8 elements")


def scale_copy(x):
    """2 * x, in x's dtype (bf16 on the card)."""
    if native.on_cpu([x]):
        return scale_copy_plain(x)
    _check_bf16_vectors([x])
    out = torch.empty_like(x)
    native.launch("axvs_scale_copy", x.data_ptr(), out.data_ptr(), x.numel(),
                  device=x.device)
    scale_copy.launches += 1
    return out


def sum_n(xs: Sequence[torch.Tensor]):
    """bf16(sum of the inputs in order, in f32): up to 16 arrays of one
    shape (bf16 on the card)."""
    xs = list(xs)
    if not xs or any(x.shape != xs[0].shape for x in xs):
        raise ValueError(f"{len(xs)} inputs of shapes "
                         f"{sorted({tuple(x.shape) for x in xs})}")
    if native.on_cpu(xs):
        return sum_n_plain(xs)
    if len(xs) > MAX_INPUTS:
        raise ValueError(f"{len(xs)} inputs, the kernel takes at most "
                         f"{MAX_INPUTS}")
    _check_bf16_vectors(xs)
    out = torch.empty_like(xs[0])
    native.launch("axvs_sum_n", native.pointers(xs), len(xs), out.data_ptr(),
                  xs[0].numel(), device=out.device)
    sum_n.launches += 1
    return out


def column_gather(t, idx):
    """t (S, C) f32 or bf16, idx (N, C) int32 -> (N, C):
    ``out[i, j] = t[idx[i, j], j]``; an index outside [0, S) gives 0 on the
    card. Raises ValueError, on the CPU as on the card, on tables the
    kernel does not hold: C not a multiple of 8, S above
    ``gather_max_rows``, or no rows."""
    if t.dim() != 2 or idx.dim() != 2 or idx.shape[1] != t.shape[1]:
        raise ValueError(f"table {tuple(t.shape)}, indices {tuple(idx.shape)}")
    (s, c), n = t.shape, idx.shape[0]
    if c % GATHER_W or not 0 < s <= gather_max_rows(t.dtype) or n < 1:
        raise ValueError(f"the CUDA kernel takes C a multiple of {GATHER_W}, "
                         f"1-{gather_max_rows(t.dtype)} table rows in "
                         f"{t.dtype} and at least one index row; got table "
                         f"{tuple(t.shape)}, indices {tuple(idx.shape)}")
    if native.on_cpu([t, idx]):
        return column_gather_plain(t, idx)
    if t.dtype not in (torch.float32, torch.bfloat16) or idx.dtype != torch.int32:
        raise TypeError(f"the CUDA kernel takes an f32 or bf16 table and int32 "
                        f"indices, got {t.dtype} and {idx.dtype}")
    if not (t.is_contiguous() and idx.is_contiguous()) or (
            t.data_ptr() % 16 or idx.data_ptr() % 16):
        raise ValueError("table and indices must be contiguous and 16-byte "
                         "aligned")
    out = torch.empty(idx.shape, dtype=t.dtype, device=t.device)
    native.launch("axvs_column_gather", t.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), t.shape[0], idx.shape[0], t.shape[1],
                  int(t.dtype == torch.bfloat16), device=t.device)
    column_gather.launches += 1
    return out


#: kernel launches since each count was last set to 0
scale_copy.launches = 0
sum_n.launches = 0
column_gather.launches = 0


def counted_kernels():
    """The wrappers whose ``launches`` this probe moves."""
    return {"P4-copy": scale_copy, "P4-sum12": sum_n,
            "P4-gather": column_gather}


def build_inputs(rng, rows: int = ROWS, device="cpu"):
    """x and 12 more bf16 (rows, 128) arrays, drawn as the JAX tool's main."""
    def draw():
        return torch.from_numpy(rng.randn(rows, LANES).astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)

    x = draw()
    return x, [draw() for _ in range(N_SUM)]


def build_gather_inputs(rng, s: int, dtype, device="cpu"):
    """The table (S, 128) and its int32 indices (S, 128), as
    ``probe_gather`` draws them."""
    t = torch.from_numpy(rng.randn(s, LANES).astype(np.float32)).to(
        device=device, dtype=dtype)
    idx = torch.from_numpy(rng.randint(0, s, (s, LANES)).astype(np.int32))
    return t, idx.to(device)


def _entry(kernel, plain, library, device, iters, nbytes, compare_library):
    """Check the kernel against its plain version (and, if asked, the
    library call), then time all three."""
    before = {k: fn.launches for k, fn in counted_kernels().items()}
    got = kernel()
    launches = {k: fn.launches - before[k] for k, fn in counted_kernels().items()}
    want = plain()
    err, scale = max_diff(got, want)
    r = {"max_abs_diff": err, "max_abs": scale, "launches": launches,
         "nbytes": nbytes,
         "library_diff": max_diff(library(), want)[0] if compare_library else None}
    if iters > 0:
        r["ms"] = time_ms(kernel, device, iters)
        r["plain_ms"] = time_ms(plain, device, iters)
        r["library_ms"] = time_ms(library, device, iters)
        r["graph_ms"] = graph_ms(kernel, device, iters)
        r["library_graph_ms"] = graph_ms(library, device, iters)
    return r


def run(rows: int = ROWS, iters: int = 20, gather: bool = False,
        device="cuda"):
    """Check and time the probe. Without ``gather``: {"copy": ..., "sum12":
    ...}; with it, one entry per table of ``GATHER_CASES``. Each entry holds
    ``max_abs_diff`` against the plain version (0 expected), ``max_abs``,
    ``elems`` (the gather's output elements),
    the kernels' ``launches`` in its checking call, ``nbytes`` (inputs read
    once, output written once) and, when ``iters`` > 0, ``ms``,
    ``plain_ms`` and ``library_ms`` (CUDA events around eager calls) and
    the kernel's and the library call's ``graph_ms`` and
    ``library_graph_ms`` (a CUDA-graph replay: device time without the
    host's launch cost; None on the CPU); ``library_diff`` is the library call's
    max |diff| from the plain version, where it computes the same value."""
    device = require_device(device)
    rng = np.random.RandomState(0)
    results = {}
    with torch.inference_mode():
        if gather:
            for s, dtype in GATHER_CASES:
                t, idx = build_gather_inputs(rng, s, dtype, device)
                idx_long = idx.long()  # the library call's index, built once
                r = _entry(lambda: column_gather(t, idx),
                           lambda: column_gather_plain(t, idx),
                           lambda: torch.gather(t, 0, idx_long), device, iters,
                           t.numel() * t.element_size() * 2 + idx.numel() * 4,
                           True)
                r["elems"] = idx.numel()
                results[f"S={s} {str(dtype).split('.')[-1]}"] = r
            return results
        x, xs = build_inputs(rng, rows, device)
        nb = x.numel() * 2
        results["copy"] = _entry(lambda: scale_copy(x),
                                 lambda: scale_copy_plain(x), lambda: x * 2,
                                 device, iters, 2 * nb, True)
        results["sum12"] = _entry(
            lambda: sum_n(xs), lambda: sum_n_plain(xs),
            lambda: functools.reduce(torch.add, xs), device, iters,
            (N_SUM + 1) * nb, False)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--gather", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    results = run(args.rows, args.iters, args.gather, device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the host CPU (not a card's time)")
    print(f"bandwidth probe on {where}: rows {args.rows} x {LANES} bf16")
    for name, r in results.items():
        line = (f"{name}: max |diff| vs plain {r['max_abs_diff']:.6g}; "
                f"launches {r['launches']}")
        if "ms" in r:
            line += (f"; kernel {r['ms']:.4f} ms "
                     f"({r['nbytes'] / r['ms'] / 1e6:.0f} GB/s), plain "
                     f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms")
            if r["graph_ms"] is not None:
                line += (f"; in a CUDA graph: kernel {r['graph_ms']:.4f} ms, "
                         f"library {r['library_graph_ms']:.4f} ms")
            if "elems" in r:
                best = r["graph_ms"] or r["ms"]
                line += f", {r['elems'] / best / 1e6:.2f} G elems/s"
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
