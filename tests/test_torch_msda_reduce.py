"""The MSDA bench path of the PyTorch port against the JAX package, on CPU.

- K6 and K7's plain versions (``axial_vs_tpu_torch/ops/msda_reduce.py``)
  against the Pallas kernels of ``axial_vs_tpu/ops/msda_pallas.py`` run in
  interpret mode, with R = 37 rows in blocks of 16 (padding and edge
  blocks), within 1 bf16 ulp of max|out|. Both sum in f32 in the same
  order and round the output once; K6's plain version rounds each product
  to bf16 as the TPU kernel's dtypes say, while XLA's CPU backend keeps
  that product in f32 (interpret-mode K6 equals v4 here), which moves the
  output by less than one of its ulps. So K6's bf16 products are held on
  their own, on inputs where that rounding moves the output by many ulps,
  to an op-by-op jnp composition of ``_multi_kernel``'s dtypes.
- K8's plain version bitwise against ``pack_corner_table_ref`` on every row
  and against the interpret-mode kernel on the rows that do not wrap.
- ``axial_vs_tpu_torch/tools/bench_msda.py`` against ``tools/bench_msda.py``
  at a small shape, on one set of inputs: ``_prep`` (indices and table
  equal, weights within 1 bf16 ulp) and every variant. Bounds, in bf16 ulps
  of max|out|: 1 where both sides reduce in f32 (``pallas_v3``, ``_v4``,
  ``_v5``); 16 where a side accumulates 12 samples in bf16 (``prod``, whose
  JAX side is the bf16 XLA accumulate and whose port side is K2's f32 sum;
  ``sample_loop`` and ``giant_gather_only``, which XLA may keep in f32
  between its bf16 operations).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axial_vs_tpu.ops.msda_pallas import (pack_corner_table,
                                          pack_corner_table_ref,
                                          weighted_corner_reduce_multi,
                                          weighted_corner_reduce_ref,
                                          weighted_corner_reduce_v4,
                                          weighted_corner_reduce_v5)
from axial_vs_tpu_torch.ops import msda_reduce as port
from axial_vs_tpu_torch.tools import bench_msda as port_bench
from test_torch_parity import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
R, N, D, BLOCK = 37, 6, 8, 16
SMALL = dict(shapes=((6, 7), (3, 5), (2, 3)), b=2, m=2, d=8, p=2)


def interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def bf16_ulp(scale):
    return 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)


def assert_ulps(got, want, ulps):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = ulps * bf16_ulp(float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def both(a):
    """One bf16 array for both sides: (jax, torch)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


@pytest.fixture
def rows(rng):
    """N gathered arrays (R, 4D) and sample-major weights (R, 4N), bf16."""
    gs = [both(rng.randn(R, 4 * D)) for _ in range(N)]
    return [g[0] for g in gs], [g[1] for g in gs], both(rng.randn(R, 4 * N))


def test_multi_matches_pallas(rows):
    jg, tg, (jw, tw) = rows
    with interpret():
        want = weighted_corner_reduce_multi(jg, jw, block_rows=BLOCK)
    assert_ulps(port.weighted_corner_reduce_multi_plain(tg, tw), want, 1)


def multi_bf16_products(gs, w):
    """``_multi_kernel``'s dtypes, one jnp op at a time (not jitted, so
    each bf16 product is materialized): products rounded to bf16, f32 sums
    over the samples, then the slot fold."""
    d = gs[0].shape[1] // 4
    acc = jnp.zeros((gs[0].shape[0], 4 * d), jnp.float32)
    for si, g in enumerate(gs):
        w128 = jnp.repeat(w[:, 4 * si:4 * si + 4], d, axis=1)
        acc = acc + (g * w128).astype(jnp.float32)
    return (((acc[:, :d] + acc[:, d:2 * d]) + acc[:, 2 * d:3 * d])
            + acc[:, 3 * d:]).astype(jnp.bfloat16)


def test_multi_rounds_each_product_to_bf16(rng):
    """Samples in cancelling pairs, rows ``a`` and ``-a`` weighted ``c`` and
    ``c - 2^-7`` (``c`` in [1, 2)), leave an output near ``a * 2^-7`` while
    each product rounds at ``a``'s scale: the bf16 product rounding moves
    the output by tens of its ulps. K6's plain version keeps that rounding
    (within 1 ulp of the bf16-product composition) and so is more than 1
    ulp from the f32-product reference."""
    jg, tg, jw, tw = [], [], [], []
    for _ in range(N // 2):
        ja, ta = both(rng.randn(R, 4 * D))
        c = np.asarray(jnp.asarray(1.0 + rng.rand(R, 4), jnp.bfloat16),
                       np.float32)
        jg += [ja, -ja]
        tg += [ta, -ta]
        for wc in (c, c - 2.0 ** -7):  # both exact in bf16
            j, t = both(wc)
            jw.append(j)
            tw.append(t)
    jw, tw = jnp.concatenate(jw, axis=1), torch.cat(tw, dim=1)
    got = port.weighted_corner_reduce_multi_plain(tg, tw)
    assert_ulps(got, multi_bf16_products(jg, jw), 1)
    f32_products = np.asarray(
        weighted_corner_reduce_ref(jnp.stack(jg, axis=1), jw), np.float32)
    bound = bf16_ulp(float(np.abs(f32_products).max()))
    assert float(np.abs(got.float().numpy() - f32_products).max()) > 4 * bound


@pytest.mark.parametrize("slot_major", [False, True])
@pytest.mark.parametrize("p", [1, 2])
def test_v5_matches_pallas(rows, p, slot_major):
    jg, tg, (jw, tw) = rows
    levels = N // p
    jm = [jnp.concatenate(jg[l * p:(l + 1) * p], axis=1) for l in range(levels)]
    tm = [torch.cat(tg[l * p:(l + 1) * p], dim=1) for l in range(levels)]
    with interpret():
        want = weighted_corner_reduce_v5(jm, jw, p, block_rows=BLOCK,
                                         slot_major=slot_major)
    got = port.weighted_corner_reduce_v5_plain(tm, tw, p, slot_major)
    assert_ulps(got, want, 1)


@pytest.mark.parametrize("slot_major", [False, True])
def test_v5_p1_is_v4(rows, slot_major):
    """K7 with p=1 is the v4 reduce (the inference route's, fused into K2)."""
    jg, tg, (jw, tw) = rows
    with interpret():
        want = weighted_corner_reduce_v4(jg, jw, block_rows=BLOCK,
                                         slot_major=slot_major)
    assert_ulps(port.weighted_corner_reduce_v5(tg, tw, 1, slot_major), want, 1)


def test_v5_rounds_f32_weights_to_bf16(rows, rng):
    """K7 takes weights of any float dtype and rounds them to bf16 first,
    as the Pallas wrapper does."""
    jg, tg, _ = rows
    w = rng.randn(R, 4 * N).astype(np.float32)
    with interpret():
        want = weighted_corner_reduce_v5(jg, jnp.asarray(w), 1, block_rows=BLOCK)
    got = port.weighted_corner_reduce_v5_plain(tg, torch.from_numpy(w), 1)
    assert_ulps(got, want, 1)


@pytest.mark.parametrize("h,w,n_heads", [(9, 7, 2), (7, 11, 3),
                                         (1, 7, 2)])  # H = 1: W, W + 1 >= S
def test_pack_corner_table_matches_pallas(rng, h, w, n_heads):
    """Every row equals the roll build; rows that do not wrap equal the
    interpret-mode kernel (S is no multiple of its 16-row blocks; at H = 1
    the offsets W and W + 1 wrap every row)."""
    b, s, md = 2, h * w, n_heads * D
    jv, tv = both(rng.randn(b, s, md))
    got = port.pack_corner_table_plain(tv, w, n_heads).float().numpy()
    want = np.asarray(pack_corner_table_ref(jv, w, n_heads), np.float32)
    np.testing.assert_array_equal(got, want)
    with interpret():
        kern = np.asarray(pack_corner_table(jv, width=w, n_heads=n_heads,
                                            block_rows=BLOCK, interpret=True),
                          np.float32)
    for m in range(n_heads):
        for k, off in enumerate((0, 1, w, w + 1)):
            lanes = slice((m * 4 + k) * D, (m * 4 + k + 1) * D)
            rows = slice(0, max(s - off, 0))  # the rows that do not wrap
            np.testing.assert_array_equal(got[:, rows, lanes],
                                          kern[:, rows, lanes])


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX tool, loaded privately by path, with its module constants
    set to the small shape."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_msda_small", ROOT / "tools" / "bench_msda.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SHAPES = SMALL["shapes"]
    mod.B, mod.M, mod.D, mod.P = (SMALL[k] for k in "bmdp")
    return mod


@pytest.fixture(scope="module")
def inputs():
    """The port's inputs from seed 0, and the same arrays for JAX."""
    tv, tl, ta = port_bench.build_inputs(np.random.RandomState(0), **SMALL)
    jv = jnp.asarray(tv.float().numpy(), jnp.bfloat16)
    return (tv, tl, ta), (jv, jnp.asarray(tl.numpy()), jnp.asarray(ta.numpy()))


def test_build_inputs_match(jax_bench, inputs):
    (tv, tl, ta), _ = inputs
    jv, jl, ja = jax_bench.build_inputs(np.random.RandomState(0))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-7)


def test_prep_matches(jax_bench, inputs):
    (tv, tl, ta), (jv, jl, ja) = inputs
    flat, idx, wgt = port_bench._prep(tv, tl, ta, SMALL["shapes"])
    jflat, jidx, jwgt = jax_bench._prep(jv, jl, ja)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(flat.float().numpy(),
                                  np.asarray(jflat, np.float32))
    assert wgt.dtype == torch.bfloat16
    assert_ulps(wgt, jwgt, 1)


@pytest.mark.parametrize("name,ulps", [
    ("prod", 16), ("sample_loop", 16), ("pallas_v3", 1), ("pallas_v4", 1),
    ("giant_gather_only", 16)])
def test_variant_matches_jax(jax_bench, inputs, name, ulps):
    (tv, tl, ta), (jv, jl, ja) = inputs
    with interpret():
        want = jax.jit(getattr(jax_bench, f"variant_{name}"))(jv, jl, ja)
    got = port_bench.VARIANTS[name](tv, tl, ta, SMALL["shapes"])
    assert got.dtype == torch.bfloat16
    assert_ulps(got, want, ulps)


def test_variant_v5_matches_jax_composition(jax_bench, inputs):
    """The JAX tool has no v5 variant: its ``_prep``, one merged gather per
    level and the Pallas v5 reduce, as ``ops/msda.py``'s record describes."""
    (tv, tl, ta), (jv, jl, ja) = inputs
    b, m, d, p = (SMALL[k] for k in "bmdp")
    levels = len(SMALL["shapes"])
    lq = tl.shape[1]
    rows = b * m * lq

    def composition(value, loc, aw):
        flat, idx, wgt = jax_bench._prep(value, loc, aw)
        by_level = idx.reshape(rows, levels, p)
        gs = [flat.at[by_level[:, lvl].reshape(-1)].get(
            mode="promise_in_bounds").reshape(rows, p * 4 * d)
            for lvl in range(levels)]
        out = weighted_corner_reduce_v5(gs, wgt.reshape(rows, -1), p,
                                        block_rows=BLOCK)
        out = out.reshape(b, m, lq, d).transpose(0, 2, 1, 3)
        return out.reshape(b, lq, m * d)

    with interpret():
        want = jax.jit(composition)(jv, jl, ja)
    got = port_bench.variant_pallas_v5(tv, tl, ta, SMALL["shapes"])
    assert_ulps(got, want, 1)
