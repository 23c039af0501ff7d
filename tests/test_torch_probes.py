"""The probe tools of the PyTorch port (P1-P4) against the JAX tools, on CPU.

Each JAX tool is loaded privately by path; three of them set JAX's
persistent compilation cache when imported, so the loader puts both cache
settings back as they were. The Pallas kernels run in interpret mode
(``pltpu.force_tpu_interpret_mode()``; ``exp_vmem_gather.run`` interprets
by itself off the TPU), on the same numpy inputs as the port's plain
versions. Bounds, in bf16 ulps of the JAX output's max |value|:

- P1 (``tools/exp_dwconv_variants.py``), each of the 8 variants at (1, 11,
  9, 16) with ``tile_h=4`` (a ragged last tile), weights bf16-representable
  as the port's kernel takes them: 1. Both sides sum the same f32 terms in
  the same order and round once; the LayerNorm's mean is summed in another
  order. XLA's CPU keeps ``bf16mul``'s bf16 products in f32 (the
  interpret-mode kernel equals the f32-product order), which moves the
  output by less than an ulp here; so those products are held on their
  own, on inputs where their rounding moves the output by tens of ulps, to
  an op-by-op jnp composition of ``_k_bf16``'s dtypes. ``ship`` is K1, held
  to the Pallas K1 by ``test_torch_parity.py``.
- P2 (``tools/exp_vmem_gather.py``), ``xla`` and ``pl_u{1,4,8}`` at S = 50,
  NQ = 37 (ragged against ``blkq=16``), P = 4: 1, the same f32 products
  summed in the same order.
- P3 (``tools/bench_overlap.py``): the plain versions against ``_vpu_work``
  (1) and ``_mxu_work`` (2: the hidden layer is rounded to bf16 after a dot
  that the two sides may sum in another order, so a hidden value can round
  the other way), then the four kernel bodies in one small interpret-mode
  ``pallas_call`` each, with the module's TH, W, C set to 4, 8, 64 (TOKENS
  = 32, which ``k_interleave`` reads).
- P4 (``tools/bench_pallas_bw.py``) at 64 rows in blocks of 16: the copy and
  the 12-input sum bitwise, the gather bitwise for f32 and bf16 tables.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axial_vs_tpu_torch.tools import bench_overlap as port_overlap
from axial_vs_tpu_torch.tools import bench_pallas_bw as port_bw
from axial_vs_tpu_torch.tools import exp_dwconv_variants as port_dw
from axial_vs_tpu_torch.tools import exp_vmem_gather as port_gather
from test_torch_parity import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs")


def load_tool(name):
    """``tools/<name>.py`` as a private module; JAX's cache settings are put
    back as they were before it ran."""
    saved = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_probe_{name}", ROOT / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def bf16_ulp(scale):
    return 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)


def assert_ulps(got, want, ulps):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= ulps * bf16_ulp(np.abs(want).max()), err


def as_bf16(a):
    """The same bf16 values for both frameworks, from f32 numpy."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


@pytest.fixture(scope="module")
def tools():
    return {name: load_tool(name) for name in (
        "exp_dwconv_variants", "exp_vmem_gather", "bench_overlap",
        "bench_pallas_bw")}


def test_loading_the_tools_keeps_the_cache_settings(tools):
    """Importing the JAX tools by path leaves JAX's persistent-cache
    settings as they were (three of the tools set them at import)."""
    before = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    load_tool("bench_overlap")
    assert {k: getattr(jax.config, k) for k in CACHE_KEYS} == before


@pytest.mark.parametrize("variant", list(port_dw.VARIANTS))
def test_dwconv_variant_matches_jax(tools, variant):
    rng = np.random.RandomState(0)
    n, h, w, c = 1, 11, 9, 16
    jx, tx = as_bf16(rng.randn(n, h, w, c))
    # weights as the port's kernel takes them: bf16 values, JAX's HWIO layout
    k = np.asarray(as_bf16(rng.randn(7, 7, 1, c) * 0.1)[1].float())
    b, ls, lb = (rng.randn(c).astype(np.float32) * 0.1 for _ in range(3))
    ls = ls + 1
    with interpret():
        want = tools["exp_dwconv_variants"].run_variant(
            jx, jnp.asarray(k), jnp.asarray(b), jnp.asarray(ls),
            jnp.asarray(lb), variant, tile_h=4)
    weight = torch.from_numpy(k).permute(3, 2, 0, 1).bfloat16()
    got = port_dw.dwconv_variant(tx, weight, *map(torch.from_numpy, (b, ls, lb)),
                                 variant)
    assert got.dtype == torch.bfloat16
    assert_ulps(got, want, 1)


def test_bf16mul_rounds_each_product_to_bf16(tools):
    """XLA's CPU keeps ``_k_bf16``'s bf16 products in f32, so the
    interpret-mode kernel equals the f32-product order and the test above
    cannot see the rounding. Here the port's ``bf16mul`` is held to an
    op-by-op jnp composition of ``_k_bf16``'s dtypes (each eager op rounds
    to its dtype) on inputs where that rounding moves the output by tens of
    ulps: x near 64, taps whose weights sum to about 0 per channel."""
    jd = tools["exp_dwconv_variants"]
    rng = np.random.RandomState(0)
    n, h, w, c = 1, 11, 9, 16
    jx, tx = as_bf16(64 + 0.5 * rng.randn(n, h, w, c))
    k = rng.randn(7, 7, 1, c) * 0.1
    k = np.asarray(as_bf16(k - k.mean(axis=(0, 1), keepdims=True))[1].float())
    b, ls, lb = (np.zeros(c, np.float32), np.ones(c, np.float32),
                 np.zeros(c, np.float32))
    xp = jnp.pad(jx, ((0, 0), (3, 3), (3, 3), (0, 0)))
    kwb = jnp.asarray(k).reshape(49, c).astype(jnp.bfloat16)
    acc = jnp.broadcast_to(jnp.asarray(b), (n, h, w, c))
    for dx in range(7):
        for dy in range(7):
            prod = xp[:, dy:dy + h, dx:dx + w] * kwb[dy * 7 + dx]
            assert prod.dtype == jnp.bfloat16
            acc = acc + prod.astype(jnp.float32)
    want = jd._ln(acc, jnp.asarray(ls)[None], jnp.asarray(lb)[None], 1e-6)
    args = (tx, torch.from_numpy(k).permute(3, 2, 0, 1).bfloat16(),
            *map(torch.from_numpy, (b, ls, lb)))
    assert_ulps(port_dw.dwconv_variant(*args, "bf16mul"), want, 1)
    f32_products = port_dw.dwconv_variant(*args, "f32once").float().numpy()
    ulp = bf16_ulp(np.abs(np.asarray(want)).max())
    assert np.abs(f32_products - np.asarray(want)).max() > 8 * ulp


def _variant_args(shape, seed=0):
    """bf16 x and weight, f32 bias and norm, on the CPU."""
    rng = np.random.RandomState(seed)
    n, h, w, c = shape
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32)).bfloat16()
    wt = torch.from_numpy((rng.randn(c, 1, 7, 7) * 0.1).astype(np.float32))
    vecs = (torch.from_numpy(rng.randn(c).astype(np.float32)) for _ in range(3))
    return (x, wt.bfloat16(), *vecs)


@pytest.mark.parametrize("variant", ["ship", *port_dw.VARIANTS])
def test_dwconv_variant_takes_the_taps(variant):
    """With the weight tap-major (``taps=dwconv_taps(weight)``, as ``run``
    passes it) a variant equals the call that makes the copy itself."""
    from axial_vs_tpu_torch.ops.convnext_cuda import dwconv_taps

    args = _variant_args((1, 8, 10, 24))
    want = port_dw.run_variant(*args, variant)
    got = port_dw.run_variant(*args, variant, taps=dwconv_taps(args[1]))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["taps", "taps_transposed", "c_not_8",
                                  "c_too_wide", "h_too_tall", "not_nhwc",
                                  "strided", "misaligned", "variant"])
def test_dwconv_variant_refuses_what_the_kernel_cannot_take(case):
    """The kernel's limits hold on the CPU too, as ``ValueError``: taps of
    another shape, C not a multiple of 8 or above 1536, H above 65535, x
    not NHWC, not contiguous or not 16-byte aligned, an unknown variant."""
    from axial_vs_tpu_torch.ops.convnext_cuda import dwconv_taps

    shape = {"c_not_8": (1, 4, 5, 12), "c_too_wide": (1, 2, 3, 1544),
             "h_too_tall": (1, 65536, 1, 8)}.get(case, (1, 4, 5, 16))
    x, wt, b, lw, lb = _variant_args(shape)
    kw, variant = {}, "noln"
    if case == "taps":
        kw["taps"] = dwconv_taps(wt)[:, :6]
    elif case == "taps_transposed":
        kw["taps"] = wt.reshape(shape[3], 7, 7)
    elif case == "not_nhwc":
        x = x[0]
    elif case == "strided":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "misaligned":
        x = torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    elif case == "variant":
        variant = "acc8"
    with pytest.raises(ValueError):
        port_dw.dwconv_variant(x, wt, b, lw, lb, variant, **kw)


SASS = """
\t\tFunction : _ZN12_GLOBAL__N_121dwconv_variant_kernelILi0EEEvPK13__nv_bfloat16
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;  /* 0x00000a00ff017624 */
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;         /* 0x0000000402047981 */
        /*0020*/                   IMAD.U32 R8, R4, 0x10000, RZ ;           /* 0x0001000004087824 */
        /*0030*/                   LOP3.LUT R9, R4, 0xffff0000, RZ, 0xc0, !PT ; /* 0x0 */
        /*0040*/              @!P0 FFMA R10, R8, R12, R10 ;               /* 0x0000000c080a7223 */
        /*0050*/                   FFMA R11, R9, R13, R11 ;                 /* 0x0000000d090b7223 */
        /*0060*/                   EXIT ;                                   /* 0x000000000000794d */
\t\tFunction : _ZN12_GLOBAL__N_121dwconv_variant_kernelILi1EEEvPK13__nv_bfloat16
        /*0000*/                   FMUL R2, R3, R4 ;                        /* 0x0000000403027220 */
        /*0010*/                   FADD R2, R2, R5 ;                        /* 0x0000000502027221 */
\t\tFunction : _ZN12_GLOBAL__N_116overlap_vpu_kernelEv
        /*0000*/                   FFMA R2, R3, R4, R5 ;                    /* 0x0000000403027223 */
"""


def test_instruction_mix_counts_the_sass(monkeypatch):
    """P1's SASS census counts each named kernel's instructions by class
    (a predicated one too) and skips the kernels it does not name."""
    class Done:
        stdout = SASS

    monkeypatch.setattr(port_dw.native, "_nvcc", lambda: __file__)
    monkeypatch.setattr(port_dw.Path, "exists", lambda self: True)
    monkeypatch.setattr(port_dw.subprocess, "run", lambda *a, **k: Done())
    mix = port_dw.instruction_mix("libaxvs_kernels.so")
    assert mix == {
        "noln": {"total": 7, "ffma": 2, "fmul_fadd": 0, "load": 1, "move": 1,
                 "unpack": 2},
        "tree": {"total": 2, "ffma": 0, "fmul_fadd": 2, "load": 0, "move": 0,
                 "unpack": 0}}


@pytest.mark.parametrize("variant", list(port_gather.VARIANTS))
def test_slab_gather_matches_jax(tools, variant):
    s, nq, p = 50, 37, 4
    idx, w, slab = port_gather.build_inputs(np.random.RandomState(0), s, nq, p)
    want = tools["exp_vmem_gather"].run(
        jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(slab.float().numpy(), jnp.bfloat16), variant, s=s, blkq=16)
    got = port_gather.gather(idx, w, slab, variant)
    assert got.dtype == torch.bfloat16
    assert_ulps(got, want, 1)


def test_overlap_plain_versions_match_jax(tools):
    jt = tools["bench_overlap"]
    x, t, w1, w2 = port_overlap.build_inputs(np.random.RandomState(0), 32, 64)
    jv, jtt, jw1, jw2 = (jnp.asarray(a.float().numpy(), jnp.bfloat16)
                         for a in (x, t, w1, w2))
    want_v = jt._vpu_work(jv.astype(jnp.float32)).astype(jnp.bfloat16)
    want_m = jt._mxu_work(jtt, jw1, jw2).astype(jnp.bfloat16)
    assert_ulps(port_overlap.vpu_work(x), want_v, 1)
    assert_ulps(port_overlap.mxu_work(t, w1, w2), want_m, 2)


@pytest.mark.parametrize("variant", list(port_overlap.VARIANTS))
def test_overlap_kernel_bodies_match_jax(tools, variant):
    """Each JAX kernel body in one interpret-mode ``pallas_call`` at
    TOKENS = 32, C = 64, against the port's wrapper (its plain version)."""
    from jax.experimental import pallas as pl

    jt = tools["bench_overlap"]
    jt.TH, jt.W, jt.C = 4, 8, 64
    jt.TOKENS = jt.TH * jt.W
    x, t, w1, w2 = port_overlap.build_inputs(np.random.RandomState(0),
                                             jt.TOKENS, jt.C)
    jx, jtt, jw1, jw2 = (jnp.asarray(a.float().numpy(), jnp.bfloat16)
                         for a in (x, t, w1, w2))
    out = jax.ShapeDtypeStruct((jt.TOKENS, jt.C), jnp.bfloat16)
    body, outs, args = {
        "vpu": (jt.k_vpu, out, (jx,)),
        "mxu": (jt.k_mxu, out, (jtt, jw1, jw2)),
        "both": (jt.k_both, (out, out), (jx, jtt, jw1, jw2)),
        "interleave": (jt.k_interleave, (out, out), (jx, jtt, jw1, jw2)),
    }[variant]
    with interpret():
        want = pl.pallas_call(body, out_shape=outs)(*args)
    got = {"vpu": lambda: (port_overlap.overlap_vpu(x, 1),),
           "mxu": lambda: (port_overlap.overlap_mxu(t, w1, w2, 1),),
           "both": lambda: port_overlap.overlap_both(x, t, w1, w2, 1),
           "interleave": lambda: port_overlap.overlap_interleave(
               x, t, w1, w2, 1)}[variant]()
    want = want if isinstance(want, tuple) else (want,)
    kinds = ["vpu", "mxu"] if len(want) == 2 else [variant]
    for kind, g, wv in zip(kinds, got, want):
        assert g.shape == (1, jt.TOKENS, jt.C)
        assert_ulps(g[0], wv, 1 if kind == "vpu" else 2)


ROWS, BLOCK = 64, 16


def test_scale_copy_matches_jax(tools):
    jx, tx = as_bf16(np.random.RandomState(0).randn(ROWS, 128))
    with interpret():
        want = tools["bench_pallas_bw"].pallas_copy(jx, BLOCK)
    assert_ulps(port_bw.scale_copy(tx), want, 0)


def test_sum12_matches_jax(tools):
    rng = np.random.RandomState(0)
    pairs = [as_bf16(rng.randn(ROWS, 128)) for _ in range(port_bw.N_SUM)]
    with interpret():
        want = tools["bench_pallas_bw"].pallas_sum12(*[j for j, _ in pairs],
                                                     block=BLOCK)
    got = port_bw.sum_n([t for _, t in pairs])
    assert got.dtype == torch.bfloat16
    assert_ulps(got, want, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_column_gather_matches_jax(tools, dtype):
    """The JAX tool's gather with its index types (int16 for a bf16 table,
    Mosaic's rule) against the port's, which takes int32 for both."""
    t, idx = port_bw.build_gather_inputs(np.random.RandomState(0), ROWS,
                                         getattr(torch, dtype))
    jt = jnp.asarray(t.float().numpy(), getattr(jnp, dtype))
    jidx = jnp.asarray(idx.numpy().astype(
        np.int16 if dtype == "bfloat16" else np.int32))
    with interpret():
        want = tools["bench_pallas_bw"].vmem_gather(jt, jidx)
    got = port_bw.column_gather(t, idx)
    assert got.dtype == t.dtype
    assert_ulps(got, want, 0)
