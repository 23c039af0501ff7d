"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided in
the fixture, at run time). On a machine with a card and without JAX, run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: both sides sum in f32 and round to bf16 at the same points, so
they agree to within 2 bf16 ulp of the output's largest magnitude (K3:
``ops/traj.py::TRAJ_ULPS``, derived there). The f32 instantiations of K1,
K2 and K3 agree with their plain versions to ``ops/native.py::
F32_REL_BOUND`` of max|out| (f32 sums in other orders; TF32 is off). For K4 and K5 a bf16 cast of an
intermediate (the normalised tile, the hidden activation) may round the
other way; such an element enters one of C or 4C products and moves the
output far less than one of its ulps. K6 and K7 round at the same points
as their plain versions and sum the same terms in the same order: 1 ulp.
K8 copies: bitwise.
"""
import math

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _ulp(want):
    """One bf16 ulp at the output's largest magnitude."""
    scale = want.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


def _bound(want):
    """2 bf16 ulp of max|out| in bf16; F32_REL_BOUND of it in f32."""
    if want.dtype == torch.float32:
        from axial_vs_tpu_torch.ops.native import F32_REL_BOUND

        return F32_REL_BOUND * want.abs().max().item()
    return 2 * _ulp(want)


@pytest.fixture
def full_f32():
    """f32 products and convolutions in full f32 on the card, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (2, 24, 42, 1536), (1, 37, 53, 200), (1, 3, 5, 2),
    # the other ConvNeXt-L stages at 769x1345
    (2, 192, 336, 192), (2, 96, 168, 384), (2, 48, 84, 768),
    # H < 7 and W not a multiple of the 8-pixel strip at the widest C;
    # C / 8 and C / 4 not whole (narrower vectors), C / V above a warp
    (1, 5, 19, 1536), (1, 6, 9, 12), (1, 2, 3, 6), (1, 9, 70, 1000)])
def test_dwconv7x7_layernorm_kernel(gen, full_f32, shape, dtype):
    """K1 in bf16 and in f32 (the weights in x's dtype) against its plain
    version; another dtype raises."""
    from axial_vs_tpu_torch.ops.convnext_cuda import (
        dwconv7x7_layernorm, dwconv7x7_layernorm_plain)

    n, h, w, c = shape
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    wt = (torch.randn(c, 1, 7, 7, generator=gen, device="cuda") * 0.1).to(dtype)
    b, lw, lb = (torch.randn(c, generator=gen, device="cuda") * 0.1
                 for _ in range(3))
    before = dwconv7x7_layernorm.launches
    got = dwconv7x7_layernorm(x, wt, b, lw + 1, lb)
    assert dwconv7x7_layernorm.launches == before + 1
    want = dwconv7x7_layernorm_plain(x, wt, b, lw + 1, lb)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= _bound(want)
    with pytest.raises(TypeError):
        dwconv7x7_layernorm(x.half(), wt, b, lw, lb)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [10, 50, 200, 1000])
def test_dwconv7x7_layernorm_kernel_partial_warp(gen, full_f32, c, dtype):
    """K1 where a block's strips are not whole warps (blocks of 100, 125 or
    250 threads, padded to whole warps): each of many calls within the bound
    of the plain version, and bitwise equal to the first (each LayerNorm sum
    has one writer and a fixed order)."""
    from axial_vs_tpu_torch.ops.convnext_cuda import (
        dwconv7x7_layernorm, dwconv7x7_layernorm_plain, dwconv_taps)

    shape = (2, 11, 37, c)
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    wt = (torch.randn(c, 1, 7, 7, generator=gen, device="cuda") * 0.1).to(dtype)
    b, lw, lb = (torch.randn(c, generator=gen, device="cuda") * 0.1
                 for _ in range(3))
    taps = dwconv_taps(wt)
    want = dwconv7x7_layernorm_plain(x, wt, b, lw + 1, lb)
    outs = [dwconv7x7_layernorm(x, wt, b, lw + 1, lb, taps=taps)
            for _ in range(50)]
    torch.cuda.synchronize()
    for got in outs:
        assert (got.float() - want.float()).abs().max().item() <= _bound(want)
        assert torch.equal(got, outs[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,shapes", [(32, ((6, 7), (12, 14))),
                                      (40, ((5, 7), (3, 4), (2, 3)))])
def test_ms_deform_attn_kernel(gen, d, shapes, dtype):
    from axial_vs_tpu_torch.ops.msda import (
        level_start_index, ms_deform_attn, ms_deform_attn_plain)

    b, lq, m, p = 2, 29, 4, 3
    s = sum(h * w for h, w in shapes)
    value = torch.randn(b, s, m, d, generator=gen, device="cuda").to(dtype)
    loc = torch.rand(b, lq, m, len(shapes), p, 2, generator=gen,
                     device="cuda") * 1.4 - 0.2
    w = torch.randn(b, lq, m, len(shapes) * p, generator=gen, device="cuda")
    w = w.softmax(-1).reshape(b, lq, m, len(shapes), p).to(dtype)
    starts = level_start_index(shapes)
    before = ms_deform_attn.launches
    got = ms_deform_attn(value, shapes, starts, loc, w)
    assert ms_deform_attn.launches == before + 1
    want = ms_deform_attn_plain(value, shapes, starts, loc, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= _bound(want)
    with pytest.raises(TypeError):  # value and weights in two dtypes
        ms_deform_attn(value, shapes, starts, loc, w.half())
    assert ms_deform_attn.launches == before + 1


WC_LEVELS = ((24, 42), (48, 84), (96, 168))  # res5, res4, res3 at 769x1345


def msda_model_inputs(gen, b, shapes, m, d, p, dtype, jitter=0.5):
    """value, locations and weights as ``MSDeformAttn.sample`` makes them:
    every token of every level a query, its location its own pixel centre
    plus the layer's offset-bias grid (1-4 pixels along each head's
    direction) plus N(0, jitter^2) pixels, weights softmaxed over levels
    and points."""
    from axial_vs_tpu_torch.layers.msda_attention import (
        offset_bias_init, reference_points_for_shapes)

    nl, lq = len(shapes), sum(h * w for h, w in shapes)
    value = torch.randn(b, lq, m, d, generator=gen, device="cuda").to(dtype)
    bias = torch.as_tensor(offset_bias_init(m, nl, p), device="cuda")
    offsets = bias.reshape(1, 1, m, nl, p, 2) + jitter * torch.randn(
        b, lq, m, nl, p, 2, generator=gen, device="cuda")
    ref = reference_points_for_shapes(shapes, device="cuda")
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device="cuda")
    loc = (ref[None, :, None, :, None, :]
           + offsets / norm[None, None, None, :, None, :]).contiguous()
    w = torch.randn(b, lq, m, nl * p, generator=gen, device="cuda")
    w = w.softmax(-1).reshape(b, lq, m, nl, p).to(dtype)
    return value, loc, w


def _msda_check(value, shapes, loc, w):
    """K2 against its plain version; returns the kernel's output."""
    from axial_vs_tpu_torch.ops.msda import (
        level_start_index, ms_deform_attn, ms_deform_attn_plain)

    starts = level_start_index(shapes)
    got = ms_deform_attn(value, shapes, starts, loc, w)
    want = ms_deform_attn_plain(value, shapes, starts, loc, w)
    torch.cuda.synchronize()
    assert got.dtype == value.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= _bound(want)
    return got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ms_deform_attn_kernel_model_inputs(gen, dtype):
    """K2 at the WC shape on the layer's own kind of locations (neighbouring
    queries share corners), on the vector path in the dtype's row order
    (``ROW_ORDER``: bf16 order 0, f32 order 1)."""
    from axial_vs_tpu_torch.ops.msda import vector_path

    value, loc, w = msda_model_inputs(gen, 2, WC_LEVELS, 8, 32, 4, dtype)
    assert vector_path(value, loc, value)
    _msda_check(value, WC_LEVELS, loc, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shapes,p", [(((13, 17),), 1),  # L = 1, P = 1
                                      (((9, 11), (5, 6), (3, 3), (2, 1)), 1),
                                      (((6, 7), (3, 4), (2, 2)), 2)])
def test_ms_deform_attn_kernel_generic(gen, dtype, shapes, p):
    """K2's generic instantiation (L and P other than 3 and 4)."""
    value, loc, w = msda_model_inputs(gen, 2, shapes, 8, 32, p, dtype)
    _msda_check(value, shapes, loc, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,m,aligned", [(37, 3, True),   # scalar path
                                         (8, 4, True),    # one or two lanes a row
                                         (8, 4, False),   # unaligned: scalar
                                         (32, 1, True),   # M = 1
                                         (64, 2, True)])  # 8 (f32: 16) lanes
def test_ms_deform_attn_kernel_paths(gen, dtype, d, m, aligned):
    """K2's vector and scalar paths, at L = 3 and P = 4 (the fixed
    instantiation where the vector path takes the shape)."""
    from axial_vs_tpu_torch.ops.msda import vector_path

    shapes = ((5, 7), (10, 14), (20, 28))
    value, loc, w = msda_model_inputs(gen, 2, shapes, m, d, 4, dtype)
    if not aligned:  # value one element past a 16-byte boundary
        value = torch.cat([value.reshape(-1), value.reshape(-1)[:1]])[1:]
        value = value.reshape(2, -1, m, d)
    assert vector_path(value, loc, value) == (aligned and d % (
        16 // value.element_size()) == 0)
    _msda_check(value, shapes, loc, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ms_deform_attn_kernel_nan_and_far_locations(gen, dtype):
    """Samples at NaN or far outside every level add nothing; the plain
    version, which cannot index at NaN, gets those samples far outside."""
    from axial_vs_tpu_torch.ops.msda import level_start_index, ms_deform_attn

    shapes = ((6, 7), (12, 14), (24, 28))
    value, loc, w = msda_model_inputs(gen, 2, shapes, 8, 32, 4, dtype)
    pick = torch.rand(loc.shape[:-1], generator=gen, device="cuda")
    far = torch.tensor([float("nan"), 1e30, -1e30, float("inf"), 7.5, -3.0],
                       device="cuda")
    kind = (pick * 12).long()  # half the samples bad, in 6 kinds
    bad = kind < 6
    loc = loc.clone()
    loc[..., 0] = torch.where(bad, far[kind.clamp(max=5)], loc[..., 0])
    got = ms_deform_attn(value, shapes, level_start_index(shapes), loc, w)
    want = _msda_check(value, shapes, torch.nan_to_num(loc, nan=-5.0), w)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ms_deform_attn_kernel_repeatable(gen, dtype):
    """50 calls at the WC shape give the bits of the first."""
    from axial_vs_tpu_torch.ops.msda import level_start_index, ms_deform_attn

    value, loc, w = msda_model_inputs(gen, 2, WC_LEVELS, 8, 32, 4, dtype)
    starts = level_start_index(WC_LEVELS)
    outs = [ms_deform_attn(value, WC_LEVELS, starts, loc, w)
            for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs)


def mlp_inputs(gen, c, hidden=None):
    """The ConvNeXt MLP's parameters at unit-variance-preserving scales and
    gamma ~ U(-1, 1) (at the upstream 1e-6 the residual would hide the
    kernel's work): bf16 matrices in torch's (out, in) layout, f32 vectors."""
    hidden = hidden or 4 * c

    def r(*shape, scale):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    w1 = r(hidden, c, scale=c ** -0.5).bfloat16()
    w2 = r(c, hidden, scale=hidden ** -0.5).bfloat16()
    gamma = torch.rand(c, generator=gen, device="cuda") * 2 - 1
    return w1, r(hidden, scale=0.1), w2, r(c, scale=0.1), gamma


#: the four ConvNeXt-L stages of a 2x769x1345 clip, and ragged small shapes
#: (rows and W not multiples of the kernels' 16-row tiles)
CONVNEXT_SHAPES = [(2, 192, 336, 192), (2, 96, 168, 384), (2, 48, 84, 768),
                   (2, 24, 42, 1536), (2, 23, 40, 48), (1, 5, 7, 32),
                   (1, 9, 21, 640)]


@pytest.mark.parametrize("shape", CONVNEXT_SHAPES)
def test_convnext_mlp_residual_kernel(gen, shape):
    from axial_vs_tpu_torch.ops.convnext_cuda import (
        convnext_mlp_residual, convnext_mlp_residual_plain)

    c = shape[-1]
    x, sc = (torch.randn(*shape, generator=gen, device="cuda").bfloat16()
             for _ in range(2))
    params = mlp_inputs(gen, c)
    before = convnext_mlp_residual.launches
    got = convnext_mlp_residual(x, sc, *params)
    assert convnext_mlp_residual.launches == before + 1
    want = convnext_mlp_residual_plain(x, sc, *params)
    torch.cuda.synchronize()
    assert got.shape == shape
    assert (got.float() - want.float()).abs().max().item() <= _bound(want)
    with pytest.raises(TypeError):
        convnext_mlp_residual(x.float(), sc.float(), *params)
    assert convnext_mlp_residual.launches == before + 1


@pytest.mark.parametrize("shape", CONVNEXT_SHAPES)
def test_convnext_block_fused_kernel(gen, shape):
    from axial_vs_tpu_torch.ops.convnext_cuda import (
        convnext_block_fused, convnext_block_fused_plain)

    n, h, w, c = shape
    x = torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    wt = (torch.randn(c, 1, 7, 7, generator=gen, device="cuda") * 0.1).bfloat16()
    b, lw, lb = (torch.randn(c, generator=gen, device="cuda") * 0.1
                 for _ in range(3))
    args = (x, wt, b, lw + 1, lb, *mlp_inputs(gen, c))
    before = convnext_block_fused.launches
    got = convnext_block_fused(*args)
    assert convnext_block_fused.launches == before + 1
    want = convnext_block_fused_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == shape
    assert (got.float() - want.float()).abs().max().item() <= _bound(want)
    with pytest.raises(ValueError):  # C not a multiple of 16
        convnext_block_fused(x[..., :c - 8].contiguous(), wt[:c - 8],
                             *(t[:c - 8] for t in args[2:5]),
                             *mlp_inputs(gen, c - 8))
    assert convnext_block_fused.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (1, 320, 320, 192), (1, 80, 80, 768),  # ConvNeXtV2-L stages 0, 2 at 1281
    (2, 9, 13, 48)])
def test_grn_block_dwln_route(gen, full_f32, monkeypatch, shape, dtype):
    """A ConvNeXtV2 (GRN) block in eval on the ``"dwln"`` route, its GRN
    gamma and beta drawn (zero at init: the identity): K1 launched once a
    call, the output against the same block with K1's plain version in its
    place (2 bf16 ulp or F32_REL_BOUND of max|out|: the rest of the block
    is the same ops on both sides); the ``"mlp"`` (K5) and ``"block"``
    (K4) routes refuse a GRN block."""
    from axial_vs_tpu_torch.models.backbones import convnext
    from axial_vs_tpu_torch.models.kmax import materialize
    from axial_vs_tpu_torch.ops.convnext_cuda import (
        dwconv7x7_layernorm, dwconv7x7_layernorm_plain)

    c = shape[-1]
    block = materialize(
        convnext.ConvNeXtBlock(c, use_grn=True, device=torch.device("meta")),
        torch.device("cuda"), gen,
        torch.bfloat16 if dtype == torch.bfloat16 else None)
    with torch.no_grad():
        block.grn.gamma.normal_(0.0, 0.5, generator=gen)
        block.grn.beta.normal_(0.0, 0.5, generator=gen)
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    before = dwconv7x7_layernorm.launches
    with torch.inference_mode():
        got = block(x)
    assert dwconv7x7_layernorm.launches == before + 1
    monkeypatch.setattr(
        convnext, "dwconv7x7_layernorm",
        lambda *args, eps, taps: dwconv7x7_layernorm_plain(*args, eps=eps))
    with torch.inference_mode():
        want = block(x)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= _bound(want)
    for route in ("mlp", "block"):
        with pytest.raises(NotImplementedError, match="GRN"):
            convnext.ConvNeXtBlock(c, use_grn=True, block_kernel=route,
                                   device=torch.device("meta"))


def traj_inputs(gen, b, f, n, c=256, dtype=torch.bfloat16):
    """q, k, v (b, f*n, c) ~ N(0, 1) and the stage-2 Linear parameters at
    their xavier-uniform / U(+-1/sqrt(c)) scales, matrices in ``dtype``."""
    def u(*shape, bound):
        return (torch.rand(*shape, generator=gen, device="cuda") * 2 - 1) * bound

    q, k, v = (torch.randn(b, f * n, c, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    wq = u(c, c, bound=(6 / (2 * c)) ** 0.5).to(dtype)
    wkv = u(2 * c, c, bound=(6 / (3 * c)) ** 0.5).to(dtype)
    return q, k, v, wq, u(c, bound=c ** -0.5), wkv, u(2 * c, bound=c ** -0.5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,f,n", [(48, 2, 84),   # widest within-clip row
                                   (23, 5, 40),   # widest Tube-Link row
                                   (40, 5, 23),   # ragged: N = 115
                                   (3, 3, 7),     # f = 3, small n
                                   # the other WC and Tube-Link shapes
                                   (84, 2, 48), (42, 2, 24), (24, 2, 42),
                                   (20, 5, 12), (12, 5, 20),
                                   (2, 8, 10),    # f = 8
                                   (1, 2, 84),    # B' = 1, one token tile
                                   (2, 2, 150),   # n > 128: chunked softmax
                                   # at and past the f32 tiles' edges: 64
                                   # queries (stage 1), 128 tokens (stage 2),
                                   # 32-key chunks
                                   (1, 2, 32), (1, 3, 22), (2, 2, 32),
                                   (1, 2, 65),
                                   # the cross-clip module: frames are
                                   # clips, n = 128 queries; and a ragged
                                   # f > 8
                                   (1, 3, 128), (1, 9, 128), (1, 24, 128),
                                   (1, 64, 128), (2, 13, 37),
                                   # the Tube-Link CC layers: 100 queries,
                                   # 3 and 12 clips
                                   (1, 3, 100), (1, 12, 100)])
def test_trajectory_attention_core_kernel(gen, full_f32, b, f, n, dtype):
    """K3 in bf16 (TRAJ_ULPS) and in f32 (F32_REL_BOUND) against its plain
    version; q, k, v of two dtypes raise."""
    from axial_vs_tpu_torch.ops.traj import (
        TRAJ_ULPS, trajectory_attention_core, trajectory_attention_core_plain)

    args = traj_inputs(gen, b, f, n, dtype=dtype)
    before = trajectory_attention_core.launches
    got = trajectory_attention_core(*args, f, 8)
    assert trajectory_attention_core.launches == before + 1
    want = trajectory_attention_core_plain(*args, f, 8)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert err <= (TRAJ_ULPS * _ulp(want) if dtype == torch.bfloat16
                   else _bound(want))
    q, k, v = args[:3]
    with pytest.raises(TypeError):
        trajectory_attention_core(q, k, v.half(), *args[3:], f, 8)
    assert trajectory_attention_core.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h", [4, 3, 1])
def test_trajectory_attention_core_kernel_heads(gen, full_f32, h, dtype):
    """K3 with fewer than 8 heads (an odd count leaves the last head pair of
    the bf16 stage 2 half empty), N = 3 * 19 not a multiple of 64."""
    from axial_vs_tpu_torch.ops.traj import (
        TRAJ_ULPS, trajectory_attention_core, trajectory_attention_core_plain)

    b, f, n = 5, 3, 19
    args = traj_inputs(gen, b, f, n, c=32 * h, dtype=dtype)
    got = trajectory_attention_core(*args, f, h)
    want = trajectory_attention_core_plain(*args, f, h)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert err <= (TRAJ_ULPS * _ulp(want) if dtype == torch.bfloat16
                   else _bound(want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,f,n,c,h", [
    (23, 5, 40, 64, 8), (23, 5, 40, 64, 4),  # d = 8 and 16, Tube-Link rows
    (1, 9, 128, 64, 8), (2, 13, 37, 64, 4),  # many frames, ragged
    (3, 3, 7, 16, 2), (3, 3, 7, 16, 1),      # C = 16: one part group
    (2, 4, 65, 48, 3), (2, 2, 32, 80, 5),    # C not a multiple of 32
    (2, 3, 130, 128, 8)])                    # n > 128, 8 heads of 16
def test_trajectory_attention_core_kernel_narrow_heads(gen, full_f32, b, f,
                                                       n, c, h, dtype):
    """K3 at head widths 8 and 16 (heads of a 32-column group of stage 2
    each with their own temporal softmax; C a multiple of 16, the last
    group part empty where C is not a multiple of 32) against its plain
    version, within the bounds of the 32-wide heads."""
    from axial_vs_tpu_torch.ops.traj import (
        TRAJ_ULPS, trajectory_attention_core, trajectory_attention_core_plain)

    args = traj_inputs(gen, b, f, n, c=c, dtype=dtype)
    before = trajectory_attention_core.launches
    got = trajectory_attention_core(*args, f, h)
    assert trajectory_attention_core.launches == before + 1
    want = trajectory_attention_core_plain(*args, f, h)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert err <= (TRAJ_ULPS * _ulp(want) if dtype == torch.bfloat16
                   else _bound(want))


@pytest.mark.parametrize("c,h", [(64, 16), (128, 2), (24, 3), (40, 5)])
def test_trajectory_attention_core_refuses_other_widths(gen, c, h):
    """Head widths other than 8, 16 and 32 (4 and 64 here), more than 8
    heads, and C not a multiple of 16 raise on the card: no launch."""
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core

    args = traj_inputs(gen, 2, 2, 10, c=c)
    before = trajectory_attention_core.launches
    with pytest.raises(ValueError):
        trajectory_attention_core(*args, 2, h)
    assert trajectory_attention_core.launches == before


def test_trajectory_attention_core_kernel_f32_repeatable(gen, full_f32):
    """50 f32 calls at the widest WC row give the bits of the first (each
    sum has one thread and a fixed order)."""
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core

    args = traj_inputs(gen, 48, 2, 84, dtype=torch.float32)
    outs = [trajectory_attention_core(*args, 2, 8) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_cc_module_launches_k3_over_clips(gen, full_f32):
    """The cross-clip module of 6 layers on a 9-clip video of 128 queries
    (K3 in f32 at f = 9, one launch a layer) against the same module on
    the CPU (K3's plain version), within 1e-3 of max|out| (the bound of
    chip_smoke.py's f32 model references: a LayerNorm of the sum of six
    layers of f32 sums in other orders)."""
    import copy

    from axial_vs_tpu_torch.models.cc_module import CrossClipTrackingModule
    from axial_vs_tpu_torch.models.kmax import materialize
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core

    dev = torch.device("cuda")
    model = materialize(CrossClipTrackingModule(124, device=torch.device("meta")),
                        dev, gen, None)
    clips = 9
    query = torch.randn(1, 128, clips, 256, generator=gen, device=dev)
    pixel = torch.randn(clips, 2 * 12, 20, 128, generator=gen, device=dev)
    before = trajectory_attention_core.launches
    with torch.inference_mode():
        got = model(query, pixel)
    assert trajectory_attention_core.launches == before + 6
    with torch.inference_mode():
        want = copy.deepcopy(model).cpu()(query.cpu(), pixel.cpu())
    for k in ("pred_logits", "pred_masks"):
        err = (got[k].cpu() - want[k]).abs().max().item()
        assert err <= 1e-3 * want[k].abs().max().item(), k


def test_kernels_refuse_grad(gen):
    """K1 and K4-K8 raise on a CUDA input that requires grad while grad
    mode is on (they have no backward), and launch under inference_mode.
    K2 and K3 launch under grad too, through their autograd Functions, and
    return an output with a ``grad_fn``."""
    from axial_vs_tpu_torch.ops import convnext_cuda as cc
    from axial_vs_tpu_torch.ops import msda_reduce as mr
    from axial_vs_tpu_torch.ops.msda import level_start_index, ms_deform_attn
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    c, shapes = 32, ((6, 7), (3, 4))
    dw = (r(c, 1, 7, 7) * 0.1, r(c, dtype=torch.float32),
          r(c, dtype=torch.float32) + 1, r(c, dtype=torch.float32))
    x = r(1, 5, 7, c)
    mlp = mlp_inputs(gen, c)
    loc = torch.rand(1, 9, 4, 2, 3, 2, generator=gen, device="cuda")
    w = r(1, 9, 4, 2, 3).softmax(-1)
    value = r(1, sum(h * wd for h, wd in shapes), 4, 32)
    gs, wr = [r(40, 128) for _ in range(2)], r(40, 8)
    calls = {
        "K1": (cc.dwconv7x7_layernorm, lambda t: (t, *dw)),
        "K5": (cc.convnext_mlp_residual, lambda t: (t, x, *mlp)),
        "K4": (cc.convnext_block_fused, lambda t: (t, *dw, *mlp)),
        "K2": (ms_deform_attn, lambda t: (t, shapes, level_start_index(shapes),
                                          loc, w)),
        "K3": (trajectory_attention_core,
               lambda t: (t, *traj_inputs(gen, 2, 2, 7)[1:], 2, 8)),
        "K6": (mr.weighted_corner_reduce_multi, lambda t: ([t, gs[1]], wr)),
        "K7": (mr.weighted_corner_reduce_v5, lambda t: ([t, gs[1]], wr, 1)),
        "K8": (mr.pack_corner_table, lambda t: (t.reshape(1, 40, 128), 8, 4)),
    }
    inputs = {"K1": x, "K5": x, "K4": x, "K2": value,
              "K3": traj_inputs(gen, 2, 2, 7)[0], "K6": gs[0], "K7": gs[0],
              "K8": gs[0]}
    for key, (fn, args) in calls.items():
        leaf = inputs[key].clone().requires_grad_(True)
        before = fn.launches
        if key in ("K2", "K3"):
            out = fn(*args(leaf))
            torch.cuda.synchronize()
            assert fn.launches == before + 1 and out.grad_fn is not None, key
            before += 1
        else:
            with pytest.raises(RuntimeError, match="no backward"):
                fn(*args(leaf))
            assert fn.launches == before, key
        with torch.inference_mode():
            out = fn(*args(leaf))
        torch.cuda.synchronize()
        assert fn.launches == before + 1 and out.grad_fn is None, key


def _autograd_check(fn, plain, args, seed):
    """``fn`` (an autograd Function on the card) against autograd of its
    plain version at the same inputs: launches once, forward within the
    kernel's bound, each gradient in its input's dtype and within ``_bound``
    of the reference gradient (both sides are the plain version's VJP; the
    gradient scatters' atomic adds may sum in another order). ``args``:
    tensors are leaves that may require grad."""
    def grads(f):
        leaves = [a.detach().clone().requires_grad_(a.requires_grad)
                  if torch.is_tensor(a) else a for a in args]
        out = f(*leaves)
        ct = torch.randn(out.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(seed)).to(out.dtype)
        wanted = [t for t in leaves if torch.is_tensor(t) and t.requires_grad]
        return out, wanted, torch.autograd.grad(out, wanted, ct)

    before = fn.launches
    out, leaves, got = grads(fn)
    assert fn.launches == before + 1
    want_out, _, want = grads(plain)
    torch.cuda.synchronize()
    assert (out.float() - want_out.float()).abs().max().item() <= _bound(
        want_out)
    for leaf, g, w in zip(leaves, got, want):
        assert g.dtype == leaf.dtype == w.dtype
        assert (g.float() - w.float()).abs().max().item() <= _bound(w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ms_deform_attn_autograd(gen, full_f32, dtype):
    """K2's autograd Function at the WC shape on model-like inputs: the
    gradients of value, locations (f32) and weights against autograd of
    the plain version."""
    from axial_vs_tpu_torch.ops.msda import (
        level_start_index, ms_deform_attn, ms_deform_attn_plain)

    value, loc, w = msda_model_inputs(gen, 2, WC_LEVELS, 8, 32, 4, dtype)
    starts = level_start_index(WC_LEVELS)
    args = [value.requires_grad_(), WC_LEVELS, starts, loc.requires_grad_(),
            w.requires_grad_()]
    _autograd_check(ms_deform_attn, ms_deform_attn_plain, args, 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_trajectory_attention_core_autograd(gen, full_f32, dtype):
    """K3's autograd Function at the widest WC row: the gradients of q, k,
    v and the stage-2 weights against autograd of the plain version, each
    in its own dtype (in bf16 the matrices are bf16 and the biases f32
    master weights)."""
    from axial_vs_tpu_torch.ops.traj import (trajectory_attention_core,
                                             trajectory_attention_core_plain)

    args = [t.requires_grad_() for t in traj_inputs(gen, 48, 2, 84,
                                                     dtype=dtype)]
    assert args[4].dtype == args[6].dtype == torch.float32
    _autograd_check(trajectory_attention_core, trajectory_attention_core_plain,
                    [*args, 2, 8], 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h", [8, 4])
def test_trajectory_attention_core_autograd_narrow_heads(gen, full_f32, h,
                                                         dtype):
    """K3's autograd Function at 64 channels in 8 heads of 8 (the WC
    overfit tool's module) and 4 of 16, at a Tube-Link row: the gradients
    of q, k, v and the stage-2 weights against autograd of the plain
    version."""
    from axial_vs_tpu_torch.ops.traj import (trajectory_attention_core,
                                             trajectory_attention_core_plain)

    args = [t.requires_grad_() for t in traj_inputs(gen, 23, 5, 40, c=64,
                                                     dtype=dtype)]
    _autograd_check(trajectory_attention_core, trajectory_attention_core_plain,
                    [*args, 5, h], 4)


@pytest.mark.parametrize("b,f,n", [(1, 4, 128), (1, 9, 128)])
def test_trajectory_attention_core_autograd_cc(gen, full_f32, b, f, n):
    """K3's autograd Function at the cross-clip (CC) module's f32 shapes:
    one video's 128 queries over 4 clips (the CC training step's 8-frame
    video) and over 9; the gradients of q, k, v and the stage-2 weights
    against autograd of the plain version."""
    from axial_vs_tpu_torch.ops.traj import (trajectory_attention_core,
                                             trajectory_attention_core_plain)

    args = [t.requires_grad_() for t in traj_inputs(gen, b, f, n,
                                                     dtype=torch.float32)]
    _autograd_check(trajectory_attention_core, trajectory_attention_core_plain,
                    [*args, f, 8], 3)


def test_cc_train_step_on_card(gen, full_f32):
    """One ``train_step`` of a narrow CC model (R18 segmenter in f32 with
    its WC module at 256 channels and 8 heads, which K3 needs; 2 CC layers)
    on one 8-frame video on the card: finite losses, the CC module's K3
    launched once a layer at f = 4 beside the segmenter's launches, finite
    CC gradients, the segmenter bitwise unchanged and the CC module
    moved."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.engine.lr_schedule import tf2_warmup_poly_lr
    from axial_vs_tpu_torch.engine.optim import build_optimizer
    from axial_vs_tpu_torch.engine.train_step import train_step
    from axial_vs_tpu_torch.models.build import build_model_and_criterion
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core

    cfg = load_config("vipseg/maxtron_cc_r50.yaml", [
        "model.backbone.name", "resnet18", "model.backbone.resnet.depth", 18,
        "model.num_classes", 7, "input.image_size", [64, 64],
        "model.maxtron.wc.dim_feedforward", 96,
        "model.kmax.pixel_dec.dec_layers", [1, 1, 1, 1],
        "model.kmax.pixel_dec.dec_channels", [32, 16, 16, 16],
        "model.kmax.trans_dec.dec_layers", [1, 1, 1],
        "model.kmax.trans_dec.num_object_queries", 16,
        "model.maxtron.cc.num_layers", 2, "solver.ims_per_batch", 1])
    dev = torch.device("cuda")
    model, crit = build_model_and_criterion(cfg, train=True, device=dev,
                                            generator=gen)
    opt, sched = build_optimizer(cfg, model, tf2_warmup_poly_lr(1e-3, 10, 0))
    frames = torch.randn(8, 64, 64, 3, generator=gen, device=dev)
    before = trajectory_attention_core.launches
    with torch.no_grad():
        model.segmenter(frames[:2])
    per_clip = trajectory_attention_core.launches - before
    seg0 = {k: v.clone() for k, v in model.segmenter.state_dict().items()}
    cc0 = {k: v.clone() for k, v in model.cc_module.state_dict().items()}
    masks = torch.rand(1, 3, 8, 16, 16, generator=gen, device=dev) > 0.7
    batch = {"images": frames, "targets": {
        "labels": torch.tensor([[0, 3, 5]], device=dev),
        "masks": masks.float(),
        "valid": torch.ones(1, 3, dtype=torch.bool, device=dev)}}
    before = trajectory_attention_core.launches
    losses = train_step(model, crit, opt, sched, batch,
                        torch.Generator(device=dev).manual_seed(1))
    assert all(math.isfinite(v) for v in losses.values())
    assert trajectory_attention_core.launches - before == 4 * per_clip + 2
    for n, p in model.cc_module.named_parameters():
        assert torch.isfinite(p.grad).all(), n
    for k, v in model.segmenter.state_dict().items():
        assert torch.equal(v, seg0[k]), k
    assert any(not torch.equal(v, cc0[k])
               for k, v in model.cc_module.state_dict().items())


def test_train_step_on_card(gen, full_f32):
    """One ``train_step`` of a narrow WC training model (R18, 64x64 frames,
    T = 2, the WC module at its 256 channels and 8 heads, which K3 needs)
    on the card: finite losses and gradients, K2 and K3 launched once per
    call of their layers, non-zero gradients of the MSDA and trajectory
    projections."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.engine.train_step import train_step
    from axial_vs_tpu_torch.ops.msda import ms_deform_attn
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core
    from axial_vs_tpu_torch.tools import bench_train

    cfg = load_config("vipseg/maxtron_wc_r50.yaml", [
        "model.backbone.name", "resnet18", "model.backbone.resnet.depth", 18,
        "model.num_classes", 7, "input.image_size", [64, 64],
        "model.maxtron.wc.dim_feedforward", 96,
        "model.kmax.pixel_dec.dec_layers", [1, 1, 1, 1],
        "model.kmax.pixel_dec.dec_channels", [32, 16, 16, 16],
        "model.kmax.trans_dec.dec_layers", [1, 1, 1],
        "model.kmax.trans_dec.num_object_queries", 16])
    dev = torch.device("cuda")
    parts = bench_train.build(cfg, dev)
    batch = bench_train.synthetic_batch(7, (64, 64), dev)
    k2, k3 = ms_deform_attn.launches, trajectory_attention_core.launches
    losses = train_step(*parts, batch, torch.Generator(device=dev).manual_seed(1))
    assert all(math.isfinite(v) for v in losses.values()) and len(losses) == 18
    # 2 stages: 1 MSDA layer, 2 temporal layers x 2 axes x 2 levels each
    assert ms_deform_attn.launches - k2 == 2
    assert trajectory_attention_core.launches - k3 == 16
    for n, p in parts[0].named_parameters():
        assert torch.isfinite(p.grad).all(), n
        if n.endswith(("value_proj.weight", "sampling_offsets.weight",
                       "attn.q.weight", "attn.proj_kv.weight")):
            assert p.grad.abs().max() > 0, n


@pytest.mark.parametrize("yaml", ["vipseg/tube_link_vps_r50.yaml",
                                  "ytvis21/tube_link_maxtron_cc_r50.yaml",
                                  "image/mask2former_r50_coco_panoptic_50e.yaml"])
def test_inference_only_tube_link_models_on_card(gen, full_f32, yaml):
    """The VPS, cross-clip VIS and image models (R18, 8 thing queries, the
    head at its widths) built by the registry on the card, its default
    device: K2 (and K3 with temporal attention) launched, every output
    within 1e-3 of max |CPU| of a CPU copy's on 64x64 frames; the VPS
    stream's two windows with ids equal on 0.999 of the pixels."""
    import copy

    import numpy as np

    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.models.build import build_model_and_criterion
    from axial_vs_tpu_torch.models.tube_link.vps import (TubeLinkVPSInference,
                                                         num_things_split)
    from axial_vs_tpu_torch.ops.msda import ms_deform_attn
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core

    cfg = load_config(yaml, [
        "model.backbone.name", "resnet18", "model.backbone.resnet.depth", 18,
        "model.tube_link.num_queries", 8, "input.num_clip_frames", 2])
    model, _ = build_model_and_criterion(cfg, train=False, generator=gen)
    assert next(model.parameters()).device.type == "cuda"
    cpu = copy.deepcopy(model).cpu()
    frames = 1 if "image" in yaml else 4
    x = torch.randn(frames, 64, 64, 3, generator=gen, device="cuda")
    k2, k3 = ms_deform_attn.launches, trajectory_attention_core.launches
    if "vps" in yaml:
        things, stuff = num_things_split(cfg)
        kw = dict(clip_len=2, num_things_classes=things,
                  num_stuff_classes=stuff, object_mask_thr=0.0, iou_thr=0.0,
                  tracker_kwargs=dict(init_score_thr=0.0, obj_score_thr=0.0))
        maps = {}
        for side, m, xs in (("card", model, x), ("cpu", cpu, x.cpu())):
            pipe = TubeLinkVPSInference(m, **kw)
            pipe.init_memory()
            maps[side] = np.stack([pipe.process_window(xs[:2], 0),
                                   pipe.process_window(xs[2:], 1)])
        assert (maps["card"] == maps["cpu"]).mean() >= 0.999
        # two windows: 6 MSDA layers, 6 x 2 levels x 2 axes trajectory calls
        assert ms_deform_attn.launches - k2 == 2 * 6
        assert trajectory_attention_core.launches - k3 == 2 * 24
        return
    with torch.inference_mode():
        got, want = model(x), cpu(x.cpu())
    assert ms_deform_attn.launches - k2 == 6 * (2 if "cc" in yaml else 1)
    assert (trajectory_attention_core.launches - k3 > 0) == ("cc" in yaml)
    for key in ("cls_preds", "mask_preds"):
        for g, w in zip(got[key], want[key]):
            assert torch.isfinite(g).all(), key
            assert (g.cpu() - w).abs().max() <= 1e-3 * w.abs().max(), key


#: (R, N, P, D) of the MSDA reduces: the WC bench shape (R = 2*8*21168
#: rows, 3 levels of 4 points) and a ragged one (R no multiple of 32, 2
#: levels of 3 points, D = 40)
REDUCE_SHAPES = [(338688, 12, 4, 32), (1001, 6, 3, 40)]


def _rows(gen, r, lanes, count):
    return [torch.randn(r, lanes, generator=gen, device="cuda").bfloat16()
            for _ in range(count)]


@pytest.mark.parametrize("r,n,p,d", REDUCE_SHAPES)
def test_weighted_corner_reduce_multi_kernel(gen, r, n, p, d):
    """K6 against its plain version: the same bf16 products summed in f32
    in the same order, so at most 1 bf16 ulp of max|out| apart."""
    from axial_vs_tpu_torch.ops.msda_reduce import (
        weighted_corner_reduce_multi, weighted_corner_reduce_multi_plain)

    gs = _rows(gen, r, 4 * d, n)
    w = _rows(gen, r, 4 * n, 1)[0]
    before = weighted_corner_reduce_multi.launches
    got = weighted_corner_reduce_multi(gs, w)
    assert weighted_corner_reduce_multi.launches == before + 1
    want = weighted_corner_reduce_multi_plain(gs, w)
    torch.cuda.synchronize()
    assert got.shape == (r, d)
    assert (got.float() - want.float()).abs().max().item() <= _ulp(want)
    with pytest.raises(TypeError):
        weighted_corner_reduce_multi([g.float() for g in gs], w)
    assert weighted_corner_reduce_multi.launches == before + 1


@pytest.mark.parametrize("slot_major", [False, True])
@pytest.mark.parametrize("r,n,p,d", REDUCE_SHAPES)
def test_weighted_corner_reduce_v5_kernel(gen, r, n, p, d, slot_major):
    """K7 with one sample per array (the v4 reduce) and with p merged
    samples per level, against its plain version (1 bf16 ulp)."""
    from axial_vs_tpu_torch.ops.msda_reduce import (
        weighted_corner_reduce_v5, weighted_corner_reduce_v5_plain)

    w = torch.randn(r, 4 * n, generator=gen, device="cuda")  # cast inside
    for pp in (1, p):
        gs = _rows(gen, r, pp * 4 * d, n // pp)
        before = weighted_corner_reduce_v5.launches
        got = weighted_corner_reduce_v5(gs, w, pp, slot_major)
        assert weighted_corner_reduce_v5.launches == before + 1
        want = weighted_corner_reduce_v5_plain(gs, w, pp, slot_major)
        torch.cuda.synchronize()
        assert got.shape == (r, d)
        assert (got.float() - want.float()).abs().max().item() <= _ulp(want)


@pytest.mark.parametrize("levels,m,d", [
    (((24, 42), (48, 84), (96, 168)), 8, 32),  # the WC levels
    (((5, 517), (3, 4)), 3, 40),               # W + 1 wider than a block
    # H = 1 (the offsets W and W + 1 reach past S: taken mod S); a level of
    # one pixel, whose runs wrap at S on every row; S = 1961, no multiple of
    # the 4-row tiles two batch rows of it get
    (((1, 7), (1, 1), (37, 53)), 8, 32),
    # rows of 1024 and of 2048 16-byte vectors (a thread walks 2 of them)
    (((6, 7), (2, 3)), 4, 512), (((4, 5), (1, 3)), 16, 256)])
def test_pack_corner_table_kernel(gen, levels, m, d):
    """K8 on each level's slice of the whole value (batch rows apart) and
    on a contiguous copy, bitwise equal to the roll build; the last level
    50 times, each call bitwise equal to the first."""
    from axial_vs_tpu_torch.ops.msda_reduce import (pack_corner_table,
                                                    pack_corner_table_plain)

    s = sum(h * w for h, w in levels)
    value = torch.randn(2, s, m * d, generator=gen, device="cuda").bfloat16()
    start = 0
    for h, w in levels:
        v = value[:, start:start + h * w]
        start += h * w
        want = pack_corner_table_plain(v, w, m)
        for x in (v, v.contiguous()):
            before = pack_corner_table.launches
            got = pack_corner_table(x, w, m)
            assert pack_corner_table.launches == before + 1
            torch.cuda.synchronize()
            assert torch.equal(got, want), (h, w)
    outs = [pack_corner_table(v, w, m) for _ in range(50)]
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(got, outs[0]) and torch.equal(got, want)
    with pytest.raises(TypeError):
        pack_corner_table(value.float(), levels[0][1], m)


# The probes P1-P4 (axial_vs_tpu_torch/tools/): each kernel against its plain
# version on the same inputs. The copy, the 12-input sum, the column gather
# and the slab gather round where their plain versions round and sum in the
# same order: equal, held to 0 (the slab gather to 1 bf16 ulp, its bound in
# the tool). The dwconv variants and the vpu chain may contract a product and
# its sum into an FMA: 1 bf16 ulp of max|out|. The mxu work rounds its hidden
# layer to bf16 after a dot summed in another order: 2 ulp.


@pytest.mark.parametrize("rows", [338688, 1001])
def test_probe_bandwidth_kernels(gen, rows):
    from axial_vs_tpu_torch.tools.bench_pallas_bw import (
        scale_copy, scale_copy_plain, sum_n, sum_n_plain)

    xs = [torch.randn(rows, 128, generator=gen, device="cuda").bfloat16()
          for _ in range(12)]
    before = (scale_copy.launches, sum_n.launches)
    assert torch.equal(scale_copy(xs[0]), scale_copy_plain(xs[0]))
    for n in (12, 3):
        assert torch.equal(sum_n(xs[:n]), sum_n_plain(xs[:n]))
    assert (scale_copy.launches, sum_n.launches) == (before[0] + 1,
                                                     before[1] + 2)
    with pytest.raises(TypeError):
        sum_n([x.float() for x in xs[:2]])


@pytest.mark.parametrize("s,dtype", [(4096, torch.float32),
                                     (16384, torch.float32),
                                     (4096, torch.bfloat16),
                                     (37, torch.bfloat16),
                                     # the fourth of the JAX tool's tables;
                                     # the largest tables the kernel holds
                                     (1024, torch.float32),
                                     (32768, torch.float32),
                                     (65536, torch.bfloat16)])
def test_probe_column_gather_kernel(gen, s, dtype):
    from axial_vs_tpu_torch.tools.bench_pallas_bw import (column_gather,
                                                          column_gather_plain)

    t = torch.randn(s, 128, generator=gen, device="cuda").to(dtype)
    idx = torch.randint(0, s, (s + 5, 128), generator=gen, device="cuda",
                        dtype=torch.int32)
    before = column_gather.launches
    assert torch.equal(column_gather(t, idx), column_gather_plain(t, idx))
    assert column_gather.launches == before + 1


@pytest.mark.parametrize("s,n,c,dtype", [(4096, 4096, 128, torch.float32),
                                         (1024, 1024, 128, torch.float32),
                                         (16384, 16384, 128, torch.float32),
                                         (4096, 4096, 128, torch.bfloat16),
                                         (37, 3, 16, torch.float32)])
def test_probe_column_gather_out_of_range(gen, s, n, c, dtype):
    """Indices outside [0, S) give 0; the rest equal the plain gather."""
    from axial_vs_tpu_torch.tools.bench_pallas_bw import (column_gather,
                                                          column_gather_plain)

    t = torch.randn(s, c, generator=gen, device="cuda").to(dtype)
    idx = torch.randint(-s, 2 * s, (n, c), generator=gen, device="cuda",
                        dtype=torch.int32)
    idx[0, 0], idx[-1, -1] = -2 ** 31, 2 ** 31 - 1
    inside = (idx >= 0) & (idx < s)
    want = torch.where(inside, column_gather_plain(t, idx.clamp(0, s - 1)),
                       torch.zeros((), dtype=dtype, device="cuda"))
    assert torch.equal(column_gather(t, idx), want)


@pytest.mark.parametrize("s,c,dtype", [(32769, 128, torch.float32),
                                       (65537, 8, torch.bfloat16),
                                       (64, 12, torch.float32)])
def test_probe_column_gather_refuses_tables_it_cannot_hold(gen, s, c, dtype):
    from axial_vs_tpu_torch.tools.bench_pallas_bw import column_gather

    t = torch.zeros(s, c, device="cuda", dtype=dtype)
    idx = torch.zeros(4, c, device="cuda", dtype=torch.int32)
    before = column_gather.launches
    with pytest.raises(ValueError):
        column_gather(t, idx)
    assert column_gather.launches == before


@pytest.mark.parametrize("unroll", [1, 4, 8])
@pytest.mark.parametrize("s,nq,p,outside", [
    (16128, 21168, 4, False), (50, 37, 3, False),
    # tube_l0; an odd NQ, which no block's rows divide; P = 1 and P = 8
    (3600, 4760, 4, False), (16128, 21167, 4, False), (1000, 1237, 1, False),
    (1000, 1237, 8, False),
    # one index at -1 and one at S, each a zero row
    (3600, 4760, 4, True), (50, 37, 3, True)])
def test_probe_slab_gather_kernel(gen, unroll, s, nq, p, outside):
    """Bitwise equal to the plain version (the same f32 products and sums
    in the same order, one rounding), the first and the last slab rows
    among the indices; an index outside [0, S) reads a zero row, which the
    plain version gets from a zero row appended to the slab."""
    from axial_vs_tpu_torch.tools.exp_vmem_gather import (slab_gather,
                                                          slab_gather_plain)

    slab = torch.randn(s, 128, generator=gen, device="cuda").bfloat16()
    idx = torch.randint(0, s, (nq, p), generator=gen, device="cuda",
                        dtype=torch.int32)
    idx[0, 0], idx[-1, -1] = 0, s - 1
    if outside:
        idx[1, 0], idx[nq // 2, p - 1] = -1, s
    w = torch.rand(nq, p, generator=gen, device="cuda")
    before = slab_gather.launches
    got = slab_gather(idx, w, slab, unroll)
    assert slab_gather.launches == before + 1
    inside = (idx >= 0) & (idx < s)
    zero_row = torch.cat([slab, slab.new_zeros(1, 128)])
    want = slab_gather_plain(torch.where(inside, idx, s), w, zero_row)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant", ["noln", "tree", "bf16mul", "f32once",
                                     "dxpart", "acc2", "acc4", "dxonce"])
@pytest.mark.parametrize("shape", [
    (2, 24, 42, 1536), (1, 11, 9, 16),
    # the other ConvNeXt-L stages at 769x1345
    (2, 192, 336, 192), (2, 96, 168, 384), (2, 48, 84, 768),
    # strips of 5 and 25 threads, blocks that are not whole warps
    (1, 13, 21, 40), (2, 9, 37, 200),
    # H < 7 with a ragged W, at the widest C and at the narrowest
    (1, 5, 19, 1536), (2, 3, 11, 8)])
def test_probe_dwconv_variant_kernel(gen, variant, shape):
    """Each variant against its plain version; with the taps made once
    (``taps=``) bitwise equal to the call that makes them; where a block's
    strips are not whole warps, 50 calls each bitwise equal to the first."""
    from axial_vs_tpu_torch.ops.convnext_cuda import dwconv_taps
    from axial_vs_tpu_torch.tools.exp_dwconv_variants import (
        dwconv_variant, dwconv_variant_plain)

    n, h, w, c = shape
    x = torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    wt = (torch.randn(c, 1, 7, 7, generator=gen, device="cuda") * 0.1).bfloat16()
    b, lw, lb = (torch.randn(c, generator=gen, device="cuda") * 0.1
                 for _ in range(3))
    before = dwconv_variant.launches
    got = dwconv_variant(x, wt, b, lw + 1, lb, variant)
    assert dwconv_variant.launches == before + 1
    want = dwconv_variant_plain(x, wt, b, lw + 1, lb, variant)
    taps = dwconv_taps(wt)
    outs = [dwconv_variant(x, wt, b, lw + 1, lb, variant, taps=taps)
            for _ in range(50 if c in (40, 200) else 1)]
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _ulp(want)
    for again in outs:
        assert torch.equal(again, got)


@pytest.mark.parametrize("tokens,c,hidden,tiles", [
    (672, 768, 3072, 27), (40, 128, 256, 3),
    # rows not a multiple of the GEMM's 128-row tile, C of 192 and 768 with
    # a hidden width of 4C, one tile and 27
    *[(n, c, 4 * c, k) for n in (100, 672) for c in (192, 768)
      for k in (1, 27) if (n, c, k) != (672, 768, 27)]])
def test_probe_overlap_kernels(gen, tokens, c, hidden, tiles):
    from axial_vs_tpu_torch.tools import bench_overlap as bo

    x, t = (torch.randn(tokens, c, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    w1 = (torch.randn(c, hidden, generator=gen, device="cuda") * 0.02).bfloat16()
    w2 = (torch.randn(hidden, c, generator=gen, device="cuda") * 0.02).bfloat16()
    want_v, want_m = bo.vpu_work(x), bo.mxu_work(t, w1, w2)
    ops = bo.mxu_operands(t, w1, w2, tiles)

    def err(got, want):
        return (got.float() - want.float()).abs().max().item()

    before = {k: fn.launches for k, fn in bo.counted_kernels().items()}
    got_v = bo.overlap_vpu(x, tiles)
    got_m = bo.overlap_mxu(t, w1, w2, tiles)  # the wrapper makes the operands
    both = bo.overlap_both(x, t, w1, w2, tiles, ops)
    inter = bo.overlap_interleave(x, t, w1, w2, tiles, ops)
    torch.cuda.synchronize()
    assert {k: fn.launches - before[k]
            for k, fn in bo.counted_kernels().items()} == dict.fromkeys(
                bo.counted_kernels(), 1)
    for got in (got_v, both[0], inter[0]):
        assert got.shape == (tiles, tokens, c)
        assert err(got, want_v) <= _ulp(want_v)
    for got in (got_m, both[1], inter[1]):
        assert got.shape == (tiles, tokens, c)
        assert err(got, want_m) <= 2 * _ulp(want_m)


@pytest.mark.parametrize("case", ["c24", "c1552", "hidden40", "tiles0",
                                  "operands"])
def test_probe_overlap_refuses_shapes_outside_its_limits(gen, case):
    """Shapes the GEMM core does not take raise ValueError before any
    launch, as on the CPU; so do operands of the wrong shapes."""
    from axial_vs_tpu_torch.tools import bench_overlap as bo

    tokens, c, hidden, tiles = {"c24": (8, 24, 96, 1), "c1552": (8, 1552, 64, 1),
                                "hidden40": (8, 16, 40, 1),
                                "tiles0": (8, 16, 64, 0),
                                "operands": (8, 16, 64, 2)}[case]
    x = torch.zeros(tokens, c, device="cuda", dtype=torch.bfloat16)
    w1 = torch.zeros(c, hidden, device="cuda", dtype=torch.bfloat16)
    w2 = torch.zeros(hidden, c, device="cuda", dtype=torch.bfloat16)
    ops = bo.mxu_operands(x, w1, w2, 1) if case == "operands" else None
    before = {k: fn.launches for k, fn in bo.counted_kernels().items()}
    for call in (lambda: bo.overlap_mxu(x, w1, w2, tiles, ops),
                 lambda: bo.overlap_both(x, x, w1, w2, tiles, ops),
                 lambda: bo.overlap_interleave(x, x, w1, w2, tiles, ops)):
        with pytest.raises(ValueError):
            call()
    assert {k: fn.launches for k, fn in bo.counted_kernels().items()} == before
