"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided in
the fixture, at run time). On a machine with a card and without JAX, run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: both sides sum in f32 and round to bf16 once, so they agree to
within 2 bf16 ulp of the output's largest magnitude.
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


def _bound(want):
    scale = want.float().abs().max().item()
    return 2 * 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


@pytest.mark.parametrize("shape", [(2, 24, 42, 1536), (1, 37, 53, 200),
                                   (1, 3, 5, 2)])
def test_dwconv7x7_layernorm_kernel(gen, shape):
    from axial_vs_tpu_torch.ops.convnext_cuda import (
        dwconv7x7_layernorm, dwconv7x7_layernorm_plain)

    n, h, w, c = shape
    x = torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    wt = (torch.randn(c, 1, 7, 7, generator=gen, device="cuda") * 0.1).bfloat16()
    b, lw, lb = (torch.randn(c, generator=gen, device="cuda") * 0.1
                 for _ in range(3))
    before = dwconv7x7_layernorm.launches
    got = dwconv7x7_layernorm(x, wt, b, lw + 1, lb)
    assert dwconv7x7_layernorm.launches == before + 1
    want = dwconv7x7_layernorm_plain(x, wt, b, lw + 1, lb)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _bound(want)
    with pytest.raises(TypeError):
        dwconv7x7_layernorm(x.float(), wt, b, lw, lb)


@pytest.mark.parametrize("d,shapes", [(32, ((6, 7), (12, 14))),
                                      (40, ((5, 7), (3, 4), (2, 3)))])
def test_ms_deform_attn_kernel(gen, d, shapes):
    from axial_vs_tpu_torch.ops.msda import (
        level_start_index, ms_deform_attn, ms_deform_attn_plain)

    b, lq, m, p = 2, 29, 4, 3
    s = sum(h * w for h, w in shapes)
    value = torch.randn(b, s, m, d, generator=gen, device="cuda").bfloat16()
    loc = torch.rand(b, lq, m, len(shapes), p, 2, generator=gen,
                     device="cuda") * 1.4 - 0.2
    w = torch.randn(b, lq, m, len(shapes) * p, generator=gen, device="cuda")
    w = w.softmax(-1).reshape(b, lq, m, len(shapes), p).bfloat16()
    starts = level_start_index(shapes)
    before = ms_deform_attn.launches
    got = ms_deform_attn(value, shapes, starts, loc, w)
    assert ms_deform_attn.launches == before + 1
    want = ms_deform_attn_plain(value, shapes, starts, loc, w)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _bound(want)
