"""K1's and K4's tap-major weight copy, checked on the CPU: the layout
(``ops/convnext_cuda.py::dwconv_taps``), the copy a ConvNeXt block keeps in
eval mode (``models/backbones/convnext.py::ConvNeXtBlock.dw_taps``), and the
wrappers' check of a copy they are given."""
import pytest
import torch

from axial_vs_tpu_torch.models.backbones.convnext import ConvNeXt, ConvNeXtBlock
from axial_vs_tpu_torch.models.kmax import materialize
from axial_vs_tpu_torch.ops import convnext_cuda
from axial_vs_tpu_torch.utils import convert
from test_torch_parity import torch_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [2, 6, 192])
def test_dwconv_taps_is_tap_major(c, dtype):
    w = torch.randn(c, 1, 7, 7)
    taps = convnext_cuda.dwconv_taps(w, dtype)
    assert taps.shape == (7, 7, c) and taps.dtype == dtype
    assert taps.is_contiguous()
    for dy, dx in ((0, 0), (3, 5), (6, 6)):
        torch.testing.assert_close(taps[dy, dx], w[:, 0, dy, dx].to(dtype),
                                   rtol=0, atol=0)


def _assert_block_taps(block):
    weight = block.conv_dw.weight.detach()
    assert block.dw_taps.dtype == weight.dtype
    torch.testing.assert_close(block.dw_taps, convnext_cuda.dwconv_taps(weight),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [2, 6, 192])
def test_block_keeps_taps_in_eval_mode_only(c, dtype):
    block = ConvNeXtBlock(c).to(dtype)
    with torch.no_grad():
        block.conv_dw.weight.normal_()
    assert block.dw_taps is None
    block.eval()
    _assert_block_taps(block)
    assert "dw_taps" not in block.state_dict()
    block.train()
    assert block.dw_taps is None


def test_block_takes_new_weights_at_eval():
    block = ConvNeXtBlock(8).eval()
    state = {k: torch.randn(v.shape).numpy()
             for k, v in block.state_dict().items()}
    convert.load_into(block, state).eval()
    _assert_block_taps(block)
    torch.testing.assert_close(block.dw_taps[2, 4],
                               torch.from_numpy(state["conv_dw.weight"][:, 0, 2, 4]),
                               rtol=0, atol=0)


def test_block_taps_follow_the_module_dtype():
    block = ConvNeXtBlock(8)
    with torch.no_grad():
        block.conv_dw.weight.normal_()
    block = block.eval().to(torch.bfloat16)
    _assert_block_taps(block)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("route", ["dwln", "mlp", "block"])
def test_materialized_backbone_keeps_every_blocks_taps(route, dtype):
    """``materialize`` (meta device, draws, bf16 cast, eval) leaves every
    block with the copy of its drawn weight, in the weight's dtype."""
    model = ConvNeXt(depths=(1, 2, 1, 1), dims=(8, 16, 24, 32),
                     block_kernel=route, device=torch.device("meta"))
    model = materialize(model, torch.device("cpu"),
                        torch.Generator().manual_seed(0), dtype)
    blocks = [b for b in model.modules() if isinstance(b, ConvNeXtBlock)]
    assert len(blocks) == 5
    for block in blocks:
        _assert_block_taps(block)
        assert block.dw_taps.dtype == (dtype or torch.float32)


@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_wrappers_check_the_taps_they_are_given(kernel):
    c = 16
    x = torch.randn(1, 5, 6, c)
    dw = (torch.randn(c, 1, 7, 7), *(torch.randn(c) for _ in range(3)))
    mlp = (torch.randn(4 * c, c), torch.randn(4 * c), torch.randn(c, 4 * c),
           torch.randn(c), torch.randn(c))
    call = {"K1": lambda **kw: convnext_cuda.dwconv7x7_layernorm(x, *dw, **kw),
            "K4": lambda **kw: convnext_cuda.convnext_block_fused(
                x, *dw, *mlp, **kw)}[kernel]
    want = call()
    torch.testing.assert_close(call(taps=convnext_cuda.dwconv_taps(dw[0])),
                               want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        call(taps=torch.zeros(7, 7, c + 2))
