"""Guards for the PyTorch port (axial_vs_tpu_torch): the weight converters
round-trip, the package imports without JAX, CPU tensors take the kernels'
plain versions without launching anything, and the bf16 segmenter runs."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from axial_vs_tpu.utils.torch_convert import (convert_maxtron_wc,
                                              stack_convnext_for_scan)
from axial_vs_tpu_torch.models.kmax import build_segmenter
from axial_vs_tpu_torch.ops.convnext_cuda import (dwconv7x7_layernorm,
                                                  dwconv7x7_layernorm_plain)
from axial_vs_tpu_torch.ops.msda import (level_start_index, ms_deform_attn,
                                         ms_deform_attn_plain)
from axial_vs_tpu_torch.utils.convert import convert_variables

ROOT = Path(__file__).resolve().parent.parent
DEPTHS, DIMS = (1, 2, 1, 1), (32, 64, 96, 128)
DEC_LAYERS, TD_LAYERS = (1, 2, 1, 1), (1, 1, 1)


def _config(dtype="float32"):
    from axial_vs_tpu.config import get_default_config

    cfg = get_default_config()
    cfg.model.backbone.name = "convnext_guard_test"
    cfg.model.backbone.convnext.depths = list(DEPTHS)
    cfg.model.backbone.convnext.dims = list(DIMS)
    cfg.model.num_classes = 5
    cfg.model.dtype = dtype
    cfg.model.maxtron.wc.enable = True
    cfg.model.maxtron.wc.conv_dims = 64
    cfg.model.maxtron.wc.dim_feedforward = 96
    cfg.model.kmax.pixel_dec.dec_layers = list(DEC_LAYERS)
    cfg.model.kmax.pixel_dec.dec_channels = [32, 16, 16, 16]
    cfg.model.kmax.trans_dec.dec_layers = list(TD_LAYERS)
    cfg.model.kmax.trans_dec.num_object_queries = 8
    return cfg


@pytest.mark.parametrize("scan_stacked", [False, True])
def test_converter_round_trip(scan_stacked):
    """port state_dict -> convert_maxtron_wc -> utils/convert.py gives back
    the same state_dict, also from the scan-stacked ConvNeXt tree."""
    model = build_segmenter(_config(), torch.device("cpu"),
                            torch.Generator().manual_seed(3), num_frames=2)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = convert_maxtron_wc(
        sd, backbone="convnext", depths=DEPTHS, dec_layers=DEC_LAYERS,
        num_td_layers=sum(TD_LAYERS), temporal_per_stage=2)
    if scan_stacked:
        variables["params"]["backbone"] = stack_convnext_for_scan(
            variables["params"]["backbone"], DEPTHS)
        assert "stage1_blocks" in variables["params"]["backbone"]
    back = convert_variables(variables)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=k)


def test_port_imports_without_jax():
    """Every module of the port imports with jax and flax unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax'):\n"
        "    sys.modules[m] = None\n"
        "import axial_vs_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'axial_vs_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'axial_vs_tpu' or k.startswith('axial_vs_tpu.') "
        "for k in sys.modules), 'the port imported the JAX package'\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def _k1_inputs(rng):
    c = 24
    return (torch.from_numpy(rng.randn(2, 6, 9, c).astype(np.float32)),
            torch.from_numpy(rng.randn(c, 1, 7, 7).astype(np.float32)),
            *(torch.from_numpy(rng.randn(c).astype(np.float32))
              for _ in range(3)))


def _k2_inputs(rng):
    shapes = ((3, 4), (2, 2))
    value = torch.from_numpy(rng.randn(2, 16, 2, 8).astype(np.float32))
    loc = torch.from_numpy(rng.rand(2, 5, 2, 2, 3, 2).astype(np.float32))
    w = torch.from_numpy(rng.rand(2, 5, 2, 2, 3).astype(np.float32))
    return value, shapes, level_start_index(shapes), loc, w


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_cpu_tensors_take_plain_version(rng, kernel):
    """On CPU tensors a wrapper returns its plain version's result and does
    not count a launch (nothing is built or loaded)."""
    from axial_vs_tpu_torch.ops import native

    wrapper, plain, args = {
        "K1": (dwconv7x7_layernorm, dwconv7x7_layernorm_plain,
               _k1_inputs(rng)),
        "K2": (ms_deform_attn, ms_deform_attn_plain, _k2_inputs(rng)),
    }[kernel]
    before = wrapper.launches
    torch.testing.assert_close(wrapper(*args), plain(*args), rtol=0, atol=0)
    assert wrapper.launches == before == 0
    assert native._lib is None


def test_bf16_segmenter_runs_on_cpu(rng):
    """bf16 inference path end to end at a small size: shapes, finiteness,
    and matrices kept bf16 at rest with f32 vectors."""
    model = build_segmenter(_config("bfloat16"), torch.device("cpu"),
                            torch.Generator().manual_seed(0), num_frames=2)
    assert model.backbone.stem[0].weight.dtype == torch.bfloat16
    assert model.backbone.stem[1].weight.dtype == torch.float32
    x = torch.from_numpy(rng.randn(4, 65, 97, 3).astype(np.float32))
    with torch.inference_mode():
        out = model(x)
    shapes = {"pred_logits": (2, 8, 6), "pred_masks": (2, 2, 16, 24, 8),
              "pred_mask_embeddings": (2, 8, 128)}
    for k, shape in shapes.items():
        assert out[k].shape == shape and out[k].dtype == torch.bfloat16
        assert torch.isfinite(out[k].float()).all(), k


def _leaves(ns, prefix=""):
    from types import SimpleNamespace

    for k, v in vars(ns).items():
        if isinstance(v, SimpleNamespace):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_smoke_config_is_the_bench_config():
    """chip_smoke.py builds bench.py's default configuration from plain
    objects (it imports nothing of the JAX package); every value it sets is
    the one the repo's config tree gives with bench.py's overrides."""
    import importlib.util

    from axial_vs_tpu.config import get_default_config

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = get_default_config()  # bench.py:93-109, the ConvNeXt-L default
    cfg.model.backbone.name = "convnext_large"
    cfg.model.backbone.convnext.depths = [3, 3, 27, 3]
    cfg.model.backbone.convnext.dims = [192, 384, 768, 1536]
    cfg.model.num_classes = 124
    cfg.model.dtype = "bfloat16"
    cfg.input.image_size = [769, 1345]
    cfg.input.num_clip_frames = 2
    cfg.model.maxtron.wc.enable = True
    leaves = dict(_leaves(smoke.wc_convnext_large_config()))
    assert len(leaves) >= 25
    for path, value in leaves.items():
        node = cfg
        for key in path.split("."):
            node = node[key]
        assert node == value, path
