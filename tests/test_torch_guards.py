"""Guards for the PyTorch port (axial_vs_tpu_torch): the weight converters
round-trip, the package imports without JAX, CPU tensors take the kernels'
plain versions without launching anything, the builders and the bench and
probe tools default to the card, the bf16 segmenter and Tube-Link detector
run, the inference-only Tube-Link models build and refuse training, and
chip_smoke.py's configs are the benches' configs."""
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from axial_vs_tpu.utils.torch_convert import (convert_maxtron_wc,
                                              stack_convnext_for_scan)
from axial_vs_tpu_torch.models.kmax import build_segmenter
from axial_vs_tpu_torch.ops.convnext_cuda import (
    convnext_block_fused, convnext_block_fused_plain, convnext_mlp_residual,
    convnext_mlp_residual_plain, dwconv7x7_layernorm, dwconv7x7_layernorm_plain)
from axial_vs_tpu_torch.models.tube_link.cc_detector import (
    build_tube_link_video_vis)
from axial_vs_tpu_torch.models.tube_link.detector import (
    TubeLinkVISInference, build_tube_link_vis)
from axial_vs_tpu_torch.models.tube_link.image_mask2former import (
    build_image_mask2former)
from axial_vs_tpu_torch.models.tube_link.vps import build_tube_link_vps
from axial_vs_tpu_torch.ops.msda import (level_start_index, ms_deform_attn,
                                         ms_deform_attn_plain)
from axial_vs_tpu_torch.ops.msda_reduce import (
    pack_corner_table, pack_corner_table_plain, weighted_corner_reduce_multi,
    weighted_corner_reduce_multi_plain, weighted_corner_reduce_v5,
    weighted_corner_reduce_v5_plain)
from axial_vs_tpu_torch.ops.traj import (trajectory_attention_core,
                                         trajectory_attention_core_plain)
from axial_vs_tpu_torch.tools import bench_overlap as probe_overlap
from axial_vs_tpu_torch.tools import bench_pallas_bw as probe_bw
from axial_vs_tpu_torch.tools import exp_dwconv_variants as probe_dw
from axial_vs_tpu_torch.tools import exp_vmem_gather as probe_gather
from axial_vs_tpu_torch.utils.convert import convert_variables
from fixtures_coco import write_tiny_coco
from test_torch_parity import torch_threads  # noqa: F401 (autouse)

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
        "print(' '.join(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 30
    for module in ("data.vipseg", "data.catalog", "data.panoptic_utils",
                   "evaluation.vpq", "evaluation.vipseg_evaluator",
                   "evaluation.stq", "engine.evaluator_loop",
                   "models.postprocess", "models.video_inference",
                   "ops.msda_reduce", "tools.bench_msda", "tools.timing",
                   "tools.bench_pallas_bw", "tools.exp_vmem_gather",
                   "tools.exp_dwconv_variants", "tools.bench_overlap",
                   "config", "config.node", "config.defaults",
                   "losses.matcher", "losses.criterion", "ops.hungarian",
                   "engine.lr_schedule", "engine.optim", "engine.train_step",
                   "tools.bench", "tools.bench_train", "data.transforms",
                   "data.build", "data.builtin", "data.loader",
                   "data.synthetic", "engine.trainer", "engine.checkpoint",
                   "engine.logger", "models.build", "tools.train_net_video",
                   "tools.validate_overfit", "tools.validate_overfit_cc",
                   "data.mask_rle", "data.ytvis", "evaluation.ytvis_eval",
                   "models.tube_link.vps", "models.tube_link.fusion",
                   "models.tube_link.cc_detector",
                   "models.tube_link.image_mask2former",
                   "trackers.quasi_dense", "evaluation.dstq",
                   "evaluation.vspw_metrics", "models.backbones.swin",
                   "models.backbones.stdc"):
        assert f"axial_vs_tpu_torch.{module}" in names, module


def _k1_inputs(rng, c=24):
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


def _mlp_inputs(rng, c=32):
    return [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.2)
            for s in ((4 * c, c), (4 * c,), (c, 4 * c), (c,), (c,))]


def _k5_inputs(rng):
    x, sc = (torch.from_numpy(rng.randn(2, 5, 7, 32).astype(np.float32))
             for _ in range(2))
    return (x, sc, *_mlp_inputs(rng))


def _k4_inputs(rng):
    return (*_k1_inputs(rng, c=32), *_mlp_inputs(rng))


def _bf16(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()


def _k6_inputs(rng):
    return [_bf16(rng, 7, 32) for _ in range(3)], _bf16(rng, 7, 12)


def _k7_inputs(rng):
    return ([_bf16(rng, 7, 64) for _ in range(3)], _bf16(rng, 7, 24), 2,
            True)


def _k8_inputs(rng):
    return _bf16(rng, 2, 15, 16), 5, 2


def _k3_inputs(rng):
    c, f = 64, 3
    q, k, v = (torch.from_numpy(rng.randn(2, f * 5, c).astype(np.float32))
               for _ in range(3))
    w = [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1)
         for s in ((c, c), (c,), (2 * c, c), (2 * c,))]
    return (q, k, v, *w, f, 8)


def _p2_inputs(rng):
    return (torch.from_numpy(rng.randint(0, 10, (7, 3)).astype(np.int32)),
            torch.from_numpy(rng.rand(7, 3).astype(np.float32)),
            _bf16(rng, 10, 16), 4)


def _p3_inputs(rng, kernel):
    x, t = _bf16(rng, 8, 16), _bf16(rng, 8, 16)
    w1, w2 = _bf16(rng, 16, 64), _bf16(rng, 64, 16)
    return {"P3-vpu": (x, 2), "P3-mxu": (t, w1, w2, 2)}.get(
        kernel, (x, t, w1, w2, 2))


#: the probes' wrappers and plain versions (tools/)
PROBES = {
    "P1": (probe_dw.dwconv_variant, probe_dw.dwconv_variant_plain),
    "P2": (probe_gather.slab_gather,
           lambda idx, w, slab, unroll: probe_gather.slab_gather_plain(
               idx, w, slab)),
    "P3-vpu": (probe_overlap.overlap_vpu, probe_overlap.overlap_vpu_plain),
    "P3-mxu": (probe_overlap.overlap_mxu, probe_overlap.overlap_mxu_plain),
    "P3-both": (probe_overlap.overlap_both, probe_overlap.overlap_both_plain),
    "P3-interleave": (probe_overlap.overlap_interleave,
                      probe_overlap.overlap_interleave_plain),
    "P4-copy": (probe_bw.scale_copy, probe_bw.scale_copy_plain),
    "P4-sum12": (probe_bw.sum_n, probe_bw.sum_n_plain),
    "P4-gather": (probe_bw.column_gather, probe_bw.column_gather_plain),
}


def _probe_inputs(rng, kernel):
    if kernel == "P1":
        return (*_k1_inputs(rng, c=16), "tree")
    if kernel == "P2":
        return _p2_inputs(rng)
    if kernel.startswith("P3"):
        return _p3_inputs(rng, kernel)
    if kernel == "P4-copy":
        return (_bf16(rng, 4, 128),)
    if kernel == "P4-sum12":
        return ([_bf16(rng, 4, 128) for _ in range(3)],)
    return (torch.from_numpy(rng.randn(6, 128).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 6, (5, 128)).astype(np.int32)))


@pytest.mark.parametrize("kernel",
                         ["K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8",
                          *PROBES])
def test_cpu_tensors_take_plain_version(rng, kernel):
    """On CPU tensors a wrapper returns its plain version's result and does
    not count a launch (nothing is built or loaded)."""
    from axial_vs_tpu_torch.ops import native

    wrapper, plain, args = {
        "K1": (dwconv7x7_layernorm, dwconv7x7_layernorm_plain,
               _k1_inputs(rng)),
        "K2": (ms_deform_attn, ms_deform_attn_plain, _k2_inputs(rng)),
        "K3": (trajectory_attention_core, trajectory_attention_core_plain,
               _k3_inputs(rng)),
        "K4": (convnext_block_fused, convnext_block_fused_plain,
               _k4_inputs(rng)),
        "K5": (convnext_mlp_residual, convnext_mlp_residual_plain,
               _k5_inputs(rng)),
        "K6": (weighted_corner_reduce_multi, weighted_corner_reduce_multi_plain,
               _k6_inputs(rng)),
        "K7": (weighted_corner_reduce_v5, weighted_corner_reduce_v5_plain,
               _k7_inputs(rng)),
        "K8": (pack_corner_table, pack_corner_table_plain, _k8_inputs(rng)),
        **{k: (*PROBES[k], _probe_inputs(rng, k)) for k in PROBES
           if k == kernel},
    }[kernel]
    before = wrapper.launches
    torch.testing.assert_close(wrapper(*args), plain(*args), rtol=0, atol=0)
    assert wrapper.launches == before == 0
    assert native._lib is None


def test_msda_bench_defaults_to_the_card():
    """The MSDA bench runs on the card unless asked for the CPU: ``run``
    and ``main`` default to ``cuda`` (and fail here, where there is none);
    on request it runs on the CPU at a small shape, every variant checked
    against ``prod``, with no kernel launched."""
    from axial_vs_tpu_torch.tools import bench_msda

    assert inspect.signature(bench_msda.run).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_msda.main([])
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_msda.run(iters=0)
    res = bench_msda.run(iters=1, device="cpu", shapes=((5, 6), (3, 4)), b=1,
                         m=2, d=8, p=3)
    assert list(res) == list(bench_msda.VARIANTS)
    for name, r in res.items():
        assert r["ms"] > 0 and set(r["launches"].values()) == {0}, name
        if name != "giant_gather_only":  # unweighted: not the op's value
            assert r["max_abs_diff"] <= 0.05, (name, r)


@pytest.mark.parametrize("name", ["bench", "bench_train"])
def test_bench_tool_defaults_to_the_card(name):
    """The inference and training benches run on the card unless asked for
    the CPU: ``run`` and ``main`` default to ``cuda`` (and fail here, where
    there is none); on request they run on the CPU at a small size (the
    full-width R50 models at 64x64 frames), print-ready, with no kernel
    launched and nothing built."""
    import importlib

    from axial_vs_tpu_torch.ops import native
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core

    mod = importlib.import_module(f"axial_vs_tpu_torch.tools.{name}")
    assert inspect.signature(mod.run).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(["--iters", "0"])
    kernels = (ms_deform_attn, trajectory_attention_core)
    before = [k.launches for k in kernels]
    if name == "bench":
        res = mod.run(backbone="resnet50", image_size=(64, 64), iters=2,
                      device="cpu")
        assert res["unit"] == "frames/sec" and res["dtype"] == "bfloat16"
        assert res["ms_per_forward_min"] <= res["ms_per_forward_median"]
    else:
        res = mod.run(image_size=(64, 64), iters=1, device="cpu")
        assert res["unit"] == "steps/sec" and res["dtype"] == "float32"
        assert res["matching"] == "exact" and res["gt_segments"] == 24
        assert np.isfinite([res["loss_first"], res["loss_last"]]).all()
    assert res["value"] > 0 and res["device"] == "cpu"
    assert [k.launches for k in kernels] == before and native._lib is None


#: each probe tool's ``run`` arguments for a small CPU run
PROBE_RUNS = {
    "bench_pallas_bw": dict(rows=64),
    "bench_pallas_bw --gather": dict(gather=True),
    "exp_vmem_gather": dict(shapes=["s"], sizes={"s": (50, 37, 4, 128)}),
    "exp_dwconv_variants": dict(stages=["s"], sizes={"s": (1, 11, 9, 16)}),
    "bench_overlap": dict(tokens=32, c=64, tiles=2),
}


def _probe_checks(name, res):
    """(error, bound) of every checked output of a probe tool's run."""
    if name.startswith("bench_pallas_bw"):
        return [(r["max_abs_diff"], 0.0) for r in res.values()]
    if name == "bench_overlap":
        return [(d, r["bound"][k]) for n, r in res.items() if n != "summary"
                for k, d in r["diff"].items()]
    return [(r["max_abs_diff"], r["bound"]) for rv in res.values()
            for r in rv.values()]


@pytest.mark.parametrize("name", list(PROBE_RUNS))
def test_probe_tool_defaults_to_the_card(name):
    """Each probe tool runs on the card unless asked for the CPU: ``run``
    and ``main`` default to ``cuda`` (and fail here, where there is none);
    on request it runs on the CPU at a small shape, every output within its
    bound of the plain version, with no kernel launched and nothing built."""
    import importlib

    from axial_vs_tpu_torch.ops import native

    mod = importlib.import_module(
        f"axial_vs_tpu_torch.tools.{name.split()[0]}")
    assert inspect.signature(mod.run).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.run(iters=0)
    wrappers = [w for w, _ in PROBES.values()] + [dwconv7x7_layernorm]
    before = [w.launches for w in wrappers]
    res = mod.run(iters=1, device="cpu", **PROBE_RUNS[name])
    assert [w.launches for w in wrappers] == before == [0] * len(wrappers)
    assert native._lib is None
    checks = _probe_checks(name, res)
    assert checks and all(err <= bound for err, bound in checks), checks


def test_mxu_operands_are_the_transposes(rng):
    """P3's mxu kernels take K-major copies: every tile's rows of t in
    order, w1 transposed and w2 transposed, contiguous."""
    x, t = _bf16(rng, 5, 16), _bf16(rng, 5, 16)
    w1, w2 = _bf16(rng, 16, 64), _bf16(rng, 64, 16)
    a, w1t, w2t = probe_overlap.mxu_operands(t, w1, w2, 3)
    assert all(o.is_contiguous() and o.dtype == torch.bfloat16
               for o in (a, w1t, w2t))
    assert torch.equal(a, torch.cat([t, t, t]))
    assert torch.equal(w1t, w1.t()) and torch.equal(w2t, w2.t())
    assert w1t.shape == (64, 16) and w2t.shape == (16, 64)


#: shapes outside the P2, P3 and P4 kernels' limits: (wrapper, its inputs)
OUTSIDE_LIMITS = {
    "P2 no points a query": ("slab", 0),
    "P2 more points a query than MAX_P": ("slab", 9),
    "P3 C not a multiple of 16": ("mxu", (8, 24, 96, 1)),
    "P3 C above MXU_MAX_C": ("mxu", (8, 1552, 64, 1)),
    "P3 hidden not a multiple of 16": ("both", (8, 16, 40, 1)),
    "P3 no tiles": ("interleave", (8, 16, 64, 0)),
    "P3 vpu tokens x C not whole vectors": ("vpu", (3, 5, 0, 2)),
    "P4 C not a multiple of 8": ("gather", (64, 12, torch.float32)),
    "P4 f32 table above 32768 rows": ("gather", (32769, 8, torch.float32)),
    "P4 bf16 table above 65536 rows": ("gather", (65537, 8, torch.bfloat16)),
}


@pytest.mark.parametrize("case", list(OUTSIDE_LIMITS))
def test_probe_limits_raise_on_cpu(case):
    """Shapes the P2, P3 and P4 kernels do not take raise ValueError before
    anything is launched or built, on CPU tensors as on the card's."""
    from axial_vs_tpu_torch.ops import native

    kind, shape = OUTSIDE_LIMITS[case]
    if kind == "slab":
        call = lambda: probe_gather.slab_gather(  # noqa: E731
            torch.zeros(5, shape, dtype=torch.int32), torch.zeros(5, shape),
            torch.zeros(10, 128, dtype=torch.bfloat16), 4)
    elif kind == "gather":
        s, c, dtype = shape
        call = lambda: probe_bw.column_gather(  # noqa: E731
            torch.zeros(s, c, dtype=dtype), torch.zeros(4, c, dtype=torch.int32))
    else:
        tokens, c, hidden, tiles = shape
        x = torch.zeros(tokens, c, dtype=torch.bfloat16)
        w1 = torch.zeros(c, hidden, dtype=torch.bfloat16)
        w2 = torch.zeros(hidden, c, dtype=torch.bfloat16)
        call = {"vpu": lambda: probe_overlap.overlap_vpu(x, tiles),
                "mxu": lambda: probe_overlap.overlap_mxu(x, w1, w2, tiles),
                "both": lambda: probe_overlap.overlap_both(x, x, w1, w2, tiles),
                "interleave": lambda: probe_overlap.overlap_interleave(
                    x, x, w1, w2, tiles)}[kind]
    with pytest.raises(ValueError):
        call()
    assert native._lib is None


@pytest.mark.parametrize("shape", list(probe_gather.SHAPES))
@pytest.mark.parametrize("unroll", [1, 4, 8])
def test_slab_gather_grid_fills_the_card(shape, unroll):
    """P2's launch on an H100's 132 SMs: the most threads (32-256) whose row
    slots fit and whose grid keeps 4 blocks an SM; the grid a multiple of
    the SM count, at least 2 blocks an SM, with room for NQ; the kernel's
    spread of the queries gives blocks that differ by at most one query,
    so no SM takes half again another's share."""
    sms, (s, nq, p, _) = 132, probe_gather.SHAPES[shape]
    threads, blocks = probe_gather.launch_shape(nq, unroll, p, sms)
    per_block = threads // probe_gather.ROW_THREADS * unroll

    def fits(t):
        return (t * p * unroll * 16 <= probe_gather.ROW_SLOT_BYTES
                and -(-nq // (t // probe_gather.ROW_THREADS * unroll))
                >= probe_gather.BLOCKS_PER_SM * sms)

    assert threads in (32, 64, 128, 256) and (fits(threads) or threads == 32)
    assert threads == 256 or not fits(2 * threads)
    assert blocks % sms == 0 and blocks >= 2 * sms and blocks * per_block >= nq
    b = np.arange(blocks + 1, dtype=np.int64)
    counts = np.diff(b * nq // blocks)  # the kernel's run of queries a block
    assert counts.sum() == nq and counts.max() <= per_block
    assert counts.max() - counts.min() <= 1
    shares = counts.reshape(-1, sms).sum(axis=0)  # blocks b, b + sms, ...
    assert shares.max() < 1.5 * shares.min()


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


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_smoke_config_is_the_bench_config():
    """chip_smoke.py builds bench.py's default configuration from the
    port's own config (it imports nothing of the JAX package); every value
    of it is the one the repo's config tree gives with bench.py's
    overrides, the evaluation's fields (``input.pixel_mean/std``,
    ``model.maxtron.test.*``) included."""
    from axial_vs_tpu.config import get_default_config

    cfg = get_default_config()  # bench.py:93-109, the ConvNeXt-L default
    cfg.model.backbone.name = "convnext_large"
    cfg.model.backbone.convnext.depths = [3, 3, 27, 3]
    cfg.model.backbone.convnext.dims = [192, 384, 768, 1536]
    cfg.model.backbone.convnext.drop_path_rate = 0.0
    cfg.model.backbone.convnext.use_scan = True
    cfg.model.num_classes = 124
    cfg.model.dtype = "bfloat16"
    cfg.input.image_size = [769, 1345]
    cfg.input.num_clip_frames = 2
    cfg.model.maxtron.wc.enable = True
    _assert_config_leaves(_smoke().wc_convnext_large_config(), cfg, 35)


def test_smoke_r50_config_is_the_yaml_config():
    """chip_smoke.py's R50 f32 configuration is the repo's default config
    with ``configs/vipseg/maxtron_wc_r50.yaml`` merged in, at the WC
    bench's frame size and clip length: every value of it, f32 (the
    default dtype, which the yaml leaves) included."""
    from axial_vs_tpu.config import get_default_config

    cfg = get_default_config()
    cfg.merge_from_file(str(ROOT / "configs" / "vipseg" / "maxtron_wc_r50.yaml"))
    plain = _smoke().wc_r50_config()
    assert plain.model.dtype == "float32" == cfg.model.dtype
    _assert_config_leaves(plain, cfg, 30)


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _assert_config_leaves(plain, cfg, at_least):
    leaves = dict(_leaves(plain))
    assert len(leaves) >= at_least
    for path, value in leaves.items():
        node = cfg
        for key in path.split("."):
            node = node[key]
        assert node == value, path


def test_smoke_tube_link_config_is_the_bench_config():
    """chip_smoke.py's Tube-Link R50 configuration is the repo's default
    config with tools/bench_tube_link.py:38-44's overrides."""
    from axial_vs_tpu.config import get_default_config

    cfg = get_default_config()
    cfg.model.meta_architecture = "TubeLinkVIS"
    cfg.model.backbone.name = "resnet50"
    cfg.model.num_classes = 40  # YTVIS-19
    cfg.model.dtype = "bfloat16"
    cfg.model.tube_link.clip_len = 5
    cfg.input.num_clip_frames = 5
    _assert_config_leaves(_smoke().tube_link_r50_config(), cfg, 15)


@pytest.mark.parametrize("fused", [False, True])
def test_smoke_captures_the_first_msda_call(fused):
    """chip_smoke.py's ``first_msda_call`` keeps the arguments of the first
    K2 call an MSDA layer makes (the WC layer's and the Tube-Link fused
    layer's), and the call still runs: K2 on the kept arguments gives the
    layer's own sample, and the wrapper counted every call."""
    from axial_vs_tpu_torch.layers.msda_attention import MSDeformAttn
    from axial_vs_tpu_torch.models.tube_link.pixel_decoder import (
        FusedMSDATrajectoryAttention)
    from axial_vs_tpu_torch.ops.msda import ms_deform_attn

    torch.manual_seed(0)
    shapes = ((2, 3), (4, 6), (8, 12))
    s, c = sum(h * w for h, w in shapes), 64
    if fused:
        layer = FusedMSDATrajectoryAttention(c, num_frames=2)
    else:
        layer = MSDeformAttn(c)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn_like(p) * 0.1)
    x = torch.randn(2, s, c)
    box, before = {}, ms_deform_attn.launches
    with torch.no_grad(), _smoke().first_msda_call(box, "k"):
        want = layer.sample(x, x, shapes)
        layer.sample(x + 1, x, shapes)
    assert ms_deform_attn.launches == before  # CPU tensors: the plain version
    value, got_shapes, starts, loc, weights = box["k"]
    assert got_shapes == shapes and value.shape == (2, s, 8, c // 8)
    assert torch.equal(ms_deform_attn(value, got_shapes, starts, loc, weights),
                       want)
    from axial_vs_tpu_torch.layers import msda_attention

    assert msda_attention.ms_deform_attn is ms_deform_attn  # restored


def test_msda_vector_path_rule():
    """K2's wrapper takes the 16-byte path where D holds whole 16-byte
    vectors, at most 32 a row, and the pointers are aligned; else the
    kernel's one-channel path."""
    from axial_vs_tpu_torch.ops.msda import vector_path

    loc = torch.zeros(2, 3, 8, 3, 4, 2)
    for dtype, d, want in ((torch.bfloat16, 32, True), (torch.float32, 32, True),
                           (torch.bfloat16, 37, False), (torch.float32, 6, False),
                           (torch.bfloat16, 8, True), (torch.bfloat16, 256, True),
                           (torch.bfloat16, 264, False), (torch.float32, 132, False)):
        value = torch.zeros(2, 7, 8, d, dtype=dtype)
        assert vector_path(value, loc, value) is want, (dtype, d)
    value = torch.zeros(2 * 7 * 8 * 32 + 1, dtype=torch.bfloat16)[1:]
    assert not vector_path(value.view(2, 7, 8, 32), loc, value)
    aligned = torch.zeros(2, 7, 8, 32)
    assert not vector_path(aligned, torch.zeros(97)[1:], aligned)


@pytest.mark.parametrize("builder", [
    build_segmenter, build_tube_link_vis, build_tube_link_vps,
    build_tube_link_video_vis, build_image_mask2former])
def test_builders_default_to_the_card(builder):
    """The entry points build on the card unless the caller passes another
    device, and draw the weights only from a generator they are given."""
    params = inspect.signature(builder).parameters
    assert params["device"].default == torch.device("cuda")
    with pytest.raises(TypeError):
        builder(_config(), torch.device("cpu"))


def _tube_link_config(dtype):
    from axial_vs_tpu.config import get_default_config

    cfg = get_default_config()
    cfg.model.backbone.name = "resnet18"
    cfg.model.backbone.resnet.depth = 18
    cfg.model.num_classes = 5
    cfg.model.dtype = dtype
    tl = cfg.model.tube_link
    tl.num_queries, tl.feat_channels, tl.out_channels = 8, 32, 32
    tl.num_decoder_layers = 2
    cfg.input.num_clip_frames = 3
    return cfg


def test_bf16_tube_link_runs_on_cpu(rng):
    """The bf16 Tube-Link VIS path end to end at a small size: bf16
    matrices and f32 vectors at rest, finite bf16 outputs, a whole 7-frame
    video in 3 tubes (the last one shifted back) with top-k instances."""
    model = build_tube_link_vis(_tube_link_config("bfloat16"),
                                torch.device("cpu"),
                                torch.Generator().manual_seed(0))
    assert model.backbone.conv1.weight.dtype == torch.bfloat16
    assert model.backbone.bn1.weight.dtype == torch.float32
    x = torch.from_numpy(rng.randn(7, 32, 48, 3).astype(np.float32))
    with torch.inference_mode():
        out = model(x[:3], return_query=True)
    assert len(out["cls_preds"]) == 3
    for k, shape in {"cls_preds": (1, 8, 6), "mask_preds": (1, 3, 8, 8, 12)}.items():
        v = out[k][-1]
        assert v.shape == shape and v.dtype == torch.bfloat16
        assert torch.isfinite(v.float()).all(), k
    res = TubeLinkVISInference(model, clip_len=3, topk=10).run_video(x)
    assert res["masks"].shape == (10, 7, 8, 12)
    assert np.isfinite(res["masks"]).all()
    assert ((res["labels"] >= 0) & (res["labels"] < 5)).all()
    assert np.all(res["scores"][:-1] >= res["scores"][1:])


@pytest.mark.parametrize("arch,yaml,classes", [
    ("TubeLinkVPS", "vipseg/tube_link_vps_r50.yaml", 58 + 66 + 1),
    ("TubeLinkVideoVIS", "ytvis21/tube_link_maxtron_cc_r50.yaml", 40 + 1),
    ("ImageMask2Former", "image/mask2former_r50_coco_panoptic_50e.yaml",
     80 + 53 + 1)])
def test_inference_only_architectures(arch, yaml, classes, tmp_path):
    """The registry builds the other Tube-Link models and the image
    Mask2Former (here on the CPU, an R18 backbone), with the Tube-Link
    criterion; the registry and each model's builder default to the card;
    ``Trainer`` refuses to train them, naming the architecture; and none of
    it imports JAX or the JAX package (run in a process where they are
    unimportable)."""
    code = f"""
import inspect, sys
for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax'):
    sys.modules[m] = None
import torch
from axial_vs_tpu_torch.config import load_config
from axial_vs_tpu_torch.engine.trainer import Trainer
from axial_vs_tpu_torch.models import build
from axial_vs_tpu_torch.models.tube_link.criterion import TubeLinkCriterion

cuda = torch.device('cuda')
builder = build._tube_link_builders()[{arch!r}]
for fn in (build.build_model_and_criterion, builder):
    assert inspect.signature(fn).parameters['device'].default == cuda
cfg = load_config({yaml!r}, ['model.backbone.name', 'resnet18',
                            'model.backbone.resnet.depth', 18,
                            'output_dir', {str(tmp_path)!r}])
model, crit = build.build_model_and_criterion(
    cfg, train=False, device=torch.device('cpu'),
    generator=torch.Generator().manual_seed(0))
assert type(model).__name__ == {arch!r} and not model.training
assert isinstance(crit, TubeLinkCriterion) and not crit.exact_matching
head = getattr(model, 'head', None) or model.wc_head_wrapper
assert head.cls_embed.weight.shape[0] == {classes}
try:
    Trainer(cfg, device=torch.device('cpu'))
except NotImplementedError as e:
    assert {arch!r} in str(e), e
else:
    raise AssertionError('Trainer took ' + {arch!r})
assert not any(k == 'axial_vs_tpu' or k.startswith('axial_vs_tpu.')
               for k in sys.modules), 'the JAX package was imported'
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_evaluate_ytvis_refuses_other_models():
    """``evaluate_ytvis`` runs ``TubeLinkVISInference``: another model is
    refused, named, before any data is read."""
    from axial_vs_tpu_torch.engine.evaluator_loop import evaluate_ytvis

    with pytest.raises(NotImplementedError, match="Module"):
        evaluate_ytvis(None, torch.nn.Module())


def test_tube_link_trainer_refuses_to_train(tmp_path):
    """A Tube-Link VIS config builds with its criterion (the Tube-Link
    losses, matched by the device auction) and trains; without a training
    set ``Trainer.train`` refuses, naming the missing data, rather than
    step on nothing."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.engine.trainer import Trainer
    from axial_vs_tpu_torch.models.tube_link.criterion import TubeLinkCriterion
    from axial_vs_tpu_torch.models.tube_link.detector import TubeLinkVIS

    cfg = load_config("ytvis19/tube_link_r50.yaml", [
        "model.backbone.name", "resnet18", "model.backbone.resnet.depth", 18,
        "model.tube_link.num_queries", 8, "model.tube_link.feat_channels",
        32, "model.tube_link.out_channels", 32,
        "model.tube_link.num_decoder_layers", 1, "datasets.train", [],
        "output_dir", str(tmp_path)])
    trainer = Trainer(cfg, device=torch.device("cpu"))
    assert isinstance(trainer.model, TubeLinkVIS)
    assert isinstance(trainer.criterion, TubeLinkCriterion)
    assert not trainer.criterion.exact_matching
    with pytest.raises(RuntimeError, match="no training data"):
        trainer.train()
    assert trainer.step == 0


def test_cli_refuses_coco_evaluation(tmp_path, monkeypatch):
    """``train_net_video --eval-only`` on a COCO-format panoptic test set
    (``configs/coco/kmax_r50.yaml`` cut to an R18 at small widths) builds
    the image model with its COCO mapper and sends the set through
    ``Trainer.evaluate`` to ``evaluate_coco_panoptic``: its PQ dict. The
    same config without ``--eval-only`` refuses to train, naming the
    mapper: image training is not ported."""
    from axial_vs_tpu_torch.engine import evaluator_loop
    from axial_vs_tpu_torch.tools import train_net_video

    name = write_tiny_coco(tmp_path, "coco_guards_tiny")
    calls = []
    real = evaluator_loop.evaluate_coco_panoptic

    def counted(cfg, model, **kwargs):
        calls.append(type(model).__name__)
        return real(cfg, model, **kwargs)

    monkeypatch.setattr(evaluator_loop, "evaluate_coco_panoptic", counted)
    argv = ["--config-file", "coco/kmax_r50.yaml", "--device", "cpu",
            "--opts", "model.backbone.name", "resnet18",
            "model.backbone.resnet.depth", "18", "model.num_classes", "2",
            "model.kmax.pixel_dec.dec_layers", "[1,1,1,1]",
            "model.kmax.pixel_dec.dec_channels", "[32,16,16,16]",
            "model.kmax.trans_dec.dec_layers", "[1,1,1]",
            "model.kmax.trans_dec.num_object_queries", "8",
            "input.image_size", "[33,33]", "datasets.train", f"[{name}]",
            "datasets.test", f"[{name}]", "output_dir", str(tmp_path / "out")]
    res = train_net_video.main(["--eval-only"] + argv)
    assert calls == ["KMaXSegmenter"]
    assert set(res) == {"all", "things", "stuff", "per_class"}
    assert res["all"]["n"] == 2 and 0.0 <= res["all"]["pq"] <= 1.0
    with pytest.raises(NotImplementedError, match="coco_panoptic"):
        train_net_video.main(argv)
    assert calls == ["KMaXSegmenter"]
