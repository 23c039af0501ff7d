"""Parity of the PyTorch port (axial_vs_tpu_torch) with the JAX package.

The same inputs, made with numpy from a seed, go through each JAX module and
its port counterpart, with every parameter and BatchNorm statistic
randomized (the upstream inits would hide whole branches: layer-scale 1e-6,
zero-init residual BN gammas, zero-init deformable offsets) and carried to
the port by ``axial_vs_tpu_torch/utils/convert.py``. Everything runs in f32
on the CPU, where the JAX package runs its XLA branches and the port's
kernel wrappers take their plain versions.

Tolerances: each module agrees to f32 rounding, so ``TOL_MODULE`` = 1e-5
relative to the output scale; the whole segmenter is held to
``test_full_transplant.py``'s 2e-3 of the output scale.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from axial_vs_tpu_torch.utils import convert

TOL_MODULE = 1e-5
TOL_SLICE = 2e-3
#: torch's intra-op threads while a port test file runs (the autouse
#: fixture ``torch_threads``, which a file takes by importing it). The
#: suite runs in 6 processes on 8 cores, where torch's default of a thread
#: a core in each process oversubscribes the CPU: the port's files took
#: 936.79 s of wall time so and 251.58-289.23 s with this fixture (8 cores,
#: -n 6 --dist loadfile, a cold JAX cache). ``test_torch_eval.py`` keeps
#: the default: its panoptic ids' agreement with JAX's (0.999 of the
#: pixels) was measured there, and falls to 0.99884 at 2 threads.
TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """The module's tests run with ``TORCH_THREADS`` intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def numpy_lsap():
    """JAX's exact matcher (``axial_vs_tpu/ops/hungarian.py``) runs scipy in
    a ``jax.pure_callback``, whose arguments arrive as ``jax.Array``s: its
    indexing then dispatches JAX ops from the callback's thread, which can
    deadlock with the main thread's dispatch (a hung
    ``test_torch_train.py::test_criterion_terms_match_jax``, both threads
    in JAX's indexing). The module's tests run the same callback on numpy
    copies of its arguments, as a file takes it by importing it."""
    import axial_vs_tpu.ops.hungarian as jax_hungarian

    real = jax_hungarian._lsap_host
    jax_hungarian._lsap_host = lambda cost, valid: real(np.asarray(cost),
                                                        np.asarray(valid))
    yield
    jax_hungarian._lsap_host = real


def randomize(shapes, seed, scale=0.1):
    """Random numpy values for a flax variable tree: BN variances in
    [0.5, 1.5), everything else N(0, scale^2)."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        return (rng.randn(*s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_init(module, *args, seed=0, **kwargs):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return randomize(shapes, seed)


def jax_apply(module, variables, *args, **kwargs):
    fn = jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))
    return jax.tree.map(np.asarray, fn(jax.tree.map(jnp.asarray, variables),
                                        *args))


def port(module, state_dict):
    return convert.load_into(module, state_dict).eval()


def close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- numerics --

@pytest.mark.parametrize("kind", ["batchnorm", "layernorm", "groupnorm"])
def test_norms(rng, kind):
    from axial_vs_tpu.ops import norm as jn
    from axial_vs_tpu_torch.ops import norm as tn

    c = 64
    x = rng.randn(2, 5, 7, c).astype(np.float32) * 2 + 0.5
    jm, tm = {
        "batchnorm": (jn.BatchNorm(c), tn.BatchNorm(c)),
        "layernorm": (jn.LayerNorm(c, epsilon=1e-6), tn.LayerNorm(c, 1e-6)),
        "groupnorm": (jn.GroupNorm(c, 32), tn.GroupNorm(c, 32)),
    }[kind]
    v = jax_init(jm, jnp.asarray(x))
    sd = (convert._bn(v["params"], v["batch_stats"]) if kind == "batchnorm"
          else convert._norm(v["params"]))
    want = jax_apply(jm, v, jnp.asarray(x))
    close(port(tm, sd)(t(x)), want, TOL_MODULE)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", [((4, 6), (13, 17)), ((9, 7), (4, 3))])
def test_resize_and_gelu(rng, align_corners, in_hw, out_hw):
    from axial_vs_tpu.ops.act import gelu as jgelu
    from axial_vs_tpu.ops.resize import resize_bilinear as jresize
    from axial_vs_tpu_torch.ops.act import gelu
    from axial_vs_tpu_torch.ops.resize import resize_bilinear

    x = rng.randn(2, *in_hw, 3).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), out_hw, align_corners=align_corners))
    close(resize_bilinear(t(x), out_hw, align_corners=align_corners), want,
          TOL_MODULE)
    close(gelu(t(x)), np.asarray(jgelu(jnp.asarray(x))), TOL_MODULE)


def test_position_embeddings():
    from axial_vs_tpu.layers import position_embeddings as jp
    from axial_vs_tpu_torch.layers import position_embeddings as tp

    close(tp.position_embedding_sine_2d(5, 7, 16),
          jp.position_embedding_sine_2d(5, 7, 16), TOL_MODULE)
    close(tp.position_embedding_sine_3d(3, 5, 7, 16),
          jp.position_embedding_sine_3d(3, 5, 7, 16), TOL_MODULE)


# ------------------------------------------------ ConvNeXt (kernel K1 path) --

@pytest.mark.parametrize("shape", [(2, 9, 13, 32), (1, 5, 7, 48)])
def test_convnext_block(rng, shape):
    from axial_vs_tpu.models.backbones.convnext import ConvNeXtBlock as J
    from axial_vs_tpu_torch.models.backbones.convnext import ConvNeXtBlock

    x = rng.randn(*shape).astype(np.float32)
    jm = J(dim=shape[-1])
    v = jax_init(jm, jnp.asarray(x))
    want = jax_apply(jm, v, jnp.asarray(x), train=False)
    got = port(ConvNeXtBlock(shape[-1]), convert.convnext_block(v["params"]))
    close(got(t(x)), want, TOL_MODULE)


def test_convnext_backbone_scan_stacked(rng):
    """The bench's scan-stacked ConvNeXt tree, unstacked by the converter;
    a 65x97 input exercises the VALID stem's dropped border."""
    from axial_vs_tpu.models.backbones.convnext import ConvNeXt as J
    from axial_vs_tpu_torch.models.backbones.convnext import ConvNeXt

    depths, dims = (2, 1, 1, 1), (32, 64, 96, 128)
    x = rng.randn(2, 65, 97, 3).astype(np.float32)
    jm = J(depths=depths, dims=dims, use_scan=True)
    v = jax_init(jm, jnp.asarray(x))
    assert "stage0_blocks" in v["params"]
    want = jax_apply(jm, v, jnp.asarray(x), train=False)
    got = port(ConvNeXt(depths, dims), convert.convnext(v["params"]))(t(x))
    assert want["res2"].shape == (2, 16, 24, 32)
    for k in want:
        close(got[k], want[k], TOL_MODULE)


# ------------------------------------------------------ MSDA (kernel K2) ----

@pytest.mark.parametrize("seed", [0, 1])
def test_ms_deform_attn_op(seed):
    """Locations straddle [-0.2, 1.2], so border and out-of-level corners
    are exercised (zero padding)."""
    from axial_vs_tpu.ops.msda import ms_deform_attn as jmsda
    from axial_vs_tpu_torch.ops.msda import level_start_index, ms_deform_attn

    rng = np.random.RandomState(seed)
    b, m, d, p, lq = 2, 4, 8, 3, 19
    shapes = ((2, 3), (4, 6), (7, 9))
    s = sum(h * w for h, w in shapes)
    value = rng.randn(b, s, m, d).astype(np.float32)
    locs = (rng.rand(b, lq, m, len(shapes), p, 2) * 1.4 - 0.2).astype(np.float32)
    w = rng.rand(b, lq, m, len(shapes), p).astype(np.float32)
    want = jmsda(jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(w))
    got = ms_deform_attn(t(value), shapes, level_start_index(shapes), t(locs),
                         t(w))
    close(got, want, TOL_MODULE)


def test_msdeform_attn_module(rng):
    from axial_vs_tpu.layers.msda_attention import MSDeformAttn as J
    from axial_vs_tpu_torch.layers.msda_attention import MSDeformAttn

    shapes = ((2, 3), (4, 6), (8, 12))
    s = sum(h * w for h, w in shapes)
    q = rng.randn(2, s, 64).astype(np.float32)
    x = rng.randn(2, s, 64).astype(np.float32)
    jm = J(d_model=64, n_levels=3, n_heads=8, n_points=4)
    v = jax_init(jm, jnp.asarray(q), jnp.asarray(x), shapes)
    # offsets of several pixels: many samples leave their level
    so = v["params"]["sampling_offsets"]
    so["bias"] = (rng.randn(*so["bias"].shape) * 3).astype(np.float32)
    want = jax_apply(jm, v, jnp.asarray(q), jnp.asarray(x), spatial_shapes=shapes)
    got = port(MSDeformAttn(64, 3, 8, 4), convert.msdeform_attn(v["params"]))
    close(got(t(q), t(x), shapes), want, TOL_MODULE)


# ------------------------------------------- trajectory attention, WC module --

@pytest.mark.parametrize("part", ["attention", "encoder"])
def test_trajectory_attention(rng, part):
    from axial_vs_tpu.layers import trajectory_attention as jt
    from axial_vs_tpu_torch.layers import trajectory_attention as tt
    from axial_vs_tpu_torch.layers.position_embeddings import (
        position_embedding_sine_3d)

    f, h, w, c = 2, 3, 5, 64
    if part == "attention":
        q = rng.randn(4, f * h, c).astype(np.float32)
        k = rng.randn(4, f * h, c).astype(np.float32)
        val = rng.randn(4, f * h, c).astype(np.float32)
        jm = jt.TrajectoryAttention(dim=c, num_heads=8)
        args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(val))
        v = jax_init(jm, *args, num_frames=f)
        want = jax_apply(jm, v, *args, num_frames=f)
        got = port(tt.TrajectoryAttention(c, 8),
                   convert.trajectory_attention(v["params"]))
        close(got(t(q), t(k), t(val), num_frames=f), want, TOL_MODULE)
    else:
        src = rng.randn(2 * f, h * w, c).astype(np.float32)
        pos = position_embedding_sine_3d(f, h, w, c // 2).numpy()
        jm = jt.TemporalEncoder(d_model=c, d_ffn=96, num_heads=8, num_layers=2)
        args = (jnp.asarray(src), jnp.asarray(pos))
        kw = dict(num_frames=f, height=h, width=w)
        v = jax_init(jm, *args, **kw)
        want = jax_apply(jm, v, *args, **kw)[0]
        got = port(tt.TemporalEncoder(c, 96, 8, 2),
                   convert.temporal_encoder(v["params"]))
        close(got(t(src), t(pos), f, h, w), want, TOL_MODULE)


@pytest.mark.parametrize("temporal_layers", [4, 0])
def test_wc_module(rng, temporal_layers):
    """Both stages with their temporal encoders, and the spatial-only
    variant (temporal_layers=0)."""
    from axial_vs_tpu.models.wc_module import WithinClipTrackingModule as J
    from axial_vs_tpu_torch.models.wc_module import WithinClipTrackingModule

    f = 2
    chans = {"res3": 64, "res4": 96, "res5": 128}
    sizes = {"res3": (8, 12), "res4": (4, 6), "res5": (2, 3)}
    feats = {k: rng.randn(2 * f, *sizes[k], chans[k]).astype(np.float32)
             for k in chans}
    kw = dict(conv_dims=64, nheads=8, dim_feedforward=96, num_stages=2,
              spatial_layers=2, temporal_layers=temporal_layers, num_frames=f)
    jm = J(**kw)
    jfeats = {k: jnp.asarray(x) for k, x in feats.items()}
    v = jax_init(jm, jfeats, train=False)
    want = jax_apply(jm, v, jfeats, train=False)[0]
    got = port(WithinClipTrackingModule(chans, **kw),
               convert.wc_module(v["params"]))({k: t(x) for k, x in feats.items()})
    for k in chans:
        close(got[k], want[k], TOL_MODULE)


# ---------------------------------------- axial attention, pixel decoder ----

def test_axial_attention_2d(rng):
    from axial_vs_tpu.layers.axial_attention import AxialAttention2D as J
    from axial_vs_tpu_torch.layers.axial_attention import AxialAttention2D

    x = rng.randn(2, 5, 7, 24).astype(np.float32)
    jm = J(query_shape=(5, 7), filters=16, num_heads=8)
    v = jax_init(jm, jnp.asarray(x), train=False)
    want = jax_apply(jm, v, jnp.asarray(x), train=False)
    sd = {}
    for axis in ("height_axis", "width_axis"):
        sd.update(convert._prefix(f"_{axis}", convert.axial_attention(
            v["params"][axis], v["batch_stats"][axis])))
    close(port(AxialAttention2D(24, filters=16), sd)(t(x)), want, TOL_MODULE)


def test_pixel_decoder(rng):
    from axial_vs_tpu.models.pixel_decoder import KMaXPixelDecoder as J
    from axial_vs_tpu_torch.models.pixel_decoder import KMaXPixelDecoder

    chans = {"res2": 32, "res3": 64, "res4": 96, "res5": 128}
    sizes = {"res2": (16, 24), "res3": (8, 12), "res4": (4, 6), "res5": (2, 3)}
    feats = {k: rng.randn(2, *sizes[k], chans[k]).astype(np.float32)
             for k in chans}
    kw = dict(dec_layers=(1, 2, 1, 1), dec_channels=(32, 16, 16, 16),
              layer_types=("axial", "axial", "bottleneck", "bottleneck"))
    jm = J(spatial_shape=(65, 97), **kw)
    jfeats = {k: jnp.asarray(x) for k, x in feats.items()}
    v = jax_init(jm, jfeats, train=False)
    pano, sem, ms = jax_apply(jm, v, jfeats, train=False)
    got = port(KMaXPixelDecoder(chans, **kw), convert.pixel_decoder(
        v["params"], v["batch_stats"]))({k: t(x) for k, x in feats.items()})
    close(got[0], pano, TOL_MODULE)
    assert len(got[1]) == len(sem) == len(got[2]) == len(ms) == 3
    for g, w in zip(got[1] + got[2], list(sem) + list(ms)):
        close(g, w, TOL_MODULE)


# ------------------------------------------------------ transformer decoder --

def test_transformer_decoder(rng):
    from axial_vs_tpu.models.transformer_decoder import (
        KMaXTransformerDecoder as J)
    from axial_vs_tpu_torch.models.transformer_decoder import (
        KMaXTransformerDecoder)

    f, b = 2, 1
    chans = (64, 48, 32)
    hw = ((2, 3), (4, 6), (8, 12))
    ms = [rng.randn(b * f, *s, c).astype(np.float32) for s, c in zip(hw, chans)]
    pano = rng.randn(b * f, 16, 24, 24).astype(np.float32)
    jm = J(num_classes=6, dec_layers=(1, 1, 1), num_queries=16, num_frames=f)
    jargs = ([jnp.asarray(x) for x in ms], jnp.asarray(pano), None)
    v = jax_init(jm, *jargs, train=False)
    want = jax_apply(jm, v, *jargs, train=False)
    got = port(KMaXTransformerDecoder(6, chans, 24, (1, 1, 1), 16, f),
               convert.transformer_decoder(v["params"], v["batch_stats"]))
    got = got([t(x) for x in ms], t(pano))
    for k in ("pred_logits", "pred_masks", "pred_mask_embeddings",
              "cluster_centers"):
        close(got[k], want[k], TOL_MODULE)
    for ga, wa in zip(got["aux_outputs"], want["aux_outputs"]):
        for k in ("pred_logits", "pred_masks", "pixel_feature"):
            close(ga[k], wa[k], TOL_MODULE)


# ------------------------------------------------------- the whole slice ----

def small_config():
    """The bench's WC ConvNeXt configuration, cut to small widths."""
    from axial_vs_tpu.config import get_default_config

    cfg = get_default_config()
    cfg.model.backbone.name = "convnext_small_test"
    c = cfg.model.backbone.convnext
    c.depths, c.dims, c.drop_path_rate = [1, 1, 1, 1], [32, 64, 96, 128], 0.0
    c.use_scan = True
    cfg.model.num_classes = 7
    cfg.input.image_size = [65, 97]
    cfg.input.num_clip_frames = 2
    w = cfg.model.maxtron.wc
    w.enable, w.conv_dims, w.dim_feedforward = True, 64, 96
    cfg.model.kmax.pixel_dec.dec_layers = [1, 1, 1, 1]
    cfg.model.kmax.pixel_dec.dec_channels = [32, 16, 16, 16]
    cfg.model.kmax.trans_dec.dec_layers = [1, 1, 1]
    cfg.model.kmax.trans_dec.num_object_queries = 16
    return cfg


def test_segmenter(rng):
    from axial_vs_tpu.models.kmax import build_segmenter as jax_build
    from axial_vs_tpu_torch.models.kmax import build_segmenter

    cfg = small_config()
    jm = jax_build(cfg, num_frames=2, train=False)
    x = rng.randn(4, 65, 97, 3).astype(np.float32)
    v = jax_init(jm, jnp.asarray(x), train=False)
    want = jax_apply(jm, v, jnp.asarray(x), train=False)
    model = build_segmenter(cfg, torch.device("cpu"),
                            torch.Generator().manual_seed(0), num_frames=2)
    with torch.no_grad():
        got = port(model, convert.convert_variables(v))(t(x))
    assert got["pred_masks"].shape == (2, 2, 16, 24, 16)
    for k in ("pred_logits", "pred_masks", "pred_mask_embeddings"):
        close(got[k], want[k], TOL_SLICE)


def test_segmenter_resnet(rng):
    """The WC segmenter with a ResNet backbone (``bench.py --backbone
    resnet50``'s family), here R18 at small widths: no K1 on this path."""
    from axial_vs_tpu.models.kmax import build_segmenter as jax_build
    from axial_vs_tpu_torch.models.kmax import build_segmenter

    cfg = small_config()
    cfg.model.backbone.name = "resnet18"
    cfg.model.backbone.resnet.depth = 18
    jm = jax_build(cfg, num_frames=2, train=False)
    x = rng.randn(4, 65, 97, 3).astype(np.float32)
    v = jax_init(jm, jnp.asarray(x), train=False)
    want = jax_apply(jm, v, jnp.asarray(x), train=False)
    model = build_segmenter(cfg, torch.device("cpu"),
                            torch.Generator().manual_seed(0), num_frames=2)
    with torch.no_grad():
        got = port(model, convert.convert_variables(v))(t(x))
    assert got["pred_masks"].shape == (2, 2, 17, 25, 16)
    for k in ("pred_logits", "pred_masks", "pred_mask_embeddings"):
        close(got[k], want[k], TOL_SLICE)


# ------------------- K1, K4, K5 in bf16 against the Pallas kernels ---------
#
# The JAX package's kernels run in Pallas interpret mode on the CPU (about
# 1.5 s per call at these shapes) and are the oracle of the port's plain
# versions, which the card's kernels are held to in chip_smoke.py and
# tests/test_torch_cuda.py. Weights are drawn bf16-exact, since the port
# keeps every matrix (the depthwise taps too) bf16 at rest. Tolerance: both
# sides accumulate in f32 and round at the same points, so they agree to 2
# bf16 ulp of max|out| (TOL_ULPS); a bf16 cast of an intermediate that rounds
# the other way moves the output by far less than one of its ulps.

TOL_ULPS = 2


def bf16_exact(a):
    """f32 values that bf16 represents exactly (round to nearest)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def bf16_ulp(scale):
    return 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)


def close_ulps(got, want, ulps=TOL_ULPS):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = ulps * bf16_ulp(float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)
    return bound


def interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def block_params(rng, c, hidden=None, gamma=0.5):
    """A ConvNeXt block's parameters in the JAX layouts, bf16-exact, at
    scales where every part of the block moves the output: unit-variance
    MLP weights, LayerNorm scale ~1, layer scale ``gamma``."""
    hidden = hidden or 4 * c
    r = lambda *s, scale=0.1: bf16_exact(rng.randn(*s) * scale)  # noqa: E731
    return dict(
        dwconv={"kernel": r(7, 7, 1, c), "bias": r(c)},
        norm={"scale": 1 + r(c), "bias": r(c)},
        pwconv1={"kernel": r(c, hidden, scale=c ** -0.5), "bias": r(hidden)},
        pwconv2={"kernel": r(hidden, c, scale=hidden ** -0.5), "bias": r(c)},
        gamma=np.full(c, gamma, np.float32) if np.isscalar(gamma) else gamma)


@pytest.mark.parametrize("p,c", [(70, 32), (203, 48)])
def test_convnext_mlp_residual_matches_pallas(rng, p, c):
    """K5's plain version against the Pallas kernel, with a ragged row tail
    and the hidden axis in several chunks."""
    from axial_vs_tpu.ops.convnext_pallas import convnext_mlp_residual as jk
    from axial_vs_tpu_torch.ops.convnext_cuda import (
        convnext_mlp_residual, convnext_mlp_residual_plain)

    x, sc = (bf16_exact(rng.randn(p, c)) for _ in range(2))
    w = block_params(rng, c, gamma=bf16_exact(rng.rand(c) * 2 - 1))
    w1, b1 = w["pwconv1"]["kernel"], w["pwconv1"]["bias"]
    w2, b2 = w["pwconv2"]["kernel"], w["pwconv2"]["bias"]
    with interpret():
        want = jk(jnp.asarray(x, jnp.bfloat16), jnp.asarray(sc, jnp.bfloat16),
                  w1, b1, w2, b2, w["gamma"], rows=32, hidden_chunk=64)
    want = np.asarray(want.astype(jnp.float32))
    args = (t(x).bfloat16(), t(sc).bfloat16(), t(w1.T.copy()), t(b1),
            t(w2.T.copy()), t(b2), t(w["gamma"]))
    got = convnext_mlp_residual_plain(*args)
    assert got.dtype == torch.bfloat16
    bound = close_ulps(got, want)
    assert np.abs(want - sc).max() > 10 * bound  # the MLP is visible
    torch.testing.assert_close(convnext_mlp_residual(*args), got, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 9, 13, 32), (1, 5, 7, 48)])
def test_dwconv_and_block_match_pallas(rng, shape):
    """K1's and K4's plain versions against the Pallas kernels in bf16
    (K1's rounding points were held only against the f32 XLA branch
    before), at H and W that do not fill the kernels' tiles."""
    from axial_vs_tpu.ops.convnext_pallas import (
        convnext_block_fused as jblock, dwconv7x7_layernorm as jdwln)
    from axial_vs_tpu_torch.ops.convnext_cuda import (
        convnext_block_fused_plain, dwconv7x7_layernorm_plain)

    c = shape[-1]
    x = bf16_exact(rng.randn(*shape))
    w = block_params(rng, c, gamma=bf16_exact(rng.rand(c) * 2 - 1))
    jargs = (w["dwconv"]["kernel"], w["dwconv"]["bias"], w["norm"]["scale"],
             w["norm"]["bias"])
    mlp = (w["pwconv1"]["kernel"], w["pwconv1"]["bias"], w["pwconv2"]["kernel"],
           w["pwconv2"]["bias"], w["gamma"])
    with interpret():
        xb = jnp.asarray(x, jnp.bfloat16)
        want_dwln = np.asarray(jdwln(xb, *jargs).astype(jnp.float32))
        want_block = np.asarray(jblock(xb, *jargs, *mlp, hidden_chunk=64)
                                .astype(jnp.float32))
    dw = (t(w["dwconv"]["kernel"].transpose(3, 2, 0, 1).copy()),
          t(w["dwconv"]["bias"]), t(w["norm"]["scale"]), t(w["norm"]["bias"]))
    tmlp = (t(mlp[0].T.copy()), t(mlp[1]), t(mlp[2].T.copy()), t(mlp[3]),
            t(mlp[4]))
    close_ulps(dwconv7x7_layernorm_plain(t(x).bfloat16(), *dw), want_dwln)
    bound = close_ulps(convnext_block_fused_plain(t(x).bfloat16(), *dw, *tmlp),
                       want_block)
    assert np.abs(want_block - x).max() > 10 * bound


def _fused_routes(monkeypatch, route):
    """Turn the JAX ConvNeXt block's Pallas routes on, as on a TPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setenv("AXIALVS_FUSED_DWLN", "1")
    monkeypatch.setenv("AXIALVS_FUSED_MLP", "1" if route == "mlp" else "0")
    monkeypatch.setenv("AXIALVS_FUSED_BLOCK", "1" if route == "block" else "0")


def _bf16_tree(tree, rng):
    """Every leaf bf16-exact; ConvNeXt blocks get block_params' scales and
    LayerNorm scales are ~1."""
    def walk(d):
        if "pwconv1" in d and "dwconv" in d:
            c = np.asarray(d["norm"]["scale"]).shape[0]
            return block_params(rng, c)
        return {k: walk(v) if isinstance(v, dict)
                else bf16_exact(1 + v if k == "scale" else v)
                for k, v in d.items()}
    return walk(tree)


@pytest.mark.parametrize("route", ["dwln", "mlp", "block"])
def test_convnext_block_routes_match_jax(rng, monkeypatch, route):
    """The port's ConvNeXtBlock on each ``block_kernel`` route against the
    JAX block on the same route (its env gates, its Pallas kernels in
    interpret mode), bf16 input, gamma 0.5."""
    from axial_vs_tpu.models.backbones.convnext import ConvNeXtBlock as J
    from axial_vs_tpu_torch.models.backbones.convnext import ConvNeXtBlock
    from axial_vs_tpu_torch.ops.init import cast_for_inference

    _fused_routes(monkeypatch, route)
    shape = (2, 9, 13, 32)
    x = bf16_exact(rng.randn(*shape))
    jm = J(dim=shape[-1], dtype=jnp.bfloat16)
    params = block_params(rng, shape[-1])
    with interpret():
        want = jm.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    model = port(ConvNeXtBlock(shape[-1], block_kernel=route),
                 convert.convnext_block(params))
    cast_for_inference(model, torch.bfloat16)
    with torch.no_grad():
        got = model(t(x).bfloat16())
    bound = close_ulps(got, want)
    assert np.abs(want - x).max() > 10 * bound


#: the backbone's bound, of each output's scale. The stem here is exact in
#: bf16 on both sides, so res2 agrees to TOL_ULPS on the fused routes; from
#: res3 on, the two frameworks' bf16 downsampling convs (2x2/2 over 4C
#: inputs, outside the kernels) round differently, and that drift alone
#: reached 1.4e-2 of scale at res4 in this test.
TOL_BACKBONE = 2e-2


@pytest.mark.parametrize("route", ["dwln", "mlp", "block"])
def test_convnext_backbone_routes_match_jax(rng, monkeypatch, route):
    """A depth-1/1/1/1 ConvNeXt on each route against the JAX backbone, in
    bf16 with gamma 0.5."""
    from axial_vs_tpu.models.backbones.convnext import ConvNeXt as J
    from axial_vs_tpu_torch.models.backbones.convnext import ConvNeXt
    from axial_vs_tpu_torch.ops.init import cast_for_inference

    _fused_routes(monkeypatch, route)
    depths, dims = (1, 1, 1, 1), (32, 48, 64, 80)
    # multiples of 1/8 and stem taps in {0, +-1/32}: the JAX stem sums four
    # bf16 partial products and rounds each; with these values every partial
    # sum is exact in bf16
    x = np.clip(np.round(rng.randn(2, 65, 97, 3) * 4), -8, 8) / 8
    jm = J(depths=depths, dims=dims, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x, jnp.bfloat16)))
    params = _bf16_tree(jax.tree.map(
        lambda s: np.asarray(rng.randn(*s.shape) * 0.1, np.float32),
        shapes["params"]), rng)
    stem = params["downsample0_conv"]
    stem["kernel"] = (rng.randint(-1, 2, stem["kernel"].shape) / 32).astype(np.float32)
    with interpret():
        want = jm.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    model = port(ConvNeXt(depths, dims, block_kernel=route),
                 convert.convnext(params))
    cast_for_inference(model, torch.bfloat16)
    with torch.no_grad():
        got = model(t(x).float().bfloat16())
    for k in want:
        w = np.asarray(want[k].astype(jnp.float32))
        g = got[k].float().numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= TOL_BACKBONE * np.abs(w).max(), k
        if k == "res2" and route != "dwln":
            close_ulps(g, w)
