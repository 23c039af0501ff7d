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
    pano, _, ms = jax_apply(jm, v, jfeats, train=False)
    got = port(KMaXPixelDecoder(chans, **kw), convert.pixel_decoder(
        v["params"], v["batch_stats"]))({k: t(x) for k, x in feats.items()})
    close(got[0], pano, TOL_MODULE)
    assert len(got[1]) == len(ms) == 3
    for g, w in zip(got[1], ms):
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
