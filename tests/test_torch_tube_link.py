"""Parity of the port's Tube-Link VIS path (axial_vs_tpu_torch) with the JAX
package: kernel K3's plain version, the ResNet backbone, the fused
MSDA + trajectory pixel decoder, the Mask2Former tube head, the whole
detector and its whole-video inference.

As in ``test_torch_parity.py``: the same numpy inputs go through each JAX
module and its port, with every parameter and BatchNorm statistic
randomized (so the pixel decoder's ``gamma``, 1e-6 at init, lets the
temporal branch reach the outputs), carried over by
``axial_vs_tpu_torch/utils/convert.py``, in f32 on the CPU. Tolerances:
1e-5 of scale per module, 2e-3 for the whole model; K3's plain version
against the interpret-mode Pallas kernel at ``tests/test_traj_pallas.py``'s
2e-3.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from axial_vs_tpu.utils.torch_convert import convert_torchvision_resnet
from axial_vs_tpu_torch.utils import convert
from test_torch_parity import (TOL_MODULE, TOL_SLICE, close, jax_apply,
                               jax_init, port, t)
from test_torch_parity import torch_threads  # noqa: F401 (autouse)

CHANS_R18 = {"res2": 64, "res3": 128, "res4": 256, "res5": 512}


# ------------------------------------------------------ kernel K3 (plain) ----

def _traj_args(rng, b, f, n, c):
    q, k, v = (rng.randn(b, f * n, c).astype(np.float32) for _ in range(3))
    wq = (rng.randn(c, c) * 0.05).astype(np.float32)
    bq = (rng.randn(c) * 0.05).astype(np.float32)
    wkv = (rng.randn(c, 2 * c) * 0.05).astype(np.float32)
    bkv = (rng.randn(2 * c) * 0.05).astype(np.float32)
    return q, k, v, wq, bq, wkv, bkv


def _port_traj(q, k, v, wq, bq, wkv, bkv, f, h):
    """The port's wrapper on CPU tensors; weights to torch's (out, in)."""
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core

    return trajectory_attention_core(t(q), t(k), t(v), t(wq.T.copy()), t(bq),
                                     t(wkv.T.copy()), t(bkv), f, h)


@pytest.mark.parametrize("b,f,n,h,d", [(3, 5, 23, 8, 32), (2, 2, 43, 8, 32),
                                       (3, 5, 23, 8, 8), (3, 5, 23, 4, 16)])
def test_traj_core_matches_jax_math(rng, b, f, n, h, d):
    from axial_vs_tpu.ops.traj_pallas import _traj_math

    args = _traj_args(rng, b, f, n, h * d)
    want = _traj_math(*map(jnp.asarray, args), f, h, d ** -0.5)
    close(_port_traj(*args, f, h), want, TOL_MODULE)


@pytest.mark.parametrize("c,h", [(24, 3), (40, 5), (8, 1)])
def test_traj_core_refuses_channels_off_16(rng, c, h):
    """K3 takes C a multiple of 16 (its TMA row pitch and 16-column steps),
    on every device: the CPU's plain version refuses the same shapes."""
    args = _traj_args(rng, 2, 2, 5, c)
    with pytest.raises(ValueError, match="multiple of 16"):
        _port_traj(*args, 2, h)


def test_traj_core_matches_interpret_kernel(rng):
    from axial_vs_tpu.ops.traj_pallas import fused_trajectory_attention

    b, f, n, h, d = 2, 3, 7, 8, 32
    args = _traj_args(rng, b, f, n, h * d)
    want = fused_trajectory_attention(*map(jnp.asarray, args), f, h,
                                      d ** -0.5, True)
    np.testing.assert_allclose(_port_traj(*args, f, h).numpy(),
                               np.asarray(want), rtol=2e-3, atol=2e-3)


def test_traj_core_bf16_matches_interpret_kernel(rng):
    """The bf16 rounding points (probabilities, x, q2, k2, v2 and q2 * scale
    cast to bf16, biases added in bf16) at a ragged Tube-Link-like shape:
    N = 115 tokens, 8 heads of 32. The plain version against the Pallas
    kernel in interpret mode, both in bf16, within ``TRAJ_ULPS`` bf16 ulp of
    max|out| (f32 sums in other orders may round a cast the other way)."""
    from axial_vs_tpu.ops.traj_pallas import fused_trajectory_attention
    from axial_vs_tpu_torch.ops.traj import TRAJ_ULPS

    b, f, n, h, d = 2, 5, 23, 8, 32
    args = _traj_args(rng, b, f, n, h * d)
    want = fused_trajectory_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in args), f, h,
        d ** -0.5, True)
    want = np.asarray(want.astype(jnp.float32))
    q, k, v, wq, bq, wkv, bkv = (
        torch.from_numpy(np.ascontiguousarray(a)).bfloat16() for a in
        (*args[:3], args[3].T, args[4], args[5].T, args[6]))
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core

    got = trajectory_attention_core(q, k, v, wq, bq, wkv, bkv, f, h)
    assert got.dtype == torch.bfloat16 and got.shape == (b, f * n, h * d)
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert np.abs(got.float().numpy() - want).max() <= TRAJ_ULPS * ulp


# --------------------------------------------------------------- ResNet ----

@pytest.mark.parametrize("depth", [18, 50])
def test_resnet(rng, depth):
    """The port against JAX's ResNet on the same weights, and a round trip
    of the port state_dict through the JAX package's torchvision converter
    and ``convert.resnet``. 37x53 exercises odd sizes and the max-pool's
    -inf padding."""
    from axial_vs_tpu.models.backbones.resnet import ResNet as J
    from axial_vs_tpu_torch.models.backbones.resnet import ResNet

    x = rng.randn(1, 37, 53, 3).astype(np.float32)
    jm = J(depth=depth)
    v = jax_init(jm, jnp.asarray(x), train=False)
    want = jax_apply(jm, v, jnp.asarray(x), train=False)
    model = port(ResNet(depth), convert.resnet(v["params"], v["batch_stats"]))
    got = model(t(x))
    assert want["res5"].shape == (1, 2, 2, 2048 if depth == 50 else 512)
    for k in want:
        close(got[k], want[k], TOL_MODULE)
    sd = {k: x.numpy() for k, x in model.state_dict().items()}
    params, stats = convert_torchvision_resnet(sd, depth)
    back = convert.resnet(params, stats)
    assert sorted(back) == sorted(sd)
    for k, x in sd.items():
        np.testing.assert_array_equal(back[k], x, err_msg=k)


# ------------------------------------------------------------ pixel decoder --

def _features(rng, bt, chans, hw=(16, 24)):
    h, w = hw
    return {f"res{i + 2}": rng.randn(bt, h >> i, w >> i, c).astype(np.float32)
            for i, c in enumerate(chans.values())}


def test_fused_msda_trajectory_attention(rng):
    _check_fused_attention(rng, temporal=True)


def test_fused_msda_attention_without_temporal(rng):
    """The Tube-Link baseline's layer: deformable attention alone, no
    ``gamma`` and no ``temporal_encoder`` on either side."""
    _check_fused_attention(rng, temporal=False)


def _check_fused_attention(rng, temporal):
    from axial_vs_tpu.layers.position_embeddings import (
        position_embedding_sine_3d)
    from axial_vs_tpu.models.tube_link.pixel_decoder import (
        FusedMSDATrajectoryAttention as J)
    from axial_vs_tpu_torch.models.tube_link.pixel_decoder import (
        FusedMSDATrajectoryAttention)

    f, c = 3, 32
    shapes = ((2, 3), (4, 6), (8, 12))
    s = sum(h * w for h, w in shapes)
    query = rng.randn(f, s, c).astype(np.float32)
    pos = rng.randn(s, c).astype(np.float32)
    pos_3d = [np.asarray(position_embedding_sine_3d(f, h, w, c // 2))
              for h, w in shapes[:2]]
    kw = dict(embed_dims=c, num_temporal_dim=48, num_frames=f,
              use_temporal=temporal)
    jm = J(**kw)
    jargs = (jnp.asarray(query), jnp.asarray(pos),
             [jnp.asarray(p) for p in pos_3d], shapes)
    v = jax_init(jm, *jargs)
    want = jax_apply(jm, v, *jargs[:3], spatial_shapes=shapes)
    sd = convert.tube_link_pixel_decoder({"layer0_attn": v["params"]})
    sd = {k[len("layers.0.attn."):]: x for k, x in sd.items()}
    assert ("gamma" in sd) == temporal
    got = port(FusedMSDATrajectoryAttention(**kw), sd)
    close(got(t(query), t(pos), [t(p) for p in pos_3d], shapes), want,
          TOL_MODULE)


def test_tube_link_pixel_decoder(rng):
    from axial_vs_tpu.models.tube_link.pixel_decoder import (
        TubeLinkPixelDecoder as J)
    from axial_vs_tpu_torch.models.tube_link.pixel_decoder import (
        TubeLinkPixelDecoder)

    f = 3
    feats = _features(rng, f, CHANS_R18)
    jm = J(feat_channels=32, out_channels=32, num_encoder_layers=2,
           num_frames=f, ffn_dim=48)
    jfeats = {k: jnp.asarray(x) for k, x in feats.items()}
    v = jax_init(jm, jfeats)
    want_mask, want_outs = jax_apply(jm, v, jfeats)
    got = port(TubeLinkPixelDecoder(CHANS_R18, 32, 32, num_encoder_layers=2,
                                    num_frames=f, ffn_dim=48),
               convert.tube_link_pixel_decoder(v["params"]))
    mask, outs = got({k: t(x) for k, x in feats.items()})
    close(mask, want_mask, TOL_MODULE)
    assert len(outs) == len(want_outs) == 3
    for g, w in zip(outs, want_outs):
        close(g, w, TOL_MODULE)


def test_mask2former_head(rng):
    """The narrow head (32 channels, 8 queries, 3 layers) over two tubes,
    every layer's predictions and the final query."""
    from axial_vs_tpu.models.tube_link.head import (
        Mask2FormerVideoHeadTube as J)
    from axial_vs_tpu_torch.models.tube_link.head import (
        Mask2FormerVideoHeadTube)

    f = 2
    feats = _features(rng, 2 * f, CHANS_R18)
    kw = dict(num_things_classes=5, num_queries=8, feat_channels=32,
              out_channels=32, num_decoder_layers=3, num_heads=4, ffn_dim=64,
              num_frames=f)
    jm = J(**kw)
    jfeats = {k: jnp.asarray(x) for k, x in feats.items()}
    v = jax_init(jm, jfeats)
    want = jax_apply(jm, v, jfeats, return_query=True)
    got = port(Mask2FormerVideoHeadTube(CHANS_R18, **kw),
               convert.tube_link_head(v["params"]))
    got = got({k: t(x) for k, x in feats.items()}, return_query=True)
    assert len(got["cls_preds"]) == 4
    assert got["mask_preds"][-1].shape == (2, f, 8, 16, 24)
    for key in ("cls_preds", "mask_preds"):
        for g, w in zip(got[key], want[key]):
            close(g, w, TOL_MODULE)
    close(got["query"], want["query"], TOL_MODULE)


# ------------------------------------------------- detector, whole video ----

TUBE = 3  # frames per tube
NARROW = dict(num_things_classes=5, num_queries=8, feat_channels=32,
              out_channels=32, num_decoder_layers=3, num_heads=4, ffn_dim=64)


@pytest.fixture(scope="module")
def detector():
    """The narrow R18 TubeLinkVIS in both frameworks on one set of random
    weights, and the JAX forward jitted once for a (3, 32, 48, 3) tube."""
    from axial_vs_tpu.models.backbones.resnet import ResNet as JResNet
    from axial_vs_tpu.models.tube_link.detector import TubeLinkVIS as J
    from axial_vs_tpu_torch.models.backbones.resnet import ResNet
    from axial_vs_tpu_torch.models.tube_link.detector import TubeLinkVIS

    jm = J(backbone=JResNet(depth=18, name="backbone"), num_frames=TUBE,
           **NARROW)
    x = jnp.zeros((TUBE, 32, 48, 3), jnp.float32)
    v = jax_init(jm, x, return_query=True, seed=1)
    fwd = jax.jit(lambda vs, im: jm.apply(vs, im, return_query=True))
    model = port(TubeLinkVIS(ResNet(18), CHANS_R18, num_frames=TUBE, **NARROW),
                 convert.tube_link_vis(v))
    return jm, v, fwd, model


def test_tube_link_vis(detector):
    _, v, fwd, model = detector
    x = np.random.RandomState(2).randn(TUBE, 32, 48, 3).astype(np.float32)
    want = jax.tree.map(np.asarray, fwd(jax.tree.map(jnp.asarray, v),
                                        jnp.asarray(x)))
    with torch.no_grad():
        got = model(t(x), return_query=True)
    assert got["mask_preds"][-1].shape == (1, TUBE, 8, 8, 12)
    for key in ("cls_preds", "mask_preds"):
        assert len(got[key]) == len(want[key]) == 4
        for g, w in zip(got[key], want[key]):
            close(g, w, TOL_SLICE)
    close(got["query"], want["query"], TOL_SLICE)


def test_run_video(detector):
    """A 6-frame video in tubes of 3: the same instances, labels and order,
    scores and masks within the whole-model tolerance."""
    from axial_vs_tpu.models.tube_link.detector import (
        TubeLinkVISInference as J)
    from axial_vs_tpu_torch.models.tube_link.detector import (
        TubeLinkVISInference)

    jm, v, fwd, model = detector
    frames = np.random.RandomState(3).randn(6, 32, 48, 3).astype(np.float32)
    pipeline = J(jm, v, clip_len=TUBE, topk=6)
    jv = jax.tree.map(jnp.asarray, v)

    def tube_forward(clip):  # the fixture's compiled forward, same outputs
        out = fwd(jv, clip)
        return out["cls_preds"][-1][0], out["mask_preds"][-1][0], out["query"][0]

    pipeline._tube_forward = tube_forward
    want = pipeline.run_video(frames)
    got = TubeLinkVISInference(model, clip_len=TUBE, topk=6).run_video(
        t(frames))
    assert got["masks"].shape == want["masks"].shape == (6, 6, 8, 12)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    close(got["scores"], want["scores"], TOL_SLICE)
    close(got["masks"], want["masks"], TOL_SLICE)
