"""Parity of the port's Tube-Link VPS, cross-clip VIS and image Mask2Former
paths (axial_vs_tpu_torch) with the JAX package: the stuff-slot tube head,
``ThingQueryLink``'s three contexts, ``TubeLinkVPS`` and its window stream
(fusion, tracker, id rewrite), every fusion mode, the quasi-dense tracker,
``TubeLinkVideoVIS`` at 2 clips, ``ImageMask2Former``, DSTQ and the VSPW
metrics.

As in ``test_torch_tube_link.py``: the same numpy inputs, drawn from a
seed, go through each JAX module and its port, every parameter and
BatchNorm statistic randomized and carried over by
``axial_vs_tpu_torch/utils/convert.py``, in f32 on the CPU. Tensors agree
within ``TOL_MODULE`` (1e-5) of max |reference|; host outputs (id maps,
track ids, fusion maps and metrics) are equal. JAX's whole models are
jitted once per input signature, forward only.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from axial_vs_tpu_torch.utils import convert
from test_torch_parity import TOL_MODULE, close, jax_init, port, t
from test_torch_parity import torch_threads  # noqa: F401 (autouse)

CHANS_R18 = {"res2": 64, "res3": 128, "res4": 256, "res5": 512}
T = 2                         # frames per window / clip
HW = (32, 48)                 # input frames; masks at 8x12
NT, NS, QT = 3, 2, 6          # thing classes, stuff classes, thing queries
#: low tracker gates, so that random weights start and carry tracks
TRACKER = dict(init_score_thr=0.0, obj_score_thr=0.0, match_score_thr=0.2)


def _frames(seed, n=T):
    return np.random.RandomState(seed).randn(n, *HW, 3).astype(np.float32)


def _close_tree(got, want, keys):
    for key in keys:
        g, w = got[key], want[key]
        if isinstance(w, (list, tuple)):
            assert len(g) == len(w), key
            for gi, wi in zip(g, w):
                close(gi, wi, TOL_MODULE)
        else:
            close(g, w, TOL_MODULE)


# ------------------------------------------------------- ThingQueryLink ----

@pytest.mark.parametrize("context", ["none", "empty", "carried"])
def test_thing_query_link(rng, context):
    """``pre_query`` None attends over [cur, cur]; of length 0 over cur
    alone; a carried one over [cur, pre]."""
    from axial_vs_tpu.models.tube_link.vps import ThingQueryLink as J
    from axial_vs_tpu_torch.models.tube_link.vps import ThingQueryLink

    c = 32
    cur = rng.randn(1, 5, c).astype(np.float32)
    pre = {"none": None, "empty": np.zeros((1, 0, c), np.float32),
           "carried": rng.randn(1, 5, c).astype(np.float32)}[context]
    jm = J(embed_dim=c)
    v = jax_init(jm, jnp.asarray(cur), None if pre is None else jnp.asarray(pre))
    want = jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(cur),
                    None if pre is None else jnp.asarray(pre))
    got = port(ThingQueryLink(c), convert.thing_query_link(v["params"]))(
        t(cur), None if pre is None else t(pre))
    close(got, want, TOL_MODULE)


# ------------------------------------------------------------- TubeLinkVPS --

VPS_KEYS = ("cls_preds", "mask_preds", "query", "thing_query",
            "thing_query_raw", "track_embeds", "track_embeds_raw")


@pytest.fixture(scope="module")
def vps():
    """The R18 TubeLinkVPS (3 thing + 2 stuff classes, 6 thing queries, the
    head at its default widths) in both frameworks on one set of random
    weights; the JAX forward jitted with a ``pre_thing_query`` argument."""
    from axial_vs_tpu.models.backbones.resnet import ResNet as JResNet
    from axial_vs_tpu.models.tube_link.vps import TubeLinkVPS as J
    from axial_vs_tpu_torch.models.backbones.resnet import ResNet
    from axial_vs_tpu_torch.models.tube_link.vps import TubeLinkVPS

    jm = J(backbone=JResNet(depth=18, name="backbone"), num_things_classes=NT,
           num_stuff_classes=NS, num_thing_queries=QT, num_frames=T)
    v = jax_init(jm, jnp.zeros((T, *HW, 3), jnp.float32), seed=1)
    jv = jax.tree.map(jnp.asarray, v)
    fn = jax.jit(lambda vs, im, pre: jm.apply(vs, im, pre_thing_query=pre))

    def fwd(images, pre):
        return jax.tree.map(np.asarray, fn(jv, jnp.asarray(images), pre))

    model = port(TubeLinkVPS(ResNet(18), CHANS_R18, num_things_classes=NT,
                             num_stuff_classes=NS, num_thing_queries=QT,
                             num_frames=T), convert.tube_link_vps(v))
    return jm, v, fwd, model


@pytest.mark.parametrize("context", ["none", "empty", "carried"])
def test_tube_link_vps(vps, context):
    """Every output of the whole model: ``pre_thing_query`` of length 0 (the
    stream's first window), the previous window's linked thing queries (its
    later windows) and None, which attends over [cur, cur]: JAX's
    ``pre_query = cur_query``, held here as JAX's run with the window's own
    unlinked thing queries passed as ``pre`` (``test_thing_query_link``
    holds the None path itself), so that JAX compiles the model twice, not
    three times."""
    _, _, fwd, model = vps
    x = _frames(2)
    empty = np.zeros((1, 0, 256), np.float32)
    pre = {"none": None, "empty": empty,
           "carried": fwd(_frames(3), empty)["thing_query"]}[context]
    if context == "none":
        want = fwd(x, fwd(x, empty)["thing_query_raw"])
    else:
        want = fwd(x, pre)
    with torch.no_grad():
        got = model(t(x), pre_thing_query=None if pre is None else t(pre))
    assert got["cls_preds"][-1].shape == (1, QT + NS, NT + NS + 1)
    assert got["track_embeds"].shape == (1, QT, 256)
    _close_tree(got, want, VPS_KEYS)


def _pipelines(vps, **kw):
    """JAX's and the port's ``TubeLinkVPSInference`` on the fixture's
    models; JAX's window forward is the fixture's compiled one."""
    from axial_vs_tpu.models.tube_link.vps import TubeLinkVPSInference as J
    from axial_vs_tpu_torch.models.tube_link.vps import TubeLinkVPSInference

    jm, v, fwd, model = vps
    kw = dict(clip_len=T, num_things_classes=NT, num_stuff_classes=NS,
              object_mask_thr=0.0, iou_thr=0.0, tracker_kwargs=TRACKER, **kw)
    want = J(jm, v, **kw)

    def window_forward(images, pre):
        out = fwd(images, pre)
        return (out["cls_preds"][-1][0], out["mask_preds"][-1][0],
                out["track_embeds"][0], jnp.asarray(out["thing_query"]))

    want._window_forward = window_forward
    return want, TubeLinkVPSInference(model, **kw)


def test_vps_window_stream(vps):
    """Two windows of ``process_window`` then one of
    ``process_window_instance``: id maps, the tracker's tracks and the
    instances equal to JAX's; at least one thing track carries from the
    first window to the second."""
    want, got = _pipelines(vps)
    want.init_memory()
    got.init_memory()
    started = []  # tracks after each window
    for frame_id, seed in enumerate((4, 5)):
        x = _frames(seed)
        w, g = want.process_window(x, frame_id), got.process_window(t(x),
                                                                    frame_id)
        assert g.shape == (T, 8, 12)
        np.testing.assert_array_equal(g, w)
        # void = num_classes; stuff and untracked things < num_classes;
        # tracked things cls + (track + 1) * divisor, cls < num_things
        off = got.label_divisor
        assert ((g <= got.num_classes) | (g % off < NT)).all()
        assert sorted(got.tracker.tracks) == sorted(want.tracker.tracks)
        started.append(got.tracker.num_tracks)
    assert started[0] > 0
    assert any(tid < started[0] and tr["last_frame"] == 1
               for tid, tr in got.tracker.tracks.items())

    x = _frames(6)
    w = want.process_window_instance(x, 2, score_thr=0.0)
    g = got.process_window_instance(t(x), 2, score_thr=0.0)
    assert len(g) == len(w) == T
    for gi, wi in zip(g, w):
        for key in ("labels", "masks", "track_ids"):
            np.testing.assert_array_equal(gi[key], wi[key], err_msg=key)
        close(gi["scores"], wi["scores"], TOL_MODULE)
    assert (g[0]["track_ids"] >= 0).any()


def test_stuff_fixed_assignment():
    from axial_vs_tpu.models.tube_link.vps import stuff_fixed_assignment as j
    from axial_vs_tpu_torch.models.tube_link.vps import stuff_fixed_assignment

    for args in ((100, 66, 58), (6, 0, 19)):
        for g, w in zip(stuff_fixed_assignment(*args), j(*args)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("yaml,split", [
    ("vipseg/tube_link_vps_r50.yaml", (58, 66)),
    ("kitti_step/tube_link_vps_r50.yaml", (19, 0)),
    ("image/mask2former_r50_coco_panoptic_50e.yaml", (80, 53))])
def test_num_things_split(yaml, split):
    """``model.num_things`` of ``model.num_classes``; every class a thing
    where it is unset (KITTI-STEP)."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.models.tube_link.vps import num_things_split

    assert num_things_split(load_config(yaml)) == split


# ------------------------------------------------------------------ fusion ----

FUSION_CASES = {
    "with_query": dict(object_mask_thr=0.3, iou_thr=0.4),
    "with_query_filter": dict(object_mask_thr=0.3, iou_thr=0.4,
                              filter_low_score=True),
    "sort_with_query": dict(object_mask_thr=0.2, overlap_thr=0.3),
    "sort": dict(object_mask_thr=0.3, overlap_thr=0.4),
    "sem_seg_only_with_query": {},
    "sperate_focal": dict(num_thing_queries=8, max_per_image=12,
                          object_mask_thr=0.1, overlap_thr=0.4),
    "empty": dict(object_mask_thr=1.0),
}


@pytest.mark.parametrize("case", sorted(FUSION_CASES))
def test_fusion_modes(case):
    """Every fusion mode on drawn logits (10 queries, 3 things + 2 stuff):
    the panoptic map and the (query, id) list equal to JAX's."""
    from axial_vs_tpu.models.tube_link import fusion as jf
    from axial_vs_tpu_torch.models.tube_link import fusion

    mode = "with_query" if case in ("empty", "with_query_filter") else case
    rng = np.random.RandomState(sorted(FUSION_CASES).index(mode))
    cls = (rng.randn(10, NT + NS + 1) * 3).astype(np.float32)
    masks = (rng.randn(10, 12, 16) * 3).astype(np.float32)
    kw = FUSION_CASES[case]
    w_pan, w_list = jf.panoptic_fusion(mode, cls, masks, NT, NT + NS, **kw)
    g_pan, g_list = fusion.panoptic_fusion(mode, cls, masks, NT, NT + NS,
                                           **kw)
    np.testing.assert_array_equal(g_pan, w_pan)
    assert g_pan.dtype == w_pan.dtype
    assert g_list == w_list
    assert (g_pan != NT + NS).any() != (case == "empty")
    assert bool(g_list) == (mode.endswith("with_query") and case != "empty")


def test_fusion_unknown_mode_and_mask2box(rng):
    from axial_vs_tpu.models.tube_link import fusion as jf
    from axial_vs_tpu_torch.models.tube_link import fusion

    with pytest.raises(ValueError, match="joint_focal"):
        fusion.panoptic_fusion("joint_focal", None, None, 1, 2)
    masks = rng.rand(4, 9, 11) > 0.8
    masks[2] = False
    np.testing.assert_array_equal(fusion.mask2box(masks), jf.mask2box(masks))


# ----------------------------------------------------------------- tracker ----

@pytest.mark.parametrize("metric", ["bisoftmax", "cosine"])
def test_quasi_dense_tracker(metric):
    """A drawn 5-step sequence over 6 identities (labels fixed per
    identity, one flipped, scores around the gates, a gap of 12 frames
    that retires stale tracks): the ids of every step and the tracks'
    memory equal to JAX's."""
    from axial_vs_tpu.trackers.quasi_dense import QuasiDenseEmbedTracker as J
    from axial_vs_tpu_torch.trackers.quasi_dense import QuasiDenseEmbedTracker

    rng = np.random.RandomState(7)
    base = rng.randn(6, 16).astype(np.float32)
    kw = dict(match_metric=metric, memo_tracklet_frames=10)
    want, got = J(**kw), QuasiDenseEmbedTracker(**kw)
    for step, frame_id in enumerate((0, 1, 2, 14, 15)):
        idx = rng.choice(6, rng.randint(3, 7), replace=False)
        embeds = (base[idx] * 2 + rng.randn(len(idx), 16) * 0.5).astype(
            np.float32)
        labels = idx % 3
        if step == 2:
            labels[0] = (labels[0] + 1) % 3
        scores = rng.rand(len(idx)).astype(np.float32)
        np.testing.assert_array_equal(
            got.match(embeds, labels, scores, frame_id),
            want.match(embeds, labels, scores, frame_id))
        assert got.num_tracks == want.num_tracks
        assert sorted(got.tracks) == sorted(want.tracks)
        for tid, tr in got.tracks.items():
            np.testing.assert_array_equal(tr["embed"], want.tracks[tid]["embed"])
            assert tr["label"] == want.tracks[tid]["label"]
            assert tr["last_frame"] == want.tracks[tid]["last_frame"]
    got.reset()
    assert got.num_tracks == 0 and not got.tracks


# ---------------------------------------------------------- TubeLinkVideoVIS --

def test_tube_link_video_vis(rng):
    """The R18 cross-clip detector (5 classes, 8 queries, 2 CC layers) on 2
    clips of 2 frames: every CC layer's class and mask predictions; a
    video that is not a whole number of clips raises. Its detector runs
    without MaXTron's temporal attention, which the Tube-Link VIS tests
    hold, since JAX's jit of two clips with it took 50 s."""
    from axial_vs_tpu.models.backbones.resnet import ResNet as JResNet
    from axial_vs_tpu.models.tube_link.cc_detector import TubeLinkVideoVIS as J
    from axial_vs_tpu_torch.models.backbones.resnet import ResNet
    from axial_vs_tpu_torch.models.tube_link.cc_detector import (
        TubeLinkVideoVIS)

    kw = dict(num_things_classes=5, num_queries=8, num_frames=T,
              num_cc_layers=2, use_temporal_attn=False)
    jm = J(backbone=JResNet(depth=18, name="backbone"), **kw)
    x = _frames(8, 2 * T)
    v = jax_init(jm, jnp.asarray(x), seed=2)
    want = jax.tree.map(np.asarray, jax.jit(jm.apply)(
        jax.tree.map(jnp.asarray, v), jnp.asarray(x)))
    model = port(TubeLinkVideoVIS(ResNet(18), CHANS_R18, **kw),
                 convert.tube_link_video_vis(v))
    with torch.no_grad():
        got = model(t(x))
    assert got["cls_preds"][-1].shape == (1, 8, 6)
    assert got["mask_preds"][-1].shape == (1, 2 * T, 8, 8, 12)
    _close_tree(got, want, ("cls_preds", "mask_preds"))
    with pytest.raises(ValueError, match="whole number of clips"):
        model(t(x[:3]))


def test_tube_link_video_vis_freezes_the_detector():
    """In ``train()`` the detector stays in ``eval()`` and no gradient
    reaches it; the CC layers and heads get theirs."""
    from axial_vs_tpu_torch.models.backbones.resnet import ResNet
    from axial_vs_tpu_torch.models.kmax import materialize
    from axial_vs_tpu_torch.models.tube_link.cc_detector import (
        TubeLinkVideoVIS)

    meta = torch.device("meta")
    model = materialize(TubeLinkVideoVIS(
        ResNet(18, device=meta), CHANS_R18, num_things_classes=5,
        num_queries=8, num_frames=T, num_cc_layers=1, device=meta),
        torch.device("cpu"), torch.Generator().manual_seed(0), None).train()
    assert not (model.backbone.training or model.wc_head_wrapper.training)
    assert model.cc_layers.training
    out = model(t(_frames(9, 2 * T)))
    (out["cls_preds"][-1].sum() + out["mask_preds"][-1].sum()).backward()
    for name, p in model.named_parameters():
        frozen = name.startswith(("backbone.", "wc_head_wrapper."))
        assert (p.grad is None) == frozen, name
    assert model.cc_layers.trajectory_attn0.proj_q.weight.grad.abs().sum() > 0


# ---------------------------------------------------------- ImageMask2Former --

def test_image_mask2former():
    """R18, 3 things + 2 stuff, 8 queries, two images: every layer's class
    logits over things, stuff and void (the stuff-slot head's
    ``cls_embed``) and (B, Q, H/4, W/4) masks, and the final query."""
    from axial_vs_tpu.models.backbones.resnet import ResNet as JResNet
    from axial_vs_tpu.models.tube_link.image_mask2former import (
        ImageMask2Former as J)
    from axial_vs_tpu_torch.models.backbones.resnet import ResNet
    from axial_vs_tpu_torch.models.tube_link.image_mask2former import (
        ImageMask2Former)

    kw = dict(num_things_classes=NT, num_stuff_classes=NS, num_queries=8)
    jm = J(backbone=JResNet(depth=18, name="backbone"), **kw)
    x = _frames(10)
    v = jax_init(jm, jnp.asarray(x), seed=3)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda vs, im: jm.apply(vs, im, return_query=True))(
            jax.tree.map(jnp.asarray, v), jnp.asarray(x)))
    model = port(ImageMask2Former(ResNet(18), CHANS_R18, **kw),
                 convert.image_mask2former(v))
    with torch.no_grad():
        got = model(t(x), return_query=True)
    assert got["mask_preds"][-1].shape == (2, 8, 8, 12)
    assert got["cls_preds"][-1].shape == (2, 8, NT + NS + 1)
    _close_tree(got, want, ("cls_preds", "mask_preds", "query"))


# ------------------------------------------------------------------ metrics ----

def _panoptic(rng, shape, num_classes=5, things=(0, 1)):
    sem = rng.randint(0, num_classes, shape)
    sem[rng.rand(*shape) < 0.1] = 255
    inst = np.where(np.isin(sem, things), rng.randint(0, 3, shape), 0)
    return (sem << 16) + inst


def test_dstq_matches_jax():
    """Two sequences of three frames, with depth (zeros invalid) on all
    but one frame: every result field equal to JAX's."""
    from axial_vs_tpu.evaluation.dstq import DSTQuality as J
    from axial_vs_tpu_torch.evaluation.dstq import DSTQuality

    rng = np.random.RandomState(11)
    kw = dict(num_classes=5, things_list=[0, 1], ignore_label=255)
    want, got = J(**kw), DSTQuality(**kw)
    for seq in range(2):
        for frame in range(3):
            gt, pred = _panoptic(rng, (12, 16)), _panoptic(rng, (12, 16))
            depth = None
            if (seq, frame) != (1, 2):
                d_true = rng.rand(12, 16) * 80 * (rng.rand(12, 16) > 0.2)
                depth = (d_true, d_true * (1 + rng.randn(12, 16) * 0.15)
                         * (rng.rand(12, 16) > 0.1))
            for m in (want, got):
                m.update_state(gt, pred, *(depth or (None, None)),
                               sequence_id=seq)
    w, g = want.result(), got.result()
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                      err_msg=k)
    with pytest.raises(ValueError):
        DSTQuality(**kw, depth_threshold=())


def test_vspw_metrics_match_jax():
    """mIoU, VC, both warps and both TCs on drawn label maps and flows (a
    video longer than the VC window, ignore labels, flows past the
    borders): equal to JAX's."""
    from axial_vs_tpu.evaluation import vspw_metrics as jv
    from axial_vs_tpu_torch.evaluation import vspw_metrics as pv

    rng = np.random.RandomState(12)
    n, v, hw = 6, 10, (9, 13)
    gts = rng.randint(0, n, (v, *hw))
    gts[:, :3] = gts[0, :3]  # a static area for VC
    gts[rng.rand(v, *hw) < 0.05] = 255
    preds = np.where(rng.rand(v, *hw) < 0.8, gts % n, rng.randint(0, n, (v, *hw)))
    flows = (rng.randn(v - 1, *hw, 2) * 2).astype(np.float32)

    got, want = pv.SemanticIoU(n), jv.SemanticIoU(n)
    for g, p in zip(gts, preds):
        got.update(g, p)
        want.update(g, p)
    np.testing.assert_array_equal(got.cm, want.cm)
    assert got.miou() == want.miou()
    assert pv.SemanticIoU(n).miou() == jv.SemanticIoU(n).miou() == 0.0
    for window in (4, 8, 10):
        np.testing.assert_array_equal(
            np.asarray(pv.video_consistency(gts, preds, window), float),
            np.asarray(jv.video_consistency(gts, preds, window), float))
    np.testing.assert_array_equal(pv.warp_by_flow(preds[0], flows[0]),
                                  jv.warp_by_flow(preds[0], flows[0]))
    np.testing.assert_array_equal(pv.warp_nearest_ref(preds[1], flows[1], 7),
                                  jv.warp_nearest_ref(preds[1], flows[1], 7))
    assert (pv.temporal_consistency(preds, flows, n)
            == jv.temporal_consistency(preds, flows, n))
    assert (pv.temporal_consistency_ref(preds, flows, n)
            == jv.temporal_consistency_ref(preds, flows, n))
    got, want = pv.SemanticIoU(n), jv.SemanticIoU(n)
    for m, mod in ((got, pv), (want, jv)):
        mod.update_tc_pairs(m, preds[:4], flows[:3])
        mod.update_tc_pairs(m, preds[4:], flows[4:])
    np.testing.assert_array_equal(got.cm, want.cm)
