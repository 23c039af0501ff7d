"""Parity of the port's VIPSeg evaluation slice with the JAX package:
panoptic inference and the dataset-id remap, VPQ, the clip re-ID, STQ, and
the whole path from video files to VPQ (``evaluate_vipseg``).

Inputs come from numpy seeds; the whole-slice tests carry the JAX model's
weights to the port with ``axial_vs_tpu_torch/utils/convert.py`` and run
both in f32 on the CPU. Tolerances: integer outputs of the post-processing
are identical (inputs are drawn with every score at least 1e-4 away from a
threshold, so f32 rounding cannot flip a gate); the metrics are equal to
1e-9 on equal id maps; the whole slice's id maps agree on at least 99.9% of
the pixels (a pixel whose mask probability sits within f32 rounding of a
threshold may flip) and its VPQ and STQ to 1e-3.
"""
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from axial_vs_tpu_torch.utils import convert

THRESHOLDS = dict(pixel_confidence_threshold=0.3, class_threshold_thing=0.2,
                  class_threshold_stuff=0.3, overlap_threshold=0.8)
MARGIN = 1e-4


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def _draw_logits(seed, spatial, n, c):
    """Class and mask logits with no score within MARGIN of a threshold and
    no two reorder scores within MARGIN. Slots 0 and 1 are confident things
    with nearly the same mask (the later one is an overlap rejection), and
    slots 2 and 3 share a confident stuff class (a stuff merge)."""
    thing_mask = np.arange(c) < c // 2
    for s in range(seed, seed + 1000):
        rng = np.random.RandomState(s)
        mask_cls = (rng.randn(n, c + 1) * 2).astype(np.float32)
        mask_pred = (rng.randn(*spatial, n) * 3).astype(np.float32)
        mask_pred[..., 1] = mask_pred[..., 0] + 0.05
        mask_cls[:4] = -4.0
        mask_cls[:2, 0] = 4.0
        mask_cls[2:4, c - 1] = 4.0
        cls_prob = _softmax(mask_cls, -1)[:, :-1]
        scores = cls_prob.max(-1)
        probs = _softmax(mask_pred, -1)
        binary = probs > THRESHOLDS["pixel_confidence_threshold"]
        conf = (probs * binary).reshape(-1, n).sum(0) / np.maximum(
            binary.reshape(-1, n).sum(0), 1)
        reorder = np.sort(scores * conf)
        near = min(np.abs(probs - THRESHOLDS["pixel_confidence_threshold"]).min(),
                   np.abs(scores - THRESHOLDS["class_threshold_thing"]).min(),
                   np.abs(scores - THRESHOLDS["class_threshold_stuff"]).min(),
                   np.diff(reorder[reorder > 0]).min())
        if near > MARGIN:
            return mask_cls, mask_pred, thing_mask
    raise AssertionError("no draw kept its margins")


@pytest.mark.parametrize("spatial,n,c", [((13, 17), 12, 6), ((3, 11, 9), 16, 5)])
def test_panoptic_inference_matches_jax(spatial, n, c):
    from axial_vs_tpu.models.postprocess import (
        panoptic_inference as jpan, remap_panoptic_to_dataset_ids as jremap)
    from axial_vs_tpu_torch.models.postprocess import (
        panoptic_inference, remap_panoptic_to_dataset_ids)

    mask_cls, mask_pred, thing_mask = _draw_logits(len(spatial), spatial, n, c)
    cont2ds = np.arange(c, dtype=np.int32) * 7 + 3
    want = jpan(jnp.asarray(mask_cls), jnp.asarray(mask_pred),
                jnp.asarray(thing_mask), **THRESHOLDS)
    want_ids, want_new = jremap(want, jnp.asarray(cont2ds), 1000)
    got = panoptic_inference(torch.from_numpy(mask_cls),
                             torch.from_numpy(mask_pred),
                             torch.from_numpy(thing_mask), **THRESHOLDS)
    got_ids, got_new = remap_panoptic_to_dataset_ids(
        got, torch.from_numpy(cont2ds), 1000)
    for field, w in zip(got._fields, want):
        g = getattr(got, field)
        assert g.dtype in (torch.int32, torch.bool), field
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_new.numpy(), np.asarray(want_new))
    accepted = got.accepted.numpy()
    assert (accepted & ~got.segment_valid.numpy()).any(), "no stuff merge"
    assert {0, 1} & set(got.slot_index.numpy()[~accepted]), "no overlap rejection"
    assert got.segment_valid.numpy().sum() >= 3


# --------------------------------------------------------------- metrics ----

def _id_maps(rng, v=7, h=20, w=24):
    """GT and prediction id maps in the evaluator's dataset format (things
    cat * 1000 + instance, stuff cat, -1 void). Categories: 2 stuff; 1, 3, 4
    things, with a crowd region of 3. The prediction noises the GT, misses
    one thing, adds a false one, and puts a segment of 3 over the crowd."""
    gt = np.full((v, h, w), 2, np.int64)
    gt[:, :3, :5] = -1
    gt[:, 15:, 18:] = 3009
    for f in range(v):
        gt[f, 4:10, 2 + f:8 + f] = 1001
    gt[:, 11:16, 10:15] = 1002
    gt[:, 5:8, 16:20] = 4001
    pred = gt.copy()
    pred[:, 11:16, 10:15] = 2
    pred = np.where(rng.rand(v, h, w) < 0.05, 2, pred)
    pred[:, 12:15, 1:4] = 1005
    pred[:, 14:17, 17:22] = 3003
    gt_segments = {int(s): {"category_id": int(s // 1000 if s >= 1000 else s),
                            "iscrowd": int(s == 3009)}
                   for s in np.unique(gt) if s >= 0}
    pred_segments = {int(s): {"category_id": int(s // 1000 if s >= 1000 else s)}
                     for s in np.unique(pred) if s >= 0}
    return gt, pred, gt_segments, pred_segments


def _close_dicts(got, want, tol=1e-9):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_dicts(got[k], want[k], tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_dicts(g, w, tol)
    elif isinstance(want, (float, np.floating)):
        assert abs(got - want) <= tol, (got, want)
    else:
        assert got == want, (got, want)


def test_vpq_matches_jax(rng, tmp_path):
    """VPQ@{1,2,4,6} through both evaluators (id encoding, the PNG/JSON
    dump, the metric) on the same id maps, and the dumps themselves."""
    from axial_vs_tpu.evaluation.vipseg_evaluator import VIPSegEvaluator as J
    from axial_vs_tpu.evaluation.vpq import vpq_compute as jvpq
    from axial_vs_tpu_torch.evaluation.vipseg_evaluator import VIPSegEvaluator
    from axial_vs_tpu_torch.evaluation.vpq import vpq_compute

    cats = {i: {"isthing": int(i in (1, 3, 4))} for i in range(5)}
    results = []
    for cls, out in ((J, tmp_path / "jax"), (VIPSegEvaluator, tmp_path / "port")):
        ev = cls(cats, label_divisor=1000, output_dir=str(out))
        for vid in range(2):
            gt, pred, gs, ps = _id_maps(np.random.RandomState(vid))
            ev.process_video(f"v{vid}", pred, ps, gt, gs,
                             frame_names=[f"{f:05d}.jpg" for f in range(len(gt))])
        results.append(ev.evaluate())
    _close_dicts(results[1], results[0])
    assert 0 < results[1]["vpq"] < 1
    for vid in range(2):
        a, b = (json.loads((tmp_path / side / "pan_pred" / f"v{vid}" /
                            "pred.json").read_text()) for side in ("jax", "port"))
        assert a == b
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / "pan_pred" / f"v{vid}" /
                                  "00003.png")),
            np.asarray(Image.open(tmp_path / "jax" / "pan_pred" / f"v{vid}" /
                                  "00003.png")))
    gt, pred, gs, ps = _id_maps(rng)
    videos = [(gt + 1, pred + 1, {k + 1: v for k, v in gs.items()},
               {k + 1: v for k, v in ps.items()})]
    _close_dicts(vpq_compute(videos, cats, window_sizes=(1, 3, 7)),
                 jvpq(videos, cats, window_sizes=(1, 3, 7), use_native=False))


@pytest.mark.parametrize("num_workers", [0, 2])
def test_vpq_workers_and_reset_match_jax(num_workers):
    """VPQ of two videos counted in this process (0) and in a pool of 2
    processes, against the JAX evaluator's serial Python path; ``reset()``
    empties the evaluator, which then scores a new evaluation alone."""
    from axial_vs_tpu.evaluation.vpq import vpq_compute as jvpq
    from axial_vs_tpu_torch.evaluation.vipseg_evaluator import VIPSegEvaluator

    cats = {i: {"isthing": int(i in (1, 3, 4))} for i in range(5)}
    maps = [_id_maps(np.random.RandomState(10 + vid)) for vid in range(2)]
    ev = VIPSegEvaluator(cats, label_divisor=1000, num_workers=num_workers)
    for gt, pred, gs, ps in maps:
        ev.process_video("v", pred, ps, gt, gs)
    got = ev.evaluate()
    want = jvpq(ev._videos, cats, use_native=False)
    _close_dicts(got, want)
    assert 0 < got["vpq"] < 1
    ev.reset()
    assert ev._videos == []
    gt, pred, gs, ps = maps[1]
    ev.process_video("v", pred, ps, gt, gs)
    _close_dicts(ev.evaluate(), jvpq(ev._videos, cats, use_native=False))


@pytest.mark.parametrize("shape", [(5, 7), (7, 5), (6, 6)])
def test_lap_with_cost_limit_matches_jax(shape):
    from axial_vs_tpu.evaluation.vipseg_evaluator import lap_with_cost_limit as jlap
    from axial_vs_tpu_torch.evaluation.vipseg_evaluator import lap_with_cost_limit

    cost = np.random.RandomState(sum(shape)).rand(*shape)
    want = jlap(cost, 0.2)
    assert (want >= 0).any() and (want < 0).any()
    np.testing.assert_array_equal(lap_with_cost_limit(cost, 0.2), want)


def test_stitch_clips_matches_jax(rng):
    """Clip-wise re-ID with an EMA memory: three clips whose thing ids are
    clip-local, with embeddings that match, miss and open a new instance."""
    from axial_vs_tpu.evaluation.vipseg_evaluator import VIPSegEvaluator as J
    from axial_vs_tpu_torch.evaluation.vipseg_evaluator import VIPSegEvaluator

    def unit(v):
        return v / np.linalg.norm(v)

    base = [unit(rng.randn(8)) for _ in range(3)]
    clip_ids, clip_embs = [], []
    for ci in range(3):
        ids = np.full((2, 6, 8), 4, np.int64)
        ids[:, 1:3, 1:4] = 1 * 1000 + 0
        ids[:, 3:5, 4:7] = 1 * 1000 + 1
        ids[:, 5:, :2] = 2 * 1000 + 0
        order = [(ci + k) % 3 for k in range(2)]
        clip_ids.append(ids)
        clip_embs.append({1: [unit(base[o] + 0.1 * rng.randn(8)) for o in order],
                          2: [unit(rng.randn(8))]})
    clip_embs.insert(1, {})
    clip_ids.insert(1, np.full((2, 6, 8), -1, np.int64))
    cats = {i: {"isthing": int(i in (1, 2))} for i in range(5)}
    want = J(cats, label_divisor=1000, mem_weight=0.3).stitch_clips(
        clip_ids, clip_embs)
    got = VIPSegEvaluator(cats, label_divisor=1000, mem_weight=0.3).stitch_clips(
        clip_ids, clip_embs)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[got >= 1000])) > 2


def test_stq_matches_jax(rng):
    from axial_vs_tpu.evaluation.stq import STQuality as J
    from axial_vs_tpu_torch.evaluation.stq import STQuality

    metrics = [cls(5, [0, 1], ignore_label=255) for cls in (J, STQuality)]
    for seq in ("a", "b"):
        for _ in range(3):
            sem = rng.randint(0, 5, (12, 14))
            sem[rng.rand(12, 14) < 0.1] = 255
            inst = np.where(sem < 2, rng.randint(0, 3, sem.shape), 0)
            y_true = (sem << 16) + inst
            sem_p = np.where(rng.rand(12, 14) < 0.2, rng.randint(0, 5, sem.shape),
                             np.minimum(sem, 4))
            y_pred = (sem_p << 16) + np.where(sem_p < 2, inst, 0)
            for m in metrics:
                m.update_state(y_true, y_pred, sequence_id=seq)
    want, got = (m.result() for m in metrics)
    _close_dicts(got, want)
    assert 0 < got["STQ"] < 1


# ------------------------------------------------------- the whole slice ----

CATEGORIES = [dict(id=10, name="obj", isthing=1), dict(id=20, name="bg", isthing=0),
              dict(id=30, name="other", isthing=1), dict(id=40, name="more", isthing=0)]


def _write_dataset(root):
    """tests/test_e2e.py's dataset: 2 videos of 3 frames of 48x72 random
    pixels, a moving thing (id 1, category 10) over stuff (id 2, category
    20), as jpg frames, panoptic pngs and a panoVIPSeg JSON."""
    from axial_vs_tpu_torch.data.panoptic_utils import id2rgb

    img_root, pan_root = root / "imgs", root / "panomasks"
    rng = np.random.RandomState(0)
    videos = []
    for vid in range(2):
        video_id = f"v{vid}"
        (img_root / video_id).mkdir(parents=True)
        (pan_root / video_id).mkdir(parents=True)
        images, annotations = [], []
        for f in range(3):
            img = rng.randint(0, 255, (48, 72, 3), np.uint8)
            Image.fromarray(img).save(img_root / video_id / f"{f:05d}.jpg")
            pan = np.full((48, 72), 2, np.int32)
            pan[10:30, 10 + 5 * f:30 + 5 * f] = 1
            Image.fromarray(id2rgb(pan)).save(pan_root / video_id / f"{f:05d}.png")
            images.append(dict(id=f"{video_id}_{f}", file_name=f"{f:05d}.jpg",
                               height=48, width=72))
            annotations.append(dict(
                image_id=f"{video_id}_{f}", file_name=f"{f:05d}.png",
                segments_info=[dict(id=1, category_id=10, isthing=True, iscrowd=0),
                               dict(id=2, category_id=20, isthing=False,
                                    iscrowd=0)]))
        videos.append(dict(video_id=video_id, images=images,
                           annotations=annotations))
    json_path = root / "panoVIPSeg_val.json"
    json_path.write_text(json.dumps(dict(videos=videos, categories=CATEGORIES)))
    return str(img_root), str(pan_root), str(json_path)


def _slice_config(name, dtype="float32"):
    """The bench's WC ConvNeXt configuration cut to small widths; frames
    are downscaled (48x72 -> 43x65) and padded to 64x65."""
    from axial_vs_tpu.config import get_default_config

    cfg = get_default_config()
    cfg.model.backbone.name = "convnext_eval_test"
    c = cfg.model.backbone.convnext
    c.depths, c.dims, c.drop_path_rate = [1, 1, 1, 1], [32, 64, 96, 128], 0.0
    cfg.model.num_classes = len(CATEGORIES)
    cfg.model.dtype = dtype
    cfg.input.image_size = [64, 65]
    cfg.input.num_clip_frames = 2
    w = cfg.model.maxtron.wc
    w.enable, w.conv_dims, w.dim_feedforward = True, 64, 96
    cfg.model.kmax.pixel_dec.dec_layers = [1, 1, 1, 1]
    cfg.model.kmax.pixel_dec.dec_channels = [32, 16, 16, 16]
    cfg.model.kmax.trans_dec.dec_layers = [1, 1, 1]
    cfg.model.kmax.trans_dec.num_object_queries = 16
    cfg.datasets.test = [name]
    return cfg


@pytest.fixture(scope="module")
def vipseg_slice(tmp_path_factory):
    """The dataset registered in both packages' catalogs, the JAX WC model
    with random variables, and the port's model carrying them."""
    from axial_vs_tpu.data.vipseg import register_vipseg_video as jregister
    from axial_vs_tpu.data.catalog import MetadataCatalog as JMeta
    from axial_vs_tpu.models.kmax import build_segmenter as jbuild
    from axial_vs_tpu_torch.data.catalog import DatasetCatalog
    from axial_vs_tpu_torch.data.vipseg import (register_vipseg_video,
                                                set_panoptic_metadata)
    from axial_vs_tpu_torch.models.kmax import build_segmenter
    from test_torch_parity import port, randomize

    root = tmp_path_factory.mktemp("vipseg")
    name = f"torch_eval_vipseg_{root.name}"
    paths = _write_dataset(root)
    set_panoptic_metadata(register_vipseg_video(name, *paths), CATEGORIES)
    jregister(name, *paths)
    set_panoptic_metadata(JMeta.get(name), CATEGORIES)
    cfg = _slice_config(name)
    jm = jbuild(cfg, num_frames=2, train=False)
    # every parameter N(0, 0.5^2), seed 5: voids, stuff and several things.
    # At 0.1 the decoder's slots collapse and no pixel passes the mask
    # threshold, which would make the id-map comparison vacuous
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 65, 3)), train=False))
    variables = jax.tree.map(jnp.asarray, randomize(shapes, 5, scale=0.5))
    model = build_segmenter(cfg, torch.device("cpu"),
                            torch.Generator().manual_seed(0), num_frames=2)
    model = port(model, convert.convert_variables(variables))
    videos = [np.stack([np.asarray(Image.open(f["file_name"]).convert("RGB"))
                        for f in v["frames"]])
              for v in DatasetCatalog.get(name)]
    return dict(cfg=cfg, root=root, jm=jm, variables=variables, model=model,
                videos=videos, name=name)


def _pipelines(s, **kw):
    from axial_vs_tpu.models.video_inference import WCInferencePipeline as J
    from axial_vs_tpu_torch.data.catalog import MetadataCatalog
    from axial_vs_tpu_torch.models.video_inference import WCInferencePipeline

    cfg, meta = s["cfg"], MetadataCatalog.get(s["name"])
    test = cfg.model.maxtron.test
    args = dict(
        num_clip_frames=2, input_size=cfg.input.image_size,
        pixel_mean=cfg.input.pixel_mean, pixel_std=cfg.input.pixel_std,
        thing_class_mask=np.asarray([c["isthing"] for c in CATEGORIES], bool),
        contiguous_to_dataset_id=np.asarray(meta.contiguous_to_dataset_id),
        label_divisor=meta.label_divisor,
        pixel_confidence_threshold=test.pixel_confidence_threshold,
        class_threshold_thing=test.class_threshold_thing,
        class_threshold_stuff=test.class_threshold_stuff, **kw)
    return J(s["jm"], s["variables"], **args), WCInferencePipeline(s["model"], **args)


def _agree(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert (want >= 0).any(), "no segment at all: the comparison is vacuous"
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("mode", ["videowise", "windowed", "clipwise"])
def test_video_inference_matches_jax(vipseg_slice, mode):
    """Each video through both pipelines: the video-wise path, the windowed
    path (windows of 2 frames, identities carried across them) and the
    clip-wise path with the evaluator's re-ID."""
    from axial_vs_tpu.evaluation.vipseg_evaluator import VIPSegEvaluator as J
    from axial_vs_tpu_torch.evaluation.vipseg_evaluator import VIPSegEvaluator

    jpipe, pipe = _pipelines(vipseg_slice, videowise_max_frames=(
        2 if mode == "windowed" else 16))
    for frames in vipseg_slice["videos"]:
        if mode == "clipwise":
            cats = {i: {"isthing": c["isthing"]} for i, c in enumerate(CATEGORIES)}
            # whole clips: the last one repeats the video's last frame
            want = J(cats).stitch_clips(*jpipe.run_video_clipwise(frames))
            got = VIPSegEvaluator(cats).stitch_clips(*pipe.run_video_clipwise(frames))
            assert got.shape == (4,) + frames.shape[1:3]
        else:
            want = jpipe.run_video(frames)[0]
            got = pipe.run_video(frames)[0]
            assert got.shape == frames.shape[:3]
        _agree(got, want)


def test_evaluate_vipseg_matches_jax(vipseg_slice, tmp_path):
    """evaluate_vipseg of both packages on the same dataset and weights: VPQ
    per window and STQ."""
    from axial_vs_tpu.engine.evaluator_loop import evaluate_vipseg as jeval
    from axial_vs_tpu_torch.engine.evaluator_loop import evaluate_vipseg

    cfg = vipseg_slice["cfg"]
    cfg.output_dir = str(tmp_path / "jax")
    want = jeval(cfg, vipseg_slice["jm"], vipseg_slice["variables"],
                 compute_stq=True)
    cfg.output_dir = str(tmp_path / "port")
    got = evaluate_vipseg(cfg, vipseg_slice["model"], compute_stq=True)
    assert set(got["per_window"]) == {1, 2, 4, 6}
    for k in (1, 2, 4, 6):
        for part in ("all", "things", "stuff"):
            assert abs(got["per_window"][k][part]["pq"]
                       - want["per_window"][k][part]["pq"]) <= 1e-3
    assert abs(got["vpq"] - want["vpq"]) <= 1e-3
    assert abs(got["stq"]["STQ"] - want["stq"]["STQ"]) <= 1e-3
    assert 0.0 <= got["vpq"] <= 1.0 and 0.0 <= got["stq"]["STQ"] <= 1.0


def test_evaluate_vipseg_bf16_block_route(vipseg_slice, tmp_path):
    """The port's bf16 segmenter on the fused-block route (K4's plain
    version on the CPU) through evaluate_vipseg: finite, in range."""
    from axial_vs_tpu_torch.engine.evaluator_loop import evaluate_vipseg
    from axial_vs_tpu_torch.models.kmax import build_segmenter
    from axial_vs_tpu_torch.ops.convnext_cuda import convnext_block_fused

    cfg = _slice_config(vipseg_slice["name"], "bfloat16")
    cfg.output_dir = str(tmp_path)
    model = build_segmenter(cfg, torch.device("cpu"),
                            torch.Generator().manual_seed(1), num_frames=2,
                            block_kernel="block")
    assert all(b.block_kernel == "block" for s in model.backbone.stages
               for b in s.blocks)
    res = evaluate_vipseg(cfg, model, compute_stq=True)
    values = [res["vpq"], res["stq"]["STQ"]] + [
        res["per_window"][k]["all"]["pq"] for k in (1, 2, 4, 6)]
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in values)
    assert convnext_block_fused.launches == 0  # the CPU takes the plain version
