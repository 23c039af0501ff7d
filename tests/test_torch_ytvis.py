"""Parity of the port's YouTube-VIS evaluation path (axial_vs_tpu_torch)
with the JAX package: the RLE codec, the YTVIS loader, clip mapper and
result writer, the synthetic fixture writer, the devkit evaluator, the
Tube-Link baseline without temporal attention, and ``evaluate_ytvis`` end
to end.

The data code is numpy on both sides, so its outputs must be equal (the
evaluator's AP/AR to 1e-12). The model runs in f32 on the CPU on converted
JAX weights: tube outputs within ``TOL_MODULE`` (1e-5 of scale). The JAX
model is built, randomized and jitted once for the file (``baseline``);
``evaluate_ytvis`` on both sides goes through that compiled forward on one
short fixture video.
"""
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from axial_vs_tpu_torch.utils import convert
from fixtures_ytvis import synthesize_ytvis_videos
from test_torch_parity import TOL_MODULE, close, jax_init, port, t
from test_torch_parity import torch_threads  # noqa: F401 (autouse)

CHANS_R18 = {"res2": 64, "res3": 128, "res4": 256, "res5": 512}
TUBE = 2  # frames per tube
VIDEO_FRAMES = 4  # the end-to-end video: two tubes
INPUT_HW = (48, 80)  # the model's input: the 96x160 fixture at half size
NARROW = dict(num_things_classes=2, num_queries=6, feat_channels=32,
              out_channels=32, num_decoder_layers=2, num_heads=4, ffn_dim=48)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """The repo's YTVIS fixture (2 videos of 8 frames at 96x160, seed 0)."""
    root = str(tmp_path_factory.mktemp("ytvis"))
    return synthesize_ytvis_videos(root)


# ------------------------------------------------------------- RLE codec ----

def test_mask_rle_matches_jax():
    from axial_vs_tpu.data import mask_rle as J
    from axial_vs_tpu_torch.data import mask_rle as P

    rng = np.random.RandomState(0)
    masks = [rng.rand(37, 23) > 0.6, np.zeros((5, 4), bool),
             np.ones((5, 4), bool), rng.rand(200, 3) > 0.01]
    for m in masks:
        enc = P.encode(m)
        assert enc == J.encode(m)
        np.testing.assert_array_equal(P.decode(enc), m.astype(np.uint8))
        assert P.area(enc) == J.area(enc) == int(m.sum())
        assert P.mask_to_rle_counts(m) == J.mask_to_rle_counts(m)
    # a known value: column-major 0 1 1 | 1 0 1 -> runs [1, 3, 1, 1]; the
    # string "1", "3", "1", then the difference 1 - 3 (chars from 48)
    m = np.array([[0, 1], [1, 0], [1, 1]], np.uint8)
    assert P.encode(m) == {"size": [3, 2], "counts": "131N"}
    assert P.rle_decode_string("131N") == [1, 3, 1, 1]
    a, b = P.encode(masks[0]), P.encode(rng.rand(37, 23) > 0.5)
    assert P.iou_rle(a, b) == J.iou_rle(a, b)


@pytest.mark.parametrize("top", [10, 10**4, 10**9])
def test_rle_codec_matches_jax(top):
    """The count strings, both ways, on seeded counts up to ``top``
    (differences of either sign, 1-7 five-bit groups); counts that under-
    and over-fill a mask; the runs of masks of 0-3 dimensions, each
    dimension 0-8 long, and of values 0-2."""
    from axial_vs_tpu.data import mask_rle as J
    from axial_vs_tpu_torch.data import mask_rle as P

    rng = np.random.RandomState(top % 97)
    for n in (0, 1, 2, 3, 4, 5, 17, 300):
        counts = rng.randint(0, top, n).tolist()
        s = P.rle_encode_string(counts)
        assert s == J.rle_encode_string(counts)
        assert P.rle_decode_string(s) == J.rle_decode_string(s) == counts
        assert P.rle_decode_string(s.encode()) == counts
    for counts in ([3, 2], [2, 20], [0, 9], [], [9]):
        np.testing.assert_array_equal(P.rle_counts_to_mask(counts, (3, 3)),
                                      J.rle_counts_to_mask(counts, (3, 3)))
    for i in range(300):
        shape = tuple(rng.randint(0, 9, rng.randint(0, 4)))
        m = rng.randint(0, 3, shape) if i % 3 == 0 else rng.rand(*shape) > 0.5
        assert P.mask_to_rle_counts(m) == J.mask_to_rle_counts(m), shape


# ----------------------------------------------------------------- data ----

def test_synthetic_writer_equals_fixture(tmp_path):
    from axial_vs_tpu_torch.data.synthetic import write_ytvis_videos

    want = synthesize_ytvis_videos(str(tmp_path / "a"), 2, 5, seed=3)
    got = write_ytvis_videos(str(tmp_path / "b"), 2, 5, seed=3)
    for w, g in zip(want, got):
        assert os.path.relpath(w, tmp_path / "a") == os.path.relpath(
            g, tmp_path / "b")
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "a")
                   for d, _, fs in os.walk(tmp_path / "a") for f in fs)
    assert len(files) == 11  # 10 frames and the JSON
    for rel in files:
        with open(tmp_path / "a" / rel, "rb") as f, \
                open(tmp_path / "b" / rel, "rb") as g:
            assert f.read() == g.read(), rel


def test_synthetic_writer_stored_frames(tmp_path):
    """``compress_level=0`` (the smoke's 720x1280 videos) stores the same
    pixels and the same JSON as the fixture's default level."""
    from PIL import Image

    from axial_vs_tpu_torch.data.synthetic import write_ytvis_videos

    a = write_ytvis_videos(str(tmp_path / "a"), 1, 3, seed=3)
    b = write_ytvis_videos(str(tmp_path / "b"), 1, 3, seed=3,
                           compress_level=0)
    with open(a[1]) as f, open(b[1]) as g:
        assert f.read() == g.read()
    for i in range(3):
        pa, pb = (os.path.join(r, "v0", f"{i:03d}.png") for r in (a[0], b[0]))
        np.testing.assert_array_equal(np.asarray(Image.open(pa)),
                                      np.asarray(Image.open(pb)))
        assert os.path.getsize(pb) > os.path.getsize(pa)


def test_loader_and_mapper_match_jax(fixture_root):
    from axial_vs_tpu.data import ytvis as J
    from axial_vs_tpu_torch.data import ytvis as P

    img_root, js = fixture_root
    want, want_cats = J.load_ytvis_json(js, img_root)
    got, got_cats = P.load_ytvis_json(js, img_root)
    assert got == want and got_cats == want_cats and len(got) == 2
    kw = dict(image_size=(64, 96), num_frames=3, max_instances=4, seed=5,
              dataset_id_to_contiguous_id={1: 0, 2: 1})
    jm, pm = J.YTVISClipMapper(**kw), P.YTVISClipMapper(**kw)
    for video in (want * 2):  # the mappers' random streams, twice through
        a, b = jm(video), pm(video)
        np.testing.assert_array_equal(b["images"], a["images"])
        for k in ("labels", "masks", "valid"):
            np.testing.assert_array_equal(b["targets"][k], a["targets"][k])
    assert b["targets"]["valid"].sum() == 2


def test_build_mapper_on_ytvis_config(fixture_root):
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.data.build import build_mapper
    from axial_vs_tpu_torch.data.catalog import DatasetCatalog
    from axial_vs_tpu_torch.data.ytvis import YTVISClipMapper, register_ytvis

    name = "ytvis_mapper_test_train"
    if name not in DatasetCatalog:
        register_ytvis(name, *fixture_root)
    cfg = load_config("ytvis19/tube_link_r50.yaml",
                      ["datasets.train", [name]])
    mapper = build_mapper(cfg, seed=3)
    assert isinstance(mapper, YTVISClipMapper)
    assert mapper.dataset_id_to_contiguous_id == {1: 0, 2: 1}
    assert mapper.num_frames == cfg.input.num_video_frames


def _random_predictions(videos, rng):
    """Per video 5 tubes: the GT masks shifted, cut or emptied frame by
    frame, random categories and scores."""
    from axial_vs_tpu.data import mask_rle

    preds = []
    for v in videos:
        for k in range(5):
            ann = v["annotations"][k % 2]
            segs = []
            for s in ann["segmentations"]:
                m = mask_rle.decode(s)
                m = np.roll(m, (rng.randint(-6, 7), rng.randint(-6, 7)), (0, 1))
                if rng.rand() < 0.15:
                    m[:] = 0
                segs.append(mask_rle.encode(m) if m.any() else None)
            preds.append(dict(video_id=v["video_id"],
                              category_id=int(rng.randint(1, 3)),
                              score=float(rng.rand()), segmentations=segs))
    return preds


def test_evaluator_matches_jax(fixture_root):
    from axial_vs_tpu.data.ytvis import load_ytvis_json
    from axial_vs_tpu.evaluation.ytvis_eval import YTVISEvaluator as J
    from axial_vs_tpu_torch.evaluation.ytvis_eval import YTVISEvaluator as P

    videos, _ = load_ytvis_json(fixture_root[1], fixture_root[0])
    gts = [dict(video_id=v["video_id"], **{k: a[k] for k in (
        "category_id", "segmentations", "areas", "iscrowd")})
        for v in videos for a in v["annotations"]]
    preds = _random_predictions(videos, np.random.RandomState(0))
    copy = lambda recs: [dict(r) for r in recs]  # the evaluators annotate
    want = J().evaluate(copy(gts), copy(preds))
    got = P().evaluate(copy(gts), copy(preds))
    assert sorted(got) == sorted(want)
    assert 0.0 < want["AP"] < 1.0
    for k, w in want.items():
        if k == "per_category_AP":
            assert got[k].keys() == w.keys()
            for c in w:
                assert abs(got[k][c] - w[c]) <= 1e-12
        else:
            assert abs(got[k] - w) <= 1e-12, k


def test_results_writer_matches_jax():
    from axial_vs_tpu.data.ytvis import results_to_ytvis_json as J
    from axial_vs_tpu_torch.data.ytvis import results_to_ytvis_json as P

    rng = np.random.RandomState(1)
    videos = [(3, dict(masks=rng.rand(4, 3, 12, 10).astype(np.float32),
                       labels=rng.randint(1, 40, 4), scores=rng.rand(4))),
              (7, dict(masks=rng.rand(2, 5, 9, 11).astype(np.float32) * 0.6,
                       labels=rng.randint(1, 40, 2), scores=rng.rand(2)))]
    videos[1][1]["masks"][0, 2] = 0.0  # an empty frame: None
    want, got = J(videos), P(videos)
    assert json.dumps(got) == json.dumps(want)
    assert any(s is None for r in got for s in r["segmentations"])
    assert json.dumps(P(videos, 0.5)) == json.dumps(J(videos, 0.5))


# ------------------------------------- the baseline: no temporal attention --

@pytest.fixture(scope="module")
def baseline():
    """The narrow R18 Tube-Link baseline (``use_temporal_attn=False``) in
    both frameworks on one set of random weights, and the JAX forward
    jitted once for a (TUBE, 48, 80, 3) tube."""
    from axial_vs_tpu.models.backbones.resnet import ResNet as JResNet
    from axial_vs_tpu.models.tube_link.detector import TubeLinkVIS as J
    from axial_vs_tpu_torch.models.backbones.resnet import ResNet
    from axial_vs_tpu_torch.models.tube_link.detector import TubeLinkVIS

    jm = J(backbone=JResNet(depth=18, name="backbone"), num_frames=TUBE,
           use_temporal_attn=False, **NARROW)
    x = jnp.zeros((TUBE, *INPUT_HW, 3), jnp.float32)
    v = jax_init(jm, x, return_query=True, seed=2)
    fwd = jax.jit(lambda vs, im: jm.apply(vs, im, return_query=True))
    model = port(TubeLinkVIS(ResNet(18), CHANS_R18, num_frames=TUBE,
                             use_temporal_attn=False, **NARROW),
                 convert.tube_link_vis(v))
    return jm, v, fwd, model


def test_baseline_tube_matches_jax(baseline):
    """No ``level_3d_encoding``, ``gamma`` or ``temporal_encoder`` on either
    side; every layer's predictions and the final query of one tube."""
    _, v, fwd, model = baseline
    pd = v["params"]["head"]["pixel_decoder"]
    assert "level_3d_encoding" not in pd and "gamma" not in pd["layer0_attn"]
    assert not any("temporal" in k or "gamma" in k or "3d" in k
                   for k in model.state_dict())
    x = np.random.RandomState(4).randn(TUBE, *INPUT_HW, 3).astype(np.float32)
    want = jax.tree.map(np.asarray, fwd(jax.tree.map(jnp.asarray, v),
                                        jnp.asarray(x)))
    with torch.no_grad():
        got = model(t(x), return_query=True)
    assert got["mask_preds"][-1].shape == (1, TUBE, 6, 12, 20)
    for key in ("cls_preds", "mask_preds"):
        assert len(got[key]) == len(want[key]) == 3
        for g, w in zip(got[key], want[key]):
            close(g, w, TOL_MODULE)
    close(got["query"], want["query"], TOL_MODULE)


def test_converter_refuses_a_mismatched_tree(baseline):
    """A tree without the temporal encoder does not load into a model with
    one: the missing keys raise."""
    from axial_vs_tpu_torch.models.backbones.resnet import ResNet
    from axial_vs_tpu_torch.models.tube_link.detector import TubeLinkVIS

    _, v, _, _ = baseline
    with_temporal = TubeLinkVIS(ResNet(18), CHANS_R18, num_frames=TUBE,
                                device=torch.device("meta"), **NARROW)
    with pytest.raises(KeyError, match="temporal_encoder"):
        convert.load_into(with_temporal, convert.tube_link_vis(v))


def _configs(name):
    """The JAX and the port config of the narrow baseline on ``name``."""
    from axial_vs_tpu.config import get_default_config
    from axial_vs_tpu_torch.config import get_default_config as port_default

    cfgs = []
    for cfg in (get_default_config(), port_default()):
        cfg.datasets.test = [name]
        cfg.input.image_size = list(INPUT_HW)
        cfg.model.tube_link.clip_len = TUBE
        cfg.model.tube_link.test_topk = 5
        cfg.model.tube_link.use_temporal_attn = False
        cfgs.append(cfg)
    return cfgs


def test_evaluate_ytvis_matches_jax(baseline, tmp_path, monkeypatch):
    """One 4-frame fixture video (two tubes) through both packages'
    ``evaluate_ytvis``: the same AP/AR fields (equal), and the same
    submission JSON: video, category and RLEs equal, scores within 1e-5
    (each side's softmax of its own logits; only their float repr
    differs)."""
    import axial_vs_tpu.models.tube_link.detector as jdet
    from axial_vs_tpu.data.catalog import DatasetCatalog as JCatalog
    from axial_vs_tpu.data.ytvis import register_ytvis as jregister
    from axial_vs_tpu.engine.evaluator_loop import evaluate_ytvis as jeval
    from axial_vs_tpu_torch.data.catalog import DatasetCatalog
    from axial_vs_tpu_torch.data.ytvis import register_ytvis
    from axial_vs_tpu_torch.engine.evaluator_loop import evaluate_ytvis

    jm, v, fwd, model = baseline
    img_root, js = synthesize_ytvis_videos(str(tmp_path), 1, VIDEO_FRAMES)
    name = "ytvis_eval_parity_val"
    for catalog, register in ((JCatalog, jregister),
                              (DatasetCatalog, register_ytvis)):
        assert name not in catalog
        register(name, img_root, js)
    jv = jax.tree.map(jnp.asarray, v)

    class Compiled(jdet.TubeLinkVISInference):  # the fixture's forward
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)

            def tube_forward(clip):
                out = fwd(jv, clip)
                return (out["cls_preds"][-1][0], out["mask_preds"][-1][0],
                        out["query"][0])

            self._tube_forward = tube_forward

    monkeypatch.setattr(jdet, "TubeLinkVISInference", Compiled)
    jcfg, cfg = _configs(name)
    want = jeval(jcfg, jm, v, format_only_path=str(tmp_path / "jax.json"))
    got = evaluate_ytvis(cfg, model, format_only_path=str(tmp_path / "port.json"))
    assert got["num_videos"] == want["num_videos"] == 1
    assert got["num_predictions"] == want["num_predictions"] == 5
    for k, w in want.items():
        if k != "results_json":
            assert got[k] == w, k
    with open(tmp_path / "jax.json") as f, open(tmp_path / "port.json") as g:
        want_json, got_json = json.load(f), json.load(g)
    assert len(got_json) == 5
    assert any(s is not None for r in got_json for s in r["segmentations"])
    for a, b in zip(got_json, want_json):
        assert abs(a.pop("score") - b.pop("score")) <= 1e-5
        assert a == b


@pytest.mark.parametrize("yaml", ["ytvis19/tube_link_r50.yaml",
                                  "ovis/tube_link_maxtron_wc_r50.yaml"])
def test_train_net_video_eval_only(fixture_root, tmp_path, yaml):
    """``train_net_video --eval-only --format-only`` on a Tube-Link config
    (the baseline, and MaXTron's temporal attention on an OVIS test set),
    narrowed, on the CPU: the YTVIS loop's AP/AR and the submission JSON at
    the videos' size."""
    from axial_vs_tpu_torch.data import mask_rle
    from axial_vs_tpu_torch.data.catalog import DatasetCatalog
    from axial_vs_tpu_torch.data.ytvis import register_ytvis
    from axial_vs_tpu_torch.tools import train_net_video

    name = "ytvis_cli_val" if yaml.startswith("ytvis") else "ovis_cli_val"
    if name not in DatasetCatalog:
        register_ytvis(name, *fixture_root)
    out = str(tmp_path / "results.json")
    res = train_net_video.main([
        "--config-file", yaml, "--eval-only", "--format-only", out,
        "--device", "cpu", "--opts",
        "model.backbone.name", "resnet18", "model.backbone.resnet.depth", "18",
        "model.num_classes", "2", "model.tube_link.num_queries", "6",
        "model.tube_link.feat_channels", "32",
        "model.tube_link.out_channels", "32",
        "model.tube_link.num_decoder_layers", "1",
        "model.tube_link.clip_len", str(TUBE), "model.tube_link.test_topk",
        "4", "input.num_clip_frames", str(TUBE), "input.image_size",
        f"[{INPUT_HW[0]}, {INPUT_HW[1]}]", "datasets.train", "[]",
        "datasets.test", f"[{name}]", "output_dir", str(tmp_path)],
        eval_kwargs={"max_videos": 1})
    assert res["num_videos"] == 1 and res["num_predictions"] == 4
    assert res["results_json"] == out and -1.0 <= res["AP"] <= 1.0
    with open(out) as f:
        preds = json.load(f)
    assert len(preds) == 4
    for r in preds:
        assert r["video_id"] == 1 and r["category_id"] in (1, 2)
        assert len(r["segmentations"]) == 8
        for s in r["segmentations"]:
            assert s is None or mask_rle.decode(s).shape == (96, 160)


def test_builtin_registers_ytvis_splits(fixture_root, tmp_path):
    """``data/builtin.py::register_all`` registers a YTVIS-format split it
    finds in detectron2's layout (``ytvis_2019/valid.json`` with frames
    under ``ytvis_2019/valid/JPEGImages``), with its category map, and
    skips the splits that are not on disk."""
    import shutil

    from axial_vs_tpu_torch.data import builtin
    from axial_vs_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog

    img_root, js = fixture_root
    base = tmp_path / "ytvis_2019"
    shutil.copytree(img_root, base / "valid" / "JPEGImages")
    shutil.copy(js, base / "valid.json")
    names = builtin.register_all(str(tmp_path))
    assert "ytvis_2019_val" in names and "ytvis_2019_train" not in names
    videos = DatasetCatalog.get("ytvis_2019_val")
    assert len(videos) == 2 and all(os.path.exists(f) for v in videos
                                    for f in v["file_names"])
    assert MetadataCatalog.get("ytvis_2019_val").contiguous_to_dataset_id == [1, 2]
