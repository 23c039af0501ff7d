"""Parity of the port's image kMaX-DeepLab path with the JAX package: the
ConvNeXtV2 GRN block and backbone, the image segmenter (T = 1) without and
with the spatial-only WC module, semantic and instance inference, image PQ
and COCO instance AP, the COCO-format data (loaders, registrations, both
training mappers) and ``evaluate_coco_panoptic``; and the builder on every
image yaml.

The same inputs, made with numpy from a seed, go through the JAX function
and the port's, with every parameter randomized (``test_torch_parity.py``'s
``randomize``: GRN's zero-init gamma and beta would make it the identity).
Tolerances: a module ``TOL_MODULE`` (1e-5 of the output scale, f32
rounding); the segmenter ``TOL_SLICE`` (2e-3, as ``test_torch_parity.py::
test_segmenter``); GRN in bf16 ``TOL_ULPS`` (2 bf16 ulp of max|out|: the
f32 sum of squares in another order may round the bf16 ratio the other
way); the post-processing 1e-6 of its scale and its masks, classes and
order exactly; PQ/AP, loaders and mappers exactly (the same numpy code);
``evaluate_coco_panoptic`` within 1e-3 of each PQ figure, as
``test_torch_eval.py`` holds ``evaluate_vipseg``.
"""
import glob
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from axial_vs_tpu_torch.utils import convert
from test_torch_parity import (TOL_MODULE, TOL_SLICE, TOL_ULPS, close,
                               close_ulps, jax_apply, jax_init, port,
                               randomize, small_config, t)
from test_torch_parity import torch_threads  # noqa: F401 (autouse)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
#: the image yamls: COCO, ADE20k and Cityscapes
IMAGE_YAMLS = sorted(
    os.path.relpath(p, CONFIGS) for d in ("coco", "ade20k", "cityscapes")
    for p in glob.glob(os.path.join(CONFIGS, d, "kmax_*.yaml")))


# ------------------------------------------------------- ConvNeXtV2 (K1) ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grn(rng, dtype):
    """GRN alone on an (N, H, W, 4C) activation, in f32 and in bf16 (the
    sum of squares in f32, the ratio cast to bf16, f32 gamma and beta)."""
    from axial_vs_tpu.models.backbones.convnext import GRN as J
    from axial_vs_tpu_torch.models.backbones.convnext import GRN

    x = rng.randn(2, 5, 7, 64).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    jm = J(dim=64)
    v = jax_init(jm, jx)
    assert np.abs(v["params"]["gamma"]).min() > 0
    want = jax_apply(jm, v, jx)
    m = GRN(64)
    m.load_state_dict({k: t(a) for k, a in v["params"].items()})
    got = m(torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        close(got.detach(), want, TOL_MODULE)
    else:
        close_ulps(got.detach(), np.asarray(want, np.float32), TOL_ULPS)


@pytest.mark.parametrize("shape", [(2, 9, 13, 32), (1, 5, 7, 48)])
def test_grn_block(rng, shape):
    """A ConvNeXtV2 block (no layer scale, GRN inside the MLP) on the
    ``"dwln"`` route, in eval and in train mode (the plain modules), with
    its params under the upstream names; the fused routes refuse it."""
    from axial_vs_tpu.models.backbones.convnext import ConvNeXtBlock as J
    from axial_vs_tpu_torch.models.backbones.convnext import ConvNeXtBlock

    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    jm = J(dim=c, use_grn=True)
    v = jax_init(jm, jnp.asarray(x))
    assert "gamma" not in v["params"] and "grn" in v["params"]
    want = jax_apply(jm, v, jnp.asarray(x), train=False)
    sd = convert.convnext_block(v["params"])
    assert {"grn.gamma", "grn.beta"} <= set(sd) and "gamma" not in sd
    block = port(ConvNeXtBlock(c, use_grn=True), sd)
    with torch.no_grad():
        close(block(t(x)), want, TOL_MODULE)
        close(block.train()(t(x)), want, TOL_MODULE)
    for route in ("mlp", "block"):
        with pytest.raises(NotImplementedError, match=route):
            ConvNeXtBlock(c, use_grn=True, block_kernel=route)


@pytest.mark.parametrize("use_scan", [False, True])
def test_convnextv2_backbone(rng, use_scan):
    """A narrow ConvNeXtV2 (GRN) backbone, unrolled and scan-stacked, on a
    65x97 image (the VALID stem's dropped border)."""
    from axial_vs_tpu.models.backbones.convnext import ConvNeXt as J
    from axial_vs_tpu_torch.models.backbones.convnext import ConvNeXt

    depths, dims = (1, 1, 2, 1), (32, 64, 96, 128)
    x = rng.randn(1, 65, 97, 3).astype(np.float32)
    jm = J(depths=depths, dims=dims, use_grn=True, use_scan=use_scan)
    v = jax_init(jm, jnp.asarray(x))
    want = jax_apply(jm, v, jnp.asarray(x), train=False)
    model = port(ConvNeXt(depths, dims, use_grn=True),
                 convert.convnext(v["params"]))
    with torch.no_grad():
        got = model(t(x))
    for k in want:
        close(got[k], want[k], TOL_MODULE)


def test_convnextv2_weights_round_trip():
    """The port's ConvNeXtV2 state_dict in the upstream ConvNeXtV2 layout
    (``stages.{i}.{j}.{dwconv, norm, pwconv1, grn.gamma, grn.beta,
    pwconv2}``), through the JAX package's converter and back through
    ``convert_variables``: every key and value again. One set of weights
    serves both packages."""
    import re

    from axial_vs_tpu.utils.torch_convert import convert_maxtron_wc
    from axial_vs_tpu_torch.models.kmax import build_segmenter

    cfg = _image_config("convnextv2", wc=False)
    model = build_segmenter(cfg, torch.device("cpu"),
                            torch.Generator().manual_seed(3), num_frames=1)
    with torch.no_grad():  # GRN is zero at init: make it count
        for name, p in model.named_parameters():
            if ".grn." in name:
                p.normal_(generator=torch.Generator().manual_seed(4))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    leaf = {"conv_dw": "dwconv", "mlp.fc1": "pwconv1", "mlp.fc2": "pwconv2"}

    def upstream(k):
        m = re.fullmatch(r"backbone\.stages\.(\d)\.blocks\.(\d+)\.(.+)", k)
        if not m:
            return k
        rest = m.group(3)
        for ours, theirs in leaf.items():
            rest = rest.replace(ours, theirs)
        return f"backbone.stages.{m.group(1)}.{m.group(2)}.{rest}"

    variables = convert_maxtron_wc(
        {upstream(k): v for k, v in sd.items()}, backbone="convnext",
        depths=tuple(cfg.model.backbone.convnext.depths),
        dec_layers=tuple(cfg.model.kmax.pixel_dec.dec_layers),
        num_td_layers=sum(cfg.model.kmax.trans_dec.dec_layers))
    assert "wc_module" not in variables["params"]
    back = convert.convert_variables(variables)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=k)


# ------------------------------------------------- the image segmenter ------

def _image_config(backbone: str, wc: bool):
    """``test_torch_parity.py``'s small configuration as the image model
    (``KMaXDeepLab``, T = 1): an R18 or a narrow ConvNeXtV2, with the
    spatial-only WC module of the ``kmax_wc_*`` yamls or without one."""
    cfg = small_config()
    cfg.model.meta_architecture = "KMaXDeepLab"
    if backbone == "resnet18":
        cfg.model.backbone.name = "resnet18"
        cfg.model.backbone.resnet.depth = 18
    else:
        cfg.model.backbone.name = "convnextv2_small_test"
        cfg.model.backbone.convnext.use_grn = True
    cfg.model.maxtron.wc.enable = wc
    cfg.model.maxtron.wc.temporal_layers = 0
    return cfg


@pytest.fixture(scope="module")
def r18_image():
    """The narrow R18 image model without the WC module (``_image_config``,
    2 classes, 33x33 inputs) of both packages on the same weights: every
    parameter N(0, 0.5^2), seed 1 (several segments an image in
    ``evaluate_coco_panoptic``; at most other seeds one query wins every
    pixel)."""
    from axial_vs_tpu.models.kmax import build_segmenter as jbuild
    from axial_vs_tpu_torch.models.kmax import build_segmenter

    cfg = _image_config("resnet18", wc=False)
    cfg.input.image_size = [33, 33]
    cfg.model.num_classes = 2
    jm = jbuild(cfg, num_frames=1, train=False)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 3)), train=False))
    variables = jax.tree.map(jnp.asarray, randomize(shapes, 1, scale=0.5))
    model = port(build_segmenter(cfg, torch.device("cpu"),
                                 torch.Generator().manual_seed(0),
                                 num_frames=1),
                 convert.convert_variables(variables))
    return dict(cfg=cfg, jm=jm, variables=variables, model=model)


def _hold_segmenter(got, want, mask_hw):
    """The image layout (no T axis, JAX's keys) and JAX's outputs within
    ``TOL_SLICE``."""
    assert sorted(got) == sorted(want)
    assert got["pred_masks"].shape == (1, *mask_hw, 16)
    for k in ("pred_logits", "pred_masks", "pixel_feature"):
        close(got[k], want[k], TOL_SLICE)


def test_image_segmenter(rng, r18_image):
    """The image segmenter (T = 1) without the WC module: the R18 of
    ``r18_image`` on a 33x33 input."""
    x = rng.randn(1, 33, 33, 3).astype(np.float32)
    want = jax_apply(r18_image["jm"], r18_image["variables"], jnp.asarray(x),
                     train=False)
    model = r18_image["model"]
    assert model.sem_seg_head.wc_module is None
    with torch.no_grad():
        _hold_segmenter(model(t(x)), want, (9, 9))


def test_image_segmenter_wc(rng):
    """The image segmenter (T = 1) of a narrow ConvNeXtV2 (GRN params
    drawn, not zero) with the spatial-only WC module of the ``kmax_wc_*``
    yamls, on a 65x97 input."""
    from axial_vs_tpu.models.kmax import build_segmenter as jax_build
    from axial_vs_tpu_torch.models.kmax import build_segmenter

    cfg = _image_config("convnextv2", wc=True)
    jm = jax_build(cfg, num_frames=1, train=False)
    x = rng.randn(1, 65, 97, 3).astype(np.float32)
    v = jax_init(jm, jnp.asarray(x), train=False)
    assert "wc_module" in v["params"]
    want = jax_apply(jm, v, jnp.asarray(x), train=False)
    model = build_segmenter(cfg, torch.device("cpu"),
                            torch.Generator().manual_seed(0), num_frames=1)
    assert model.sem_seg_head.wc_module is not None
    with torch.no_grad():
        _hold_segmenter(port(model, convert.convert_variables(v))(t(x)), want,
                        (16, 24))


@pytest.mark.parametrize("yaml", IMAGE_YAMLS)
def test_builder_on_image_yamls(yaml):
    """``build_model_and_criterion`` builds every image yaml (ResNet,
    ConvNeXt, ConvNeXtV2 and Swin backbones) at small widths, the image
    layout out of one forward."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.models.build import build_model_and_criterion

    name = load_config(yaml).model.backbone.name
    opts = ["model.kmax.pixel_dec.dec_layers", [1, 1, 1, 1],
            "model.kmax.pixel_dec.dec_channels", [32, 16, 16, 16],
            "model.kmax.trans_dec.dec_layers", [1, 1, 1],
            "model.kmax.trans_dec.num_object_queries", 8,
            "model.maxtron.wc.dim_feedforward", 32,
            "model.maxtron.wc.conv_dims", 64, "input.image_size", [65, 65]]
    if name.startswith("convnext"):
        opts += ["model.backbone.convnext.depths", [1, 1, 1, 1],
                 "model.backbone.convnext.dims", [32, 64, 96, 128]]
    elif name.startswith("resnet"):
        opts += ["model.backbone.name", "resnet18",
                 "model.backbone.resnet.depth", 18]
    elif name.startswith("swin"):
        opts += ["model.backbone.swin.embed_dim", 32,
                 "model.backbone.swin.depths", [2, 2, 2, 2],
                 "model.backbone.swin.num_heads", [1, 2, 4, 8]]
    cfg = load_config(yaml, opts)
    kw = dict(train=False, device=torch.device("cpu"),
              generator=torch.Generator().manual_seed(0))
    model, _ = build_model_and_criterion(cfg, **kw)
    assert (model.sem_seg_head.wc_module is not None) == cfg.model.maxtron.wc.enable
    grn = [m for m in model.modules() if type(m).__name__ == "GRN"]
    assert bool(grn) == bool(cfg.model.backbone.convnext.use_grn
                             and name.startswith("convnext"))
    with torch.no_grad():
        out = model(torch.randn(1, 65, 65, 3))
    k = cfg.model.num_classes
    assert out["pred_logits"].shape == (1, 8, k + 1)
    assert out["pred_masks"].ndim == 4 and out["pred_masks"].shape[-1] == 8
    assert torch.isfinite(out["pred_masks"]).all()


# ------------------------------------------------------ post-processing -----

def test_semantic_and_instance_inference(rng):
    """Both functions on drawn logits with ties: two slots with equal class
    logits and two classes equal within a slot, so that the top-k meets
    equal scores across and within slots; at k = 10 and at every pair."""
    from axial_vs_tpu.models import postprocess as J
    from axial_vs_tpu_torch.models import postprocess as P

    n, c = 12, 5
    cls = rng.randn(n, c + 1).astype(np.float32) * 2
    cls[7] = cls[3]           # equal scores in two slots
    cls[5, 2] = cls[5, 1]     # and two classes of one slot
    masks = rng.randn(2, 9, 11, n).astype(np.float32) * 3
    things = np.array([True, False, True, True, False])
    want = jax.jit(J.semantic_inference)(jnp.asarray(cls), jnp.asarray(masks))
    got = P.semantic_inference(t(cls), t(masks))
    close(got, want, 1e-6)
    instances = jax.jit(J.instance_inference, static_argnums=3)
    for k in (10, n * c):
        want = instances(jnp.asarray(cls), jnp.asarray(masks),
                         jnp.asarray(things), k)
        got = P.instance_inference(t(cls), t(masks), t(things), k)
        assert sorted(got) == sorted(want)
        for key in ("pred_masks", "pred_classes", "is_thing"):
            assert got[key].dtype == getattr(torch, str(want[key].dtype))
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]), err_msg=key)
        close(got["scores"], want["scores"], 1e-6)


# ------------------------------------------------------------ metrics -------

def _drawn_panoptic(rng, n_images=4, hw=(20, 24)):
    """Images of GT and prediction id maps (0 = void) with segments of 4
    classes, crowd GT among them, and predictions that overlap the GT."""
    images = []
    for i in range(n_images):
        gt = rng.randint(0, 6, hw) + 1
        gt[:2] = 0
        pred = np.where(rng.rand(*hw) < 0.7, gt, rng.randint(1, 8, hw))
        gt_segments = {s: {"category_id": s % 4, "iscrowd": int(s == 6 and i)}
                       for s in np.unique(gt) if s}
        pred_segments = {s: {"category_id": s % 4} for s in np.unique(pred)}
        images.append((gt, pred, gt_segments, pred_segments))
    return images


def test_pq_and_coco_instance_ap(rng):
    """``pq_compute`` and ``coco_instance_ap`` (segm and bbox, with crowd GT
    and an empty prediction) on drawn inputs: the JAX package's dicts."""
    from axial_vs_tpu.evaluation import coco_instance as JI
    from axial_vs_tpu.evaluation.pq import pq_compute as jpq
    from axial_vs_tpu_torch.evaluation import coco_instance as PI
    from axial_vs_tpu_torch.evaluation.pq import pq_compute

    images = _drawn_panoptic(rng)
    categories = {0: {"isthing": 1}, 1: {"isthing": 1}, 2: {"isthing": 0},
                  3: {"isthing": 0}}
    want = jpq(images, categories)
    assert 0 < want["all"]["pq"] < 1
    assert pq_compute(images, categories) == want

    gts, preds = ([], []), ([], [])
    for i in range(3):
        k = 5
        masks = rng.rand(k, 30, 40) < 0.3
        for j in range(k):
            y, x = rng.randint(0, 20, 2)
            masks[j, y:y + 10, x:x + 15] = True
        labels = rng.randint(0, 3, k)
        crowd = (np.arange(k) == 4).astype(int)
        probs = np.clip(masks + rng.randn(k, 30, 40) * 0.4, 0, 1)
        probs[0] = 0.0  # an empty prediction
        scores = rng.rand(k)
        for pkg, out in ((JI, gts), (PI, preds)):
            out[0].extend(pkg.gt_to_records(i, masks, labels, crowd))
            out[1].extend(pkg.instances_to_records(i, probs, labels, scores,
                                                   score_threshold=0.1))
    assert gts[0] == preds[0] and gts[1] == preds[1]
    assert PI.mask_to_box(np.zeros((3, 3))) is None
    want = JI.coco_instance_ap(*gts)
    got = PI.coco_instance_ap(*preds)
    assert set(got) == {"segm", "bbox"} and got == want
    assert PI.coco_instance_ap(*preds, tasks=("segm",)) == want["segm"]


# ------------------------------------------------------------ COCO data -----

def _id2rgb(ids):
    return np.stack([ids % 256, ids // 256 % 256, ids // 65536 % 256],
                    -1).astype(np.uint8)


@pytest.fixture(scope="module")
def coco_files(tmp_path_factory):
    """A COCO-format dataset of 3 images (panoptic PNGs and JSON; an
    instances JSON of polygons, an RLE, a crowd and a crowd-only image) in
    the builtin layout under ``root/coco``."""
    from axial_vs_tpu_torch.data import mask_rle

    root = tmp_path_factory.mktemp("coco_root")
    base = root / "coco"
    images_dir, ann = base / "val2017", base / "annotations"
    pan_dir = ann / "panoptic_val2017"
    for d in (images_dir, pan_dir):
        d.mkdir(parents=True)
    rs = np.random.RandomState(11)
    cats = [dict(id=1, name="person", isthing=1),
            dict(id=3, name="car", isthing=1),
            dict(id=7, name="sky", isthing=0),
            dict(id=9, name="road", isthing=0)]
    images, pan_anns, inst_anns = [], [], []
    for i, (h, w) in enumerate([(60, 80), (72, 56), (50, 90)], 1):
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            images_dir / f"{i:012d}.jpg")
        pan = np.full((h, w), 20, np.int64)             # sky
        pan[h // 2:] = 21                               # road
        pan[5:25, 10:40] = 30 + i                       # a person
        pan[h // 2:h // 2 + 15, w // 2:w // 2 + 20] = 40  # a car
        Image.fromarray(_id2rgb(pan)).save(pan_dir / f"{i:012d}.png")
        images.append(dict(id=i, file_name=f"{i:012d}.jpg", height=h,
                           width=w))
        pan_anns.append(dict(image_id=i, file_name=f"{i:012d}.png",
                             segments_info=[
                                 dict(id=20, category_id=7, iscrowd=0),
                                 dict(id=21, category_id=9, iscrowd=0),
                                 dict(id=30 + i, category_id=1, iscrowd=0),
                                 dict(id=40, category_id=3, iscrowd=int(i == 2))]))
        car = np.zeros((h, w), np.uint8)
        car[h // 2:h // 2 + 15, w // 2:w // 2 + 20] = 1
        inst_anns += [
            dict(id=10 * i, image_id=i, category_id=1, iscrowd=0,
                 segmentation=[[10, 5, 40, 5, 40, 25, 10, 25],
                               [12, 30, 20, 30, 16, 38]]),
            dict(id=10 * i + 1, image_id=i, category_id=3, iscrowd=0,
                 segmentation=mask_rle.encode(car)),
            dict(id=10 * i + 2, image_id=i, category_id=3, iscrowd=1,
                 segmentation=mask_rle.encode(car))]
    images.append(dict(id=4, file_name="000000000001.jpg", height=60,
                       width=80))
    inst_anns.append(dict(id=99, image_id=4, category_id=1, iscrowd=1,
                          segmentation=[[1, 1, 9, 1, 9, 9]]))
    with open(ann / "panoptic_val2017.json", "w") as f:
        json.dump(dict(images=images[:3], annotations=pan_anns,
                       categories=cats), f)
    with open(ann / "instances_val2017.json", "w") as f:
        json.dump(dict(images=images, annotations=inst_anns,
                       categories=[c for c in cats if c["isthing"]]), f)
    return dict(root=str(root), images=str(images_dir), pans=str(pan_dir),
                panoptic=str(ann / "panoptic_val2017.json"),
                instances=str(ann / "instances_val2017.json"))


def test_coco_loaders_and_registration(coco_files):
    """Both JSON loaders give JAX's records; ``data/builtin.py`` registers
    ``coco_2017_val_{panoptic,instance}`` from the builtin layout, with
    JAX's metadata once loaded; ``polygons_to_mask`` equals JAX's."""
    from axial_vs_tpu.data import coco as J
    from axial_vs_tpu.data.catalog import MetadataCatalog as JMeta
    from axial_vs_tpu_torch.data import builtin
    from axial_vs_tpu_torch.data import coco as P
    from axial_vs_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog

    f = coco_files
    args = (f["panoptic"], f["images"], f["pans"])
    assert P.load_coco_panoptic_json(*args) == J.load_coco_panoptic_json(*args)
    got = P.load_coco_instance_json(f["instances"], f["images"])
    assert got == J.load_coco_instance_json(f["instances"], f["images"])
    assert [r["image_id"] for r in got[0]] == [1, 2, 3]  # crowd-only out
    polys = [[3.5, 2, 30, 4, 25.2, 20, 6, 18], [40, 10, 50, 10, 45, 19],
             [1, 1, 2, 2]]
    np.testing.assert_array_equal(P.polygons_to_mask(polys, 24, 56),
                                  J.polygons_to_mask(polys, 24, 56))

    names = {"coco_2017_val_panoptic", "coco_2017_val_instance"}
    for name in names:
        DatasetCatalog._registry.pop(name, None)
    assert set(builtin.register_all(f["root"])) == names
    J.register_coco_panoptic("jax_" + f["root"], f["images"], f["pans"],
                             f["panoptic"])
    from axial_vs_tpu.data.catalog import DatasetCatalog as JCat

    assert (DatasetCatalog.get("coco_2017_val_panoptic")
            == JCat.get("jax_" + f["root"]))
    meta, want = (MetadataCatalog.get("coco_2017_val_panoptic"),
                  JMeta.get("jax_" + f["root"]))
    for key in ("contiguous_to_dataset_id", "thing_dataset_id_to_contiguous_id",
                "stuff_dataset_id_to_contiguous_id", "label_divisor"):
        assert meta[key] == want[key], key
    records = DatasetCatalog.get("coco_2017_val_instance")
    assert len(records) == 3
    assert MetadataCatalog.get("coco_2017_val_instance")[
        "dataset_id_to_contiguous_id"] == {1: 0, 3: 1}


def _equal_trees(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _equal_trees(a[k], b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["panoptic", "instance"])
@pytest.mark.parametrize("copy_paste", [True, False])
def test_coco_mappers(coco_files, kind, copy_paste):
    """Four samples of each mapper from seed 7 (copy-paste on and off),
    equal to the JAX mapper's: the same draws give the same arrays."""
    from axial_vs_tpu.data import coco as J
    from axial_vs_tpu_torch.data import coco as P

    f = coco_files
    kw = dict(image_size=(41, 57), max_instances=6, copy_paste=copy_paste,
              seed=7)
    if kind == "panoptic":
        records, _ = P.load_coco_panoptic_json(f["panoptic"], f["images"],
                                               f["pans"])
        kw["thing_ids"] = [1, 3]
        want, got = J.CocoPanopticMapper(**kw), P.CocoPanopticMapper(**kw)
    else:
        records, cat_map = P.load_coco_instance_json(f["instances"],
                                                     f["images"])
        kw["dataset_id_to_contiguous_id"] = cat_map
        want, got = J.CocoInstanceMapper(**kw), P.CocoInstanceMapper(**kw)
    for i in range(4):
        rec = records[i % len(records)]
        w = want(rec, dataset=records)
        _equal_trees(got(rec, dataset=records), w)
    assert w["images"].shape == (41, 57, 3)
    assert w["targets"]["masks"].shape == (6, 11, 15)


# ------------------------------------------------ evaluate_coco_panoptic ----

@pytest.fixture(scope="module")
def tiny_coco(tmp_path_factory):
    """``tests/test_coco_eval_loop.py``'s fixture (two 24x32 images, a
    thing and a stuff segment each), registered in both packages'
    catalogs."""
    from axial_vs_tpu.data.coco import register_coco_panoptic as jregister
    from axial_vs_tpu_torch.data.coco import register_coco_panoptic

    tmp = tmp_path_factory.mktemp("tiny_coco")
    img_root, pan_root = tmp / "imgs", tmp / "pans"
    img_root.mkdir()
    pan_root.mkdir()
    rng = np.random.RandomState(0)
    images, annos = [], []
    for i in (1, 2):
        Image.fromarray((rng.rand(24, 32, 3) * 255).astype(np.uint8)).save(
            img_root / f"{i:06d}.jpg")
        pan = np.zeros((24, 32), np.int64)
        pan[:, :16] = 7
        pan[:, 16:] = 9
        Image.fromarray(_id2rgb(pan)).save(pan_root / f"{i:06d}.png")
        images.append(dict(id=i, file_name=f"{i:06d}.jpg", height=24,
                           width=32))
        annos.append(dict(image_id=i, file_name=f"{i:06d}.png",
                          segments_info=[
                              dict(id=7, category_id=1, isthing=1, iscrowd=0),
                              dict(id=9, category_id=3, isthing=0,
                                   iscrowd=0)]))
    js = tmp / "panoptic.json"
    with open(js, "w") as f:
        json.dump(dict(images=images, annotations=annos, categories=[
            dict(id=1, name="t", isthing=1), dict(id=3, name="s", isthing=0)]),
            f)
    name = f"torch_image_tiny_coco_{tmp.name}"
    for register in (jregister, register_coco_panoptic):
        register(name, str(img_root), str(pan_root), str(js))
    return name


def _pq_inputs(monkeypatch, module, box: list):
    """``module.pq_compute`` keeping its ``images`` in ``box``."""
    real = module.pq_compute

    def keep(images, categories):
        box.extend(images)
        return real(images, categories)

    monkeypatch.setattr(module, "pq_compute", keep)


def test_evaluate_coco_panoptic_matches_jax(tiny_coco, r18_image,
                                            monkeypatch):
    """``evaluate_coco_panoptic`` of both packages on the tiny fixture and
    ``r18_image``'s model, the class and overlap gates at 0 so that
    segments are accepted: the GT and prediction id maps that reach PQ
    (0.999 of the prediction pixels equal, the same segments), and each
    PQ/SQ/RQ within 1e-3 with the same class counts."""
    import axial_vs_tpu.evaluation.pq as jax_pq
    import axial_vs_tpu_torch.evaluation.pq as port_pq
    from axial_vs_tpu.engine.evaluator_loop import evaluate_coco_panoptic as J
    from axial_vs_tpu_torch.engine.evaluator_loop import evaluate_coco_panoptic

    cfg = r18_image["cfg"].clone()
    cfg.datasets.test = [tiny_coco]
    test = cfg.model.kmax.test
    test.class_threshold_thing = test.class_threshold_stuff = 0.0
    test.overlap_threshold = 0.0
    want_images, got_images = [], []
    _pq_inputs(monkeypatch, jax_pq, want_images)
    _pq_inputs(monkeypatch, port_pq, got_images)
    want = J(cfg, r18_image["jm"], r18_image["variables"])
    got = evaluate_coco_panoptic(cfg, r18_image["model"])
    assert len(got_images) == len(want_images) == 2
    for (gg, gp, ggs, gps), (wg, wp, wgs, wps) in zip(got_images,
                                                      want_images):
        np.testing.assert_array_equal(gg, wg)
        assert ggs == wgs
        assert gp.shape == wp.shape == (24, 32)
        assert len(wps) >= 2 and gps == wps
        assert (gp == wp).mean() >= 0.999
    assert sorted(got) == sorted(want) == ["all", "per_class", "stuff",
                                           "things"]
    assert want["all"]["n"] == 2
    for part in ("all", "things", "stuff"):
        assert got[part]["n"] == want[part]["n"]
        for k in ("pq", "sq", "rq"):
            assert abs(got[part][k] - want[part][k]) <= 1e-3, (part, k)
    for c, res in want["per_class"].items():
        for k in ("pq", "sq", "rq"):
            assert abs(got["per_class"][c][k] - res[k]) <= 1e-3, (c, k)
