"""Parity of the port's cross-clip (CC) stage with the JAX package: the
temporal ASPP, the CC predictor and the CC module, the clip alignment, the
whole ``MaXTronCCModel``, the WC -> CC weight surgery, the CC inference
pipeline and ``build_model_and_criterion``.

Inputs come from numpy seeds and both sides run in f32 on the CPU (the
port's K3 through its plain version). The modules are held to a relative L2
distance of 1e-5 and the whole model to 5e-4 (``MODEL_REL_L2``); the
alignment's permutations and the pipeline's id maps are equal. JAX's whole ``MaXTronCCModel`` is never compiled: its reference
is the composition of its parts, each jitted alone (the segmenter once per
clip shape, ``align_clip_queries`` and the CC module), in the order of its
``__call__``, on the R18 configuration of ``tests/test_maxtron_cc.py`` with
a one-layer within-clip module (the port's segmenter needs one).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from axial_vs_tpu_torch.utils import convert
from test_torch_parity import jax_apply, jax_init, port, randomize, t
from test_torch_parity import numpy_lsap, torch_threads  # noqa: F401 (autouse)

#: bound on |port - JAX|_2 / |JAX|_2 of every module output
REL_L2 = 1e-5
#: the same bound for the whole model's outputs: the segmenter's f32 sums
#: run in other orders on each side (its outputs differed by up to 1.4e-5
#: on seeds 0-2, the CC outputs by up to 8.6e-5); the segmenter's own
#: slice bound in tests/test_torch_parity.py is 2e-3
MODEL_REL_L2 = 5e-4
C, QUERIES, CLIPS, LAYERS, V = 256, 8, 3, 2, 2  # V: frames a clip
NUM_CLASSES = 5  # without void


def rel_l2(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _pixels(rng, clips=CLIPS, h=6, w=5):
    return rng.randn(clips, V * h, w, 128).astype(np.float32)


def test_temporal_aspp_matches_jax(rng):
    from axial_vs_tpu.models.cc_module import TemporalASPP1D as J
    from axial_vs_tpu_torch.models.cc_module import TemporalASPP1D

    x = rng.randn(QUERIES, CLIPS, C).astype(np.float32)
    jm = J(output_channels=C)
    v = jax_init(jm, jnp.asarray(x))
    want = jax_apply(jm, v, jnp.asarray(x))
    got = port(TemporalASPP1D(C), convert.temporal_aspp(v["params"]))
    assert rel_l2(got(t(x)), want) <= REL_L2


def test_cc_predictor_matches_jax(rng):
    from axial_vs_tpu.models.cc_module import MaXTronCCPredictor as J
    from axial_vs_tpu_torch.models.cc_module import MaXTronCCPredictor

    mask_emb, class_emb = (rng.randn(CLIPS, QUERIES, 256).astype(np.float32)
                           for _ in range(2))
    pix = _pixels(rng)
    jm = J(num_classes=NUM_CLASSES + 1, num_clip_frames=V)
    args = [jnp.asarray(a) for a in (mask_emb, class_emb, pix)]
    v = jax_init(jm, *args)
    want = jax_apply(jm, v, *args)
    got = port(MaXTronCCPredictor(NUM_CLASSES + 1, V),
               convert.cc_predictor(v["params"], v["batch_stats"]))
    out = got(t(mask_emb), t(class_emb), t(pix))
    assert out["mask_logits"].shape == (CLIPS * V, 6, 5, QUERIES)
    for k in ("class_logits", "mask_logits"):
        assert rel_l2(out[k], want[k]) <= REL_L2, k


def test_cc_module_matches_jax(rng):
    from axial_vs_tpu.models.cc_module import CrossClipTrackingModule as J
    from axial_vs_tpu_torch.models.cc_module import CrossClipTrackingModule

    query = rng.randn(1, QUERIES, CLIPS, C).astype(np.float32)
    pix = _pixels(rng)
    jm = J(num_classes=NUM_CLASSES, num_layers=LAYERS, num_clip_frames=V)
    args = (jnp.asarray(query), jnp.asarray(pix))
    v = jax_init(jm, *args)
    want = jax_apply(jm, v, *args)
    model = CrossClipTrackingModule(NUM_CLASSES, LAYERS, V)
    got = port(model, convert.cc_module(v["params"], v["batch_stats"]))(
        t(query), t(pix))
    # one projection pair and one predictor for all the layers
    assert sum(k.startswith("_predictor.") for k in model.state_dict()) == 13
    assert len(got["aux_outputs"]) == LAYERS - 1
    pairs = [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"]))
    for g, w in pairs:
        for k in ("pred_logits", "pred_masks"):
            assert rel_l2(g[k], w[k]) <= REL_L2, k


def _embeddings(rng, clips=4, n=QUERIES, d=128):
    """Each clip's slots are a permutation of one set of unit vectors plus
    noise, so that the best alignment is clear of ties."""
    base = rng.randn(n, d)
    out = np.stack([base[rng.permutation(n)] + 0.05 * rng.randn(n, d)
                    for _ in range(clips)])
    return out.astype(np.float32), rng.randn(clips, n, 256).astype(np.float32)


@pytest.mark.parametrize("exact", [True, False])
def test_align_clip_queries_matches_jax(rng, exact):
    """Equal permutations and aligned centers from the same embeddings, and
    equal assignments on each cost array that JAX's alignment solved."""
    from axial_vs_tpu.models.maxtron_cc import align_clip_queries as jalign
    from axial_vs_tpu.ops.hungarian import hungarian_assign as jassign
    from axial_vs_tpu_torch.models.maxtron_cc import align_clip_queries
    from axial_vs_tpu_torch.ops.hungarian import hungarian_assign

    embds, centers = _embeddings(rng)
    want_c, want_p = jax.jit(functools.partial(jalign, exact=exact))(
        jnp.asarray(embds), jnp.asarray(centers))
    got_c, got_p = align_clip_queries(t(embds), t(centers), exact)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert not (np.asarray(want_p) == np.arange(QUERIES)).all()

    matched = embds[0]
    valid = np.ones((1, QUERIES), bool)
    for i in range(1, len(embds)):
        def unit(x):
            return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
        cost = (1.0 - unit(embds[i]) @ unit(matched).T)[None].astype(np.float32)
        want = np.asarray(jassign(jnp.asarray(cost), jnp.asarray(valid), exact))
        got = hungarian_assign(t(cost), t(valid), exact)
        np.testing.assert_array_equal(got.numpy(), want)
        matched = embds[i][np.clip(want[0], 0, None)]


# ------------------------------------------------- the whole CC model ----

def _tiny_config(name=None):
    """``tests/test_maxtron_cc.py``'s R18 configuration with a within-clip
    module of one spatial and one temporal layer."""
    from axial_vs_tpu.config import get_default_config

    cfg = get_default_config()
    cfg.model.backbone.name = "resnet18"
    cfg.model.backbone.resnet.depth = 18
    cfg.model.num_classes = NUM_CLASSES
    cfg.model.kmax.pixel_dec.dec_channels = [32, 24, 16, 8]
    cfg.model.kmax.pixel_dec.dec_layers = [1, 1, 1, 1]
    cfg.model.kmax.trans_dec.dec_layers = [1, 1, 1]
    cfg.model.kmax.trans_dec.num_object_queries = QUERIES
    cfg.input.image_size = [64, 64]
    w = cfg.model.maxtron.wc
    w.enable, w.conv_dims, w.dim_feedforward = True, 64, 96
    w.spatial_layers, w.temporal_layers = 1, 1
    cfg.model.maxtron.cc.num_layers = LAYERS
    if name:
        cfg.datasets.test = [name]
    return cfg


@pytest.fixture(scope="module")
def cc_models():
    """The JAX segmenter with random variables (every parameter N(0,
    0.3^2): at 0.1 the decoder's slots collapse, at 0.5 its outputs reach
    1e10 and JAX's CC attention overflows) and the CC module at its inits,
    the JAX composition of the CC model's forward, and the port's
    ``MaXTronCCModel`` carrying the same weights."""
    from axial_vs_tpu.models.cc_module import CrossClipTrackingModule as JCC
    from axial_vs_tpu.models.kmax import build_segmenter as jbuild
    from axial_vs_tpu.models.maxtron_cc import align_clip_queries as jalign
    from axial_vs_tpu_torch.models.cc_module import CrossClipTrackingModule
    from axial_vs_tpu_torch.models.kmax import build_segmenter
    from axial_vs_tpu_torch.models.maxtron_cc import MaXTronCCModel

    cfg = _tiny_config()
    jseg = jbuild(cfg, num_frames=V, train=False)
    jcc = JCC(num_classes=NUM_CLASSES, num_layers=LAYERS, num_clip_frames=V)
    h, w = cfg.input.image_size
    seg_v = randomize(jax.eval_shape(lambda: jseg.init(
        jax.random.PRNGKey(0), jnp.zeros((V, h, w, 3)), train=False)), 5,
        scale=0.3)
    cc_v = jax.tree.map(np.array, jax.jit(lambda key: jcc.init(
        key, jnp.zeros((1, QUERIES, 2, 256)),
        jnp.zeros((2, V * h // 4, w // 4, 128)), train=False))(
            jax.random.PRNGKey(6)))
    # at its own inits the CC module keeps the slots apart, but no class
    # beats void and no mask passes the pixel threshold: a wider class head
    # with void pushed down, and a wider mask norm (the pixel features are
    # unit vectors), so that a segment is accepted
    pred = cc_v["params"]["predictor"]
    pred["transformer_class_head"]["conv"]["kernel"] *= 100.0
    pred["transformer_class_head"]["conv"]["bias"][-1] = -20.0
    pred["pixel_space_mask_batch_norm"]["scale"][:] = 3.0
    variables = {col: {"segmenter": seg_v[col], "cc_module": cc_v[col]}
                 for col in ("params", "batch_stats")}
    variables = jax.tree.map(jnp.asarray, variables)

    seg_fn = jax.jit(lambda v, x: jseg.apply(v, x, train=False))
    align_fn = jax.jit(functools.partial(jalign, exact=False))
    cc_fn = jax.jit(lambda v, q, p: jcc.apply(v, q, p, train=False))

    def forward(images):
        """``MaXTronCCModel.__call__`` of the JAX package, part by part."""
        sv = {c: variables[c]["segmenter"] for c in variables}
        outs = [seg_fn(sv, images[i:i + V]) for i in range(0, len(images), V)]
        stack = {k: jnp.stack([o[k][0] for o in outs])
                 for k in ("pred_mask_embeddings", "cluster_centers",
                           "pixel_feature", "pred_logits")}
        aligned, perms = align_fn(stack["pred_mask_embeddings"],
                                  stack["cluster_centers"])
        pix = stack["pixel_feature"]
        tc, vv, ph, pw, pc = pix.shape
        out = cc_fn({c: variables[c]["cc_module"] for c in variables},
                    aligned.transpose(1, 0, 2)[None],
                    pix.reshape(tc, vv * ph, pw, pc))
        out["clip_perms"] = perms
        out["clip_pred_logits"] = stack["pred_logits"]
        out["clip_pred_masks"] = jnp.concatenate(
            [o["pred_masks"][0] for o in outs], 0)
        return out

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    model = MaXTronCCModel(
        build_segmenter(cfg, cpu, gen, num_frames=V),
        CrossClipTrackingModule(NUM_CLASSES, LAYERS, V), num_clip_frames=V)
    model = port(model, convert.maxtron_cc(variables))
    return dict(cfg=cfg, variables=variables, forward=forward, model=model)


def test_cc_model_matches_jax(cc_models, rng):
    """The port's whole model on a 3-clip video against JAX's parts: the
    same permutations, and each output within the bound."""
    frames = rng.randn(CLIPS * V, 64, 64, 3).astype(np.float32)
    want = cc_models["forward"](jnp.asarray(frames))
    with torch.no_grad():
        got = cc_models["model"](t(frames))
    np.testing.assert_array_equal(got["clip_perms"].numpy(),
                                  np.asarray(want["clip_perms"]))
    assert got["pred_masks"].shape == (1, CLIPS * V, 16, 16, QUERIES)
    assert got["pred_logits"].shape == (1, QUERIES, NUM_CLASSES + 1)
    for k in ("clip_pred_logits", "clip_pred_masks", "pred_logits"):
        assert rel_l2(got[k], want[k]) <= MODEL_REL_L2, k
    assert rel_l2(got["pred_masks"][0], want["pred_masks"]) <= MODEL_REL_L2
    for g, w in zip(got["aux_outputs"], want["aux_outputs"]):
        assert rel_l2(g["pred_logits"], w["pred_logits"]) <= MODEL_REL_L2
        assert rel_l2(g["pred_masks"][0], w["pred_masks"]) <= MODEL_REL_L2
    # the segmenter stays frozen whatever mode the model is in
    cc_models["model"].train()
    assert not cc_models["model"].segmenter.training
    cc_models["model"].eval()


def test_prepare_cc_weights_matches_jax(cc_models):
    """The port's surgery on the converted state_dict equals the conversion
    of JAX's surgery on the variables (the segmenter's tree and the CC
    module side by side, as JAX's ``prepare_cc_weights`` takes them)."""
    from axial_vs_tpu.utils.torch_convert import prepare_cc_weights as jprep
    from axial_vs_tpu_torch.utils.convert import prepare_cc_weights

    variables = jax.tree.map(np.asarray, cc_models["variables"])
    flat = {col: {**variables[col]["segmenter"],
                  "cc_module": variables[col]["cc_module"]}
            for col in variables}
    done = jprep(flat)
    nested = {col: {"segmenter": {k: v for k, v in done[col].items()
                                  if k != "cc_module"},
                    "cc_module": done[col]["cc_module"]} for col in done}
    want = convert.maxtron_cc(nested)
    before = convert.maxtron_cc(variables)
    got = prepare_cc_weights(before)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cloned = {k for k in want if not np.array_equal(want[k], before[k])}
    # three BN'd convs (5 leaves each), a biased conv (2) and a BN (4)
    assert len(cloned) == 21 and all(k.startswith("cc_module.") for k in cloned)
    # on a WC segmenter's own state_dict, whose keys lack "segmenter."
    wc = {k[len("segmenter."):]: v for k, v in before.items()
          if k.startswith("segmenter.")}
    assert set(prepare_cc_weights(wc)) - set(wc) == cloned


def test_cc_pipeline_matches_jax(cc_models, tmp_path):
    """``CCInferencePipeline`` of both packages on a 3-frame 48x72 video
    (padded to 2 clips by repeating its last frame): equal id maps. The JAX
    pipeline's whole-video forward is the composition of its parts."""
    from axial_vs_tpu.models.video_inference import CCInferencePipeline as J
    from axial_vs_tpu_torch.models.video_inference import CCInferencePipeline

    cfg = cc_models["cfg"]
    test = cfg.model.maxtron.test
    args = dict(
        num_clip_frames=V, input_size=cfg.input.image_size,
        pixel_mean=cfg.input.pixel_mean, pixel_std=cfg.input.pixel_std,
        thing_class_mask=np.arange(NUM_CLASSES) >= 2,
        contiguous_to_dataset_id=np.arange(NUM_CLASSES, dtype=np.int32) * 10 + 1,
        label_divisor=1000,
        pixel_confidence_threshold=test.pixel_confidence_threshold,
        class_threshold_thing=test.class_threshold_thing,
        class_threshold_stuff=test.class_threshold_stuff)
    jpipe = J(None, cc_models["variables"], **args)

    def video_forward(images):
        out = cc_models["forward"](images)
        return out["pred_logits"][0], out["pred_masks"]

    jpipe._video_forward = video_forward
    pipe = CCInferencePipeline(cc_models["model"], **args)
    frames = np.random.RandomState(3).randint(0, 255, (3, 48, 72, 3), np.uint8)
    want, want_result, _ = jpipe.run_video(frames)
    got, result, _ = pipe.run_video(frames)
    assert got.shape == (3, 48, 72) and got.dtype == np.int32
    assert (want >= 1000).any(), "no thing at all: the comparison is vacuous"
    np.testing.assert_array_equal(got, want)
    for field, w in zip(result._fields, want_result):
        np.testing.assert_array_equal(getattr(result, field), np.asarray(w),
                                      err_msg=field)


def test_build_cc_model_on_cpu():
    """``build_model_and_criterion`` on ``configs/vipseg/
    maxtron_cc_convnext_large.yaml`` (its backbone cut to one block a stage
    of 32-256 channels, so that the CPU builds it quickly): the CC model of
    the yaml's module, a bf16 segmenter under an f32 CC
    module, the class and mask losses, the card by default."""
    import inspect

    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.models.build import build_model_and_criterion
    from axial_vs_tpu_torch.models.maxtron_cc import MaXTronCCModel

    assert inspect.signature(build_model_and_criterion).parameters[
        "device"].default == torch.device("cuda")
    cfg = load_config("vipseg/maxtron_cc_convnext_large.yaml", [
        "model.backbone.convnext.depths", "[1, 1, 1, 1]",
        "model.backbone.convnext.dims", "[32, 64, 128, 256]"])
    assert cfg.model.meta_architecture == "MaXTronCCDeepLab"
    model, criterion = build_model_and_criterion(
        cfg, train=False, device=torch.device("cpu"),
        generator=torch.Generator().manual_seed(0))
    assert isinstance(model, MaXTronCCModel)
    assert criterion.losses == ("labels", "masks")
    assert not model.training and not model.segmenter.training
    cc = model.cc_module
    assert len(cc.transformer_trajectory_self_attention_layers) == 6
    assert cc._predictor._transformer_class_head.conv.weight.shape[0] == 125
    assert model.segmenter.sem_seg_head.predictor.num_frames == 2
    assert model.segmenter.sem_seg_head.predictor._cluster_centers.weight.dtype \
        == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in cc.parameters())
    with pytest.raises(TypeError):  # the weights come only from a generator
        build_model_and_criterion(cfg, train=False, device=torch.device("cpu"))


def test_evaluate_vipseg_runs_the_cc_pipeline(cc_models, tmp_path):
    """``evaluate_vipseg(..., pipeline_cls=CCInferencePipeline)`` over two
    synthetic videos of 3 and 4 frames: the ids it scores are the CC
    pipeline's (held to JAX's above), and VPQ and STQ lie in [0, 1]."""
    from PIL import Image

    from axial_vs_tpu_torch.data.catalog import DatasetCatalog
    from axial_vs_tpu_torch.data.synthetic import write_vipseg_videos
    from axial_vs_tpu_torch.data.vipseg import (register_vipseg_video,
                                                set_panoptic_metadata)
    from axial_vs_tpu_torch.engine import evaluator_loop
    from axial_vs_tpu_torch.models.video_inference import CCInferencePipeline

    name = f"torch_cc_vipseg_{tmp_path.name}"
    paths, categories = write_vipseg_videos(
        str(tmp_path / "data"), (3, 4), (48, 72), 0, thing=2, stuff=4,
        num_classes=NUM_CLASSES, num_things=3)
    set_panoptic_metadata(register_vipseg_video(name, *paths), categories)
    cfg = _tiny_config(name)
    cfg.output_dir = str(tmp_path / "out")
    scored = []
    real = CCInferencePipeline.run_video

    def run_video(self, frames, *args):
        out = real(self, frames, *args)
        scored.append((frames, out[0]))
        return out

    CCInferencePipeline.run_video = run_video
    try:
        res = evaluator_loop.evaluate_vipseg(
            cfg, cc_models["model"], compute_stq=True,
            pipeline_cls=CCInferencePipeline)
    finally:
        CCInferencePipeline.run_video = real
    videos = DatasetCatalog.get(name)
    assert [len(ids) for _, ids in scored] == [3, 4]
    pipe = evaluator_loop.wc_pipeline(cfg, cc_models["model"], name,
                                      CCInferencePipeline)
    for video, (frames, ids) in zip(videos, scored):
        want = np.stack([np.asarray(Image.open(f["file_name"]).convert("RGB"))
                         for f in video["frames"]])
        np.testing.assert_array_equal(frames, want)
        np.testing.assert_array_equal(ids, pipe.run_video(frames)[0])
    assert 0.0 <= res["vpq"] <= 1.0 and 0.0 <= res["stq"]["STQ"] <= 1.0
    assert set(res["per_window"]) == {1, 2, 4, 6}
