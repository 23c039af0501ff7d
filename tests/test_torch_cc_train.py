"""Training of the port's cross-clip (CC) stage against the JAX package, on
the CPU in f32: the CC module in train mode (outputs and BatchNorm
statistics), the CC loss and the CC module's gradients, one AdamW update,
the optimizer's parameter rules, a whole CC ``train_step`` with the
segmenter frozen, the WC -> CC weight function, the ``Trainer`` on a CC
config, and the two overfit tools.

The JAX side runs the CC module, the criterion and the optimizer alone, fed
the same aligned cluster centers and pixel features as numpy (the
segmenter's outputs): JAX's whole ``MaXTronCCModel`` is never compiled (its
jit outlasts a minute), and neither is its segmenter under ``jax.grad``.
The port's K3 runs its plain version here.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from flax import traverse_util

from axial_vs_tpu_torch.utils import convert
from test_torch_parity import jax_init, randomize, t
from test_torch_parity import numpy_lsap, torch_threads  # noqa: F401 (autouse)

#: bound on |port - JAX|_2 / |JAX|_2 of the CC module's outputs and of its
#: BatchNorm statistics after the forward
REL_L2 = 1e-5
#: the losses of one step, relative
TOL_LOSS = 1e-5
#: each gradient tensor, relative to its max (``tests/test_torch_train.py``)
TOL_GRAD = 1e-4
#: f32 rounding noise of a gradient that is zero in exact arithmetic (a
#: bias before a softmax over clips or before the shared projections'
#: train-mode BatchNorm), relative to the largest gradient: the last
#: layer's ``conv_norms`` bias read 1.6e-7 in JAX and the port alike
GRAD_NOISE = 1e-6
#: AdamW's parameters after one update, relative to each tensor's max
TOL_ADAMW = 1e-6
C, QUERIES, CLIPS, LAYERS, V = 256, 8, 4, 2, 2  # V: frames a clip
NUM_CLASSES, GT = 5, 3  # classes without void; GT segments of the video
PH, PW = 6, 5  # the pixel features' grid a frame
WEIGHTS = {"loss_ce": 3.0, "loss_mask": 0.3, "loss_dice": 3.0}


def rel_l2(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def cc():
    """JAX's CC module with random variables (BatchNorm statistics too),
    the port's module carrying them, and seeded inputs: the aligned
    centers (1, Q, clips, C), the pixel features (clips, V*PH, PW, 128)
    and targets of ``GT`` segments over the video's frames."""
    from axial_vs_tpu.models.cc_module import CrossClipTrackingModule as J

    rng = np.random.RandomState(0)
    query = rng.randn(1, QUERIES, CLIPS, C).astype(np.float32)
    pix = rng.randn(CLIPS, V * PH, PW, 128).astype(np.float32)
    targets = {
        "labels": rng.randint(0, NUM_CLASSES, (1, GT)),
        "masks": (rng.rand(1, GT, CLIPS * V, PH, PW) > 0.6).astype(np.float32),
        "valid": np.ones((1, GT), bool)}
    jm = J(num_classes=NUM_CLASSES, num_layers=LAYERS, num_clip_frames=V)
    v = jax_init(jm, jnp.asarray(query), jnp.asarray(pix))
    return dict(jm=jm, v=v, query=query, pix=pix, targets=targets)


def _port_module(v, train=True):
    from axial_vs_tpu_torch.models.cc_module import CrossClipTrackingModule

    model = CrossClipTrackingModule(NUM_CLASSES, LAYERS, V)
    convert.load_into(model, convert.cc_module(v["params"], v["batch_stats"]))
    return model.train(train)


def _video(out):
    """The CC model's batch axis on the masks, as ``MaXTronCCModel`` adds
    it."""
    return {**out, "pred_masks": out["pred_masks"][None],
            "aux_outputs": [{**a, "pred_masks": a["pred_masks"][None]}
                            for a in out["aux_outputs"]]}


def test_cc_module_train_matches_jax(cc):
    """The CC module in ``train()`` (dropout 0) against JAX's ``apply(...,
    train=True, mutable=["batch_stats"])``: every output and every
    BatchNorm statistic after the forward. The projections and the
    predictor are shared by the layers, so their statistics take one
    momentum update a layer call in both (the random initial statistics
    make one update or two tell apart)."""
    jm, v = cc["jm"], cc["v"]
    args = (jnp.asarray(cc["query"]), jnp.asarray(cc["pix"]))
    want, new = jax.jit(lambda vv: jm.apply(vv, *args, train=True,
                                            mutable=["batch_stats"]))(v)
    model = _port_module(v)
    calls = []
    model._predictor._pixel_space_mask_batch_norm.register_forward_hook(
        lambda *_: calls.append(1))
    got = model(t(cc["query"]), t(cc["pix"]), torch.Generator())
    assert len(calls) == LAYERS
    pairs = [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"]))
    for g, w in pairs:
        for k in ("pred_logits", "pred_masks"):
            assert rel_l2(g[k], w[k]) <= REL_L2, k
    sd = convert.cc_module(v["params"], jax.tree.map(np.asarray,
                                                     new["batch_stats"]))
    stats = {n: b for n, b in model.state_dict().items() if "running" in n}
    assert len(stats) == 2 * 4  # two projections, the mask head, the BN
    for n, b in stats.items():
        assert rel_l2(b, sd[n]) <= REL_L2, n


def test_cc_dropout_draws_from_the_generator(cc):
    """The CC module's attention and ASPP dropouts in ``train()``: a
    positive rate without a generator raises; the same seed draws the same
    masks, another seed others."""
    from axial_vs_tpu_torch.models.cc_module import CrossClipTrackingModule

    model = CrossClipTrackingModule(NUM_CLASSES, 1, V, attn_drop=0.1,
                                    aspp_drop=0.1)
    sd = {k: v for k, v in convert.cc_module(cc["v"]["params"],
                                             cc["v"]["batch_stats"]).items()
          if not k.startswith(("transformer_trajectory_self_attention_layers.1",
                               "conv_short_aggregate_layers.1", "conv_norms.1"))}
    convert.load_into(model, sd)
    model.train()
    q, p = t(cc["query"]), t(cc["pix"])
    with pytest.raises(TypeError, match="Generator"):
        model(q, p)
    a, b, c = (model(q, p, torch.Generator().manual_seed(s))["pred_masks"]
               for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_cc_loss_and_gradients_match_jax(cc):
    """JAX's ``SetCriterion(losses=("labels", "masks"))`` on the CC
    module's train-mode outputs, under ``jax.value_and_grad`` over the CC
    module's parameters only, against the port's criterion and autograd:
    every loss of the video-level tube matching (the last layer's and the
    aux layer's) and every parameter's gradient."""
    from axial_vs_tpu.losses.criterion import SetCriterion as J
    from axial_vs_tpu_torch.losses.criterion import SetCriterion

    jm, v = cc["jm"], cc["v"]
    args = (jnp.asarray(cc["query"]), jnp.asarray(cc["pix"]))
    jtg = {k: jnp.asarray(x) for k, x in cc["targets"].items()}
    jcrit = J(NUM_CLASSES, weights=WEIGHTS, losses=("labels", "masks"))

    def loss(params):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          *args, train=True, mutable=["batch_stats"])
        losses = jcrit(jax.random.PRNGKey(0), _video(out), jtg)
        return jcrit.weighted_total(losses), losses

    (jtotal, jlosses), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])
    model = _port_module(v)
    crit = SetCriterion(NUM_CLASSES, weights=WEIGHTS,
                        losses=("labels", "masks"))
    out = _video(model(t(cc["query"]), t(cc["pix"]), torch.Generator()))
    losses = crit(out, {k: t(x) for k, x in cc["targets"].items()},
                  torch.Generator())
    total = crit.weighted_total(losses)
    total.backward()
    assert set(losses) == set(jlosses) == {
        "loss_ce", "loss_mask", "loss_dice", "loss_ce_0", "loss_mask_0",
        "loss_dice_0"}
    for k, w in [*jlosses.items(), ("total", jtotal)]:
        g = total if k == "total" else losses[k]
        assert abs(g.item() - float(w)) <= TOL_LOSS * abs(float(w)), k
    zero = jax.tree.map(np.zeros_like, v["batch_stats"])
    want = convert.cc_module(jax.tree.map(np.asarray, grads), zero)
    largest = max(np.abs(w).max() for w in want.values())
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for n, p in named.items():
        err = np.abs(p.grad.numpy() - want[n]).max()
        assert err <= max(TOL_GRAD * np.abs(want[n]).max(),
                          GRAD_NOISE * largest), n


def _jax_cfg():
    from axial_vs_tpu.config import get_default_config

    cfg = get_default_config()
    cfg.merge_from_file("configs/vipseg/maxtron_cc_r50.yaml")
    return cfg


def test_cc_param_rules_match_jax(cc):
    """Every CC parameter's (lr_mult, wd) equals JAX's rule for the flax
    path that ``convert.cc_module`` carries into it, on the CC yaml (the
    0.1 head multiplier; no decay on the LayerNorms of the trajectory
    layers, ``conv_norms`` and the ASPP projection, nor on biases)."""
    from axial_vs_tpu.engine.optim import param_rules as jax_rules
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.engine.optim import param_rules

    flat = traverse_util.flatten_dict(cc["v"]["params"], sep="/")
    paths = sorted(flat)
    ids = traverse_util.unflatten_dict(
        {p: np.full(flat[p].shape, i, np.float64)
         for i, p in enumerate(paths)}, sep="/")
    sd = convert.cc_module(ids, jax.tree.map(np.zeros_like,
                                             cc["v"]["batch_stats"]))
    want = jax_rules(_jax_cfg())
    got = param_rules(load_config("vipseg/maxtron_cc_r50.yaml"))
    names = [n for n, _ in _port_module(cc["v"]).named_parameters()]
    assert len(names) == len(paths)
    seen = set()
    for name in names:
        (i,) = np.unique(sd[name])
        rule = got(f"cc_module.{name}")
        assert rule == pytest.approx(want("cc_module/" + paths[int(i)])), name
        seen.add(rule)
    assert seen == {(0.1, 0.05), (0.1, 0.0), (1.0, 0.05), (1.0, 0.0)}


def test_cc_adamw_update_matches_jax(cc):
    """One update of the port's AdamW and schedule on the CC module against
    JAX's ``build_optimizer`` on the CC yaml from the same parameters and
    gradients."""
    from axial_vs_tpu.engine.lr_schedule import tf2_warmup_poly_lr as jsched
    from axial_vs_tpu.engine.optim import build_optimizer as jax_build
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.engine.lr_schedule import tf2_warmup_poly_lr
    from axial_vs_tpu_torch.engine.optim import build_optimizer

    v = cc["v"]
    rng = np.random.RandomState(3)
    params = {"cc_module": v["params"]}
    grads = jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.1).astype(
        np.float32), params)
    tx = jax_build(_jax_cfg(), params, jsched(1e-3, 100, warmup_iters=0))
    jp = jax.tree.map(jnp.asarray, params)
    upd, _ = jax.jit(tx.update)(jax.tree.map(jnp.asarray, grads),
                                tx.init(jp), jp)
    jp = optax.apply_updates(jp, upd)

    zero = jax.tree.map(np.zeros_like, v["batch_stats"])
    model = torch.nn.ModuleDict({"cc_module": _port_module(v)})
    opt, sched = build_optimizer(load_config("vipseg/maxtron_cc_r50.yaml"),
                                 model, tf2_warmup_poly_lr(1e-3, 100,
                                                           warmup_iters=0))
    gsd = convert.cc_module(grads["cc_module"], zero)
    for n, p in model.named_parameters():
        p.grad = t(gsd[n[len("cc_module."):]])
    opt.step()
    sched.step()
    want = convert.cc_module(jax.tree.map(np.asarray, jp["cc_module"]), zero)
    start = convert.cc_module(v["params"], zero)
    moved = 0.0
    for n, p in model.named_parameters():
        k = n[len("cc_module."):]
        err = np.abs(p.detach().numpy() - want[k]).max()
        assert err <= TOL_ADAMW * np.abs(want[k]).max(), n
        moved = max(moved, float(np.abs(want[k] - start[k]).max()))
    assert moved > 1e-4


# ------------------------------------------------ a whole small CC model ----

#: ``tests/test_maxtron_cc.py``'s R18 configuration, its within-clip module
#: cut to one spatial and one temporal layer as ``tests/test_torch_cc.py``
#: cuts it, 2 CC layers, one video a step
TINY = ["model.backbone.name", "resnet18", "model.backbone.resnet.depth", 18,
        "model.num_classes", NUM_CLASSES, "input.image_size", [64, 64],
        "model.kmax.pixel_dec.dec_channels", [32, 24, 16, 8],
        "model.kmax.pixel_dec.dec_layers", [1, 1, 1, 1],
        "model.kmax.trans_dec.dec_layers", [1, 1, 1],
        "model.kmax.trans_dec.num_object_queries", QUERIES,
        "model.maxtron.wc.conv_dims", 64,
        "model.maxtron.wc.dim_feedforward", 96,
        "model.maxtron.wc.spatial_layers", 1,
        "model.maxtron.wc.temporal_layers", 1,
        "model.maxtron.cc.num_layers", LAYERS, "solver.ims_per_batch", 1]


def _tiny_cc(extra=()):
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.models.build import build_model_and_criterion

    cfg = load_config("vipseg/maxtron_cc_r50.yaml", TINY + list(extra))
    model, crit = build_model_and_criterion(
        cfg, train=True, device=torch.device("cpu"),
        generator=torch.Generator().manual_seed(0))
    return cfg, model, crit


def test_cc_train_step_freezes_the_segmenter():
    """``build_model_and_criterion(train=True)`` on the CC yaml, then two
    ``train_step``s on an 8-frame video: the optimizer holds every CC
    parameter and no segmenter one; every segmenter tensor, BatchNorm
    statistics included, is bitwise unchanged; the CC module moved."""
    from axial_vs_tpu_torch.engine.lr_schedule import tf2_warmup_poly_lr
    from axial_vs_tpu_torch.engine.optim import build_optimizer
    from axial_vs_tpu_torch.engine.train_step import train_step

    cfg, model, crit = _tiny_cc()
    assert model.training and model.cc_module.training
    assert not model.segmenter.training
    assert not any(p.requires_grad for p in model.segmenter.parameters())
    assert crit.losses == ("labels", "masks")
    opt, sched = build_optimizer(cfg, model, tf2_warmup_poly_lr(1e-3, 10, 0))
    held = [n for g in opt.param_groups for n in g["names"]]
    assert sorted(held) == sorted(f"cc_module.{n}" for n, _ in
                                  model.cc_module.named_parameters())
    seg0 = {k: v.clone() for k, v in model.segmenter.state_dict().items()}
    cc0 = {k: v.clone() for k, v in model.cc_module.state_dict().items()}
    rs = np.random.RandomState(0)
    frames = CLIPS * V
    batch = {"images": t(rs.randn(frames, 64, 64, 3).astype(np.float32)),
             "targets": {"labels": t(rs.randint(0, NUM_CLASSES, (1, GT))),
                         "masks": t((rs.rand(1, GT, frames, 16, 16) > 0.7)
                                    .astype(np.float32)),
                         "valid": torch.ones(1, GT, dtype=torch.bool)}}
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        losses = train_step(model, crit, opt, sched, batch, gen)
        assert np.isfinite(list(losses.values())).all()
    assert all(p.grad is None for p in model.segmenter.parameters())
    for k, v in model.segmenter.state_dict().items():
        assert torch.equal(v, seg0[k]), k
    moved = [k for k, v in model.cc_module.state_dict().items()
             if not torch.equal(v, cc0[k])]
    assert any("running" in k for k in moved)
    assert len(moved) >= len(cc0) - 3  # 3 gradients are zero in exact math


@pytest.fixture(scope="module")
def jax_cc_variables():
    """JAX's CC model variables (its segmenter's shapes traced, never
    compiled) and a JAX WC training tree of the same segmenter, with the
    auxiliary semantic head, as ``tools/validate_overfit.py
    --save-params`` writes it; all random."""
    from axial_vs_tpu.config import get_default_config
    from axial_vs_tpu.models.cc_module import CrossClipTrackingModule as JCC
    from axial_vs_tpu.models.kmax import build_segmenter as jbuild

    cfg = get_default_config()
    cfg.merge_from_file("configs/vipseg/maxtron_cc_r50.yaml")
    cfg.merge_from_list(TINY)
    x = jnp.zeros((V, 64, 64, 3))
    seg, wc = (jax.eval_shape(lambda m=m: m.init(jax.random.PRNGKey(0), x,
                                                 train=train))
               for m, train in ((jbuild(cfg, num_frames=V, train=False), False),
                                (jbuild(cfg, num_frames=V, train=True), True)))
    jcc = JCC(num_classes=NUM_CLASSES, num_layers=LAYERS, num_clip_frames=V)
    cc_v = jax.eval_shape(lambda: jcc.init(
        jax.random.PRNGKey(0), jnp.zeros((1, QUERIES, 2, 256)),
        jnp.zeros((2, V * 16, 16, 128))))
    cc_vars = {col: {"segmenter": randomize(seg, 1)[col],
                     "cc_module": randomize(cc_v, 2)[col]}
               for col in ("params", "batch_stats")}
    return cc_vars, randomize(wc, 3)


def test_wc_to_cc_matches_jax_surgery(jax_cc_variables):
    """``convert.wc_to_cc`` of a JAX WC training tree (or of its port
    state_dict) into a CC model's state_dict equals the conversion of the
    JAX CC tool's surgery (``params["segmenter"] = wc["params"]``, the
    statistics likewise; JAX ignores the semantic head's parameters, which
    the frozen segmenter lacks); ``prepare_cc_weights`` of it takes the
    clones of the JAX surgery; a foreign tree raises."""
    from axial_vs_tpu.utils.torch_convert import prepare_cc_weights as jprep

    cc_vars, wc = jax_cc_variables
    assert "auxiliary_semantic_predictor" in wc["params"]["transformer_decoder"]
    done = {col: {**cc_vars[col], "segmenter": wc[col]} for col in cc_vars}
    own = convert.maxtron_cc(cc_vars)
    want = {k: v for k, v in convert.maxtron_cc(done).items() if k in own}
    assert set(want) == set(own)
    for src in (wc, convert.convert_variables(wc)):
        got = convert.wc_to_cc(src, own)
        assert set(got) == set(own)
        for k in own:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    flat = {col: {**wc[col], "cc_module": cc_vars[col]["cc_module"]}
            for col in cc_vars}
    jdone = jprep(flat)
    nested = {col: {"segmenter": {k: v for k, v in jdone[col].items()
                                  if k != "cc_module"},
                    "cc_module": jdone[col]["cc_module"]} for col in jdone}
    want = {k: v for k, v in convert.maxtron_cc(nested).items() if k in own}
    got = convert.prepare_cc_weights(convert.wc_to_cc(wc, own))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    partial = convert.convert_variables(wc)
    partial.pop(next(iter(partial)))
    with pytest.raises(KeyError, match="missing"):
        convert.wc_to_cc(partial, own)


# -------------------------------------------- the trainer and the tools ----

@pytest.fixture(scope="module")
def overfit_fixture(tmp_path_factory):
    from axial_vs_tpu_torch.tools import validate_overfit

    out = str(tmp_path_factory.mktemp("overfit"))
    return out, validate_overfit.fixture(out)


CC_YAML = "vipseg/maxtron_cc_r50.yaml"


def _opts(out, name, **extra):
    opts = TINY + ["model.num_classes", 2, "solver.max_iter", 2,
                   "solver.checkpoint_period", 1, "dataloader.num_workers", 0,
                   "test.eval_period", 0, "datasets.train", [name],
                   "datasets.test", [name], "output_dir", str(out)]
    for k, v in extra.items():
        opts += [k.replace("__", "."), v]
    return opts


def _trainer(out, name, **extra):
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.engine.trainer import Trainer

    return Trainer(load_config(CC_YAML, _opts(out, name, **extra)),
                   device=torch.device("cpu"))


def _cli(flags, out, name, **extra):
    """``train_net_video.main`` on the CC yaml with ``_opts`` as the
    command line gives them; the evaluation takes one video."""
    from axial_vs_tpu_torch.tools import train_net_video

    opts = [str(o).replace(" ", "") for o in _opts(out, name, **extra)]
    return train_net_video.main(
        flags + ["--config-file", f"configs/{CC_YAML}", "--device", "cpu",
                 "--opts"] + opts, eval_kwargs={"max_videos": 1})


def test_trainer_on_the_cc_config(overfit_fixture, tmp_path):
    """``Trainer`` on the CC yaml over the 96x160 fixture (8-frame videos,
    64x64 crops): two steps straight equal ``train_net_video``'s one step,
    then ``--resume`` to step 2 with the eval hook, bitwise (the frozen
    segmenter unchanged, the CC module's optimizer state restored); the
    eval hook and ``--eval-only`` run ``CCInferencePipeline``;
    ``load_weights`` of a WC segmenter's state_dict seeds the segmenter;
    ``ims_per_batch`` other than 1 raises."""
    from axial_vs_tpu_torch.models.video_inference import CCInferencePipeline

    out, name = overfit_fixture
    with pytest.raises(ValueError, match="one video a step"):
        _trainer(tmp_path / "x", name, solver__ims_per_batch=2)
    straight = _trainer(tmp_path / "a", name)
    seg0 = {k: v.clone() for k, v in straight.model.segmenter.state_dict()
            .items()}
    straight.train()
    assert straight.loader.stream.mapper.num_frames == 8
    for k, v in straight.model.segmenter.state_dict().items():
        assert torch.equal(v, seg0[k]), k
    _cli([], tmp_path / "b", name, solver__max_iter=1)
    runs = []
    real = CCInferencePipeline.run_video

    def run_video(self, frames, *args):
        runs.append(len(frames))
        return real(self, frames, *args)

    CCInferencePipeline.run_video = run_video
    try:
        resumed = _cli(["--resume"], tmp_path / "b", name,
                       test__eval_period=2)
        res = _cli(["--resume", "--eval-only"], tmp_path / "b", name)
    finally:
        CCInferencePipeline.run_video = real
    assert resumed.step == 2 and runs == [8, 8] and resumed.model.training
    assert 0.0 <= res["vpq"] <= 1.0
    for k, v in straight.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    for sa, sb in zip(straight.optimizer.state.values(),
                      resumed.optimizer.state.values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert len(resumed.optimizer.state) == len(
        list(resumed.model.cc_module.parameters()))

    wc = {k[len("segmenter."):]: v + 1 if v.is_floating_point() else v
          for k, v in straight.model.state_dict().items()
          if k.startswith("segmenter.")}
    path = tmp_path / "wc.pt"
    torch.save(wc, path)
    fresh = _trainer(tmp_path / "c", name)
    cc_before = {k: v.clone() for k, v in fresh.model.cc_module.state_dict()
                 .items()}
    fresh.load_weights(str(path))
    for k, v in fresh.model.segmenter.state_dict().items():
        assert torch.equal(v, wc[k]), k
    for k, v in fresh.model.cc_module.state_dict().items():
        assert torch.equal(v, cc_before[k]), k
    wc.pop(next(iter(wc)))
    torch.save(wc, path)
    with pytest.raises(KeyError, match="missing"):
        fresh.load_weights(str(path))


def _json_lines(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, [json.loads(x) for x in buf.getvalue().splitlines()
                if x.startswith("{")]


def test_cc_mapper_gives_a_video_a_sample(overfit_fixture):
    """``build_mapper`` on the CC yaml (crop 769x1345, 128 GT slots): one
    sample is one video of ``input.num_video_frames`` = 8 frames."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.data.build import build_mapper
    from axial_vs_tpu_torch.data.catalog import DatasetCatalog

    _, name = overfit_fixture
    cfg = load_config(CC_YAML, ["datasets.train", [name]])
    assert (cfg.input.num_video_frames, cfg.model.kmax.trans_dec
            .num_object_queries) == (8, 128)
    sample = build_mapper(cfg)(DatasetCatalog.get(name)[0])
    h, w = cfg.input.image_size
    assert sample["images"].shape == (8, h, w, 3)
    assert sample["targets"]["masks"].shape == (
        128, 8, (h + 3) // 4, (w + 3) // 4)
    assert sample["targets"]["valid"].sum() >= 2


def test_overfit_tools_run(overfit_fixture, tmp_path):
    """Both overfit tools at 2 steps on the CPU: each prints an eval line
    and its final line (VPQ in [0, 1], not yet at the target: exit 1), and
    the CC tool trains on the WC tool's ``--save-weights`` file."""
    from axial_vs_tpu_torch.tools import validate_overfit, validate_overfit_cc

    out, _ = overfit_fixture
    weights = str(tmp_path / "wc.pt")
    common = ["--steps", "2", "--eval-every", "2", "--device", "cpu",
              "--out", out]
    for fn, extra in ((validate_overfit.main, ["--save-weights", weights]),
                      (validate_overfit_cc.main, ["--wc-weights", weights])):
        rc, lines = _json_lines(fn, common + extra)
        assert rc in (0, 1) and len(lines) == 2
        assert lines[0]["step"] == 2 and 0.0 <= lines[0]["vpq"] <= 1.0
        assert set(lines[0]) >= {"loss", "things_pq", "stuff_pq", "loss_terms"}
        assert lines[1]["final_vpq"] == lines[0]["vpq"]
        assert lines[1]["passed"] == (rc == 0)
    assert "loss_pixel_insdis" not in lines[0]["loss_terms"]  # the CC losses
