"""Training on the port (axial_vs_tpu_torch) against the JAX package, on
the CPU in f32: the plain VJPs that are K2's and K3's backward, the matcher,
each criterion term, the LR schedules, the optimizer's parameter rules and
its AdamW update, one whole train step, and the stochastic layers.

The whole step runs the narrow WC configuration of
``tests/test_torch_parity.py`` with an R18 backbone (the slice's family) at
64x64 frames, T = 2, drop rates 0; the JAX ASPP's dropout, which the JAX
module fixes at 0.1, is set to 0 on both sides for that comparison. The
Gumbel samples take every pixel (``sample_k`` at least the pixel count), so
the losses do not depend on the draws.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from flax import linen as fnn
from flax import traverse_util

from axial_vs_tpu_torch.utils import convert
from test_torch_parity import jax_init, small_config
from test_torch_parity import numpy_lsap, torch_threads  # noqa: F401 (autouse)

#: bound of the plain VJPs against jax.vjp, relative to each gradient's max
TOL_VJP = 1e-5
#: bound of the losses of one step, relative
TOL_LOSS = 1e-5
#: bound of each gradient tensor of one step, relative to its max
TOL_GRAD = 1e-4
#: f32 rounding noise of a step's gradients, relative to the largest one
GRAD_NOISE = 1e-7
#: the criterion terms on the same inputs, relative
TOL_TERM = 1e-5
#: AdamW's parameters after three updates, relative to each tensor's max
TOL_ADAMW = 1e-6
T, HW, M = 2, 16, 5  # frames, the OS4 grid of 64x64 frames, GT slots
LOSS_WEIGHTS = {"loss_ce": 3.0, "loss_mask": 0.3, "loss_dice": 3.0,
                "loss_pixel_insdis": 1.0, "loss_aux_semantic": 1.0}


def rel_err(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def train_config(backbone="resnet18"):
    cfg = small_config()
    if backbone == "resnet18":
        cfg.model.backbone.name = "resnet18"
        cfg.model.backbone.resnet.depth = 18
    else:
        cfg.model.backbone.convnext.use_scan = False
    cfg.input.image_size = [64, 64]
    return cfg


# ---------------------------------------------- K2's and K3's backward ----

def test_msda_plain_vjp_matches_jax():
    """K2's backward, the VJP of ``ms_deform_attn_plain``, against jax.vjp
    of the JAX op on the path JAX training takes (XLA, no Pallas reduce):
    gradients of value, locations and weights. Locations straddle [-0.2,
    1.2], so corners outside the level are exercised."""
    from axial_vs_tpu.ops.msda import ms_deform_attn as jmsda
    from axial_vs_tpu_torch.ops.msda import (level_start_index,
                                             ms_deform_attn_plain)
    from axial_vs_tpu_torch.ops.native import plain_vjp

    rng = np.random.RandomState(0)
    b, m, d, p, lq = 2, 4, 8, 3, 19
    shapes = ((2, 3), (4, 6), (7, 9))
    s = sum(h * w for h, w in shapes)
    value = rng.randn(b, s, m, d).astype(np.float32)
    locs = (rng.rand(b, lq, m, len(shapes), p, 2) * 1.4 - 0.2).astype(np.float32)
    w = rng.rand(b, lq, m, len(shapes), p).astype(np.float32)
    ct = rng.randn(b, lq, m * d).astype(np.float32)
    _, vjp = jax.vjp(lambda v, l, a: jmsda(v, shapes, l, a),
                     jnp.asarray(value), jnp.asarray(locs), jnp.asarray(w))
    want = vjp(jnp.asarray(ct))
    starts = level_start_index(shapes)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (value, locs, w)]
    got = plain_vjp(lambda v, l, a: ms_deform_attn_plain(v, shapes, starts,
                                                         l, a),
                    inputs, torch.from_numpy(ct))
    for name, g, wt in zip(("value", "locations", "weights"), got, want):
        assert rel_err(g, wt) <= TOL_VJP, name


def test_traj_plain_vjp_matches_jax():
    """K3's backward, the VJP of ``trajectory_attention_core_plain``, against
    jax.vjp of the JAX op (the Pallas kernel in interpret mode; its custom
    VJP is that of ``_traj_math``): gradients of q, k, v and the stage-2
    weights (JAX's Dense kernels are the port's Linear weights
    transposed)."""
    from axial_vs_tpu.ops.traj_pallas import fused_trajectory_attention
    from axial_vs_tpu_torch.ops.native import plain_vjp
    from axial_vs_tpu_torch.ops.traj import trajectory_attention_core_plain

    rng = np.random.RandomState(1)
    b, f, n, h, d = 2, 2, 3, 2, 32
    c = h * d
    q, k, v = (rng.randn(b, f * n, c).astype(np.float32) for _ in range(3))
    wq2, wkv2 = (rng.randn(c, c * i).astype(np.float32) * 0.1 for i in (1, 2))
    bq2, bkv2 = (rng.randn(c * i).astype(np.float32) * 0.1 for i in (1, 2))
    ct = rng.randn(b, f * n, c).astype(np.float32)
    args = (q, k, v, wq2, bq2, wkv2, bkv2)
    _, vjp = jax.vjp(
        lambda *a: fused_trajectory_attention(*a, f, h, d ** -0.5, True),
        *map(jnp.asarray, args))
    want = vjp(jnp.asarray(ct))
    port_args = (q, k, v, wq2.T, bq2, wkv2.T, bkv2)
    inputs = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
              for a in port_args]
    got = plain_vjp(lambda *a: trajectory_attention_core_plain(*a, f, h),
                    inputs, torch.from_numpy(ct))
    names = ("q", "k", "v", "wq2", "bq2", "wkv2", "bkv2")
    for name, g, wt in zip(names, got, want):
        wt = np.asarray(wt)
        assert rel_err(g, wt.T if wt.ndim == 2 else wt) <= TOL_VJP, name


# --------------------------------------------------- matcher, criterion ----

def _outputs(rng, b=2, n=8, classes=6, hw=(6, 7), aux=2):
    """Model-like outputs: (B, N, C+1) logits, (B, T, H, W, N) masks,
    (B, T, H, W, 16) unit pixel features, aux layers and the semantic
    head's (B, T, H, W, C+1)."""
    def layer():
        feat = rng.randn(b, T, *hw, 16).astype(np.float32)
        return {"pred_logits": rng.randn(b, n, classes + 1).astype(np.float32),
                "pred_masks": rng.randn(b, T, *hw, n).astype(np.float32) * 2,
                "pixel_feature": feat / np.linalg.norm(feat, axis=-1,
                                                       keepdims=True)}

    out = layer()
    out["aux_outputs"] = [layer() for _ in range(aux)]
    out["aux_semantic_pred"] = rng.randn(b, T, *hw, classes + 1).astype(
        np.float32)
    return out


def _targets(rng, b=2, m=M, classes=6, hw=(6, 7)):
    valid = np.ones((b, m), bool)
    valid[0, -2:] = False
    masks = (rng.rand(b, m, T, *hw) > 0.75).astype(np.float32)
    masks[~valid] = 0.0
    return {"labels": rng.randint(0, classes, (b, m)), "masks": masks,
            "valid": valid,
            "semantic_masks": rng.randint(-1, classes, (b, T, *hw))}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def test_matcher_matches_jax():
    """The assignment (exact, scipy on the host on both sides) is equal, and
    the matched dice and class probabilities agree."""
    from axial_vs_tpu.losses.matcher import hungarian_match as jmatch
    from axial_vs_tpu_torch.losses.matcher import hungarian_match

    rng = np.random.RandomState(2)
    out, tg = _outputs(rng), _targets(rng)
    want = jmatch(_to_jax(out), _to_jax(tg), exact=True)
    got = hungarian_match(_to_torch(out), _to_torch(tg))
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    assert rel_err(got.matched_dice, want.matched_dice) <= TOL_TERM
    assert rel_err(got.matched_cls_prob, want.matched_cls_prob) <= TOL_TERM


@pytest.mark.parametrize("case", ["shared", "per_layer", "ceil_grid"])
def test_criterion_terms_match_jax(case):
    """Every loss term, the aux layers' too, and the weighted total: with
    the final matching shared by the aux layers (the default), matched per
    layer, and with targets on the ceil(size / 4) grid one row and column
    larger than the prediction's, which the criterion crops."""
    from axial_vs_tpu.losses.criterion import SetCriterion as J
    from axial_vs_tpu_torch.losses.criterion import SetCriterion

    rng = np.random.RandomState(3)
    out = _outputs(rng)
    tg = _targets(rng, hw=(7, 8) if case == "ceil_grid" else (6, 7))
    s = 2 * T * 6 * 7  # at least the pixels of a sample
    kw = dict(weights=LOSS_WEIGHTS, pixel_insdis_sample_k=s,
              aux_semantic_sample_k=s,
              share_final_matching=case != "per_layer")
    want = J(6, exact_matching=True, **kw)(jax.random.PRNGKey(0),
                                           _to_jax(out), _to_jax(tg))
    crit = SetCriterion(6, **kw)
    got = crit(_to_torch(out), _to_torch(tg), torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want) and len(got) == 5 + 4 * 2
    for k in want:
        assert rel_err(got[k], want[k]) <= TOL_TERM, k
    assert rel_err(crit.weighted_total(got),
                   J(6, **kw).weighted_total(want)) <= TOL_TERM


# ------------------------------------------------ schedule and optimizer ----

def test_lr_schedules_match_jax():
    from axial_vs_tpu.engine import lr_schedule as J
    from axial_vs_tpu_torch.engine import lr_schedule

    steps = [0, 1, 7, 99, 100, 101, 500, 899, 900, 999, 1000, 1200]
    for args, kw in (((1e-4, 1000), dict(warmup_iters=100)),
                     ((5e-5, 1000), dict(warmup_iters=0,
                                         constant_ending=0.3))):
        want = J.tf2_warmup_poly_lr(*args, **kw)
        got = lr_schedule.tf2_warmup_poly_lr(*args, **kw)
        for s in steps:
            assert got(s) == pytest.approx(float(want(s)), rel=1e-6), s
    want = J.step_lr(1e-4, [300, 900], warmup_iters=100)
    got = lr_schedule.step_lr(1e-4, [900, 300], warmup_iters=100)
    for s in steps:
        assert got(s) == pytest.approx(float(want(s)), rel=1e-6), s


def _id_tree(params):
    """Each leaf of a flax tree replaced by a float64 array of its shape
    holding the leaf's index, and the index -> '/'-joined path."""
    flat = traverse_util.flatten_dict(params, sep="/")
    paths = sorted(flat)
    ids = {p: np.full(flat[p].shape, i, np.float64)
           for i, p in enumerate(paths)}
    return traverse_util.unflatten_dict(ids, sep="/"), paths


def _jax_train_model(cfg, x):
    from axial_vs_tpu.models.kmax import build_segmenter as jax_build

    jm = jax_build(cfg, num_frames=T, train=True)
    return jm, jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x), train=True))


@pytest.mark.parametrize("case", ["resnet", "convnext_layer_wise",
                                  "convnext_stage_wise"])
def test_param_rules_match_jax(case):
    """Every port parameter gets the (lr_mult, wd) that JAX's rules give the
    flax path that ``utils/convert.py`` carries into it: the R18 training
    model with its semantic head, and a ConvNeXt model under both kinds of
    layer-wise LR decay."""
    from axial_vs_tpu.engine.optim import param_rules as jax_rules
    from axial_vs_tpu_torch.engine.optim import param_rules
    from axial_vs_tpu_torch.models.kmax import build_segmenter

    cfg = train_config("resnet18" if case == "resnet" else "convnext")
    if case != "resnet":
        cfg.solver.layer_decay.enabled = True
        cfg.solver.layer_decay.decay_type = case[len("convnext_"):]
    x = np.zeros((T, 64, 64, 3), np.float32)
    _, shapes = _jax_train_model(cfg, x)
    ids, paths = _id_tree(shapes["params"])
    stats = jax.tree.map(lambda s: np.zeros(s.shape), shapes["batch_stats"])
    sd = convert.convert_variables({"params": ids, "batch_stats": stats})
    model = build_segmenter(cfg, torch.device("cpu"),
                            torch.Generator().manual_seed(0), num_frames=T,
                            train=True)
    want, got = jax_rules(cfg), param_rules(cfg)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(paths)
    for name in names:
        (i,) = np.unique(sd[name])
        assert got(name) == pytest.approx(want(paths[int(i)])), (name,
                                                                 paths[int(i)])


def _semantic_heads(rng, train=True):
    """Two small semantic heads as one parameter tree, one under
    ``backbone`` (the backbone's LR multiplier) and one under ``head``:
    JAX's variables and the port's module with them loaded."""
    import axial_vs_tpu.layers.kmax_layers as jax_layers
    from axial_vs_tpu_torch.layers.kmax_layers import SemanticPredictor

    inputs = [rng.randn(*s).astype(np.float32) for s in
              ((2, 6, 7, 16), (2, 12, 14, 8), (2, 24, 28, 8))]
    jm = jax_layers.SemanticPredictor(num_classes=5)
    variables = {c: {} for c in ("params", "batch_stats")}
    model = torch.nn.ModuleDict()
    for i, part in enumerate(("backbone", "head")):
        v = jax_init(jm, *map(jnp.asarray, inputs), seed=i, train=train)
        for c in variables:
            variables[c][part] = v[c]
        model[part] = SemanticPredictor(16, 8, 8, 5)
        convert.load_into(model[part], convert.semantic_predictor(
            v["params"], v["batch_stats"]))
        model[part]._aspp._proj_drop.rate = 0.0
    return jm, variables, model.train(train), inputs


def test_semantic_head_train_matches_jax(monkeypatch):
    """The auxiliary semantic head (ASPP + the Panoptic-DeepLab decoder) in
    train mode, at a size where its atrous taps reach the image: output,
    BatchNorm running statistics and parameter gradients against JAX
    (ASPP's dropout at rate 0 on both sides)."""
    import axial_vs_tpu.layers.kmax_layers as jax_layers

    monkeypatch.setattr(jax_layers, "nn", _NoDropout())
    rng = np.random.RandomState(5)
    jm, variables, model, inputs = _semantic_heads(rng)
    params, stats = (variables[c]["head"] for c in ("params", "batch_stats"))
    ct = rng.randn(2, 24, 28, 5).astype(np.float32)

    def loss(p):
        out, new = jm.apply({"params": p, "batch_stats": stats},
                            *map(jnp.asarray, inputs), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * ct), (out, new["batch_stats"])

    (_, (want, new)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    head = model["head"]
    got = head(*map(torch.from_numpy, inputs), generator=torch.Generator())
    (got * torch.from_numpy(ct)).sum().backward()
    assert rel_err(got, want) <= TOL_TERM
    zero = jax.tree.map(np.zeros_like, stats)
    gsd = convert.semantic_predictor(jax.tree.map(np.asarray, grads), zero)
    ssd = convert.semantic_predictor(params, jax.tree.map(np.asarray, new))
    for n, p in head.named_parameters():
        assert rel_err(p.grad, gsd[n]) <= TOL_GRAD, n
    for n, t in head.state_dict().items():
        if "running" in n:
            assert rel_err(t, ssd[n]) <= TOL_TERM, n


@pytest.mark.parametrize("clip", [True, False])
def test_adamw_update_matches_jax(clip):
    """Three updates of the port's AdamW and schedule against the JAX
    optax chain from the same parameters and gradients, on two semantic
    heads (one under ``backbone``: groups of two LR multipliers and two
    weight decays), with the global gradient clip (the default solver) and
    without (the R50 yaml)."""
    from axial_vs_tpu.engine.lr_schedule import tf2_warmup_poly_lr as jsched
    from axial_vs_tpu.engine.optim import build_optimizer as jax_build
    from axial_vs_tpu_torch.engine.lr_schedule import tf2_warmup_poly_lr
    from axial_vs_tpu_torch.engine.optim import build_optimizer

    cfg = train_config()
    cfg.solver.clip_gradients.enabled = clip
    rng = np.random.RandomState(4)
    _, variables, model, _ = _semantic_heads(rng)
    params, stats = variables["params"], variables["batch_stats"]
    grads = [jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.1).astype(
        np.float32), params) for _ in range(3)]
    tx = jax_build(cfg, params, jsched(1e-3, 100, warmup_iters=2))
    update = jax.jit(tx.update)
    jp, state = jax.tree.map(jnp.asarray, params), tx.init(params)
    for g in grads:
        upd, state = update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)

    def port_tree(tree):
        return {f"{part}.{k}": v for part in ("backbone", "head")
                for k, v in convert.semantic_predictor(
                    tree[part], stats[part]).items()}

    opt, sched = build_optimizer(cfg, model, tf2_warmup_poly_lr(
        1e-3, 100, warmup_iters=2))
    assert {(g["lr_mult"], g["weight_decay"]) for g in opt.param_groups} == {
        (0.1, 0.05), (0.1, 0.0), (1.0, 0.05), (1.0, 0.0)}
    named = dict(model.named_parameters())
    for g in grads:
        gsd = port_tree(g)
        for n, p in named.items():
            p.grad = torch.from_numpy(np.ascontiguousarray(gsd[n]))
        opt.step()
        sched.step()
    want, start = port_tree(jax.tree.map(np.asarray, jp)), port_tree(params)
    moved = 0.0
    for n, p in named.items():
        assert rel_err(p, want[n]) <= TOL_ADAMW, n
        moved = max(moved, float(np.abs(want[n] - start[n]).max()))
    assert moved > 1e-4  # the updates are not vanishingly small


# ------------------------------------------------------- one whole step ----

class _NoDropout:
    """``flax.linen`` with Dropout at rate 0, for the JAX ASPP's module
    globals: its dropout rate is fixed at 0.1 in the module."""

    def __getattr__(self, name):
        return getattr(fnn, name)

    @staticmethod
    def Dropout(rate, **kwargs):
        return fnn.Dropout(rate=0.0, **kwargs)


def test_train_step_matches_jax(monkeypatch):
    """One ``train_step`` against JAX's ``make_train_step`` from the same
    weights, batch and targets: every loss and the total to ``TOL_LOSS``,
    the BatchNorm running statistics after the step, and every gradient
    tensor (JAX's, captured by an optax transformation that keeps them as
    its state, carried into the port's layout by ``convert_variables``).

    Gradient bound: within ``TOL_GRAD`` of the tensor's max, or within 8x
    of how far JAX's own gradient of that tensor moves when the input frames
    are scaled by 1 +- 2^-22 or 1 +- 2^-21 (a few f32 ulps; over the tensors
    beyond ``TOL_GRAD``, the port's distance from JAX was a median 0.83 and
    at most 6.2 times that), or below ``GRAD_NOISE`` of the
    step's largest gradient. At 64x64 the res5 level is 2x2 and the ASPP's
    image-pooling BatchNorm sees 2 values, and gradients that are zero in
    exact arithmetic (a bias before a train-mode BatchNorm or a softmax)
    are rounding noise: such tensors move by up to 1e-2 of their max in JAX
    alone, and the port cannot agree with JAX more closely than JAX agrees
    with itself. (``test_semantic_head_train_matches_jax`` holds the
    semantic head to ``TOL_GRAD`` at a size where it is well conditioned.)"""
    import axial_vs_tpu.layers.kmax_layers as jax_layers
    from axial_vs_tpu.engine.train_step import TrainState, make_train_step
    from axial_vs_tpu.losses.criterion import SetCriterion as J
    from axial_vs_tpu_torch.engine.lr_schedule import tf2_warmup_poly_lr
    from axial_vs_tpu_torch.engine.optim import build_optimizer
    from axial_vs_tpu_torch.engine.train_step import train_step
    from axial_vs_tpu_torch.losses.criterion import SetCriterion
    from axial_vs_tpu_torch.models.kmax import build_segmenter

    monkeypatch.setattr(jax_layers, "nn", _NoDropout())
    cfg = train_config()
    cfg.solver.clip_gradients.enabled = False  # p.grad keeps the gradient
    classes, s = cfg.model.num_classes, T * HW * HW
    kw = dict(weights=LOSS_WEIGHTS, pixel_insdis_sample_k=s,
              aux_semantic_sample_k=s)
    rs = np.random.RandomState(0)
    x = rs.randn(T, 64, 64, 3).astype(np.float32)
    jm = _jax_train_model(cfg, x)[0]
    v = jax_init(jm, jnp.asarray(x), train=True)
    tg = {"labels": rs.randint(0, classes, (1, M)),
          "masks": (rs.rand(1, M, T, HW, HW) > 0.7).astype(np.float32),
          "valid": np.array([[True] * (M - 1) + [False]]),
          "semantic_masks": rs.randint(-1, classes, (1, T, HW, HW))}
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, st, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    step = jax.jit(make_train_step(jm, J(classes, **kw), keep))
    state = TrainState(jnp.zeros([], jnp.int32), v["params"],
                       v["batch_stats"], keep.init(v["params"]))
    zero = jax.tree.map(np.zeros_like, v["batch_stats"])

    def jax_step(frames):
        new, metrics = step(state, {"images": jnp.asarray(frames),
                                    "targets": _to_jax(tg)},
                            jax.random.PRNGKey(1))
        grads = convert.convert_variables(
            {"params": jax.tree.map(np.asarray, new.opt_state),
             "batch_stats": zero})
        return new, {k: float(m) for k, m in metrics.items()}, grads

    new, want, jgrad = jax_step(x)
    moved = [jax_step(x * np.float32(1 + e))[2]
             for e in (2 ** -22, -2 ** -22, 2 ** -21, -2 ** -21)]

    model = build_segmenter(cfg, torch.device("cpu"),
                            torch.Generator().manual_seed(0), num_frames=T,
                            train=True)
    convert.load_into(model, convert.convert_variables(v))
    aspp = model.sem_seg_head.predictor._auxiliary_semantic_predictor._aspp
    aspp._proj_drop.rate = 0.0
    opt, sched = build_optimizer(cfg, model, tf2_warmup_poly_lr(
        cfg.solver.base_lr, cfg.solver.max_iter))
    got = train_step(model, SetCriterion(classes, **kw), opt, sched,
                     {"images": torch.from_numpy(x), "targets": _to_torch(tg)},
                     torch.Generator().manual_seed(1))
    assert sorted(got) == sorted(want) and len(got) == 5 + 4 * 3 + 1
    for k in want:
        assert abs(got[k] - want[k]) <= TOL_LOSS * abs(want[k]), k
    within, names = 0, [n for n, _ in model.named_parameters()]
    noise = GRAD_NOISE * max(np.abs(g).max() for g in jgrad.values())
    for n, p in model.named_parameters():
        err = np.abs(p.grad.numpy() - jgrad[n]).max()
        scale = np.abs(jgrad[n]).max()
        jitter = max(np.abs(g[n] - jgrad[n]).max() for g in moved)
        assert err <= max(TOL_GRAD * scale, 8 * jitter, noise), n
        within += bool(err <= TOL_GRAD * scale)
    assert within >= 0.7 * len(names)  # most tensors meet the plain bound
    stats = convert.convert_variables(
        {"params": v["params"],
         "batch_stats": jax.tree.map(np.asarray, new.batch_stats)})
    for k, t in model.state_dict().items():
        if "running" in k:
            assert rel_err(t, stats[k]) <= TOL_LOSS, k


# ------------------------------------------------------ stochastic layers ----

@pytest.mark.parametrize("layer", ["DropPath", "Dropout"])
def test_stochastic_layer_draws_from_the_generator(layer):
    """A DropPath or Dropout at rate 0.5 in train(): the same generator seed
    gives the same output, another seed another; kept entries are scaled
    by 2; eval() is the identity; train() without a generator raises."""
    from axial_vs_tpu_torch.layers import convbn

    mod = getattr(convbn, layer)(0.5).train()
    x = torch.randn(64, 3, 5, generator=torch.Generator().manual_seed(9))
    a, b, c = (mod(x, torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert 0 < kept.float().mean() < 1
    assert torch.allclose(a[kept], 2 * x[kept])
    if layer == "DropPath":  # whole samples
        assert (kept.flatten(1).all(1) | ~kept.flatten(1).any(1)).all()
    with pytest.raises(TypeError):
        mod(x)
    assert torch.equal(mod.eval()(x), x)


def test_model_drop_paths_draw_from_the_generator():
    """The training model with the transformer's and the pixel decoder's
    drop paths at 0.5: its outputs depend only on the generator passed in.
    The residual branches' BatchNorm gammas (0 at init, which would hide
    the drop paths) are set to 1."""
    from axial_vs_tpu_torch.models.kmax import build_segmenter
    from axial_vs_tpu_torch.ops.norm import BatchNorm

    cfg = train_config()
    cfg.model.kmax.trans_dec.drop_path_prob = 0.5
    cfg.model.kmax.pixel_dec.drop_path_prob = 0.5
    model = build_segmenter(cfg, torch.device("cpu"),
                            torch.Generator().manual_seed(0), num_frames=T,
                            train=True)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.weight.data.fill_(1.0)
    x = torch.randn(T, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        a, b, c = (model(x, torch.Generator().manual_seed(s))["pred_masks"]
                   for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
