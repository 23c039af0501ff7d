"""bf16 training on the port (axial_vs_tpu_torch) against the JAX package,
on the CPU, and the ConvNeXt backbone's drop path under remat.

bf16 compute rounds every activation and every activation gradient to 8
bits of mantissa, and the two frameworks round at different points (XLA
fuses elementwise chains and keeps their intermediates in f32; torch
rounds after each op). How far that moves a result depends on how well
the computation is conditioned, so the port is held to JAX at two levels:

- Layers (``test_bf16_layer_matches_jax``, ``test_bf16_criterion_matches_
  jax``): the layers whose precision policy matters (f32 softmax, f32
  BatchNorm and LayerNorm statistics, f32 sampling locations, the f32 loss
  island), each in train mode on the same bf16 inputs and weights, forward
  and VJP. These are well conditioned, so the bounds are tight: each is
  1.15x-1.4x the distance measured at these seeds (``LAYER_BOUNDS``), and
  each of these planted faults moves a distance past its bound: a softmax
  whose exp and sum run in bf16, BatchNorm or LayerNorm statistics in
  bf16, MSDA sampling offsets divided in bf16, the loss terms' log-softmax
  in bf16. The k-means layer's own argmax flips move it further than a
  bf16 softmax in its query self-attention would, so that island is left
  to the whole step.
- The whole step (``test_bf16_train_step_matches_jax``): the narrow R18 WC
  configuration of ``tests/test_torch_train.py`` with one k-means decoder
  layer at 128x128 frames in bf16, against JAX's bf16 ``make_train_step``
  from the same weights and batch. Train-mode BatchNorm over a few pixels
  and the k-means argmaxes make a tiny random model's bf16 gradients move
  by several percent when a few input pixels move by one bf16 ulp (the
  frames scaled by 1 + 2^-22, ``JITTER``), so each parameter group's f32
  master gradient is held within ``GROUP_FACTOR`` times JAX's own largest
  move and never beyond ``GROUP_CAP``, and each loss within ``TOL_LOSS_BF16``
  relative. The Hungarian assignment is fixed to the identity on both
  sides (the matcher is held to JAX in ``tests/test_torch_train.py`` and
  ``tests/test_torch_auction.py``), so a flipped near-tie in the matching
  does not swap the losses' targets.

Remat replays a ConvNeXt block's forward in the backward; the drop-path
masks come from the step's generator outside the replayed call, so remat on
and off give bitwise the same loss and gradients on the CPU.
"""
import numpy as np
import pytest
import torch

from test_torch_train import (LOSS_WEIGHTS, M, T, _NoDropout, _outputs,
                              _targets, _to_jax, _to_torch, train_config)

#: the input scalings whose effect on JAX's own step bounds the port's
JITTER = (2 ** -22, 2 ** -21, 2 ** -20)
#: bound of each loss of the step, relative
TOL_LOSS_BF16 = 1e-2
#: a group's distance from JAX over JAX's own largest move, relative L2
GROUP_FACTOR = 2.5
#: and the most it may be, whatever JAX's own move
GROUP_CAP = 0.25
#: the step's frames (square) and its OS4 grid
STEP_SIZE = 128
STEP_HW = STEP_SIZE // 4
#: per layer, relative L2 bounds of: the output, the input's gradient, all
#: parameter gradients together, and the BatchNorm statistics' update
LAYER_BOUNDS = {
    "axial": {"out": 5e-3, "dx": 1.5e-2, "grads": 7e-3, "stats": 1e-3},
    "msda": {"out": 3.8e-3, "dx": 4.5e-2, "grads": 1.8e-2},
}
#: the loss island on the same bf16 outputs: losses, relative; gradients
#: (rounded to bf16 on both sides), relative L2
TOL_ISLAND_LOSS = 1e-5
TOL_ISLAND_GRAD = 1e-2


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _group(name):
    """A parameter's group: backbone, WC module, pixel decoder or
    transformer decoder."""
    parts = name.split(".")
    return parts[0] if parts[0] == "backbone" else parts[1]


def _group_rel(grads, ref):
    """Relative L2 distance of ``grads`` from ``ref`` per parameter group."""
    acc = {}
    for n, r in ref.items():
        d, s = acc.get(_group(n), (0.0, 0.0))
        acc[_group(n)] = (d + float(((grads[n] - r) ** 2).sum()),
                          s + float((r ** 2).sum()))
    return {g: (d / s) ** 0.5 for g, (d, s) in acc.items()}


def _identity_matching(monkeypatch):
    """Both matchers assign GT slot j to query j."""
    import jax.numpy as jnp

    import axial_vs_tpu.losses.matcher as jax_matcher
    import axial_vs_tpu_torch.losses.matcher as matcher

    def jax_assign(cost, valid, exact=True):
        cols = jnp.arange(cost.shape[2], dtype=jnp.int32)[None]
        return jnp.where(valid, cols, -1)

    def assign(cost, valid, exact=True):
        return torch.where(valid, torch.arange(cost.shape[2])[None], -1)

    monkeypatch.setattr(jax_matcher, "hungarian_assign", jax_assign)
    monkeypatch.setattr(matcher, "hungarian_assign", assign)


def test_bf16_train_step_matches_jax(monkeypatch):
    """One bf16 ``train_step`` against JAX's bf16 ``make_train_step``, to
    the bounds of the module docstring; every master gradient is f32."""
    import jax
    import jax.numpy as jnp
    import optax

    import axial_vs_tpu.layers.kmax_layers as jax_layers
    from axial_vs_tpu.engine.train_step import TrainState, make_train_step
    from axial_vs_tpu.losses.criterion import SetCriterion as J
    from axial_vs_tpu.models.kmax import build_segmenter as jax_build
    from axial_vs_tpu_torch.engine.lr_schedule import tf2_warmup_poly_lr
    from axial_vs_tpu_torch.engine.optim import build_optimizer
    from axial_vs_tpu_torch.engine.train_step import train_step
    from axial_vs_tpu_torch.losses.criterion import SetCriterion
    from axial_vs_tpu_torch.models.kmax import build_segmenter
    from axial_vs_tpu_torch.utils import convert
    from test_torch_parity import jax_init

    monkeypatch.setattr(jax_layers, "nn", _NoDropout())
    _identity_matching(monkeypatch)
    cfg = train_config()
    cfg.model.dtype = "bfloat16"
    cfg.input.image_size = [STEP_SIZE, STEP_SIZE]
    cfg.model.kmax.trans_dec.dec_layers = [0, 0, 1]
    w = cfg.model.maxtron.wc
    w.num_stages, w.spatial_layers, w.temporal_layers = 1, 1, 2
    cfg.solver.clip_gradients.enabled = False  # p.grad keeps the gradient
    classes, s = cfg.model.num_classes, T * STEP_HW * STEP_HW
    kw = dict(weights=LOSS_WEIGHTS, pixel_insdis_sample_k=s,
              aux_semantic_sample_k=s)
    rs = np.random.RandomState(0)
    x = rs.randn(T, STEP_SIZE, STEP_SIZE, 3).astype(np.float32)
    hw = (STEP_HW, STEP_HW)
    tg = {"labels": rs.randint(0, classes, (1, M)),
          "masks": (rs.rand(1, M, T, *hw) > 0.7).astype(np.float32),
          "valid": np.array([[True] * (M - 1) + [False]]),
          "semantic_masks": rs.randint(-1, classes, (1, T, *hw))}
    jm = jax_build(cfg, num_frames=T, train=True)
    v = jax_init(jm, jnp.asarray(x), train=True)
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
        return {k: float(m) for k, m in metrics.items()}, grads

    want, jgrad = jax_step(x)
    moved = [jax_step(x * np.float32(1 + e)) for e in JITTER]

    model = build_segmenter(cfg, torch.device("cpu"),
                            torch.Generator().manual_seed(0), num_frames=T,
                            train=True)
    convert.load_into(model, convert.convert_variables(v))
    model.sem_seg_head.predictor._auxiliary_semantic_predictor._aspp \
        ._proj_drop.rate = 0.0
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    opt, sched = build_optimizer(cfg, model, tf2_warmup_poly_lr(
        cfg.solver.base_lr, cfg.solver.max_iter))
    got = train_step(model, SetCriterion(classes, **kw), opt, sched,
                     {"images": torch.from_numpy(x), "targets": _to_torch(tg)},
                     torch.Generator().manual_seed(1))
    assert sorted(got) == sorted(want)
    assert {p.grad.dtype for p in model.parameters()} == {torch.float32}
    loss_rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    ref = {n: jgrad[n] for n in grads}
    rel = _group_rel(grads, ref)
    own = {g: max(_group_rel(m[1], ref)[g] for m in moved) for g in rel}
    bound = {g: min(GROUP_CAP, GROUP_FACTOR * own[g]) for g in rel}
    assert len(rel) == 4
    assert (max(loss_rel.values()) <= TOL_LOSS_BF16
            and all(rel[g] <= bound[g] for g in rel)), (loss_rel, rel, own)


# ------------------------------------------------------------ the layers ----

def _layer_case(name, rng):
    """(JAX module, its f32 inputs, its keyword arguments, the port module,
    the port call, the converter of (params, batch_stats))."""
    import jax.numpy as jnp

    from axial_vs_tpu_torch.utils import convert

    bf16 = jnp.bfloat16
    if name == "axial":
        from axial_vs_tpu.layers.axial_attention import AxialAttention2D as J
        from axial_vs_tpu_torch.layers.axial_attention import AxialAttention2D

        def conv(p, s):
            return {k: v for axis in ("height_axis", "width_axis")
                    for k, v in convert._prefix(f"_{axis}", convert.axial_attention(
                        p[axis], s[axis])).items()}
        x = rng.randn(2, 5, 7, 24).astype(np.float32)
        return (J(query_shape=(5, 7), filters=16, num_heads=8, dtype=bf16),
                (x,), {}, AxialAttention2D(24, filters=16),
                lambda m, a: m(*a), conv)
    from axial_vs_tpu.layers.msda_attention import MSDeformAttnEncoderLayer as J
    from axial_vs_tpu_torch.layers.msda_attention import MSDeformAttnEncoderLayer

    shapes = ((2, 3), (4, 6), (8, 12))
    s = sum(h * w for h, w in shapes)
    src, pos = (rng.randn(2, s, 64).astype(np.float32) for _ in range(2))
    return (J(d_model=64, d_ffn=96, n_levels=3, n_heads=8, n_points=4,
              dtype=bf16), (src, pos), {"spatial_shapes": shapes},
            MSDeformAttnEncoderLayer(64, 96, 3, 8, 4),
            lambda m, a: m(a[0], a[1], shapes),
            lambda p, s: convert.msda_encoder_layer(p))


@pytest.mark.parametrize("name", sorted(LAYER_BOUNDS))
def test_bf16_layer_matches_jax(name):
    """A layer in train mode on bf16 inputs, f32 weights: its output, the
    VJP of a seeded bf16 cotangent (the inputs' and every parameter's
    gradient, f32 for the parameters) and, where it has BatchNorms, the
    statistics' update, against the JAX layer's, within ``LAYER_BOUNDS``.
    Measured at these seeds: the axial block's output 3.97e-3, the input's
    gradient 1.18e-2, the parameters' 5.83e-3, its statistics' update
    8.1e-4; MSDA's 3.29e-3, 3.63e-2, 1.40e-2. A bf16 softmax island in the
    axial block moves its output to 5.96e-3 and its gradients to 8.1e-3;
    bf16 BatchNorm statistics move its statistics to 2.4e-3; bf16
    LayerNorm statistics move MSDA's output to 4.05e-3; sampling offsets
    divided in bf16 move MSDA's input gradient to 5.5e-2."""
    import jax
    import jax.numpy as jnp

    from axial_vs_tpu_torch.utils import convert
    from test_torch_parity import jax_init

    bounds = LAYER_BOUNDS[name]
    rng = np.random.RandomState(0)
    jm, args, kw, module, call, conv = _layer_case(name, rng)
    v = jax_init(jm, *map(jnp.asarray, args), train=True, **kw)
    stats = v.get("batch_stats")

    def fn(params, *xs):
        extra = {"batch_stats": stats} if stats else {}
        out = jm.apply({"params": params, **extra}, *xs, train=True,
                       mutable=["batch_stats"] if stats else False, **kw)
        return out if stats else (out, {})

    out, vjp, new = jax.jit(lambda p, *xs: jax.vjp(fn, p, *xs, has_aux=True))(
        v["params"], *(jnp.asarray(a, jnp.bfloat16) for a in args))
    ct = rng.randn(*out.shape).astype(np.float32)
    jg = vjp(jnp.asarray(ct, jnp.bfloat16))
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    start = conv(np_tree(v["params"]), np_tree(stats) if stats else None)
    want = conv(np_tree(jg[0]), np_tree(stats) if stats else None)

    convert.load_into(module, start).train()
    xs = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
          for a in args]
    got = call(module, xs)
    got.backward(torch.from_numpy(ct).to(torch.bfloat16))
    grads = {n: p.grad for n, p in module.named_parameters()}
    assert {g.dtype for g in grads.values()} == {torch.float32}
    dist = {"out": _rel(got.float().detach(), np.asarray(out, np.float32)),
            "dx": max(_rel(x.grad.float(), np.asarray(g, np.float32))
                      for x, g in zip(xs, jg[1:]))}
    err = sum(float(((g.numpy() - want[n]) ** 2).sum())
              for n, g in grads.items())
    dist["grads"] = (err / sum(float((want[n] ** 2).sum())
                               for n in grads)) ** 0.5
    if stats:
        moved = conv(np_tree(v["params"]), np_tree(new["batch_stats"]))
        keys = [k for k in moved if "running" in k]
        assert keys
        dist["stats"] = max(
            _rel(module.state_dict()[k].numpy() - start[k], moved[k] - start[k])
            for k in keys)
    assert dist.keys() == bounds.keys()
    assert all(dist[k] <= bounds[k] for k in bounds), (dist, bounds)


def test_bf16_criterion_matches_jax():
    """The f32 loss island: the set criterion on the same bf16 model
    outputs (every term, the aux layers, the semantic head), against JAX's
    criterion on them: each loss within ``TOL_ISLAND_LOSS``, the weighted
    total's gradients by the outputs within ``TOL_ISLAND_GRAD``. Measured:
    losses within 2e-7, gradients within 2e-5. The loss terms' log-softmax
    run in bf16 misses the first bound 13x."""
    import jax
    import jax.numpy as jnp

    from axial_vs_tpu.losses.criterion import SetCriterion as J
    from axial_vs_tpu_torch.losses.criterion import SetCriterion

    rng = np.random.RandomState(4)
    out, tg = _outputs(rng), _targets(rng)
    s = 2 * 2 * 6 * 7  # every pixel sampled: the losses do not depend on draws
    kw = dict(weights=LOSS_WEIGHTS, pixel_insdis_sample_k=s,
              aux_semantic_sample_k=s)
    bf16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), out)
    jc = J(6, **kw)

    def total(o):
        losses = jc(jax.random.PRNGKey(0), o, _to_jax(tg))
        return jc.weighted_total(losses), losses

    (_, want), jgrad = jax.jit(jax.value_and_grad(total, has_aux=True))(bf16)
    leaves = jax.tree.leaves(jgrad)
    assert {g.dtype for g in leaves} == {jnp.dtype(jnp.bfloat16)}

    tout = jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16).requires_grad_(), bf16)
    crit = SetCriterion(6, **kw)
    got = crit(tout, _to_torch(tg), torch.Generator().manual_seed(0))
    crit.weighted_total(got).backward()
    assert sorted(got) == sorted(want)
    for k in want:
        w = float(want[k])
        err = abs(float(got[k].detach()) - w)
        assert err <= TOL_ISLAND_LOSS * max(abs(w), 1e-6), (k, err, w)
    for t, g in zip(jax.tree.leaves(tout), leaves):
        assert t.grad.dtype == torch.bfloat16
        err = _rel(t.grad.float(), np.asarray(g, np.float32))
        assert err <= TOL_ISLAND_GRAD, err


# --------------------------------------------------- drop path and remat ----

def _convnext_train_model(remat, rate):
    from axial_vs_tpu_torch.models.kmax import build_segmenter

    cfg = train_config("convnext")
    cfg.model.backbone.convnext.drop_path_rate = rate
    cfg.model.backbone.remat = remat
    return build_segmenter(cfg, torch.device("cpu"),
                           torch.Generator().manual_seed(0), num_frames=T,
                           train=True)


def test_convnext_drop_path_rates():
    """Block k of the backbone drops at linspace(0, rate, sum(depths))[k],
    as the JAX ConvNeXt does; ``remat`` reaches every stage."""
    model = _convnext_train_model(True, 0.3)
    blocks = [b for st in model.backbone.stages for b in st.blocks]
    want = np.linspace(0.0, 0.3, len(blocks))
    assert [b.drop_path_rate for b in blocks] == pytest.approx(want)
    assert all(st.remat for st in model.backbone.stages)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_keeps_the_drop_path_masks(dtype):
    """A ConvNeXt backbone with drop path 0.5 and remat on, against remat
    off, from the same weights and generator seed: the same outputs and
    gradients, bitwise; and some residual branch was dropped (the masks
    are not all ones), so a mask re-drawn in the replay would show."""
    dt = getattr(torch, dtype)
    x = torch.randn(4, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    runs = []
    for remat in (False, True):
        model = _convnext_train_model(remat, 0.5)
        for st in model.backbone.stages:  # layer scale 1: branches matter
            for b in st.blocks:
                b.gamma.data.fill_(1.0)
        out = model.backbone(x.to(dt), torch.Generator().manual_seed(1))
        loss = sum(v.float().square().mean() for v in out.values())
        loss.backward()
        runs.append((loss.detach(), {n: p.grad.clone() for n, p in
                                     model.backbone.named_parameters()}))
    (la, ga), (lb, gb) = runs
    assert torch.equal(la, lb)
    assert ga.keys() == gb.keys()
    for n in ga:
        assert torch.equal(ga[n], gb[n]), n
    gen = torch.Generator().manual_seed(1)
    masks = [torch.rand((4, 1, 1, 1), generator=gen) < 1 - b.drop_path_rate
             for st in model.backbone.stages for b in st.blocks
             if b.drop_path_rate > 0]
    assert not all(bool(m.all()) for m in masks)
