"""Training of the port's Tube-Link VIS (axial_vs_tpu_torch) against the
JAX package, on the CPU in f32: the criterion's point sampling and every
loss term with their logit gradients, the optimizer's parameter rules on
``TubeLinkVIS``, one whole training step, the ``Trainer`` and CLI on a
YTVIS yaml, and the overfit tool.

The criterion draws its points at random. Here JAX's
``jax.random.randint`` is replaced, in this test process only, by seeded
numpy draws that are kept (under ``jax.jit`` they become constants of the
program), and the port's ``criterion._randint`` replays them in order,
checking each draw's shape and range: both sides then sample the same
points, and the order of the draws is held to JAX's.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from axial_vs_tpu_torch.utils import convert
from fixtures_ytvis import synthesize_ytvis_videos
from test_torch_parity import randomize
from test_torch_parity import numpy_lsap, torch_threads  # noqa: F401 (autouse)
from test_torch_train import _id_tree, rel_err

#: the criterion's terms on the same inputs, relative
TOL_TERM = 1e-5
#: each logit gradient of the criterion, and each parameter gradient of the
#: whole step, relative to the tensor's max
TOL_GRAD = 1e-4
#: the step's gradients that are zero in exact arithmetic (the key biases
#: of a softmax attention, a bias before a GroupNorm) are f32 rounding noise
#: on both sides: such a tensor is held below this share of the step's
#: largest gradient instead of ``TOL_GRAD``
GRAD_NOISE = 1e-7
#: the losses of the whole step, relative
TOL_LOSS = 1e-5
#: parameters and BatchNorm running statistics after the step's update,
#: relative to each tensor's max
TOL_UPDATE = 1e-6
B, T, Q, HW, M = 2, 2, 8, 16, 4  # tubes, frames, queries, mask grid, GT slots
YAML = "ytvis19/tube_link_maxtron_wc_r50.yaml"
#: the narrow R18 model of the whole step: 64 channels (the pixel decoder's
#: 8 heads of 8: K3 takes heads of 8, 16 and 32), 2 decoder layers
NARROW = ["model.backbone.name", "resnet18", "model.backbone.resnet.depth", 18,
          "model.num_classes", 5, "model.tube_link.num_queries", Q,
          "model.tube_link.feat_channels", 64,
          "model.tube_link.out_channels", 64,
          "model.tube_link.num_decoder_layers", 2,
          "input.num_clip_frames", T, "input.num_video_frames", T,
          "input.image_size", [4 * HW, 4 * HW]]


class Draws:
    """JAX's ``randint`` replaced by seeded numpy draws that are kept; the
    port's ``_randint`` replays them in order."""

    def __init__(self, monkeypatch, seed=0):
        import axial_vs_tpu_torch.models.tube_link.criterion as crit

        self.rs = np.random.RandomState(seed)
        self.kept, self.used = [], 0
        monkeypatch.setattr(jax.random, "randint", self.jax_randint)
        monkeypatch.setattr(crit, "_randint", self.replay)

    def jax_randint(self, key, shape, minval, maxval, dtype=jnp.int32):
        x = self.rs.randint(minval, maxval, shape)
        self.kept.append((x, maxval))
        return jnp.asarray(x, jnp.int32)

    def replay(self, generator, shape, high, device):
        x, want_high = self.kept[self.used]
        self.used += 1
        assert (tuple(shape), high) == (x.shape, want_high), self.used
        return torch.from_numpy(x).to(device)

    def all_replayed(self):
        return self.used == len(self.kept) > 0


def _configs(opts=()):
    """The JAX and the port config of the yaml with ``opts``."""
    from axial_vs_tpu.config import get_default_config as jax_defaults
    from axial_vs_tpu_torch.config import CONFIGS_DIR, load_config

    want = jax_defaults().merge_from_file(str(CONFIGS_DIR / YAML))
    return want.merge_from_list(list(opts)), load_config(YAML, list(opts))


# ---------------------------------------------------------- the criterion ----

def test_uncertainty_points_match_jax(monkeypatch):
    """Logits on a coarse grid (many equal |logit|) and candidates drawn
    with replacement: the ties go to the earlier candidate on both sides,
    so the same points come out."""
    from axial_vs_tpu.models.tube_link.criterion import (
        uncertainty_point_idx as J)
    from axial_vs_tpu_torch.models.tube_link.criterion import (
        uncertainty_point_idx)

    draws = Draws(monkeypatch)
    rs = np.random.RandomState(1)
    logits = (rs.randint(-6, 7, (5, 300)) / 4).astype(np.float32)
    want = np.asarray(J(jax.random.PRNGKey(0), jnp.asarray(logits), 200))
    got = uncertainty_point_idx(None, torch.from_numpy(logits), 200)
    assert draws.all_replayed() and got.shape == (5, 200)
    np.testing.assert_array_equal(got.numpy(), want)


def _targets(rs, classes):
    """M = 4 GT slots, 1 and 3 of them valid."""
    return {"labels": rs.randint(0, classes, (B, M)).astype(np.int32),
            "masks": (rs.rand(B, M, T, HW, HW) > 0.6).astype(np.float32),
            "valid": np.array([[True, False, False, False],
                               [True, True, True, False]])}


def _criterion_inputs(rs, classes, layers=3):
    cls = [rs.randn(B, Q, classes + 1).astype(np.float32) for _ in range(layers)]
    masks = [(rs.randn(B, T, Q, HW, HW) * 3).astype(np.float32)
             for _ in range(layers)]
    return cls, masks, _targets(rs, classes)


@pytest.mark.parametrize("case", ["exact", "auction", "stuff_split"])
def test_criterion_terms_match_jax(monkeypatch, case):
    """Every term of ``TubeLinkCriterion`` over 3 layers on random outputs
    (B = 2, T = 2, Q = 8, 16x16, M = 4 with 1 and 3 valid GTs) and the
    gradients of their sum with respect to every class and mask logit:
    exact matching, the auction, and the VPS form (stuff pinned to the last
    queries, thing and stuff terms apart) with the last layer's assignment.
    250 match points and 300 loss points of the 512 a tube: candidates
    repeat, so ties are broken."""
    from axial_vs_tpu.models.tube_link.criterion import TubeLinkCriterion as J
    from axial_vs_tpu_torch.models.tube_link.criterion import TubeLinkCriterion

    stuff = case == "stuff_split"
    kw = dict(num_things=3 if stuff else 5, num_stuff=2 if stuff else 0,
              num_points=300, match_points=250,
              exact_matching=case == "exact", stuff_fixed=stuff,
              loss_split=stuff)
    rs = np.random.RandomState(2)
    cls, masks, targets = _criterion_inputs(rs, 5)
    draws = Draws(monkeypatch)
    jcrit = J(**kw)

    def loss(c, m):
        out = jcrit(jax.random.PRNGKey(0), {"cls_preds": c, "mask_preds": m},
                    jax.tree.map(jnp.asarray, targets), return_assign=True)
        return jcrit.total(out[0]), out

    (_, (want, want_assign)), (gc, gm) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            [jnp.asarray(c) for c in cls], [jnp.asarray(m) for m in masks])

    tc = [torch.from_numpy(c).requires_grad_() for c in cls]
    tm = [torch.from_numpy(m).requires_grad_() for m in masks]
    crit = TubeLinkCriterion(**kw)
    got, assign = crit({"cls_preds": tc, "mask_preds": tm},
                       {k: torch.from_numpy(v) for k, v in targets.items()},
                       None, return_assign=True)
    crit.total(got).backward()
    assert draws.all_replayed()
    assert len(got) == 3 * (6 if stuff else 3) and sorted(got) == sorted(want)
    for k, w in want.items():
        assert abs(got[k].item() - float(w)) <= TOL_TERM * abs(float(w)), k
    np.testing.assert_array_equal(assign.numpy(), np.asarray(want_assign))
    matched = targets["valid"] & (targets["labels"] < kw["num_things"])
    assert (assign[matched] >= 0).all() and (assign[~matched] == -1).all()
    for g, w in zip(tc + tm, list(gc) + list(gm)):
        assert rel_err(g.grad, w) <= TOL_GRAD


# -------------------------------------------------------- parameter rules ----

def _narrow(temporal):
    """The JAX and port configs of the narrow model, JAX's module and
    criterion from its builder, and the module's variable shapes."""
    from axial_vs_tpu.models.build import build_model_and_criterion

    jcfg, cfg = _configs(NARROW + ["model.tube_link.use_temporal_attn",
                                   temporal])
    jm, jcrit = build_model_and_criterion(jcfg, train=True)
    x = jnp.zeros((B * T, 4 * HW, 4 * HW, 3), jnp.float32)
    return jcfg, cfg, jm, jcrit, jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), x, train=True))


@pytest.fixture(scope="module")
def narrow_temporal():
    return _narrow(True)


@pytest.mark.parametrize("temporal", [True, False])
def test_param_rules_match_jax(narrow_temporal, temporal):
    """Every ``TubeLinkVIS`` parameter, with MaXTron's temporal attention
    and without (the Tube-Link baseline), gets the (lr_mult, wd) that JAX's
    rules give the flax path ``convert.tube_link_vis`` carries into it (the
    pixel decoder's GroupNorms ``input_norms.{i}`` among them)."""
    from axial_vs_tpu.engine.optim import param_rules as jax_rules
    from axial_vs_tpu_torch.engine.optim import param_rules
    from axial_vs_tpu_torch.models.build import build_model_and_criterion

    jcfg, cfg, _, _, shapes = narrow_temporal if temporal else _narrow(False)
    ids, paths = _id_tree(shapes["params"])
    stats = jax.tree.map(lambda s: np.zeros(s.shape), shapes["batch_stats"])
    sd = convert.tube_link_vis({"params": ids, "batch_stats": stats})
    model, _ = build_model_and_criterion(cfg, device=torch.device("cpu"),
                                         generator=torch.Generator())
    want, got = jax_rules(jcfg), param_rules(cfg)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(paths)
    assert any("input_norms" in n for n in names)
    assert any("temporal_encoder" in n for n in names) == temporal
    for name in names:
        (i,) = np.unique(sd[name])
        assert got(name) == pytest.approx(want(paths[int(i)])), (
            name, paths[int(i)])


# --------------------------------------------------------- one whole step ----

def test_train_step_matches_jax(narrow_temporal, monkeypatch):
    """One ``train_step`` of the narrow R18 ``TubeLinkVIS`` (64x64, T = 2,
    B = 2) on the yaml's criterion (the auction) and optimizer (AdamW,
    gradient clip 0.01, warmup) against JAX's from the same weights, batch
    and draws: every loss, every parameter's gradient, and the parameters
    and BatchNorm running statistics after the update. JAX's side is
    ``make_train_step`` with an optax stage that keeps the gradients, then
    the yaml's optax chain on them, as ``make_train_step`` applies it
    (params + updates): jitted apart, since inside the step its per-leaf
    rules doubled the step's compile time."""
    from axial_vs_tpu.engine.lr_schedule import tf2_warmup_poly_lr as jsched
    from axial_vs_tpu.engine.optim import build_optimizer as jax_optimizer
    from axial_vs_tpu.engine.train_step import TrainState, make_train_step
    from axial_vs_tpu_torch.engine.lr_schedule import tf2_warmup_poly_lr
    from axial_vs_tpu_torch.engine.optim import build_optimizer
    from axial_vs_tpu_torch.engine.train_step import train_step
    from axial_vs_tpu_torch.models.build import build_model_and_criterion

    jcfg, cfg, jm, jcrit, shapes = narrow_temporal
    assert cfg.solver.clip_gradients.enabled and jcfg.solver.warmup_iters
    sol = cfg.solver
    vn = randomize(shapes, 0)
    v = jax.tree.map(jnp.asarray, vn)
    rs = np.random.RandomState(0)
    x = rs.randn(B * T, 4 * HW, 4 * HW, 3).astype(np.float32)
    targets = _targets(rs, cfg.model.num_classes)
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, st, p=None: (g, g))
    draws = Draws(monkeypatch)
    step = jax.jit(make_train_step(jm, jcrit, keep))
    new, metrics = step(
        TrainState(jnp.zeros([], jnp.int32), v["params"], v["batch_stats"],
                   keep.init(v["params"])),
        {"images": jnp.asarray(x),
         "targets": jax.tree.map(jnp.asarray, targets)},
        jax.random.PRNGKey(1))
    tx = jax_optimizer(jcfg, v["params"], jsched(
        sol.base_lr, sol.max_iter, warmup_iters=sol.warmup_iters,
        power=sol.poly_power))
    updates, _ = jax.jit(tx.update)(new.opt_state, tx.init(v["params"]),
                                    v["params"])
    params = jax.tree.map(lambda p, u: np.asarray(p + u), v["params"],
                          updates)
    want = {k: float(m) for k, m in metrics.items()}
    zero = jax.tree.map(np.zeros_like, vn["batch_stats"])
    jgrad = convert.tube_link_vis({"params": jax.tree.map(
        np.asarray, new.opt_state), "batch_stats": zero})
    after = convert.tube_link_vis({"params": params, "batch_stats":
                                   jax.tree.map(np.asarray, new.batch_stats)})

    model, crit = build_model_and_criterion(cfg, device=torch.device("cpu"),
                                            generator=torch.Generator())
    convert.load_into(model, convert.tube_link_vis(vn))
    opt, sched = build_optimizer(cfg, model, tf2_warmup_poly_lr(
        sol.base_lr, sol.max_iter, warmup_iters=sol.warmup_iters,
        power=sol.poly_power))
    grads = {}
    for n, p in model.named_parameters():  # the gradient before the clip
        p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
    got = train_step(model, crit, opt, sched,
                     {"images": torch.from_numpy(x),
                      "targets": {k: torch.from_numpy(a)
                                  for k, a in targets.items()}},
                     torch.Generator())
    assert draws.all_replayed()
    assert sorted(got) == sorted(want) and len(got) == 3 * 3 + 1
    for k in want:
        assert abs(got[k] - want[k]) <= TOL_LOSS * abs(want[k]), k
    noise = GRAD_NOISE * max(np.abs(g).max() for g in jgrad.values())
    for n, _ in model.named_parameters():
        g = grads.get(n, torch.zeros(jgrad[n].shape))  # not reached: zero
        if rel_err(g, jgrad[n]) > TOL_GRAD:  # only a zero gradient's noise
            assert max(np.abs(jgrad[n]).max(),
                       g.abs().max().item()) <= noise, n
    for n, t in model.state_dict().items():
        assert rel_err(t, after[n]) <= TOL_UPDATE, n


# ------------------------------------------------- Trainer, CLI and tool ----

TRAIN, TEST = "ytvis_tl_trainer_train", "ytvis_tl_trainer_val"
#: the narrowest trainer model: 32 channels, one decoder layer, 32x32 tubes
TRAINER_OPTS = NARROW + [
    "input.image_size", [32, 32],
    "model.tube_link.feat_channels", 32, "model.tube_link.out_channels", 32,
    "model.tube_link.num_decoder_layers", 1, "model.tube_link.clip_len", T,
    "model.tube_link.test_topk", 4, "model.num_classes", 2,
    "solver.ims_per_batch", 2, "solver.max_iter", 4,
    "solver.checkpoint_period", 2, "dataloader.num_workers", 0,
    "test.eval_period", 0, "datasets.train", [TRAIN],
    "datasets.test", [TEST]]


@pytest.fixture(scope="module")
def registered(tmp_path_factory):
    from axial_vs_tpu_torch.data.catalog import DatasetCatalog
    from axial_vs_tpu_torch.data.ytvis import register_ytvis

    root = synthesize_ytvis_videos(str(tmp_path_factory.mktemp("ytvis")))
    for name in (TRAIN, TEST):
        if name not in DatasetCatalog:
            register_ytvis(name, *root)
    return root


def _trainer(out, *extra):
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.engine.trainer import Trainer

    return Trainer(load_config(YAML, TRAINER_OPTS + ["output_dir", str(out),
                                                     *extra]),
                   device=torch.device("cpu"))


def test_trainer_resumes_and_evaluates(registered, tmp_path):
    """4 steps straight equal 2 steps, a fresh ``Trainer`` resumed from the
    step-2 checkpoint and 2 more steps, bitwise (model with its BatchNorm
    statistics, optimizer, losses); the eval hook runs ``evaluate_ytvis``
    at steps 2 and 4 (an AP of the training videos)."""
    from axial_vs_tpu_torch.models.tube_link.criterion import TubeLinkCriterion

    straight = _trainer(tmp_path / "a")
    assert isinstance(straight.criterion, TubeLinkCriterion)
    assert not straight.criterion.exact_matching
    want = straight.train()
    assert len(want) == 2 * 3 + 1 and all(np.isfinite(list(want.values())))
    _trainer(tmp_path / "b").train(max_iter=2)
    resumed = _trainer(tmp_path / "b", "test.eval_period", 2)
    evals = []
    got = resumed.train(resume=True, eval_fn=lambda: evals.append(
        (resumed.step, resumed.evaluate(max_videos=1))))
    assert got == want
    for n, t in straight.model.state_dict().items():
        assert torch.equal(t, resumed.model.state_dict()[n]), n
    for sa, sb in zip(straight.optimizer.state.values(),
                      resumed.optimizer.state.values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert [s for s, _ in evals] == [4]
    res = evals[0][1]
    assert res["num_videos"] == 1 and res["num_predictions"] == 4
    assert -1.0 <= res["AP"] <= 1.0 and resumed.model.training


def test_train_net_video_trains(registered, tmp_path):
    """``train_net_video`` trains the same yaml (both variants), its
    checkpoint at the last step."""
    from axial_vs_tpu_torch.tools import train_net_video

    for temporal in (True, False):
        out = tmp_path / str(temporal)
        trainer = train_net_video.main([
            "--config-file", YAML, "--device", "cpu", "--opts",
            *map(str, TRAINER_OPTS), "solver.max_iter", "1",
            "model.tube_link.use_temporal_attn", str(temporal),
            "output_dir", str(out)])
        assert trainer.step == 1 and trainer.ckpt.all_steps() == [1]
        assert any("temporal" in n for n in trainer.model.state_dict()) \
            == temporal


def test_overfit_tool_runs(tmp_path, capsys):
    """The overfit tool for 2 steps and one eval on the CPU: its eval line
    and its last line, the curve."""
    import json

    from axial_vs_tpu_torch.tools import validate_overfit_vis

    rc = validate_overfit_vis.main(["--steps", "2", "--eval-every", "2",
                                    "--target", "0", "--device", "cpu",
                                    "--out", str(tmp_path)])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert rc == 0 and lines[0]["step"] == 2 and np.isfinite(lines[0]["loss"])
    assert lines[-1]["curve"][0]["AP"] == lines[0]["AP"] >= 0.0
