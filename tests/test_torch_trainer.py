"""The port's trainer (``axial_vs_tpu_torch/engine``) and its CLI
(``axial_vs_tpu_torch/tools/train_net_video.py``) on the CPU, on a narrow
R18 WC model in bf16 at 64x64 crops of the synthetic VIPSeg videos of
``tests/fixtures_vipseg.py``, with a synchronous loader.

Four straight steps equal two steps, a resume from the step-2 checkpoint in
a fresh ``Trainer``, and two more steps, bitwise: the checkpoint carries
the model with its BatchNorm statistics, the optimizer, the schedule and
the step generator, and the resumed run replays the data order.
``load_weights`` of a pickled JAX parameter tree gives JAX's forward, to
``TOL_FORWARD`` of each output's max.
"""
import pickle

import numpy as np
import pytest
import torch

from fixtures_coco import write_tiny_coco
from fixtures_vipseg import synthesize_vipseg_videos
from test_torch_parity import torch_threads  # noqa: F401 (autouse)

TRAIN, TEST = "vipseg_trainer_test_train", "vipseg_trainer_test_val"
#: the port's f32 forward after ``load_weights`` against JAX's, relative
#: to each output's max
TOL_FORWARD = 1e-4
NARROW = ["model.backbone.name", "resnet18", "model.backbone.resnet.depth",
          18, "model.num_classes", 7, "input.image_size", [64, 64],
          "model.maxtron.wc.conv_dims", 64,
          "model.maxtron.wc.dim_feedforward", 96,
          "model.maxtron.wc.num_stages", 1,
          "model.maxtron.wc.spatial_layers", 1,
          "model.maxtron.wc.temporal_layers", 2,
          "model.kmax.pixel_dec.dec_layers", [1, 1, 1, 1],
          "model.kmax.pixel_dec.dec_channels", [32, 16, 16, 16],
          "model.kmax.trans_dec.dec_layers", [1, 1, 1],
          "model.kmax.trans_dec.num_object_queries", 16]


@pytest.fixture(scope="module")
def registered(tmp_path_factory):
    from axial_vs_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from axial_vs_tpu_torch.data.vipseg import set_panoptic_metadata

    videos = synthesize_vipseg_videos(str(tmp_path_factory.mktemp("vids")),
                                      n_videos=2, n_frames=4, hw=(90, 160))
    for name in (TRAIN, TEST):
        if name not in DatasetCatalog:
            DatasetCatalog.register(name, lambda: videos)
            set_panoptic_metadata(MetadataCatalog.get(name), [
                dict(id=i, isthing=int(i < 4)) for i in range(7)])
    return videos


def _opts(out, **extra):
    opts = NARROW + [
        "model.dtype", "bfloat16", "solver.ims_per_batch", 1,
        "solver.max_iter", 4, "solver.checkpoint_period", 2,
        "dataloader.num_workers", 0, "test.eval_period", 0,
        "datasets.train", [TRAIN], "datasets.test", [TEST],
        "output_dir", str(out)]
    for k, v in extra.items():
        opts += [k.replace("__", "."), v]
    return opts


def _cfg(out, **extra):
    from axial_vs_tpu_torch.config import load_config

    return load_config("vipseg/maxtron_wc_r50.yaml", _opts(out, **extra))


def _trainer(out, **extra):
    from axial_vs_tpu_torch.engine.trainer import Trainer

    return Trainer(_cfg(out, **extra), device=torch.device("cpu"))


def test_resume_replays_the_straight_run(registered, tmp_path):
    """4 steps straight == 2 steps, a fresh Trainer resumed from step 2,
    and 2 more steps: parameters, BatchNorm statistics, optimizer moments
    and losses bitwise; the restored state equals the saved one."""
    straight = _trainer(tmp_path / "a")
    want = straight.train()
    a = _trainer(tmp_path / "b")
    a.train(max_iter=2)
    saved = a.state_dict()
    assert a.ckpt.all_steps() == [2]
    b = _trainer(tmp_path / "b")
    b.resume_or_load(resume=True)
    restored = b.state_dict()
    assert restored["step"] == 2
    for n, t in saved["model"].items():
        assert torch.equal(t, restored["model"][n]), n
    opt_a, opt_b = saved["optimizer"], restored["optimizer"]
    assert opt_a["param_groups"] == opt_b["param_groups"]
    for i, st in opt_a["state"].items():
        assert all(torch.equal(st[k], opt_b["state"][i][k]) for k in st)
    assert torch.equal(saved["generator"], restored["generator"])
    assert saved["scheduler"] == restored["scheduler"]
    got = _trainer(tmp_path / "b").train(resume=True)
    assert got == want
    end = _trainer(tmp_path / "b")
    end.resume_or_load(resume=True)
    assert end.step == 4 and end.ckpt.all_steps() == [2, 4]
    for n, t in straight.model.state_dict().items():
        assert torch.equal(t, end.model.state_dict()[n]), n
    for (sa, sb) in zip(straight.optimizer.state.values(),
                        end.optimizer.state.values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_eval_hook_follows_the_dynamic_intervals(registered, tmp_path):
    """``eval_period`` 2 with ``dynamic_eval_intervals`` [(2, 1)]: evaluated
    at steps 2, 3 and 4 of 4; the model is back in train mode after."""
    tr = _trainer(tmp_path, test__eval_period=2)
    steps = []
    tr.train(eval_fn=lambda: steps.append(tr.step),
             dynamic_eval_intervals=[(2, 1)])
    assert steps == [2, 3, 4]
    assert tr.loader_close_s == 0.0  # the synchronous loader


def test_cli_trains_evaluates_and_resumes(registered, tmp_path):
    """``train_net_video.main``: 2 steps with the VIPSeg eval hook at step
    2 (one video), then ``--resume`` to step 3; ``--eval-only`` returns
    VPQ; ``--distributed`` and a COCO-format training set raise."""
    from axial_vs_tpu_torch.engine import evaluator_loop
    from axial_vs_tpu_torch.tools import train_net_video

    calls = []
    real = evaluator_loop.evaluate_vipseg

    def counted(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    evaluator_loop.evaluate_vipseg = counted
    try:
        base = ["--config-file", "configs/vipseg/maxtron_wc_r50.yaml",
                "--device", "cpu", "--opts"]
        opts = _opts(tmp_path, solver__max_iter=2, test__eval_period=2)
        tr = train_net_video.main(base + _flat(opts),
                                  eval_kwargs={"max_videos": 1})
        assert tr.step == 2 and len(calls) == 1
        tr = train_net_video.main(["--resume"] + base + _flat(
            _opts(tmp_path, solver__max_iter=3)))
        assert tr.step == 3 and tr.ckpt.all_steps() == [2, 3]
        res = train_net_video.main(["--eval-only", "--resume"] + base + _flat(
            _opts(tmp_path)), eval_kwargs={"max_videos": 1})
        assert 0.0 <= res["vpq"] <= 1.0 and len(calls) == 2
    finally:
        evaluator_loop.evaluate_vipseg = real
    with pytest.raises(NotImplementedError):
        train_net_video.main(["--distributed"] + base + _flat(_opts(tmp_path)))
    # a COCO-format training set: the trainer builds its COCO mapper and
    # refuses to train, naming it (image training is not ported)
    coco = write_tiny_coco(tmp_path / "coco", "coco_trainer_tiny")
    with pytest.raises(NotImplementedError, match="coco_panoptic"):
        train_net_video.main(base + _flat(_opts(
            tmp_path, datasets__train=[coco], datasets__test=[coco],
            test__eval_period=5)))


def _flat(opts):
    """--opts values as the command line gives them."""
    return [str(o).replace(" ", "") for o in opts]


def test_load_weights_of_a_jax_tree_gives_the_jax_forward(registered,
                                                         tmp_path):
    """A pickled JAX training tree ({"params", "batch_stats"} as numpy):
    the port's model after ``load_weights`` (f32, eval) gives JAX's eval
    forward on the same frames."""
    import jax
    import jax.numpy as jnp

    from axial_vs_tpu.config import get_default_config
    from axial_vs_tpu.models.kmax import build_segmenter as jax_build
    from test_torch_parity import jax_apply, jax_init

    opts = _opts(tmp_path, model__dtype="float32")
    jcfg = get_default_config()
    jcfg.merge_from_file("configs/vipseg/maxtron_wc_r50.yaml")
    jcfg.merge_from_list(opts)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    jm = jax_build(jcfg, num_frames=2, train=True)
    v = jax_init(jm, jnp.asarray(x), train=True)
    path = tmp_path / "jax_tree.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, v), f)
    tr = _trainer(tmp_path, model__dtype="float32")
    tr.load_weights(str(path))
    want = jax_apply(jm, v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tr.model.eval()(torch.from_numpy(x))
    for k in ("pred_logits", "pred_masks"):
        g, w = got[k].numpy(), want[k]
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= TOL_FORWARD * np.abs(w).max(), k
