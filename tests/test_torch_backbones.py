"""Parity of the port's Swin Transformer and STDC backbones with the JAX
package, and the builders on every yaml that names one.

The same inputs, made with numpy from a seed, go through the JAX module and
the port's, every parameter and BatchNorm statistic drawn
(``test_torch_parity.py``'s ``randomize``) and carried to the port by
``axial_vs_tpu_torch/utils/convert.py``. Tolerances, each relative to the
largest |value| of the JAX output:

- f32 forwards (the window helpers exactly): ``TOL`` = 1e-5;
- gradients against ``jax.grad`` (drop path 0): ``TOL_GRAD`` = 1e-4 of
  each parameter's largest gradient;
- Swin in bf16 against JAX in bf16: the port may be at most
  ``BF16_VS_JAX`` = 2x as far from JAX's bf16 output as that output is
  from JAX's f32 one (measured up to 1.43x at seeds 0-2: the two round
  the bf16 matmuls and casts in different orders), and at most
  ``BF16_VS_F32`` = 1.25x as far from JAX's f32 output as JAX's bf16 is
  (measured up to 1.14x);
- STDC in ``train()``: the batch statistics of a few pixels a channel on
  the deep stages amplify f32 rounding in both packages. ``stdc64``, a
  float64 numpy pass of JAX's STDCNet that reads JAX's variables and
  shares no code with either package, is the witness. At the seeds here
  (0-2 and 4) JAX's f32 res5 of the stdc2 cat net lies up to 4.55e-5 of
  max from it, the port's up to 2.39e-5; the witness is held to JAX
  within ``WITNESS`` = 1e-4 of max, lest a wrong witness widen the bounds
  below. Each output is held to JAX's within ``TOL`` or, beyond it, the
  port to the witness within ``F64_SLACK`` = 2x JAX's own distance from
  it (measured up to 1.35x) and to JAX within ``F64_TRIANGLE`` = 1 +
  ``F64_SLACK`` times that distance (measured up to 2.02x).
- Swin at the upstream init (every bias zero) on a half zero-padded input:
  a padded patch is a zero row in the LayerNorms, whose backward at zero
  variance multiplies by 1 / sqrt(eps). JAX's largest gradient is then at
  least ``PAD_AMPLIFIED`` = 1e3x its largest with the biases drawn
  (measured 5.5e4x); the port's gradients match JAX's within
  ``TOL_GRAD`` in both cases.
"""
import glob
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import traverse_util
from numpy.lib.stride_tricks import sliding_window_view

from axial_vs_tpu_torch.utils import convert
from test_torch_parity import jax_apply, jax_init, port, t
from test_torch_parity import torch_threads  # noqa: F401 (autouse)

TOL = 1e-5
TOL_GRAD = 1e-4
BF16_VS_JAX = 2.0
BF16_VS_F32 = 1.25
F64_SLACK = 2.0
F64_TRIANGLE = 1.0 + F64_SLACK
WITNESS = 1e-4
PAD_AMPLIFIED = 1e3
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
#: a small Swin: four stages of two blocks, 16 channels a head
SWIN = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16),
            window_size=7)
#: 61x67: the patch embed pads SAME (1, 2) and (0, 1); every stage's side
#: is off the window, and the last ones pad up to one window (hp == ws)
SWIN_HW = (61, 67)


def within(got, want, tol):
    got = (got.detach().float().numpy() if torch.is_tensor(got)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, (err, tol * scale)
    return err / scale


def _yaml_names(prefixes):
    out = []
    for p in sorted(glob.glob(os.path.join(CONFIGS, "*", "*.yaml"))):
        from axial_vs_tpu_torch.config import load_config

        y = os.path.relpath(p, CONFIGS)
        if load_config(y).model.backbone.name.startswith(prefixes):
            out.append(y)
    return out


#: every yaml whose backbone is a Swin or an STDC net
BACKBONE_YAMLS = _yaml_names(("swin", "stdc"))


# ------------------------------------------------------------ window helpers --

@pytest.mark.parametrize("helper", ["window_partition", "window_reverse",
                                    "relative_position_index",
                                    "shifted_window_mask"])
def test_window_helpers(rng, helper):
    """Each helper equal to JAX's, bit for bit."""
    from axial_vs_tpu.models.backbones import swin as J
    from axial_vs_tpu_torch.models.backbones import swin as P

    if helper == "window_partition":
        x = rng.randn(2, 14, 21, 5).astype(np.float32)
        np.testing.assert_array_equal(P.window_partition(t(x), 7).numpy(),
                                      J.window_partition(jnp.asarray(x), 7))
    elif helper == "window_reverse":
        w = rng.randn(2 * 6, 49, 5).astype(np.float32)
        np.testing.assert_array_equal(
            P.window_reverse(t(w), 7, 14, 21).numpy(),
            J.window_reverse(jnp.asarray(w), 7, 14, 21))
    elif helper == "relative_position_index":
        for ws in (1, 5, 7, 12):
            np.testing.assert_array_equal(P.relative_position_index(ws),
                                          J.relative_position_index(ws))
    else:
        for h, w, ws, shift in ((14, 21, 7, 3), (12, 12, 12, 6),
                                (24, 36, 12, 6), (10, 15, 5, 2)):
            np.testing.assert_array_equal(
                P.shifted_window_mask(h, w, ws, shift),
                J.shifted_window_mask(h, w, ws, shift))


# ------------------------------------------------------------------- Swin ----

@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block(rng, shift):
    """One block, window 5, on 11x17 (padded to 15x20), unshifted and
    shifted by ws // 2: the pad after norm1, the roll and the region mask
    at the padded size."""
    from axial_vs_tpu.models.backbones.swin import SwinBlock as J
    from axial_vs_tpu_torch.models.backbones.swin import SwinBlock

    x = rng.randn(2, 11, 17, 32).astype(np.float32)
    jm = J(dim=32, num_heads=4, window_size=5, shift=shift)
    v = jax_init(jm, jnp.asarray(x))
    want = jax_apply(jm, v, jnp.asarray(x))
    model = port(SwinBlock(32, 4, 5, shift=shift), convert.swin_block(
        v["params"]))
    with torch.no_grad():
        within(model(t(x)), want, TOL)


def _swin_pair(seed=0):
    from axial_vs_tpu.models.backbones.swin import SwinTransformer as J

    x = np.random.RandomState(seed).randn(2, *SWIN_HW, 3).astype(np.float32)
    jm = J(**SWIN, drop_path_rate=0.0)
    return jm, jax_init(jm, jnp.asarray(x), seed=seed), x


def _port_swin(v):
    from axial_vs_tpu_torch.models.backbones.swin import SwinTransformer

    return port(SwinTransformer(**SWIN, drop_path_rate=0.0),
                convert.swin(v["params"]))


def test_swin_transformer(rng):
    """The whole small Swin on 61x67: all four outputs; and a round trip of
    the port's state_dict through the JAX package's ``convert_swin`` and
    ``convert.swin``."""
    from axial_vs_tpu.utils.torch_convert import convert_swin

    jm, v, x = _swin_pair()
    want = jax_apply(jm, v, jnp.asarray(x))
    model = _port_swin(v)
    with torch.no_grad():
        got = model(t(x))
    assert [want[k].shape for k in sorted(want)] == [
        (2, 16, 17, 32), (2, 8, 9, 64), (2, 4, 5, 128), (2, 2, 3, 256)]
    for k in want:
        within(got[k], want[k], TOL)
    sd = {k: a.numpy() for k, a in model.state_dict().items()}
    back = convert.swin(convert_swin(sd, SWIN["depths"]))
    assert sorted(back) == sorted(sd)
    for k, a in sd.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_swin_bf16(seed):
    """The small Swin in bf16 (f32 weights cast at use, bf16 input) against
    JAX's ``SwinTransformer(dtype=bfloat16)``, within the module's bf16
    bounds."""
    from axial_vs_tpu.models.backbones.swin import SwinTransformer as J

    jm, v, x = _swin_pair(seed)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jax_apply(jm, v, xb.astype(jnp.float32))
    want = jax_apply(J(**SWIN, drop_path_rate=0.0, dtype=jnp.bfloat16), v, xb)
    with torch.no_grad():
        got = _port_swin(v)(t(np.asarray(xb.astype(jnp.float32))).to(
            torch.bfloat16))
    for k in want:
        assert got[k].dtype == torch.bfloat16 and want[k].dtype == jnp.bfloat16
        w = np.asarray(want[k], np.float32)
        own = float(np.abs(w - ref[k]).max())
        assert 0 < own
        g = got[k].float().numpy()
        assert np.abs(g - w).max() <= BF16_VS_JAX * own, k
        assert np.abs(g - ref[k]).max() <= BF16_VS_F32 * own, k


def _grads_against_jax(jm, v, model, x, seed, mutable=False):
    """Each parameter's gradient of sum(out * cotangent) over the outputs,
    the port's against ``jax.grad``'s, carried by the same converter."""
    rs = np.random.RandomState(seed)
    v = jax.tree.map(jnp.asarray, v)
    shapes = jax.eval_shape(lambda: jm.apply(
        v, jnp.asarray(x), train=True,
        **({"mutable": ["batch_stats"]} if mutable else {})))
    outs = shapes[0] if mutable else shapes
    cot = {k: rs.randn(*s.shape).astype(np.float32) for k, s in outs.items()}

    def loss(params):
        out = jm.apply({**v, "params": params}, jnp.asarray(x), train=True,
                       **({"mutable": ["batch_stats"]} if mutable else {}))
        out = out[0] if mutable else out
        return sum(jnp.sum(out[k] * cot[k]) for k in cot)

    grads = jax.jit(jax.grad(loss))(v["params"])
    model.train()
    out = model(t(x))
    sum((out[k] * t(cot[k])).sum() for k in cot).backward()
    return jax.tree.map(np.asarray, grads)


def _check_grads(model, want_sd):
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        within(p.grad, want_sd[name], TOL_GRAD)


def test_swin_gradients():
    """The small Swin's parameter gradients in ``train()`` (drop path 0)
    against ``jax.grad`` of the JAX module's."""
    jm, v, x = _swin_pair(2)
    model = _port_swin(v)
    grads = _grads_against_jax(jm, v, model, x, seed=3)
    _check_grads(model, convert.swin(grads))


def test_swin_gradients_at_padded_patches():
    """The small Swin at JAX's own init (zero biases, as upstream's) on an
    input whose right half is zero, as a crop padded into the training
    size: JAX's largest gradient at least ``PAD_AMPLIFIED`` times its
    largest once the biases are drawn from N(0, 0.02^2); the port's
    gradients equal JAX's within ``TOL_GRAD`` in both cases."""
    from axial_vs_tpu.models.backbones.swin import SwinTransformer as J

    x = np.random.RandomState(7).randn(2, *SWIN_HW, 3).astype(np.float32)
    x[:, :, SWIN_HW[1] // 2:] = 0
    jm = J(**SWIN, drop_path_rate=0.0)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x), train=False))
    rs = np.random.RandomState(8)
    woken = jax.tree_util.tree_map_with_path(
        lambda path, a: (rs.randn(*a.shape) * 0.02).astype(np.float32)
        if getattr(path[-1], "key", None) == "bias" else a, v)
    largest = []
    for variables in (v, woken):
        model = _port_swin(variables)
        want = convert.swin(_grads_against_jax(jm, variables, model, x, 3))
        _check_grads(model, want)
        largest.append(max(float(np.abs(a).max()) for a in want.values()))
    assert np.isfinite(largest).all()
    assert largest[0] >= PAD_AMPLIFIED * largest[1], largest


# ------------------------------------------------------------------- STDC ----

def _stdc_pair(name, block_type, seed):
    from axial_vs_tpu.models.backbones.stdc import STDCNet as J
    from axial_vs_tpu_torch.models.backbones.stdc import STDC_LAYERS, STDCNet

    x = np.random.RandomState(seed).randn(2, 45, 61, 3).astype(np.float32)
    jm = J(base=16, layers=STDC_LAYERS[name], block_type=block_type)
    v = jax_init(jm, jnp.asarray(x), seed=seed, train=False)
    model = port(STDCNet(STDC_LAYERS[name], base=16, block_type=block_type),
                 convert.stdc(v["params"], v["batch_stats"]))
    return jm, v, model, x


def _conv64(x, kernel, stride, depthwise=False):
    """NHWC convolution in float64, padding kernel // 2 on each side."""
    p = kernel.shape[0] // 2
    x = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))
    win = sliding_window_view(x, kernel.shape[:2], axis=(1, 2))
    win = win[:, ::stride, ::stride]
    if depthwise:
        return np.einsum("nhwcij,ijc->nhwc", win, kernel[:, :, 0])
    return np.einsum("nhwcij,ijco->nhwo", win, kernel)


def _bn64(x, p):
    """Batch statistics, two-pass variance."""
    mean = x.mean((0, 1, 2))
    var = np.square(x - mean).mean((0, 1, 2))
    return (x - mean) / np.sqrt(var + 1e-5) * p["scale"] + p["bias"]


def _convx64(x, p, stride=1):
    return np.maximum(_bn64(_conv64(x, p["conv"]["kernel"], stride),
                            p["bn"]), 0)


def _dwnorm64(x, p):
    return _bn64(_conv64(x, p["conv"]["kernel"], 2, depthwise=True), p["bn"])


def _cat64(x, p, stride, block_num=4):
    out1 = y = _convx64(x, p["conv0"])
    outs = []
    for i in range(1, block_num):
        if i == 1 and stride == 2:
            y = _dwnorm64(y, p["avd"])
        y = _convx64(y, p[f"conv{i}"])
        outs.append(y)
    if stride == 2:  # 3x3/2 average pool, padding 1 counted
        pad = np.pad(out1, ((0, 0), (1, 1), (1, 1), (0, 0)))
        out1 = sliding_window_view(pad, (3, 3), axis=(1, 2))[
            :, ::2, ::2].mean((-2, -1))
    return np.concatenate([out1] + outs, -1)


def _add64(x, p, stride, block_num=4):
    outs, y = [], x
    for i in range(block_num):
        y = _convx64(y, p[f"conv{i}"])
        if i == 0 and stride == 2:
            y = _dwnorm64(y, p["avd"])
        outs.append(y)
    if stride == 2:
        x = _conv64(_dwnorm64(x, p["skip_dw"]), p["skip_pw"]["kernel"], 1)
        x = _bn64(x, p["skip_bn"])
    return np.concatenate(outs, -1) + x


def stdc64(params, x, layers, block_type):
    """JAX's ``STDCNet`` in ``train()`` as a float64 numpy pass over JAX's
    variables: the witness of the train-mode checks."""
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    block = _cat64 if block_type == "cat" else _add64
    x = _convx64(_convx64(x.astype(np.float64), p["stem0"], 2),
                 p["stem1"], 2)
    out = {"res2": x}
    for i, n in enumerate(layers):
        for j in range(n):
            x = block(x, p[f"stage{i}_block{j}"], 2 if j == 0 else 1)
        out[f"res{i + 3}"] = x
    return out


def _check_stdc_train(name, block_type, seed):
    """``train()`` on the batch statistics against JAX, with the witness
    ``stdc64`` for the outputs beyond ``TOL``; the running statistics
    that step leaves behind within ``TOL``. Returns the port's distance
    from the witness over JAX's, for each output."""
    from axial_vs_tpu_torch.models.backbones.stdc import STDC_LAYERS

    jm, v, model, x = _stdc_pair(name, block_type, seed)
    want, new = jax.tree.map(np.asarray, jax.jit(lambda vs, a: jm.apply(
        vs, a, train=True, mutable=["batch_stats"]))(
            jax.tree.map(jnp.asarray, v), jnp.asarray(x)))
    with torch.no_grad():
        got = model.train()(t(x))
    exact = stdc64(v["params"], x, STDC_LAYERS[name], block_type)
    sd = convert.stdc(v["params"], new["batch_stats"])
    for k, a in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            within(a, sd[k], TOL)
    assert sorted(got) == sorted(want) == ["res2", "res3", "res4", "res5"]
    ratios = {}
    for k in want:
        g, w, e = got[k].numpy(), want[k], exact[k]
        scale = TOL * float(np.abs(w).max())
        own = float(np.abs(w - e).max())
        assert own <= WITNESS * float(np.abs(e).max()), (k, own)
        mine = float(np.abs(g - e).max())
        assert mine <= max(scale, F64_SLACK * own), (k, mine, own)
        assert np.abs(g - w).max() <= max(scale, F64_TRIANGLE * own), k
        ratios[k] = mine / own
    return ratios


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("block_type", ["cat", "add"])
@pytest.mark.parametrize("name", ["stdc1", "stdc2"])
def test_stdc(name, block_type, mode):
    """STDC1 and STDC2 at base 16 with either block type on 45x61: in
    ``eval()`` on the drawn running statistics, in ``train()`` on the
    batch's, with the running statistics that step leaves behind."""
    if mode == "train":
        _check_stdc_train(name, block_type, seed=4)
        return
    jm, v, model, x = _stdc_pair(name, block_type, seed=4)
    want = jax_apply(jm, v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(t(x))
    assert sorted(got) == ["res2", "res3", "res4", "res5"]
    for k in want:
        within(got[k], want[k], TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("block_type", ["cat", "add"])
@pytest.mark.parametrize("name", ["stdc1", "stdc2"])
def test_stdc_train_seeds(name, block_type, seed):
    """The train-mode check of ``test_stdc`` at three more seeds."""
    _check_stdc_train(name, block_type, seed)


def test_stdc_gradients():
    """STDC2 (cat) at base 16 in ``train()``: every parameter's gradient
    against ``jax.grad``, through the batch statistics; and a round trip of
    the port's state_dict through ``convert_stdc`` and ``convert.stdc``."""
    from axial_vs_tpu.utils.torch_convert import convert_stdc
    from axial_vs_tpu_torch.models.backbones.stdc import STDC_LAYERS

    jm, v, model, x = _stdc_pair("stdc2", "cat", seed=5)
    sd = {k: a.numpy().copy() for k, a in model.state_dict().items()}
    params, stats = convert_stdc(sd, STDC_LAYERS["stdc2"])
    back = convert.stdc(params, stats)
    assert sorted(back) == sorted(sd)
    for k, a in sd.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    grads = _grads_against_jax(jm, v, model, x, seed=6, mutable=True)
    _check_grads(model, convert.stdc(grads, v["batch_stats"]))


# ------------------------------------------------------------ param rules ----

def _id_tree(params):
    """Each leaf of a flax tree replaced by a float64 array of its shape
    holding the leaf's index, and the index -> '/'-joined path."""
    flat = traverse_util.flatten_dict(params, sep="/")
    paths = sorted(flat)
    ids = {p: np.full(flat[p].shape, i, np.float64)
           for i, p in enumerate(paths)}
    return traverse_util.unflatten_dict(ids, sep="/"), paths


@pytest.mark.parametrize("yaml", ["ytvis21/tube_link_maxtron_wc_swin_l.yaml",
                                  "vipseg/tube_link_vps_stdc2.yaml"])
def test_backbone_param_rules_match_jax(yaml):
    """Every backbone parameter gets the (lr_mult, wd) that JAX's rules give
    the flax path ``utils/convert.py`` carries into it: the Swin's bias
    table and norms, the STDC's BatchNorms (whose JAX name ``bn`` holds no
    "norm", so their scales decay as JAX's do)."""
    from axial_vs_tpu.config import get_default_config as jax_defaults
    from axial_vs_tpu.engine.optim import param_rules as jax_rules
    from axial_vs_tpu.models.kmax import build_backbone as jax_backbone
    from axial_vs_tpu_torch.config import CONFIGS_DIR, load_config
    from axial_vs_tpu_torch.engine.optim import param_rules
    from axial_vs_tpu_torch.models.kmax import build_backbone

    opts = (["model.backbone.swin.embed_dim", 32,
             "model.backbone.swin.depths", [2, 2, 2, 2],
             "model.backbone.swin.num_heads", [1, 2, 4, 8]]
            if "swin" in yaml else [])
    jcfg = jax_defaults().merge_from_file(str(CONFIGS_DIR / yaml))
    jcfg.merge_from_list(list(opts))
    cfg = load_config(yaml, opts)
    jm = jax_backbone(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    ids, paths = _id_tree(shapes["params"])
    stats = jax.tree.map(lambda s: np.zeros(s.shape),
                         shapes.get("batch_stats", {}))
    sd = convert.backbone(ids, stats)
    model, _ = build_backbone(cfg, device=torch.device("meta"))
    want, got = jax_rules(cfg), param_rules(cfg)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(paths)
    assert any("relative_position_bias_table" in n or ".bn." in n
               for n in names)
    for name in names:
        (i,) = np.unique(sd[name])
        path = "backbone/" + paths[int(i)]
        assert got("backbone." + name) == pytest.approx(want(path)), (name,
                                                                       path)


# ---------------------------------------------------- yamls: shapes, builds --

_JAX_SHAPES = {}


def _jax_backbone_shapes(yaml):
    """{port key: shape} of JAX's backbone for ``yaml``, from
    ``jax.eval_shape`` of its init at 64x64 carried by the converter (on
    zero-stride views: nothing the size of Swin-L is allocated)."""
    from axial_vs_tpu.config import get_default_config as jax_defaults
    from axial_vs_tpu.models.kmax import build_backbone as jax_backbone
    from axial_vs_tpu_torch.config import CONFIGS_DIR

    cfg = jax_defaults().merge_from_file(str(CONFIGS_DIR / yaml))
    key = repr(cfg.model.backbone.to_dict())
    if key not in _JAX_SHAPES:
        jm = jax_backbone(cfg)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
        views = jax.tree.map(
            lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
        sd = convert.backbone(views["params"], views.get("batch_stats", {}))
        _JAX_SHAPES[key] = {k: tuple(np.shape(a)) for k, a in sd.items()}
    return _JAX_SHAPES[key]


@pytest.mark.parametrize("yaml", BACKBONE_YAMLS)
def test_backbone_shapes_match_jax(yaml):
    """The port's backbone for each Swin or STDC yaml, built on the meta
    device at full width, has JAX's parameters and statistics, shape for
    shape, under the converter's names; its channels are JAX's outputs'."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.models.kmax import build_backbone

    cfg = load_config(yaml)
    model, channels = build_backbone(cfg, device=torch.device("meta"))
    got = {k: tuple(a.shape) for k, a in model.state_dict().items()}
    assert got == _jax_backbone_shapes(yaml)
    norms = {f"res{i + 2}": got.get(f"norm{i}.weight") for i in range(4)}
    if cfg.model.backbone.name.startswith("swin"):
        assert channels == {k: s[0] for k, s in norms.items()}
    else:
        assert channels == {"res2": 64, "res3": 256, "res4": 512,
                            "res5": 1024}


#: the Tube-Link family's yamls with a Swin or STDC backbone (the image
#: kMaX yaml is ``test_torch_image.py``'s)
TUBE_LINK_YAMLS = [y for y in BACKBONE_YAMLS if not y.startswith("coco/")]
SMALL_SWIN = ["model.backbone.swin.embed_dim", 32,
              "model.backbone.swin.depths", [2, 2, 2, 2],
              "model.backbone.swin.num_heads", [1, 2, 4, 8]]
SMALL_HEAD = ["model.tube_link.num_queries", 8,
              "model.tube_link.feat_channels", 32,
              "model.tube_link.out_channels", 32,
              "model.tube_link.num_decoder_layers", 1,
              "model.maxtron.cc.num_layers", 1]


@pytest.mark.parametrize("yaml", TUBE_LINK_YAMLS)
def test_tube_link_yamls_build_and_run(yaml):
    """``build_model_and_criterion`` builds each yaml for inference (its
    Swin cut to 32 channels and two blocks a stage at the yaml's window,
    an STDC at full width; the heads at 8 queries), in the yaml's dtype,
    and one forward of one 64x64 clip gives finite outputs of the
    architecture's shapes."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.models.build import build_model_and_criterion

    cfg = load_config(yaml)
    opts = SMALL_HEAD + (SMALL_SWIN if cfg.model.backbone.name.startswith(
        "swin") else [])
    cfg = load_config(yaml, opts)
    arch, frames = cfg.model.meta_architecture, cfg.input.num_clip_frames
    model, _ = build_model_and_criterion(
        cfg, train=False, device=torch.device("cpu"),
        generator=torch.Generator().manual_seed(0))
    dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else torch.float32
    assert {p.dtype for p in model.backbone.parameters() if p.ndim >= 2} == {
        dtype}
    x = torch.randn(1 if arch == "ImageMask2Former" else frames, 64, 64, 3)
    with torch.no_grad():
        out = model(x)
    masks, logits = out["mask_preds"][-1], out["cls_preds"][-1]
    assert masks.shape[-2:] == (16, 16) and logits.shape[0] == 1
    assert torch.isfinite(masks.float()).all()
    assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("yaml", ["ytvis21/tube_link_maxtron_wc_swin_l.yaml",
                                  "vipseg/tube_link_vps_swin_b.yaml"])
def test_tube_link_trains_in_f32(yaml):
    """A bf16 Tube-Link yaml built for training has only f32 parameters and
    computes in f32, as JAX's registry builds it; built for inference it
    keeps its matrices bf16 at rest."""
    from axial_vs_tpu_torch.config import load_config
    from axial_vs_tpu_torch.models.build import build_model_and_criterion

    cfg = load_config(yaml, SMALL_HEAD + SMALL_SWIN)
    assert cfg.model.dtype == "bfloat16"
    kw = dict(device=torch.device("cpu"),
              generator=torch.Generator().manual_seed(0))
    model, _ = build_model_and_criterion(cfg, train=True, **kw)
    assert model.training and model.dtype is None
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert cfg.model.dtype == "bfloat16"  # the caller's config is untouched
    model, _ = build_model_and_criterion(cfg, train=False, **kw)
    assert not model.training and model.dtype == torch.bfloat16
    matrices = {p.dtype for p in model.parameters() if p.ndim >= 2}
    assert matrices == {torch.bfloat16}
