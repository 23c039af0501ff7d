"""The ConvNeXt block's training route against JAX's gradients.

In training mode the port's ``ConvNeXtBlock`` runs its own modules
(``conv_dw``, ``norm``, ``mlp``, ``gamma``) as plain, differentiable torch
ops, on every ``block_kernel`` route, as the JAX block trains through XLA
(``axial_vs_tpu/models/backbones/convnext.py``, ``not train``): the kernels
have no backward. A train-mode block at C = 32 in f32 against ``jax.grad``
of the JAX block with ``train=True``, on the same parameters, input and
cotangent drawn with numpy from a seed: the output, the input's gradient and
every parameter's gradient. The JAX gradients are computed once for the
module.

Tolerance: both sides compute the same f32 function and sum in other
orders, so each result agrees to ``TOL`` = 1e-5 of its scale, as
``test_torch_parity.py``'s ``TOL_MODULE``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axial_vs_tpu_torch.utils import convert
from test_torch_parity import torch_threads  # noqa: F401 (autouse)

TOL = 1e-5
SHAPE = (2, 9, 13, 32)


def _close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


@pytest.fixture(scope="module")
def jax_block():
    """(params, x, cotangent, JAX output, d/dparams, d/dx) of one train-mode
    JAX block; the parameters are N(0, 0.1^2), LayerNorm's scale 1 + that,
    so that every branch carries weight (the upstream 1e-6 gamma would
    not)."""
    from axial_vs_tpu.models.backbones.convnext import ConvNeXtBlock as J

    rng = np.random.RandomState(0)
    x = rng.randn(*SHAPE).astype(np.float32)
    cot = rng.randn(*SHAPE).astype(np.float32)
    jm = J(dim=SHAPE[-1])
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True))
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: ((1.0 if str(getattr(path[-1], "key", "")) == "scale"
                          else 0.0) + 0.1 * rng.randn(*s.shape)
                         ).astype(np.float32),
        shapes["params"])

    def loss(p, xx):
        y = jm.apply({"params": p}, xx, train=True)
        return jnp.sum(y * jnp.asarray(cot)), y

    (_, y), (dp, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return params, x, cot, np.asarray(y), to_np(dp), np.asarray(dx)


@pytest.mark.parametrize("route", ["dwln", "mlp", "block"])
def test_train_mode_block_gradients_match_jax(jax_block, route):
    from axial_vs_tpu_torch.models.backbones.convnext import ConvNeXtBlock

    params, x, cot, want_y, want_dp, want_dx = jax_block
    model = convert.load_into(ConvNeXtBlock(SHAPE[-1], block_kernel=route),
                              convert.convnext_block(params)).train()
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y = model(xt)
    assert y.grad_fn is not None
    (y * torch.from_numpy(cot)).sum().backward()
    _close(y, want_y)
    _close(xt.grad, want_dx)
    # the converter is linear (transposes and reshapes), so it maps JAX's
    # parameter gradients onto the port's state_dict names and layouts
    want = convert.convnext_block(want_dp)
    grads = dict(model.named_parameters())
    assert set(grads) == set(want)
    for name, p in grads.items():
        assert p.grad is not None, name
        _close(p.grad, want[name])


def test_refuse_grad():
    """``native.refuse_grad``, which every kernel wrapper calls before a
    launch on the card: it raises while grad mode is on and an argument
    requires grad, and passes under ``inference_mode``/``no_grad``."""
    from axial_vs_tpu_torch.ops.native import refuse_grad

    leaf = torch.ones(3, requires_grad=True)
    plain = torch.ones(3)
    refuse_grad(plain, [leaf], 1.0)  # only tensor arguments count
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad(plain, leaf)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad(leaf * 2)
    with torch.no_grad():
        refuse_grad(plain, leaf)
    with torch.inference_mode():
        refuse_grad(plain, leaf)
