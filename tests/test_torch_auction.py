"""The port's on-device auction LAP (``axial_vs_tpu_torch/ops/hungarian.py``,
``exact=False``) against the JAX package's ``_auction_assign``, on the CPU.

The same cost matrices and validity masks, drawn from a seed with numpy,
must give the same assignment on both sides, element for element (the
port replays JAX's operations in f32), and both must lie within the JAX
test's optimality bound of scipy's optimum (``tests/test_hungarian.py``:
an assignment that uses every valid column once, with a gap to the optimum
of at most ``GAP_BOUND`` relative). Each JAX shape is compiled once per
module and reused.
"""
import functools

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

#: each problem: (B, N, M) of its batch, as the criterion calls the matcher
SHAPE = (4, 32, 8)
#: the training step's problem on the card: one clip, 128 queries, 24 GT
STEP_SHAPE = (1, 128, 24)
#: the JAX test's per-problem bound on the auction's gap to the optimum,
#: relative to max(|optimum|, 1) (its adversarial bound is m * 1e-3)
GAP_BOUND = 8e-3


@functools.lru_cache(maxsize=None)
def _jax_auction(shape):
    import jax

    from axial_vs_tpu.ops.hungarian import _auction_assign

    del shape  # one compile per shape, kept for the module
    return jax.jit(_auction_assign)


def _problem(seed, shape=SHAPE):
    rs = np.random.RandomState(seed)
    b, n, m = shape
    cost = rs.randn(b, n, m).astype(np.float32)
    if seed % 3 == 1:  # the matcher's range: -(dice x probability)
        cost = -(rs.rand(b, n, m) * rs.rand(b, n, m)).astype(np.float32)
    if seed % 3 == 2:  # coarse values, many ties
        cost = (np.round(cost * 2) / 2).astype(np.float32)
    valid = rs.rand(b, m) > 0.3
    valid[:, 0] = True
    valid[-1] = False  # a sample without GT
    return cost, valid


def _check_matching(cost, valid, assign):
    """The assignment's total cost per sample; every valid column takes one
    row, no row twice, invalid columns -1."""
    totals = []
    for i in range(cost.shape[0]):
        cols = np.flatnonzero(valid[i])
        rows = assign[i, cols]
        assert (assign[i, ~valid[i]] == -1).all()
        assert (rows >= 0).all() and len(set(rows.tolist())) == len(rows)
        totals.append(float(cost[i][rows, cols].sum()))
    return np.array(totals)


def _optimum(cost, valid):
    out = []
    for i in range(cost.shape[0]):
        cols = np.flatnonzero(valid[i])
        r, c = linear_sum_assignment(cost[i][:, cols]) if cols.size else ([], [])
        out.append(float(cost[i][r, cols[c]].sum()) if cols.size else 0.0)
    return np.array(out)


def _both(cost, valid):
    import jax.numpy as jnp

    from axial_vs_tpu_torch.ops.hungarian import hungarian_assign

    want = np.asarray(_jax_auction(cost.shape)(jnp.asarray(cost),
                                               jnp.asarray(valid)))
    got = hungarian_assign(torch.from_numpy(cost), torch.from_numpy(valid),
                           exact=False)
    assert got.dtype == torch.int64
    return got.numpy(), want


@pytest.mark.parametrize("seed", range(20))
def test_auction_matches_jax(seed):
    cost, valid = _problem(seed)
    got, want = _both(cost, valid)
    np.testing.assert_array_equal(got, want)
    best = _optimum(cost, valid)
    for assign in (got, want):
        gap = _check_matching(cost, valid, assign) - best
        assert (gap > -1e-4).all()
        assert (gap <= GAP_BOUND * np.maximum(np.abs(best), 1.0)).all(), gap


@pytest.mark.parametrize("seed", range(3))
def test_auction_matches_jax_at_the_step_shape(seed):
    """The shape of the ConvNeXt-L training step's matching (one clip, 128
    queries, 24 valid GT columns), costs in the matcher's range: the same
    assignment as JAX, one-to-one, within ``GAP_BOUND`` of the optimum."""
    rs = np.random.RandomState(100 + seed)
    cost = -(rs.rand(*STEP_SHAPE) * rs.rand(*STEP_SHAPE)).astype(np.float32)
    valid = np.ones(STEP_SHAPE[::2], bool)
    got, want = _both(cost, valid)
    np.testing.assert_array_equal(got, want)
    best = _optimum(cost, valid)
    gap = _check_matching(cost, valid, got) - best
    assert (gap > -1e-4).all()
    assert (gap <= GAP_BOUND * np.maximum(np.abs(best), 1.0)).all(), gap


def test_auction_on_adversarial_costs():
    """The JAX test's adversarial cases (all tied, duplicated columns,
    near-ties, a 1e-7 ladder): the same assignment as JAX, within its bound
    of m * 1e-3 of the optimum."""
    rs = np.random.RandomState(0)
    n, m = 16, 6
    near = np.round(rs.randn(n, m) * 2) / 2 + rs.randn(n, m) * 1e-6
    cost = np.stack([np.zeros((n, m)),
                     rs.randn(n, 1) @ np.ones((1, m)), near,
                     np.arange(n * m).reshape(n, m) * 1e-7]).astype(np.float32)
    valid = np.ones((4, m), bool)
    got, want = _both(cost, valid)
    np.testing.assert_array_equal(got, want)
    gap = _check_matching(cost, valid, got) - _optimum(cost, valid)
    assert (gap <= m * 1e-3 + 1e-5).all(), gap


def test_matcher_and_criterion_on_the_auction():
    """``hungarian_match(exact=False)`` and ``SetCriterion(exact_matching=
    False)`` against JAX's on the same outputs: the same assignment, the
    same losses (to ``TOL_TERM`` of ``tests/test_torch_train.py``)."""
    from axial_vs_tpu.losses.criterion import SetCriterion as J
    from axial_vs_tpu.losses.matcher import hungarian_match as jmatch
    from axial_vs_tpu_torch.losses.criterion import SetCriterion
    from axial_vs_tpu_torch.losses.matcher import hungarian_match
    from test_torch_train import (TOL_TERM, _outputs, _targets, _to_jax,
                                  _to_torch)
    import jax

    rng = np.random.RandomState(2)
    out, tg = _outputs(rng), _targets(rng)
    want = jmatch(_to_jax(out), _to_jax(tg), exact=False)
    got = hungarian_match(_to_torch(out), _to_torch(tg), exact=False)
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    s = 2 * 2 * 6 * 7  # every pixel sampled: the losses do not depend on draws
    kw = dict(pixel_insdis_sample_k=s, aux_semantic_sample_k=s,
              exact_matching=False)
    jl = J(6, **kw)(jax.random.PRNGKey(0), _to_jax(out), _to_jax(tg))
    tl = SetCriterion(6, **kw)(_to_torch(out), _to_torch(tg),
                               torch.Generator().manual_seed(0))
    assert sorted(jl) == sorted(tl)
    for k in jl:
        w = float(jl[k])
        assert abs(float(tl[k]) - w) <= TOL_TERM * max(abs(w), 1e-6), k
