"""Linear assignment for Hungarian matching (counterpart of
``axial_vs_tpu/ops/hungarian.py``): the exact host path and the on-device
auction.

``exact=True``: the cost matrix goes to the host once per call and scipy's
``linear_sum_assignment`` solves each sample, as the reference does
(`kmax_deeplab/modeling/matcher.py:91`).

``exact=False``: the JAX package's on-device auction (``_auction_assign``),
op for op, so that the same inputs give the same assignment. It runs in
plain torch ops on the cost's device (the JAX package runs it as XLA, not as
a Pallas kernel), with every loop on the device and no host read: a forward
auction of the GT columns for the query rows at a fixed eps for
``max(256, 16 m)`` rounds (prices carried), the auction's rows scattered
into columns (one write per row, the last row's write winning where two
write one column, as XLA's serial scatter does), a greedy fill of each
column still unassigned with its cheapest unused row, and ``2 m`` rounds of
local refinement, each taking the better of the best pairwise swap and the
best move of a column to an unused row.
"""
from __future__ import annotations

import numpy as np
import torch

_BIG = 1e9
#: the profiler range around each assignment (``hungarian_assign``)
MATCHING_RANGE = "matching"
#: the auction's eps, and the refinement's least gain
AUCTION_EPS = 2e-4
_MIN_GAIN = -1e-6


def lsap_host(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """cost (B, N, M), valid (B, M) -> (B, M) int64: the query row of each
    valid GT column, -1 for an invalid one."""
    from scipy.optimize import linear_sum_assignment

    b, n, m = cost.shape
    out = np.full((b, m), -1, np.int64)
    for i in range(b):
        cols = np.flatnonzero(valid[i])
        if cols.size == 0:
            continue
        row_ind, col_ind = linear_sum_assignment(cost[i][:, cols])
        out[i, cols[col_ind]] = row_ind
    return out


def hungarian_assign(cost: torch.Tensor, valid: torch.Tensor,
                     exact: bool = True) -> torch.Tensor:
    """Assign each valid GT column one query row, minimizing the total cost.

    cost (B, N, M) rows = queries, columns = GT slots; valid (B, M) bool.
    Returns (B, M) int64 on cost's device: the query of each GT column (-1
    where invalid). ``exact`` solves on the host (scipy), otherwise the
    auction runs on cost's device. Runs in the profiler range
    ``MATCHING_RANGE``."""
    cost = cost.detach().float()
    with torch.profiler.record_function(MATCHING_RANGE):
        if exact:
            out = lsap_host(cost.cpu().numpy(), valid.detach().cpu().numpy())
            return torch.from_numpy(out).to(cost.device)
        return auction_assign(cost, valid.detach())


def _scatter_true(index, size):
    """(B, size) bool, True at each (b, index[b, i]) with 0 <= index < size
    (an index of ``size`` is dropped)."""
    b = index.shape[0]
    out = torch.zeros(b, size + 1, dtype=torch.bool, device=index.device)
    return out.scatter_(1, index, True)[:, :size]


@torch.no_grad()
def auction_assign(cost, valid):
    """The JAX package's ``_auction_assign`` on cost's device: cost (B, N,
    M) f32, valid (B, M) bool -> (B, M) int64 (module docstring)."""
    b, n, m = cost.shape
    dev = cost.device
    bi = torch.arange(b, device=dev)
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    benefit = -torch.where(valid[:, None, :], cost,
                           torch.full_like(cost, _BIG))
    eps_t = torch.full((b, 1), AUCTION_EPS, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(-float("inf"), device=dev)
    prices = torch.zeros(b, n, device=dev)
    owner = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    for _ in range(max(256, 16 * m)):
        owned = _scatter_true(torch.where(owner >= 0, owner, m), m)
        unassigned = valid & ~owned
        value = benefit - prices[:, :, None]
        best = value.argmax(1)
        best_val = value.amax(1)
        second_val = value.topk(2, 1).values[:, 1] if n > 1 else best_val
        bid = best_val - second_val + eps_t
        bid_masked = torch.where(unassigned, bid, neg_inf)
        row_bid = torch.full((b, n), -float("inf"), device=dev).scatter_reduce(
            1, best, bid_masked, reduce="amax")
        winner_col = torch.where(
            (best[:, None, :] == rows[None, :, None]) & unassigned[:, None, :],
            bid[:, None, :], neg_inf).argmax(2)
        row_has_bid = torch.isfinite(row_bid)
        prices = torch.where(row_has_bid, prices + row_bid.clamp_min(0.0),
                             prices)
        owner = torch.where(row_has_bid, winner_col, owner)
    # each row writes into its column (an unowned row writes -1 into
    # column 0); where several write one column, the last row wins
    has = owner >= 0
    writes = owner.clamp_min(0)[:, :, None] == cols[None, None, :]
    last = torch.where(writes, rows[None, :, None], -1).amax(1)  # (B, M)
    out = torch.where(
        (last >= 0) & has.gather(1, last.clamp_min(0)), last, -1)
    out = torch.where(valid, out, -1)

    # fill: each leftover column takes its cheapest unused row
    used = _scatter_true(torch.where(out >= 0, out, n), n)
    for j in range(m):
        c = torch.where(used, _BIG, cost[:, :, j])
        pick = c.argmin(1)
        need = (out[:, j] < 0) & valid[:, j]
        out[:, j] = torch.where(need, pick, out[:, j])
        used[bi, pick] = used[bi, pick] | need
    out = torch.where(valid, out, -1)

    # local refinement: 2m rounds of the best swap or move to an unused row
    inf = torch.tensor(float("inf"), device=dev)
    for _ in range(2 * m):
        safe = out.clamp_min(0)
        assigned = valid & (out >= 0)
        cr = cost.gather(1, safe[:, :, None].expand(b, m, m))  # (B, M, M)
        diag = cr.diagonal(dim1=1, dim2=2)
        delta = (cr.transpose(1, 2) + cr - diag[:, :, None]
                 - diag[:, None, :])
        ok = assigned[:, :, None] & assigned[:, None, :]
        delta = torch.where(ok, delta, inf).reshape(b, -1)
        sbest = delta.argmin(1)
        sgain = delta.gather(1, sbest[:, None])[:, 0]
        used = _scatter_true(torch.where(assigned, safe, n), n)
        cands = torch.where(used[:, :, None], _BIG, cost)
        rbest = cands.argmin(1)
        rgain = torch.where(assigned, cands.amin(1) - diag, inf)
        jbest = rgain.argmin(1)
        rgain_best = rgain.gather(1, jbest[:, None])[:, 0]
        do_swap = (sgain < rgain_best) & (sgain < _MIN_GAIN)
        do_repl = ~do_swap & (rgain_best < _MIN_GAIN)
        jj, kk = sbest // m, sbest % m
        rj, rk = out[bi, jj], out[bi, kk]
        out[bi, jj] = torch.where(do_swap, rk, out[bi, jj])
        out[bi, kk] = torch.where(do_swap, rj, out[bi, kk])
        out[bi, jbest] = torch.where(do_repl, rbest[bi, jbest], out[bi, jbest])
    return torch.where(valid, out, -1)
