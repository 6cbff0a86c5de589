"""Saliency helpers for the DST update (port of ``repro/core/saliency.py``).

Counts like "top K" with a K held in a tensor are realized by rank
comparisons (a stable argsort, then a scatter of the ranks), so
selected-set sizes are exact even with ties, and nothing waits for the
device. Every float operation is float32, in the reference's order, so
the selections equal the reference's on the same inputs.
"""
from __future__ import annotations

import torch

NEG = float("-inf")


def descending_ranks(x: torch.Tensor, axis: int | None = None) -> torch.Tensor:
    """Rank of each element in descending order along ``axis`` (0 = largest);
    ties keep their index order. ``axis=None`` ranks the flattened tensor."""
    if axis is None:
        flat = x.reshape(-1)
        order = torch.argsort(-flat, stable=True)
        ranks = torch.empty_like(order)
        ranks[order] = torch.arange(flat.numel(), device=x.device)
        return ranks.reshape(x.shape)
    axis = axis % x.ndim
    order = torch.argsort(-x, dim=axis, stable=True)
    shape = [-1 if i == axis else 1 for i in range(x.ndim)]
    ar = torch.arange(x.shape[axis], device=x.device).reshape(shape).expand(x.shape)
    return torch.empty_like(order).scatter_(axis, order, ar)


def prune_survivors(weight: torch.Tensor, mask: torch.Tensor, n_prune) -> torch.Tensor:
    """Layer-wise magnitude prune: drop the ``n_prune`` smallest-|w| active
    weights of the (d_in, d_out) layer. Returns the survivor mask.

    The ranks run over the flattened layer (row-major, so ties fall as in
    the reference), inactive positions at -inf; ``n_prune`` may be a tensor.
    """
    mag = torch.where(mask, weight.abs(), torch.full((), NEG, dtype=weight.dtype,
                                                     device=weight.device))
    ranks = descending_ranks(mag)  # active weights occupy ranks [0, A)
    return mask & (ranks < (mask.sum() - n_prune))


def top_k_candidates(score: torch.Tensor, candidates: torch.Tensor, n_grow) -> torch.Tensor:
    """Layer-wise top-``n_grow`` of ``score`` among ``candidates`` (bool),
    ranked over the flattened layer as ``prune_survivors`` ranks."""
    s = torch.where(candidates, score, torch.full((), NEG, dtype=score.dtype,
                                                  device=score.device))
    return candidates & (descending_ranks(s) < n_grow)


def topk_threshold(values: torch.Tensor, candidates: torch.Tensor, k: torch.Tensor,
                   iters: int = 30) -> torch.Tensor:
    """Scalar threshold t with count(values > t & candidates) ~= k.

    A 30-step float32 bisection over [0, max + 1e-6] using compares and
    sums only; realized counts match k up to 2^-iters of the value range.
    ``k`` may be a tensor (no host sync).
    """
    f32 = values.dtype
    vmax = torch.amax(torch.where(candidates, values, torch.zeros((), dtype=f32,
                                                                   device=values.device)))
    lo = torch.zeros((), dtype=f32, device=values.device)
    hi = vmax + torch.tensor(1e-6, dtype=f32, device=values.device)
    half = torch.tensor(0.5, dtype=f32, device=values.device)
    for _ in range(iters):
        mid = half * (lo + hi)
        c = ((values > mid) & candidates).sum()
        more = c > k
        lo, hi = torch.where(more, mid, lo), torch.where(more, hi, mid)
    return lo


def select_topk_threshold(values: torch.Tensor, candidates: torch.Tensor, k,
                          iters: int = 30) -> torch.Tensor:
    """Bool mask of the ~k largest ``values`` among ``candidates`` (thresholded)."""
    t = topk_threshold(values, candidates, k, iters)
    return candidates & (values > t)


def normalized(x: torch.Tensor, where: torch.Tensor | None = None) -> torch.Tensor:
    """|x| scaled into [0, 1] (by the max over ``where`` if given)."""
    a = x.abs()
    if where is not None:
        m = torch.amax(torch.where(where, a, torch.zeros((), dtype=a.dtype, device=a.device)))
    else:
        m = torch.amax(a)
    return a / (m + torch.tensor(1e-12, dtype=a.dtype, device=a.device))
