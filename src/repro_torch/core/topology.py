"""Sparse-topology utilities: mask initialization, condensed<->dense conversion.

Port of ``repro/core/topology.py``; see its module docstring for the
conventions. A sparse linear computes ``y = x @ W`` with ``W`` of shape
``(d_in, d_out)``; constant fan-in means every column (output neuron) has
exactly ``k`` non-zeros. The condensed representation stores

  values  : (d_out, k)  — the non-zero weights of each neuron
  indices : (d_out, k)  — the input-feature index of each non-zero (int32)

Padding slots (columns with fewer than k non-zeros, including fully ablated
neurons) carry value 0 and an index pointing at an INACTIVE row of that
column, so re-gathering ``w * mask`` at the stored indices reproduces 0
there. Every function here takes leading (stack) dims before the last two
axes, where the reference vmaps over them.
"""
from __future__ import annotations

import numpy as np
import torch


def random_constant_fan_in_mask(generator: torch.Generator, d_in: int, d_out: int,
                                k: int, *, lead: tuple[int, ...] = ()) -> torch.Tensor:
    """Boolean mask (*lead, d_in, d_out) with exactly k True per column.

    Each column keeps the rows of its k largest uniform scores drawn from
    ``generator`` (on the generator's device), so the result is reproducible
    from one seed.
    """
    if not 1 <= k <= d_in:
        raise ValueError(f"fan-in k={k} must be in [1, {d_in}]")
    scores = torch.rand((*lead, d_in, d_out), generator=generator,
                        device=generator.device)
    top = torch.topk(scores, k, dim=-2).indices
    mask = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    return mask.scatter_(-2, top, True)


def random_unstructured_mask(generator: torch.Generator, d_in: int, d_out: int,
                             nnz: int, *, lead: tuple[int, ...] = ()) -> torch.Tensor:
    """Boolean mask (*lead, d_in, d_out) with exactly nnz True per layer,
    uniform over the layer's matrix (the RigL and SET initialization).

    Each layer keeps the positions of its nnz largest uniform scores drawn
    from ``generator`` on its device.
    """
    total = d_in * d_out
    if not 0 <= nnz <= total:
        raise ValueError(f"nnz={nnz} out of range [0, {total}]")
    scores = torch.rand((*lead, total), generator=generator, device=generator.device)
    top = torch.topk(scores, nnz, dim=-1).indices
    mask = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    return mask.scatter_(-1, top, True).reshape(*lead, d_in, d_out)


def random_nm_mask(generator: torch.Generator, d_in: int, d_out: int, n: int, m: int, *,
                   lead: tuple[int, ...] = ()) -> torch.Tensor:
    """Classic N:M mask (*lead, d_in, d_out): N non-zeros in every M
    *contiguous* fan-in weights of each column.

    Constant fan-in (the paper's structure) is the special case M = d_in;
    this covers the hardware 2:4 style patterns the paper relates to (Sec. 2,
    Mishra et al. 2021) for comparison studies.
    """
    if d_in % m:
        raise ValueError(f"d_in={d_in} not divisible by M={m}")
    if not 1 <= n <= m:
        raise ValueError(f"need 1 <= N <= M, got {n}:{m}")
    scores = torch.rand((*lead, d_in // m, m, d_out), generator=generator,
                        device=generator.device)
    top = torch.topk(scores, n, dim=-2).indices
    mask = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    return mask.scatter_(-2, top, True).reshape(*lead, d_in, d_out)


def check_nm(mask, n: int, m: int) -> bool:
    """True iff every contiguous M-group along fan-in has exactly N non-zeros
    (of every layer of a stacked mask)."""
    a = np.asarray(torch.as_tensor(mask).cpu())
    groups = a.reshape(*a.shape[:-2], a.shape[-2] // m, m, a.shape[-1]).sum(axis=-2)
    return bool(np.all(groups == n))


def dense_to_condensed(weight: torch.Tensor, mask: torch.Tensor, k: int):
    """Masked dense (*lead, d_in, d_out) -> condensed (values, indices), each (*lead, d_out, k).

    Each column may hold at most k True. Rows are ranked active-first by a
    STABLE sort (ascending row order within each class), as in the
    reference, so slots past a column's nnz land on mask-False rows with
    value +0 (a select, not a product with the mask, which would give -0
    under a negative weight: the reference's compiled product is a select
    too, and quantized codes keep the sign of a zero).
    """
    inactive = (~mask).to(torch.uint8)
    order = torch.argsort(inactive, dim=-2, stable=True)        # active rows first
    top_idx = order[..., :k, :].transpose(-1, -2)               # (*lead, d_out, k)
    gathered_mask = torch.take_along_dim(mask.transpose(-1, -2), top_idx, dim=-1)
    gathered = torch.take_along_dim(weight.transpose(-1, -2), top_idx, dim=-1)
    values = torch.where(gathered_mask, gathered, torch.zeros_like(gathered))
    return values, top_idx.to(torch.int32).contiguous()


def condensed_to_dense(values: torch.Tensor, indices: torch.Tensor, d_in: int) -> torch.Tensor:
    """Scatter condensed (*lead, d_out, k) arrays back to a dense (*lead, d_in, d_out) matrix."""
    *lead, d_out, _ = values.shape
    dense = torch.zeros((*lead, d_out, d_in), dtype=values.dtype, device=values.device)
    dense.scatter_add_(-1, indices.long(), values)
    return dense.transpose(-1, -2)


def column_nnz(mask: torch.Tensor) -> torch.Tensor:
    """Number of non-zeros per output neuron (column), int32 (*lead, d_out)."""
    return mask.sum(dim=-2, dtype=torch.int32)


def check_constant_fan_in(mask, k: int, neuron_active=None) -> bool:
    """True iff every active column has exactly k non-zeros and inactive ones have 0."""
    nnz = np.asarray(torch.as_tensor(mask).cpu()).sum(axis=-2)
    if neuron_active is None:
        return bool(np.all(nnz == k))
    neuron_active = np.asarray(torch.as_tensor(neuron_active).cpu())
    ok_active = np.all(nnz[neuron_active] == k) if neuron_active.any() else True
    ok_ablated = np.all(nnz[~neuron_active] == 0) if (~neuron_active).any() else True
    return bool(ok_active and ok_ablated)
