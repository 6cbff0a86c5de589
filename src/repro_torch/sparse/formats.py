"""Serving formats for sparse weight stacks (port of ``repro/sparse/formats.py``).

Only ``Condensed`` is ported so far: the constant fan-in gather layout of
the paper's Alg. 1. ``MaskedDense``, ``StructuredFanIn``,
``CondensedOverActive``, quantized values and tensor-parallel blocks come
with later slices.
"""
from __future__ import annotations

import dataclasses
import typing

import torch

from repro_torch.core import topology
from repro_torch.kernels import ops


class ExportStats(typing.NamedTuple):
    """Realized per-stack statistics that size an export."""

    k: int                  # max realized fan-in over the stack's columns
    max_active: int         # max surviving-neuron count over the stack's layers
    active_fraction: float  # mean fraction of neurons with any non-zero
    min_fan_in: int         # min fan-in over active columns (d_in iff ablation-only)


def stats_row(mask: torch.Tensor) -> torch.Tensor:
    """The four ExportStats of one stacked mask (*lead, d_in, d_out), on its device."""
    nnz = mask.sum(dim=-2, dtype=torch.int32)                  # (*lead, d_out)
    act = nnz > 0
    return torch.stack([
        nnz.max().float(),
        act.sum(dim=-1, dtype=torch.int32).max().float(),
        act.float().mean(),
        torch.where(act, nnz, mask.shape[-2]).min().float(),
    ])


def stats_from_row(row) -> ExportStats:
    return ExportStats(k=int(row[0]), max_active=int(row[1]),
                       active_fraction=float(row[2]), min_fan_in=int(row[3]))


def realized_stats(mask: torch.Tensor) -> ExportStats:
    """ExportStats of one stacked mask, with one host sync."""
    return stats_from_row(stats_row(mask).tolist())


@dataclasses.dataclass(frozen=True, eq=False)
class Condensed:
    """Fig. 4 "condensed": values and int32 indices at constant fan-in k.

    ``values`` and ``indices`` are (*lead, d_out, k); ``d_in`` is the dense
    fan-in the indices address. ``apply`` takes one layer's arrays (no lead
    dims); ``layer(i)`` slices them out of a stack.
    """
    values: torch.Tensor
    indices: torch.Tensor
    d_in: int = 0

    def apply(self, x: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
        # the values' cast to the activation dtype is a no-op when the export
        # already stored them at the compute dtype (export_condensed does)
        return ops.condensed_linear_nd(x, self.values.to(x.dtype), self.indices)

    def layer(self, i: int) -> "Condensed":
        return Condensed(self.values[i], self.indices[i], self.d_in)

    def to(self, device) -> "Condensed":
        return Condensed(self.values.to(device), self.indices.to(device), self.d_in)

    @classmethod
    def export_from_dense(cls, w: torch.Tensor, mask: torch.Tensor,
                          stats: ExportStats | None = None, *,
                          dtype: torch.dtype | None = None) -> "Condensed":
        """Condense ``w * mask`` at the stack's realized fan-in.

        ``dtype`` stores the values at that dtype (the serving copy's compute
        dtype); None keeps the weight's dtype, as the reference does.
        """
        stats = stats if stats is not None else realized_stats(mask)
        k = max(stats.k, 1)
        values, indices = topology.dense_to_condensed(w * mask, mask, k)
        if dtype is not None:
            values = values.to(dtype)
        return cls(values=values.contiguous(), indices=indices,
                   d_in=int(w.shape[-2]))
