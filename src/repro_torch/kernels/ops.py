"""Layer-level wrappers of the sparse kernels (port of ``repro/kernels/ops.py``).

Forward only so far: ``condensed_linear_nd`` runs the condensed gather
kernel over any leading dims. Its ``torch.autograd.Function`` (dx by
scatter-add, dw by the K3 kernel) comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import condensed_matmul as cm


def condensed_linear_nd(x: torch.Tensor, values: torch.Tensor,
                        indices: torch.Tensor) -> torch.Tensor:
    """Rank-polymorphic wrapper: flattens leading dims to the batch axis.

    y[..., n] = sum_k x[..., indices[n, k]] * values[n, k].
    """
    lead = x.shape[:-1]
    y = cm.condensed_matmul(x.reshape(-1, x.shape[-1]).contiguous(), values, indices)
    return y.reshape(*lead, values.shape[0])
