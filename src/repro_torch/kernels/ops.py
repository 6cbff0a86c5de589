"""Layer-level wrappers of the sparse kernels (port of ``repro/kernels/ops.py``).

Forward only so far; each flattens the leading dims of x to the batch axis:

* ``condensed_linear_nd`` — the condensed gather (K1; K2 with ``scales=``);
* ``condensed_over_active_linear_nd`` — the gather over surviving rows,
  written through ``out_index`` (K4; K2-coa with ``scales=``);
* ``structured_linear_nd`` — the column-gathered matmul over the live dense
  weight (K5, or K6 with ``REPRO_PREFETCH_GATHER=1`` at decode shapes);
* ``structured_gathered_linear_nd`` — the same kernel over a caller-supplied
  panel of gathered columns;
* ``structured_dense`` — the formula the structured kernel is held to.

Their ``torch.autograd.Function``s (dx by scatter-add, dw by the K3 kernel)
come with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import condensed_matmul as cm
from repro_torch.kernels import structured_matmul as sm
from repro_torch.kernels.ref import structured_dense  # noqa: F401  (the reference's ops name)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def condensed_linear_nd(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor, *,
                        scales: torch.Tensor | None = None) -> torch.Tensor:
    """y[..., n] = sum_k x[..., indices[n, k]] * values[n, k]. ``scales``
    marks ``values`` as int8/fp8 codes: y[..., n] is then that sum times
    scales[n] (the dequant-fused kernel K2; inference only)."""
    y = cm.condensed_matmul(_rows(x), values, indices, scales=scales)
    return y.reshape(*x.shape[:-1], values.shape[0])


def condensed_over_active_linear_nd(x: torch.Tensor, values: torch.Tensor,
                                    indices: torch.Tensor, out_index: torch.Tensor,
                                    d_out: int, *,
                                    scales: torch.Tensor | None = None) -> torch.Tensor:
    """y[..., out_index[r]] = sum_k x[..., indices[r, k]] * values[r, k] over
    the surviving rows r; every other output column is exactly zero.
    ``scales`` marks ``values`` as codes, as in ``condensed_linear_nd`` (K2-coa)."""
    y = sm.condensed_over_active_matmul(_rows(x), values, indices, out_index, d_out,
                                        scales=scales)
    return y.reshape(*x.shape[:-1], d_out)


def structured_linear_nd(x: torch.Tensor, w: torch.Tensor,
                         active_index: torch.Tensor) -> torch.Tensor:
    """y = x @ w over the surviving columns ``active_index`` of the dense
    (d_in, d_out) weight; ablated columns exactly zero. The weight is cast
    to ``x.dtype`` (a no-op for the serving copy)."""
    y = sm.structured_matmul(_rows(x), w.to(x.dtype), active_index)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def structured_gathered_linear_nd(x: torch.Tensor, panel: torch.Tensor,
                                  active_index: torch.Tensor, d_out: int) -> torch.Tensor:
    """Structured matmul over a (d_in, a) panel of already gathered columns.
    A panel already in ``x.dtype`` (a dequantized one) is used as it is."""
    y = sm.structured_matmul_pregathered(_rows(x), panel.to(x.dtype), active_index, d_out)
    return y.reshape(*x.shape[:-1], d_out)
