"""Plain PyTorch versions of the port's kernels.

Each is the CPU path of its kernel's wrapper and the yardstick the kernel is
held to on the card. They follow the Hopper kernels' numerics, which are the
TPU kernels' numerics, not those of ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch


def condensed_matmul_ref(x: torch.Tensor, values: torch.Tensor,
                         indices: torch.Tensor) -> torch.Tensor:
    """Condensed constant fan-in matmul (paper Alg. 1 / Eq. 30-31).

    x       : (B, d_in)
    values  : (n_out, k)   non-zero weights per neuron
    indices : (n_out, k)   int — input feature index of each non-zero
    returns : (B, n_out)   out[b, n] = sum_k f32(x[b, indices[n, k]]) * f32(values[n, k])

    Gathers x at the indices, multiplies in float32, sums over k in float32
    and casts to ``x.dtype`` — the order of
    ``repro/kernels/condensed_matmul.py::_fwd_kernel``. (The reference's
    ``condensed_matmul_ref`` multiplies in ``x.dtype`` instead.)
    """
    return _gather_sum(x, values, indices).to(x.dtype)


def _gather_sum(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """(B, n_out) float32: sum_k f32(x[b, indices[n, k]]) * f32(values[n, k])."""
    gathered = x[:, indices.long()].float()              # (B, n_out, k)
    return (gathered * values.float()[None]).sum(dim=-1)  # f32 accumulate


def condensed_matmul_scaled_ref(x: torch.Tensor, q: torch.Tensor, indices: torch.Tensor,
                                scales: torch.Tensor) -> torch.Tensor:
    """Condensed matmul over quantized values (the function of K2).

    q       : (n_out, k)   int8 or float8_e4m3fn codes
    scales  : (n_out,)     float32 per-neuron scale
    returns : (B, n_out)   (sum_k f32(x[b, indices[n, k]]) * f32(q[n, k])) * scales[n]

    The scale multiplies each neuron's float32 k-sum, and the product is
    cast once to ``x.dtype`` — the order of
    ``repro/kernels/condensed_matmul.py::_fwd_scaled_kernel``.
    """
    return (_gather_sum(x, q, indices) * scales.float()[None]).to(x.dtype)


def condensed_matmul_grouped_ref(x: torch.Tensor, values: torch.Tensor,
                                 indices: torch.Tensor,
                                 scales: torch.Tensor | None = None) -> torch.Tensor:
    """The expert-grouped condensed matmul (K1-moe; K2-moe with ``scales``).

    x       : (E, M, d_in)
    values  : (E, n_out, k)   values, or int8 / float8_e4m3fn codes
    indices : (E, n_out, k)
    scales  : (E, n_out)      float32 per-neuron scale of the codes, or None
    returns : (E, M, n_out)   y[e] = condensed_matmul_ref(x[e], values[e], indices[e])
                              (times scales[e] after the k-sum)

    Expert by expert the one-expert plain version, so each expert's output
    is exactly that version's: f32 accumulate, the scale after the k-sum,
    one cast to ``x.dtype``.
    """
    if scales is None:
        return torch.stack([condensed_matmul_ref(xe, v, i)
                            for xe, v, i in zip(x, values, indices)])
    return torch.stack([condensed_matmul_scaled_ref(xe, q, i, s)
                        for xe, q, i, s in zip(x, values, indices, scales)])


def condensed_over_active_matmul_ref(x: torch.Tensor, values: torch.Tensor,
                                     indices: torch.Tensor, out_index: torch.Tensor,
                                     d_out: int) -> torch.Tensor:
    """Condensed gather over the surviving rows, scattered to dense columns.

    values, indices : (a, k)   the a <= d_out surviving rows
    out_index       : (a,)     int — dense output column of each row;
                               ``d_out`` marks a padding row (dropped)
    returns         : (B, d_out), ablated columns exact zeros

    Row r is ``condensed_matmul_ref``'s row r (f32 accumulate, one cast to
    ``x.dtype``), stored at column ``out_index[r]`` — the function of
    ``repro/kernels/structured_matmul.py::_coa_kernel``.
    """
    y = condensed_matmul_ref(x, values, indices)                     # (B, a)
    return _scatter_columns(y, out_index, d_out)


def condensed_over_active_matmul_scaled_ref(x: torch.Tensor, q: torch.Tensor,
                                            indices: torch.Tensor, out_index: torch.Tensor,
                                            scales: torch.Tensor, d_out: int) -> torch.Tensor:
    """``condensed_over_active_matmul_ref`` over quantized rows (K2-coa):
    row r is ``condensed_matmul_scaled_ref``'s row r (its scale ``scales[r]``
    applied after the k-sum), stored at column ``out_index[r]`` — the
    ``scaled=True`` function of ``repro/kernels/structured_matmul.py::_coa_kernel``.
    """
    return _scatter_columns(condensed_matmul_scaled_ref(x, q, indices, scales), out_index,
                            d_out)


def condensed_over_active_matmul_grouped_ref(x: torch.Tensor, values: torch.Tensor,
                                             indices: torch.Tensor, out_index: torch.Tensor,
                                             d_out: int,
                                             scales: torch.Tensor | None = None) -> torch.Tensor:
    """The expert-grouped condensed gather over surviving rows (K4-moe;
    K2-coa-moe with ``scales``).

    x         : (E, M, d_in)
    values    : (E, a, k)   values, or int8 / float8_e4m3fn codes
    indices   : (E, a, k)
    out_index : (E, a)      each row's dense column, ``d_out`` a padding row
    scales    : (E, a)      float32 per-row scale of the codes, or None
    returns   : (E, M, d_out), y[e] = condensed_over_active_matmul_ref(x[e], ...)

    Expert by expert the one-expert plain version (its scaled form with
    ``scales``), so each expert's output is exactly that version's.
    """
    if scales is None:
        return torch.stack([condensed_over_active_matmul_ref(xe, v, i, o, d_out)
                            for xe, v, i, o in zip(x, values, indices, out_index)])
    return torch.stack([condensed_over_active_matmul_scaled_ref(xe, q, i, o, s, d_out)
                        for xe, q, i, o, s in zip(x, values, indices, out_index, scales)])


def structured_matmul_grouped_ref(x: torch.Tensor, panel: torch.Tensor,
                                  active_index: torch.Tensor, d_out: int) -> torch.Tensor:
    """The expert-grouped structured matmul (K5-moe; K6-moe reads the same
    columns of the dense weights). x (E, M, d_in), panel (E, d_in, a_pad),
    active_index (E, a_pad) -> (E, M, d_out): expert by expert
    ``structured_matmul_ref``."""
    return torch.stack([structured_matmul_ref(xe, p, ai, d_out)
                        for xe, p, ai in zip(x, panel, active_index)])


def structured_matmul_ref(x: torch.Tensor, panel: torch.Tensor,
                          active_index: torch.Tensor, d_out: int) -> torch.Tensor:
    """Matmul over gathered columns, each placed at its dense position.

    panel        : (d_in, a_pad)  the surviving columns of the dense weight
    active_index : (a_pad,)       int — dense column of each panel column;
                                  ``d_out`` marks a padding slot (dropped)
    returns      : (B, d_out), ablated columns exact zeros

    ``f32(x) @ f32(panel)`` with one cast to ``x.dtype`` — the function of
    ``repro/kernels/structured_matmul.py::_structured_kernel``.
    """
    y = (x.float() @ panel.float()).to(x.dtype)                      # (B, a_pad)
    return _scatter_columns(y, active_index, d_out)


def _scatter_columns(y: torch.Tensor, index: torch.Tensor, d_out: int) -> torch.Tensor:
    """(B, a) -> (B, d_out): column j of y to column index[j], sentinel
    (out-of-range) slots dropped, every other column zero. Out-of-range
    slots land in a spare column that is cut off, so nothing here waits for
    the device (a CUDA graph can capture it)."""
    dst = torch.where((index >= 0) & (index < d_out), index, d_out).long()
    out = torch.zeros((y.shape[0], d_out + 1), dtype=y.dtype, device=y.device)
    return out.index_copy_(1, dst, y)[:, :d_out].contiguous()


def structured_dense(x: torch.Tensor, weight: torch.Tensor,
                     neuron_active: torch.Tensor) -> torch.Tensor:
    """Fig. 4 "structured-only" formula: ``x @ (weight * neuron_active)``.

    weight (d_in, n_out); ablated outputs are exact zeros. The formula of
    ``repro/kernels/ops.py::structured_dense``, in ``x.dtype`` as there; the
    structured kernel (K5) is held to it with a tolerance.
    """
    return x @ (weight * neuron_active[None, :].to(weight.dtype))


def condensed_matmul_dx_ref(dy: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                            d_in: int) -> torch.Tensor:
    """Gradient wrt x: scatter-add of dy * values back to the input features,
    in ``dy.dtype`` — ``repro/kernels/ref.py::condensed_matmul_dx_ref``.

    dy (B, n_out), values/indices (n_out, k) -> (B, d_in). Neurons go in
    chunks so the (B, chunk, k) products stay near 2**26 elements. On the
    card ``index_add_`` adds with atomics, in an order that varies.
    """
    b = dy.shape[0]
    n_out, k = values.shape
    dx = torch.zeros((b, d_in), dtype=dy.dtype, device=dy.device)
    step = max(1, (1 << 26) // max(b * k, 1))
    for n0 in range(0, n_out, step):
        contrib = dy[:, n0:n0 + step, None] * values[None, n0:n0 + step].to(dy.dtype)
        dx.index_add_(1, indices[n0:n0 + step].reshape(-1).long(), contrib.reshape(b, -1))
    return dx


def condensed_matmul_dw_ref(dy: torch.Tensor, x: torch.Tensor,
                            indices: torch.Tensor) -> torch.Tensor:
    """Gradient wrt values: dw[n, k] = sum_b f32(dy[b, n]) * f32(x[b, indices[n, k]]).

    dy (B, n_out), x (B, d_in), indices (n_out, k) -> (n_out, k), float32
    for 16-bit inputs, else the inputs' dtype: the function and output type
    of ``repro/kernels/condensed_matmul.py::_dw_kernel`` (the kernel K3).
    """
    out = torch.float32 if dy.dtype in (torch.bfloat16, torch.float16) else dy.dtype
    gathered = x[:, indices.long()].float()                        # (B, n_out, k)
    return torch.einsum("bn,bnk->nk", dy.float(), gathered).to(out)


def condensed_matmul_dw_grouped_ref(dy: torch.Tensor, x: torch.Tensor,
                                    indices: torch.Tensor) -> torch.Tensor:
    """The expert-grouped values gradient (K3-moe). dy (E, B, n_out), x (E,
    B, d_in), indices (E, n_out, k) -> (E, n_out, k): expert by expert
    ``condensed_matmul_dw_ref``."""
    return torch.stack([condensed_matmul_dw_ref(d, xe, i) for d, xe, i in zip(dy, x, indices)])


def condensed_matmul_dx_grouped_ref(dy: torch.Tensor, values: torch.Tensor,
                                    indices: torch.Tensor, d_in: int) -> torch.Tensor:
    """Gradient wrt x of the expert-grouped condensed matmul: one batched
    scatter-add over every expert, in ``dy.dtype`` (the reference's
    ``jax.vmap`` of ``condensed_matmul_dx_ref``).

    dy (E, B, n_out), values/indices (E, n_out, k) -> (E, B, d_in). Expert
    e's indices are offset by e * d_in into one (B, E * d_in) accumulator,
    so each expert's slots add into its own columns; neurons go in chunks as
    in ``condensed_matmul_dx_ref``.
    """
    e, b, n_out = dy.shape
    k = values.shape[-1]
    dx = torch.zeros((b, e * d_in), dtype=dy.dtype, device=dy.device)
    offset = (torch.arange(e, device=dy.device) * d_in).view(e, 1, 1)
    flat_idx = indices.long() + offset                                   # (E, n_out, k)
    dyt = dy.permute(1, 0, 2)                                            # (B, E, n_out)
    step = max(1, (1 << 26) // max(b * e * k, 1))
    for n0 in range(0, n_out, step):
        contrib = dyt[:, :, n0:n0 + step, None] * values[None, :, n0:n0 + step].to(dy.dtype)
        dx.index_add_(1, flat_idx[:, n0:n0 + step].reshape(-1), contrib.reshape(b, -1))
    return dx.view(b, e, d_in).permute(1, 0, 2).contiguous()
