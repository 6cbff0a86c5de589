"""Layer-level wrappers of the sparse kernels (port of ``repro/kernels/ops.py``).

``condensed_linear`` and ``condensed_over_active_linear`` are
``torch.autograd.Function``s, the reference's custom VJPs: the forward runs
K1 / K4; the backward computes

  dx = scatter-add of dy * values, in dy's dtype (``ref.condensed_matmul_dx_ref``)
  dw = the values-gradient kernel K3 (``condensed_matmul.condensed_matmul_dw``),

returned at x's and values' dtypes. ``structured_linear`` is one too: the
forward runs K5 (or K6); the backward is the reference's
``_structured_bwd``, which the reference also computes outside any kernel:

  dx = dy_act @ w_act.T          (dy and w at the surviving columns)
  dw = x.T @ dy_act, added into zeros at the surviving columns only,

so padding entries (``== d_out``) are dropped and ablated columns get an
exact 0. The quantized (``scales=``) and pregathered paths are forward
only. The ``_nd`` wrappers flatten the leading dims of x to the batch axis:

* ``condensed_linear_nd`` — the condensed gather (K1; K2 with ``scales=``,
  inference only);
* ``condensed_linear_grouped`` — an MoE layer's expert stack in one
  expert-grouped launch (K1-moe; K2-moe with ``scales=``, inference
  only), its blocks read at one expert's key; differentiable in x and the
  values, the backward a batched scatter-add for dx and K3-moe
  (``condensed_matmul_dw_grouped``) for dw, as the reference's ``jax.vmap``
  of the custom VJP;
* ``condensed_over_active_linear_grouped`` — the same over the experts'
  surviving rows (K4-moe; K2-coa-moe with ``scales=``, inference only),
  its backward K3-moe on dy gathered at ``out_index``;
* ``structured_linear_grouped`` / ``structured_gathered_linear_grouped`` —
  the experts' column-gathered matmul (K5-moe, K6-moe under
  ``REPRO_PREFETCH_GATHER=1`` at decode shapes; over a caller's panels),
  the first differentiable in x and the weights through the reference's
  ``_structured_bwd`` batched over the experts;
* ``condensed_over_active_linear_nd`` — the gather over surviving rows,
  written through ``out_index`` (K4; K2-coa with ``scales=``, inference
  only);
* ``structured_linear_nd`` — the column-gathered matmul over the live dense
  weight (K5, or K6 with ``REPRO_PREFETCH_GATHER=1`` at decode shapes),
  differentiable in x and the weight;
* ``structured_gathered_linear_nd`` — the same kernel over a caller-supplied
  panel of gathered columns;
* ``structured_dense`` — the formula the structured kernel is held to.

Launch resolution (``_resolve_blocks``, as the reference's): a
caller-forced ``block_b`` or ``block_n`` wins; else the launch cached by
``sparse.autotune`` under the format's key (``formats.shape_tuning_key``
at x's device, dtype and batch bucket, a quantized key naming x's dtype;
the structured kernel's and the condensed-over-active kernel's keys carry
their ``kind``); else the wrapper's default. With one of the two forced
the cache is not read: an entry names a pair. The lookup reads the
cache's in-memory view, so a call reads no file; inside a captured CUDA
graph it happens once, at capture, and a graph captured before
``autotune`` keeps the launch it captured (as a reference program compiled
before ``autotune`` keeps its blocks).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import condensed_matmul as cm
from repro_torch.kernels import ref
from repro_torch.kernels import structured_matmul as sm
from repro_torch.kernels.ref import structured_dense  # noqa: F401  (the reference's ops name)


def _resolve_blocks(x: torch.Tensor, n_out: int, k: int, block_b: int | None,
                    block_n: int | None, *, kind: str = "condensed",
                    scatter_width: int | None = None,
                    values_dtype: str | None = None) -> tuple[int | None, int | None]:
    """(block_b, block_n) for one launch on x (B, d_in): the caller's where
    either is forced, else the cached entry under the format's key, else
    (None, None), the wrapper's default."""
    if block_b is not None or block_n is not None:
        return block_b, block_n
    # lazy: the formats import this module
    from repro_torch.sparse import autotune as AT
    from repro_torch.sparse import formats as F
    if not AT.has_kernel_entries():
        return None, None
    tuned = AT.lookup_entry(F.shape_tuning_key(
        x.shape[-1], n_out, k, x.shape[0], backend=AT.device_key(x.device),
        itemsize=x.element_size(), kind=kind, scatter_width=scatter_width,
        values_dtype=values_dtype, compute_dtype=x.dtype))
    if tuned is None:
        return None, None
    return tuned["block_b"], tuned["block_n"]


def _quantized_name(values: torch.Tensor) -> str | None:
    """The key's name of quantized codes ("int8" / "fp8")."""
    from repro_torch.sparse import formats as F
    return F.resolve_quantize_spec(values.dtype)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def _needs_graph(x: torch.Tensor, values: torch.Tensor) -> bool:
    """Whether autograd records this call; serving calls the kernel directly
    and skips the Function's per-call cost."""
    return torch.is_grad_enabled() and (x.requires_grad or values.requires_grad)


class _CondensedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, values, indices, block_b, block_n):
        ctx.save_for_backward(x, values, indices)
        return cm.condensed_matmul(x, values, indices, block_b=block_b, block_n=block_n)

    @staticmethod
    def backward(ctx, dy):
        x, values, indices = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ref.condensed_matmul_dx_ref(dy, values, indices, x.shape[-1]).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = cm.condensed_matmul_dw(dy, x, indices).to(values.dtype)
        return dx, dw, None, None, None


def condensed_linear(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                     block_b: int | None = None, block_n: int | None = None) -> torch.Tensor:
    """y[b, n] = sum_k x[b, indices[n, k]] * values[n, k]; differentiable in
    x and values. x (B, d_in); values, indices (n_out, k). The launch as
    ``_resolve_blocks`` gives it."""
    bb, bn = _resolve_blocks(x, *values.shape, block_b, block_n)
    if _needs_graph(x, values):
        return _CondensedLinear.apply(x, values, indices, bb, bn)
    return cm.condensed_matmul(x, values, indices, block_b=bb, block_n=bn)


def _dy_active(dy: torch.Tensor, out_index: torch.Tensor, d_out: int) -> torch.Tensor:
    """dy (..., M, d_out) at the surviving rows' dense columns, out_index
    (..., a) (an expert's own for each expert of a grouped launch); padding
    rows (out_index == d_out) get exact-zero cotangents."""
    cols = out_index.clamp(max=d_out - 1).long().unsqueeze(-2).expand(*dy.shape[:-1], -1)
    sel = torch.gather(dy, -1, cols)
    return (sel * (out_index < d_out).unsqueeze(-2).to(sel.dtype)).contiguous()


class _CondensedOverActiveLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, values, indices, out_index, d_out, block_b, block_n):
        ctx.save_for_backward(x, values, indices, out_index)
        ctx.d_out = d_out
        return sm.condensed_over_active_matmul(x, values, indices, out_index, d_out,
                                               block_b=block_b, block_n=block_n)

    @staticmethod
    def backward(ctx, dy):
        x, values, indices, out_index = ctx.saved_tensors
        dy_act = _dy_active(dy, out_index, ctx.d_out)                 # (B, a)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ref.condensed_matmul_dx_ref(dy_act, values, indices, x.shape[-1]).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = cm.condensed_matmul_dw(dy_act, x, indices).to(values.dtype)
        return dx, dw, None, None, None, None, None


def condensed_over_active_linear(x: torch.Tensor, values: torch.Tensor,
                                 indices: torch.Tensor, out_index: torch.Tensor,
                                 d_out: int, block_b: int | None = None,
                                 block_n: int | None = None) -> torch.Tensor:
    """The condensed gather over the ``a`` surviving rows, row r stored at
    column ``out_index[r]`` of the (B, d_out) output (``d_out`` marks a
    padding row); differentiable in x and values. The launch as
    ``_resolve_blocks`` gives it (the ``coa`` keys)."""
    bb, bn = _resolve_blocks(x, *values.shape, block_b, block_n, kind="coa",
                             scatter_width=d_out)
    if _needs_graph(x, values):
        return _CondensedOverActiveLinear.apply(x, values, indices, out_index, d_out, bb, bn)
    return sm.condensed_over_active_matmul(x, values, indices, out_index, d_out,
                                           block_b=bb, block_n=bn)


def _inference_only(x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("quantized values (scales=) are inference-only: no gradient "
                           "flows through them")


def condensed_linear_nd(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor, *,
                        scales: torch.Tensor | None = None) -> torch.Tensor:
    """y[..., n] = sum_k x[..., indices[n, k]] * values[n, k]. ``scales``
    marks ``values`` as int8/fp8 codes: y[..., n] is then that sum times
    scales[n] (the dequant-fused kernel K2; inference only)."""
    x2 = _rows(x)
    if scales is None:
        y = condensed_linear(x2, values, indices)
    else:
        _inference_only(x)
        bb, bn = _resolve_blocks(x2, *values.shape, None, None,
                                 values_dtype=_quantized_name(values))
        y = cm.condensed_matmul(x2, values, indices, scales=scales, block_b=bb, block_n=bn)
    return y.reshape(*x.shape[:-1], values.shape[0])


class _CondensedLinearGrouped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, values, indices, block_b, block_n):
        ctx.save_for_backward(x, values, indices)
        return cm.condensed_matmul_grouped(x, values, indices, block_b=block_b, block_n=block_n)

    @staticmethod
    def backward(ctx, dy):
        x, values, indices = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ref.condensed_matmul_dx_grouped_ref(dy, values, indices,
                                                     x.shape[-1]).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = cm.condensed_matmul_dw_grouped(dy, x, indices).to(values.dtype)
        return dx, dw, None, None, None


def _experts_rows(x: torch.Tensor) -> torch.Tensor:
    """x (E, ..., d_in) as (E, M, d_in), contiguous."""
    return x.reshape(x.shape[0], -1, x.shape[-1]).contiguous()


def condensed_linear_grouped(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor, *,
                             scales: torch.Tensor | None = None) -> torch.Tensor:
    """The experts' condensed linear: x (E, ..., d_in), values and indices
    (E, n_out, k) -> (E, ..., n_out), expert e's rows through expert e's
    weights (the reference's ``jax.vmap`` of ``condensed_linear_nd`` over the
    experts). ``scales`` (E, n_out) marks ``values`` as codes (K2-moe,
    inference only, as K2 is). Differentiable in x and values: dx by a
    batched scatter-add in dy's dtype, dw by K3-moe. The launch is resolved
    at the key the reference's wrapper reads under its ``vmap``: one
    expert's shape (d_in, n_out, k) at its rows (x's middle dims flattened,
    G * C for a routed layer), bucketed; the blocks apply to every expert."""
    x3 = _experts_rows(x)
    bb, bn = _resolve_blocks(x3[0], *values.shape[1:], None, None,
                             values_dtype=None if scales is None else _quantized_name(values))
    if scales is not None:
        _inference_only(x)
        y = cm.condensed_matmul_grouped(x3, values, indices, scales=scales, block_b=bb,
                                        block_n=bn)
    elif _needs_graph(x3, values):
        y = _CondensedLinearGrouped.apply(x3, values, indices, bb, bn)
    else:
        y = cm.condensed_matmul_grouped(x3, values, indices, block_b=bb, block_n=bn)
    return y.reshape(*x.shape[:-1], values.shape[-2])


class _CondensedOverActiveLinearGrouped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, values, indices, out_index, d_out, block_b, block_n):
        ctx.save_for_backward(x, values, indices, out_index)
        ctx.d_out = d_out
        return sm.condensed_over_active_matmul_grouped(x, values, indices, out_index, d_out,
                                                       block_b=block_b, block_n=block_n)

    @staticmethod
    def backward(ctx, dy):
        x, values, indices, out_index = ctx.saved_tensors
        dy_act = _dy_active(dy, out_index, ctx.d_out)          # (E, M, a)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ref.condensed_matmul_dx_grouped_ref(dy_act, values, indices,
                                                     x.shape[-1]).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = cm.condensed_matmul_dw_grouped(dy_act, x, indices).to(values.dtype)
        return dx, dw, None, None, None, None, None


def condensed_over_active_linear_grouped(x: torch.Tensor, values: torch.Tensor,
                                         indices: torch.Tensor, out_index: torch.Tensor,
                                         d_out: int, *,
                                         scales: torch.Tensor | None = None) -> torch.Tensor:
    """The experts' condensed gather over surviving rows: x (E, ..., d_in);
    values, indices (E, a, k); out_index (E, a) -> (E, ..., d_out), the
    reference's ``jax.vmap`` of ``condensed_over_active_linear_nd``.
    ``scales`` marks ``values`` as codes (K2-coa-moe, inference only).
    Differentiable in x and values (K3-moe on dy gathered at
    ``out_index``). The launch as ``condensed_linear_grouped``'s, at one
    expert's ``coa`` key."""
    x3 = _experts_rows(x)
    bb, bn = _resolve_blocks(x3[0], *values.shape[1:], None, None, kind="coa",
                             scatter_width=d_out,
                             values_dtype=None if scales is None else _quantized_name(values))
    if scales is not None:
        _inference_only(x)
        y = sm.condensed_over_active_matmul_grouped(x3, values, indices, out_index, d_out,
                                                    scales=scales, block_b=bb, block_n=bn)
    elif _needs_graph(x3, values):
        y = _CondensedOverActiveLinearGrouped.apply(x3, values, indices, out_index, d_out, bb,
                                                    bn)
    else:
        y = sm.condensed_over_active_matmul_grouped(x3, values, indices, out_index, d_out,
                                                    block_b=bb, block_n=bn)
    return y.reshape(*x.shape[:-1], d_out)


def condensed_over_active_linear_nd(x: torch.Tensor, values: torch.Tensor,
                                    indices: torch.Tensor, out_index: torch.Tensor,
                                    d_out: int, *,
                                    scales: torch.Tensor | None = None) -> torch.Tensor:
    """y[..., out_index[r]] = sum_k x[..., indices[r, k]] * values[r, k] over
    the surviving rows r; every other output column is exactly zero.
    ``scales`` marks ``values`` as codes, as in ``condensed_linear_nd`` (K2-coa)."""
    x2 = _rows(x)
    if scales is None:
        y = condensed_over_active_linear(x2, values, indices, out_index, d_out)
    else:
        _inference_only(x)
        bb, bn = _resolve_blocks(x2, *values.shape, None, None, kind="coa",
                                 scatter_width=d_out, values_dtype=_quantized_name(values))
        y = sm.condensed_over_active_matmul(x2, values, indices, out_index, d_out,
                                            scales=scales, block_b=bb, block_n=bn)
    return y.reshape(*x.shape[:-1], d_out)


class _StructuredLinear(torch.autograd.Function):
    """K5 (x (B, d_in), w (d_in, d_out)) or, with the experts first (x (E,
    M, d_in), w (E, d_in, d_out), active_index (E, a_pad)), K5-moe; the
    backward is the reference's ``_structured_bwd`` (for each expert)."""

    @staticmethod
    def forward(ctx, x, w, active_index, block_b):
        ctx.save_for_backward(x, w, active_index)
        run = sm.structured_matmul_grouped if x.ndim == 3 else sm.structured_matmul
        return run(x, w.to(x.dtype), active_index, block_b=block_b)

    @staticmethod
    def backward(ctx, dy):
        x, w, active_index = ctx.saved_tensors
        d_out = w.shape[-1]
        dy_act = _dy_active(dy, active_index, d_out)                  # (..., M, a_pad)
        cols = active_index.long().unsqueeze(-2).expand(*w.shape[:-1], -1)  # (..., d_in, a_pad)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_act = torch.gather(w, -1, cols.clamp(max=d_out - 1)).to(dy_act.dtype)
            dx = (dy_act @ w_act.transpose(-1, -2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            contrib = (x.to(dy_act.dtype).transpose(-1, -2) @ dy_act).to(w.dtype)
            # one spare column takes the padding entries, then is cut off
            dw = torch.zeros((*w.shape[:-1], d_out + 1), dtype=w.dtype, device=w.device)
            dw = dw.scatter_add_(-1, cols, contrib)[..., :d_out].contiguous()
        return dx, dw, None, None


def structured_linear(x: torch.Tensor, w: torch.Tensor, active_index: torch.Tensor,
                      block_b: int | None = None) -> torch.Tensor:
    """y = x @ w over the surviving columns ``active_index`` (padded with
    the sentinel ``d_out``) of the dense (d_in, d_out) weight, ablated
    columns exact zeros; differentiable in x and w. The weight is cast to
    ``x.dtype`` (a no-op for the serving copy). x (B, d_in). The batch tile
    as ``_resolve_blocks`` gives it (the ``structured`` keys; K5 takes no
    ``block_n``)."""
    bb, _ = _resolve_blocks(x, active_index.shape[0], 0, block_b, None, kind="structured",
                            scatter_width=w.shape[-1])
    if _needs_graph(x, w):
        return _StructuredLinear.apply(x, w, active_index, bb)
    return sm.structured_matmul(x, w.to(x.dtype), active_index, block_b=bb)


def structured_linear_nd(x: torch.Tensor, w: torch.Tensor,
                         active_index: torch.Tensor) -> torch.Tensor:
    """``structured_linear`` with the leading dims of x flattened."""
    y = structured_linear(_rows(x), w, active_index)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def structured_gathered_linear_nd(x: torch.Tensor, panel: torch.Tensor,
                                  active_index: torch.Tensor, d_out: int, *,
                                  values_dtype: str | None = None) -> torch.Tensor:
    """Structured matmul over a (d_in, a) panel of already gathered columns.
    A panel already in ``x.dtype`` (a dequantized one) is used as it is.
    ``values_dtype`` names the quantized leaf's key."""
    x2 = _rows(x)
    bb, _ = _resolve_blocks(x2, active_index.shape[0], 0, None, None, kind="structured",
                            scatter_width=d_out, values_dtype=values_dtype)
    y = sm.structured_matmul_pregathered(x2, panel.to(x.dtype), active_index, d_out,
                                         block_b=bb)
    return y.reshape(*x.shape[:-1], d_out)


def structured_linear_grouped(x: torch.Tensor, w: torch.Tensor,
                              active_index: torch.Tensor) -> torch.Tensor:
    """The experts' structured linear: x (E, ..., d_in), w (E, d_in, d_out),
    active_index (E, a_pad) -> (E, ..., d_out), the reference's ``jax.vmap``
    of ``structured_linear_nd`` (K5-moe; K6-moe under
    ``REPRO_PREFETCH_GATHER=1`` at decode shapes). Differentiable in x and
    w. The batch tile at one expert's ``structured`` key."""
    x3 = _experts_rows(x)
    bb, _ = _resolve_blocks(x3[0], active_index.shape[-1], 0, None, None, kind="structured",
                            scatter_width=w.shape[-1])
    if _needs_graph(x3, w):
        y = _StructuredLinear.apply(x3, w, active_index, bb)
    else:
        y = sm.structured_matmul_grouped(x3, w.to(x.dtype), active_index, block_b=bb)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def structured_gathered_linear_grouped(x: torch.Tensor, panel: torch.Tensor,
                                       active_index: torch.Tensor, d_out: int, *,
                                       values_dtype: str | None = None) -> torch.Tensor:
    """K5-moe over the experts' (E, d_in, a_pad) panels of already gathered
    columns (a quantized expert leaf's, dequantized); forward only.
    ``values_dtype`` names the quantized leaf's key."""
    x3 = _experts_rows(x)
    bb, _ = _resolve_blocks(x3[0], active_index.shape[-1], 0, None, None, kind="structured",
                            scatter_width=d_out, values_dtype=values_dtype)
    y = sm.structured_matmul_grouped_pregathered(x3, panel.to(x.dtype), active_index, d_out,
                                                 block_b=bb)
    return y.reshape(*x.shape[:-1], d_out)
