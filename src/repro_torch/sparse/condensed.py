"""Condensed-representation export: masks -> serving trees (port of
``repro/sparse/condensed.py``).

The same trained weights serve as masked-dense, condensed constant fan-in,
structured or condensed-over-active (paper Sec. 4.4, Fig. 4). The exports
here turn a (params, masks) pair into a serving tree whose sparse leaves
are ``formats`` objects; the tree plugs into the masks slot of
``models.model.prefill_step``/``decode_step``. Values are stored once at
the compute dtype ``cfg.dtype``, so serving casts nothing per call, unless
``quantize_spec`` names a storage dtype: "int8"/"fp8" quantize the float32
param values per neuron, "bf16" stores them at bf16.
"""
from __future__ import annotations

import torch

from repro_torch.core.distributions import fan_in_from_density
from repro_torch.sparse import formats as F
from repro_torch.sparse import registry as REG


def export_stats(registry, masks: dict, stacks=None) -> dict[str, F.ExportStats]:
    """Per-stack realized stats with one host sync for all stacks.

    ``k`` is the largest realized fan-in of the stack, which sizes its
    condensed arrays. ``stacks`` restricts the measurement to a subset (an
    incremental refresh measures only the stacks whose masks changed).
    """
    stacks = list(registry if stacks is None else stacks)
    if not stacks:
        return {}
    table = torch.stack([F.stats_row(REG.get_path(masks, s.path))
                         for s in stacks]).tolist()           # single transfer
    return {s.name: F.stats_from_row(r) for s, r in zip(stacks, table)}


def stats_from_leaf(leaf, *, min_fan_in: int = 0) -> F.ExportStats:
    """ExportStats from an exported leaf's geometry (no mask): the sync
    subscriber adopts leaves exported elsewhere. ``k`` and ``max_active``
    are exact (they size the arrays), ``active_fraction`` is the spec's
    padded estimate, and ``min_fan_in`` defaults to 0 ("unknown"), so a
    plan repriced from these stats never takes the structured path by
    accident."""
    spec = leaf.spec()
    return F.ExportStats(k=int(spec.k), max_active=int(spec.max_active),
                         active_fraction=float(spec.active_fraction),
                         min_fan_in=int(min_fan_in))


def recondense_stack_leaf(weight, mask, stats: F.ExportStats, old_leaf, *,
                          over_active: bool = False, donate: bool = True,
                          quantize_spec=None, dtype: torch.dtype | None = None
                          ) -> F.SparseFormat:
    """Re-condense one stack for ``Plan.refresh``, into ``old_leaf``'s
    tensors when the shapes are unchanged (``formats.*.donate_refresh``).
    An old leaf of another representation gives a fresh export, its values
    stored at ``quantize_spec`` or else ``dtype``."""
    cls = F.CondensedOverActive if over_active else F.Condensed
    if not isinstance(old_leaf, cls):
        return cls.export_from_dense(weight, mask, stats, dtype=dtype,
                                     quantize_spec=quantize_spec)
    return old_leaf.donate_refresh(weight, mask, stats, donate=donate)


def revalue_stack_leaf(weight, mask, leaf, *, donate: bool = False) -> F.SparseFormat:
    """Values-only refresh of a condensed(-over-active) leaf under an
    unchanged topology (``formats.Condensed.refresh_values``)."""
    return leaf.refresh_values(weight, mask, donate=donate)


def condense_active_stack_leaf(weight, mask, stats: F.ExportStats, *,
                               dtype: torch.dtype | None = None) -> F.CondensedOverActive:
    """Condensed-over-active format for one stack at its realized stats."""
    return F.CondensedOverActive.export_from_dense(weight, mask, stats, dtype=dtype)


def structured_stack_leaf(mask, *, weight_itemsize: int = 4,
                          stats: F.ExportStats | None = None) -> F.StructuredFanIn:
    """Structured-only format for one stack (``StructuredFanIn.from_mask``)."""
    return F.StructuredFanIn.from_mask(mask, stats, weight_itemsize=weight_itemsize)


def export_condensed(cfg, registry, params: dict, masks: dict,
                     stats: dict[str, F.ExportStats] | None = None, *,
                     quantize_spec=None) -> dict:
    """Concrete export after training; k per stack = max realized fan-in.
    Leaves are ``formats.Condensed``."""
    return _export_tree(cfg, F.Condensed, registry, params, masks, stats, quantize_spec)


def export_condensed_over_active(cfg, registry, params: dict, masks: dict,
                                 stats: dict[str, F.ExportStats] | None = None, *,
                                 quantize_spec=None) -> dict:
    """Ablated neurons dropped, survivors condensed: ``formats.CondensedOverActive``
    leaves (the paper's combined Fig. 4 point, exact for any mask)."""
    return _export_tree(cfg, F.CondensedOverActive, registry, params, masks, stats,
                        quantize_spec)


def export_structured(cfg, registry, masks: dict,
                      stats: dict[str, F.ExportStats] | None = None, *,
                      params: dict | None = None, quantize_spec=None) -> dict:
    """Structured-only serving tree: ``formats.StructuredFanIn`` leaves, each
    ``active_index`` sized at its stack's realized active count. Float
    leaves read the live dense weights, so there are no values to store; an
    int8/fp8 ``quantize_spec`` stores each quantized gathered panel, cut
    from ``params``."""
    stats = stats if stats is not None else export_stats(registry, masks)
    quantized = F.resolve_quantize_spec(quantize_spec) in F.QUANTIZED_DTYPES
    if quantized and params is None:
        raise ValueError("a quantized structured export needs the params")
    out: dict = {}
    for s in registry:
        m = REG.get_path(masks, s.path)
        leaf = (F.StructuredFanIn.export_from_dense(REG.get_path(params, s.path), m,
                                                    stats[s.name], quantize_spec=quantize_spec)
                if quantized else structured_stack_leaf(m, stats=stats[s.name]))
        REG.set_path(out, s.path, leaf)
    return out


def _export_tree(cfg, cls, registry, params, masks, stats, quantize_spec):
    stats = stats if stats is not None else export_stats(registry, masks)
    dtype = getattr(torch, cfg.dtype)
    out: dict = {}
    for s in registry:
        w = REG.get_path(params, s.path)
        m = REG.get_path(masks, s.path)
        REG.set_path(out, s.path, cls.export_from_dense(w, m, stats[s.name], dtype=dtype,
                                                        quantize_spec=quantize_spec))
    return out


def abstract_condensed(cfg, registry, param_dtype: torch.dtype | None = None) -> dict:
    """The condensed serving tree at each stack's target fan-in, as meta
    tensors (``plan.abstract_serving_tree``, imported here late: the plan
    imports this module)."""
    from repro_torch.sparse import plan as PLAN
    return PLAN.abstract_serving_tree(cfg, registry, {s.name: "condensed" for s in registry},
                                      param_dtype=param_dtype)


def condensed_bytes(cfg, registry) -> tuple[int, int]:
    """(condensed weight bytes, dense weight bytes) over the sparse stacks at
    their target fan-ins and the param dtype: values and int32 indices
    against the dense weights."""
    itemsize = getattr(torch, cfg.param_dtype).itemsize
    dense = cond = 0
    for s in registry:
        k = fan_in_from_density(s.d_in, s.density)
        dense += s.n_replicas * s.d_in * s.d_out * itemsize
        cond += s.n_replicas * s.d_out * k * (itemsize + 4)
    return cond, dense
