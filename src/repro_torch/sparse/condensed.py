"""Condensed-representation export: masks -> serving trees (port of
``repro/sparse/condensed.py``).

The same trained weights serve as masked-dense or as condensed constant
fan-in (paper Sec. 4.4). ``export_condensed`` turns a (params, masks) pair
into a serving tree whose sparse leaves are ``formats.Condensed``; the tree
plugs into the masks slot of ``models.model.prefill_step``/``decode_step``.
"""
from __future__ import annotations

import torch

from repro_torch.sparse import formats as F
from repro_torch.sparse import registry as REG


def export_stats(registry, masks: dict) -> dict[str, F.ExportStats]:
    """Per-stack realized stats with one host sync for all stacks.

    ``k`` is the largest realized fan-in of the stack, which sizes its
    condensed arrays.
    """
    if not registry:
        return {}
    table = torch.stack([F.stats_row(REG.get_path(masks, s.path))
                         for s in registry]).tolist()         # single transfer
    return {s.name: F.stats_from_row(r) for s, r in zip(registry, table)}


def export_condensed(cfg, registry, params: dict, masks: dict,
                     stats: dict[str, F.ExportStats] | None = None) -> dict:
    """Concrete export after training; k per stack = max realized fan-in.

    Leaves are ``formats.Condensed`` with values stored once at the compute
    dtype ``cfg.dtype``, so serving casts nothing per call.
    """
    stats = stats if stats is not None else export_stats(registry, masks)
    dtype = getattr(torch, cfg.dtype)
    out: dict = {}
    for s in registry:
        w = REG.get_path(params, s.path)
        m = REG.get_path(masks, s.path)
        REG.set_path(out, s.path,
                     F.Condensed.export_from_dense(w, m, stats[s.name], dtype=dtype))
    return out
