"""SET baseline (Mocanu et al. 2018): prune by magnitude, regrow at random
(port of ``repro/core/set_sparse.py``).

The paper's Table 3 compares against it; it shares the rank machinery with
RigL and SRigL. The random scores come from a ``torch.Generator`` the
caller passes, never from the global generator, so a seeded update
regrows the same positions every time.
"""
from __future__ import annotations

import torch

from repro_torch.core import saliency
from repro_torch.core.rigl import (RigLSpec, RigLState, _count,  # noqa: F401 (re-export)
                                   init_layer_state, n_to_prune, stack_stats)


def set_update(spec: RigLSpec, weight: torch.Tensor, generator: torch.Generator,
               state: RigLState, drop_fraction) -> tuple[RigLState, dict]:
    """One SET update of a (d_in, d_out) layer: the RigL prune, then
    ``n_pruned`` positions regrown among the inactive ones by uniform scores
    from ``generator`` (on the weight's device). A weight with one leading
    axis runs each replica in turn, drawing from the same generator.

    Stats (int32): ``n_pruned``, ``n_grown`` and ``nnz``.
    """
    if weight.ndim == 3:
        return stack_stats([set_update(spec, w, generator, RigLState(m), drop_fraction)
                            for w, m in zip(weight, state.mask)])
    mask = state.mask
    n_prune = n_to_prune(mask, drop_fraction)
    survive = saliency.prune_survivors(weight, mask, n_prune)
    rand = torch.rand(weight.shape, generator=generator, device=weight.device)
    grown = saliency.top_k_candidates(rand, ~mask, n_prune)
    new_mask = survive | grown
    stats = dict(n_pruned=_count(mask & ~new_mask), n_grown=_count(grown),
                 nnz=_count(new_mask))
    return RigLState(mask=new_mask), stats
