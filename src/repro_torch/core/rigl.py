"""RigL baseline (Evci et al. 2021), unstructured sparse-to-sparse DST
(port of ``repro/core/rigl.py``).

Prunes the K smallest-magnitude active weights of a layer and regrows the K
largest-|gradient| inactive positions, with no structural constraint, by
the same rank machinery as SRigL so the two compare directly. K =
floor(drop_fraction * nnz) in float32, as SRigL computes it; every
selection is a stable sort over the flattened layer, so the masks equal
the reference's on equal inputs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import saliency
from repro_torch.core.srigl import _count


@dataclasses.dataclass(frozen=True)
class RigLSpec:
    name: str
    d_in: int
    d_out: int
    density: float

    @property
    def target_nnz(self) -> int:
        return max(1, round(self.density * self.d_in * self.d_out))


class RigLState(NamedTuple):
    mask: torch.Tensor  # bool (d_in, d_out)


def init_layer_state(generator: torch.Generator, spec: RigLSpec) -> RigLState:
    from repro_torch.core import topology

    return RigLState(mask=topology.random_unstructured_mask(generator, spec.d_in, spec.d_out,
                                                            spec.target_nnz))


def n_to_prune(mask: torch.Tensor, drop_fraction) -> torch.Tensor:
    """floor(drop_fraction * nnz) in float32, as an int32 tensor."""
    drop = torch.tensor(drop_fraction, dtype=torch.float32, device=mask.device)
    return torch.floor(drop * _count(mask).to(torch.float32)).to(torch.int32)


def stack_stats(outs: list) -> tuple:
    """Per-replica (state, stats) pairs stacked along a new leading axis;
    the states are NamedTuples, the stats NamedTuples or dicts."""
    def stack(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: torch.stack([it[k] for it in items]) for k in first}
        return type(first)(*(torch.stack(t) for t in zip(*items)))
    return stack([o[0] for o in outs]), stack([o[1] for o in outs])


def rigl_update(spec: RigLSpec, weight: torch.Tensor, dense_grad: torch.Tensor,
                state: RigLState, drop_fraction) -> tuple[RigLState, dict]:
    """One RigL update of a (d_in, d_out) layer, float32; a weight with one
    leading axis runs each replica in turn, as the reference vmaps it.

    Stats (int32): ``n_pruned``, ``n_grown``, ``nnz`` and ``n_ablated``, the
    neurons left with no incoming weight (RigL's implicit ablation, the
    observation behind SRigL's explicit one, paper Fig. 3b).
    """
    if weight.ndim == 3:
        return stack_stats([rigl_update(spec, w, g, RigLState(m), drop_fraction)
                            for w, g, m in zip(weight, dense_grad, state.mask)])
    mask = state.mask
    n_prune = n_to_prune(mask, drop_fraction)
    survive = saliency.prune_survivors(weight, mask, n_prune)
    grown = saliency.top_k_candidates(dense_grad.abs(), ~mask, n_prune)
    new_mask = survive | grown
    stats = dict(n_pruned=_count(mask & ~new_mask), n_grown=_count(grown),
                 nnz=_count(new_mask), n_ablated=_count(_count(new_mask, 0) == 0))
    return RigLState(mask=new_mask), stats
