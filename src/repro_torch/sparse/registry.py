"""Registry of sparsifiable layers per architecture (port of ``repro/sparse/registry.py``).

The registry enumerates every sparse weight *stack* (a group of
identically-shaped layers stacked on leading dims, e.g. ``("blocks",
"w_gate")`` with ``lead=(L,)``) and solves the ERK (or uniform) densities
over the stacks. Paper defaults: MLP and attention-output projections are
sparse; QKV input projections, norms and embeddings stay dense.

Ported so far: the dense family's enumeration, ``k_fan_map``, the tree path
helpers and SRigL mask initialization. The DST update waits for the
training slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core import distributions as D
from repro_torch.core import topology


@dataclasses.dataclass(frozen=True)
class SparseStack:
    path: tuple[str, ...]       # location in the params tree
    d_in: int
    d_out: int
    lead: tuple[int, ...]       # leading (stack) dims, e.g. (L,)
    density: float = 1.0        # filled by the ERK solve

    @property
    def n_replicas(self) -> int:
        return int(math.prod(self.lead)) if self.lead else 1

    @property
    def name(self) -> str:
        return "/".join(self.path)


def _attn_stacks(cfg, prefix: tuple, lead: tuple, with_mlp=True) -> list[SparseStack]:
    d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    out = [SparseStack(prefix + ("wo",), qd, d, lead)]
    if cfg.sparsity.sparse_qkv:
        out += [
            SparseStack(prefix + ("wq",), d, qd, lead),
            SparseStack(prefix + ("wk",), d, kvd, lead),
            SparseStack(prefix + ("wv",), d, kvd, lead),
        ]
    if with_mlp and ff:
        out += [
            SparseStack(prefix + ("w_gate",), d, ff, lead),
            SparseStack(prefix + ("w_up",), d, ff, lead),
            SparseStack(prefix + ("w_down",), ff, d, lead),
        ]
    return out


def build_registry(cfg) -> list[SparseStack]:
    """All sparse stacks of ``cfg`` with ERK/uniform densities solved."""
    if cfg.sparsity.method == "dense":
        return []
    if cfg.family != "dense" or cfg.local_global_ratio:
        raise NotImplementedError(
            f"family {cfg.family!r} (local_global_ratio="
            f"{cfg.local_global_ratio}) is not ported yet")
    stacks = _attn_stacks(cfg, ("blocks",), (cfg.n_layers,))
    shapes = [D.LayerShape(s.name, s.d_in, s.d_out, s.n_replicas) for s in stacks]
    solver = D.erk_densities if cfg.sparsity.distribution == "erk" else D.uniform_densities
    dens = solver(shapes, cfg.sparsity.sparsity)
    return [dataclasses.replace(s, density=dens[s.name]) for s in stacks]


def k_fan_map(cfg, registry: Sequence[SparseStack]) -> dict[str, int]:
    """layer-name -> constant fan-in (for init scaling). Last path element keys."""
    return {s.path[-1]: D.fan_in_from_density(s.d_in, s.density) for s in registry}


def set_path(tree: dict, path: tuple, leaf) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = leaf


def get_path(tree: dict, path: tuple):
    node = tree
    for p in path:
        node = node[p]
    return node


def init_sparsity_state(cfg, generator: torch.Generator,
                        registry: Sequence[SparseStack]) -> dict:
    """Returns {"masks": tree, "neuron_active": tree} (paths mirror params).

    Masks are drawn from ``generator`` on its device, exactly k True per
    column of every layer (k from the stack's solved density).
    """
    if cfg.sparsity.method != "srigl":
        raise NotImplementedError(
            f"sparsity method {cfg.sparsity.method!r} is not ported yet")
    masks: dict = {}
    active: dict = {}
    for s in registry:
        k = D.fan_in_from_density(s.d_in, s.density)
        mask = topology.random_constant_fan_in_mask(generator, s.d_in, s.d_out, k,
                                                    lead=s.lead)
        set_path(masks, s.path, mask)
        set_path(active, s.path, torch.ones((*s.lead, s.d_out), dtype=torch.bool,
                                            device=generator.device))
    return {"masks": masks, "neuron_active": active}
