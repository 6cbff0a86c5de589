"""Registry of sparsifiable layers per architecture (port of ``repro/sparse/registry.py``).

The registry enumerates every sparse weight *stack* (a group of
identically-shaped layers stacked on leading dims, e.g. ``("blocks",
"w_gate")`` with ``lead=(L,)``) and solves the ERK (or uniform) densities
over the stacks. Paper defaults: MLP and attention-output projections are
sparse; QKV input projections, norms and embeddings stay dense.

Ported so far: the dense family's enumeration, ``k_fan_map``, the tree path
helpers, SRigL mask initialization, the SRigL topology update over every
stack (``dst_update``) and ``sparsity_summary``. The RigL and SET updates
are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core import distributions as D
from repro_torch.core import srigl as S
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

    def srigl_spec(self, cfg) -> S.SRigLSpec:
        sp = cfg.sparsity
        return S.SRigLSpec(
            name=self.name, d_in=self.d_in, d_out=self.d_out,
            density=self.density, gamma_sal=sp.gamma_sal, ablation=sp.ablation)


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


def _map_over_lead(fn, n_lead: int, *args):
    """``fn`` on one layer slab at a time along the FIRST leading axis (the
    reference's ``lax.map``), its (LayerState, UpdateStats) stacked; inner
    leading axes go to ``fn`` whole. Selection temporaries then stay at one
    slab's size."""
    if n_lead == 0:
        return fn(*args)
    outs = [fn(*xs) for xs in zip(*args)]
    return (S.LayerState(*(torch.stack(t) for t in zip(*(o[0] for o in outs)))),
            S.UpdateStats(*(torch.stack(t) for t in zip(*(o[1] for o in outs)))))


def dst_update(cfg, registry: Sequence[SparseStack], params: dict, grads: dict,
               state: dict, drop_fraction, rng=None):
    """One topology update across every sparse stack.

    Run on its own every delta_t steps (not inside the train step), one
    layer slab at a time, with the float32 casts made per slab. ``rng`` is
    the reference's key argument, which only its SET update reads.
    Returns (new_state, stats keyed by stack name: each an ``UpdateStats``
    field as an int32 tensor over the stack's leading dims).
    """
    method = cfg.sparsity.method
    if method != "srigl":
        raise NotImplementedError(f"the {method!r} topology update is not ported yet")
    new_masks, new_active, stats = {}, {}, {}
    for s in registry:
        spec = s.srigl_spec(cfg)

        def fn(w_, g_, m_, a_, spec=spec):
            return S.srigl_update(spec, w_.float(), g_.float(), S.LayerState(m_, a_),
                                  drop_fraction)
        st, sts = _map_over_lead(fn, len(s.lead), get_path(params, s.path),
                                 get_path(grads, s.path), get_path(state["masks"], s.path),
                                 get_path(state["neuron_active"], s.path))
        set_path(new_masks, s.path, st.mask)
        set_path(new_active, s.path, st.neuron_active)
        stats[s.name] = dict(sts._asdict())
    return {"masks": new_masks, "neuron_active": new_active}, stats


def sparsity_summary(registry: Sequence[SparseStack], state: dict) -> dict:
    """Host-side summary: realized density and active-neuron fraction per stack."""
    out = {}
    for s in registry:
        m = get_path(state["masks"], s.path)
        a = get_path(state["neuron_active"], s.path)
        out[s.name] = {
            "density": float(m.float().mean()),
            "target_density": s.density,
            "active_neurons": float(a.float().mean()),
        }
    return out
