"""Registry of sparsifiable layers per architecture (port of ``repro/sparse/registry.py``).

The registry enumerates every sparse weight *stack* (a group of
identically-shaped layers stacked on leading dims, e.g. ``("blocks",
"w_gate")`` with ``lead=(L,)``, gemma3's ``("g_local", "w_gate")`` with
``lead=(g, r)``, an MoE expert stack ``("blocks", "w_gate")`` with
``lead=(L, E)``, or the hybrid's shared block ``("shared_attn",
"w_gate")`` with no leading axis, ``lead=()``) and solves the ERK (or
uniform) densities over the stacks. Paper defaults: MLP and
attention-output projections are sparse; QKV input projections, norms and
embeddings stay dense.

Ported: the dense, VLM, MoE, SSM and hybrid families' enumeration (the
``blocks`` layout, the grouped local/global one, the expert stacks, the SSM
mixers' ``in_z`` / ``in_x`` / ``out_proj``, and the hybrid's ``m_groups``
(g, r), ``m_rem`` (rem,) and ``shared_attn`` ()), ``k_fan_map``, the tree
path helpers, mask initialization and the topology update over every
stack (``dst_update``) for SRigL, RigL and SET, the ITOP tracker and
``sparsity_summary``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core import distributions as D
from repro_torch.core import rigl as R
from repro_torch.core import set_sparse as SS
from repro_torch.core import srigl as S
from repro_torch.core import topology
from repro_torch.models import model as M


@dataclasses.dataclass(frozen=True)
class SparseStack:
    path: tuple[str, ...]       # location in the params tree
    d_in: int
    d_out: int
    lead: tuple[int, ...]       # leading (stack) dims, e.g. (L,) or (L, E)
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

    def rigl_spec(self) -> R.RigLSpec:
        return R.RigLSpec(name=self.name, d_in=self.d_in, d_out=self.d_out,
                          density=self.density)


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


def _moe_stacks(cfg, prefix: tuple, lead: tuple) -> list[SparseStack]:
    """The MoE block's stacks: wo over ``lead``, the experts' SwiGLU over
    ``lead + (E,)`` (each expert its own constant fan-in matrix)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    out = _attn_stacks(cfg, prefix, lead, with_mlp=False)
    out += [
        SparseStack(prefix + ("w_gate",), d, ff, lead + (e,)),
        SparseStack(prefix + ("w_up",), d, ff, lead + (e,)),
        SparseStack(prefix + ("w_down",), ff, d, lead + (e,)),
    ]
    return out


def _ssm_stacks(cfg, prefix: tuple, lead: tuple) -> list[SparseStack]:
    """The SSM mixer's sparse linears: the z and x input projections and
    the output projection (B, C and dt stay dense)."""
    d, di = cfg.d_model, cfg.d_inner
    return [
        SparseStack(prefix + ("in_z",), d, di, lead),
        SparseStack(prefix + ("in_x",), d, di, lead),
        SparseStack(prefix + ("out_proj",), di, d, lead),
    ]


def is_expert_stack(stack: SparseStack, cfg) -> bool:
    """Whether ``stack`` holds an MoE block's experts (lead ``(L, E)``)."""
    return getattr(cfg, "family", None) == "moe" and len(stack.lead) == 2


def build_registry(cfg) -> list[SparseStack]:
    """All sparse stacks of ``cfg`` with ERK/uniform densities solved."""
    if cfg.sparsity.method == "dense":
        return []
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "audio", "vit"):
        raise ValueError(cfg.family)
    if cfg.family == "moe":
        stacks = _moe_stacks(cfg, ("blocks",), (cfg.n_layers,))
    elif cfg.family == "ssm":
        stacks = _ssm_stacks(cfg, ("blocks",), (cfg.n_layers,))
    elif cfg.family == "hybrid":
        # the Mamba2 stacks (m_groups, then m_rem), then the shared block's
        stacks = [s for key, lead in M.block_stacks(cfg)
                  for s in (_attn_stacks(cfg, (key,), lead) if key == "shared_attn"
                            else _ssm_stacks(cfg, (key,), lead))]
    else:
        # the model's block stacks: ("blocks", (L,)) (audio and vit too),
        # or gemma3's grouped ("g_local", (g, r)), ("g_global", (g,)) and
        # ("g_rem", (rem,))
        stacks = [s for key, lead in M.block_stacks(cfg)
                  for s in _attn_stacks(cfg, (key,), lead)]
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

    Masks are drawn from ``generator`` on its device: for SRigL exactly k
    True per column of every layer (k from the stack's solved density), for
    RigL and SET exactly ``target_nnz`` True per layer, uniform over it.
    """
    method = cfg.sparsity.method
    if method not in ("srigl", "rigl", "set"):
        raise ValueError(method)
    masks: dict = {}
    active: dict = {}
    for s in registry:
        if method == "srigl":
            k = D.fan_in_from_density(s.d_in, s.density)
            mask = topology.random_constant_fan_in_mask(generator, s.d_in, s.d_out, k,
                                                        lead=s.lead)
        else:  # rigl / set: unstructured
            mask = topology.random_unstructured_mask(generator, s.d_in, s.d_out,
                                                     s.rigl_spec().target_nnz, lead=s.lead)
        set_path(masks, s.path, mask)
        set_path(active, s.path, torch.ones((*s.lead, s.d_out), dtype=torch.bool,
                                            device=generator.device))
    return {"masks": masks, "neuron_active": active}


def _map_over_lead(fn, n_lead: int, *args):
    """``fn`` on one layer slab at a time along the FIRST leading axis (the
    reference's ``lax.map``), its (state, stats) stacked; inner leading axes
    go to ``fn`` whole. Selection temporaries then stay at one slab's size.
    A stack with no leading axis (the hybrid's shared block) is one slab."""
    if n_lead == 0:
        return fn(*args)
    return R.stack_stats([fn(*xs) for xs in zip(*args)])


def dst_update(cfg, registry: Sequence[SparseStack], params: dict, grads: dict,
               state: dict, drop_fraction, rng: torch.Generator | None = None):
    """One topology update across every sparse stack.

    Run on its own every delta_t steps (not inside the train step), one
    layer slab at a time, with the float32 casts made per slab. ``rng`` is
    the generator SET draws its regrowth scores from (stack after stack,
    layer after layer); SRigL and RigL read nothing random, and SET reads
    no gradient (``grads`` may be empty). RigL and SET carry
    ``neuron_active`` unchanged. Returns (new_state, stats keyed by
    stack name: a dict of int32 tensors over the stack's leading dims).
    """
    method = cfg.sparsity.method
    if method not in ("srigl", "rigl", "set"):
        raise ValueError(method)
    if method == "set" and rng is None:
        raise ValueError("the SET update draws its regrowth from a torch.Generator (rng=)")
    new_masks, new_active, stats = {}, {}, {}
    for s in registry:
        w = get_path(params, s.path)
        m, a = get_path(state["masks"], s.path), get_path(state["neuron_active"], s.path)
        g = None if method == "set" else get_path(grads, s.path)
        if method == "srigl":
            spec = s.srigl_spec(cfg)

            def fn(w_, g_, m_, a_, spec=spec):
                return S.srigl_update(spec, w_.float(), g_.float(), S.LayerState(m_, a_),
                                      drop_fraction)
            st, sts = _map_over_lead(fn, len(s.lead), w, g, m, a)
            set_path(new_active, s.path, st.neuron_active)
            sts = dict(sts._asdict())
        elif method == "rigl":
            spec = s.rigl_spec()

            def fn(w_, g_, m_, spec=spec):
                return R.rigl_update(spec, w_.float(), g_.float(), R.RigLState(m_),
                                     drop_fraction)
            st, sts = _map_over_lead(fn, len(s.lead), w, g, m)
            set_path(new_active, s.path, a)
        else:
            spec = s.rigl_spec()

            def fn(w_, m_, spec=spec):
                return SS.set_update(spec, w_.float(), rng, R.RigLState(m_), drop_fraction)
            st, sts = _map_over_lead(fn, len(s.lead), w, m)
            set_path(new_active, s.path, a)
        set_path(new_masks, s.path, st.mask)
        stats[s.name] = sts
    return {"masks": new_masks, "neuron_active": new_active}, stats


def _map_tree(fn, *trees) -> dict:
    """``fn`` over the leaves of trees of one structure (the first's keys)."""
    return {k: _map_tree(fn, *(t[k] for t in trees)) if isinstance(v, dict)
            else fn(*(t[k] for t in trees)) for k, v in trees[0].items()}


def init_itop(registry: Sequence[SparseStack], state: dict) -> dict:
    """In-Time Overparameterization tracker (Liu et al. 2021c; paper App. H):
    the union of all masks seen so far, starting as a copy of the current
    masks. ITOP rate = |union| / |weights|."""
    return _map_tree(torch.clone, state["masks"])


def update_itop(itop: dict, masks: dict) -> dict:
    """The union tracked so far with ``masks``."""
    return _map_tree(torch.logical_or, itop, masks)


def itop_rate(registry: Sequence[SparseStack], itop: dict) -> dict:
    """Per stack, the fraction of its weights ever active: the union's count
    in float32 over the weight count in float32."""
    out = {}
    for s in registry:
        u = get_path(itop, s.path)
        out[s.name] = float(u.sum(dtype=torch.int64).to(torch.float32) / u.numel())
    return out


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
