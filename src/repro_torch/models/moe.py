"""Top-k MoE with GShard-style capacity routing (port of ``repro/models/moe.py``).

Tokens go in groups of ``min(group_size, B * T)``; each group dispatches to
a per-expert capacity buffer with one-hot einsums, the reference's
formulation. Tokens over an expert's capacity are dropped (capacity factor
1.25 by default); a decode group of at most 8 rows has capacity equal to
the group, so nothing is dropped there.

Experts are SwiGLU FFNs stored stacked ``(E, d, ff)``, so SRigL treats each
expert as its own constant fan-in matrix. The reference runs the experts
with ``jax.vmap``; here each sparse linear takes the whole expert axis at
once: a bool mask as a batched masked product, a format leaf whose arrays
carry the expert axis first through its expert-grouped launch, one launch
per stack and call (``formats.Condensed``: K1-moe / K2-moe,
``CondensedOverActive``: K4-moe / K2-coa-moe, ``StructuredFanIn``: K5-moe
/ K6-moe; ``kernels.ops.*_grouped``), differentiable in ``xe`` and the
leaves as the reference's vmapped custom VJPs are.

Routing has no data-dependent shape and no host sync (top-k by a stable
sort, one-hot by comparison with an ``arange``, the slot loop over the k
choices unrolled), so a decode step with experts is one captured CUDA
graph. A load-balancing auxiliary loss (Switch Transformer eq. 4) is
returned for the trainer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import layers as L


class MoEParams(NamedTuple):
    router: torch.Tensor   # (d_model, E), float32
    w_gate: torch.Tensor   # (E, d_model, ff)
    w_up: torch.Tensor     # (E, d_model, ff)
    w_down: torch.Tensor   # (E, ff, d_model)


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int, n_experts: int,
                    k_fan_in: dict | None = None, dtype=torch.float32, *,
                    lead: tuple[int, ...] = ()) -> MoEParams:
    """Normal init on ``generator``'s device: each expert weight with std
    1/sqrt(its fan-in, from ``k_fan_in``, else the dense fan-in), the
    router dense and float32. ``lead`` stacks the blocks (e.g. ``(L,)``)."""
    kf = k_fan_in or {}

    def init(a: int, b: int, fan: int) -> torch.Tensor:
        w = L.normal(generator, (*lead, n_experts, a, b))
        return (w / max(fan, 1) ** 0.5).to(dtype)

    return MoEParams(
        router=L.dense_init(generator, d_model, n_experts, torch.float32, lead=lead),
        w_gate=init(d_model, d_ff, kf.get("w_gate", d_model)),
        w_up=init(d_model, d_ff, kf.get("w_up", d_model)),
        w_down=init(d_ff, d_model, kf.get("w_down", d_ff)),
    )


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``idx[..., None] == arange(n)`` at ``dtype``: no bounds check, so no
    device sync (an index outside [0, n) gives a row of zeros)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis and their indices, in
    descending order, equal entries by the lower index first (the order of
    ``jax.lax.top_k``; ``torch.topk`` promises none): a stable descending
    sort, cut to ``k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_topk(logits: torch.Tensor, top_k_experts: int, capacity: int):
    """GShard top-k routing for the groups.

    logits: (G, S, E). Returns (dispatch (G, S, E, C) bool, combine (G, S,
    E, C) float32, aux_loss float32 scalar). A token's j-th choice takes
    the next free slot of its expert after every earlier token's j-th
    choice and every token's earlier choices (the sequential slot loop);
    past ``capacity`` it is dropped.
    """
    g, s, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = top_k(probs, top_k_experts)                 # (G, S, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    counts = torch.zeros((g, e), dtype=torch.int64, device=logits.device)
    dispatch = torch.zeros((g, s, e, capacity), dtype=torch.bool, device=logits.device)
    combine = torch.zeros((g, s, e, capacity), dtype=torch.float32, device=logits.device)
    for j in range(top_k_experts):
        onehot = _one_hot(gate_idx[:, :, j], e, torch.int64)          # (G, S, E)
        pos = torch.cumsum(onehot, dim=1) - onehot + counts[:, None, :]  # slot per token
        counts = counts + onehot.sum(dim=1)
        keep = (pos < capacity) & (onehot > 0)
        slot = pos.clamp(0, capacity - 1)
        slot_oh = _one_hot(slot, capacity, torch.float32) * keep[..., None]
        dispatch = dispatch | (slot_oh > 0)
        combine = combine + gate_vals[:, :, j, None, None] * slot_oh

    # load-balance aux loss: E * sum_e f_e * p_e (Switch Transformer eq. 4)
    me = probs.mean(dim=(0, 1))                                       # mean router prob
    ce = _one_hot(gate_idx[:, :, 0], e, torch.float32).mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)
    return dispatch, combine, aux


def capacity_for(cfg, group: int) -> int:
    """Slots an expert holds in a group of ``group`` tokens: ceil(group * k
    * cf / E), at least k (tiny decode groups are never starved) and at
    most the group (a token takes each chosen expert once, so capacity ==
    group drops nothing)."""
    e, k = cfg.n_experts, cfg.top_k_experts
    return min(group, max(-(-group * k * int(100 * cfg.capacity_factor) // (100 * e)), k))


def moe_block(cfg, params: MoEParams, x: torch.Tensor, masks: dict | None = None,
              group_size: int = 2048):
    """x: (B, T, d) -> (y (B, T, d), aux_loss).

    ``masks`` holds the expert stacks' serving leaves (``w_gate``, ``w_up``,
    ``w_down``): bool masks (E, d, ff), formats whose arrays carry the
    expert axis first, or nothing (dense). The router is float32, cast to
    x's dtype before its product; dispatch and combine are cast to x's
    dtype before their einsums, as in the reference.
    """
    m = masks or {}
    b, t, d = x.shape
    n_tok = b * t
    gs = min(group_size, n_tok)
    n_groups = n_tok // gs
    if n_groups * gs != n_tok:
        raise AssertionError(f"tokens {n_tok} not divisible by group {gs}")
    e, k = cfg.n_experts, cfg.top_k_experts
    capacity = capacity_for(cfg, gs)

    xt = x.reshape(n_groups, gs, d)
    logits = torch.matmul(xt, params.router.to(x.dtype))              # (G, S, E)
    dispatch, combine, aux = route_topk(logits, k, capacity)

    # dispatch: (G, S, E, C) x (G, S, d) -> (E, G, C, d), the experts' rows
    # flattened to (E, G * C, d) for the batched linears
    xe = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), xt)
    xe = xe.reshape(e, n_groups * capacity, d)
    gate = L.linear(xe, params.w_gate, m.get("w_gate"))
    up = L.linear(xe, params.w_up, m.get("w_up"))
    ye = L.linear(L.swiglu(gate, up), params.w_down, m.get("w_down"))
    ye = ye.reshape(e, n_groups, capacity, d)

    # combine: (G, S, E, C) x (E, G, C, d) -> (G, S, d)
    y = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), ye)
    return y.reshape(b, t, d), aux
