"""SRigL — Structured RigL (Lasby et al., ICLR 2024), Section 3.1 (port of
``repro/core/srigl.py``).

A sparse-to-sparse DST update that keeps a **constant fan-in** topology
(every active output neuron has exactly ``k`` non-zero incoming weights)
and performs **dynamic neuron ablation** controlled by ``gamma_sal``. The
seven steps of the paper, as the reference's module docstring maps them:

  1. prune criterion |W| (active), grow criterion |G| (inactive)
  2. K = drop_fraction * nnz (per layer, cosine-annealed)
  3. per-neuron salient count: survivors-of-prune + top-K-gradients
  4. ablate neurons with fewer than max(1, ceil(gamma_sal * k)) salient weights
  5. new fan-in k' = floor(target_nnz / n_active')
  6. layer-wise prune of the K smallest-magnitude active weights
  7. per-neuron regrow by decreasing |G| until fan-in k'

Steps 6 and 7 are one per-column priority ranking: prune survivors
outrank grow candidates (by |G|), which outrank freshly pruned weights (a
backup tier, so a column always fills to k'). Every selection is an
integer count, a float32 compare or a stable sort, so the masks equal the
reference's on equal inputs. Counts stay on the device: nothing here waits
for it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import saliency


@dataclasses.dataclass(frozen=True)
class SRigLSpec:
    """Static per-layer configuration for SRigL."""

    name: str
    d_in: int
    d_out: int
    density: float              # from the ERK / uniform distribution
    gamma_sal: float = 0.3      # min fraction of salient weights per neuron
    ablation: bool = True       # neuron ablation enabled (SRigL w/ ablation)
    min_active_neurons: int = 1  # never ablate the whole layer

    @property
    def k0(self) -> int:
        """Initial constant fan-in."""
        return max(1, round(self.density * self.d_in))

    @property
    def target_nnz(self) -> int:
        """Per-neuron-matrix non-zero budget, constant through training."""
        return self.k0 * self.d_out


class LayerState(NamedTuple):
    """Dynamic per-layer DST state."""

    mask: torch.Tensor           # bool (d_in, d_out)
    neuron_active: torch.Tensor  # bool (d_out,)


class UpdateStats(NamedTuple):
    """int32 counts of one update (stacked along the leading dims)."""

    n_pruned: torch.Tensor
    n_grown: torch.Tensor
    n_ablated: torch.Tensor
    fan_in: torch.Tensor
    nnz: torch.Tensor


def init_layer_state(generator: torch.Generator, spec: SRigLSpec) -> LayerState:
    from repro_torch.core import topology

    mask = topology.random_constant_fan_in_mask(generator, spec.d_in, spec.d_out, spec.k0)
    return LayerState(mask=mask, neuron_active=torch.ones((spec.d_out,), dtype=torch.bool,
                                                          device=mask.device))


def _count(b: torch.Tensor, dim=None) -> torch.Tensor:
    return b.sum(dtype=torch.int32) if dim is None else b.sum(dim=dim, dtype=torch.int32)


def srigl_update(spec: SRigLSpec, weight: torch.Tensor, dense_grad: torch.Tensor,
                 state: LayerState, drop_fraction) -> tuple[LayerState, UpdateStats]:
    """One SRigL topology update for a single (d_in, d_out) layer, float32.

    A weight with one leading axis (stacked replicas) runs the update on
    each replica in turn, as the reference vmaps it. ``drop_fraction`` is a
    float32 scalar (``DSTSchedule.drop_fraction``).
    """
    if weight.ndim == 3:
        outs = [srigl_update(spec, w, g, LayerState(m, a), drop_fraction)
                for w, g, m, a in zip(weight, dense_grad, state.mask, state.neuron_active)]
        st = LayerState(*(torch.stack(t) for t in zip(*(o[0] for o in outs))))
        return st, UpdateStats(*(torch.stack(t) for t in zip(*(o[1] for o in outs))))

    dev = weight.device
    f32 = torch.float32
    mask, active_old = state.mask, state.neuron_active
    w_mag = weight.abs()
    g_mag = dense_grad.abs()

    # -- step 2: number of weights to prune and grow this update ------------
    nnz = _count(mask)
    drop = torch.tensor(drop_fraction, dtype=f32, device=dev)
    n_prune = torch.floor(drop * nnz.to(f32)).to(torch.int32)

    # -- step 6 (criterion side): survivors of the layer-wise prune ---------
    survive = saliency.select_topk_threshold(w_mag, mask, nnz - n_prune)

    # -- steps 1 and 3: per-neuron salient counts ----------------------------
    grow_salient = saliency.select_topk_threshold(g_mag, ~mask, n_prune)
    sal_per_neuron = _count(survive, 0) + _count(grow_salient, 0)

    # -- step 4: ablation ---------------------------------------------------
    n_active_old = torch.clamp(_count(active_old), min=1)
    k_cur = torch.clamp(torch.div(nnz, n_active_old, rounding_mode="floor"), min=1)
    tau = torch.clamp(torch.ceil(torch.tensor(spec.gamma_sal, dtype=f32, device=dev)
                                 * k_cur.to(f32)), min=1.0)
    if spec.ablation:
        active_new = sal_per_neuron.to(f32) >= tau
        # never ablate below min_active_neurons: force-keep the most salient
        neuron_rank = saliency.descending_ranks(sal_per_neuron.to(f32))
        active_new = active_new | (neuron_rank < spec.min_active_neurons)
    else:
        active_new = torch.ones_like(active_old)

    # -- step 5: new constant fan-in (floor keeps nnz <= target_nnz) --------
    n_active_new = torch.clamp(_count(active_new), min=1)
    k_new = torch.clamp(torch.div(spec.target_nnz, n_active_new, rounding_mode="floor"),
                        1, spec.d_in).to(torch.int32)

    # -- steps 6 and 7: the new mask by per-column priority ------------------
    w_norm = saliency.normalized(weight, mask)       # in [0, 1]
    g_norm = saliency.normalized(dense_grad, ~mask)  # in [0, 1]
    two = torch.tensor(2.0, dtype=f32, device=dev)
    priority = torch.where(survive, two + w_norm,             # tier 3: prune survivors
                           torch.where(~mask, g_norm,         # tier 2: grow by |G|
                                       -two + w_norm))        # tier 1: freshly pruned
    col_rank = saliency.descending_ranks(priority, axis=0)
    new_mask = (col_rank < k_new) & active_new[None, :]

    stats = UpdateStats(
        n_pruned=_count(mask & ~new_mask),
        n_grown=_count(~mask & new_mask),
        n_ablated=_count(active_old & ~active_new),
        fan_in=k_new,
        nnz=_count(new_mask),
    )
    return LayerState(mask=new_mask, neuron_active=active_new), stats


class _StraightThroughMask(torch.autograd.Function):
    """forward: the select ``where(mask & (w != 0), w, +0)``; backward: the
    gradient passed through unmasked."""

    @staticmethod
    def forward(ctx, weight, mask):
        return torch.where(mask & (weight != 0), weight,
                           torch.zeros((), dtype=weight.dtype, device=weight.device))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def apply_mask_for_forward(weight: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked weight whose *gradient is dense* (straight-through on the mask).

    forward:  w * mask, with +0 at masked positions and for an unmasked
              -0.0, as the reference's ``w - stop_gradient(w * (1 - m))``
              gives (one select, where the reference runs three full-size
              passes)
    backward: dL/dw = dL/d(w * mask), unmasked — the dense gradient the
              SRigL grow criterion needs. The optimizer re-masks.
    """
    return _StraightThroughMask.apply(weight, mask.to(torch.bool))
