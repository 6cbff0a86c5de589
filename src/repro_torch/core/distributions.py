"""Per-layer sparsity distributions (ERK, uniform) — Evci et al. 2021 / Mocanu et al. 2018.

A copy of ``repro/core/distributions.py``: given a global target sparsity S
and the sparsifiable layers, assign each layer a density so that the
parameter-weighted mean density equals (1 - S). ERK scores a linear layer of
shape (d_in, d_out) by (d_in + d_out) / (d_in * d_out); layers whose density
would exceed 1.0 are clamped dense and the remaining budget is re-solved.
Pure Python, so the densities and integer fan-ins equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """Static description of one sparsifiable weight tensor."""

    name: str
    d_in: int   # fan-in of each output unit
    d_out: int  # number of output units (neurons)
    n_replicas: int = 1  # e.g. layers of one stack sharing this shape

    @property
    def n_params(self) -> int:
        return self.d_in * self.d_out * self.n_replicas

    @property
    def er_score(self) -> float:
        return (self.d_in + self.d_out) / (self.d_in * self.d_out)


def uniform_densities(layers: Sequence[LayerShape], sparsity: float) -> dict[str, float]:
    """Every layer gets the same density 1 - sparsity."""
    _check_sparsity(sparsity)
    return {l.name: 1.0 - sparsity for l in layers}


def erk_densities(layers: Sequence[LayerShape], sparsity: float) -> dict[str, float]:
    """ERK densities: density_l = eps * er_score_l, eps solved for the global budget.

    Iteratively clamps layers that would exceed density 1.0.
    """
    _check_sparsity(sparsity)
    if not layers:
        return {}
    total_params = sum(l.n_params for l in layers)
    budget = (1.0 - sparsity) * total_params

    dense_set: set[str] = set()
    while True:
        dense_params = sum(l.n_params for l in layers if l.name in dense_set)
        free_layers = [l for l in layers if l.name not in dense_set]
        if not free_layers:
            break
        denom = sum(l.er_score * l.n_params for l in free_layers)
        eps = (budget - dense_params) / max(denom, 1e-12)
        overflow = [l for l in free_layers if eps * l.er_score > 1.0]
        if not overflow:
            break
        dense_set.update(l.name for l in overflow)

    out: dict[str, float] = {}
    for l in layers:
        if l.name in dense_set:
            out[l.name] = 1.0
        else:
            out[l.name] = max(min(eps * l.er_score, 1.0), 0.0)
    return out


def fan_in_from_density(d_in: int, density: float) -> int:
    """Constant fan-in k for a layer: at least 1 non-zero per neuron."""
    return max(1, round(density * d_in))


def _check_sparsity(sparsity: float) -> None:
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
