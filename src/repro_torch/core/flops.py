"""FLOPs accounting following the paper's methodology (Table 5, Appendix G)
(port of ``repro/core/flops.py``; pure Python).

Only operations induced by linear/matmul layers count (activations, adds,
pools and norms are ignored, per Evci et al. 2021's MicroNet-style count).
Sparse layers count 2 * nnz FLOPs per token for the forward pass; the
backward pass costs 2x the forward (grad-wrt-input + grad-wrt-weight
matmuls), so one training step costs 3x inference. DST mask updates are
amortized over delta_t steps and ignored (paper App. G).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class LinearCost:
    name: str
    d_in: int
    d_out: int
    density: float = 1.0     # fraction of weights active
    n_replicas: int = 1      # experts etc.
    tokens_scale: float = 1.0  # fraction of tokens hitting this layer (MoE top-k/E)

    @property
    def nnz(self) -> float:
        return self.d_in * self.d_out * self.density * self.n_replicas

    def fwd_flops_per_token(self) -> float:
        return 2.0 * self.d_in * self.d_out * self.density * self.tokens_scale * (
            self.n_replicas if self.tokens_scale == 1.0 else 1.0
        )


def inference_flops(layers: Sequence[LinearCost], tokens: int) -> float:
    """Forward FLOPs for ``tokens`` tokens."""
    return tokens * sum(l.fwd_flops_per_token() for l in layers)


def training_flops(layers: Sequence[LinearCost], tokens_per_step: int, steps: int) -> float:
    """fwd + 2x bwd = 3x fwd, as in the paper's Table 5 methodology."""
    return 3.0 * steps * inference_flops(layers, tokens_per_step)


def sparse_vs_dense_ratio(layers: Sequence[LinearCost]) -> float:
    """FLOPs ratio sparse/dense for one forward pass (Table 5 column ratio)."""
    sparse = sum(l.fwd_flops_per_token() for l in layers)
    dense = sum(
        dataclasses.replace(l, density=1.0).fwd_flops_per_token() for l in layers
    )
    return sparse / max(dense, 1e-12)
