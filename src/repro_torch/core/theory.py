"""Output-norm variance theory (paper Appendix A/B, Eqs. 1-3) and its
Monte-Carlo check (port of ``repro/core/theory.py``).

For a ReLU layer z = sqrt(2/k) (W ⊙ I)(ξ ⊙ u) with n neurons and mean
fan-in k, E[||z||^2 / ||u||^2] = 1 and the variance depends on the sparsity
*structure*:

  Bernoulli            Var = (5n - 8 + 18 n/k) / (n (n+2))                 (1)
  Constant-per-layer   Var = ((n^2+7n-8) C_{n,k} + 18 n/k - n^2 - 2n)
                             / (n (n+2)),  C_{n,k} = (n - 1/k)/(n - 1/n)   (2)
  Constant fan-in      Var = Bernoulli - 3 (n-k) / (k n (n+2))             (3)

The paper's main-text Eqs. (1)-(2) print the third term as ``18 k/n``; the
Appendix B derivations (Props. B.4-B.6) and the simulation both give
``18 n/k``, which is what is implemented here, as in the reference.

Constant fan-in always has the smallest variance, the paper's theoretical
motivation for SRigL. The simulator draws the three index-matrix ensembles
from a ``torch.Generator`` and estimates Var(||z||^2) (Fig. 1b) in float32.
"""
from __future__ import annotations

import numpy as np
import torch


def var_bernoulli(n: int, k: int) -> float:
    return (5 * n - 8 + 18 * n / k) / (n * (n + 2))


def c_nk(n: int, k: int) -> float:
    return (n - 1 / k) / (n - 1 / n)


def var_const_per_layer(n: int, k: int) -> float:
    return ((n**2 + 7 * n - 8) * c_nk(n, k) + 18 * n / k - n**2 - 2 * n) / (n * (n + 2))


def var_const_fan_in(n: int, k: int) -> float:
    return var_bernoulli(n, k) - 3 * (n - k) / (k * n * (n + 2))


def _sample_index_matrices(generator: torch.Generator, s: int, n: int, k: int,
                           kind: str) -> torch.Tensor:
    """``s`` index matrices (s, n, n) of one ensemble."""
    dev = generator.device
    if kind == "bernoulli":
        return torch.rand((s, n, n), generator=generator, device=dev) < k / n
    if kind == "const_per_layer":  # exactly k * n ones per matrix
        top = torch.rand((s, n * n), generator=generator, device=dev).topk(k * n, dim=-1)
        flat = torch.zeros((s, n * n), dtype=torch.bool, device=dev)
        return flat.scatter_(-1, top.indices, True).reshape(s, n, n)
    if kind == "const_fan_in":  # exactly k ones per row, rows independent
        top = torch.rand((s, n, n), generator=generator, device=dev).topk(k, dim=-1)
        ind = torch.zeros((s, n, n), dtype=torch.bool, device=dev)
        return ind.scatter_(-1, top.indices, True)
    raise ValueError(kind)


def simulate_output_norm_var(generator: torch.Generator, n: int, k: int, kind: str,
                             n_samples: int = 2000, chunk: int = 256) -> float:
    """Empirical Var(||z||^2) for the given sparsity ensemble, the samples
    drawn ``chunk`` at a time (each holds three (chunk, n, n) tensors)."""
    dev = generator.device
    norms = []
    for start in range(0, n_samples, chunk):
        s = min(chunk, n_samples - start)
        u = torch.randn((s, n), generator=generator, device=dev)
        u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)  # uniform on the sphere
        xi = torch.rand((s, n), generator=generator, device=dev) < 0.5  # half active
        ind = _sample_index_matrices(generator, s, n, k, kind)
        w = torch.randn((s, n, n), generator=generator, device=dev)
        z = (2.0 / k) ** 0.5 * ((w * ind) @ (xi * u)[..., None])[..., 0]
        norms.append((z * z).sum(-1))
    return float(torch.cat(norms).var(correction=0))


def theory_table(n: int, ks: list[int]) -> np.ndarray:
    """Rows: k; cols: [bernoulli, const_per_layer, const_fan_in] variances."""
    return np.array(
        [[var_bernoulli(n, k), var_const_per_layer(n, k), var_const_fan_in(n, k)] for k in ks]
    )
