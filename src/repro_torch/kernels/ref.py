"""Plain PyTorch versions of the port's kernels.

Each is the CPU path of its kernel's wrapper and the yardstick the kernel is
held to on the card. They follow the Hopper kernels' numerics, which are the
TPU kernels' numerics, not those of ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch


def condensed_matmul_ref(x: torch.Tensor, values: torch.Tensor,
                         indices: torch.Tensor) -> torch.Tensor:
    """Condensed constant fan-in matmul (paper Alg. 1 / Eq. 30-31).

    x       : (B, d_in)
    values  : (n_out, k)   non-zero weights per neuron
    indices : (n_out, k)   int — input feature index of each non-zero
    returns : (B, n_out)   out[b, n] = sum_k f32(x[b, indices[n, k]]) * f32(values[n, k])

    Gathers x at the indices, multiplies in float32, sums over k in float32
    and casts to ``x.dtype`` — the order of
    ``repro/kernels/condensed_matmul.py::_fwd_kernel``. (The reference's
    ``condensed_matmul_ref`` multiplies in ``x.dtype`` instead.)
    """
    gathered = x[:, indices.long()].float()              # (B, n_out, k)
    acc = (gathered * values.float()[None]).sum(dim=-1)  # f32 accumulate
    return acc.to(x.dtype)
