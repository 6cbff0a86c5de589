"""Primitive layers: norms, init, RoPE, sparse-aware linear apply (port of
``repro/models/layers.py``).

Functions on tensors with the reference's signatures (RoPE and the
three-stream M-RoPE among them); random init draws
from an explicit ``torch.Generator`` on the generator's device. In place of
a generator, ``torch.device("meta")`` builds the same shapes and dtypes
with no storage and no draw (the dry run's, ``launch/dryrun.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

from repro_torch.core.srigl import apply_mask_for_forward
from repro_torch.sparse import formats as F


def init_device(generator) -> torch.device:
    """The device an init builds on: the generator's, or the meta device
    passed in its place."""
    if isinstance(generator, torch.device):
        if generator.type != "meta":
            raise TypeError(f"an init takes a torch.Generator or the meta device, "
                            f"not {generator}")
        return generator
    return generator.device


def normal(generator, shape: tuple[int, ...]) -> torch.Tensor:
    """Standard normal float32 draws of ``shape`` from ``generator`` on its
    device; on the meta device (``init_device``) a tensor of that shape with
    no storage, and nothing drawn."""
    device = init_device(generator)
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=generator, device=device)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, *, lead: tuple[int, ...] = ()) -> torch.Tensor:
    """Normal init, std = 1/sqrt(d_in), shape (*lead, d_in, d_out)."""
    w = normal(generator, (*lead, d_in, d_out))
    return (w / d_in ** 0.5).to(dtype)


def sparse_init(generator: torch.Generator, d_in: int, d_out: int, k: int,
                dtype=torch.float32, *, lead: tuple[int, ...] = ()) -> torch.Tensor:
    """Fan-in-aware init for sparse layers (Evci et al. 2022): std = 1/sqrt(k)."""
    w = normal(generator, (*lead, d_in, d_out))
    return (w / max(k, 1) ** 0.5).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, *, lead: tuple[int, ...] = ()) -> torch.Tensor:
    """Normal init, std 0.02, shape (*lead, vocab, d)."""
    w = normal(generator, (*lead, vocab, d))
    return (w * 0.02).to(dtype)


def linear(x: torch.Tensor, w: torch.Tensor, mask=None) -> torch.Tensor:
    """y = x @ (w masked if sparse), dispatching on the serving leaf's type.

    * a ``formats.SparseFormat`` — the format executes itself (a condensed,
      condensed-over-active or structured kernel, or the masked matmul).
    * bool tensor — masked-dense ``torch.matmul`` on ``w * mask``.
    * None — dense.

    The weight is cast to ``x.dtype``; that is a no-op for a serving copy
    already stored at the compute dtype (``model.serving_params``).
    """
    if isinstance(mask, F.SparseFormat):
        return mask.apply(x, w)
    if mask is not None:
        w = apply_mask_for_forward(w, mask)
    return torch.matmul(x, w.to(x.dtype))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Zero-centred RMSNorm, ``x * (1 + scale)``, computed in float32."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, D); positions: broadcastable to (..., T)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)                # (D/2,)
    ang = positions[..., None].float() * freqs                   # (..., T, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(2, 1, 1)) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): three position streams (t, h, w) over the
    D/2 frequency bands.

    x: (B, T, H, D); positions: (3, B, T). The bands are split in proportion
    to ``sections``, the last band taking the remainder, and each band turns
    by its own stream's positions.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)                # (D/2,)
    n = d // 2
    total = sum(sections)
    bounds, acc = [], 0
    for s in sections:
        bounds.append((acc, acc + (n * s) // total))
        acc = bounds[-1][1]
    bounds[-1] = (bounds[-1][0], n)
    ang = torch.cat([positions[axis][..., None].float() * freqs[lo:hi]
                     for axis, (lo, hi) in enumerate(bounds)], dim=-1)   # (B, T, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :n], x[..., n:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return Fn.silu(gate) * up
