"""Gradient compression with error feedback (port of
``repro/optim/grad_compress.py``).

Across nodes the data-parallel gradient all-reduce is the slowest link per
byte. Compressing gradients to bf16 (or int8 with a per-tensor scale)
before the reduction halves (or quarters) those bytes; the quantization
error is fed back into the next step's gradient (error feedback, EF-SGD) so
convergence is preserved. Trees are nested dicts of tensors, as the
trainer's params are; an int8 leaf compresses to a ``(codes, scale)`` pair.
"""
from __future__ import annotations

import torch


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (the first's keys)."""
    return {k: _map(fn, *(t[k] for t in trees)) if isinstance(v, dict)
            else fn(*(t[k] for t in trees)) for k, v in trees[0].items()}


def _unzip(tree) -> tuple:
    """A tree of (compressed, error) pairs as two trees."""
    return _map(lambda t: t[0], tree), _map(lambda t: t[1], tree)


def init_error_feedback(params) -> dict:
    """bf16 zeros shaped as ``params``."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device), params)


def compress_bf16(grads, ef_state):
    """Round grads + error to bf16; returns (compressed, new error)."""
    def comp(g, e):
        g32 = g.float() + e.float()
        c = g32.to(torch.bfloat16)
        return c, (g32 - c.float()).to(torch.bfloat16)
    return _unzip(_map(comp, grads, ef_state))


def compress_int8(grads, ef_state):
    """Per-tensor symmetric int8 quantization with error feedback: scale =
    max(absmax, 1e-12) / 127 in float32, codes rounded half to even and
    clipped to +-127; returns ({leaf: (codes, scale)}, new error)."""
    def comp(g, e):
        g32 = g.float() + e.float()
        scale = torch.clamp(g32.abs().amax(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        return (q, scale), (g32 - deq).to(torch.bfloat16)
    return _unzip(_map(comp, grads, ef_state))


def decompress_int8(comp):
    """float32 gradients from ``compress_int8``'s (codes, scale) leaves."""
    return _map(lambda t: t[0].float() * t[1], comp)
