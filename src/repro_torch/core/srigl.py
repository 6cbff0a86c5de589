"""SRigL pieces the serving path needs (port of ``repro/core/srigl.py``).

Only the forward masking is ported so far; the topology update
(``srigl_update``) comes with the training slice.
"""
from __future__ import annotations

import torch


def apply_mask_for_forward(weight: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked weight ``w * mask``.

    The reference writes this as ``w - stop_gradient(w * (1 - m))`` so the
    gradient stays dense (straight-through on the mask); its forward value
    is exactly ``w * mask``, which is what serving needs.
    """
    return weight * mask
