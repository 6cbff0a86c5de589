"""PyTorch/CUDA port of the SRigL sparse-training and serving system.

The package mirrors ``src/repro`` module for module (``configs``, ``core``,
``sparse``, ``kernels``, ``models``, ``launch``) so each function has one
counterpart there, with the same signature and the same stacked tensor
layout. It imports ``torch`` and never ``jax``, and nothing of the ``repro``
package: the configs and the sparsity math it needs are its own copies.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
without a card and without that request they raise instead of quietly
running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises if CUDA is requested (explicitly or by default) and there is no
    card: a serving run never drops to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
