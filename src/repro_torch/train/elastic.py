"""Elastic scaling and fault-domain utilities (port of
``repro/train/elastic.py``).

Checkpoints are stored mesh-agnostic (``train/checkpoint.py``), so elastic
scaling is: (1) find the devices that answer (``device_health``), (2) pick
the grid with ``largest_feasible_mesh``, (3) rebuild the state for it, (4)
restore the checkpoint into that template (``remesh``). DST state (masks,
``neuron_active``) travels with its weights, path for path.

Straggler mitigation (the Trainer's step-time watch): a checkpoint cadence
aligned with delta_t keeps the restart penalty below one DST period; a
spare takes over a failed data-parallel rank by replaying from
(step // ckpt_every) * ckpt_every.
"""
from __future__ import annotations

import torch


def largest_feasible_mesh(n_devices: int, model_parallel: int) -> tuple[int, int]:
    """Greatest (data, model) grid with model fixed and data = n // model.

    Elastic restarts keep the model-parallel degree (weight shards must stay
    rectangular) and absorb device loss in the data axis; leftover devices
    idle until the next maintenance window.
    """
    model = model_parallel
    data = max(1, n_devices // model)
    return (data, model)


def remesh(template_state, ckpt_dir: str, step: int, make_state_fn):
    """Restore a checkpoint onto the current device set.

    ``make_state_fn()`` builds a state for the new layout (tensors on their
    devices); the checkpoint's values are then written into it. The first
    argument is the reference's and is unused, as there.
    """
    from repro_torch.train import checkpoint as CKPT
    return CKPT.restore(ckpt_dir, step, make_state_fn())


def device_health(devices=None) -> dict:
    """Cheap liveness probe of each CUDA device: {"cuda:i": bool}, True when
    a one-element tensor placed there reads back as 1.

    ``devices`` defaults to every visible CUDA device; with no card the
    result is ``{}``. The CPU is never probed in a card's place: a device
    that is not CUDA raises.
    """
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    out = {}
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            raise ValueError(f"device_health probes CUDA devices, not {d}")
        try:
            x = torch.ones((), device=d)
            out[str(d)] = bool(x.item() == 1.0)
        except RuntimeError:  # a device fault (or a CUDA error) marks it down
            out[str(d)] = False
    return out
