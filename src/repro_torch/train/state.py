"""TrainState: everything a step needs (port of ``repro/train/state.py``)."""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.optim import make_optimizer
from repro_torch.sparse import registry as REG


class TrainState(NamedTuple):
    step: torch.Tensor         # () int32, on the CPU
    params: Any                # model parameter tree (float32 tensors on the device)
    opt_state: Any
    masks: Any                 # bool masks, paths mirror params (always the
                               # training layout, never serving formats)
    neuron_active: Any         # per-stack (lead..., d_out) bool
    grad_accum: Any            # dense-grad accumulator for the saliency window
                               # ({} when grad_accum_for_saliency == 1)
    mask_versions: Any         # {stack name: () int32} — bumped by the DST step
                               # when that stack's mask changed
    rng: np.ndarray            # the reference's PRNG key, uint32[2]: carried
                               # unchanged so checkpoints keep it; with the
                               # step it seeds SET's regrowth
                               # (trainer.set_generator)


def init_train_state(cfg, generator: torch.Generator, device=None) -> TrainState:
    """A fresh state: params, then masks, drawn from ``generator`` (on its
    device); ``device`` (default: the generator's) is where the state lives.

    ``rng`` is the key ``jax.random.PRNGKey(generator.initial_seed())`` would
    hold, for checkpoints the reference restores.
    """
    device = torch.device(device) if device is not None else generator.device
    registry = REG.build_registry(cfg)
    params = M.init_params(cfg, generator, REG.k_fan_map(cfg, registry))
    if registry:
        sp = REG.init_sparsity_state(cfg, generator, registry)
        masks, active = sp["masks"], sp["neuron_active"]
    else:
        masks, active = {}, {}
    params, masks, active = (_to(t, device) for t in (params, masks, active))
    opt_init, _ = make_optimizer(cfg.optimizer)
    accum: dict = {}
    if cfg.sparsity.grad_accum_for_saliency > 1:
        for s in registry:
            REG.set_path(accum, s.path, torch.zeros(REG.get_path(params, s.path).shape,
                                                    dtype=torch.float32, device=device))
    seed = generator.initial_seed()
    return TrainState(
        step=torch.zeros((), dtype=torch.int32), params=params, opt_state=opt_init(params),
        masks=masks, neuron_active=active, grad_accum=accum,
        mask_versions={s.name: torch.zeros((), dtype=torch.int32) for s in registry},
        rng=np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32))


def _to(tree: dict, device, copy: bool = False) -> dict:
    return {k: _to(v, device, copy) if isinstance(v, dict) else v.to(device, copy=copy)
            for k, v in tree.items()}


def state_to(state: TrainState, device) -> TrainState:
    """A copy of ``state`` with the tensors of its trees on ``device`` (the
    counters ``step``, ``opt_state/count`` and ``mask_versions`` stay on
    the CPU)."""
    opt = {k: _to(v, device, True) if isinstance(v, dict) else v.clone()
           for k, v in state.opt_state.items()}
    return state._replace(
        step=state.step.clone(), params=_to(state.params, device, True), opt_state=opt,
        masks=_to(state.masks, device, True),
        neuron_active=_to(state.neuron_active, device, True),
        grad_accum=_to(state.grad_accum, device, True),
        mask_versions={k: v.clone() for k, v in state.mask_versions.items()},
        rng=state.rng.copy())
