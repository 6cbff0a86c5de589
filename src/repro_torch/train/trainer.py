"""Training step, topology-update step and host-side Trainer loop (port of
``repro/train/trainer.py``).

``make_train_step`` builds the hot-path step:

  1. forward/backward — sparse layers use straight-through masking, so the
     gradient tree is DENSE (the SRigL grow criterion) at no extra cost;
  2. gradient clipping by the global norm, then the optimizer update, which
     re-masks gradients and moments.

``make_dst_step`` builds the topology update that runs every ``delta_t``
steps on its own (SRigL, RigL or SET, as ``cfg.sparsity.method`` says): it
recomputes the dense gradients of the sparse stacks, prunes/grows/ablates,
zeroes newly grown weights (RigL semantics: a regrown connection starts at
w = 0 with zero momentum) and stamps ``mask_versions``.

Both consume their state: params and moments are updated in place, as the
reference's jitted step donates its state. The Trainer adds the shell:
device copies of prefetched batches, checkpoint/restart, restore on
failure and a step-time watch for stragglers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.core.schedule import DSTSchedule
from repro_torch.models import model as M
from repro_torch.optim import make_optimizer
from repro_torch.sparse import registry as REG
from repro_torch.train.state import TrainState, init_train_state


def _leaves(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """(path, leaf) pairs in the reference's leaf order (sorted keys)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out


def _global_norm(tree) -> torch.Tensor:
    """float32 sqrt(sum of squares + 1e-30) over every leaf."""
    total = sum((x.float().square().sum() for _, x in _leaves(tree)),
                torch.zeros((), dtype=torch.float32))
    return torch.sqrt(total + torch.tensor(1e-30, dtype=torch.float32))


def _dst_schedule(cfg) -> DSTSchedule:
    sp = cfg.sparsity
    return DSTSchedule(delta_t=sp.delta_t, alpha=sp.alpha, t_end_fraction=sp.t_end_fraction,
                       total_steps=getattr(cfg, "total_steps", 100_000))


def _grads(cfg, params: dict, masks: dict, batch: dict, paths) -> tuple:
    """(loss, metrics, {path: gradient}) of ``loss_fn`` wrt the leaves at
    ``paths``; a leaf the loss does not read (the ViT's CLS stub ``embed``)
    gets zeros, as ``jax.grad`` gives it."""
    leaves = [REG.get_path(params, p) for p in paths]
    for t in leaves:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, metrics = M.loss_fn(cfg, params, masks, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    metrics = {k: v.detach() for k, v in metrics.items()}
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return loss.detach(), metrics, dict(zip(paths, grads))


def _tree(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        REG.set_path(out, path, v)
    return out


def _split(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches along the batch axis (axis 1 of the (3, B, T)
    ``mrope_positions``)."""
    def part(k, v, i):
        if k == "mrope_positions":
            return v.reshape(3, n, v.shape[1] // n, v.shape[-1])[:, i]
        return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
    return [{k: part(k, v, i) for k, v in batch.items()} for i in range(n)]


def make_train_step(cfg, registry, lr_fn: Callable, *, clip_norm: float = 1.0,
                    microbatches: int = 1):
    """The hot-path step(state, batch) -> (state, metrics).

    The topology update is not in this step: it runs every delta_t steps
    on its own (``make_dst_step``). The step accumulates the dense saliency
    gradients when the config asks for a multi-step window.
    """
    sched = _dst_schedule(cfg)
    _, opt_update = make_optimizer(cfg.optimizer)
    accum_n = cfg.sparsity.grad_accum_for_saliency

    def train_step(state: TrainState, batch: dict):
        paths = [p for p, _ in _leaves(state.params)]
        if microbatches > 1:
            # gradient accumulation: grads averaged in float32
            loss, grads = 0.0, None
            for mb in _split(batch, microbatches):
                l_i, metrics, g_i = _grads(cfg, state.params, state.masks, mb, paths)
                loss = loss + l_i / microbatches
                g_i = {p: g.float() / microbatches for p, g in g_i.items()}
                grads = g_i if grads is None else {p: grads[p] + g_i[p] for p in paths}
            metrics["loss"] = loss
        else:
            loss, metrics, grads = _grads(cfg, state.params, state.masks, batch, paths)
        grads = _tree(grads)

        gnorm = _global_norm(grads)
        grads_c = grads
        if clip_norm:
            scale = torch.clamp(torch.tensor(clip_norm, dtype=torch.float32)
                                / (gnorm + torch.tensor(1e-9, dtype=torch.float32)), max=1.0)
            # clipped in the gradient's own dtype; optimizers upcast per leaf
            grads_c = _tree({p: (g.float() * scale.to(g.device)).to(g.dtype)
                             for p, g in ((p, REG.get_path(grads, p)) for p in paths)})

        step = int(state.step)
        lr = lr_fn(step)
        params, opt_state = opt_update(state.params, grads_c, state.opt_state, lr,
                                       masks=state.masks if registry else None)
        del grads_c

        grad_accum = state.grad_accum
        if accum_n > 1 and registry:
            # the running sum of the last accum_n steps' dense (unclipped)
            # grads (paper D.2)
            decay = 0.0 if step % accum_n == 0 else 1.0
            new_accum: dict = {}
            for s in registry:
                a = REG.get_path(grad_accum, s.path)
                REG.set_path(new_accum, s.path,
                             a * decay + REG.get_path(grads, s.path).float())
            grad_accum = new_accum

        new_state = state._replace(step=state.step + 1, params=params, opt_state=opt_state,
                                   grad_accum=grad_accum)
        metrics = dict(metrics)
        metrics.update(grad_norm=gnorm, lr=lr, drop_fraction=sched.drop_fraction(step))
        return new_state, metrics

    return train_step


def set_generator(state: TrainState) -> torch.Generator:
    """The generator SET's update at ``state.step`` draws its regrowth from,
    on the state's device.

    The reference splits its key every update; ``jax.random`` streams cannot
    be reproduced in torch, and the port carries that key unchanged
    (``TrainState.rng``). So the generator is seeded from the key and the
    step together: a run restored at step s regrows exactly as an
    uninterrupted run does at s, and the checkpoint layout stays the
    reference's.
    """
    key = (int(state.rng[0]) << 32) | int(state.rng[1])
    device = next(t for _, t in _leaves(state.params)).device
    seed = (key * 1_000_003 + int(state.step)) % 2**63
    return torch.Generator(device=device).manual_seed(seed)


def make_dst_step(cfg, registry):
    """The topology update step(state, batch) -> state: new masks (and, for
    SRigL, neuron_active); newly grown weights restart at 0 (their moments
    are re-masked by the next optimizer call); ``mask_versions`` of every
    stack whose mask changed move up by one. SET draws its regrowth from
    ``set_generator(state)``."""
    sched = _dst_schedule(cfg)
    accum_n = max(cfg.sparsity.grad_accum_for_saliency, 1)
    method = cfg.sparsity.method

    def dst_step(state: TrainState, batch: dict) -> TrainState:
        drop = sched.drop_fraction(int(state.step))
        rng = None
        if method == "set":  # random regrowth: no gradient to recompute
            rng, sal = set_generator(state), {}
        elif accum_n > 1:
            sal = {s.path: REG.get_path(state.grad_accum, s.path) / accum_n for s in registry}
        else:
            # recompute the sparse stacks' dense grads (1/delta_t amortized)
            _, _, sal = _grads(cfg, state.params, state.masks, batch,
                               [s.path for s in registry])
        sal_grads = _tree({p: g.float() for p, g in sal.items()})
        del sal
        sp_state = {"masks": state.masks, "neuron_active": state.neuron_active}
        new_sp, _stats = REG.dst_update(cfg, registry, state.params, sal_grads, sp_state, drop,
                                        rng)
        del sal_grads
        new_versions = dict(state.mask_versions)
        for s in registry:
            w = REG.get_path(state.params, s.path)
            old_m = REG.get_path(state.masks, s.path)
            new_m = REG.get_path(new_sp["masks"], s.path)
            w.masked_fill_(new_m & ~old_m, 0.0)  # in place: grown weights restart at 0
            changed = bool((new_m != old_m).any())
            new_versions[s.name] = state.mask_versions[s.name] + int(changed)
        return state._replace(masks=new_sp["masks"], neuron_active=new_sp["neuron_active"],
                              mask_versions=new_versions)

    return dst_step


def _batch_to(batch: dict, device) -> dict:
    """A prefetched batch on the state's device (non-blocking from pinned memory)."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


@dataclasses.dataclass
class Trainer:
    """Host-side loop: batches to the device, checkpoint/restart, restore on
    failure, straggler watch."""

    cfg: Any
    lr_fn: Callable
    ckpt_dir: str | None = None
    ckpt_every: int = 1000
    keep_checkpoints: int = 3
    log_every: int = 50
    straggler_factor: float = 3.0   # a step slower than 3x the median is flagged
    # called with the state right after every DST step (the moment
    # mask_versions move) and every ``publish_every`` steps besides; the
    # reference hands it to its train->serve Publisher
    publisher: Callable | None = None
    publish_every: int | None = None
    device: Any = None              # where init_or_restore places a new state

    def __post_init__(self):
        self.registry = REG.build_registry(self.cfg)
        self._step_fn = None
        self._step_times: list[float] = []
        self.straggler_events: list[tuple[int, float]] = []
        self.last_metrics: dict = {}  # the metrics of the last step fit ran

    def init_or_restore(self, generator: torch.Generator) -> TrainState:
        from repro_torch.train import checkpoint as CKPT
        state = init_train_state(self.cfg, generator, self.device)
        if self.ckpt_dir:
            latest = CKPT.latest_step(self.ckpt_dir)
            if latest is not None:
                return CKPT.restore(self.ckpt_dir, latest, state)
        return state

    def fit(self, state: TrainState, batches, n_steps: int,
            log_fn: Callable = print) -> TrainState:
        from repro_torch.train import checkpoint as CKPT
        if self._step_fn is None:
            self._step_fn = make_train_step(self.cfg, self.registry, self.lr_fn)
            self._dst_fn = make_dst_step(self.cfg, self.registry) if self.registry else None
        sched = _dst_schedule(self.cfg)
        device = next(t for _, t in _leaves(state.params)).device
        it = iter(batches)
        start = int(state.step)
        for i in range(start, start + n_steps):
            batch = _batch_to(next(it), device)
            t0 = time.perf_counter()
            try:
                state, metrics = self._step_fn(state, batch)
                dst_ran = self._dst_fn is not None and sched.is_update_step(i + 1)
                if dst_ran:
                    state = self._dst_fn(state, batch)
                if self.publisher is not None and (
                        dst_ran or (self.publish_every and (i + 1) % self.publish_every == 0)):
                    self.publisher(state)
            except Exception:
                # restore from the last checkpoint and go on; with none, re-raise
                if self.ckpt_dir and CKPT.latest_step(self.ckpt_dir) is not None:
                    log_fn(f"[trainer] step {i}: failure — restoring last checkpoint")
                    state = CKPT.restore(self.ckpt_dir, CKPT.latest_step(self.ckpt_dir), state)
                    continue
                raise
            dt = time.perf_counter() - t0
            self.last_metrics = metrics
            self._watch_stragglers(i, dt, log_fn)
            if i % self.log_every == 0:
                loss = float(metrics["loss"])
                log_fn(f"[trainer] step {i} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if self.ckpt_dir and (i + 1) % self.ckpt_every == 0:
                CKPT.save(self.ckpt_dir, state, keep=self.keep_checkpoints)
        return state

    def _watch_stragglers(self, step: int, dt: float, log_fn):
        self._step_times.append(dt)
        if len(self._step_times) >= 20:
            recent = sorted(self._step_times[-100:])
            med = recent[len(recent) // 2]
            if dt > self.straggler_factor * med:
                self.straggler_events.append((step, dt))
                log_fn(f"[trainer] straggler: step {step} took {dt:.2f}s (median {med:.2f}s)")
