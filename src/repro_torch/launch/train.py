"""Training launcher (port of ``repro/launch/train.py``).

  python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --device cpu \
      --steps 4

Trains masked-dense with the straight-through mask and runs the topology
update every ``delta_t`` steps: SRigL by default, the paper's baselines
with ``--method rigl`` or ``--method set`` (unstructured masks), none with
``--method dense``. Runs on the card unless ``--device cpu`` is given;
without a card it raises.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs, resolve_device
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--sparsity", type=float, default=None)
    ap.add_argument("--method", default=None,
                    choices=[None, "srigl", "rigl", "set", "dense"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = (configs.get_smoke_config if args.smoke else configs.get_config)(args.arch)
    sp = cfg.sparsity
    if args.sparsity is not None:
        sp = dataclasses.replace(sp, sparsity=args.sparsity)
    if args.method is not None:
        sp = dataclasses.replace(sp, method=args.method)
    cfg = cfg.replace(sparsity=sp)

    data = SyntheticLM(vocab_size=max(cfg.vocab_size, 2), seq_len=args.seq,
                       batch_size=args.batch, seed=args.seed, family=cfg.family,
                       n_codebooks=cfg.n_codebooks, d_model=cfg.d_model)
    batches = Prefetcher(data.iterate(), depth=2, pin=device.type == "cuda")
    trainer = Trainer(
        cfg=cfg,
        lr_fn=warmup_cosine(args.lr, warmup_steps=max(args.steps // 20, 1),
                            total_steps=args.steps),
        ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every, log_every=10,
        device=device)
    try:
        state = trainer.init_or_restore(torch.Generator(device=device).manual_seed(args.seed))
        if int(state.step) > 0:
            print(f"[train] resumed from step {int(state.step)}")
        state = trainer.fit(state, batches, args.steps)
    finally:
        batches.close()
    if trainer.straggler_events:
        print(f"[train] {len(trainer.straggler_events)} straggler events flagged")
    print(f"[train] done at step {int(state.step)}")
    return state


if __name__ == "__main__":
    main()
