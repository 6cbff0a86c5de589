"""Batched serving example on the PyTorch port: prefill a batch of prompts,
stream greedy decode, and show the sliding-window ring-buffer cache in
action (gemma3-style).

  PYTHONPATH=src python examples/serve_batched_torch.py [--arch gemma3-1b] [--device cpu]

Runs the smoke config on the card (each decode step a replayed CUDA graph)
unless ``--device cpu`` is given.
"""
import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.launch.engine import generate
from repro_torch.models import model as M
from repro_torch.sparse import registry as REG


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=configs.ALL_ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.get_smoke_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    reg = REG.build_registry(cfg)
    params = M.init_params(cfg, gen, REG.k_fan_map(cfg, reg))
    masks = REG.init_sparsity_state(cfg, gen, reg)["masks"] if reg else {}

    max_len = args.prompt_len + args.gen
    cache = M.init_cache(cfg, args.batch, max_len=max_len, device=device)
    total = sum(t.numel() * t.element_size() for c in cache.values() if isinstance(c, dict)
                for t in c.values())
    print(f"[serve] cache bytes: {total / 1e6:.2f} MB "
          f"(ring buffers cap local-attention layers at window="
          f"{cfg.sliding_window or 'n/a'}; {max_len} positions a stream)")

    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                            device=device, dtype=torch.int32)
    t0 = time.perf_counter()
    out = generate(cfg, params, masks, prompts, args.gen)
    dt = time.perf_counter() - t0
    print(f"[serve] {args.batch} streams x {args.gen} tokens in {dt:.2f}s")
    for b in range(min(args.batch, 2)):
        print(f"  stream {b}: ...{out[b, -args.gen:].tolist()}")
    return out


if __name__ == "__main__":
    main()
