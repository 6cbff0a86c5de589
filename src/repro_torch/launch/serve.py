"""Serving CLI (port of ``repro/launch/serve.py`` with ``--no-paged``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --batch 4 --prompt-len 32 --gen 16 --path condensed

Initializes the model and its SRigL constant fan-in masks from ``--seed``
with a ``torch.Generator``, builds the serving tree for ``--path`` and runs
one greedy prefill + decode pass:

  --path masked      masked-dense ``torch.matmul`` on ``w * mask``
  --path condensed   every sparse linear runs the condensed gather kernel
                     over ``formats.Condensed`` leaves (paper Alg. 1)

The two evaluate the same masked weights, so their tokens agree (up to
float ties). Runs on CUDA unless ``--device cpu``; with no card and no
``--device cpu`` it exits with an error. The paged scheduler and the other
paths of the reference CLI come with later slices.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs, resolve_device
from repro_torch.launch.engine import ServingModel
from repro_torch.models import model as M
from repro_torch.sparse import condensed as COND
from repro_torch.sparse import registry as REG

PATHS = ("masked", "condensed")


def build_serving_masks(cfg, registry, params, masks, path: str) -> dict:
    """The serving tree for ``path``: ``masks`` itself for masked, the
    condensed export for condensed."""
    if path == "masked":
        return masks
    if path == "condensed":
        return COND.export_condensed(cfg, registry, params, masks)
    raise ValueError(f"unknown path {path!r}; ported paths: {PATHS}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--path", choices=PATHS, default="masked",
                    help="serving representation for sparse linears")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config if args.smoke else configs.get_config)(args.arch)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    reg = REG.build_registry(cfg)
    params = M.init_params(cfg, gen, REG.k_fan_map(cfg, reg))
    masks = REG.init_sparsity_state(cfg, gen, reg)["masks"] if reg else {}
    if args.path != "masked" and not reg:
        raise SystemExit(f"{args.arch} has no sparse stacks — only --path masked")
    model = ServingModel(cfg, params,
                         build_serving_masks(cfg, reg, params, masks, args.path))
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device, dtype=torch.int32)
    out, _ = model.serve_once(prompts, args.gen, args.path)
    print("[serve] first stream:", out[0, -args.gen:].tolist())
    return out


if __name__ == "__main__":
    main()
