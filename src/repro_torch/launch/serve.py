"""Serving CLI: a thin wrapper over ``repro_torch.launch.engine.ServingEngine``
(port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --batch 4 --prompt-len 32 --gen 16 --path condensed

Initializes the model and its SRigL constant fan-in masks from ``--seed``
with a ``torch.Generator``, builds a ``ServingEngine`` for ``--path``,
submits one request of ``--batch`` random prompts and serves it:

  --path masked      masked-dense ``torch.matmul`` on ``w * mask``
  --path condensed   every sparse linear runs the condensed gather kernel
                     (K1) over ``formats.Condensed`` leaves (paper Alg. 1)
  --path structured  ablated neurons dropped, surviving columns gathered
                     and multiplied by the structured kernel (K5; K6 at
                     decode with ``REPRO_PREFETCH_GATHER=1``): exact only
                     for ablation-only masks
  --path condensed_over_active
                     ablated neurons dropped, then the condensed gather over
                     the surviving rows, scattered back to dense columns
                     (K4): the paper's combined Fig. 4 point
  --path auto        per-stack cost model (``sparse.plan``) at the batch's
                     bucket; prints the plan

  --values-dtype f32|bf16|int8|fp8
                     stored width of the exported sparse values: int8 and
                     fp8 quantize per output neuron (symmetric absmax scale)
                     and the condensed paths run the dequant-fused kernel
                     (K2; K2-coa over active rows), bf16 is a plain storage
                     cast, f32 keeps the param dtype. Masked stacks read the
                     live params and are unaffected.
  --no-paged         the exact-shape slab path on a contiguous cache instead
                     of the paged continuous-batching scheduler
  --sync-dir D       subscribe to a live trainer's sync directory
                     (``repro_torch.sync.DirChannel``): bootstrap the engine
                     from the publisher's snapshot instead of the local
                     init, then drain its deltas at chunk boundaries while
                     serving, written into the engine's tensors in place.
                     The stream fixes the path and values dtype
                     (condensed-family only). ``--sync-wait`` seconds to
                     wait for the snapshot.
  --speculative      self-draft speculative decoding: the same weights at
                     ``--draft-ablation`` extra neuron ablation draft
                     ``--gamma`` tokens a round, one full-network verify
                     scores them (``launch/speculative.py``); the tokens are
                     plain greedy decode's, and a ``[serve:spec]`` line
                     reports acceptance and full-network dispatches per
                     token. Any path but masked; a fixed path always
                     speculates, ``--path auto`` may decline by its price.
  --profile default|measured
                     the hardware profile ``--path auto`` (and the
                     speculation price) is computed with: ``measured`` times
                     the rates on this device (``HardwareProfile.measure``,
                     cached per device name in
                     ``$REPRO_TORCH_AUTOTUNE_CACHE``).
  --autotune         before serving, time every launch configuration of
                     each kernel the engine's stacks run at ``--batch``'s
                     bucket (``ServingEngine.autotune``) and keep the
                     fastest in the same cache, where the kernel wrappers
                     read it; prints one ``[serve] autotuned`` line per
                     launch shape. Skipped on ``--path masked``.

The engine plans every path but masked with ``sparse.plan.build_plan`` at
the request's batch bucket. masked, condensed, condensed_over_active and
auto evaluate the same masked weights, so their tokens agree (up to float
ties). On the card each decode step is a replayed CUDA graph. Runs on CUDA
unless ``--device cpu``; with no card and no ``--device cpu`` it exits with
an error. The reference CLI's ``--tp`` is not ported yet (ROADMAP queue 1,
item 9). As the reference's, it refuses the encoder-only vit-b16 ("no
decode path"), and musicgen-medium with a ValueError: its prompts are (B,
K, T), which the engine does not take (``engine.refuse_audio``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs, resolve_device
from repro_torch.launch.engine import ServingEngine, refuse_audio
from repro_torch.launch.speculative import SpecConfig
from repro_torch.models import model as M
from repro_torch.sparse import plan as PLAN
from repro_torch.sparse import registry as REG

PATHS = PLAN.PATHS


def build_plan(cfg, registry, params, masks, path: str, *,
               batch_size: int = 1, values_dtype: str | None = None) -> PLAN.Plan:
    """The execution plan for ``path``, priced at ``batch_size``'s bucket,
    its values stored at ``values_dtype``."""
    return PLAN.build_plan(cfg, registry, params, masks, path=path,
                           batch_size=PLAN.batch_bucket(max(int(batch_size), 1)),
                           values_dtype=values_dtype)


def build_serving_masks(cfg, registry, params, masks, path: str,
                        batch_size: int = 1) -> dict:
    """The serving tree for ``path``: ``masks`` itself for masked, else the
    tree of the plan built at ``batch_size``'s bucket."""
    if path == "masked":
        return masks
    return build_plan(cfg, registry, params, masks, path,
                      batch_size=batch_size).serving_tree


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
    ap.add_argument("--values-dtype", choices=("f32", "bf16", "int8", "fp8"), default="f32",
                    help="stored width of the exported sparse values: int8/fp8 quantize "
                         "per output neuron (symmetric absmax scale, dequantized inside "
                         "the kernels), bf16 is a plain storage cast, f32 keeps the param "
                         "dtype; masked stacks read the live params and are unaffected")
    ap.add_argument("--no-paged", action="store_true",
                    help="the exact-shape slab path on a contiguous cache instead of the "
                         "paged continuous-batching scheduler")
    ap.add_argument("--sync-dir", default=None,
                    help="subscribe to a live trainer's sync directory (DirChannel): "
                         "bootstrap the engine from the publisher's snapshot instead of "
                         "the local init, then drain its deltas at chunk boundaries; the "
                         "stream's condensed-family path and values dtype are served")
    ap.add_argument("--sync-wait", type=float, default=10.0,
                    help="seconds to wait for the bootstrap snapshot in --sync-dir")
    ap.add_argument("--speculative", action="store_true",
                    help="self-draft speculative decoding: the same weights at "
                         "--draft-ablation extra neuron ablation draft --gamma tokens a "
                         "round, one full-network verify scores them (the tokens stay "
                         "plain greedy decode's); any path but masked, and --path auto "
                         "may decline it by its price")
    ap.add_argument("--gamma", type=int, default=3,
                    help="drafted tokens per speculative round (the verify scores "
                         "gamma + 1 positions)")
    ap.add_argument("--draft-ablation", type=float, default=0.5,
                    help="extra neuron ablation of the draft (0.5 keeps the most "
                         "salient half of each stack's active neurons)")
    ap.add_argument("--profile", choices=("default", "measured"), default="default",
                    help="the hardware profile --path auto and the speculation price "
                         "use: 'measured' times the stream, matmul and gather rates on "
                         "this device (cached per device name) instead of the built-in "
                         "H100 figures")
    ap.add_argument("--autotune", action="store_true",
                    help="time every launch configuration of the sparse kernels at the "
                         "batch's bucket before serving and keep the fastest (cached per "
                         "device name in $REPRO_TORCH_AUTOTUNE_CACHE)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config if args.smoke else configs.get_config)(args.arch)
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only — no decode path")
    refuse_audio(cfg)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    reg = REG.build_registry(cfg)
    params = M.init_params(cfg, gen, REG.k_fan_map(cfg, reg))
    masks = REG.init_sparsity_state(cfg, gen, reg)["masks"] if reg else {}
    if args.path not in ("masked", "auto") and not reg:
        raise SystemExit(f"{args.arch} has no sparse stacks — only --path masked/auto")
    profile = PLAN.DEFAULT_PROFILE
    if args.profile == "measured":
        profile = PLAN.HardwareProfile.measure(device=device)
        print(f"[serve] calibrated profile {profile.name}: "
              f"hbm {profile.hbm_bytes_per_s / 1e9:.1f} GB/s, "
              f"matmul {profile.mxu_flops_per_s / 1e9:.1f} GFLOP/s, "
              f"gather {profile.gather_flops_per_s / 1e9:.1f}"
              f"->{profile.gather_flops_per_s_large / 1e9:.1f} GFLOP/s")
    speculative = None
    if args.speculative:
        # a fixed path is the operator's choice: speculate as asked; --path
        # auto keeps the price in charge
        speculative = SpecConfig(gamma=args.gamma, draft_ablation=args.draft_ablation,
                                 force=args.path != "auto")
    if args.values_dtype != "f32" and args.path == "masked":
        print("[serve] note: --path masked serves the live dense params; "
              f"--values-dtype {args.values_dtype} only affects exported "
              "value-storing formats (condensed/structured paths or auto)")
    subscriber = None
    if args.sync_dir is not None:
        from repro_torch.sync import DirChannel, Subscriber, engine_from_snapshot
        subscriber = Subscriber(DirChannel(args.sync_dir).subscribe("serve"), name="serve")
        print(f"[serve] syncing from {args.sync_dir}: waiting up to {args.sync_wait:.0f}s "
              "for a bootstrap snapshot")
        if not subscriber.wait_for_bootstrap(timeout=args.sync_wait):
            raise SystemExit(f"no snapshot appeared in {args.sync_dir} within "
                             f"{args.sync_wait:.0f}s: is the trainer publishing?")
        meta = subscriber.meta
        if args.path != meta.get("path"):
            print(f"[serve] note: stream publishes path={meta.get('path')!r}; serving "
                  f"that (not --path {args.path})")
        engine = engine_from_snapshot(cfg, subscriber, registry=reg, device=device,
                                      profile=profile,
                                      paged=False if args.no_paged else None,
                                      speculative=speculative)
        args.path = engine.path
        print(f"[serve] bootstrapped at generation {subscriber.generation} "
              f"(path={engine.path}, values_dtype={engine.values_dtype})")
    else:
        engine = ServingEngine(cfg, params, masks, reg, path=args.path, profile=profile,
                               paged=False if args.no_paged else None,
                               values_dtype=args.values_dtype, speculative=speculative)
    if args.autotune and args.path == "masked":
        print("[serve] --autotune skipped: --path masked never dispatches to the "
              "condensed kernels (use a condensed-family path or auto)")
    elif args.autotune and reg:
        for name, res in engine.autotune(args.batch).items():
            print(f"[serve] autotuned {name}: best {res.label} ({res.us:.1f} us vs "
                  f"default {res.default_us:.1f} us)")
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device, dtype=torch.int32)
    rid = engine.submit(prompts, args.gen)
    if args.path == "auto":
        # the plan is keyed on the batch bucket, so --batch 2 plans at bucket 8
        print(engine.plan_for(engine.plan_key(args.batch))
              .describe(requested_batch=args.batch))
    if args.values_dtype != "f32" and reg and args.path != "masked":
        weight_bytes, masked_ref = engine.plan_for(engine.plan_key(args.batch)).weight_bytes()
        print(f"[serve] values_dtype={args.values_dtype}: serving weight bytes "
              f"{weight_bytes} ({weight_bytes / max(masked_ref, 1):.3f}x of the "
              f"masked-dense reference)")
    engine.step()
    [res] = engine.retire(rid)
    b, t = prompts.shape
    print(f"[serve:{args.path}] prefill {b}x{t} in {res.prefill_s:.3f}s | "
          f"decode {b}x{args.gen} in {res.decode_s:.3f}s ({res.tok_s:.1f} tok/s)")
    print("[serve] first stream:", res.tokens[0, -args.gen:].tolist())
    if speculative is not None:
        if res.spec is not None:
            s = res.spec
            print(f"[serve:spec] gamma={s['gamma']} draft_ablation={s['draft_ablation']} | "
                  f"acceptance {s['acceptance_rate']:.3f} ({s['matched']}/{s['drafted']} "
                  f"drafts) | {s['full_dispatches_per_token']:.3f} full-network "
                  f"dispatches/token | draft {s['draft_s']:.3f}s + verify "
                  f"{s['verify_s']:.3f}s")
        else:
            est = engine.spec_estimate_for(res.plan_key)
            print(f"[serve:spec] declined by the price: {est.spec_s_per_token * 1e6:.1f} vs "
                  f"plain {est.base_s_per_token * 1e6:.1f} us/tok at assumed acceptance "
                  f"{est.acceptance:.2f} (gamma={est.gamma}); served plain decode")
    if subscriber is not None:
        c = subscriber.counters
        print(f"[serve:sync] generation {subscriber.generation} | applied "
              f"{c['applied_deltas']} delta(s) + {c['applied_snapshots']} snapshot(s) | "
              f"delta bytes {c['bytes_deltas']} vs snapshot bytes {c['bytes_snapshots']} | "
              f"stale {c['stale']} dup {c['duplicate']} gaps {c['gaps']} resyncs "
              f"{c['resyncs']}")
    return res.tokens


if __name__ == "__main__":
    main()
