"""Quickstart on the PyTorch port: train a small LM with SRigL, inspect the
learned structure, check the condensed representation, serve it through
the engine, keep training, and refresh the engine incrementally.

  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

(``--device cuda``, the default, runs on the card, where the condensed
paths launch the port's CUDA kernels and every decode step is a replayed
CUDA graph.) The sections follow ``examples/quickstart.py``'s 1-8 and 13:
section 7 is the calibration (a measured profile, then the
launch-configuration search), section 13 self-draft speculative decoding.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import time
import types

import torch

from repro_torch import configs, resolve_device
from repro_torch.core import topology
from repro_torch.core.schedule import DSTSchedule
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.kernels import structured_matmul as SM
from repro_torch.launch.engine import ServingEngine, generate
from repro_torch.launch.speculative import SpecConfig
from repro_torch.models import model as M
from repro_torch.sparse import formats as F
from repro_torch.sparse import plan as PLAN
from repro_torch.sparse import autotune
from repro_torch.sparse import registry as REG
from repro_torch.train.state import init_train_state
from repro_torch.train.trainer import make_dst_step, make_train_step


def _time_us(fn, *args, reps: int = 5) -> float:
    """Median microseconds of ``fn(*args)``: CUDA events on the card, the
    host clock on the CPU (where the kernels' plain versions run)."""
    fn(*args)
    times = []
    for _ in range(reps):
        if args[0].is_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e6)
    return sorted(times)[len(times) // 2]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. a reduced qwen3-style config at 90% sparsity, SRigL with ablation
    cfg = configs.get_smoke_config("qwen3-1.7b")
    cfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity, delta_t=10))
    registry = REG.build_registry(cfg)
    print(f"sparse stacks: {[s.name for s in registry]}")
    print(f"ERK densities: {[f'{s.density:.3f}' for s in registry]}")

    # 2. train with periodic topology updates
    state = init_train_state(cfg, torch.Generator(device=device).manual_seed(0))
    step = make_train_step(cfg, registry, lambda s: 3e-3)
    dst = make_dst_step(cfg, registry)
    sched = DSTSchedule(delta_t=10)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=48, batch_size=8, seed=0)

    def train(steps):
        nonlocal state
        for i in steps:
            batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(i).items()}
            state, metrics = step(state, batch)
            if sched.is_update_step(i + 1):
                state = dst(state, batch)
            if i % 10 == 0:
                print(f"step {i:3d} loss {float(metrics['loss']):.4f} "
                      f"drop_frac {float(metrics['drop_fraction']):.3f}")

    train(range(60))

    # 3. learned structure: constant fan-in + neuron ablation
    summary = REG.sparsity_summary(registry, {"masks": state.masks,
                                              "neuron_active": state.neuron_active})
    for name, row in summary.items():
        print(f"{name:20s} density={row['density']:.3f} "
              f"active_neurons={row['active_neurons']:.2%}")

    # 4. condensed export: the same weights, two representations (paper Sec. 4.4)
    s0 = registry[0]
    w = REG.get_path(state.params, s0.path)[0]
    m = REG.get_path(state.masks, s0.path)[0]
    k = int(m.sum(0).max())
    vals, idx = topology.dense_to_condensed(w * m, m, k)
    x = torch.randn((2, w.shape[0]), generator=torch.Generator(device=device).manual_seed(1),
                    device=device)
    err = float((ops.condensed_linear(x, vals, idx) - x @ (w * m)).abs().max())
    print(f"condensed-vs-masked max err: {err:.2e}  (fan-in k={k}, "
          f"{vals.numel()}/{w.numel()} weights stored = {vals.numel() / w.numel():.1%})")

    # 5. serve the trained model through the engine: requests group by plan
    #    key (batch bucket x per-stack format the cost model picks there),
    #    and greedy decode is token-identical to masked-dense for every
    #    exact format the plan can choose. The engine keeps its own copy of
    #    the weights, so the training below does not move what it serves.
    #    (CLI: PYTHONPATH=src python -m repro_torch.launch.serve \
    #        --arch qwen3-1.7b --smoke --path auto)
    engine = ServingEngine(cfg, state.params, state.masks, registry, path="auto",
                           mask_versions=state.mask_versions)
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(2))
    rid_a = engine.submit(prompts, gen_len=8)            # batch-2 request
    rid_b = engine.submit(prompts[:1], gen_len=8)        # batch-1 request
    groups = engine.pending_groups()
    print(f"serve: {len(groups)} plan-key group(s): {[k.describe() for k in groups]}")
    print(engine.plan_for(engine.plan_key(2)).describe())
    engine.step()
    [res_a] = engine.retire(rid_a)
    [res_b] = engine.retire(rid_b)
    out_masked = generate(cfg, M.serving_params(cfg, state.params), state.masks,
                          prompts.to(device), 8)
    same = bool(torch.equal(out_masked.cpu(), res_a.tokens.cpu()))
    print(f"serve: engine decode tokens == masked decode tokens: {same} "
          f"(batch-1 group: {res_b.tok_s:.1f} tok/s)")
    print(f"serve: first stream: {res_a.tokens[0, 8:].tolist()}")

    # 6. incremental export: keep training, then refresh the engine. Only
    #    the stacks whose mask version moved re-export (per cached plan, each
    #    once across plans); the rest regather their values at the stored
    #    indices. A same-shape refresh writes into the engine's existing
    #    tensors, so its captured decode graphs stay valid.
    before = {kk: int(v) for kk, v in state.mask_versions.items()}
    train(range(60, 70))
    moved = sorted(n for n, v in state.mask_versions.items() if int(v) != before[n])
    changed = engine.refresh(state.params, state.masks, state.mask_versions)
    print(f"serve: mask versions moved for {len(moved)}/{len(registry)} stacks: {moved}")
    for key, names in changed.items():
        plan = engine.plan_for(key)
        print(f"serve: refresh[{key.describe()}] re-exported {len(names)}/{len(registry)} "
              f"stacks: {sorted(names)}; values-only regathers (topology unchanged, weights "
              f"trained on): {plan.value_refreshes}")
    rid = engine.submit(prompts, gen_len=8)
    engine.step()
    [res] = engine.retire(rid)
    out_masked = generate(cfg, M.serving_params(cfg, state.params), state.masks,
                          prompts.to(device), 8)
    print(f"serve: refreshed engine tokens == masked decode tokens: "
          f"{bool(torch.equal(out_masked.cpu(), res.tokens.cpu()))}")

    # 7. calibration: replace the cost model's built-in H100 figures with
    #    rates measured on this device (a float32 stream, a matmul, and the
    #    condensed gather at two batch points, B = 8 and 512; CUDA events
    #    over replayed work on the card), cached per device name. The plan
    #    decisions at each bucket under both profiles, side by side.
    #    (CLI: --path auto --profile measured.) Then the launch search
    #    (engine.autotune): every launch configuration of each kernel the
    #    engine's stacks run at a bucket is timed and the fastest kept in
    #    the same cache, under the formats' tuning keys, which the kernel
    #    wrappers read (CLI: --autotune). On the CPU each candidate is the
    #    plain version, so the winners say nothing of the card.
    prof = PLAN.HardwareProfile.measure(device=device)
    print(f"calibrated {prof.name}: hbm {prof.hbm_bytes_per_s / 1e9:.1f} GB/s "
          f"matmul {prof.mxu_flops_per_s / 1e9:.1f} GFLOP/s "
          f"gather {prof.gather_flops_per_s / 1e9:.1f}->"
          f"{prof.gather_flops_per_s_large / 1e9:.1f} GFLOP/s "
          f"(b={prof.gather_small_batch}->{prof.gather_large_batch}; "
          f"cache: {autotune.cache_path()})")
    engine_m = ServingEngine(cfg, state.params, state.masks, registry, path="auto",
                             profile=prof)
    for bb in (1, 8, 32, 128, 512):
        reps = {p_.name: [dict(k.formats)[s.name] for s in registry]
                for p_, k in ((PLAN.DEFAULT_PROFILE, engine.plan_key(bb)),
                              (prof, engine_m.plan_key(bb)))}
        print(f"decisions @ bucket {bb}: " + " | ".join(f"{n}: {r}" for n, r in reps.items()))
    for name, res in engine_m.autotune(2).items():
        print(f"autotuned {name} @ b=2: best {res.label} ({res.us:.0f} us vs default "
              f"{res.default_us:.0f} us, {len(res.table)} launches timed)")

    # 8. ablation-aware kernels (Fig. 4 "structured"): the structured path
    #    multiplies only the surviving columns of the dense weight (K5 on
    #    the card), so its time follows the active fraction; on an
    #    ablation-only stack (surviving columns fully dense) the cost model
    #    lets structured win the auto choice at decode shapes.
    d_in, d_out, b = 512, 512, 8
    g8 = torch.Generator(device=device).manual_seed(8)
    w8 = torch.randn((d_in, d_out), generator=g8, device=device)
    x8 = torch.randn((b, d_in), generator=g8, device=device)
    where = "CUDA events around one call" if device.type == "cuda" else "host clock, plain version"
    base = None
    for frac in (1.0, 0.5, 0.25):
        a = int(d_out * frac)
        cols = torch.randperm(d_out, generator=g8, device=device)[:a].sort().values
        a_pad = SM.padded_active_count(a, d_out)
        ai = torch.full((a_pad,), d_out, dtype=torch.int32, device=device)
        ai[:a] = cols.to(torch.int32)
        t = _time_us(SM.structured_matmul, x8, w8, ai)
        base = base or t
        print(f"structured kernel active={frac:.2f}: {t:8.1f} us ({t / base:.2f}x of "
              f"dense-width; {where})")
    stack = types.SimpleNamespace(name="mlp@abl50", d_in=3072, d_out=1024, n_replicas=1)
    stats = F.ExportStats(k=3072, max_active=512, active_fraction=0.5,
                          min_fan_in=3072)  # ablation-only: survivors dense
    for bb in (1, 256):
        dec = PLAN.select_representation(stack, batch_size=bb, itemsize=4, stats=stats)
        est = {r: f"{v * 1e6:.1f}us" for r, v in dec.est_s.items()}
        print(f"auto @ b={bb} (ablation-only stack) -> {dec.representation} {est}")

    # 13. self-draft speculative decoding: neuron ablation means the served
    #     model already contains its own draft, the same trained weights at
    #     a higher ablation fraction. The engine derives a draft tree per
    #     plan key (plan.derive_draft_tree: every value tensor shared with
    #     the target plan, asserted), runs gamma draft steps, then one
    #     full-network verify over the gamma + 1 positions; the agreed prefix
    #     commits and the paged KV past it is rewound. Greedy acceptance
    #     keeps the tokens plain greedy decode's: the knobs trade
    #     full-network dispatches per token, never correctness. Whether it
    #     is worth running is priced (plan.price_speculation; --path auto
    #     may decline, a fixed path runs). Ablation 0.0 is the protocol's
    #     ceiling: acceptance 1.0, 1/(gamma + 1) dispatches per token. On
    #     the card the draft and verify are replayed CUDA graphs.
    p13 = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(13))
    eng_ref = ServingEngine(cfg, state.params, state.masks, registry, path="condensed")
    rid = eng_ref.submit(p13, gen_len=16)
    eng_ref.step()
    [ref13] = eng_ref.retire(rid)
    for gamma, frac in ((3, 0.0), (3, 0.5), (2, 0.5)):
        eng13 = ServingEngine(cfg, state.params, state.masks, registry, path="condensed",
                              speculative=SpecConfig(gamma=gamma, draft_ablation=frac,
                                                     force=True))
        rid = eng13.submit(p13, gen_len=16)
        eng13.step()
        [res13] = eng13.retire(rid)
        s13 = res13.spec
        print(f"spec g={gamma} abl={frac}: acceptance {s13['acceptance_rate']:.2f}, "
              f"full-network dispatches/token {s13['full_dispatches_per_token']:.3f}, "
              f"bitwise == plain: {bool(torch.equal(res13.tokens, ref13.tokens))}")
    est13 = eng13.spec_estimate_for(eng13.plan_key(2))
    print(f"spec pricing @ smoke dims: draft {est13.draft_step_s * 1e6:.2f}us vs target "
          f"{est13.target_step_s * 1e6:.2f}us per step -> auto would "
          f"{'run' if est13.worthwhile else 'decline'} (a sentinel draft gathers every row)")
    # the CLI drives the same: --speculative --gamma G --draft-ablation F
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-1.7b", "--smoke",
         "--path", "condensed", "--batch", "2", "--prompt-len", "8", "--gen", "16",
         "--speculative", "--gamma", "3", "--draft-ablation", "0.5", "--device", args.device],
        capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")]
            + [p_ for p_ in [os.environ.get("PYTHONPATH")] if p_])))
    for line in proc.stdout.splitlines():
        if "[serve:spec]" in line or "tok/s" in line:
            print(f"spec-cli| {line}")
    if proc.returncode:
        print(proc.stdout[-2000:], proc.stderr[-2000:])
        raise SystemExit("serve --speculative failed")


if __name__ == "__main__":
    main()
