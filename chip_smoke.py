#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on any failed check:

1. build: every CUDA source under src/repro_torch/kernels/csrc, compiled
   with nvcc for sm_90a, all at once.
2. kernels: the condensed gather kernel (K1) at every shape the serving
   path of full-width qwen3-1.7b gives it (wo, w_gate/w_up, w_down; decode
   B=4 and prefill B*T=128; bfloat16 and float32), held to its plain
   version within the stated tolerance, with the decode launch bitwise
   equal to the tiled launch. Times are CUDA-event medians over replays
   of a CUDA graph of launches that cycle through enough copies of the
   weights to keep L2 cold.
3. slice: full-width qwen3-1.7b (28 layers, random weights from a seeded
   torch.Generator), SRigL ERK masks at 90%, condensed export, greedy
   generation at B=4, prompt 32, gen 16 on the condensed and the masked
   path, in bfloat16 and again in float32. The condensed run must launch
   K1 exactly 4 * 28 * (1 + 16) times; the two paths' tokens must agree
   except where the masked path's top-2 logit gap is a tie at that dtype.
4. reference: the smoke config on the card against the port's CPU path
   (plain versions), which the CPU tests hold to the JAX reference.

Imports only torch, numpy, the standard library and repro_torch. Prints
the card's name and power limit, a JSON line describing each kernel, and
last a JSON line with the device. Per-shape kernel numbers also go to
build/chip_smoke_kernels.json.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2**20
ARCH = "qwen3-1.7b"
BATCH, PROMPT, GEN = 4, 32, 16
REPEATS = 5  # timed generate runs per path and dtype (tokens must repeat exactly)
# kernel vs plain version: the k-sum runs in another order (f32 rounding),
# and a bf16 output may then round to the neighbouring value (one ulp)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=8e-3, atol=1e-5)}
# masked vs condensed tokens may part only at a top-2 logit gap below this
TIE_GAP = {"bfloat16": 0.05, "float32": 1e-3}


def _time_ms(fn, arg_sets, reps: int = 5, iters: int = 30) -> float:
    """Device ms per call: ``iters`` calls cycling through ``arg_sets``
    (copies of the operands, so L2 stays cold) are captured in one CUDA
    graph, and the median over ``reps`` replays is timed with CUDA events.
    Replaying the graph keeps the host's per-call overhead out of the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up (library handles, workspaces)
        for a in arg_sets[:3]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _call_ms(fn, args, iters: int = 50) -> float:
    """Host-inclusive ms per eager call (what the serving loop pays)."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _copies(nbytes: int) -> int:
    return max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def build_phase():
    from repro_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(*names)
    print(f"[build] {', '.join(names)} in {time.perf_counter() - t0:.1f}s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name in names:
        if name in _build.build_logs:
            print(f"[build] {name}: {_build.build_seconds[name]:.1f}s")
            for line in _build.build_logs[name].splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    print(f"[build]   {line.strip()}")


def kernel_phase(device):
    """K1 at every main-path shape; returns the per-case records."""
    import torch
    from repro_torch import configs
    from repro_torch.core import distributions as D
    from repro_torch.core import topology
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(1)
    shapes = {}
    for s in REG.build_registry(cfg):  # w_up has w_gate's shape
        shapes.setdefault((s.d_in, s.d_out), (s.path[-1], D.fan_in_from_density(s.d_in, s.density)))
    cases = []
    for (d_in, n_out), (name, k) in shapes.items():
        mask = topology.random_constant_fan_in_mask(gen, d_in, n_out, k)
        w = torch.randn((d_in, n_out), generator=gen, device=device) / k ** 0.5
        vals32, idx = topology.dense_to_condensed(w * mask, mask, k)
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            vals = vals32.to(dtype).contiguous()
            dense = topology.condensed_to_dense(vals32, idx, d_in).to(dtype).contiguous()
            isz = vals.element_size()
            weight_sets = [(vals.clone(), idx.clone())
                           for _ in range(_copies(n_out * k * (isz + 4)))]
            dense_sets = [dense.clone() for _ in range(_copies(dense.numel() * isz))]
            for b, launch in ((BATCH, "decode"), (BATCH * PROMPT, "tiled")):
                x = torch.randn((b, d_in), generator=gen, device=device).to(dtype)
                y = cm.condensed_matmul(x, vals, idx)
                y_ref = ref.condensed_matmul_ref(x, vals, idx)
                torch.cuda.synchronize()
                torch.testing.assert_close(y.float(), y_ref.float(), **TOL[dtype_name])
                err = (y.float() - y_ref.float()).abs().max().item()
                if launch == "decode":
                    other = cm.condensed_matmul(x, vals, idx, block_b=8)  # tiled launch
                    same = torch.equal(cm.condensed_matmul_decode(x, vals, idx), other)
                    pair = "decode == tiled(8)"
                else:
                    same = torch.equal(y, cm.condensed_matmul(x, vals, idx, block_b=2))
                    pair = "tiled(8) == tiled(2)"
                if not same:
                    raise AssertionError(f"K1 {name} {dtype_name} B={b}: {pair} is not bitwise")
                ms = _time_ms(cm.condensed_matmul, [(x, v, i) for v, i in weight_sets])
                plain_ms = _time_ms(ref.condensed_matmul_ref,
                                    [(x, v, i) for v, i in weight_sets], iters=10)
                library_ms = _time_ms(torch.matmul, [(x, wd) for wd in dense_sets])
                call_ms = _call_ms(cm.condensed_matmul, (x, vals, idx))
                nbytes = n_out * k * (isz + 4) + b * d_in * isz + b * n_out * isz
                ops = 2 * b * n_out * k
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
                rec = dict(stack=name, d_in=d_in, n_out=n_out, k=k, dtype=dtype_name,
                           batch=b, launch=launch, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           bytes=nbytes, ops=ops, eager_call_ms=call_ms,
                           max_abs_err=err, bitwise=pair)
                cases.append(rec)
                print(f"[kernel] {name:6s} {d_in}->{n_out} k={k} {dtype_name:8s} B={b:3d} "
                      f"{launch:6s}: ms {ms:.5f} | plain {plain_ms:.5f} | torch.matmul "
                      f"{library_ms:.5f} | bound {rec['bound_ms']:.5f} ({rec['bound_by']}) | "
                      f"eager call {call_ms:.5f} | max_abs_err {err:.3g} | {pair}: bitwise")
            del weight_sets, dense_sets
    torch.cuda.empty_cache()
    return cases


def _device_profile(fn, label: str) -> None:
    """Device busy share and the kernels that take the device time of one
    generate call, from torch.profiler (wall time from an unprofiled call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():  # device-side records only: kernels and copies
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    rows = [(name, ms, count) for name, (ms, count) in by_name.items()]
    if not rows:
        print(f"[profile:{label}] device time not measured (no CUDA events)")
        return
    device_ms = sum(r[1] for r in rows)
    k1 = [r for r in rows if "condensed_fwd_kernel" in r[0]]
    k1_ms = sum(r[1] for r in k1)
    print(f"[profile:{label}] generate {BATCH}x{PROMPT}+{GEN}: wall {wall_ms:.2f} ms, "
          f"device busy {device_ms:.3f} ms ({device_ms / wall_ms:.1%}), idle "
          f"{1 - device_ms / wall_ms:.1%}; K1 {k1_ms:.3f} ms in "
          f"{sum(r[2] for r in k1)} launches ({k1_ms / device_ms:.1%} of device time)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"[profile:{label}]   {ms:9.3f} ms {count:6d}x {key[:90]}")


def _first_divergence(a, b):
    """Per stream: index of the first differing token, or None."""
    out = []
    for ra, rb in zip(a.tolist(), b.tolist()):
        out.append(next((j for j, (p, q) in enumerate(zip(ra, rb)) if p != q), None))
    return out


def _masked_gaps(cfg, model, prompts, gen_len: int):
    """The masked path's own greedy run, step by step: its tokens and the
    top-2 logit gap at each generated position."""
    import torch
    from repro_torch.models import model as M
    with torch.inference_mode():
        b, t = prompts.shape
        cache = M.init_cache(cfg, b, t + gen_len, device=prompts.device)
        logits, cache = M.prefill_step(cfg, model.compute, model.serving,
                                       {"tokens": prompts}, cache)
        toks, gaps = [], []
        for step in range(gen_len):
            if not torch.isfinite(logits[:, :cfg.vocab_size]).all():
                raise AssertionError("non-finite logits on the masked path")
            top2 = logits.topk(2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            toks.append(cur[:, 0])
            if step + 1 < gen_len:
                logits, cache = M.decode_step(cfg, model.compute, model.serving,
                                              {"tokens": cur}, cache)
        return torch.stack(toks, 1), torch.stack(gaps, 1)


def slice_phase(device, card: str):
    """Full-width qwen3-1.7b through both paths; returns K1's launch count."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.launch.engine import ServingModel
    from repro_torch.models import model as M
    from repro_torch.sparse import condensed as COND
    from repro_torch.sparse import registry as REG

    base = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(0)
    reg = REG.build_registry(base)
    k_fan = REG.k_fan_map(base, reg)
    if k_fan != {"wo": 293, "w_gate": 195, "w_up": 195, "w_down": 585}:
        raise AssertionError(f"unexpected fan-ins {k_fan}")
    t0 = time.perf_counter()
    params = M.init_params(base, gen, k_fan)
    masks = REG.init_sparsity_state(base, gen, reg)["masks"]
    prompts = torch.randint(0, base.vocab_size, (BATCH, PROMPT), generator=gen,
                            device=device, dtype=torch.int32)
    torch.cuda.synchronize()
    print(f"[slice] {ARCH}: {base.n_layers} layers, d_model {base.d_model}, d_ff "
          f"{base.d_ff}, vocab {base.vocab_size}; fan-ins {k_fan}; init "
          f"{time.perf_counter() - t0:.1f}s")
    expected = 4 * base.n_layers * (1 + GEN)
    launches = None
    for dtype_name in ("bfloat16", "float32"):
        cfg = base.replace(dtype=dtype_name)
        t0 = time.perf_counter()
        cond = COND.export_condensed(cfg, reg, params, masks)
        for s in reg:
            leaf = REG.get_path(cond, s.path)
            if leaf.values.shape[-1] != k_fan[s.path[-1]]:
                raise AssertionError(f"{s.name}: exported k {leaf.values.shape[-1]}")
        torch.cuda.synchronize()
        print(f"[slice:{dtype_name}] condensed export {time.perf_counter() - t0:.1f}s")
        cond_model = ServingModel(cfg, params, cond)
        masked_model = ServingModel(cfg, params, masks)
        cond_model.generate(prompts, GEN)  # warm-up outside the counted run
        masked_model.generate(prompts, GEN)

        cm.condensed_matmul.launches = 0
        out_c, tok_s_c = cond_model.serve_once(prompts, GEN, "condensed")
        n = cm.condensed_matmul.launches
        if n != expected:
            raise AssertionError(f"K1 launched {n} times, expected {expected}")
        out_m, tok_s_m = masked_model.serve_once(prompts, GEN, "masked")
        if launches is None:
            launches = n
            _device_profile(lambda: cond_model.generate(prompts, GEN), "condensed")
            _device_profile(lambda: masked_model.generate(prompts, GEN), "masked")
        tok_s = {"condensed": [tok_s_c], "masked": [tok_s_m]}
        for rep in range(1, REPEATS):  # alternate which path runs first
            for path in (("masked", "condensed") if rep % 2 else ("condensed", "masked")):
                model, first = ((cond_model, out_c) if path == "condensed"
                                else (masked_model, out_m))
                out, rate = model.serve_once(prompts, GEN, path, quiet=True)
                if not torch.equal(out, first):
                    raise AssertionError(f"{path}: a repeated run gave other tokens")
                tok_s[path].append(rate)
        toks_m, gaps = _masked_gaps(cfg, masked_model, prompts, GEN)
        if not torch.equal(toks_m, out_m[:, PROMPT:]):
            raise AssertionError("masked step-by-step run differs from generate")
        for out in (out_c, out_m):
            if out.shape != (BATCH, PROMPT + GEN) or not bool(
                    ((out >= 0) & (out < cfg.vocab_size)).all()):
                raise AssertionError(f"bad tokens: shape {tuple(out.shape)}")
        div = _first_divergence(out_c[:, PROMPT:], out_m[:, PROMPT:])
        for b, j in enumerate(div):
            if j is None:
                continue
            gap = gaps[b, j].item()
            print(f"[slice:{dtype_name}] stream {b}: paths part at generated "
                  f"token {j}, masked top-2 gap {gap:.3g} (tie below "
                  f"{TIE_GAP[dtype_name]})")
            if gap >= TIE_GAP[dtype_name]:
                raise AssertionError(f"condensed and masked tokens differ at a "
                                     f"gap of {gap} ({dtype_name})")
        rates = "; ".join(
            f"{p} median {statistics.median(r):.1f} tok/s (min {min(r):.1f}, max "
            f"{max(r):.1f}, n={len(r)})" for p, r in tok_s.items())
        print(f"[slice:{dtype_name}] {card}: decode {rates}; K1 launches {n}; "
              f"streams agreeing in full "
              f"{sum(j is None for j in div)}/{BATCH}; min masked top-2 gap "
              f"{gaps.min().item():.3g}")
        print(f"[slice:{dtype_name}] condensed first stream: {out_c[0, PROMPT:].tolist()}")
        del cond, cond_model, masked_model
        torch.cuda.empty_cache()
    return launches


def reference_phase(device):
    """The smoke config on the card against the port's CPU path."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import engine as E
    from repro_torch.models import model as M
    from repro_torch.sparse import condensed as COND
    from repro_torch.sparse import registry as REG

    cfg = configs.get_smoke_config(ARCH)
    gen = torch.Generator(device="cpu").manual_seed(0)
    reg = REG.build_registry(cfg)
    params = M.init_params(cfg, gen, REG.k_fan_map(cfg, reg))
    masks = REG.init_sparsity_state(cfg, gen, reg)["masks"]
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen, dtype=torch.int32)
    cond = COND.export_condensed(cfg, reg, params, masks)
    cpu = E.generate(cfg, params, cond, prompts, 10)

    def to_dev(tree):  # tensors and Condensed leaves alike
        return {k: to_dev(v) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}
    gpu = E.generate(cfg, to_dev(params), to_dev(cond), prompts.to(device), 10)
    if not torch.equal(gpu.cpu(), cpu):
        raise AssertionError(f"smoke tokens differ: card {gpu.tolist()} cpu {cpu.tolist()}")
    print(f"[reference] smoke {ARCH} condensed on the card == CPU plain path: "
          f"{cpu[0, 8:].tolist()}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels import condensed_matmul as cm

    # full float32 products and reductions in every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")

    build_phase()
    cases = kernel_phase(device)
    launches = slice_phase(device, card)
    reference_phase(device)

    out_dir = REPO / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_kernels.json").write_text(
        json.dumps({"card": smi, "cases": cases}, indent=1))
    layer = [c for c in cases if c["dtype"] == "bfloat16" and c["launch"] == "decode"]
    per_layer = {"wo": 1, "w_gate": 2, "w_down": 1}  # w_up shares w_gate's shape
    total = {key: sum(c[key] * per_layer[c["stack"]] for c in layer)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    kernels = [{
        "name": "condensed_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/condensed_matmul.cu",
        "replaces": "src/repro/kernels/condensed_matmul.py:235",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in layer),
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in layer) else "operations",
        "library_ms": total["library_ms"],
        "shape": "one decode layer: wo + w_gate + w_up + w_down, B=4, bfloat16",
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
