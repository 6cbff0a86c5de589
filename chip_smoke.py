#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on any failed check:

1. build: every CUDA source under src/repro_torch/kernels/csrc, compiled
   with nvcc for sm_90a, all at once.
2. kernels: the condensed gather kernel (K1) at every shape the serving
   path of full-width qwen3-1.7b gives it (wo, w_gate/w_up, w_down; decode
   B=4 and prefill B*T=128; bfloat16 and float32), then K4 (condensed over
   active rows), K5 (structured) and K6 (structured, gather inside; decode
   only) at the shapes of those stacks with half their neurons ablated.
   Each is held to its plain version within the stated tolerance, with
   the decode launch bitwise equal to the tiled launch, K6 bitwise equal
   to K5 and K4 bitwise equal to K1 on the same rows followed by a
   scatter. Then K2 (the condensed gather over int8 / fp8 codes with a
   float32 scale per neuron) at K1's shapes and K2-coa (the same over the
   surviving rows, stored through out_index) at K4's, each with int8 and
   fp8 codes, bf16 and f32 x, B=4 and B*T=128: decode == tiled bitwise,
   K2-coa == K2 on the same rows then a scatter bitwise, and in f32
   K2 == K1(f32(codes)) * scales bitwise. Times are CUDA-event medians over
   replays of a CUDA graph of launches that cycle through enough copies of
   the weights to keep L2 cold.
3. slice: full-width qwen3-1.7b (28 layers, random weights from a seeded
   torch.Generator), SRigL ERK masks at 90%, condensed export, greedy
   generation at B=4, prompt 32, gen 16 on the condensed and the masked
   path, in bfloat16 and again in float32. The condensed run must launch
   K1 exactly 4 * 28 * (1 + 16) times; the two paths' tokens must agree
   except where the masked path's top-2 logit gap is a tie at that dtype.
4. ablation: the same model with half of every stack's neurons ablated:
   condensed_over_active on the ablated masks (K4 4 * 28 * 17 times),
   structured on ablation-only masks (K5 4 * 28 * 17 times) and again with
   prefetch_gather (K6 4 * 28 * 16 times at decode, K5 4 * 28 at prefill),
   each against the masked path on its own masks, bf16 and f32.
5. auto: --path auto on the ablated masks at B=4 (bucket 8); each kernel
   must launch as often as the plan's decisions imply.
6. quant: --values-dtype int8 and fp8 on full-width qwen3-1.7b, bf16 and
   f32: condensed on the 90% masks and condensed_over_active on the ablated
   masks must launch K2 (K2-coa) 4 * 28 * 17 times and nothing else, and
   their tokens agree, except at near-ties, with a twin that serves the
   same codes and scales dequantized into a float export through K1 (K4);
   structured int8 on ablation-only masks (K5 4 * 28 * 17 times) gives its
   dequantized twin's tokens exactly (the twin dequantizes the panel as the
   format does, so this checks the launch counts; phase 8 holds the path to
   the CPU).
7. checkpoint: the int8 condensed serving tree saved with
   repro_torch.train.checkpoint.save and restored into a fresh template on
   the card gives identical arrays and identical tokens.
8. reference: the smoke config on the card against the port's CPU path
   (plain versions), which the CPU tests hold to the JAX reference, on the
   condensed, condensed_over_active and structured paths, each with float,
   int8 and fp8 values: identical tokens, and the path's kernel launched.

Imports only torch, numpy, the standard library and repro_torch. Prints
the card's name and power limit, a JSON line describing each kernel, and
last a JSON line with the device. Per-shape kernel numbers also go to
build/chip_smoke_kernels.json.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
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
# Two correct paths' bf16 logits differ by more than TIE_GAP: per-output
# rounding of every linear compounds over 28 layers (measured at prefill,
# NVIDIA H100: up to 0.078 condensed, 0.14 structured, against masked). The
# ablation paths are therefore held to masked with a tie threshold of
# max(TIE_GAP, 2 * d), where d is the largest |logit difference| the two
# paths show on the same prefill (a top-2 swap needs a gap below 2 * d),
# and d itself must stay below this bound.
LOGIT_NOISE_BOUND = {"bfloat16": 0.25, "float32": 5e-4}
CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = (  # key, wrapper (call), CUDA source, the TPU kernel it replaces
    ("K1", "condensed_matmul", CSRC + "condensed_matmul.cu",
     "src/repro/kernels/condensed_matmul.py:235"),
    ("K4", "condensed_over_active_matmul", CSRC + "structured_matmul.cu",
     "src/repro/kernels/structured_matmul.py:274"),
    ("K5", "structured_matmul", CSRC + "structured_matmul.cu",
     "src/repro/kernels/structured_matmul.py:217"),
    ("K6", "structured_matmul_prefetch", CSRC + "structured_matmul.cu",
     "src/repro/kernels/structured_matmul.py:244"),
    ("K2", "condensed_matmul(scales=)", CSRC + "condensed_matmul.cu",
     "src/repro/kernels/condensed_matmul.py:254"),
    ("K2-coa", "condensed_over_active_matmul(scales=)", CSRC + "structured_matmul.cu",
     "src/repro/kernels/structured_matmul.py:297"),
)
QUANT = ("int8", "fp8")  # the quantized --values-dtype choices
QUANT_REPEATS = 3  # timed generate runs per quantized path and dtype
ABLATION = 0.5  # fraction of each sparse stack's output neurons ablated
# the port's kernels as the profiler names them: K1 and K4 share
# gather_rows_kernel, K5 and K6 structured_kernel
PORT_KERNEL_NAMES = ("gather_rows_kernel", "structured_kernel")


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
        if name in _build.build_logs:  # what ptxas said of the source's kernels
            log = _build.build_logs[name]
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
            spills = [int(r) for r in re.findall(r"(\d+) bytes spill stores", log)]
            smem = [int(r) for r in re.findall(r"(\d+) bytes smem", log)] or [0]
            print(f"[build] {name}: {_build.build_seconds[name]:.1f}s, {len(regs)} kernels, "
                  f"registers {min(regs)}-{max(regs)}, static smem up to {max(smem)} bytes, "
                  f"spill stores up to {max(spills)} bytes")


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
                rec = dict(kernel="K1", stack=name, d_in=d_in, n_out=n_out, k=k,
                           dtype=dtype_name, batch=b, launch=launch, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           bytes=nbytes, ops=ops, eager_call_ms=call_ms,
                           max_abs_err=err, bitwise=pair)
                cases.append(rec)
                print(f"[kernel] K1  {name:6s} {d_in}->{n_out} k={k} {dtype_name:8s} B={b:3d} "
                      f"{launch:6s}: ms {ms:.5f} | plain {plain_ms:.5f} | torch.matmul "
                      f"{library_ms:.5f} | bound {rec['bound_ms']:.5f} ({rec['bound_by']}) | "
                      f"eager call {call_ms:.5f} | max_abs_err {err:.3g} | {pair}: bitwise")
            del weight_sets, dense_sets
    torch.cuda.empty_cache()
    return cases


def _ablated(mask, frac: float):
    """``mask`` with the last ``frac`` of its output columns emptied."""
    import torch
    d_out = mask.shape[-1]
    cut = d_out - max(1, int(d_out * frac))
    return mask & (torch.arange(d_out, device=mask.device) < cut)


def _ablate_masks(reg, masks, frac: float):
    """Constant fan-in masks with SRigL-style neuron ablation on top (the
    reference's benchmarks/serve_paths.py _ablate_masks)."""
    from repro_torch.sparse import registry as REG
    out: dict = {}
    for s in reg:
        REG.set_path(out, s.path, _ablated(REG.get_path(masks, s.path), frac))
    return out


def _ablation_only(reg, masks, frac: float):
    """Masks that are purely neuron ablation: active columns fully dense,
    ablated ones empty (the reference's tests/test_plan.py _ablation_only),
    where the structured representation is exact."""
    import torch
    from repro_torch.sparse import registry as REG
    out: dict = {}
    for s in reg:
        m = REG.get_path(masks, s.path)
        REG.set_path(out, s.path, _ablated(torch.ones_like(m), frac))
    return out


def ablation_kernel_phase(device):
    """K4, K5 and K6 at every main-path shape of the ablated stacks; returns
    the per-case records."""
    import torch
    from repro_torch import configs
    from repro_torch.core import distributions as D
    from repro_torch.core import topology
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.kernels import structured_matmul as sm
    from repro_torch.sparse import formats as F
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(2)
    shapes = {}
    for s in REG.build_registry(cfg):  # w_up has w_gate's shape
        shapes.setdefault((s.d_in, s.d_out), (s.path[-1], D.fan_in_from_density(s.d_in, s.density)))
    cases = []

    def record(kernel, name, d_in, d_out, dtype_name, b, launch, fn, arg_sets, plain,
               library, library_sets, nbytes, ops, err, pair):
        ms = _time_ms(fn, arg_sets)
        plain_ms = _time_ms(plain, arg_sets, iters=10)
        library_ms = _time_ms(library, library_sets)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
        rec = dict(kernel=kernel, stack=name, d_in=d_in, d_out=d_out, dtype=dtype_name,
                   batch=b, launch=launch, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, ops=ops, max_abs_err=err, bitwise=pair)
        cases.append(rec)
        print(f"[kernel] {kernel:3s} {name:6s} {d_in}->{d_out} {dtype_name:8s} B={b:3d} "
              f"{launch:6s}: ms {ms:.5f} | plain {plain_ms:.5f} | library {library_ms:.5f} | "
              f"bound {rec['bound_ms']:.5f} ({rec['bound_by']}) | max_abs_err {err:.3g} | "
              f"{pair}: bitwise")

    def check(kernel, got, want, dtype_name, what):
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype_name],
                                   msg=lambda m: f"{kernel} {what}: {m}")
        return (got.float() - want.float()).abs().max().item()

    def same(kernel, a, b, what):
        if not torch.equal(a, b):
            raise AssertionError(f"{kernel} {what} is not bitwise")

    for (d_in, d_out), (name, k) in shapes.items():
        mask = _ablated(topology.random_constant_fan_in_mask(gen, d_in, d_out, k), ABLATION)
        w = torch.randn((d_in, d_out), generator=gen, device=device) / k ** 0.5
        only = _ablated(torch.ones_like(mask), ABLATION)
        stats = F.realized_stats(mask)
        a_pad = sm.padded_active_count(stats.max_active, d_out)
        print(f"[kernel] {name} {d_in}->{d_out}: k {stats.k}, a = a_pad = {a_pad}")
        if stats.k != k or a_pad != stats.max_active:
            raise AssertionError(f"{name}: k {stats.k}, a {stats.max_active}, a_pad {a_pad}")
        coa = F.CondensedOverActive.export_from_dense(w, mask, stats)
        ai = F.StructuredFanIn.from_mask(only).active_index
        ai_long = ai.long()
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            isz = torch.empty((), dtype=dtype).element_size()
            vals, idx, oi = coa.values.to(dtype).contiguous(), coa.indices, coa.out_index
            masked = (w * mask).to(dtype).contiguous()
            dense = w.to(dtype).contiguous()
            panel = sm._gather_columns(dense, ai)
            coa_sets = [(vals.clone(), idx.clone(), oi.clone())
                        for _ in range(_copies(vals.numel() * (isz + 4)))]
            masked_sets = [masked.clone() for _ in range(_copies(masked.numel() * isz))]
            panel_sets = [panel.clone() for _ in range(_copies(panel.numel() * isz))]
            dense_sets = [dense.clone() for _ in range(_copies(dense.numel() * isz))]
            for b, launch in ((BATCH, "decode"), (BATCH * PROMPT, "tiled")):
                x = torch.randn((b, d_in), generator=gen, device=device).to(dtype)
                out_bytes = b * d_in * isz + b * d_out * isz

                # K4
                y = sm.condensed_over_active_matmul(x, vals, idx, oi, d_out)
                err = check("K4", y, ref.condensed_over_active_matmul_ref(x, vals, idx, oi, d_out),
                            dtype_name, f"{name} B={b}")
                other = (sm.condensed_over_active_matmul(x, vals, idx, oi, d_out, block_b=8)
                         if launch == "decode" else
                         sm.condensed_over_active_matmul(x, vals, idx, oi, d_out, block_b=2))
                pair = "decode == tiled(8)" if launch == "decode" else "tiled(8) == tiled(2)"
                same("K4", y, other, f"{name} {dtype_name} B={b}: {pair}")
                k1 = ref._scatter_columns(cm.condensed_matmul(x, vals, idx), oi, d_out)
                same("K4", y, k1, f"{name} {dtype_name} B={b}: K4 == K1 then scatter")
                k1_rows_ms = _time_ms(lambda x_, v_, i_, o_: cm.condensed_matmul(x_, v_, i_),
                                      [(x, *c) for c in coa_sets])
                record("K4", name, d_in, d_out, dtype_name, b, launch,
                       lambda *a: sm.condensed_over_active_matmul(*a, d_out),
                       [(x, *c) for c in coa_sets],
                       lambda *a: ref.condensed_over_active_matmul_ref(*a, d_out),
                       torch.matmul, [(x, m) for m in masked_sets],
                       vals.numel() * (isz + 4) + oi.numel() * 4 + out_bytes,
                       2 * b * vals.numel(), err, pair + ", K4 == K1 then scatter")
                cases[-1]["k1_same_rows_ms"] = k1_rows_ms
                print(f"[kernel] K1  {name:6s} on K4's {vals.shape[0]} rows, unscattered: "
                      f"ms {k1_rows_ms:.5f}")

                # K5, on the gathered panel
                y = sm.structured_matmul_pregathered(x, panel, ai, d_out)
                want = ref.structured_matmul_ref(x, panel, ai, d_out)
                err = check("K5", y, want, dtype_name, f"{name} B={b}")
                if launch == "decode":
                    other = sm.structured_matmul_pregathered(x, panel, ai, d_out, block_b=16)
                    pair = "decode == tiled(16)"
                else:
                    other = sm.structured_matmul_pregathered(x, panel, ai, d_out, block_b=2)
                    pair = "tiled(16) == tiled(2)"
                same("K5", y, other, f"{name} {dtype_name} B={b}: {pair}")
                same("K5", y, sm.structured_matmul(x, dense, ai),
                     f"{name} {dtype_name} B={b}: pregathered == gathered by the wrapper")
                struct_bytes = panel.numel() * isz + ai.numel() * 4 + out_bytes
                struct_ops = 2 * b * panel.numel()
                record("K5", name, d_in, d_out, dtype_name, b, launch,
                       lambda x_, p_: sm.structured_matmul_pregathered(x_, p_, ai, d_out),
                       [(x, p) for p in panel_sets],
                       lambda x_, p_: ref.structured_matmul_ref(x_, p_, ai, d_out),
                       lambda x_, p_: torch.zeros((b, d_out), dtype=dtype, device=device)
                       .index_copy_(1, ai_long, torch.matmul(x_, p_)),
                       [(x, p) for p in panel_sets], struct_bytes, struct_ops, err, pair)

                # K6, decode only: reads the dense weight through active_index
                if launch == "decode":
                    y6 = sm.structured_matmul_prefetch(x, dense, ai)
                    err = check("K6", y6, want, dtype_name, f"{name} B={b}")
                    same("K6", y6, y, f"{name} {dtype_name} B={b}: K6 == K5 decode")
                    record("K6", name, d_in, d_out, dtype_name, b, launch,
                           lambda x_, w_: sm.structured_matmul_prefetch(x_, w_, ai),
                           [(x, d) for d in dense_sets],
                           lambda x_, w_: ref.structured_matmul_ref(
                               x_, sm._gather_columns(w_, ai), ai, d_out),
                           lambda x_, p_: torch.zeros((b, d_out), dtype=dtype, device=device)
                           .index_copy_(1, ai_long, torch.matmul(x_, p_)),
                           [(x, p) for p in panel_sets], struct_bytes, struct_ops, err,
                           "K6 == K5 decode")
            del coa_sets, masked_sets, panel_sets, dense_sets
    torch.cuda.empty_cache()
    return cases


def quant_kernel_phase(device):
    """K2 at K1's main-path shapes and K2-coa at K4's (half of each stack's
    neurons ablated), int8 and fp8 codes, bf16 and f32 x; returns the
    per-case records."""
    import torch
    from repro_torch import configs
    from repro_torch.core import distributions as D
    from repro_torch.core import topology
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import ref
    from repro_torch.kernels import structured_matmul as sm
    from repro_torch.sparse import formats as F
    from repro_torch.sparse import registry as REG

    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(3)
    shapes = {}
    for s in REG.build_registry(cfg):  # w_up has w_gate's shape
        shapes.setdefault((s.d_in, s.d_out), (s.path[-1], D.fan_in_from_density(s.d_in, s.density)))
    cases = []

    def same(kernel, a, b, what):
        if not torch.equal(a, b):
            raise AssertionError(f"{kernel} {what} is not bitwise")

    for (d_in, d_out), (name, k) in shapes.items():
        mask = topology.random_constant_fan_in_mask(gen, d_in, d_out, k)
        w = torch.randn((d_in, d_out), generator=gen, device=device) / k ** 0.5
        ablated = _ablated(mask, ABLATION)
        for qdt in QUANT:
            full = F.Condensed.export_from_dense(w, mask, quantize_spec=qdt)
            coa = F.CondensedOverActive.export_from_dense(w, ablated, quantize_spec=qdt)
            if full.values.shape[-1] != k or coa.values.shape[0] != d_out // 2:
                raise AssertionError(f"{name} {qdt}: k {full.values.shape[-1]}, a "
                                     f"{coa.values.shape[0]}")
            oi = coa.out_index
            for dtype_name in ("bfloat16", "float32"):
                dtype = getattr(torch, dtype_name)
                isz = torch.empty((), dtype=dtype).element_size()
                kernels = {  # key: (codes, indices, scales, out_index or None)
                    "K2": (full.values, full.indices, full.scales, None),
                    "K2-coa": (coa.values, coa.indices, coa.scales, oi),
                }
                for key, (q, idx, sc, out_index) in kernels.items():
                    rows = q.shape[0]
                    deq = topology.condensed_to_dense(F.dequantize_values(q, sc), idx, d_in)
                    if out_index is not None:  # rows to their dense columns
                        deq = ref._scatter_columns(deq, out_index, d_out)
                    deq = deq.to(dtype).contiguous()
                    meta_bytes = rows * 4 + (rows * 4 if out_index is not None else 0)
                    weight_bytes = q.numel() * 5 + meta_bytes  # codes + int32 indices
                    sets = [(q.clone(), idx.clone(), sc.clone())
                            for _ in range(_copies(weight_bytes))]
                    dense_sets = [deq.clone() for _ in range(_copies(deq.numel() * isz))]
                    if out_index is None:
                        def fn(x_, q_, i_, s_, block_b=None):
                            return cm.condensed_matmul(x_, q_, i_, scales=s_, block_b=block_b)
                        plain = ref.condensed_matmul_scaled_ref
                    else:
                        def fn(x_, q_, i_, s_, block_b=None):
                            return sm.condensed_over_active_matmul(
                                x_, q_, i_, out_index, d_out, scales=s_, block_b=block_b)

                        def plain(x_, q_, i_, s_):
                            return ref.condensed_over_active_matmul_scaled_ref(
                                x_, q_, i_, out_index, s_, d_out)
                    for b, launch in ((BATCH, "decode"), (BATCH * PROMPT, "tiled")):
                        x = torch.randn((b, d_in), generator=gen, device=device).to(dtype)
                        what = f"{name} {qdt} {dtype_name} B={b}"
                        y = fn(x, q, idx, sc)
                        want = plain(x, q, idx, sc)
                        torch.cuda.synchronize()
                        torch.testing.assert_close(y.float(), want.float(), **TOL[dtype_name],
                                                   msg=lambda m: f"{key} {what}: {m}")
                        err = (y.float() - want.float()).abs().max().item()
                        pairs = ["decode == tiled(8)" if launch == "decode"
                                 else "tiled(8) == tiled(2)"]
                        same(key, y, fn(x, q, idx, sc, block_b=8 if launch == "decode" else 2),
                             f"{what}: {pairs[0]}")
                        if out_index is None and dtype_name == "float32":
                            same(key, y, cm.condensed_matmul(x, q.float(), idx) * sc,
                                 f"{what}: K2 == K1(f32(q)) * s")
                            pairs.append("K2 == K1(f32(q)) * s")
                        if out_index is not None:
                            rows_y = cm.condensed_matmul(x, q, idx, scales=sc)
                            same(key, y, ref._scatter_columns(rows_y, out_index, d_out),
                                 f"{what}: K2-coa == K2 rows then scatter")
                            pairs.append("K2-coa == K2 rows then scatter")
                        ms = _time_ms(fn, [(x, *c) for c in sets])
                        plain_ms = _time_ms(plain, [(x, *c) for c in sets], iters=10)
                        library_ms = _time_ms(torch.matmul, [(x, dd) for dd in dense_sets])
                        nbytes = weight_bytes + b * d_in * isz + b * d_out * isz
                        ops = 2 * b * q.numel() + b * rows  # the FMAs and the scale multiply
                        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                        t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
                        rec = dict(kernel=key, stack=name, d_in=d_in, d_out=d_out, rows=rows,
                                   k=k, codes=qdt, dtype=dtype_name, batch=b, launch=launch,
                                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                   bound_ms=max(t_bytes, t_ops),
                                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                                   bytes=nbytes, ops=ops, max_abs_err=err,
                                   bitwise=", ".join(pairs))
                        cases.append(rec)
                        print(f"[kernel] {key:6s} {name:6s} {d_in}->{d_out} rows={rows} k={k} "
                              f"{qdt:4s} {dtype_name:8s} B={b:3d} {launch:6s}: ms {ms:.5f} | "
                              f"plain {plain_ms:.5f} | torch.matmul (dequantized) "
                              f"{library_ms:.5f} | bound {rec['bound_ms']:.5f} "
                              f"({rec['bound_by']}) | max_abs_err {err:.3g} | "
                              f"{rec['bitwise']}: bitwise")
                    del sets, dense_sets, deq
    torch.cuda.empty_cache()
    return cases


def k3_bound() -> None:
    """K3 (the values gradient, not ported yet) at qwen3-1.7b's full-width
    stacks for B*T = 128, float32: its byte bound (dy + x + idx + dw, each
    once) and its operation bound, computed from the shapes, not run."""
    from repro_torch import configs
    from repro_torch.core import distributions as D
    from repro_torch.sparse import registry as REG
    b, total = BATCH * PROMPT, 0.0
    for s in REG.build_registry(configs.get_config(ARCH)):
        k = D.fan_in_from_density(s.d_in, s.density)
        nbytes = 4 * (b * s.d_out + b * s.d_in + 2 * s.d_out * k)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * b * s.d_out * k / PEAK_OPS_PER_S["float32"] * 1e3
        total += max(t_bytes, t_ops)
        print(f"[bound] K3 {s.path[-1]:6s} {s.d_in}->{s.d_out} k={k} B*T={b} float32: "
              f"{nbytes} bytes, byte bound {t_bytes:.5f} ms, operation bound {t_ops:.5f} ms "
              f"(computed, not run)")
    print(f"[bound] K3 one layer (wo + w_gate + w_up + w_down): {total:.5f} ms")


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
    ours = [r for r in rows if any(k in r[0] for k in PORT_KERNEL_NAMES)]
    ours_ms = sum(r[1] for r in ours)
    print(f"[profile:{label}] generate {BATCH}x{PROMPT}+{GEN}: wall {wall_ms:.2f} ms, "
          f"device busy {device_ms:.3f} ms ({device_ms / wall_ms:.1%}), idle "
          f"{1 - device_ms / wall_ms:.1%}; port kernels {ours_ms:.3f} ms in "
          f"{sum(r[2] for r in ours)} launches ({ours_ms / device_ms:.1%} of device time)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"[profile:{label}]   {ms:9.3f} ms {count:6d}x {key[:90]}")


def _rates(tok_s: dict) -> str:
    return "; ".join(f"{p} median {statistics.median(r):.1f} tok/s (min {min(r):.1f}, max "
                     f"{max(r):.1f}, n={len(r)})" for p, r in tok_s.items())


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


def _kernel_counters() -> dict:
    """Each kernel's launch counter: its wrapper function and the attribute
    the wrapper adds to (K2 and K2-coa count on K1's and K4's wrappers)."""
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.kernels import structured_matmul as sm
    return {"K1": (cm.condensed_matmul, "launches"),
            "K4": (sm.condensed_over_active_matmul, "launches"),
            "K5": (sm.structured_matmul, "launches"),
            "K6": (sm.structured_matmul_prefetch, "launches"),
            "K2": (cm.condensed_matmul, "scaled_launches"),
            "K2-coa": (sm.condensed_over_active_matmul, "scaled_launches")}


def _none() -> dict:
    """Every kernel's count at 0 (an expected-launches dict to fill in)."""
    return {name: 0 for name in _kernel_counters()}


def _zero_counts() -> None:
    for fn, attr in _kernel_counters().values():
        setattr(fn, attr, 0)


def _counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _kernel_counters().items()}


def _check_ties(label: str, cfg, out, toks_m, gaps, tie: float | None = None,
                against: str = "masked") -> int:
    """Tokens of a path against the masked path's on the same masks (or
    another path's, named by ``against``): they may part only where that
    path's top-2 logit gap is a tie (below ``tie``, by default TIE_GAP at
    this dtype). Returns the number of streams that agree in full."""
    dtype_name = cfg.dtype
    tie = TIE_GAP[dtype_name] if tie is None else tie
    if out.shape != (BATCH, PROMPT + GEN) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{label}: bad tokens, shape {tuple(out.shape)}")
    div = _first_divergence(out[:, PROMPT:], toks_m)
    for b, j in enumerate(div):
        if j is None:
            continue
        gap = gaps[b, j].item()
        print(f"[{label}] stream {b}: parts from {against} at generated token {j}, {against} "
              f"top-2 gap {gap:.3g} (tie below {tie:.3g})")
        if gap >= tie:
            raise AssertionError(f"{label}: tokens differ from {against} at a gap of {gap}")
    return sum(j is None for j in div)


def model_setup(device) -> dict:
    """Full-width qwen3-1.7b: random weights and SRigL ERK masks at 90% from
    a seeded generator, and the prompts every path serves."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
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
    return dict(base=base, reg=reg, k_fan=k_fan, params=params, masks=masks, prompts=prompts)


def slice_phase(setup: dict, card: str):
    """Full-width qwen3-1.7b through both paths; returns K1's launch count."""
    import torch
    from repro_torch.kernels import condensed_matmul as cm
    from repro_torch.launch.engine import ServingModel
    from repro_torch.sparse import condensed as COND
    from repro_torch.sparse import registry as REG

    base, reg, k_fan = setup["base"], setup["reg"], setup["k_fan"]
    params, masks, prompts = setup["params"], setup["masks"], setup["prompts"]
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

        _zero_counts()
        out_c, tok_s_c = cond_model.serve_once(prompts, GEN, "condensed")
        n = cm.condensed_matmul.launches
        if _counts() != {**_none(), "K1": expected}:
            raise AssertionError(f"condensed path launched {_counts()}, expected K1 "
                                 f"{expected} and nothing else")
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
        _check_ties(f"slice:{dtype_name}", cfg, out_m, toks_m, gaps)
        agree = _check_ties(f"slice:{dtype_name}", cfg, out_c, toks_m, gaps)
        print(f"[slice:{dtype_name}] {card}: decode {_rates(tok_s)}; K1 launches {n}; "
              f"streams agreeing in full {agree}/{BATCH}; min masked top-2 gap "
              f"{gaps.min().item():.3g}")
        print(f"[slice:{dtype_name}] condensed first stream: {out_c[0, PROMPT:].tolist()}")
        del cond, cond_model, masked_model
        torch.cuda.empty_cache()
    return launches


def _tie_threshold(label: str, cfg, model, masked_model, prompts,
                   against: str = "masked") -> float:
    """max(TIE_GAP, 2 * d), d the largest |logit difference| between a path
    and masked (or the path ``against`` names) on the same prefill; d must
    stay below LOGIT_NOISE_BOUND."""
    import torch
    from repro_torch.models import model as M
    logits = []
    with torch.inference_mode():
        for m in (model, masked_model):
            cache = M.init_cache(cfg, prompts.shape[0], prompts.shape[1], prompts.device)
            lg, _ = M.prefill_step(cfg, m.compute, m.serving, {"tokens": prompts}, cache)
            logits.append(lg[:, :cfg.vocab_size])
        d = (logits[0] - logits[1]).abs().max().item()
    if not d <= LOGIT_NOISE_BOUND[cfg.dtype]:
        raise AssertionError(f"{label}: prefill logits differ from {against} by {d}, above "
                             f"{LOGIT_NOISE_BOUND[cfg.dtype]}")
    tie = max(TIE_GAP[cfg.dtype], 2 * d)
    print(f"[{label}] prefill logits differ from {against} by at most {d:.4g}: tie below "
          f"{tie:.4g}")
    return tie


@contextlib.contextmanager
def _prefetch_gather(on: bool):
    """REPRO_PREFETCH_GATHER for the structured decode launches inside."""
    old = os.environ.get("REPRO_PREFETCH_GATHER")
    os.environ["REPRO_PREFETCH_GATHER"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_PREFETCH_GATHER"]
        else:
            os.environ["REPRO_PREFETCH_GATHER"] = old


def _serve_counted(label: str, model, prompts, expected: dict, repeats: int = REPEATS):
    """A warm-up, then one run with the launch counts zeroed just before and
    read just after (they must equal ``expected``), then ``repeats`` - 1 more
    timed runs that must give the same tokens. Returns (tokens, tok/s list,
    the counted run's launch counts)."""
    import torch
    model.generate(prompts, GEN)
    _zero_counts()
    out, rate = model.serve_once(prompts, GEN, label, quiet=True)
    counts = _counts()
    if counts != expected:
        raise AssertionError(f"{label}: launched {counts}, expected {expected}")
    rates = [rate]
    for _ in range(1, repeats):
        again, rate = model.serve_once(prompts, GEN, label, quiet=True)
        if not torch.equal(again, out):
            raise AssertionError(f"{label}: a repeated run gave other tokens")
        rates.append(rate)
    return out, rates, counts


def ablation_phase(setup: dict, card: str) -> dict:
    """Full-width qwen3-1.7b with half of every sparse stack's neurons
    ablated: condensed_over_active (K4) on the ablated constant fan-in
    masks, structured (K5) and structured with prefetch_gather (K6 at
    decode, K5 at prefill) on ablation-only masks, each held to the masked
    path on its own masks. Returns the bf16 runs' launch counts."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.launch.engine import ServingModel

    base, reg, params, prompts = setup["base"], setup["reg"], setup["params"], setup["prompts"]
    per_pass = 4 * base.n_layers  # sparse linears per forward pass
    sets = {"ablated": _ablate_masks(reg, setup["masks"], ABLATION),
            "ablation-only": _ablation_only(reg, setup["masks"], ABLATION)}
    none = _none()
    runs = (  # label, mask set, path, prefetch_gather, expected launches
        ("condensed_over_active", "ablated", "condensed_over_active", False,
         {**none, "K4": per_pass * (1 + GEN)}),
        ("structured", "ablation-only", "structured", False,
         {**none, "K5": per_pass * (1 + GEN)}),
        ("structured+prefetch", "ablation-only", "structured", True,
         {**none, "K5": per_pass, "K6": per_pass * GEN}),
    )
    launches = {}
    for dtype_name in ("bfloat16", "float32"):
        cfg = base.replace(dtype=dtype_name)
        tok_s, masked = {}, {}
        for set_name, m in sets.items():
            model = ServingModel(cfg, params, m)
            label = f"masked/{set_name}"
            out, tok_s[label], _ = _serve_counted(label, model, prompts, none)
            toks_m, gaps = _masked_gaps(cfg, model, prompts, GEN)
            if not torch.equal(toks_m, out[:, PROMPT:]):
                raise AssertionError(f"{label}: step-by-step run differs from generate")
            masked[set_name] = (model, toks_m, gaps)
            if dtype_name == "bfloat16":
                _device_profile(lambda: model.generate(prompts, GEN), label)
        outs = {}
        for label, set_name, path, prefetch, expected in runs:
            with _prefetch_gather(prefetch):
                t0 = time.perf_counter()
                plan = serve.build_plan(cfg, reg, params, sets[set_name], path, batch_size=BATCH)
                torch.cuda.synchronize()
                export_s = time.perf_counter() - t0
                model = ServingModel(cfg, params, plan)
                outs[label], tok_s[label], counts = _serve_counted(label, model, prompts,
                                                                   expected)
                if dtype_name == "bfloat16":
                    launches[label] = counts
                    _device_profile(lambda: model.generate(prompts, GEN), label)
                masked_model, toks_m, gaps = masked[set_name]
                name = f"ablation:{dtype_name}:{label}"
                tie = _tie_threshold(name, cfg, model, masked_model, prompts)
                del model, plan
            agree = _check_ties(name, cfg, outs[label], toks_m, gaps, tie)
            print(f"[ablation:{dtype_name}] {label} on the {set_name} masks: export "
                  f"{export_s:.1f}s, launches {expected}, streams agreeing with masked in "
                  f"full {agree}/{BATCH}; first stream {outs[label][0, PROMPT:].tolist()}")
        if not torch.equal(outs["structured+prefetch"], outs["structured"]):
            raise AssertionError(f"{dtype_name}: prefetch_gather changed the structured tokens")
        print(f"[ablation:{dtype_name}] {card}: structured+prefetch tokens == structured "
              f"tokens; decode {_rates(tok_s)}")
        del masked
        torch.cuda.empty_cache()
    return launches


def auto_phase(setup: dict) -> None:
    """--path auto on the ablated masks at B=4 (bucket 8), bf16: the launch
    count of each kernel must be what the plan's decisions imply."""
    from repro_torch.launch import serve
    from repro_torch.launch.engine import ServingModel

    base, reg, params, prompts = setup["base"], setup["reg"], setup["params"], setup["prompts"]
    cfg = base.replace(dtype="bfloat16")
    ablated = _ablate_masks(reg, setup["masks"], ABLATION)
    plan = serve.build_plan(cfg, reg, params, ablated, "auto", batch_size=BATCH)
    print(plan.describe(requested_batch=BATCH))
    if plan.batch_size != 8:
        raise AssertionError(f"B={BATCH} planned at bucket {plan.batch_size}, not 8")
    kernel_of = {"condensed": "K1", "condensed_over_active": "K4", "structured": "K5"}
    expected = _none()
    for s in reg:
        rep = plan.representation_of(s.name)
        if rep in kernel_of:
            expected[kernel_of[rep]] += base.n_layers * (1 + GEN)
    model, masked = ServingModel(cfg, params, plan), ServingModel(cfg, params, ablated)
    with _prefetch_gather(False):
        out, rates, _ = _serve_counted("auto", model, prompts, expected)
    tie = _tie_threshold("auto", cfg, model, masked, prompts)
    agree = _check_ties("auto", cfg, out, *_masked_gaps(cfg, masked, prompts, GEN), tie)
    print(f"[auto] launches {expected} as the decisions imply; streams agreeing with "
          f"masked in full {agree}/{BATCH}; decode {_rates({'auto': rates})}")


def _dequantized_twin(plan, dtype) -> dict:
    """The plan's serving tree with every quantized leaf's codes and scales
    dequantized (at ``dtype``) into a float leaf of the same format: the
    float path (K1, K4, K5) over the same numbers."""
    import dataclasses
    from repro_torch.sparse import formats as F
    from repro_torch.sparse import registry as REG
    out: dict = {}
    for s in plan.registry:
        leaf = REG.get_path(plan.serving_tree, s.path)
        axis = -2 if isinstance(leaf, F.StructuredFanIn) else -1
        REG.set_path(out, s.path, dataclasses.replace(
            leaf, values=F.dequantize_values(leaf.values, leaf.scales, axis=axis, dtype=dtype),
            scales=None, values_dtype=None))
    return out


def quant_phase(setup: dict, card: str) -> dict:
    """--values-dtype int8 / fp8 on full-width qwen3-1.7b: condensed (K2) on
    the 90% masks and condensed_over_active (K2-coa) on the ablated masks,
    bf16 and f32, each held to its dequantized twin (K1 / K4); structured
    int8 on ablation-only masks (K5) once. Returns the bf16 int8 runs'
    launch counts."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.launch.engine import ServingModel

    base, reg, params, prompts = setup["base"], setup["reg"], setup["params"], setup["prompts"]
    per_request = 4 * base.n_layers * (1 + GEN)
    sets = {"90%": setup["masks"], "ablated": _ablate_masks(reg, setup["masks"], ABLATION),
            "ablation-only": _ablation_only(reg, setup["masks"], ABLATION)}
    runs = [  # path, mask set, kernel, the twin's kernel, compute dtypes, codes
        ("condensed", "90%", "K2", "K1", ("bfloat16", "float32"), QUANT),
        ("condensed_over_active", "ablated", "K2-coa", "K4", ("bfloat16", "float32"), QUANT),
        ("structured", "ablation-only", "K5", "K5", ("bfloat16",), ("int8",)),
    ]
    launches = {}
    for path, set_name, key, twin_key, dtypes, codes in runs:
        for dtype_name in dtypes:
            cfg = base.replace(dtype=dtype_name)
            for qdt in codes:
                label = f"quant:{dtype_name}:{path}:{qdt}"
                t0 = time.perf_counter()
                plan = serve.build_plan(cfg, reg, params, sets[set_name], path,
                                        batch_size=BATCH, values_dtype=qdt)
                torch.cuda.synchronize()
                export_s = time.perf_counter() - t0
                weight_bytes, masked_ref = plan.weight_bytes()
                model = ServingModel(cfg, params, plan)
                if model.values_dtype != qdt:
                    raise AssertionError(f"{label}: the model keeps values_dtype "
                                         f"{model.values_dtype}")
                with _prefetch_gather(False):
                    out, rates, counts = _serve_counted(label, model, prompts,
                                                        {**_none(), key: per_request},
                                                        repeats=QUANT_REPEATS)
                    if dtype_name == "bfloat16" and qdt == "int8":
                        launches[key] = counts[key]
                        if key != "K5":
                            _device_profile(lambda: model.generate(prompts, GEN), label)
                    twin = ServingModel(cfg, params, _dequantized_twin(plan, getattr(torch,
                                                                                     dtype_name)))
                    out_t, _, _ = _serve_counted(f"{label}:twin", twin, prompts,
                                                 {**_none(), twin_key: per_request}, repeats=1)
                    toks_t, gaps = _masked_gaps(cfg, twin, prompts, GEN)
                    if not torch.equal(toks_t, out_t[:, PROMPT:]):
                        raise AssertionError(f"{label}: the twin's step-by-step run differs")
                    if key == "K5":
                        # the twin dequantizes as StructuredFanIn.apply does and runs
                        # the same K5, so this holds by construction: it checks the
                        # launch counts; [reference] holds this path to the CPU
                        if not torch.equal(out, out_t):
                            raise AssertionError(f"{label}: tokens differ from the twin's")
                        agree = BATCH
                    else:
                        tie = (_tie_threshold(label, cfg, model, twin, prompts, "the twin")
                               if dtype_name == "bfloat16" else TIE_GAP[dtype_name])
                        agree = _check_ties(label, cfg, out, toks_t, gaps, tie, "the twin")
                print(f"[{label}] {card}: export {export_s:.1f}s, serving weight bytes "
                      f"{weight_bytes} ({weight_bytes / masked_ref:.3f}x of masked), launches "
                      f"{key} {counts[key]}, streams agreeing with the dequantized twin "
                      f"({twin_key}) in full {agree}/{BATCH}; decode {_rates({path: rates})}; "
                      f"first stream {out[0, PROMPT:].tolist()}")
                del model, twin, plan
                torch.cuda.empty_cache()
    return launches


def checkpoint_phase(setup: dict) -> None:
    """The int8 condensed serving tree through the port's checkpoint: saved,
    restored into a fresh template of the same shapes on the card, served."""
    import dataclasses
    import tempfile
    import typing
    import torch
    from repro_torch import bridge
    from repro_torch.launch.engine import ServingModel
    from repro_torch.sparse import condensed as COND
    from repro_torch.train import checkpoint as CKPT

    class State(typing.NamedTuple):
        step: torch.Tensor
        serve: dict

    base, reg, params, prompts = setup["base"], setup["reg"], setup["params"], setup["prompts"]
    cfg = base.replace(dtype="bfloat16")
    tree = COND.export_condensed(cfg, reg, params, setup["masks"], quantize_spec="int8")
    # a fresh template: zero codes and indices, unit scales, same dtypes and device
    template = _map_leaves(tree, lambda leaf: dataclasses.replace(
        leaf, values=torch.zeros_like(leaf.values), indices=torch.zeros_like(leaf.indices),
        scales=torch.ones_like(leaf.scales)))
    out_dir = REPO / "build"
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as d:
        t0 = time.perf_counter()
        path = CKPT.save(d, State(step=torch.tensor(7), serve=tree))
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        t0 = time.perf_counter()
        got = CKPT.restore(d, CKPT.latest_step(d), State(step=torch.tensor(0), serve=template))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    want, have = bridge.flatten(tree), bridge.flatten(got.serve)
    if int(got.step) != 7 or want.keys() != have.keys():
        raise AssertionError(f"restored step {int(got.step)}, keys {sorted(have)[:4]}...")
    for k in want:
        if have[k].device != want[k].device or not torch.equal(have[k], want[k]):
            raise AssertionError(f"checkpoint: {k} differs after the round trip")
    out = ServingModel(cfg, params, tree).generate(prompts, GEN)
    out_r = ServingModel(cfg, params, got.serve).generate(prompts, GEN)
    if not torch.equal(out, out_r):
        raise AssertionError("checkpoint: the restored tree serves other tokens")
    print(f"[checkpoint] int8 condensed tree, {len(want)} arrays, {size} bytes: save "
          f"{save_s:.1f}s, restore onto {got.serve['blocks']['wo'].values.device} "
          f"{restore_s:.1f}s; every array bitwise equal, tokens equal: "
          f"{out_r[0, PROMPT:].tolist()}")


def _map_leaves(tree: dict, fn) -> dict:
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def reference_phase(device):
    """The smoke config on the card against the port's CPU path (which the
    CPU tests hold to the JAX package), float and int8/fp8 trees alike; each
    card run must launch the kernel its path names."""
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
    ablated = _ablate_masks(reg, masks, ABLATION)
    only = _ablation_only(reg, masks, ABLATION)
    trees = {  # label: (each path on masks where it is exact, the kernel it runs)
        "condensed": (COND.export_condensed(cfg, reg, params, masks), "K1"),
        "condensed_over_active": (COND.export_condensed_over_active(cfg, reg, params, ablated),
                                  "K4"),
        "structured": (COND.export_structured(cfg, reg, only), "K5"),
    }
    for qdt in QUANT:
        trees[f"condensed {qdt}"] = (COND.export_condensed(
            cfg, reg, params, masks, quantize_spec=qdt), "K2")
        trees[f"condensed_over_active {qdt}"] = (COND.export_condensed_over_active(
            cfg, reg, params, ablated, quantize_spec=qdt), "K2-coa")
        trees[f"structured {qdt}"] = (COND.export_structured(
            cfg, reg, only, params=params, quantize_spec=qdt), "K5")

    def to_dev(tree):  # tensors and format leaves alike
        return {k: to_dev(v) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}
    for path, (tree, key) in trees.items():
        cpu = E.generate(cfg, params, tree, prompts, 10)
        _zero_counts()
        gpu = E.generate(cfg, to_dev(params), to_dev(tree), prompts.to(device), 10)
        launched = _counts()[key]
        if not launched:
            raise AssertionError(f"smoke {path}: no {key} launch on the card")
        if not torch.equal(gpu.cpu(), cpu):
            raise AssertionError(f"smoke {path} tokens differ: card {gpu.tolist()} "
                                 f"cpu {cpu.tolist()}")
        print(f"[reference] smoke {ARCH} {path} on the card ({key} x {launched}) == CPU "
              f"plain path: {cpu[0, 8:].tolist()}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

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
    cases = kernel_phase(device) + ablation_kernel_phase(device) + quant_kernel_phase(device)
    k3_bound()
    setup = model_setup(device)
    launches = {"K1": slice_phase(setup, card)}
    ablation = ablation_phase(setup, card)
    launches.update(K4=ablation["condensed_over_active"]["K4"],
                    K5=ablation["structured"]["K5"],
                    K6=ablation["structured+prefetch"]["K6"])
    auto_phase(setup)
    quant = quant_phase(setup, card)
    launches.update({"K2": quant["K2"], "K2-coa": quant["K2-coa"]})
    checkpoint_phase(setup)
    del setup
    reference_phase(device)

    out_dir = REPO / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_kernels.json").write_text(
        json.dumps({"card": smi, "cases": cases}, indent=1))
    per_layer = {"wo": 1, "w_gate": 2, "w_down": 1}  # w_up shares w_gate's shape
    kernels = []
    for key, name, source, replaces in KERNELS:
        layer = [c for c in cases if c["kernel"] == key and c["dtype"] == "bfloat16"
                 and c["launch"] == "decode" and c.get("codes", "int8") == "int8"]
        total = {t: sum(c[t] * per_layer[c["stack"]] for c in layer)
                 for t in ("ms", "plain_ms", "library_ms", "bound_ms")}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": max(c["max_abs_err"] for c in layer),
            "ms": total["ms"],
            "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": ("bytes" if all(c["bound_by"] == "bytes" for c in layer)
                         else "operations"),
            "library_ms": total["library_ms"],
            "shape": "one decode layer: wo + w_gate + w_up + w_down, B=4, bfloat16"
                     + (", int8 codes" if key.startswith("K2") else "")
                     + (", 50% of each stack's neurons ablated"
                        if key not in ("K1", "K2") else ""),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
