"""Launch-configuration search and its cache (port of
``repro/sparse/autotune.py``).

The port's kernels have knobs that leave their result as it is: the batch
rows of a block (``block_b``), the neurons of a block (``block_n``) and, at
small batches, the decode launch against the tiled one. Each output's
reduction order depends only on d_in and the dtype
(``condensed_matmul.gather_geometry``, ``structured_matmul.split_geometry``),
so every launch of one shape is bitwise equal to every other, and the best
launch is a measured property of the card:

* ``autotune_blocks`` times every candidate of K1 (K2 with a quantized
  ``values_dtype``, on the codes ``formats.quantize_values`` makes) from
  ``condensed_matmul.gather_candidates``, whose first entry is the launch
  the wrapper picks today (the baseline); ``autotune_coa_blocks`` does the
  same for K4 / K2-coa and ``autotune_structured_blocks`` for K5
  (``structured_matmul.structured_candidates``, ``block_b`` only). The
  winner is the argmin of the table the baseline sits in, so
  ``speedup_vs_default >= 1`` by construction.
* ``tune_registry`` tunes every distinct launch a registry's stacks make at
  one batch bucket, under the keys the formats' ``spec_tuning_key`` give
  (``formats.shape_tuning_key``), which are the keys ``kernels.ops`` reads.
  An MoE expert stack keys as the reference's does (one expert's shape at
  the bucket) and is timed on the expert-grouped launch over its E experts
  (``experts=E``): K1-moe / K2-moe in ``autotune_blocks``, K4-moe /
  K2-coa-moe in ``autotune_coa_blocks``, K5-moe in
  ``autotune_structured_blocks``: the launch that reads the entry.
* ``lookup_entry`` / ``lookup_blocks`` read the in-memory view of the
  cache, never the disk on each call.

Timing (``_time_us``) on the card: 20 calls captured in one CUDA graph,
one replay between two CUDA events, ``min`` over ``reps``; the search
cycles the operands through enough copies to exceed the L2, since in
serving a layer's slots come cold from HBM. The timed launches do not
count toward the kernels' launch counters. On the CPU every candidate is
the plain version: the search still runs (as the reference's does in
interpret mode) and its entries are keyed ``cpu``.

The cache file is the port's own: ``$REPRO_TORCH_AUTOTUNE_CACHE``, else
``~/.cache/repro_torch/autotune.json``, with a ``kernels`` section (one
entry per key) and a ``profiles`` section (``plan.HardwareProfile.measure``'s
rates per device name, with the settings that produced them). A file
without a ``kernels`` section loads with an empty one and keeps its
profiles. The reference's cache file is never read or written.
Tensor-parallel shapes (``tp > 1``) are not ported yet (ROADMAP queue 1,
item 9).
"""
from __future__ import annotations

import functools
import json
import math
import os
import time
import typing

import torch

from repro_torch import resolve_device
from repro_torch.core import topology
from repro_torch.kernels import condensed_matmul as cm
from repro_torch.kernels import counters
from repro_torch.kernels import structured_matmul as sm

_CACHE_VERSION = 1
_STATE: dict = {"path": None, "data": None}


def cache_path() -> str:
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")


def _load() -> dict:
    path = cache_path()
    if _STATE["data"] is None or _STATE["path"] != path:
        data = {"version": _CACHE_VERSION, "kernels": {}, "profiles": {}}
        try:
            with open(path) as f:
                on_disk = json.load(f)
            if on_disk.get("version") == _CACHE_VERSION:
                data.update(on_disk)
        except (OSError, ValueError):
            pass
        _STATE["path"], _STATE["data"] = path, data
    return _STATE["data"]


def _save() -> None:
    path = _STATE["path"] or cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(_STATE["data"], f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def reset_cache_state() -> None:
    """Drop the in-memory view of the cache (after repointing
    ``$REPRO_TORCH_AUTOTUNE_CACHE``)."""
    _STATE["path"] = _STATE["data"] = None


def device_key(device: torch.device | str | None = None) -> str:
    """The cache's key for a device: the card's name, or ``cpu``. None
    names the current card, as ``resolve_device`` does: without a card it
    raises, so only an explicit ``"cpu"`` keys an entry ``cpu``."""
    dev = _device(device)
    if dev.type == "cuda":
        return _card_name(torch.cuda.current_device() if dev.index is None else dev.index)
    return dev.type


@functools.cache
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def store_profile(rates: dict, *, device: str) -> None:
    """Keep ``rates`` (a measured profile and its ``params``) under the
    device key ``device``."""
    _load()["profiles"][device] = dict(rates)
    _save()


def cached_profile(device: str) -> dict | None:
    return _load()["profiles"].get(device)


def _time_us(fn, *args, reps: int = 3, agg=min, calls: int = 20, cold: bool = False) -> float:
    """``fn(*args)`` in µs, aggregated over ``reps`` timings after one
    warm-up call.

    On the card ``calls`` calls are captured in one CUDA graph and a timing
    is one replay between two CUDA events, divided by ``calls``: the host's
    launch overhead is not in it. ``cold`` cycles the calls through copies
    of the tensor arguments, as many as exceed the card's L2 (at most
    ``calls``), so each call reads its operands from HBM as a serving step
    does. On the CPU a timing is the wall clock around one call. ``min`` by
    default (interference only adds time); pass ``statistics.median`` for a
    bandwidth rate, where the fastest run is a cache burst.
    """
    with counters.recording():  # the timed launches are not the path's
        return _timed(fn, args, reps, agg, calls, cold)


def _timed(fn, args, reps, agg, calls, cold) -> float:
    fn(*args)
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)), torch.device("cpu"))
    ts = []
    if dev.type == "cuda":
        arg_sets = [args]
        if cold:
            nbytes = sum(a.numel() * a.element_size() for a in args
                         if isinstance(a, torch.Tensor))
            l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 50 << 20)
            copies = min(calls, math.ceil(l2 / max(nbytes, 1)) + 1)
            arg_sets += [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                         for _ in range(copies - 1)]
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.cuda.graph(graph):
            for i in range(calls):
                fn(*arg_sets[i % len(arg_sets)])
        graph.replay()
        torch.cuda.synchronize(dev)
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e3 / calls)
        return float(agg(ts))
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(agg(ts))


# ---------------------------------------------------------------------------
# the kernels section: entries and their reads
# ---------------------------------------------------------------------------


class TuneResult(typing.NamedTuple):
    """One key's search: the winner's launch (``block_b`` None: the decode
    launch; ``block_n`` None: the kernel's own, as K5's), its µs and the
    baseline's, and every candidate's µs by label. ``plain`` is True where
    the candidates ran the plain version (the CPU)."""
    key: str
    block_b: int | None
    block_n: int | None
    us: float
    default_us: float
    plain: bool
    table: dict[str, float]

    @property
    def speedup_vs_default(self) -> float:
        return self.default_us / max(self.us, 1e-12)

    @property
    def label(self) -> str:
        return _label(self.block_b, self.block_n)


def _label(block_b: int | None, block_n: int | None) -> str:
    if block_b is None:
        return "decode" if block_n is None else f"decode x{block_n}"
    return f"{block_b} rows" if block_n is None else f"{block_b}x{block_n}"


def lookup_entry(key: str | None) -> dict | None:
    """The cached launch under a ``tuning_key``-derived key, or None (a read
    of the in-memory view; it never times). A None key (a format with no
    tuned kernel) always misses. Returns ``{"block_b": int | None,
    "block_n": int | None}``; ``block_b`` None is the decode launch."""
    if key is None:
        return None
    entry = _load()["kernels"].get(key)
    if not entry:
        return None
    return {"block_b": entry["block_b"], "block_n": entry["block_n"]}


def lookup_blocks(batch: int, d_in: int, n_out: int, k: int, *, backend: str | None = None,
                  itemsize: int = 4) -> dict | None:
    """``lookup_entry`` at K1's key for a shape."""
    from repro_torch.sparse import formats as F  # lazy: formats reaches this module
    return lookup_entry(F.shape_tuning_key(d_in, n_out, k, batch, backend=backend,
                                           itemsize=itemsize))


def has_kernel_entries() -> bool:
    """Whether the cache holds any launch (``kernels.ops`` reads nothing
    else when it holds none)."""
    return bool(_load()["kernels"])


# ---------------------------------------------------------------------------
# the timed search
# ---------------------------------------------------------------------------


def candidate_call(kind: str, block_b: int | None, block_n: int | None):
    """The wrapper call of one candidate launch: ``kind`` "condensed" (K1,
    K2 with scales) takes ``(x, values, indices, scales)``, "coa" (K4,
    K2-coa) ``(x, values, indices, out_index, d_out, scales)`` and
    "structured" (K5 over a gathered panel) ``(x, panel, active_index,
    d_out)``; "grouped" (K1-moe, K2-moe with scales), "grouped_coa"
    (K4-moe, K2-coa-moe) and "grouped_structured" (K5-moe) take the same
    with the experts first; ``block_b`` None is the decode launch."""
    if kind == "grouped_coa":
        return lambda x, v, i, o, d, s: sm.condensed_over_active_matmul_grouped(
            x, v, i, o, d, scales=s, block_b=block_b, block_n=block_n)
    if kind == "grouped_structured":
        if block_n is not None:
            raise ValueError("the structured kernel (K5-moe) takes block_b only")
        return lambda x, p, ai, d: sm.structured_matmul_grouped_pregathered(x, p, ai, d,
                                                                           block_b=block_b)
    if kind == "grouped":
        return lambda x, v, i, s: cm.condensed_matmul_grouped(x, v, i, scales=s,
                                                              block_b=block_b,
                                                              block_n=block_n)
    if kind == "condensed":
        if block_b is None:
            return lambda x, v, i, s: cm.condensed_matmul_decode(x, v, i, scales=s,
                                                                 block_n=block_n)
        return lambda x, v, i, s: cm.condensed_matmul(x, v, i, scales=s, block_b=block_b,
                                                      block_n=block_n)
    if kind == "coa":
        if block_b is None:
            return lambda x, v, i, o, d, s: sm.condensed_over_active_matmul_decode(
                x, v, i, o, d, scales=s, block_n=block_n)
        return lambda x, v, i, o, d, s: sm.condensed_over_active_matmul(
            x, v, i, o, d, scales=s, block_b=block_b, block_n=block_n)
    if kind == "structured":
        if block_n is not None:
            raise ValueError("the structured kernel (K5) takes block_b only")
        return lambda x, p, ai, d: sm.structured_matmul_pregathered(x, p, ai, d, block_b=block_b)
    raise ValueError(f"unknown kernel kind {kind!r}")


def _device(device) -> torch.device:
    """The search's device: the card unless the caller asks for the CPU;
    without a card, None raises (``resolve_device``) instead of timing the
    plain versions as if they were the card's."""
    return resolve_device(device)


def _sm_count(dev: torch.device) -> int:
    """The SMs the default launch is chosen for: the card's, or an H100
    SXM's (``condensed_matmul.DEFAULT_SM_COUNT``) in a search the caller
    ran on the CPU, where every candidate is the plain version."""
    if dev.type == "cuda":
        return cm._sm_count(torch.cuda.current_device() if dev.index is None else dev.index)
    return cm.DEFAULT_SM_COUNT


def _stored(vals: torch.Tensor, dtype, values_dtype):
    """(values, scales) as an export stores them: codes and scales from
    ``formats.quantize_values`` (what K2 reads) for a quantized
    ``values_dtype``, else the values at ``dtype``."""
    from repro_torch.sparse import formats as F  # lazy: formats reaches this module
    vd = F.resolve_quantize_spec(values_dtype)
    if vd in F.QUANTIZED_DTYPES:
        q, s = F.quantize_values(vals, vd)
        return q.contiguous(), s.contiguous()
    return vals.to(dtype).contiguous(), None


def _sorted_active_index(gen, a: int, d_out: int, device) -> torch.Tensor:
    """A random increasing subset of min(a, d_out) columns, padded to ``a``
    with the sentinel ``d_out``."""
    a_real = min(a, d_out)
    ai = torch.randperm(d_out, generator=gen, device=device)[:a_real].sort().values
    out = torch.full((a,), d_out, dtype=torch.int32, device=device)
    out[:a_real] = ai.to(torch.int32)
    return out


def grouped_operands(experts: int, batch: int, d_in: int, rows: int, k: int, *,
                     dtype=torch.float32, seed: int = 0, device=None,
                     values_dtype: str | None = None) -> tuple:
    """Seeded operands of K1-moe (K2-moe with a quantized ``values_dtype``):
    ``experts`` experts' ``gather_operands`` (seeds ``seed`` + e), stacked
    as ``(x (E, bucket, d_in), values, indices (E, rows, k), scales (E,
    rows) or None)``."""
    each = [gather_operands(batch, d_in, rows, k, dtype=dtype, seed=seed + e, device=device,
                            values_dtype=values_dtype) for e in range(experts)]
    return _stacked(each)


def _stacked(each: list) -> tuple:
    """Per-expert operand tuples stacked along a new leading axis (an int,
    such as ``d_out``, or None is kept as it is)."""
    return tuple(torch.stack(parts).contiguous() if isinstance(parts[0], torch.Tensor)
                 else parts[0] for parts in zip(*each))


def gather_operands(batch: int, d_in: int, rows: int, k: int, *, dtype=torch.float32,
                    seed: int = 0, device=None, values_dtype: str | None = None,
                    d_out: int | None = None) -> tuple:
    """Seeded operands of K1 at the bucket of ``batch``, as a constant
    fan-in layer's export holds them: ``rows`` neurons of ``k`` distinct
    inputs each (``topology.dense_to_condensed`` of a seeded mask; a row
    that repeats an input would take the kernels' slow path) and values at
    an initialized layer's scale, 1 / sqrt(k). Returns ``(x, values,
    indices, scales)``; with ``d_out`` those of K4 over ``rows`` surviving
    rows, ``(x, values, indices, out_index, d_out, scales)``."""
    from repro_torch.sparse.plan import batch_bucket
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch_bucket(batch), d_in), generator=gen, device=dev).to(dtype)
    mask = topology.random_constant_fan_in_mask(gen, d_in, rows, k)
    w = torch.randn((d_in, rows), generator=gen, device=dev) / k ** 0.5
    vals, idx = topology.dense_to_condensed(w * mask, mask, k)
    del mask, w
    vals, scales = _stored(vals, dtype, values_dtype)
    if d_out is None:
        return x, vals, idx, scales
    return x, vals, idx, _sorted_active_index(gen, rows, d_out, dev), d_out, scales


def structured_operands(batch: int, d_in: int, a_pad: int, d_out: int, *,
                        dtype=torch.float32, seed: int = 0, device=None) -> tuple:
    """Seeded operands of K5 at the bucket of ``batch``: ``(x, panel,
    active_index, d_out)``, the panel the (d_in, a_pad) gathered columns at
    an initialized layer's scale."""
    from repro_torch.sparse.plan import batch_bucket
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch_bucket(batch), d_in), generator=gen, device=dev).to(dtype)
    panel = (torch.randn((d_in, a_pad), generator=gen, device=dev) / d_in ** 0.5).to(dtype)
    return x, panel, _sorted_active_index(gen, a_pad, d_out, dev), d_out


def _search(kind: str, key: str, cands, operands, *, reps: int, save: bool) -> TuneResult:
    """Time every candidate on ``operands`` (L2 kept cold on the card),
    pick the argmin of the table the baseline (``cands[0]``) sits in, and
    keep the entry."""
    table = {_label(*c): _time_us(candidate_call(kind, *c), *operands, reps=reps, cold=True)
             for c in cands}
    best = min(cands, key=lambda c: table[_label(*c)])
    plain = operands[0].device.type != "cuda"
    res = TuneResult(key=key, block_b=best[0], block_n=best[1], us=table[_label(*best)],
                     default_us=table[_label(*cands[0])], plain=plain, table=table)
    if save:
        _load()["kernels"][key] = {
            "block_b": res.block_b, "block_n": res.block_n, "us": round(res.us, 3),
            "default_us": round(res.default_us, 3), "default": _label(*cands[0]),
            "plain": plain, "table": {k_: round(v, 3) for k_, v in table.items()}}
        _save()
    return res


def autotune_blocks(batch: int, d_in: int, n_out: int, k: int, *, dtype=torch.float32,
                    reps: int = 3, seed: int = 0, device=None,
                    values_dtype: str | None = None, save: bool = True,
                    experts: int = 0) -> TuneResult:
    """The search for K1 (K2 with a quantized ``values_dtype``, on the codes
    a quantized export stores) at the bucket of ``batch`` over every
    ``condensed_matmul.gather_candidates`` launch, its entry kept under the
    ``Condensed`` key. The representative batch is the bucket's top: an
    entry serves every batch of its bucket. ``experts`` > 0 times the
    expert-grouped launch (K1-moe / K2-moe) over that many experts of this
    shape instead, under the same key (the launch of an expert stack reads
    it for every expert); the baseline is the grouped default, whose
    neurons a block count every expert's rows."""
    from repro_torch.sparse import formats as F  # lazy: formats reaches this module
    if experts:
        ops_ = grouped_operands(experts, batch, d_in, n_out, k, dtype=dtype, seed=seed,
                                device=device, values_dtype=values_dtype)
    else:
        ops_ = gather_operands(batch, d_in, n_out, k, dtype=dtype, seed=seed, device=device,
                               values_dtype=values_dtype)
    x0 = ops_[0][0] if experts else ops_[0]
    b = x0.shape[0]
    key = F.shape_tuning_key(d_in, n_out, k, b, backend=device_key(x0.device),
                             itemsize=x0.element_size(),
                             compute_dtype=x0.dtype, values_dtype=values_dtype)
    cands = cm.gather_candidates(b, d_in, n_out * max(experts, 1), dtype,
                                 sm_count=_sm_count(x0.device))
    return _search("grouped" if experts else "condensed", key, cands, ops_, reps=reps,
                   save=save)


def autotune_coa_blocks(batch: int, d_in: int, a: int, k: int, d_out: int, *,
                        dtype=torch.float32, reps: int = 3, seed: int = 0, device=None,
                        values_dtype: str | None = None, save: bool = True,
                        experts: int = 0) -> TuneResult:
    """The search for K4 (K2-coa with a quantized ``values_dtype``): ``a``
    surviving rows of fan-in ``k`` stored into a ``d_out``-wide output,
    over K1's candidates at ``a`` rows, kept under the
    ``CondensedOverActive`` key. ``experts`` > 0 times K4-moe (K2-coa-moe)
    over that many experts of this shape instead, under the same key, as
    ``autotune_blocks`` does for K1-moe."""
    from repro_torch.sparse import formats as F  # lazy: formats reaches this module
    each = [gather_operands(batch, d_in, a, k, dtype=dtype, seed=seed + e, device=device,
                            values_dtype=values_dtype, d_out=d_out)
            for e in range(max(experts, 1))]
    ops_ = _stacked(each) if experts else each[0]
    x0 = each[0][0]
    b = x0.shape[0]
    key = F.shape_tuning_key(d_in, a, k, b, backend=device_key(x0.device),
                             itemsize=x0.element_size(),
                             compute_dtype=x0.dtype, kind="coa",
                             scatter_width=d_out, values_dtype=values_dtype)
    cands = cm.gather_candidates(b, d_in, a * max(experts, 1), dtype,
                                 sm_count=_sm_count(x0.device))
    return _search("grouped_coa" if experts else "coa", key, cands, ops_, reps=reps, save=save)


def autotune_structured_blocks(batch: int, d_in: int, a: int, d_out: int, *,
                               dtype=torch.float32, reps: int = 3, seed: int = 0,
                               device=None, values_dtype: str | None = None,
                               save: bool = True, experts: int = 0) -> TuneResult:
    """The search for K5 over ``a`` (the exported ``active_index`` length,
    padding included) gathered columns of a ``d_out``-wide weight, over
    ``structured_matmul.structured_candidates``, kept under the
    ``StructuredFanIn`` key. K5 runs on a gathered panel (the per-call
    column gather does not depend on the launch and is not timed);
    ``values_dtype`` only names the key, since a quantized structured leaf
    runs K5 on its dequantized panel. ``experts`` > 0 times K5-moe over
    that many experts' panels instead, under the same key."""
    from repro_torch.sparse import formats as F  # lazy: formats reaches this module
    each = [structured_operands(batch, d_in, a, d_out, dtype=dtype, seed=seed + e,
                                device=device) for e in range(max(experts, 1))]
    ops_ = _stacked(each) if experts else each[0]
    x0 = each[0][0]
    b = x0.shape[0]
    key = F.shape_tuning_key(d_in, a, 0, b, backend=device_key(x0.device),
                             itemsize=x0.element_size(),
                             compute_dtype=x0.dtype, kind="structured",
                             scatter_width=d_out, values_dtype=values_dtype)
    return _search("grouped_structured" if experts else "structured", key,
                   sm.structured_candidates(b, d_in, a, dtype), ops_, reps=reps, save=save)


def tune_registry(registry, stats: dict, *, cfg, batch: int, dtype=torch.float32,
                  reps: int = 3, device=None, values_dtype: str | None = None,
                  tp: int = 1) -> dict[str, TuneResult]:
    """Tune every distinct launch ``registry``'s stacks make at ``batch``'s
    bucket, at their realized fan-in (``stats`` from
    ``condensed.export_stats``), as the reference does: each stack's
    ``Condensed`` key on K1; a stack with ablated neurons also its
    ``CondensedOverActive`` key on K4 (label ``name@a{a}``), and an
    ablation-only one (``min_fan_in == d_in``) its ``StructuredFanIn`` key
    on K5 (``name@structured``). The keys are the formats'
    ``spec_tuning_key``, which ``kernels.ops`` reads; a key already cached
    is skipped. ``values_dtype`` ("int8"/"fp8") tunes K2 / K2-coa on codes
    under the quantized keys. An MoE expert stack of ``cfg``
    (``registry.is_expert_stack``) has each of its keys timed on the
    expert-grouped launch over its E experts (``experts=E``: K1-moe, K4-moe,
    K5-moe), the launch that reads it."""
    from repro_torch.sparse import formats as F  # lazy: formats reaches this module
    from repro_torch.sparse import registry as REG
    if int(tp) > 1:
        raise NotImplementedError("tensor-parallel tuning (tp > 1) is not ported to "
                                  "repro_torch yet (ROADMAP queue 1, item 9)")
    dev = _device(device)
    backend = device_key(dev)
    itemsize = torch.empty((), dtype=dtype).element_size()
    vd = F.resolve_quantize_spec(values_dtype)
    kw = dict(dtype=dtype, reps=reps, device=dev, values_dtype=vd)
    out: dict[str, TuneResult] = {}
    seen: set[str] = set()
    for s in registry:
        st = stats[s.name]
        spec = F.spec_for_stack(s, st, itemsize, vd)
        a = spec.max_active
        experts = s.lead[-1] if REG.is_expert_stack(s, cfg) else 0
        tuners = [(s.name, F.Condensed,
                   lambda: autotune_blocks(batch, s.d_in, s.d_out, spec.k, experts=experts,
                                           **kw))]
        if a < s.d_out:
            tuners.append((f"{s.name}@a{a}", F.CondensedOverActive,
                           lambda: autotune_coa_blocks(batch, s.d_in, a, spec.k, s.d_out,
                                                       experts=experts, **kw)))
            if st.min_fan_in >= s.d_in:
                a_pad = sm.padded_active_count(a, s.d_out)
                tuners.append((f"{s.name}@structured", F.StructuredFanIn,
                               lambda: autotune_structured_blocks(batch, s.d_in, a_pad,
                                                                  s.d_out, experts=experts,
                                                                  **kw)))
        for label, cls, tune in tuners:
            key = cls.spec_tuning_key(spec, batch, backend=backend, dtype=dtype)
            if key in seen:
                continue
            seen.add(key)
            if lookup_entry(key) is None:
                out[label] = tune()
    return out
