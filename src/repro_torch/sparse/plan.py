"""Serving execution plans: per-stack representation choice (port of
``repro/sparse/plan.py``).

The same trained constant fan-in weights execute under several
representations, and which one wins depends on the request's batch and the
hardware's balance (paper Sec. 4.4). ``build_plan`` turns a (params, masks)
pair into a ``Plan``: a representation per ``SparseStack`` (priced by each
format's ``estimate_cost`` when ``path="auto"``, forced otherwise) and the
serving tree of format objects that plugs into the masks slot of
``prefill_step``/``decode_step``.

Plans are priced at a batch *bucket* (``batch_bucket``), as the reference's
engine keys them, so ``--path auto`` decides at the same batch as there.

``values_dtype`` ("bf16", "int8", "fp8"; None keeps the param dtype) is
part of the plan: every value-storing leaf is exported at that storage
width and the cost model prices that width, as in the reference.

``Plan.refresh`` keeps a plan coherent with a training job: only the
stacks whose mask version moved are re-exported, the other condensed-family
stacks get a values-only regather, and a same-shape refresh writes into the
leaves' existing tensors (``formats.*.donate_refresh``), so CUDA graphs
captured over the plan stay valid.

``HardwareProfile.measure`` times the rates the cost model prices with on
the card (CUDA events over replayed work) and caches them per device name
(``sparse/autotune.py``); ``DEFAULT_PROFILE`` stays the default.

Self-draft speculative decoding (``launch/speculative.py``) derives its
draft here: ``derive_draft_tree`` turns a plan's serving tree into the same
weights at a higher neuron ablation, sharing every value tensor with it, and
``price_speculation`` prices draft steps and one batched verify against
plain decode, so ``--path auto`` can decline. Its MoE expert leaves (lead
(L, E)) draft per expert row block and are priced over L * E replicas, as
in the reference.

``plan_for_shape`` and ``abstract_serving_tree`` plan and shape a serving
tree from static information alone, on the meta device (the dry run's,
``launch/dryrun.py``).

An MoE expert stack (lead (L, E)) serves any of the four representations,
each through its expert-grouped launch (K1-moe, K4-moe, K5-moe / K6-moe,
or the masked product), and is priced as in the reference: over its L * E
replicas at the bucket's rows, although an expert's launch takes G * C
rows. That pricing is a kept quirk of the reference's (ROADMAP section 3),
kept because it decides which representation runs.

Ported for one device (``tp=1``). Queued: tensor parallelism.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import distributions as D
from repro_torch.sparse import condensed as COND
from repro_torch.sparse import formats as F
from repro_torch.sparse import registry as REG

REPRESENTATIONS = ("masked", "condensed", "structured", "condensed_over_active")
PATHS = REPRESENTATIONS + ("auto",)

# fraction below 1.0 at which a stack counts as having ablated neurons (guards
# against float fuzz in the mean-active reduction)
_ABLATION_EPS = 1e-6

# the reference's batch buckets (``repro/sparse/autotune.py``): geometric, x4
BATCH_BUCKETS = (1, 8, 32, 128, 512, 2048)


def batch_bucket(b: int) -> int:
    """Smallest bucket >= b; above the table the x4 progression continues.
    A ceiling: a batch is never priced at a bucket smaller than itself."""
    for v in BATCH_BUCKETS:
        if b <= v:
            return v
    v = BATCH_BUCKETS[-1]
    while v < b:
        v *= 4
    return v


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Throughput balance the format cost models price against.

    The gather unit may be calibrated at two batch points
    (``gather_flops_per_s`` at ``gather_small_batch``,
    ``gather_flops_per_s_large`` at ``gather_large_batch``);
    ``gather_rate(batch)`` interpolates log-log between them, and a profile
    with no large point has one rate.

    ``DEFAULT_PROFILE`` is one NVIDIA H100 SXM (80 GB HBM3, 700 W limit):
    ``hbm_bytes_per_s`` 3.35 TB/s and ``mxu_flops_per_s`` 989 TFLOP/s (dense
    bf16 tensor cores) from NVIDIA's data sheet; ``gather_flops_per_s`` is
    ``2 * B * n_out * k / t`` of the condensed gather kernel (K1) at decode,
    B = 4, the median of its six decode cases (wo, w_gate, w_down of
    qwen3-1.7b at 90% sparsity, bf16 and f32) in PERF.md section 6, measured
    by ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at 700.00 W.
    """

    name: str
    hbm_bytes_per_s: float
    mxu_flops_per_s: float
    gather_flops_per_s: float
    gather_flops_per_s_large: float | None = None
    gather_small_batch: int = 8
    gather_large_batch: int = 512

    def gather_rate(self, batch: int) -> float:
        """Gather throughput at ``batch``, clamped outside the two points."""
        small, large = self.gather_flops_per_s, self.gather_flops_per_s_large
        if not large or self.gather_large_batch <= self.gather_small_batch:
            return small
        b = int(batch)
        if b <= self.gather_small_batch:
            return small
        if b >= self.gather_large_batch:
            return large
        t = ((math.log(b) - math.log(self.gather_small_batch))
             / (math.log(self.gather_large_batch) - math.log(self.gather_small_batch)))
        return math.exp((1.0 - t) * math.log(small) + t * math.log(large))

    @classmethod
    def measure(cls, *, device: str | torch.device | None = None, stream_mb: float = 96.0,
                matmul_shape: tuple[int, int, int] = (128, 2048, 1024),
                gather_shape: tuple[int, int, int, int] = (8, 2048, 1024, 205),
                gather_large_shape: tuple[int, int, int, int] = (512, 2048, 1024, 205),
                reps: int = 5, use_cache: bool = True, save: bool = True) -> "HardwareProfile":
        """The cost model's rates timed on ``device`` (the card unless told
        otherwise), as the reference measures them:

        * ``hbm_bytes_per_s``: ``x + 1`` over ``stream_mb`` of float32, reads
          and writes counted, the median of ``reps``;
        * ``mxu_flops_per_s``: a float32 matmul at ``matmul_shape = (b,
          d_in, d_out)``, the best of ``reps``;
        * ``gather_flops_per_s`` / ``gather_flops_per_s_large``: ``2 * B *
          n_out * k / t`` of the port's condensed gather wrapper (K1 on the
          card, its plain version on the CPU) in float32 at ``gather_shape``
          and ``gather_large_shape`` = (B, d_in, n_out, k), the best of
          ``reps``.

        On the card each timing is a CUDA-graph replay of 20 calls between
        CUDA events (``autotune._time_us``), on the CPU the wall clock
        around a call.
        With ``use_cache`` a profile stored for this device under the same
        settings (``autotune.cached_profile``) is returned without timing;
        ``save`` stores a fresh one. The port's profile has no interconnect
        rate: tensor parallelism is not ported (ROADMAP queue 1, item 9).
        """
        import statistics

        from repro_torch import resolve_device
        from repro_torch.kernels import condensed_matmul as cm
        from repro_torch.sparse import autotune as AT

        dev = resolve_device(device)
        key = AT.device_key(dev)
        params = {"stream_mb": stream_mb, "matmul_shape": list(matmul_shape),
                  "gather_shape": list(gather_shape),
                  "gather_large_shape": list(gather_large_shape), "reps": reps}
        if use_cache:
            cached = AT.cached_profile(key)
            if cached and cached.get("params") == params:
                return cls(**{f.name: cached[f.name] for f in dataclasses.fields(cls)})

        gen = torch.Generator(device=dev).manual_seed(0)
        n = max(int(stream_mb * 2**20 / 4), 1024)
        xs = torch.full((n,), 1.5, dtype=torch.float32, device=dev)
        t_stream = AT._time_us(lambda x: x + 1.0, xs, reps=reps, agg=statistics.median)
        hbm = 8.0 * n / (t_stream * 1e-6)

        mb, md_in, md_out = matmul_shape
        a = torch.randn((mb, md_in), generator=gen, device=dev)
        b = torch.randn((md_in, md_out), generator=gen, device=dev)
        t_mm = AT._time_us(torch.matmul, a, b, reps=reps)
        mxu = 2.0 * mb * md_in * md_out / (t_mm * 1e-6)

        def gather_point(shape):
            gb, gd, gn, gk = shape
            x = torch.randn((gb, gd), generator=gen, device=dev)
            vals = torch.randn((gn, gk), generator=gen, device=dev)
            idx = torch.randint(0, gd, (gn, gk), generator=gen, device=dev, dtype=torch.int32)
            t_g = AT._time_us(cm.condensed_matmul, x, vals, idx, reps=reps)
            return 2.0 * gb * gn * gk / (t_g * 1e-6)

        prof = cls(name=f"measured-{key}", hbm_bytes_per_s=hbm, mxu_flops_per_s=mxu,
                   gather_flops_per_s=gather_point(gather_shape),
                   gather_flops_per_s_large=gather_point(gather_large_shape),
                   gather_small_batch=gather_shape[0], gather_large_batch=gather_large_shape[0])
        if save:
            AT.store_profile({**dataclasses.asdict(prof), "params": params}, device=key)
        return prof


DEFAULT_PROFILE = HardwareProfile(name="h100-sxm", hbm_bytes_per_s=3.35e12,
                                  mxu_flops_per_s=989e12, gather_flops_per_s=9.31e11)


@dataclasses.dataclass(frozen=True)
class StackDecision:
    """One stack's chosen representation and the cost table that chose it."""

    name: str
    representation: str
    est_s: dict[str, float]       # representation -> est. seconds per step
    stats: F.ExportStats          # realized fan-in / ablation at export time

    @property
    def active_fraction(self) -> float:
        return self.stats.active_fraction


def stack_costs(stack, *, batch_size: int, itemsize: int, k: int,
                active_fraction: float, profile: HardwareProfile = DEFAULT_PROFILE,
                max_active_fraction: float | None = None,
                values_dtype: str | None = None) -> dict[str, float]:
    """Estimated seconds per serving step for each representation.

    ``max_active_fraction`` is the exported row fraction that prices
    condensed_over_active (the leaf carries max_active rows per layer);
    the mean ``active_fraction`` is the fallback. ``values_dtype`` prices
    the value-storing formats at their stored width.
    """
    b = max(int(batch_size), 1)
    act = min(max(active_fraction, 0.0), 1.0)
    row_frac = act if max_active_fraction is None else min(max(max_active_fraction, 0.0), 1.0)
    spec = F.FormatSpec(d_in=stack.d_in, d_out=stack.d_out, n_replicas=stack.n_replicas,
                        itemsize=itemsize, k=max(k, 1), max_active=row_frac * stack.d_out,
                        active_fraction=act,
                        values_dtype=F.resolve_quantize_spec(values_dtype))
    return {name: cls.estimate_cost(spec, b, profile) for name, cls in F.FORMATS.items()}


def _max_active_fraction(stack, stats: F.ExportStats) -> float:
    """Exported-row fraction: the leaf carries max_active rows per layer."""
    return max(stats.max_active, 1) / max(stack.d_out, 1)


def _costs(stack, batch_size: int, itemsize: int, stats: F.ExportStats,
           profile: HardwareProfile, values_dtype: str | None) -> dict[str, float]:
    return stack_costs(stack, batch_size=batch_size, itemsize=itemsize, k=max(stats.k, 1),
                       active_fraction=stats.active_fraction, profile=profile,
                       max_active_fraction=_max_active_fraction(stack, stats),
                       values_dtype=values_dtype)


def select_representation(stack, *, batch_size: int, itemsize: int, stats: F.ExportStats,
                          profile: HardwareProfile = DEFAULT_PROFILE,
                          values_dtype: str | None = None) -> StackDecision:
    """Cost-model choice among the representations exact for this stack.

    Masked and condensed are always exact; condensed_over_active joins once
    ablation has left dead rows to drop, and structured only for
    ablation-only stacks (every surviving column fully dense,
    ``stats.min_fan_in >= d_in``).
    """
    costs = _costs(stack, batch_size, itemsize, stats, profile, values_dtype)
    cands = ("masked", "condensed")
    if stats.active_fraction < 1.0 - _ABLATION_EPS:
        cands += ("condensed_over_active",)
        if stats.min_fan_in >= stack.d_in:
            cands += ("structured",)
    rep = min(cands, key=lambda r: costs[r])
    return StackDecision(name=stack.name, representation=rep, est_s=costs, stats=stats)


def _build_leaf(rep: str, weight: torch.Tensor, mask: torch.Tensor, stats: F.ExportStats,
                dtype: torch.dtype | None = None,
                values_dtype: str | None = None) -> F.SparseFormat:
    """The format object of one stack. ``weight`` is the float32 param (the
    quantized codes are cut from it). ``values_dtype`` is the storage of the
    value-storing formats (quantized structured leaves keep their panel);
    without it the condensed formats store their values at ``dtype`` (the
    compute dtype). Masked reads the live weight and ignores both, as the
    reference does."""
    try:
        cls = F.FORMATS[rep]
    except KeyError:
        raise ValueError(f"unknown representation {rep!r}") from None
    if rep in ("condensed", "condensed_over_active"):
        return cls.export_from_dense(weight, mask, stats, dtype=dtype,
                                     quantize_spec=values_dtype)
    if rep == "structured":
        return cls.export_from_dense(weight, mask, stats, quantize_spec=values_dtype)
    return cls.export_from_dense(weight, mask, stats)


def _decide(stack, path: str, *, batch_size: int, itemsize: int, stats: F.ExportStats,
            profile: HardwareProfile, values_dtype: str | None = None) -> StackDecision:
    """One stack's decision: the cost model's for "auto", forced otherwise.
    An MoE expert stack is priced over its L * E replicas as any stack."""
    if path == "auto":
        dec = select_representation(stack, batch_size=batch_size, itemsize=itemsize,
                                    stats=stats, profile=profile, values_dtype=values_dtype)
    else:
        dec = StackDecision(name=stack.name, representation=path,
                            est_s=_costs(stack, batch_size, itemsize, stats, profile,
                                         values_dtype),
                            stats=stats)
    return dec


def _host_versions(mask_versions: dict) -> dict[str, int]:
    """Trainer counters (host ints or tensors) as a plain int dict. A dict
    of host ints is returned as it is, with no device sync; tensors are
    fetched together with one ``tolist``."""
    mv = dict(mask_versions)
    if all(type(v) is int for v in mv.values()):
        return mv
    tensors = [torch.as_tensor(v) for v in mv.values()]
    dev = next((t.device for t in tensors if t.device.type != "cpu"), torch.device("cpu"))
    vals = torch.stack([t.to(dev, torch.int64).reshape(()) for t in tensors]).tolist()
    return dict(zip(mv, (int(v) for v in vals)))


@dataclasses.dataclass
class Plan:
    """Decisions per stack, the serving tree they built and the mask
    versions it was exported at.

    ``serving_tree`` plugs into the masks slot of prefill/decode_step; its
    leaves are ``formats`` objects, and ``models.layers.linear`` dispatches
    on their type. ``export_calls`` counts per-stack leaf (re)builds over the
    plan's life and ``value_refreshes`` the values-only regathers.
    """

    cfg: object
    registry: list
    path: str                      # requested path ("auto" or a fixed representation)
    batch_size: int                # the batch the plan was priced at (a bucket)
    profile: HardwareProfile
    decisions: dict[str, StackDecision]
    serving_tree: dict
    values_dtype: str | None = None  # storage of the exported values (None: param dtype)
    mask_versions: dict = dataclasses.field(default_factory=dict)  # stack -> version exported
    export_calls: int = 0
    value_refreshes: int = 0       # values-only regathers (no re-sort)

    def representation_of(self, name: str) -> str:
        return self.decisions[name].representation

    def refresh(self, params: dict, masks: dict, mask_versions: dict, *,
                refresh_values: bool = True, donate: bool = True,
                export_cache: dict | None = None) -> list[str]:
        """Incremental re-export: only the stacks whose version moved.

        ``mask_versions`` holds the trainer's per-stack counters (host ints,
        or tensors fetched with one sync). A changed stack gets fresh
        realized stats (one sync over just those stacks), a re-run of the
        decision (ablation appearing can flip condensed to
        condensed_over_active under ``auto``) and a rebuilt leaf. With
        ``refresh_values`` every other condensed-family stack gets a
        values-only regather at its stored indices, so the plan follows
        weights that kept training; masked and float structured leaves read
        the live weight and need nothing.

        ``donate=True`` writes each same-shape leaf into its existing
        tensors (the port's form of the reference's donated programs), one
        stack layer at a time, so the plan's weights never exist twice and
        graphs captured over it keep reading the right storage;
        ``donate=False`` leaves the old leaves intact. ``export_cache``, one
        dict for a whole refresh sweep, shares each (stack,
        representation, version) export across plans: the first plan
        refreshes its own leaf, the others adopt that leaf object. Returns
        the names of the re-exported stacks.
        """
        versions = _host_versions(mask_versions)
        by_name = {s.name: s for s in self.registry}
        changed = [by_name[n] for n, v in versions.items()
                   if n in by_name and v != self.mask_versions.get(n)]
        changed_names = {s.name for s in changed}
        dtype = getattr(torch, self.cfg.dtype)
        if changed:
            stats = COND.export_stats(self.registry, masks, stacks=changed)
            itemsize = getattr(torch, self.cfg.param_dtype).itemsize
            for s in changed:
                dec = _decide(s, self.path, batch_size=self.batch_size, itemsize=itemsize,
                              stats=stats[s.name], profile=self.profile,
                              values_dtype=self.values_dtype)
                rep = dec.representation
                weight, mask = REG.get_path(params, s.path), REG.get_path(masks, s.path)
                key = (s.name, rep, self.values_dtype, versions[s.name])
                if export_cache is not None and key in export_cache:
                    leaf = export_cache[key]
                elif rep in ("condensed", "condensed_over_active") and \
                        rep == self.decisions[s.name].representation:
                    leaf = COND.recondense_stack_leaf(
                        weight, mask, stats[s.name], REG.get_path(self.serving_tree, s.path),
                        over_active=rep == "condensed_over_active", donate=donate,
                        quantize_spec=self.values_dtype, dtype=dtype)
                elif donate and rep == self.decisions[s.name].representation:
                    leaf = REG.get_path(self.serving_tree, s.path).donate_refresh(
                        weight, mask, stats[s.name])
                else:
                    leaf = _build_leaf(rep, weight, mask, stats[s.name], dtype,
                                       self.values_dtype)
                if export_cache is not None:
                    export_cache[key] = leaf
                self.decisions[s.name] = dec
                REG.set_path(self.serving_tree, s.path, leaf)
                self.mask_versions[s.name] = versions[s.name]
                self.export_calls += 1
        if refresh_values:
            for s in self.registry:
                if s.name in changed_names:
                    continue
                leaf = REG.get_path(self.serving_tree, s.path)
                if not isinstance(leaf, F.CONDENSED_FAMILY):
                    continue
                key = (s.name, type(leaf).__name__, self.values_dtype, "values")
                if export_cache is not None and key in export_cache:
                    fresh = export_cache[key]
                else:
                    fresh = COND.revalue_stack_leaf(REG.get_path(params, s.path),
                                                    REG.get_path(masks, s.path), leaf,
                                                    donate=donate)
                    if export_cache is not None:
                        export_cache[key] = fresh
                REG.set_path(self.serving_tree, s.path, fresh)
                self.value_refreshes += 1
        return [s.name for s in changed]

    def weight_bytes(self) -> tuple[int, int]:
        """(serving weight bytes under this plan, masked-path weight bytes),
        each format pricing its own export from the realized stats."""
        itemsize = getattr(torch, self.cfg.param_dtype).itemsize
        masked_ref = serving = 0
        for s in self.registry:
            dec = self.decisions[s.name]
            spec = F.spec_for_stack(s, dec.stats, itemsize, self.values_dtype)
            serving += F.FORMATS[dec.representation].estimate_weight_bytes(spec)
            masked_ref += F.MaskedDense.estimate_weight_bytes(spec)
        return serving, masked_ref

    def describe(self, requested_batch: int | None = None) -> str:
        """Human-readable plan table; a requested batch that differs from the
        bucket the plan was priced at is printed beside it."""
        batch_s = f"batch={self.batch_size}"
        if requested_batch is not None and int(requested_batch) != self.batch_size:
            batch_s = f"batch={int(requested_batch)} (bucket {self.batch_size})"
        vd = f" values_dtype={self.values_dtype}" if self.values_dtype else ""
        lines = [f"[plan] path={self.path} {batch_s} profile={self.profile.name}{vd}"]
        for name, dec in self.decisions.items():
            lines.append(
                f"[plan]   {name:24s} -> {dec.representation:22s} "
                f"(est {dec.est_s[dec.representation] * 1e6:8.3f} us/step, "
                f"k={dec.stats.k}, active={dec.active_fraction:.2f})")
        return "\n".join(lines)


def build_plan(cfg, registry, params: dict, masks: dict, *, batch_size: int = 1,
               path: str = "auto", mask_versions: dict | None = None,
               profile: HardwareProfile = DEFAULT_PROFILE,
               values_dtype: str | None = None) -> Plan:
    """The per-stack execution plan for a request of ``batch_size`` rows.

    ``path="auto"`` chooses per stack by the cost model, a representation
    name forces it everywhere. Costs are priced at the param dtype's width,
    as in the reference, or at ``values_dtype``'s ("bf16", "int8", "fp8";
    None or "f32" keep the param dtype) for the value-storing formats, whose
    leaves then store their values at that width, quantized from the float32
    ``params``. Without it condensed values are stored at ``cfg.dtype``.
    ``mask_versions`` (the trainer's counters; 0 for every stack by
    default) stamps the versions exported, so a later ``refresh``
    re-exports only the stacks whose counter moved.
    """
    if path not in PATHS:
        raise ValueError(f"unknown serving path {path!r}; expected one of {PATHS}")
    vd = F.resolve_quantize_spec(values_dtype)
    registry = list(registry or [])
    versions = (_host_versions(mask_versions) if mask_versions is not None
                else {s.name: 0 for s in registry})
    itemsize = getattr(torch, cfg.param_dtype).itemsize
    dtype = getattr(torch, cfg.dtype)
    stats = COND.export_stats(registry, masks)
    decisions: dict[str, StackDecision] = {}
    tree: dict = {}
    for s in registry:
        dec = _decide(s, path, batch_size=batch_size, itemsize=itemsize,
                      stats=stats[s.name], profile=profile, values_dtype=vd)
        decisions[s.name] = dec
        REG.set_path(tree, s.path, _build_leaf(dec.representation,
                                               REG.get_path(params, s.path),
                                               REG.get_path(masks, s.path),
                                               stats[s.name], dtype, vd))
    return Plan(cfg=cfg, registry=registry, path=path, batch_size=batch_size,
                profile=profile, decisions=decisions, serving_tree=tree, values_dtype=vd,
                mask_versions={s.name: versions.get(s.name, 0) for s in registry},
                export_calls=len(registry))


# ---------------------------------------------------------------------------
# planning without allocation (the dry run's)
# ---------------------------------------------------------------------------

def plan_for_shape(cfg, registry, *, batch_size: int,
                   profile: HardwareProfile = DEFAULT_PROFILE) -> dict[str, str]:
    """Each stack's representation at ``batch_size`` from static
    information alone: the target ERK densities, no realized mask, so no
    ablation is assumed and only masked and condensed compete (the dry
    run's choice of what to build)."""
    itemsize = getattr(torch, cfg.param_dtype).itemsize
    out = {}
    for s in registry:
        k = D.fan_in_from_density(s.d_in, s.density)
        stats = F.ExportStats(k=k, max_active=s.d_out, active_fraction=1.0, min_fan_in=k)
        out[s.name] = select_representation(s, batch_size=batch_size, itemsize=itemsize,
                                            stats=stats, profile=profile).representation
    return out


def abstract_serving_tree(cfg, registry, reps: dict[str, str],
                          param_dtype: torch.dtype | None = None) -> dict:
    """The serving tree of ``reps`` (stack name -> representation) as leaves
    of meta tensors (each format's ``abstract``), at each stack's target
    fan-in and ``param_dtype`` (default ``cfg.param_dtype``), as the
    reference's. Condensed-over-active and structured take the padded
    ``d_out`` as their row bound; a concrete export shrinks it to the
    realized active count."""
    dt = param_dtype or getattr(torch, cfg.param_dtype)
    out: dict = {}
    for s in registry:
        try:
            cls = F.FORMATS[reps[s.name]]
        except KeyError:
            raise ValueError(f"unknown representation {reps[s.name]!r}") from None
        REG.set_path(out, s.path, cls.abstract(s.lead, s.d_in, s.d_out,
                                               D.fan_in_from_density(s.d_in, s.density), dt))
    return out


# ---------------------------------------------------------------------------
# self-draft speculative decoding: the draft tree and its price
#
# The draft is the target plan at a higher neuron ablation, derived per
# stack from the serving leaf without copying any value tensor:
# * condensed / condensed_over_active: the dropped rows' ``out_index`` is
#   set to the sentinel, so the gather still runs over every row and drops
#   them at the scatter ("sentinel": exact zeros, no compute saved);
# * float structured (and ablation-only masked stacks): a smaller column
#   subset of the live weight ("subset": fewer columns run);
# * quantized structured: the dropped panel columns become sentinels;
# * masked stacks that are not ablation-only draft as themselves
#   ("identity").
# Dropped neurons are the least salient: sum |values| per output neuron
# (dequantized where there are scales), the column L1 norm of the live
# weight for the live-weight formats.
# ---------------------------------------------------------------------------


def _draft_keep(n: int, draft_ablation: float) -> int:
    """Rows or columns the draft keeps out of ``n`` at ablation ``F``."""
    f = min(max(float(draft_ablation), 0.0), 1.0)
    return max(int(math.ceil(n * (1.0 - f))), 1)


def _keep_top_rows(saliency: torch.Tensor, valid: torch.Tensor, keep: int) -> torch.Tensor:
    """Bool mask of the top-``keep`` valid entries of the last axis per lead
    replica. A stable descending sort breaks ties toward the lower index,
    as ``jax.lax.top_k`` does."""
    s = torch.where(valid, saliency.float(), torch.tensor(-torch.inf, device=saliency.device))
    flat = s.reshape(-1, s.shape[-1])
    idx = torch.sort(flat, dim=-1, descending=True, stable=True).indices[:, :min(keep, s.shape[-1])]
    km = torch.zeros(flat.shape, dtype=torch.bool, device=s.device)
    km.scatter_(1, idx, True)
    return km.reshape(s.shape) & valid


def _row_saliency(values: torch.Tensor, scales: torch.Tensor | None) -> torch.Tensor:
    s = values.float().abs().sum(dim=-1)
    return s * scales if scales is not None else s


def _is_ablation_only(mask: torch.Tensor) -> bool:
    """Does every surviving column keep its full fan-in? One layer at a
    time (a whole-stack comparison would hold a second mask-sized tensor),
    and one host sync."""
    layers = mask.reshape(-1, *mask.shape[-2:])
    full = torch.ones((), dtype=torch.bool, device=mask.device)
    for m in layers:
        full &= torch.all(m == m.any(dim=-2, keepdim=True))
    return bool(full)


def _structured_subset(weight: torch.Tensor, neuron_active: torch.Tensor, keep: int,
                       weight_itemsize: int) -> F.StructuredFanIn:
    """A live-weight column-subset ``StructuredFanIn`` draft."""
    d_out = neuron_active.shape[-1]
    sal = weight.float().abs().sum(dim=-2)
    km = _keep_top_rows(sal, neuron_active, keep)
    a_pad = F.padded_active_count(min(keep, d_out), d_out)
    return F.StructuredFanIn(neuron_active=km, active_index=F.active_index_from_bools(km, a_pad),
                             d_in=int(weight.shape[-2]), weight_itemsize=weight_itemsize)


def derive_draft_leaf(leaf: F.SparseFormat, weight: torch.Tensor, mask: torch.Tensor,
                      draft_ablation: float) -> tuple[F.SparseFormat, str]:
    """One stack's draft leaf from its target serving leaf.

    Returns (draft_leaf, kind): ``"subset"`` drafts run fewer columns,
    ``"sentinel"`` drafts share the target's tensors and drop rows at the
    scatter, ``"identity"`` stacks draft as themselves. Value tensors are
    never copied: a draft's ``values`` and ``scales`` are the target leaf's
    own tensor objects, and subset drafts read the live weight.
    """
    if isinstance(leaf, F.Condensed):
        d_out = leaf.values.shape[-2]
        sal = _row_saliency(leaf.values, leaf.scales)
        km = _keep_top_rows(sal, torch.ones(sal.shape, dtype=torch.bool, device=sal.device),
                            _draft_keep(d_out, draft_ablation))
        rows = torch.arange(d_out, dtype=torch.int32, device=sal.device).expand(sal.shape)
        oi = torch.where(km, rows, d_out).to(torch.int32)
        return F.CondensedOverActive(values=leaf.values, indices=leaf.indices, out_index=oi,
                                     d_in=leaf.d_in, d_out=d_out, scales=leaf.scales,
                                     values_dtype=leaf.values_dtype), "sentinel"
    if isinstance(leaf, F.CondensedOverActive):
        valid = leaf.out_index < leaf.d_out
        sal = _row_saliency(leaf.values, leaf.scales)
        km = _keep_top_rows(sal, valid, _draft_keep(leaf.values.shape[-2], draft_ablation))
        oi = torch.where(km, leaf.out_index, leaf.d_out).to(leaf.out_index.dtype)
        return dataclasses.replace(leaf, out_index=oi), "sentinel"
    if isinstance(leaf, F.StructuredFanIn):
        d_out = leaf.neuron_active.shape[-1]
        if leaf.values is not None:
            # quantized: the stored panel is indexed by position, so the
            # layout stays and the dropped columns become sentinels
            valid = leaf.active_index < d_out
            sal = leaf.values.float().abs().sum(dim=-2)
            if leaf.scales is not None:
                sal = sal * leaf.scales
            km = _keep_top_rows(sal, valid,
                                _draft_keep(leaf.active_index.shape[-1], draft_ablation))
            ai = torch.where(km, leaf.active_index, d_out).to(leaf.active_index.dtype)
            return dataclasses.replace(leaf, active_index=ai), "sentinel"
        keep = _draft_keep(leaf.active_index.shape[-1], draft_ablation)
        return _structured_subset(weight, leaf.neuron_active, keep,
                                  leaf.weight_itemsize), "subset"
    if isinstance(leaf, F.MaskedDense):
        if not _is_ablation_only(mask):
            return leaf, "identity"
        act = mask.any(dim=-2)
        a = max(int(act.sum(dim=-1, dtype=torch.int32).max()), 1)
        return _structured_subset(weight, act, _draft_keep(a, draft_ablation),
                                  leaf.weight_itemsize), "subset"
    raise ValueError(f"cannot derive a draft from {type(leaf).__name__}")


def derive_draft_tree(registry, serving_tree: dict, params: dict, masks: dict,
                      draft_ablation: float) -> tuple[dict, dict[str, str]]:
    """The draft serving tree for a plan's ``serving_tree``: (tree, the kind
    of each stack's draft). It plugs into the same masks slot of the paged
    decode step; the embeddings, norms and dense layers are the model's
    own."""
    tree: dict = {}
    report: dict[str, str] = {}
    for s in registry:
        leaf = REG.get_path(serving_tree, s.path)
        if not isinstance(leaf, F.SparseFormat):
            raise ValueError(
                f"stack {s.name!r} serves a raw mask leaf ({type(leaf).__name__}); "
                "speculative drafting needs a format-typed plan (any engine path "
                "except 'masked')")
        draft, kind = derive_draft_leaf(leaf, REG.get_path(params, s.path),
                                        REG.get_path(masks, s.path), draft_ablation)
        REG.set_path(tree, s.path, draft)
        report[s.name] = kind
    return tree, report


def draft_weight_overhead_bytes(registry, target_tree: dict,
                                draft_tree: dict) -> tuple[int, int]:
    """(shared_bytes, extra_bytes) of value storage in a draft tree.

    ``shared`` counts the draft's ``values``/``scales`` tensors that are the
    target leaf's own tensor objects (compared by identity: the zero extra
    weight residency contract), ``extra`` any other value storage, which the
    engine asserts to be 0. Index and bool metadata (``active_index``,
    ``out_index``, ``neuron_active``) is not weight data and is left out.
    """
    shared = extra = 0
    for s in registry:
        t = REG.get_path(target_tree, s.path)
        d = REG.get_path(draft_tree, s.path)
        target_ids = {id(getattr(t, f)) for f in t._array_fields
                      if getattr(t, f, None) is not None}
        for f in ("values", "scales"):
            arr = getattr(d, f, None)
            if arr is None:
                continue
            nbytes = arr.numel() * arr.element_size()
            if id(arr) in target_ids:
                shared += nbytes
            else:
                extra += nbytes
    return shared, extra


def expected_tokens_per_dispatch(acceptance: float, gamma: int) -> float:
    """Expected tokens committed per verify dispatch at per-token acceptance
    ``a``: 1 + a + ... + a^gamma (the verify always commits the target's own
    next token, plus every accepted draft prefix token)."""
    a = min(max(float(acceptance), 0.0), 1.0)
    g = max(int(gamma), 0)
    if a >= 1.0:
        return float(g + 1)
    return (1.0 - a ** (g + 1)) / (1.0 - a)


@dataclasses.dataclass(frozen=True)
class SpecEstimate:
    """The priced speculation decision for one plan key.

    The costs are sums over the sparse stacks, priced as the plan's own
    decisions are (attention and dense layers cost the same under draft and
    target); the verify is the full network at ``batch * (gamma + 1)`` rows.
    """

    gamma: int
    acceptance: float            # assumed per-token acceptance
    expected_tokens: float       # tokens committed per verify dispatch
    target_step_s: float         # one full-network step at the bucket
    draft_step_s: float          # one draft-tree step at the bucket
    verify_s: float              # one (gamma + 1)-position verify

    @property
    def spec_s_per_token(self) -> float:
        return (self.gamma * self.draft_step_s + self.verify_s) / max(self.expected_tokens, 1e-9)

    @property
    def base_s_per_token(self) -> float:
        return self.target_step_s

    @property
    def worthwhile(self) -> bool:
        return self.spec_s_per_token < self.base_s_per_token


def _tree_step_cost(registry, tree: dict, batch: int, profile: HardwareProfile) -> float:
    return sum(type(leaf).estimate_cost(leaf.spec(), batch, profile)
               for leaf in (REG.get_path(tree, s.path) for s in registry))


def price_speculation(registry, target_tree: dict, draft_tree: dict, *, batch_size: int,
                      gamma: int, acceptance: float = 0.7,
                      profile: HardwareProfile = DEFAULT_PROFILE) -> SpecEstimate:
    """Expected tokens per dispatch at (acceptance, gamma) against the cost
    of gamma draft steps and one batched verify: the price by which
    ``--path auto`` declines speculation when the draft is too slow
    (sentinel drafts save no compute) or the assumed acceptance too low."""
    b = max(int(batch_size), 1)
    return SpecEstimate(
        gamma=int(gamma), acceptance=float(acceptance),
        expected_tokens=expected_tokens_per_dispatch(acceptance, gamma),
        target_step_s=_tree_step_cost(registry, target_tree, b, profile),
        draft_step_s=_tree_step_cost(registry, draft_tree, b, profile),
        verify_s=_tree_step_cost(registry, target_tree, b * (int(gamma) + 1), profile))
