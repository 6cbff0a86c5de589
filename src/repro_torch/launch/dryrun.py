"""Planning without allocation: meta-device dry runs of every config (port of
``repro/launch/dryrun.py``).

Every tensor of a cell lies on ``torch.device("meta")``, which has shapes
and dtypes and no storage: the params (``models.model.init_params`` with the
meta device in place of a generator), the masks, the plan's serving tree
(``sparse.plan.abstract_serving_tree`` at the target fan-ins), the KV cache
or page pool, the optimizer state and the batch (``data.pipeline.
make_batch_spec``). The cell then runs one step of its program on them: the
model code runs as on the card, and each kernel wrapper's meta branch
returns the kernel's output (and allocates its workspace) without running
anything. So a config that fits no card (kimi-k2-1t, mistral-large-123b at
full depth) is planned and sized on any host, and nothing is allocated.

Each cell reports, as the reference's does, one JSON object:

* ``argument_bytes``: the step's inputs, summed exactly over their distinct
  storages (params, serving tree or optimizer state, cache or pool, batch),
  each part also on its own (``*_bytes``);
* ``output_bytes``: the step's outputs (a cache or pool written in place is
  counted again, as the reference's donated outputs are);
* ``peak_bytes``: the high-water mark of live meta storage during the step,
  inputs included, tracked by ``MetaMemory`` (a ``TorchDispatchMode``). It is
  an estimate: the card's caching allocator, cuBLAS workspaces and the
  kernels' own launch geometry are not in it.

Programs (``--program``): ``serve`` (masked decode or prefill on the slab
cache, the shape's kind), ``serve_cond``, ``serve_struct``, ``serve_plan``
and ``serve_engine`` (slab decode under an abstract serving tree: all
condensed, all structured, the cost model's choice at the shape's batch, the
engine's group at that batch), ``serve_paged`` (one paged decode step,
masked), ``train`` (one trainer step: forward, backward, clipping and the
optimizer update) and ``serve_zoo`` (one cell per arch: the engine's plan
key, the abstract tree and one decode step of the group's program, paged
where ``supports_paged``, else on the slab cache; the encoder-only ViT stops
after the key). ``auto`` picks ``train`` or ``serve`` by the shape.

Not ported, and refused naming their ROADMAP item: the topology-update
program (``dst``), the tensor-parallel cell (``serve_tp``), the production
meshes (``--multi-pod``, ``--both-meshes``) and the HLO roofline
(``--roofline``).

Usage:
  python -m repro_torch.launch.dryrun --program serve_zoo --arch all
  python -m repro_torch.launch.dryrun --program train --arch zamba2-7b
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --program serve_paged \\
      --shapes decode_32k --out cells.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.data.pipeline import make_batch_spec
from repro_torch.launch import engine as ENG
from repro_torch.models import model as M
from repro_torch.models import paged as PG
from repro_torch.optim import make_optimizer
from repro_torch.sparse import formats as F
from repro_torch.sparse import plan as PLAN
from repro_torch.sparse import registry as REG
from repro_torch.train.state import TrainState
from repro_torch.train.trainer import make_train_step

META = torch.device("meta")
BLOCK_SIZE = 16                      # the engine's page size in tokens
PROGRAMS = ("auto", "train", "serve", "serve_cond", "serve_struct", "serve_plan",
            "serve_engine", "serve_paged", "serve_zoo")
NOT_PORTED = {"dst": ("the topology-update program", 12),
              "serve_tp": ("the tensor-parallel serving cell", 9)}


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP queue 1, item {item})")


# ---------------------------------------------------------------------------
# bytes of meta tensors
# ---------------------------------------------------------------------------

def tensors(*trees):
    """Every tensor in ``trees``: dicts, lists, tuples (a ``TrainState``
    among them) and format leaves (their ``arrays``)."""
    for t in trees:
        if isinstance(t, torch.Tensor):
            yield t
        elif isinstance(t, F.SparseFormat):
            yield from t.arrays().values()
        elif isinstance(t, dict):
            yield from tensors(*t.values())
        elif isinstance(t, (list, tuple)):
            yield from tensors(*t)


def tree_bytes(*trees) -> int:
    """Bytes of the distinct storages under ``trees`` (a view counts once)."""
    seen: dict[int, int] = {}
    for t in tensors(*trees):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


class MetaMemory(TorchDispatchMode):
    """Live and peak bytes of meta storage while the mode is on.

    The storages of ``roots`` are live from the start; each operator's
    outputs add their storages when first seen, and a storage's bytes leave
    when it is freed (a finalizer on its Python object, which PyTorch keeps
    while any view of it lives).
    """

    def __init__(self, *roots):
        super().__init__()
        self.live = self.peak = 0
        self._ids: set[int] = set()
        for t in tensors(*roots):
            self._track(t)

    def _track(self, t) -> None:
        if not isinstance(t, torch.Tensor) or t.device.type != "meta":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._ids:
            return
        n = st.nbytes()
        self._ids.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._ids.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tensors(out):
            self._track(t)
        return out


def _step(fn, inputs: dict, result: dict) -> None:
    """Run ``fn()`` once under ``MetaMemory`` and record its bytes in
    ``result``: each input part's (``<name>_bytes``), their sum
    (``argument_bytes``), the outputs' and the peak."""
    for name, tree in inputs.items():
        result[f"{name}_bytes"] = tree_bytes(tree)
    result["argument_bytes"] = tree_bytes(*inputs.values())
    t0 = time.perf_counter()
    with torch.no_grad(), MetaMemory(*inputs.values()) as mem:
        out = fn()
    result["output_bytes"] = tree_bytes(out)
    result["peak_bytes"] = mem.peak
    result["step_s"] = time.perf_counter() - t0


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def abstract_params(cfg, registry) -> dict:
    """The parameter tree as meta tensors (nothing drawn)."""
    return M.init_params(cfg, META, REG.k_fan_map(cfg, registry))


def abstract_masks(registry) -> dict:
    """The training masks, bool (lead..., d_in, d_out) meta tensors."""
    out: dict = {}
    for s in registry:
        REG.set_path(out, s.path, torch.empty((*s.lead, s.d_in, s.d_out), dtype=torch.bool,
                                              device=META))
    return out


def abstract_pool(cfg, batch: int, seq_len: int, block_size: int = BLOCK_SIZE, *,
                  pages: tuple[int, int] | None = None):
    """(pool, block table, lengths) of a paged decode at ``batch`` streams of
    up to ``seq_len`` tokens: ``batch`` x pages-per-stream pages, as the
    reference's dry run (the engine adds its garbage page). ``pages``
    (pool pages, table width) gives an engine's own sizes instead."""
    nb = PG.pages_for(seq_len + block_size, block_size)
    n_pages, width = pages or (batch * nb, nb)
    pool = M.init_paged_pool(cfg, n_pages, block_size, META)
    return (pool, torch.empty((batch, width), dtype=torch.int32, device=META),
            torch.empty((batch,), dtype=torch.int32, device=META))


def abstract_train_state(cfg, registry) -> TrainState:
    """A ``TrainState`` of meta tensors (the step counter on the CPU, as the
    trainer keeps it)."""
    params = abstract_params(cfg, registry)
    masks = abstract_masks(registry)
    active: dict = {}
    accum: dict = {}
    for s in registry:
        REG.set_path(active, s.path, torch.empty((*s.lead, s.d_out), dtype=torch.bool,
                                                 device=META))
        if cfg.sparsity.grad_accum_for_saliency > 1:
            REG.set_path(accum, s.path, torch.empty((*s.lead, s.d_in, s.d_out),
                                                    dtype=torch.float32, device=META))
    opt_init, _ = make_optimizer(cfg.optimizer)
    return TrainState(step=torch.zeros((), dtype=torch.int32), params=params,
                      opt_state=opt_init(params), masks=masks, neuron_active=active,
                      grad_accum=accum,
                      mask_versions={s.name: torch.zeros((), dtype=torch.int32)
                                     for s in registry},
                      rng=None)


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------

def serve_slab(cfg, shape, masks: dict, result: dict, params: dict | None = None) -> dict:
    """One step of the slab path (``prefill_step`` for a prefill shape, else
    ``decode_step``) on a contiguous cache of ``shape.seq_len`` tokens, with
    ``masks`` (raw masks or a serving tree) in the masks slot."""
    params = abstract_params(cfg, REG.build_registry(cfg)) if params is None else params
    cache = M.init_cache(cfg, shape.global_batch, shape.seq_len, META)
    batch = make_batch_spec(cfg, shape)
    step = M.prefill_step if shape.kind == "prefill" else M.decode_step
    _step(lambda: step(cfg, params, masks, batch, cache),
          {"params": params, "tree": masks, "cache": cache, "batch": batch}, result)
    return result


def serve_paged(cfg, shape, masks: dict, result: dict, params: dict | None = None, *,
                pages: tuple[int, int] | None = None, block_size: int = BLOCK_SIZE) -> dict:
    """One ``paged_decode_step`` at the shape's batch against a pool of
    ``abstract_pool``'s size (``pages``: an engine's own pool pages and
    table width). ``pool_bytes`` is the pool alone."""
    if not M.supports_paged(cfg):
        raise ValueError(f"{cfg.name}: outside the paged serving path (windowed or ring "
                         "caches, M-RoPE, audio or SSM state); use program=serve")
    params = abstract_params(cfg, REG.build_registry(cfg)) if params is None else params
    pool, table, lengths = abstract_pool(cfg, shape.global_batch, shape.seq_len, block_size,
                                         pages=pages)
    batch = make_batch_spec(cfg, dataclasses.replace(shape, kind="decode"))
    result["pool_bytes"] = tree_bytes(pool)
    _step(lambda: M.paged_decode_step(cfg, params, masks, batch, pool, table, lengths),
          {"params": params, "tree": masks, "cache": {"pool": pool, "table": table,
                                                      "lengths": lengths},
           "batch": batch}, result)
    return result


def serve_planned(cfg, shape, reps: dict[str, str], result: dict) -> dict:
    """Slab decode under the abstract serving tree of ``reps``."""
    registry = REG.build_registry(cfg)
    tree = PLAN.abstract_serving_tree(cfg, registry, reps)
    result["formats"] = reps
    return serve_slab(cfg, dataclasses.replace(shape, kind="decode"), tree, result)


def train(cfg, shape, result: dict) -> dict:
    """One trainer step (``make_train_step``): forward, backward, clipping
    and the optimizer update, on a meta ``TrainState`` and batch."""
    registry = REG.build_registry(cfg)
    state = abstract_train_state(cfg, registry)
    batch = make_batch_spec(cfg, shape)
    step = make_train_step(cfg, registry, lambda s: 1e-3, microbatches=cfg.microbatches)
    # the step differentiates under its own enable_grad
    _step(lambda: step(state, batch),
          {"params": state.params, "opt_state": state.opt_state, "masks": state.masks,
           "neuron_active": state.neuron_active, "grad_accum": state.grad_accum,
           "batch": batch}, result)
    return result


def run_cell(arch: str, shape_name: str, program: str = "auto", *,
             quiet: bool = False) -> dict:
    """One (arch x shape x program) cell at the arch's published config."""
    if program in NOT_PORTED:
        raise _not_ported(*NOT_PORTED[program])
    cfg = configs.get_config(arch)
    shape = configs.SHAPES[shape_name]
    prog = ("train" if shape.kind == "train" else "serve") if program == "auto" else program
    registry = REG.build_registry(cfg)
    result = {"arch": arch, "shape": shape_name, "program": program, "kind": shape.kind,
              "family": cfg.family, "batch": shape.global_batch, "seq_len": shape.seq_len}
    if prog == "train":
        train(cfg, shape, result)
    elif prog == "serve":
        serve_slab(cfg, shape, abstract_masks(registry), result)
    elif prog == "serve_paged":
        serve_paged(cfg, shape, abstract_masks(registry), result)
    elif prog == "serve_cond":
        serve_planned(cfg, shape, {s.name: "condensed" for s in registry}, result)
    elif prog == "serve_struct":
        serve_planned(cfg, shape, {s.name: "structured" for s in registry}, result)
    elif prog == "serve_plan":
        serve_planned(cfg, shape, PLAN.plan_for_shape(cfg, registry,
                                                      batch_size=shape.global_batch), result)
    elif prog == "serve_engine":
        key, reps = ENG.abstract_plan_key(cfg, registry, shape.global_batch)
        result["plan_key"] = key.describe()
        serve_planned(cfg, shape, reps, result)
    else:
        raise ValueError(f"unknown program {program!r}; expected one of {PROGRAMS}")
    _finish(result, quiet)
    return result


def run_zoo_cell(arch: str, *, smoke: bool = False, batch: int | None = None,
                 path: str = "auto", quiet: bool = False,
                 pages: tuple[int, int] | None = None, block_size: int = BLOCK_SIZE,
                 serving_copy: bool = False) -> dict:
    """The config zoo's serving cell for one arch: the plan key a decode
    request of the arch's decode shape groups under
    (``engine.abstract_plan_key``), its abstract serving tree, and one
    decode step of the group's program, paged where the arch supports it,
    else on the slab cache. The encoder-only ViT stops after the key.
    ``batch`` and ``path`` override the shape's batch and the engine's path
    (``smoke`` takes the smoke config and cuts the batch and length to at
    most 8 and 256, as the reference's smoke cell does); ``pages`` and ``block_size`` give
    an engine's pool (``serve_paged``); ``serving_copy`` reads the params
    through the engine's serving copy at the compute dtype
    (``models.model.serving_params``) instead of the raw params the
    reference's cell reads."""
    cfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
    registry = REG.build_registry(cfg)
    shapes = configs.shapes_for(arch, cfg.family, cfg.causal)
    decode = next((s for s in shapes if s.kind == "decode"), None)
    b = batch or (decode.global_batch if decode is not None else 8)
    key, reps = ENG.abstract_plan_key(cfg, registry, b, path=path)
    tree = PLAN.abstract_serving_tree(cfg, registry, reps)
    result = {"arch": arch, "program": "serve_zoo", "smoke": smoke, "family": cfg.family,
              "plan_key": key.describe(), "formats": reps,
              "supports_paged": M.supports_paged(cfg),
              "abstract_leaves": sum(1 for _ in tensors(tree)),
              "decode_shape": decode.name if decode is not None else None}
    if decode is None:
        if not quiet:
            print(f"[serve_zoo] {arch}: encoder-only: plan key {key.describe()}, "
                  "no decode program")
        return result
    shape = dataclasses.replace(decode, global_batch=b)
    if smoke:
        shape = dataclasses.replace(shape, seq_len=min(shape.seq_len, 256),
                                    global_batch=min(shape.global_batch, 8))
    result.update(batch=shape.global_batch, seq_len=shape.seq_len)
    params = abstract_params(cfg, registry)
    if serving_copy:
        params = M.serving_params(cfg, params)
    if M.supports_paged(cfg):
        serve_paged(cfg, shape, tree, result, params, pages=pages, block_size=block_size)
    else:
        serve_slab(cfg, shape, tree, result, params)
    _finish(result, quiet, f"group {key.describe()} "
            f"({'paged' if result['supports_paged'] else 'slab'})")
    return result


def _finish(result: dict, quiet: bool, what: str = "") -> None:
    if quiet:
        return
    name = result["arch"] + (f" x {result['shape']}" if "shape" in result else "")
    print(f"[{result['program']}] {name}: {what + ', ' if what else ''}"
          f"arguments {result['argument_bytes'] / 2**30:.2f} GiB, outputs "
          f"{result['output_bytes'] / 2**30:.2f} GiB, peak {result['peak_bytes'] / 2**30:.2f} "
          f"GiB")


def _write(path: str, results: list) -> None:
    if path:
        with open(path, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shapes", default="", help="comma-separated shape names "
                                                 "(default: every shape of the arch)")
    ap.add_argument("--program", default="auto",
                    help="auto/train/serve/serve_cond/serve_struct/serve_plan/"
                         "serve_engine/serve_paged/serve_zoo")
    ap.add_argument("--smoke", action="store_true",
                    help="serve_zoo: the smoke config and a decode shape cut to 8 x 256")
    ap.add_argument("--out", default="", help="write the cells as JSON lines")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--dst", action="store_true")
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--tp", type=int, default=None)
    args = ap.parse_args(argv)
    if args.multi_pod or args.both_meshes:
        raise _not_ported("the production meshes (--multi-pod, --both-meshes)", 9)
    if args.tp is not None or args.program == "serve_tp":
        raise _not_ported(*NOT_PORTED["serve_tp"])
    if args.dst or args.program == "dst":
        raise _not_ported(*NOT_PORTED["dst"])
    if args.roofline:
        raise _not_ported("the HLO roofline (torch.profiler launch counts)", 12)
    if args.program not in PROGRAMS:
        raise SystemExit(f"unknown program {args.program!r}; expected one of {PROGRAMS}")

    archs = list(configs.ALL_ARCHS) if args.arch == "all" else [args.arch]
    results, failures = [], []
    if args.program == "serve_zoo":
        for arch in archs:
            try:
                results.append(run_zoo_cell(arch, smoke=args.smoke))
            except Exception as e:  # noqa: BLE001 -- report, go on with the sweep
                traceback.print_exc()
                failures.append((arch, "serve_zoo", str(e)[:200]))
        _write(args.out, results)
        print(f"\n{len(results)} zoo cells OK, {len(failures)} failed")
        for f in failures:
            print("FAILED:", f)
        return 1 if failures else 0
    for arch in archs:
        cfg = configs.get_config(arch)
        cells = configs.shapes_for(arch, cfg.family, cfg.causal)
        if args.shapes:
            cells = [s for s in cells if s.name in args.shapes.split(",")]
        if args.program == "train":
            cells = [s for s in cells if s.kind == "train"]
        for shape in cells:
            try:
                results.append(run_cell(arch, shape.name, args.program))
            except Exception as e:  # noqa: BLE001 -- report, go on with the sweep
                traceback.print_exc()
                failures.append((arch, shape.name, args.program, str(e)[:200]))
            _write(args.out, results)
    print(f"\n{len(results)} cells OK, {len(failures)} failed")
    for f in failures:
        print("FAILED:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
