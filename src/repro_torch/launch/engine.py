"""Serving engine: execution primitives and a continuous-batching request
scheduler (port of ``repro/launch/engine.py``).

Execution primitives:

* ``generate`` / ``serve_once`` run one greedy prefill + decode pass over a
  params tree and a serving tree (bool masks or ``formats`` leaves) on a
  contiguous KV cache; ``ServingModel`` is the ``nn.Module`` that owns the
  parameters, their serving copy at the compute dtype and one serving tree.
* Decode on the card is a captured CUDA graph, replayed: the reference runs
  its decode as one jitted ``lax.scan`` program per shape, the port captures
  one decode step per signature -- (serving tree, B, max_len) for the
  contiguous cache, (serving tree, bucket, table width, pool pages, page
  size) for the paged pool -- and replays it once per generated token. One
  replay runs embed, the 28 blocks, the final norm, the logits and their
  argmax, writes the emitted token into a (B, width) buffer at a device step
  index, the next token into ``cur`` and, paged, adds 1 to ``lengths``: the
  reference's emission order, ``gen_len`` steps for ``gen_len`` tokens. A
  chunk is that many replays and one host sync. The graph bakes in the
  addresses of what it reads, so the serving tree, the KV store and the
  static ``cur``/``toks``/``table``/``lengths`` stay where they are while it
  lives; the host fills them with ``copy_`` between chunks. On the CPU the
  same step function runs eagerly (the caller asked for the CPU). A failed
  capture or replay raises; nothing falls back to eager decode on the card.
  Prefill stays eager: one dispatch per admission wave.
* Kernel launch counters (``kernels/counters.py``) record each graph's
  launches at capture and count them once per replay.

``ServingEngine`` (``submit`` / ``step`` / ``retire``) groups requests by
``PlanKey`` (batch bucket x per-stack format signature), builds one
``sparse.plan.Plan`` per key lazily, and serves each group from a paged KV
pool (``models/paged.py``): every dispatch is padded to the group's batch
bucket and prompts to their power-of-two bucket, streams join at chunk
boundaries into a running generation and leave when done, and pad rows
point at the reserved garbage page 0, so a request's tokens do not depend
on who it shares a dispatch with. With ``warm=True`` each new decode
signature is captured (and each new prefill signature run once) on garbage
state outside the timed window, as the reference pre-compiles; a result
whose dispatch had to do so in-line is ``cold``. ``paged=False`` serves
exact-shape slabs through ``generate``'s contiguous cache instead.

The engine owns what it serves: it keeps its own copy of the params, of
their serving copy at the compute dtype and of the masks, so a trainer that
updates the caller's tensors in place moves nothing here. Only ``refresh``
and a sync drain (``attach_subscriber``) change what the engine serves, and
both write into the engine's existing tensors: the params, the masks and
every same-shape plan leaf keep their storage, so the captured graphs read
the new numbers on their next replay. Each decode step records the storage
(address, shape, dtype) of every serving tensor its graph reads; a step
whose record no longer matches (a leaf changed shape, or was rebuilt) is
recaptured at its next chunk, and the result that rode it is ``cold``.

With ``speculative=SpecConfig(...)`` each group decodes in speculative
rounds instead of chunks (``launch/speculative.py``): ``gamma`` steps of a
draft graph over the plan's draft tree (the same weights at a higher neuron
ablation, ``plan.derive_draft_tree``), one verify graph over the ``gamma +
1`` positions, one host sync, acceptance on the host and a paged rewind of
what the round wrote past each stream's committed length. The tokens are
plain greedy decode's. The draft and verify graphs live beside the decode
graph under the same signature rules: dropped with it when the pool moves,
and recaptured when the tensors they read move. A refresh or a sync drain
moves the saliency a draft's ``out_index`` follows, so each draft is
derived again and written into the old draft's tensors where the shapes
hold (its graph stays valid); ``captures`` counts every graph made.

``autotune`` runs the launch-configuration search (``sparse.autotune``)
for every launch the engine's stacks make at a batch bucket; the kernel
wrappers read its entries when a graph is captured, so graphs captured
before it keep their launches (the tokens are the same either way: every
launch of one shape is bitwise equal to every other).

Configurations that ``model.supports_paged`` turns away (gemma3's grouped
local/global layout with its ring caches, qwen2-vl's M-RoPE) are served by
the slab path, as in the reference; a paged or speculative engine for them
is refused.

The MoE family serves on the paged engine like the dense one (its routing
runs inside the captured decode step, the experts through the
expert-grouped launch of their stack's representation: K1-moe, K4-moe or
K5-moe / K6-moe). Its dispatches route their padding rows
too, as the reference's do, so an MoE request's tokens can depend on the
bucket it is padded to, and on what the padding rows read from the
garbage page they all write: of colliding writes the last is kept, as in
the reference (``attention.paged_cache_write``), on any device. It
speculates too: the draft steps route as the decode steps do, and a
verify routes its bucket x (gamma + 1) rows as one group, as the
reference's does, whose capacity may drop assignments that plain decode
keeps (``models.model.paged_verify_step``).

The SSM family (mamba2) serves on the slab path too, its decode state
(conv_x, conv_bc, h per layer) in the contiguous cache: a captured decode
step reads and writes it in place, and each prefill starts it from zeros
(``models.model.reset_cache``). So does the hybrid (zamba2): the SSM state
of its Mamba2 layers, and one KV slab for each application of its shared
attention block, whose stacks have no leading axis.

``refresh``, sync and ``autotune`` take stacks with two leading axes
(gemma3's ``g_local`` (g, r), the MoE expert stacks (L, E)) as any other.

The audio family (musicgen) is refused by ``generate``, ``serve_once``,
``ServingModel`` and ``ServingEngine.submit`` with a ValueError
(``refuse_audio``), as the reference's fail or refuse: its prompts are
(B, K, T), and the reference serves them only through
``models.model.prefill_step`` / ``decode_step``. The encoder-only ViT has
no decode path at all (``prefill_step`` refuses it).

``abstract_plan_key`` gives the plan key a request would group under,
and its per-stack formats, from static information alone, allocating
nothing (the dry run's, ``launch/dryrun.py``).

Not ported: tensor parallelism (``mesh``, ROADMAP queue 1, item 9), which
raises.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import weakref

import numpy as np
import torch
from torch import nn

from repro_torch import bridge
from repro_torch.kernels import counters
from repro_torch.launch import speculative as SP
from repro_torch.models import model as M
from repro_torch.models import paged as PG
from repro_torch.sparse import autotune as AT
from repro_torch.sparse import condensed as COND
from repro_torch.sparse import formats as F
from repro_torch.sparse import plan as PLAN
from repro_torch.sparse import registry as REG


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _storage(*trees) -> tuple:
    """(address, shape, dtype) of every tensor in ``trees`` (a format leaf
    gives its arrays): the storage a captured decode graph reads."""
    out: list = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, F.SparseFormat):
            for a in t.arrays().values():
                out.append((a.data_ptr(), tuple(a.shape), a.dtype))
        elif isinstance(t, torch.Tensor):
            out.append((t.data_ptr(), tuple(t.shape), t.dtype))

    for tree in trees:
        walk(tree)
    return tuple(out)


def _owned(tree: dict) -> dict:
    """A copy of a nested dict of tensors that shares no storage with it."""
    return {k: _owned(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


@torch.no_grad()
def _copy_into(dst: dict, src: dict) -> None:
    """Write ``src`` into ``dst``'s tensors (same paths, shapes), in place."""
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_into(v, src[k])
        else:
            v.copy_(src[k])


@torch.no_grad()
def _recast_into(compute: dict, params: dict) -> None:
    """Bring a serving copy (``models.model.serving_params`` of ``params``)
    up to date in place: each tensor cast from its param, except those that
    are the param itself."""
    for k, v in compute.items():
        if isinstance(v, dict):
            _recast_into(v, params[k])
        elif v is not params[k]:
            v.copy_(params[k])


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1) int32: the first index of each row's maximum, as jnp.argmax."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


# ---------------------------------------------------------------------------
# the decode step and its graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _DecodeState:
    """What a decode step reads and writes in place. A captured graph holds
    these tensors' addresses: they are filled with ``copy_``, never rebound,
    while it lives."""

    cur: torch.Tensor                   # (B, 1) int32: each row's next token to emit
    toks: torch.Tensor                  # (B, width) int32: the tokens emitted
    step: torch.Tensor                  # (1,) int64: the column of the next emission
    cache: dict | None = None           # contiguous: ``M.init_cache``'s dict
    pool: dict | None = None            # paged: {"pk", "pv"} page pool,
    table: torch.Tensor | None = None   # (B, nb) int32 block tables,
    lengths: torch.Tensor | None = None  # (B,) int32 tokens present per row


def _new_state(b: int, width: int, device, **store) -> _DecodeState:
    return _DecodeState(cur=torch.zeros((b, 1), dtype=torch.int32, device=device),
                        toks=torch.zeros((b, width), dtype=torch.int32, device=device),
                        step=torch.zeros((1,), dtype=torch.int64, device=device), **store)


def _contiguous_step(cfg, params, tree, st: _DecodeState) -> None:
    """One greedy step on the contiguous cache: emit ``cur``, decode it,
    ``cur`` <- its argmax (the reference's ``_decode_loop`` body)."""
    st.toks.index_copy_(1, st.step, st.cur)
    logits, _ = M.decode_step(cfg, params, tree, {"tokens": st.cur}, st.cache)
    st.cur.copy_(_greedy(logits))
    st.step += 1


def _paged_step(cfg, params, tree, st: _DecodeState) -> None:
    """One greedy step on the paged pool (the reference's
    ``_paged_decode_chunk`` body): every row advances its length by one."""
    st.toks.index_copy_(1, st.step, st.cur)
    logits, _ = M.paged_decode_step(cfg, params, tree, {"tokens": st.cur}, st.pool,
                                    st.table, st.lengths)
    st.cur.copy_(_greedy(logits))
    st.lengths += 1
    st.step += 1


class _Decoder:
    """A decode step over static state: on the card captured once in a CUDA
    graph (``capture``) and replayed, on the CPU run eagerly."""

    def __init__(self, step, state: _DecodeState, storage: tuple = ()):
        self.step = step
        self.state = state
        self.storage = storage          # ``_storage`` of what the step reads
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict = {}        # kernel launches one replay makes

    @torch.no_grad()
    def capture(self, pool=None) -> None:
        """Capture the step (after one eager step on a side stream, which
        sets up what the first call of each library and kernel sets up
        lazily: cuBLAS workspaces, the kernels' shared-memory attributes).
        The eager step runs on the state as it is: callers capture on
        garbage state. ``pool`` is a graph pool handle shared by the
        owner's graphs."""
        dev = self.state.cur.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with counters.recording() as tally, torch.cuda.graph(graph, pool=pool):
            self.step()
        self.graph, self.launches = graph, tally

    def run(self, n: int) -> None:
        """``n`` decode steps from step index 0: ``n`` replays on the card,
        the step run ``n`` times on the CPU."""
        if self.graph is None:
            if self.state.cur.device.type != "cpu":
                raise RuntimeError("decode on the card replays a captured graph; "
                                   "capture() first")
            _decode_chunk_eager(self, n)
            return
        self.state.step.zero_()
        for _ in range(n):
            self.graph.replay()
        counters.replayed(self.launches, n)


@torch.no_grad()
def _decode_chunk_eager(decoder: _Decoder, n: int) -> None:
    """``n`` steps of ``decoder`` run eagerly from step index 0, on any
    device: the CPU's decode, and on the card the eager twin of a replay
    that checks hold replay == eager against (not a serving path)."""
    decoder.state.step.zero_()
    for _ in range(n):
        decoder.step()


def _contiguous_decoder(cfg, params, masks, b: int, max_len: int, device, *,
                        decoders: dict | None = None, pool=None,
                        eager: bool = False) -> _Decoder:
    """The decoder of signature (B, max_len) for one serving tree, from
    ``decoders`` (the owner's, keyed by that signature) while the storage
    it recorded is still what ``params`` and ``masks`` hold, or made and,
    on the card, captured (unless ``eager``)."""
    storage = _storage(params, masks)
    dec = None if decoders is None else decoders.get((b, max_len))
    if dec is not None and dec.storage == storage:
        return dec
    st = _new_state(b, max_len, device, cache=M.init_cache(cfg, b, max_len, device))
    dec = _Decoder(functools.partial(_contiguous_step, cfg, params, masks, st), st, storage)
    if device.type == "cuda" and not eager:
        dec.capture(pool)
    if decoders is not None:
        decoders[(b, max_len)] = dec
    return dec


# ---------------------------------------------------------------------------
# contiguous-cache execution primitives
# ---------------------------------------------------------------------------


def refuse_audio(cfg) -> None:
    """The serving loops take (B, T) prompts; the audio family's are (B, K,
    T). The reference's ``generate`` fails on them (``b, t =
    prompts.shape``, its ``launch/engine.py:100``) and its
    ``ServingEngine.submit`` refuses them (``:850``)."""
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: audio prompts are (batch, n_codebooks, prompt_len), which the "
            "serving loops (generate, ServingModel, ServingEngine, the serve CLI) do not "
            "take, as in the reference (its launch/engine.py:100 and :850): serve the audio "
            "family through models.model.prefill_step and decode_step")


def _prefill(cfg, params, masks, batch, cache):
    return M.prefill_step(cfg, params, masks, batch, cache)


@torch.no_grad()
def _timed_serve(cfg, params, masks, prompts: torch.Tensor, gen_len: int, *,
                 decoders: dict | None = None, pool=None, eager: bool = False):
    """One timed prefill + decode pass on a contiguous cache: the prefill
    eager, the decode ``gen_len`` replays of the signature's graph on the
    card. ``decoders`` keeps the owner's graphs across calls (else one is
    captured for this call); ``eager=True`` decodes by running the step
    eagerly instead, which only ``_serve_eager`` asks for.
    Returns (tokens (B, T+gen_len), prefill_s, decode_s, decode_tok_per_s)."""
    refuse_audio(cfg)
    b, t = prompts.shape
    if gen_len == 0:
        return prompts.clone(), 0.0, 0.0, 0.0
    dec = _contiguous_decoder(cfg, params, masks, b, t + gen_len, prompts.device,
                              decoders=decoders, pool=pool, eager=eager)
    st = dec.state
    M.reset_cache(cfg, st.cache)

    t0 = time.perf_counter()
    logits, _ = _prefill(cfg, params, masks, {"tokens": prompts}, st.cache)
    _sync(logits)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    st.cur.copy_(_greedy(logits))
    if eager:
        _decode_chunk_eager(dec, gen_len)
    else:
        dec.run(gen_len)
    toks = st.toks[:, :gen_len].clone()
    _sync(toks)
    t_decode = time.perf_counter() - t0

    tok_s = b * gen_len / max(t_decode, 1e-9)
    return torch.cat([prompts, toks], dim=1), t_prefill, t_decode, tok_s


def _serve_eager(cfg, params, masks, prompts: torch.Tensor, gen_len: int):
    """``_timed_serve`` with the decode step run eagerly on any device: the
    eager loop a graph replay is held to (bitwise) and timed against."""
    return _timed_serve(cfg, params, masks, prompts, gen_len, eager=True)


def serve_once(cfg, params, masks, prompts: torch.Tensor, gen_len: int,
               path_name: str, quiet: bool = False, *, decoders: dict | None = None,
               pool=None):
    """One timed prefill+decode pass. Returns (tokens, decode_tok_per_s)."""
    out, t_prefill, t_decode, tok_s = _timed_serve(cfg, params, masks, prompts, gen_len,
                                                   decoders=decoders, pool=pool)
    if not quiet:
        b, t = prompts.shape
        print(f"[serve:{path_name}] prefill {b}x{t} in {t_prefill:.3f}s | "
              f"decode {b}x{gen_len} in {t_decode:.3f}s ({tok_s:.1f} tok/s)")
    return out, tok_s


def generate(cfg, params, masks, prompts: torch.Tensor, gen_len: int) -> torch.Tensor:
    """prompts: (B, T) int32. Greedy decode. Returns (B, T+gen_len)."""
    out, _ = serve_once(cfg, params, masks, prompts, gen_len, "generate", quiet=True)
    return out


def _graph_pool(device: torch.device):
    """A graph pool handle for the graphs of one owner (a ``ServingModel``,
    an engine) to share: on the card, else None."""
    return torch.cuda.graph_pool_handle() if device.type == "cuda" else None


class ServingModel(nn.Module):
    """Parameters under the reference's "/"-joined paths, plus one serving tree.

    ``serving`` is the masks slot of the model: the bool masks (masked
    path), an export's tree of ``formats`` leaves, or a ``sparse.plan.Plan``,
    whose serving tree is used (``self.plan`` keeps the plan, and
    ``self.values_dtype`` its values' storage: None for float values). The
    serving copy of the params (``models.model.serving_params``) is made
    once here, so no call casts weights. Its decode graphs, one per (B,
    max_len), are kept with it and share one graph pool.

    It serves a fixed checkpoint: its tensors are the caller's (and the
    serving copy shares those already at the compute dtype), so a caller
    that goes on training them in place must not serve them through it
    meanwhile; ``ServingEngine`` owns copies and ``refresh`` instead. A
    graph whose recorded storage no longer matches the tensors is
    recaptured.
    """

    def __init__(self, cfg, params: dict, serving: dict | PLAN.Plan):
        super().__init__()
        self.cfg = cfg
        self.weights = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             for k, v in bridge.flatten(params).items()})
        self.plan = serving if isinstance(serving, PLAN.Plan) else None
        self.serving = self.plan.serving_tree if self.plan else serving
        self.values_dtype = self.plan.values_dtype if self.plan else None
        self.compute = M.serving_params(cfg, params)
        self._decoders: dict = {}
        self._graph_pool = _graph_pool(params["embed"].device)

    def serve_once(self, prompts: torch.Tensor, gen_len: int, path_name: str,
                   quiet: bool = False):
        return serve_once(self.cfg, self.compute, self.serving, prompts, gen_len, path_name,
                          quiet=quiet, decoders=self._decoders, pool=self._graph_pool)

    def generate(self, prompts: torch.Tensor, gen_len: int) -> torch.Tensor:
        return self.serve_once(prompts, gen_len, "generate", quiet=True)[0]


# ---------------------------------------------------------------------------
# paged (continuous-batching) execution primitives
# ---------------------------------------------------------------------------


def _paged_prefill(cfg, params, masks, batch, pool, table, prompt_lens):
    return M.paged_prefill_step(cfg, params, masks, batch, pool, table, prompt_lens)


@torch.no_grad()
def _paged_prefill_dispatch(cfg, params, tree, tokens, pool, table, prompt_lens,
                            seen: set, sig):
    """Timed prefill dispatch (eager), writing the pool in place. ``seen``
    holds the prefill signatures already run; ``sig`` is this one's.
    Returns (logits, seconds, cold)."""
    cold = sig not in seen
    seen.add(sig)
    t0 = time.perf_counter()
    logits, _ = _paged_prefill(cfg, params, tree, {"tokens": tokens}, pool, table,
                               prompt_lens)
    _sync(logits)
    return logits, time.perf_counter() - t0, cold


@torch.no_grad()
def _paged_decode_dispatch(runner: "_PagedRunner", chunk: int):
    """Timed decode-chunk dispatch: the runner's host table, lengths and
    next tokens copied into its static buffers, ``chunk`` replays of its
    graph (eager steps on the CPU), one host sync. Returns (toks (B, chunk),
    cur (B, 1), seconds, cold): numpy, and cold when the graph had to be
    captured in-line."""
    t0 = time.perf_counter()
    cold = runner._ensure_decoder()
    st = runner.state
    st.table.copy_(torch.from_numpy(runner.table))
    st.lengths.copy_(torch.from_numpy(runner.lengths))
    st.cur.copy_(torch.from_numpy(runner.cur))
    runner.decoder.run(chunk)
    out = torch.cat([st.toks[:, :chunk], st.cur], dim=1).cpu().numpy()
    runner.steps += chunk
    return out[:, :chunk], out[:, chunk:], time.perf_counter() - t0, cold


@torch.no_grad()
def _spec_dispatch(runner: "_PagedRunner"):
    """One timed speculative round on the device: the host's tables,
    lengths and next tokens copied into the runner's static buffers,
    ``gamma`` replays of the draft graph, one of the verify graph, then the
    round's one host sync (eager steps on the CPU). Returns (feed (B, gamma +
    1), targ (B, gamma + 1), wall seconds, draft seconds, verify seconds,
    cold): numpy; the draft and verify seconds from CUDA events on the card;
    cold when a graph had to be captured in-line."""
    gamma = runner.eng.speculative.gamma
    t0 = time.perf_counter()
    cold = runner._ensure_spec()
    st = runner.state
    st.table.copy_(torch.from_numpy(runner.table))
    st.lengths.copy_(torch.from_numpy(runner.lengths))
    st.cur.copy_(torch.from_numpy(runner.cur))
    stamps = SP.Stamps(st.cur.device)
    stamps.mark()
    runner.draft.run(gamma)
    stamps.mark()
    runner.verify.run(1)
    stamps.mark()
    out = torch.cat([st.toks[:, :gamma + 1], runner.targ], dim=1).cpu().numpy()
    dt_draft, dt_verify = stamps.seconds()
    runner.rounds += 1
    runner.draft_s += dt_draft
    runner.verify_s += dt_verify
    return (out[:, :gamma + 1], out[:, gamma + 1:], time.perf_counter() - t0, dt_draft,
            dt_verify, cold)


@torch.no_grad()
def _adopt_draft(old: dict | None, new: dict, target: dict, registry) -> dict:
    """``new``, a draft derived again after a refresh, written into the
    tensors of ``old``, the draft it replaces, so the captured draft graph
    (which reads ``old``'s addresses) stays valid. That holds where every
    stack's draft keeps its format, static fields, and array shapes and
    dtypes, and shares the same tensors of the (``target``) serving tree;
    otherwise ``new`` is returned and the draft graph is recaptured."""
    if old is None:
        return new
    copies = []
    for s in registry:
        o, n = REG.get_path(old, s.path), REG.get_path(new, s.path)
        if type(o) is not type(n) or any(getattr(o, f) != getattr(n, f)
                                         for f in n._static_fields):
            return new
        oa, na = o.arrays(), n.arrays()
        if oa.keys() != na.keys():
            return new
        shared = {id(a) for a in REG.get_path(target, s.path).arrays().values()}
        for f, t in na.items():
            if t is oa[f]:
                continue                # a target tensor both drafts read
            if id(t) in shared or id(oa[f]) in shared or t.shape != oa[f].shape \
                    or t.dtype != oa[f].dtype:
                return new
            copies.append((oa[f], t))
    for dst, src in copies:
        dst.copy_(src)
    return old


def _pow2_bucket(n: int) -> int:
    """Prompt-length bucket: next power of two (>= 1)."""
    b = 1
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# requests / plan keys / results
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """What makes two requests executable under one shared plan: the batch
    bucket the request falls in (``plan.batch_bucket``) and the per-stack
    format signature the cost model picks at that bucket (a fixed ``path``
    forces it uniform). ``tp`` is the model-axis size, always 1 here."""

    batch_bucket: int
    formats: tuple[tuple[str, str], ...]
    tp: int = 1

    def describe(self) -> str:
        reps = {r for _, r in self.formats}
        rep = reps.pop() if len(reps) == 1 else "mixed"
        tp_s = f"/tp{self.tp}" if self.tp > 1 else ""
        return f"b<={self.batch_bucket}/{rep}{tp_s}"


@dataclasses.dataclass
class Request:
    id: int
    prompts: torch.Tensor   # (B, T) int32, on the host
    gen_len: int


@dataclasses.dataclass
class Result:
    id: int
    tokens: torch.Tensor    # (B, T + gen_len): prompt, then greedy tokens
    plan_key: PlanKey
    prefill_s: float
    decode_s: float
    tok_s: float            # decode throughput of the slab this request ran in
    cold: bool = False      # a dispatch it rode captured a graph (or ran a new
                            # prefill signature) in-line; never with warm=True
    spec: dict | None = None  # ``SpecStats.summary`` when it decoded speculatively


@dataclasses.dataclass(frozen=True)
class GroupReport:
    """What one ``step()`` did for one plan-key group."""
    key: PlanKey
    request_ids: tuple[int, ...]    # requests admitted during this step
    n_slabs: int            # dispatches that admitted them (paged: bucket-padded
                            # prefills; legacy: exact slabs)
    total_batch: int


# ---------------------------------------------------------------------------
# paged runner: per-group scheduler state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Active:
    """One in-flight request: the bucket rows it occupies, the pages it
    owns and the tokens collected so far."""
    req: Request
    rows: list
    pages: list
    remaining: int
    prefill_s: float
    cold: bool
    toks: list = dataclasses.field(default_factory=list)
    decode_s: float = 0.0
    spec: SP.SpecStats = dataclasses.field(default_factory=SP.SpecStats)
    base_pages: int = 0         # the admission budget per row: rewinds stop there


class _PagedRunner:
    """Device and host state of one plan-key group.

    Owns the page pool and the static buffers its graphs read (``state``:
    pool, tables, lengths, next tokens, emitted tokens; ``targ``, the
    verify's argmax), the host copies of the tables, lengths and next
    tokens, and the graphs (``decoder``; ``draft`` and ``verify`` when the
    engine speculates). Rows are bucket slots: every dispatch runs at the full
    ``key.batch_bucket``, idle rows with all-zero tables (the garbage page)
    and length 0.
    """

    def __init__(self, eng: "ServingEngine", key: PlanKey):
        # the engine owns its runners; a weak reference back keeps them out
        # of a cycle, so a dropped engine's graphs are freed at once, never
        # by the cyclic collector (which may run inside another capture)
        self._eng = weakref.ref(eng)
        self.key = key
        self.bucket = key.batch_bucket
        self.bs = eng.block_size
        self.nb = 0                     # table width (pages per stream)
        self.num_blocks = 1             # pool size incl. reserved page 0
        self.alloc = PG.BlockAllocator(1)
        self.table = np.zeros((self.bucket, 0), np.int32)
        self.lengths = np.zeros((self.bucket,), np.int32)
        self.cur = np.zeros((self.bucket, 1), np.int32)
        self.free_rows = list(range(self.bucket))
        self.active: dict[int, _Active] = {}
        self.state: _DecodeState | None = None
        self.decoder: _Decoder | None = None
        self.draft: _Decoder | None = None      # speculative: the draft step
        self.verify: _Decoder | None = None     # speculative: the verify
        self.targ: torch.Tensor | None = None   # (bucket, gamma + 1) verify argmax
        self.prefills = 0               # prefill dispatches of requests
        self.steps = 0                  # decode steps dispatched
        self.rounds = 0                 # speculative rounds dispatched
        self.draft_s = 0.0              # their draft and verify device seconds
        self.verify_s = 0.0

    @property
    def eng(self) -> "ServingEngine":
        return self._eng()

    # -- capacity -----------------------------------------------------------

    def _ensure_capacity(self, nb_needed: int, pages_needed: int) -> None:
        """Size (or grow) the pool so an admission of ``pages_needed`` fresh
        pages with table width ``nb_needed`` fits. Growth moves the pool and
        widens the tables, so the graphs of the old shape are dropped (and
        recaptured at the new one); existing pages keep their ids and
        contents, so in-flight streams are unaffected."""
        nb = max(self.nb, nb_needed)
        blocks = self.num_blocks
        if pages_needed > self.alloc.available or nb > self.nb or self.state is None:
            blocks = max(self.num_blocks + max(pages_needed - self.alloc.available, 0),
                         1 + self.bucket * nb)
        if self.state is None:
            self.nb, self.num_blocks = nb, blocks
            self.alloc = PG.BlockAllocator(blocks)
            self.table = np.zeros((self.bucket, nb), np.int32)
            self._new_state(M.init_paged_pool(self.eng.cfg, blocks, self.bs, self.eng.device))
            return
        pool = self.state.pool
        if blocks > self.num_blocks:
            pad = blocks - self.num_blocks
            pool = {name: torch.cat([a, a.new_zeros((a.shape[0], pad, *a.shape[2:]))], dim=1)
                    for name, a in pool.items()}
            self.alloc.grow(blocks)
            self.num_blocks = blocks
        if nb > self.nb:
            self.table = np.concatenate(
                [self.table, np.zeros((self.bucket, nb - self.nb), np.int32)], axis=1)
            self.nb = nb
        if pool is not self.state.pool or self.state.table.shape[1] != self.nb:
            self._new_state(pool)

    def _new_state(self, pool: dict) -> None:
        eng = self.eng
        dev = eng.device
        sc = eng.speculative
        # a speculative round's feed [cur, d_1..d_gamma] lives in the
        # emitted-token buffer, so it is at least gamma + 1 wide
        width = max(eng.gen_chunk, sc.gamma + 1) if sc is not None else eng.gen_chunk
        self.state = _new_state(
            self.bucket, width, dev, pool=pool,
            table=torch.zeros((self.bucket, self.nb), dtype=torch.int32, device=dev),
            lengths=torch.zeros((self.bucket,), dtype=torch.int32, device=dev))
        self.targ = (torch.zeros((self.bucket, sc.gamma + 1), dtype=torch.int32, device=dev)
                     if sc is not None else None)
        self.decoder = self.draft = self.verify = None

    # -- the decode graph ---------------------------------------------------

    def _signature(self, storage: tuple) -> tuple:
        """The decode program's shape: the pool's and the tables', and the
        shapes and dtypes of the serving tensors it reads."""
        return (self.key, self.bucket, self.nb, self.num_blocks, self.bs,
                tuple((shape, dtype) for _, shape, dtype in storage))

    def _ensure_decoder(self) -> bool:
        """Make the decode step of the current signature if there is none,
        or if the serving tensors it read have moved (a refresh rebuilt a
        leaf), capturing it on the card, on garbage state (every table row
        at page 0, lengths 0, step index 0: the capture's eager warm-up
        step writes only the garbage page and the first token column; the
        host refills the buffers before each chunk).
        Returns whether it had to."""
        eng = self.eng
        tree = eng.serving_tree_for(self.key)
        storage = _storage(eng.compute, tree)
        if self.decoder is not None and self.decoder.storage == storage:
            return False
        self.decoder = self._make("decode", functools.partial(
            _paged_step, eng.cfg, eng.compute, tree, self.state), storage)
        return True

    def _make(self, kind: str, step, storage: tuple, lengths: int = 0) -> _Decoder:
        """A step of ``kind`` over the runner's state, captured on the card
        on garbage state: every table row at page 0, step index 0 and the
        lengths at ``lengths`` (the verify's L0 = lengths - gamma is then 0),
        so the capture's eager warm-up writes only the garbage page; the
        host refills the buffers before each dispatch."""
        eng, st = self.eng, self.state
        st.table.zero_()
        st.lengths.fill_(lengths)
        st.step.zero_()     # a recapture comes after a chunk left it at the chunk's end
        dec = _Decoder(step, st, storage)
        if st.cur.device.type == "cuda":
            dec.capture(eng._graph_pool)
        eng._captures += 1
        eng._programs[kind].add(self._signature(storage) + (
            (eng.speculative.gamma,) if kind != "decode" else ()))
        return dec

    def _ensure_spec(self) -> bool:
        """Make the draft and verify steps of the current signature where
        there are none or the tensors they read have moved (a new draft tree
        after a refresh, a rebuilt leaf), capturing them on the card.
        Returns whether it had to."""
        eng = self.eng
        gamma = eng.speculative.gamma
        made = False
        draft_tree = eng.draft_tree_for(self.key)
        storage = _storage(eng.compute, draft_tree)
        if self.draft is None or self.draft.storage != storage:
            self.draft = self._make("draft", functools.partial(
                _paged_step, eng.cfg, eng.compute, draft_tree, self.state), storage)
            made = True
        tree = eng.serving_tree_for(self.key)
        storage = _storage(eng.compute, tree)
        if self.verify is None or self.verify.storage != storage:
            self.verify = self._make("verify", functools.partial(
                SP.verify_step, eng.cfg, eng.compute, tree, self.state, self.targ, gamma),
                storage, lengths=gamma)
            made = True
        return made

    def _warm(self, kind: str, t: int = 0) -> None:
        """Make a new signature ready outside the timed window: capture the
        decode graph, or run a prefill of prompt bucket ``t`` on garbage
        (zero tokens, all-zero tables, so only page 0 is written). A
        prefill's signature is its dispatch shape (bucket, prompt bucket):
        it runs eagerly, so the pool's size does not key it."""
        eng = self.eng
        if kind == "decode":
            # a new signature only: a graph made stale by a refresh is
            # recaptured in the dispatch, and its result is cold
            if self.decoder is None:
                self._ensure_decoder()
            return
        if kind in ("draft", "verify"):
            if getattr(self, kind) is None:
                self._ensure_spec()
            return
        sig = (self.key, t)
        if sig in eng._programs["prefill"]:
            return
        dev = eng.device
        _paged_prefill_dispatch(
            eng.cfg, eng.compute, eng.serving_tree_for(self.key),
            torch.zeros((self.bucket, t), dtype=torch.int32, device=dev), self.state.pool,
            torch.zeros((self.bucket, self.nb), dtype=torch.int32, device=dev),
            torch.zeros((self.bucket,), dtype=torch.int32, device=dev),
            eng._programs["prefill"], sig)

    # -- admission ----------------------------------------------------------

    def admit(self, pending: list[Request]) -> list[Request]:
        """Admit a FIFO prefix of ``pending`` into free rows with one
        bucket-padded prefill dispatch. Prompts are right-padded to the
        admitted set's power-of-two prompt bucket; every other row (live
        streams mid-decode included) gets an all-zero table so the prefill
        cannot touch their pages. Returns the admitted requests (possibly
        none); on a failed dispatch all bookkeeping is rolled back and
        nothing is admitted."""
        chosen, rows_needed = [], 0
        for r in pending:
            b = r.prompts.shape[0]
            if rows_needed + b > len(self.free_rows):
                break
            chosen.append(r)
            rows_needed += b
        if not chosen:
            return []

        eng = self.eng
        t_bucket = max(_pow2_bucket(r.prompts.shape[1]) for r in chosen)
        # per-stream page budget: prompt bucket + generation, no chunk slack.
        # A stream that finishes mid-chunk rides the chunk out writing
        # garbage tokens; those positions clamp into its own last page, whose
        # real slots it no longer needs, and its pages are released at chunk
        # end. Tight capacity keeps the attention span (nb * bs) near the
        # contiguous cache's.
        per_row = {r.id: PG.pages_for(t_bucket + r.gen_len, self.bs) for r in chosen}
        # speculative: the table is wider than the page budget, by gamma
        # slots: draft and verify overshoot lands in entries that are either
        # best-effort page grants (rewound each round) or zero (the writes
        # clamp into the garbage page, and the commit is capped to match)
        nb_width = max(per_row.values())
        if eng.speculative is not None:
            nb_width = max(PG.pages_for(t_bucket + r.gen_len + eng.speculative.gamma, self.bs)
                           for r in chosen)
        self._ensure_capacity(nb_width,
                              sum(per_row[r.id] * r.prompts.shape[0] for r in chosen))
        if eng.warm:
            self._warm("prefill", t_bucket)

        tokens = np.zeros((self.bucket, t_bucket), np.int32)
        prefill_table = np.zeros((self.bucket, self.nb), np.int32)
        prompt_lens = np.zeros((self.bucket,), np.int32)
        admitted: list[_Active] = []
        try:
            for r in chosen:
                b, t = r.prompts.shape
                rows = [self.free_rows.pop(0) for _ in range(b)]
                prompts_np = r.prompts.numpy()
                pages_all: list[int] = []
                for i, row in enumerate(rows):
                    pages = self.alloc.alloc(per_row[r.id])
                    pages_all.extend(pages)
                    self.table[row, :] = 0
                    self.table[row, :len(pages)] = pages
                    prefill_table[row] = self.table[row]
                    tokens[row, :t] = prompts_np[i]
                    prompt_lens[row] = t
                admitted.append(_Active(req=r, rows=rows, pages=pages_all,
                                        remaining=r.gen_len, prefill_s=0.0, cold=False,
                                        base_pages=per_row[r.id]))
            dev = eng.device
            logits, dt, cold = _paged_prefill_dispatch(
                eng.cfg, eng.compute, eng.serving_tree_for(self.key),
                torch.from_numpy(tokens).to(dev), self.state.pool,
                torch.from_numpy(prefill_table).to(dev),
                torch.from_numpy(prompt_lens).to(dev), eng._programs["prefill"],
                (self.key, t_bucket))
        except Exception:
            # roll back: nothing was admitted, the requests stay pending
            for a in admitted:
                self.alloc.release(a.pages)
                for row in a.rows:
                    self.table[row, :] = 0
                    self.free_rows.append(row)
            raise
        self.prefills += 1
        first = _greedy(logits).cpu().numpy()
        for a in admitted:
            a.prefill_s = dt
            a.cold = cold
            for row in a.rows:
                self.cur[row, 0] = first[row, 0]
                self.lengths[row] = prompt_lens[row]
            self.active[a.req.id] = a
        return [a.req for a in admitted]

    # -- decode -------------------------------------------------------------

    def decode_chunk(self) -> None:
        """One decode chunk over the full bucket. The chunk is adaptive,
        ``min(gen_chunk, longest remaining)``, so a nearly done group does
        not pay for a full one; streams that finish inside it are retired
        (pages freed, rows recycled) before the next."""
        if not self.active:
            return
        eng = self.eng
        chunk = min(eng.gen_chunk, max(a.remaining for a in self.active.values()))
        live = np.zeros((self.bucket,), bool)
        for a in self.active.values():
            live[a.rows] = True
        self.lengths[~live] = 0      # idle rows: writes pinned to page 0
        if eng.warm:
            self._warm("decode")
        toks, cur, dt, cold = _paged_decode_dispatch(self, chunk)
        self.cur = cur.copy()
        self.lengths[live] += chunk
        for a in list(self.active.values()):
            take = min(chunk, a.remaining)
            a.toks.append(toks[a.rows, :take])
            a.remaining -= take
            a.decode_s += dt
            a.cold = a.cold or cold
            if a.remaining == 0:
                self._retire(a)

    # -- speculative rounds -------------------------------------------------

    def spec_round(self) -> None:
        """One speculative round over the full bucket: ``gamma`` draft steps,
        one verify over the ``gamma + 1`` positions, acceptance on the host,
        and a paged rewind of what the round wrote past each stream's new
        committed length. A request's rows commit in lockstep (they share
        one remaining count): each commits the minimum over its rows of
        (accepted prefix + 1), capped further by what remains and by the
        capacity of the pages the row holds. A cap below a row's acceptance
        stays exact; the dropped suffix is drafted again next round."""
        if not self.active:
            return
        eng = self.eng
        gamma = eng.speculative.gamma
        live = np.zeros((self.bucket,), bool)
        for a in self.active.values():
            live[a.rows] = True
        self.lengths[~live] = 0      # idle rows: writes pinned to page 0
        # best-effort overshoot grants: pages covering slots up to L0 +
        # gamma. A row that gets none still makes progress: its overshoot
        # writes clamp into the garbage page and its commit is capped at the
        # capacity it holds (>= 1: the admission budget covers the next token)
        for a in self.active.values():
            for row in a.rows:
                needed = PG.pages_for(int(self.lengths[row]) + gamma + 1, self.bs)
                held = int(np.count_nonzero(self.table[row]))
                if needed > held:
                    try:
                        extra = self.alloc.alloc(needed - held)
                    except RuntimeError:
                        continue
                    self.table[row, held:held + len(extra)] = extra
                    a.pages.extend(extra)
        if eng.warm:
            self._warm("draft")
            self._warm("verify")
        feed, targ, dt, dt_draft, dt_verify, cold = _spec_dispatch(self)
        for a in list(self.active.values()):
            commit, matched = a.remaining, 0
            for i, row in enumerate(a.rows):
                m = 0
                while m < gamma and feed[row, m + 1] == targ[row, m]:
                    m += 1
                matched += m
                # only positions whose verify K/V landed in held pages have
                # the right logits (garbage-page overshoot attends junk)
                held = int(np.count_nonzero(self.table[row]))
                room = held * self.bs - int(self.lengths[row])
                commit = min(commit, m + 1, room)
                # a rejection at a right logit, of a token the request emits:
                # the generated index where the target's pick beat the draft's
                pick = int(self.lengths[row]) - a.req.prompts.shape[1] + m + 1
                if m < gamma and m < room and pick < a.req.gen_len:
                    a.spec.rejected.append((i, pick))
            assert commit >= 1, "the admission budget must cover the next token"
            a.toks.append(feed[a.rows, :commit])
            for row in a.rows:
                self.cur[row, 0] = targ[row, commit - 1]
                self.lengths[row] += commit
            a.remaining -= commit
            a.decode_s += dt
            a.cold = a.cold or cold
            a.spec.rounds += 1
            a.spec.drafted += gamma * len(a.rows)
            a.spec.matched += matched
            a.spec.committed += commit * len(a.rows)
            a.spec.draft_s += dt_draft
            a.spec.verify_s += dt_verify
            if a.remaining == 0:
                self._retire(a)
        # rewind: pages covering only rejected or overshoot slots go back to
        # the pool, never below the admission budget (which guarantees the
        # next round's commit without allocating under contention)
        for a in self.active.values():
            for row in a.rows:
                keep = max(int(self.lengths[row]), a.base_pages * self.bs)
                PG.rewind_pages(self.table[row], self.alloc, keep, self.bs)
            a.pages = [int(p) for row in a.rows for p in self.table[row] if p != 0]

    def _retire(self, a: _Active) -> None:
        req = a.req
        gen = torch.from_numpy(np.concatenate(a.toks, axis=1))
        out = torch.cat([req.prompts, gen], dim=1).to(self.eng.device)
        b = req.prompts.shape[0]
        spec = a.spec.summary(self.eng.speculative, b) if a.spec.rounds else None
        self.eng._done[req.id] = Result(
            id=req.id, tokens=out, plan_key=self.key, prefill_s=a.prefill_s,
            decode_s=a.decode_s, tok_s=b * req.gen_len / max(a.decode_s, 1e-9), cold=a.cold,
            spec=spec)
        self.alloc.release(a.pages)
        for row in a.rows:
            self.table[row, :] = 0
            self.lengths[row] = 0
            self.free_rows.append(row)
        del self.active[req.id]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP queue 1, item {item})")


class ServingEngine:
    """Plan-keyed batch serving over a trained (params, masks) pair.

    >>> eng = ServingEngine(cfg, params, masks, registry, path="auto")
    >>> rid = eng.submit(prompts, gen_len=16)
    >>> eng.step()
    >>> [res] = eng.retire()

    ``path`` is any ``sparse.plan.PATHS`` entry; ``"auto"`` lets each
    group's batch bucket pick per-stack formats by the cost model
    (``profile`` prices them). Plans are built lazily per ``PlanKey`` at
    the bucket's batch and cached for the engine's lifetime. The engine
    runs on the params' device; it makes one serving copy of the params at
    the compute dtype and shares it across plans.

    ``paged=None`` picks the continuous-batching paged scheduler where the
    config supports it (``model.supports_paged``), else the exact-shape
    slab path. ``block_size`` is the page size in tokens, ``gen_chunk`` the
    decode steps between host syncs (streams join and leave at chunk
    boundaries), and ``warm=True`` captures every new decode graph and runs
    every new prefill signature once outside the timed window.

    ``values_dtype`` ("bf16"/"int8"/"fp8"; None keeps the param dtype) is
    an engine-wide setting, not part of ``PlanKey``: every plan exports its
    value-storing leaves at that width. Masked stacks read the engine's
    params.

    The engine copies ``params`` and ``masks`` at construction and serves
    only its copies; ``refresh`` (a training job's update) and an attached
    sync subscriber write new numbers into them, between chunks.

    ``speculative`` (a ``launch.speculative.SpecConfig``) decodes each
    group in self-draft speculative rounds on the paged scheduler (not on
    the masked path, whose plan has no format to derive a draft from);
    ``draft_tree_for`` and ``spec_estimate_for`` give a key's draft and its
    price, by which ``path="auto"`` may decline unless ``force``.

    ``mesh`` is not ported yet and raises.
    """

    def __init__(self, cfg, params, masks, registry=None, *,
                 path: str = "auto",
                 profile: PLAN.HardwareProfile = PLAN.DEFAULT_PROFILE,
                 mask_versions: dict | None = None,
                 paged: bool | None = None,
                 block_size: int = 16,
                 gen_chunk: int = 16,
                 warm: bool = True,
                 values_dtype: str | None = None,
                 mesh=None,
                 speculative: SP.SpecConfig | None = None):
        if path not in PLAN.PATHS:
            raise ValueError(f"unknown serving path {path!r}; expected one of {PLAN.PATHS}")
        if mesh is not None:
            raise _not_ported("tensor-parallel serving (mesh)", 9)
        if speculative is not None:
            if path == "masked":
                raise ValueError(
                    "speculative decoding needs a format-typed plan to derive the draft "
                    "from; the all-masked path serves raw masks -- pick any other path "
                    "(or 'auto')")
            if paged is False or not M.supports_paged(cfg):
                raise ValueError(
                    "speculative decoding runs on the paged scheduler (draft overshoot "
                    "rollback is a page-table edit); this configuration only supports "
                    "the slab path")
        if paged is None:
            paged = M.supports_paged(cfg)
        elif paged and not M.supports_paged(cfg):
            raise ValueError(
                "paged serving requires a causal architecture without windowed/ring "
                f"caches, M-RoPE or SSM state (family={cfg.family!r}); pass paged=None "
                "to auto-select or paged=False for the slab path")
        if block_size < 1 or gen_chunk < 1:
            raise ValueError("block_size and gen_chunk must be >= 1")
        self.cfg = cfg
        # the engine's own copies: a caller training its tensors in place
        # does not move what the engine serves
        self.params = _owned(params)
        self.masks = _owned(masks or {})
        self.registry = list(REG.build_registry(cfg) if registry is None else registry)
        self.path = path
        self.profile = profile
        self.paged = bool(paged)
        self.block_size = int(block_size)
        self.gen_chunk = int(gen_chunk)
        self.warm = bool(warm)
        self.values_dtype = F.resolve_quantize_spec(values_dtype)
        self.tp = 1
        self.device = params["embed"].device
        self.compute = M.serving_params(cfg, self.params)
        self._graph_pool = _graph_pool(self.device)
        self._mask_versions = (None if mask_versions is None
                               else PLAN._host_versions(mask_versions))
        self._itemsize = getattr(torch, cfg.param_dtype).itemsize
        self._stats: dict | None = None
        self._plans: dict[PlanKey, PLAN.Plan] = {}
        # self-draft speculative decoding: draft trees derived lazily per plan
        # key (with their kind reports and prices), dropped whenever refresh
        # or a sync drain moves what the target leaves hold
        self.speculative = speculative
        self._draft_trees: dict[PlanKey, dict | None] = {}
        self._stale_drafts: dict[PlanKey, dict] = {}
        self._draft_reports: dict[PlanKey, dict[str, str]] = {}
        self._spec_estimates: dict[PlanKey, PLAN.SpecEstimate] = {}
        self._runners: dict[PlanKey, _PagedRunner] = {}
        self._legacy_decoders: dict[PlanKey, dict] = {}
        # signatures run so far: "decode", "draft" and "verify" count
        # captured graphs (step functions made, on the CPU), "prefill" the
        # prefill shapes
        self._programs: dict[str, set] = {"prefill": set(), "decode": set(), "draft": set(),
                                          "verify": set()}
        self._captures = 0              # paged steps made (graphs captured on the card)
        self._pending: list[Request] = []
        self._done: dict[int, Result] = {}
        self._next_id = 0
        # live train-to-serve sync: a subscriber drained at chunk boundaries
        self._subscriber = None
        self._sync_generation: int | None = None
        self._sync_donate = True
        self.last_drain_s = 0.0         # host seconds of the last drain that applied

    # -- stats / keys -------------------------------------------------------

    def stats(self) -> dict:
        """Realized per-stack export stats (one host sync, cached)."""
        if self._stats is None:
            self._stats = COND.export_stats(self.registry, self.masks)
        return self._stats

    def plan_key(self, batch_size: int) -> PlanKey:
        """The key a request of ``batch_size`` streams groups under: its
        batch bucket x the per-stack format signature at that bucket."""
        bucket = PLAN.batch_bucket(max(int(batch_size), 1))
        if self.path != "auto":
            sig = tuple((s.name, self.path) for s in self.registry)
            return PlanKey(batch_bucket=bucket, formats=sig, tp=self.tp)
        stats = self.stats()
        sig = tuple(
            (s.name, PLAN.select_representation(
                s, batch_size=bucket, itemsize=self._itemsize, stats=stats[s.name],
                profile=self.profile, values_dtype=self.values_dtype).representation)
            for s in self.registry)
        return PlanKey(batch_bucket=bucket, formats=sig, tp=self.tp)

    def plan_for(self, key: PlanKey) -> PLAN.Plan:
        """The (lazily built, cached) execution plan serving ``key``."""
        plan = self._plans.get(key)
        if plan is None:
            plan = PLAN.build_plan(self.cfg, self.registry, self.params, self.masks,
                                   batch_size=key.batch_bucket, path=self.path,
                                   mask_versions=self._mask_versions,
                                   profile=self.profile, values_dtype=self.values_dtype)
            if self._subscriber is not None and self._subscriber.generation is not None:
                # sync rewrites stack leaves in existing plans only, so the
                # engine's params may lag the stream: bring the new plan to
                # the subscribed generation
                self._apply_sync_to_plan(plan, self._subscriber, force=True)
            self._plans[key] = plan
        return plan

    def serving_tree_for(self, key: PlanKey):
        """The masks-slot tree a group executes with; the masked path serves
        the training-layout masks themselves."""
        if self.path == "masked":
            return self.masks
        return self.plan_for(key).serving_tree

    def draft_tree_for(self, key: PlanKey):
        """The (lazily derived, cached) draft serving tree for ``key``: the
        target plan at ``speculative.draft_ablation`` extra neuron ablation,
        sharing every value tensor with the target (asserted: no extra
        weight bytes). None when speculation is off, or when ``path="auto"``
        pricing declines it for this key and ``force`` is unset; a fixed
        path runs what it was told."""
        if self.speculative is None:
            return None
        if key in self._draft_trees:
            return self._draft_trees[key]
        sc = self.speculative
        plan = self.plan_for(key)
        tree, report = PLAN.derive_draft_tree(self.registry, plan.serving_tree, self.params,
                                              self.masks, sc.draft_ablation)
        tree = _adopt_draft(self._stale_drafts.pop(key, None), tree, plan.serving_tree,
                            self.registry)
        _, extra = PLAN.draft_weight_overhead_bytes(self.registry, plan.serving_tree, tree)
        assert extra == 0, (f"draft tree allocated {extra} value bytes; self-drafting must "
                            f"share the target's weight residency ({report})")
        est = PLAN.price_speculation(self.registry, plan.serving_tree, tree,
                                     batch_size=key.batch_bucket, gamma=sc.gamma,
                                     acceptance=sc.acceptance, profile=self.profile)
        self._spec_estimates[key] = est
        self._draft_reports[key] = report
        if self.path == "auto" and not sc.force and not est.worthwhile:
            tree = None         # declined: plain decode is priced faster at this bucket
        self._draft_trees[key] = tree
        return tree

    def spec_estimate_for(self, key: PlanKey) -> PLAN.SpecEstimate | None:
        """The price behind ``draft_tree_for``'s run or decline (None when
        speculation is off)."""
        self.draft_tree_for(key)
        return self._spec_estimates.get(key)

    def _drop_drafts(self) -> None:
        """Derive each draft anew at its next use (a refresh or a sync drain
        moved the saliency its rows were chosen by); the old trees are kept
        to be written in place (``_adopt_draft``)."""
        self._stale_drafts.update((k, t) for k, t in self._draft_trees.items() if t is not None)
        self._draft_trees.clear()
        self._draft_reports.clear()
        self._spec_estimates.clear()

    def program_count(self, kind: str) -> int:
        """Signatures run so far: ``"decode"``, ``"draft"`` and ``"verify"``
        graphs (the pool's and tables' shapes and the serving tensors'
        shapes, as the reference's jit cache keys them; the draft and verify
        also gamma), ``"prefill"`` prefill shapes. The
        counterpart of the reference's jit cache sizes. A graph recaptured
        at an unchanged signature (new storage, same shapes) is counted by
        ``captures``, not here."""
        return len(self._programs[kind])

    @property
    def captures(self) -> int:
        """Paged decode, draft and verify steps made so far: graphs captured
        on the card, step functions on the CPU, recaptures included."""
        return self._captures

    # -- request lifecycle --------------------------------------------------

    def submit(self, prompts, gen_len: int) -> int:
        """Queue a request: ``prompts`` (B, T) integer token ids in
        ``[0, vocab_size)``, decode ``gen_len`` greedy tokens per stream.
        Validated and cast to int32 here, so a malformed request fails with
        a readable error rather than as a device gather of garbage rows.
        Returns the request id. The audio family is refused
        (``refuse_audio``)."""
        refuse_audio(self.cfg)
        prompts = torch.as_tensor(prompts)
        if prompts.ndim != 2 or 0 in prompts.shape:
            raise ValueError(f"prompts must be (batch, prompt_len) with both dims >= 1; "
                             f"got shape {tuple(prompts.shape)}")
        if (prompts.dtype.is_floating_point or prompts.dtype.is_complex
                or prompts.dtype == torch.bool):
            raise ValueError(f"prompts must be integer token ids, got dtype {prompts.dtype}; "
                             "cast explicitly if these are token ids")
        if gen_len < 1:
            raise ValueError("gen_len must be >= 1")
        lo, hi = int(prompts.min()), int(prompts.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            raise ValueError(f"token ids out of range: prompts span [{lo}, {hi}] but "
                             f"vocab_size is {self.cfg.vocab_size}")
        rid = self._next_id
        self._next_id += 1
        self._pending.append(Request(id=rid, prompts=prompts.to("cpu", torch.int32),
                                     gen_len=int(gen_len)))
        return rid

    def pending_groups(self) -> dict[PlanKey, list[int]]:
        """Predicted grouping of the pending requests (no execution)."""
        groups: dict[PlanKey, list[int]] = {}
        for req in self._pending:
            groups.setdefault(self.plan_key(req.prompts.shape[0]), []).append(req.id)
        return groups

    def step(self, quiet: bool = True, max_chunks: int | None = None) -> list[GroupReport]:
        """Advance serving, one plan-key group at a time.

        Paged (default where supported): each group's runner loops
        admit-then-decode: pending requests join free bucket rows at chunk
        boundaries (one bucket-padded prefill per admission wave) and each
        iteration decodes one adaptive chunk, retiring streams as they
        finish. ``max_chunks=None`` drains the group; an event loop passes
        ``max_chunks=1`` to interleave admission with arrival. Results land
        in the retire queue.

        Slab path (``paged=False``): requests sharing (prompt_len, gen_len)
        fuse into exact-shape slabs, split so none exceeds the bucket.

        An attached subscriber is drained here and at every chunk boundary,
        never during a chunk: each chunk runs against one generation.
        """
        self._drain_sync()          # an idle engine still follows the stream
        if not self.paged:
            return self._step_legacy(quiet)

        groups: dict[PlanKey, list[Request]] = {}
        for req in self._pending:
            groups.setdefault(self.plan_key(req.prompts.shape[0]), []).append(req)
        keys = list(groups)
        for key, runner in self._runners.items():
            if key not in groups and runner.active:
                keys.append(key)        # drain groups with no new arrivals

        reports = []
        for key in keys:
            runner = self._runners.get(key)
            if runner is None:
                runner = self._runners[key] = _PagedRunner(self, key)
            admitted_ids: list[int] = []
            n_prefills = total_b = chunks = 0
            while True:
                if chunks:
                    self._drain_sync()  # a chunk boundary
                # requests leave the pending queue only once their prefill
                # has run: an exception mid-step must not drop queued work
                pend = [r for r in self._pending
                        if self.plan_key(r.prompts.shape[0]) == key]
                if pend and runner.free_rows:
                    admitted = runner.admit(pend)
                    if admitted:
                        served = {r.id for r in admitted}
                        self._pending = [r for r in self._pending if r.id not in served]
                        admitted_ids.extend(sorted(served))
                        n_prefills += 1
                        total_b += sum(r.prompts.shape[0] for r in admitted)
                        if not quiet:
                            print(f"[engine] group {key.describe()}: admitted "
                                  f"{len(admitted)} request(s) ({total_b} stream(s)) into "
                                  f"bucket {runner.bucket}")
                if not runner.active:
                    break
                if self.speculative is not None and self.draft_tree_for(key) is not None:
                    runner.spec_round()
                else:
                    runner.decode_chunk()
                chunks += 1
                if max_chunks is not None and chunks >= max_chunks:
                    break
            reports.append(GroupReport(key=key, request_ids=tuple(admitted_ids),
                                       n_slabs=n_prefills, total_batch=total_b))
        return reports

    def _step_legacy(self, quiet: bool = True) -> list[GroupReport]:
        """Exact-shape slab serving through ``generate``'s contiguous cache.

        Within a group, requests sharing (prompt_len, gen_len) fuse into
        batch slabs, each split at the plan's bucket boundary: the plan is
        priced at ``key.batch_bucket``, so a slab must never exceed it.
        """
        groups: dict[PlanKey, list[Request]] = {}
        for req in self._pending:
            groups.setdefault(self.plan_key(req.prompts.shape[0]), []).append(req)

        reports = []
        for key, reqs in groups.items():
            # requests stay pending until their slab has run: an exception
            # mid-step must not drop queued work
            tree = self.serving_tree_for(key)
            decoders = self._legacy_decoders.setdefault(key, {})
            slabs: dict[tuple[int, int], list[Request]] = {}
            for req in reqs:
                slabs.setdefault((req.prompts.shape[1], req.gen_len), []).append(req)
            n_dispatch = 0
            for (t, gen_len), slab in slabs.items():
                parts: list[list[Request]] = []
                cur_part: list[Request] = []
                cur_b = 0
                for r in slab:
                    rb = r.prompts.shape[0]
                    if cur_part and cur_b + rb > key.batch_bucket:
                        parts.append(cur_part)
                        cur_part, cur_b = [], 0
                    cur_part.append(r)
                    cur_b += rb
                parts.append(cur_part)
                for part in parts:
                    prompts = torch.cat([r.prompts for r in part], dim=0).to(self.device)
                    b = prompts.shape[0]
                    made = {k: id(d) for k, d in decoders.items()}
                    out, prefill_s, decode_s, tok_s = _timed_serve(
                        self.cfg, self.compute, tree, prompts, gen_len, decoders=decoders,
                        pool=self._graph_pool)
                    cold = {k: id(d) for k, d in decoders.items()} != made
                    n_dispatch += 1
                    row = 0
                    for r in part:
                        rb = r.prompts.shape[0]
                        self._done[r.id] = Result(
                            id=r.id, tokens=out[row:row + rb], plan_key=key,
                            prefill_s=prefill_s, decode_s=decode_s, tok_s=tok_s, cold=cold)
                        row += rb
                    served = {r.id for r in part}
                    self._pending = [r for r in self._pending if r.id not in served]
                    if not quiet:
                        print(f"[engine] group {key.describe()}: {len(part)} request(s) "
                              f"fused at {b}x{t}+{gen_len} ({tok_s:.1f} tok/s)")
            reports.append(GroupReport(
                key=key, request_ids=tuple(r.id for r in reqs), n_slabs=n_dispatch,
                total_batch=sum(r.prompts.shape[0] for r in reqs)))
        return reports

    def retire(self, request_id: int | None = None) -> list[Result]:
        """Pop finished results (all of them, or one id). Unfinished ids are
        not returned: call ``step()`` first."""
        if request_id is not None:
            res = self._done.pop(request_id, None)
            return [res] if res is not None else []
        out = [self._done[k] for k in sorted(self._done)]
        self._done.clear()
        return out

    # -- live-training coherence ---------------------------------------------

    @torch.no_grad()
    def refresh(self, params, masks, mask_versions, *,
                donate: bool = True) -> dict[PlanKey, list[str]]:
        """Bring the engine to a training job's new (params, masks, versions),
        between chunks, on the current stream (so after every replay already
        issued and before the next).

        The new params are written into the engine's own copy and its
        serving copy at the compute dtype (embeddings, norms and dense
        layers included), the new masks into the engine's masks, and every
        cached plan is refreshed (``Plan.refresh``: only stacks whose
        version moved re-export, the other condensed-family stacks regather
        their values) through one shared ``export_cache``, so a stack used
        by several plan keys exports once. With ``donate`` every same-shape
        leaf keeps its tensors and no graph is recaptured; a changed shape
        (or ``donate=False``) rebuilds the leaf, and the graphs that read it
        are recaptured at their next chunk. The versions are fetched once;
        the engine keeps them as host ints. Returns each plan key's
        re-exported stack names. A stack with two leading axes (gemma3's
        ``g_local`` (g, r), an MoE expert stack (L, E)) is written one slab
        of its first axis at a time, as any other."""
        versions = PLAN._host_versions(mask_versions)
        # a cached draft's out_index follows the old saliency: derive anew
        self._drop_drafts()
        _copy_into(self.params, params)
        _recast_into(self.compute, self.params)
        _copy_into(self.masks, masks or {})
        self._stats = None
        self._mask_versions = versions
        cache: dict = {}
        return {key: plan.refresh(self.params, self.masks, versions, donate=donate,
                                  export_cache=cache)
                for key, plan in self._plans.items()}

    # -- streamed sync (repro_torch.sync subscriber) --------------------------

    def attach_subscriber(self, subscriber, *, donate: bool = True) -> None:
        """Attach a ``repro_torch.sync.Subscriber``: its generations are
        drained at the top of ``step`` and at every chunk boundary and
        written into the engine's leaves and params in place.

        Only the condensed-family fixed paths can subscribe: ``masked``,
        ``structured`` and ``auto`` plans read the params at execution time,
        which a stream of exported leaves does not carry. ``donate=False``
        rebuilds every adopted tensor instead (its graphs recapture)."""
        if self.path not in ("condensed", "condensed_over_active"):
            raise ValueError(f"attach_subscriber requires a condensed-family path; "
                             f"path={self.path!r} reads the params at execution time")
        if subscriber.generation is not None:
            self._check_sync_meta(subscriber.meta)
            # the engine is built from the subscriber's current state: the
            # first drain applies only the generations after it
            subscriber.consume_changes()
        self._subscriber = subscriber
        self._sync_donate = bool(donate)
        self._sync_generation = subscriber.generation

    def _check_sync_meta(self, meta: dict) -> None:
        if int(meta.get("tp", 1)) != self.tp:
            raise ValueError(f"sync stream tp={meta.get('tp')} is not served by this port "
                             "yet (tensor-parallel serving is ROADMAP queue 1, item 9)")
        for field, mine in (("path", self.path), ("values_dtype", self.values_dtype)):
            theirs = meta.get(field, mine)
            if theirs != mine:
                raise ValueError(f"sync stream {field}={theirs!r} does not match engine "
                                 f"{field}={mine!r}; rebuild the engine to match the "
                                 "published layout")

    @torch.no_grad()
    def _drain_sync(self) -> bool:
        """Poll the attached subscriber and apply the generations committed
        since the last drain. Runs between chunks only. Returns whether
        anything moved; ``last_drain_s`` keeps the host seconds of an
        applying drain (poll, decode and the copies, synchronised)."""
        sub = self._subscriber
        if sub is None:
            return False
        t0 = time.perf_counter()
        sub.poll()
        if sub.generation is None or sub.generation == self._sync_generation:
            return False
        self._check_sync_meta(sub.meta)
        self._drop_drafts()
        changes = sub.consume_changes()
        if changes["snapshot"]:
            _copy_into(self.masks, sub.masks_tree())
        self._apply_sync_params(sub, changes)
        for plan in self._plans.values():
            self._apply_sync_to_plan(plan, sub, changes=changes)
        self._mask_versions = dict(sub.mask_versions)
        self._stats = None
        self._sync_generation = sub.generation
        _sync(self.params["embed"])
        self.last_drain_s = time.perf_counter() - t0
        return True

    def _apply_sync_params(self, sub, changes: dict) -> None:
        """Adopt the changed dense (non-stack) params, and their serving
        copies: embeddings and norms train between topology updates too."""
        paths = set(sub.params) if changes["snapshot"] else changes["dense"]
        stack_names = {s.name for s in self.registry}
        for path in sorted(paths):
            if path in stack_names:
                continue
            parts = tuple(path.split("/"))
            old = REG.get_path(self.params, parts)
            old_c = REG.get_path(self.compute, parts)
            new = F.adopt_array(sub.params[path], old, donate=self._sync_donate,
                                device=self.device)
            REG.set_path(self.params, parts, new)
            if old_c is old:
                REG.set_path(self.compute, parts, new)
            else:
                REG.set_path(self.compute, parts,
                             F.adopt_array(new.to(old_c.dtype), old_c,
                                           donate=self._sync_donate))

    def _leaf_from_wire(self, rec):
        """A format leaf on the engine's device from a topology record."""
        from repro_torch.sync import delta as D
        return D.wire_to_leaf(rec, device=self.device)

    def _apply_sync_to_plan(self, plan, sub, *, changes: dict | None = None,
                            force: bool = False) -> None:
        """Adopt the subscriber's merged per-stack records into one plan.

        Same layout (class, statics, per-field shapes and dtypes): the
        changed fields are written into the leaf's tensors (``adopt_arrays``),
        so no graph over the plan is recaptured. A layout change (k or the
        active-row count moved) rebuilds the leaf, and the graphs that read
        it are recaptured. ``force`` adopts every stack (a plan just built
        from the engine's possibly older params)."""
        pending = (changes or {}).get("stacks", {})
        snapshot = bool((changes or {}).get("snapshot"))
        by_name = {s.name: s for s in self.registry}
        for name, rec in sub.leaves.items():
            s = by_name.get(name)
            if s is None:
                continue
            fields = pending.get(name, set())
            if not (force or snapshot or fields):
                continue
            old = REG.get_path(plan.serving_tree, s.path)
            cls = F.FORMATS[rec.format]
            same_layout = (
                type(old) is cls
                and all(getattr(old, f) == rec.static.get(f) for f in cls._static_fields)
                and all((getattr(old, f) is None) == (f not in rec.arrays)
                        and (f not in rec.arrays
                             or (tuple(getattr(old, f).shape) == tuple(rec.arrays[f].shape)
                                 and getattr(old, f).dtype == rec.arrays[f].dtype))
                        for f in cls._array_fields))
            version_moved = rec.mask_version != plan.mask_versions.get(name)
            topology = force or snapshot or "__topology__" in fields
            if same_layout:
                new_fields = {f: rec.arrays[f]
                              for f in (rec.arrays if topology else fields & set(rec.arrays))}
                if not new_fields:
                    continue
                leaf = old.adopt_arrays(new_fields, donate=self._sync_donate)
            else:
                leaf = self._leaf_from_wire(rec)
            REG.set_path(plan.serving_tree, s.path, leaf)
            if not same_layout or version_moved or topology:
                plan.export_calls += 1
                dec = plan.decisions[name]
                plan.decisions[name] = dataclasses.replace(
                    dec, representation=rec.format, stats=COND.stats_from_leaf(leaf))
            else:
                plan.value_refreshes += 1
            plan.mask_versions[name] = rec.mask_version

    # -- calibration --------------------------------------------------------

    def autotune(self, batch_size: int, *, dtype: torch.dtype | None = None,
                 reps: int = 3) -> dict[str, AT.TuneResult]:
        """Run the launch-configuration search (``autotune.tune_registry``)
        for every launch this engine's stacks make at ``batch_size``'s
        bucket, under the keys the formats' ``spec_tuning_key`` give, which
        are what the kernel wrappers read (``kernels.ops``). Tunes at the
        serving dtype (``cfg.dtype``: an f32 entry is never read by a bf16
        serving run) and at the engine's ``values_dtype``, on the engine's
        device. A decode graph captured before this call keeps the launch
        it captured; later captures read the new entries. An MoE expert
        stack is tuned under the reference's key (one expert's shape at the
        bucket) on the expert-grouped launch over its E experts; its
        wrapper reads that key at its own rows an expert
        (``kernels.ops.condensed_linear_grouped``)."""
        dtype = getattr(torch, self.cfg.dtype) if dtype is None else dtype
        return AT.tune_registry(self.registry, self.stats(), batch=batch_size, dtype=dtype,
                                reps=reps, device=self.device, values_dtype=self.values_dtype,
                                tp=self.tp, cfg=self.cfg)


# ---------------------------------------------------------------------------
# grouping without allocation (the dry run's)
# ---------------------------------------------------------------------------


def abstract_plan_key(cfg, registry, batch_size: int, *, path: str = "auto",
                      profile: PLAN.HardwareProfile = PLAN.DEFAULT_PROFILE
                      ) -> tuple[PlanKey, dict[str, str]]:
    """The plan key a request of ``batch_size`` streams would group under,
    from static information alone (target densities, no realized mask), and
    its per-stack representations for ``plan.abstract_serving_tree``: the
    engine's grouping without a model."""
    if path not in PLAN.PATHS:
        raise ValueError(f"unknown serving path {path!r}; expected one of {PLAN.PATHS}")
    bucket = PLAN.batch_bucket(max(int(batch_size), 1))
    if path != "auto":
        reps = {s.name: path for s in registry}
    else:
        reps = PLAN.plan_for_shape(cfg, registry, batch_size=bucket, profile=profile)
    key = PlanKey(batch_bucket=bucket, formats=tuple((s.name, reps[s.name]) for s in registry))
    return key, reps
