"""Trainer-side diff engine: TrainState -> versioned Delta/Snapshot records
(port of ``repro/sync/publisher.py``).

The publisher owns one ``sparse.plan.Plan`` built at ``batch_size`` with the
serving ``path``/``values_dtype`` the fleet runs. Each ``publish(state)``:

1. reads the per-stack ``mask_versions`` counters (one host fetch),
2. runs ``Plan.refresh`` in place: only stacks whose version moved are
   re-condensed, the rest get a values-only regather (the exported
   condensed leaves are the wire payload; there is no second export path),
3. sends a ``Delta``: topology records for the moved stacks, values-only
   records for the rest, and the dense (non-stack) params,
4. answers any queued resync requests with a full ``Snapshot``.

Only the condensed family (``condensed`` / ``condensed_over_active``) can be
published: ``masked`` and float ``structured`` leaves read the live training
weights at execution time, which a stream of exported arrays cannot carry.
A ``Publisher`` is also the port's ``Trainer(publisher=...)`` hook: calling
it publishes the state.
"""
from __future__ import annotations

import dataclasses
import logging
import time

from repro_torch.sparse import plan as PLAN
from repro_torch.sparse import registry as REG
from repro_torch.sync import delta as D

log = logging.getLogger(__name__)

PUBLISHABLE_PATHS = ("condensed", "condensed_over_active")


def _record_bytes(rec: D.StackDelta) -> int:
    return sum(a.numel() * a.element_size() for a in rec.arrays.values())


def _nbytes(arrays: dict) -> int:
    return sum(a.numel() * a.element_size() for a in arrays.values())


@dataclasses.dataclass
class Publisher:
    """Publishes one stream of generations onto a channel.

    ``generation`` starts at 0 (nothing published); the first ``publish``
    sends generation 1 as a full ``Snapshot`` so subscribers can bootstrap,
    every later one a ``Delta``. ``tp`` must be 1 (tensor-parallel layouts
    are ROADMAP queue 1, item 9).
    """

    cfg: object
    registry: list
    channel: object
    path: str = "condensed"
    values_dtype: str | None = None
    tp: int = 1
    profile: object = None
    batch_size: int = 1
    arch: str | None = None

    generation: int = dataclasses.field(default=0, init=False)
    last_info: dict = dataclasses.field(default_factory=dict, init=False)
    counters: dict = dataclasses.field(
        default_factory=lambda: {"resync_requests": 0, "resync_snapshots": 0,
                                 "resync_coalesced": 0}, init=False)
    _plan: object = dataclasses.field(default=None, init=False)
    _params: object = dataclasses.field(default=None, init=False)
    _masks: object = dataclasses.field(default=None, init=False)
    _resync_snapshot_gen: int | None = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        if self.path not in PUBLISHABLE_PATHS:
            raise ValueError(f"publisher path must be one of {PUBLISHABLE_PATHS}; "
                             f"{self.path!r} leaves read live training weights at "
                             f"execution time and cannot be streamed")
        if int(self.tp) != 1:
            raise ValueError(f"tp={self.tp}: tensor-parallel publishing is not ported yet "
                             "(ROADMAP queue 1, item 9)")
        if self.profile is None:
            self.profile = PLAN.DEFAULT_PROFILE

    # -- public API ---------------------------------------------------------

    def __call__(self, state) -> dict:
        """The ``Trainer(publisher=...)`` hook: publish ``state``."""
        return self.publish(state)

    def publish(self, state=None, *, params=None, masks=None, mask_versions=None) -> dict:
        """Diff against the last published generation and send one record.

        Takes a ``TrainState`` or explicit ``params``/``masks``/
        ``mask_versions``. Returns an info dict (kind, generation, byte
        accounting, ``encode_s`` the host seconds of the encode), also kept
        as ``self.last_info``.
        """
        if state is not None:
            params, masks, mask_versions = state.params, state.masks, state.mask_versions
        if params is None or masks is None or mask_versions is None:
            raise ValueError("publish needs a TrainState or explicit "
                             "params/masks/mask_versions")
        versions = PLAN._host_versions(mask_versions)
        self._params, self._masks = params, masks
        if self._plan is None:
            self._plan = PLAN.build_plan(self.cfg, self.registry, params, masks,
                                         batch_size=self.batch_size, path=self.path,
                                         mask_versions=versions, profile=self.profile,
                                         values_dtype=self.values_dtype)
            self.generation = 1
            info = self._send_snapshot()
        else:
            changed = set(self._plan.refresh(params, masks, versions))
            self.generation += 1
            info = self._send_delta(changed, versions, params)
        self.serve_resyncs()
        self.last_info = info
        return info

    def serve_resyncs(self) -> int:
        """Answer queued resync requests with one full Snapshot at the
        current generation, coalescing a storm: the requests drained in one
        poll share one snapshot, and requests whose missing generation a
        snapshot already on the channel covers trigger none. Counters:
        ``resync_requests`` (drained), ``resync_snapshots`` (published),
        ``resync_coalesced`` (answered without a fresh publish)."""
        requests = self.channel.poll_requests()
        if not requests or self._plan is None:
            return 0
        self.counters["resync_requests"] += len(requests)
        covered = self._resync_snapshot_gen
        if covered is not None and all(
                r.get("needed_generation") is not None and r["needed_generation"] <= covered
                for r in requests):
            self.counters["resync_coalesced"] += len(requests)
            log.info("sync: resync storm from %s coalesced onto snapshot gen %d already "
                     "on channel", [r.get("subscriber") for r in requests], covered)
            return len(requests)
        log.info("sync: resync requested by %s -> snapshot gen %d",
                 [r.get("subscriber") for r in requests], self.generation)
        self._send_snapshot()
        self.counters["resync_snapshots"] += 1
        self.counters["resync_coalesced"] += len(requests) - 1
        return len(requests)

    # -- record assembly ----------------------------------------------------

    def _stack_leaves(self) -> dict:
        return {s.name: REG.get_path(self._plan.serving_tree, s.path) for s in self.registry}

    def _send_snapshot(self) -> dict:
        versions = {k: int(v) for k, v in self._plan.mask_versions.items()}
        stacks = [D.leaf_to_wire(name, versions[name], leaf)
                  for name, leaf in self._stack_leaves().items()]
        meta = {"path": self.path, "values_dtype": self.values_dtype, "tp": self.tp}
        if self.arch is not None:
            meta["arch"] = self.arch
        snap = D.Snapshot(generation=self.generation, meta=meta, mask_versions=versions,
                          stacks=stacks,
                          params={k: D.to_host(v) for k, v in
                                  D.flatten_tree(self._params).items()},
                          masks={k: D.to_host(v) for k, v in
                                 D.flatten_tree(self._masks).items()})
        t0 = time.perf_counter()
        blob = D.encode(snap)
        encode_s = time.perf_counter() - t0
        self.channel.send(blob, kind="snapshot", generation=self.generation)
        self._resync_snapshot_gen = self.generation
        return {"kind": "snapshot", "generation": self.generation, "bytes": len(blob),
                "encode_s": encode_s,
                "topology": sorted(versions), "values_only": [],
                "topology_bytes": sum(_record_bytes(r) for r in stacks), "values_bytes": 0,
                "dense_bytes": _nbytes(snap.params)}

    def _send_delta(self, changed: set, versions: dict, params) -> dict:
        stack_names = {s.name for s in self.registry}
        dense = {k: D.to_host(v) for k, v in D.flatten_tree(params).items()
                 if k not in stack_names}
        stacks, topo_b, val_b = [], 0, 0
        for name, leaf in self._stack_leaves().items():
            mode = "topology" if name in changed else "values"
            rec = D.leaf_to_wire(name, versions[name], leaf, mode=mode)
            stacks.append(rec)
            if mode == "topology":
                topo_b += _record_bytes(rec)
            else:
                val_b += _record_bytes(rec)
        t0 = time.perf_counter()
        blob = D.encode(D.Delta(generation=self.generation, stacks=stacks, dense=dense))
        encode_s = time.perf_counter() - t0
        self.channel.send(blob, kind="delta", generation=self.generation)
        return {"kind": "delta", "generation": self.generation, "bytes": len(blob),
                "encode_s": encode_s,
                "topology": sorted(changed), "values_only": sorted(stack_names - changed),
                "topology_bytes": topo_b, "values_bytes": val_b,
                "dense_bytes": _nbytes(dense)}
