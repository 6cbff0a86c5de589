"""Replica-side generation handshake: adversarial streams -> coherent state
(port of ``repro/sync/subscriber.py``).

The subscriber owns the robustness story of the protocol. It keeps a single
monotonically increasing ``generation`` and per-stack ``mask_versions``, and
enforces:

- **bootstrap**: nothing applies before a ``Snapshot`` (deltas seen first
  trigger a resync request instead of a partial state);
- **stale/duplicate**: records at ``generation <= current`` are counted and
  dropped;
- **reorder**: future deltas buffer until the chain ``current+1, +2, ...``
  is contiguous, then drain in order;
- **gap**: a missing generation (buffered deltas strictly ahead of
  ``current+1``) requests a full-snapshot resync -- at most one outstanding
  request per missing generation, so a polling loop does not spam the
  publisher;
- **all-or-nothing commit**: a delta is validated completely (stack-name
  set, per-stack version monotonicity, values-merge shape compatibility)
  BEFORE anything mutates; a failed record is counted ``rejected``, triggers
  a resync, and leaves every stack exactly as it was. A replica's stacks are
  never mutually incoherent.

State is host-side (CPU tensors); ``consume_changes()`` hands the engine
the set of stacks/dense paths touched since it last drained, so the
engine's in-place apply only walks what moved.
"""
from __future__ import annotations

import time

import torch

from repro_torch.sync import delta as D


class SyncProtocolError(RuntimeError):
    """A record that decoded fine but cannot be applied coherently."""


_COUNTER_KEYS = ("received", "applied_deltas", "applied_snapshots", "stale",
                 "duplicate", "corrupt", "rejected", "gaps", "resyncs",
                 "bytes_deltas", "bytes_snapshots")


class Subscriber:
    """Tails one channel subscription and converges on the publisher."""

    def __init__(self, subscription, name: str = "replica"):
        self.subscription = subscription
        self.name = name
        self.generation: int | None = None     # None until bootstrap
        self.meta: dict = {}
        self.mask_versions: dict[str, int] = {}
        self.leaves: dict[str, D.StackDelta] = {}   # merged topology records
        self.params: dict[str, torch.Tensor] = {}   # flattened host tree
        self.masks: dict[str, torch.Tensor] = {}
        self.counters: dict[str, int] = {k: 0 for k in _COUNTER_KEYS}
        self._buffer: dict[int, D.Delta] = {}
        self._resync_requested_for: set[int] = set()
        # change tracking for consume_changes()
        self._pending_stacks: dict[str, set[str]] = {}
        self._pending_dense: set[str] = set()
        self._pending_snapshot = False

    # -- polling ------------------------------------------------------------

    def poll(self) -> int:
        """Drain the subscription, apply what is coherent. Returns how many
        records were applied (deltas + snapshots)."""
        applied = 0
        for blob in self.subscription.recv_new():
            if not blob:            # pruned/blank entry
                continue
            self.counters["received"] += 1
            try:
                rec = D.decode(blob)
            except D.DeltaCorruptError:
                self.counters["corrupt"] += 1
                continue
            if rec.kind == "snapshot":
                applied += self._offer_snapshot(rec, len(blob))
            else:
                self._offer_delta(rec, len(blob))
        applied += self._drain_buffer()
        self._maybe_request_resync()
        return applied

    def _offer_snapshot(self, snap: D.Snapshot, nbytes: int) -> int:
        if self.generation is not None and snap.generation <= self.generation:
            self.counters["stale"] += 1
            return 0
        self._apply_snapshot(snap)
        self.counters["applied_snapshots"] += 1
        self.counters["bytes_snapshots"] += nbytes
        # buffered deltas at or below the snapshot are subsumed
        self._buffer = {g: d for g, d in self._buffer.items()
                        if g > snap.generation}
        self._resync_requested_for.clear()
        return 1

    def _offer_delta(self, delta: D.Delta, nbytes: int) -> None:
        gen = delta.generation
        if self.generation is not None and gen <= self.generation:
            self.counters["stale" if gen < self.generation
                          else "duplicate"] += 1
            return
        if gen in self._buffer:
            self.counters["duplicate"] += 1
            return
        self._buffer[gen] = delta
        self.counters["bytes_deltas"] += nbytes

    def _drain_buffer(self) -> int:
        applied = 0
        while (self.generation is not None
               and (self.generation + 1) in self._buffer):
            delta = self._buffer.pop(self.generation + 1)
            try:
                self._apply_delta(delta)
            except SyncProtocolError:
                self.counters["rejected"] += 1
                # incoherent record: nothing was mutated; fall back to resync
                self._request_resync(delta.generation,
                                     reason="rejected delta")
                break
            applied += 1
            self.counters["applied_deltas"] += 1
        return applied

    def _maybe_request_resync(self) -> None:
        if not self._buffer:
            return
        if self.generation is None:
            # deltas but no bootstrap yet
            self._request_resync(min(self._buffer), reason="no snapshot")
            return
        need = self.generation + 1
        if min(self._buffer) > need:
            self.counters["gaps"] += 1
            self._request_resync(need, reason=f"gap at generation {need}")

    def _request_resync(self, needed_gen: int, *, reason: str) -> None:
        if needed_gen in self._resync_requested_for:
            return
        self._resync_requested_for.add(needed_gen)
        self.counters["resyncs"] += 1
        self.subscription.request_resync(
            f"{reason} (subscriber={self.name})",
            needed_generation=needed_gen)

    # -- application (all-or-nothing) ---------------------------------------

    def _apply_snapshot(self, snap: D.Snapshot) -> None:
        self.meta = dict(snap.meta)
        self.mask_versions = dict(snap.mask_versions)
        self.leaves = {rec.name: rec for rec in snap.stacks}
        self.params = dict(snap.params)
        self.masks = dict(snap.masks)
        self.generation = snap.generation
        self._pending_snapshot = True
        self._pending_stacks = {name: set(rec.arrays)
                                for name, rec in self.leaves.items()}
        self._pending_dense = set(self.params)

    def _validate_delta(self, delta: D.Delta) -> None:
        names = {rec.name for rec in delta.stacks}
        if names != set(self.leaves):
            raise SyncProtocolError(
                f"delta gen {delta.generation} covers stacks "
                f"{sorted(names)} but replica holds {sorted(self.leaves)}")
        for rec in delta.stacks:
            cur_v = self.mask_versions[rec.name]
            if rec.mode == "topology":
                if rec.mask_version < cur_v:
                    raise SyncProtocolError(
                        f"{rec.name}: topology mask_version "
                        f"{rec.mask_version} < current {cur_v}")
            elif rec.mode == "values":
                if rec.mask_version != cur_v:
                    raise SyncProtocolError(
                        f"{rec.name}: values-only record at mask_version "
                        f"{rec.mask_version} but replica is at {cur_v}")
                stored = self.leaves[rec.name]
                for field, arr in rec.arrays.items():
                    old = stored.arrays.get(field)
                    if old is None or old.shape != arr.shape:
                        raise SyncProtocolError(
                            f"{rec.name}.{field}: values merge shape "
                            f"mismatch ({None if old is None else old.shape}"
                            f" vs {arr.shape})")
            else:
                raise SyncProtocolError(
                    f"{rec.name}: unknown record mode {rec.mode!r}")

    def _apply_delta(self, delta: D.Delta) -> None:
        # validate EVERYTHING before mutating ANYTHING
        self._validate_delta(delta)
        for rec in delta.stacks:
            pending = self._pending_stacks.setdefault(rec.name, set())
            if rec.mode == "topology":
                self.leaves[rec.name] = rec
                self.mask_versions[rec.name] = rec.mask_version
                pending.update(rec.arrays)
                pending.add("__topology__")
            else:
                stored = self.leaves[rec.name]
                merged = dict(stored.arrays)
                merged.update(rec.arrays)
                self.leaves[rec.name] = D.StackDelta(
                    name=stored.name, mask_version=stored.mask_version,
                    mode="topology", format=stored.format,
                    static=stored.static, arrays=merged)
                pending.update(rec.arrays)
        for path, arr in delta.dense.items():
            self.params[path] = arr
            self._pending_dense.add(path)
        self.generation = delta.generation

    # -- consumers ----------------------------------------------------------

    def consume_changes(self) -> dict:
        """What moved since the engine last drained: per-stack changed field
        sets, dense param paths, and whether a wholesale snapshot landed."""
        out = {"stacks": self._pending_stacks,
               "dense": self._pending_dense,
               "snapshot": self._pending_snapshot}
        self._pending_stacks = {}
        self._pending_dense = set()
        self._pending_snapshot = False
        return out

    def masks_tree(self, device=None) -> dict:
        """The masks as a nested tree (on ``device``, else the host
        tensors themselves: callers copy before they write)."""
        return D.unflatten_tree({k: v if device is None else v.to(device, copy=True)
                                 for k, v in self.masks.items()})

    def params_tree(self, device=None) -> dict:
        return D.unflatten_tree({k: v if device is None else v.to(device, copy=True)
                                 for k, v in self.params.items()})

    def wait_for_bootstrap(self, timeout: float = 10.0,
                           interval: float = 0.05) -> bool:
        """Poll until a snapshot lands (multi-process startup helper)."""
        deadline = time.monotonic() + timeout
        while self.generation is None:
            self.poll()
            if self.generation is not None:
                break
            if time.monotonic() >= deadline:
                return False
            time.sleep(interval)
        return True


def engine_from_snapshot(cfg, subscriber: Subscriber, *, registry=None, device=None,
                         **engine_kwargs):
    """A ``ServingEngine`` on ``device`` (``cuda`` unless the caller asks
    for the CPU) from a bootstrapped subscriber, attached to it, so that
    later deltas drain at chunk boundaries. The engine holds its own copies
    of the snapshot's arrays."""
    from repro_torch import resolve_device
    from repro_torch.launch import engine as ENG
    from repro_torch.sparse import registry as REG

    subscriber.poll()
    if subscriber.generation is None:
        raise SyncProtocolError("subscriber has no snapshot yet; wait_for_bootstrap() first")
    meta = subscriber.meta
    D._refuse_tp(meta.get("tp", 1))
    dev = resolve_device(device)
    registry = registry if registry is not None else REG.build_registry(cfg)
    eng = ENG.ServingEngine(
        cfg, subscriber.params_tree(dev), subscriber.masks_tree(dev), registry,
        path=meta.get("path", "condensed"), values_dtype=meta.get("values_dtype"),
        mask_versions={k: int(v) for k, v in subscriber.mask_versions.items()},
        **engine_kwargs)
    eng.attach_subscriber(subscriber)
    return eng
