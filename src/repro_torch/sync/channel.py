"""Transport layer: how encoded records move from publisher to subscribers
(port of ``repro/sync/channel.py``; pure Python, the same files on disk).

Two channels share one tiny interface:

publisher side::

    channel.send(blob, kind=..., generation=...)
    channel.poll_requests() -> list[dict]     # drained resync requests

subscriber side::

    sub = channel.subscribe(name)
    sub.recv_new() -> list[bytes]             # blobs not yet seen by THIS sub
    sub.request_resync(reason)

``QueueChannel`` is in-process (tests, co-located trainer+engine).
``DirChannel`` is the multi-process fleet transport: the publisher writes
each record to a tmp file and atomically ``os.replace``-renames it into the
directory as ``<generation:010d>-<kind>.rsd``, so a tailing subscriber never
observes a torn file and lexical filename order IS generation order. Resync
requests travel the other way as small ``request-*.req`` JSON files the
publisher drains and deletes.

Neither channel deduplicates, orders, or retains forever -- the subscriber's
generation handshake (``sync/subscriber.py``) owns robustness; ``DirChannel``
prunes old delta files (``retain``), which is exactly how a slow subscriber
ends up with a gap and exercises the resync path.
"""
from __future__ import annotations

import json
import os
import uuid


# ---------------------------------------------------------------------------
# in-process queue channel
# ---------------------------------------------------------------------------

class _QueueSubscription:
    def __init__(self, channel: "QueueChannel", name: str):
        self._channel = channel
        self._name = name
        self._cursor = 0

    def recv_new(self) -> list:
        log = self._channel._log
        new = [blob for _, blob in log[self._cursor:]]
        self._cursor = len(log)
        return new

    def request_resync(self, reason: str = "",
                       needed_generation: int | None = None) -> None:
        self._channel._requests.append(
            {"subscriber": self._name, "reason": reason,
             "needed_generation": needed_generation})


class QueueChannel:
    """Shared-memory channel: an append-only log + per-subscriber cursors."""

    def __init__(self, retain: int = 64):
        self._log: list[tuple[dict, bytes]] = []
        self._requests: list[dict] = []
        self.retain = retain

    def send(self, blob: bytes, *, kind: str, generation: int) -> None:
        self._log.append(({"kind": kind, "generation": int(generation)},
                          bytes(blob)))
        # cap memory; cursors index into the live list so prune by marking,
        # not slicing (a slice would silently re-deliver to every cursor)
        if len(self._log) > self.retain:
            drop = len(self._log) - self.retain
            self._log[:drop] = [(m, b"") for m, b in self._log[:drop]]

    def poll_requests(self) -> list[dict]:
        out, self._requests = self._requests, []
        return out

    def subscribe(self, name: str = "replica") -> _QueueSubscription:
        return _QueueSubscription(self, name)


# ---------------------------------------------------------------------------
# file/directory channel
# ---------------------------------------------------------------------------

_RECORD_SUFFIX = ".rsd"
_REQUEST_SUFFIX = ".req"


class _DirSubscription:
    def __init__(self, channel: "DirChannel", name: str):
        self._channel = channel
        self._name = name
        self._seen: set[str] = set()

    def recv_new(self) -> list:
        blobs = []
        for fname in self._channel._list_records():
            if fname in self._seen:
                continue
            self._seen.add(fname)
            try:
                with open(os.path.join(self._channel.dirpath, fname),
                          "rb") as f:
                    blobs.append(f.read())
            except OSError:
                # pruned between listdir and open: the generation handshake
                # treats the hole like any other dropped delta
                continue
        return blobs

    def request_resync(self, reason: str = "",
                       needed_generation: int | None = None) -> None:
        payload = json.dumps({"subscriber": self._name, "reason": reason,
                              "needed_generation": needed_generation})
        fname = f"request-{self._name}-{uuid.uuid4().hex}{_REQUEST_SUFFIX}"
        _atomic_write(self._channel.dirpath, fname, payload.encode("utf-8"))


def _atomic_write(dirpath: str, fname: str, data: bytes) -> None:
    tmp = os.path.join(dirpath, f".tmp-{uuid.uuid4().hex}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dirpath, fname))


class DirChannel:
    """Atomically-renamed record files in a shared directory.

    File name ``<generation:010d>-<kind>.rsd`` makes lexical order equal
    generation order and lets pruning keep the newest ``retain`` records
    plus always the newest snapshot (a subscriber can bootstrap any time).
    """

    def __init__(self, dirpath: str, *, retain: int = 16):
        self.dirpath = str(dirpath)
        self.retain = retain
        os.makedirs(self.dirpath, exist_ok=True)

    def _list_records(self) -> list[str]:
        try:
            names = os.listdir(self.dirpath)
        except OSError:
            return []
        return sorted(n for n in names if n.endswith(_RECORD_SUFFIX))

    def send(self, blob: bytes, *, kind: str, generation: int) -> None:
        fname = f"{int(generation):010d}-{kind}{_RECORD_SUFFIX}"
        _atomic_write(self.dirpath, fname, bytes(blob))
        self._prune()

    def _prune(self) -> None:
        records = self._list_records()
        if len(records) <= self.retain:
            return
        snapshots = [n for n in records if n.endswith(
            f"-snapshot{_RECORD_SUFFIX}")]
        keep = set(records[-self.retain:])
        if snapshots:
            keep.add(snapshots[-1])
        for n in records:
            if n not in keep:
                try:
                    os.remove(os.path.join(self.dirpath, n))
                except OSError:
                    pass

    def poll_requests(self) -> list[dict]:
        out = []
        try:
            names = sorted(os.listdir(self.dirpath))
        except OSError:
            return out
        for n in names:
            if not n.endswith(_REQUEST_SUFFIX):
                continue
            path = os.path.join(self.dirpath, n)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    out.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                pass
            try:
                os.remove(path)
            except OSError:
                pass
        return out

    def subscribe(self, name: str = "replica") -> _DirSubscription:
        return _DirSubscription(self, name)
