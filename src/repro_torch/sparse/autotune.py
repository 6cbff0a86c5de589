"""The measured-profile cache (port of the cache half of
``repro/sparse/autotune.py``).

``plan.HardwareProfile.measure`` times the cost model's rates on the live
device and keeps them here, one entry per device name
(``torch.cuda.get_device_name()``, or ``cpu``), together with the
measurement settings that produced them, so a later ``measure`` with the
same settings returns the stored rates without timing anything.

The file is the port's own: ``$REPRO_TORCH_AUTOTUNE_CACHE``, else
``~/.cache/repro_torch/autotune.json``. The reference's cache file is never
read or written. The timed block search of the reference module
(``autotune_blocks`` and the kernel-geometry entries) is not ported yet
(ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import json
import os
import time

import torch

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
        data = {"version": _CACHE_VERSION, "profiles": {}}
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
    """The cache's key for a device: the card's name, or ``cpu``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def store_profile(rates: dict, *, device: str) -> None:
    """Keep ``rates`` (a measured profile and its ``params``) under the
    device key ``device``."""
    _load()["profiles"][device] = dict(rates)
    _save()


def cached_profile(device: str) -> dict | None:
    return _load()["profiles"].get(device)


def _time_us(fn, *args, reps: int = 3, agg=min, calls: int = 20) -> float:
    """``fn(*args)`` in µs, aggregated over ``reps`` timings after one
    warm-up call.

    On the card ``calls`` calls are captured in one CUDA graph and a timing
    is one replay between two CUDA events, divided by ``calls``: the host's
    launch overhead is not in it. On the CPU a timing is the wall clock
    around one call. ``min`` by default (interference only adds time); pass
    ``statistics.median`` for a bandwidth rate, where the fastest run is a
    cache burst.
    """
    fn(*args)
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)), torch.device("cpu"))
    ts = []
    if dev.type == "cuda":
        from repro_torch.kernels import counters  # the timed launches are not the path's

        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        with counters.recording(), torch.cuda.graph(graph):
            for _ in range(calls):
                fn(*args)
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
