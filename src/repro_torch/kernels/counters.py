"""Kernel launch counters that see through CUDA-graph capture.

Each kernel wrapper counts its launches on an attribute of its own function
(``condensed_matmul.launches``, ``condensed_matmul.scaled_launches``,
``condensed_matmul_grouped.launches`` for the expert-grouped K1-moe;
``condensed_over_active_matmul_grouped.launches`` /
``.scaled_launches`` for K4-moe / K2-coa-moe,
``structured_matmul_grouped.launches`` for K5-moe,
``structured_matmul_prefetch_grouped.launches`` for K6-moe and
``condensed_matmul_dw_grouped.launches`` for K3-moe, ...)
through ``add``, where it launches the kernel and nowhere else. A launch
issued while a graph is being captured under ``recording()`` runs nothing
yet: it goes to that capture's tally instead, and ``replayed`` adds the
tally to the counters once for each replay of the graph. A run decoded by
graph replay therefore counts what an eager run of the same steps counts.
"""
from __future__ import annotations

import contextlib

# the tallies of the captures in progress, innermost last
_tallies: list[dict] = []


def add(fn, attr: str = "launches") -> None:
    """One launch of ``fn``'s kernel, counted on ``fn.<attr>``, or on the
    tally of the capture in progress."""
    if _tallies:
        tally = _tallies[-1]
        tally[(fn, attr)] = tally.get((fn, attr), 0) + 1
    else:
        setattr(fn, attr, getattr(fn, attr) + 1)


@contextlib.contextmanager
def recording():
    """Collect the launches issued inside into a tally, {(fn, attr): n},
    instead of the counters."""
    tally: dict = {}
    _tallies.append(tally)
    try:
        yield tally
    finally:
        _tallies.pop()


def replayed(tally: dict, times: int = 1) -> None:
    """Count the launches of ``times`` replays of a graph captured with
    ``tally``."""
    for (fn, attr), n in tally.items():
        setattr(fn, attr, getattr(fn, attr) + n * times)
