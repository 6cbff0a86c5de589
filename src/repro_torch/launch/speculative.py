"""Self-draft speculative decoding: the ablated subnetwork drafts, the full
network verifies (port of ``repro/launch/speculative.py``).

SRigL's neuron ablation means a served model already contains its own draft
model: the same trained weights at a higher ablation fraction
(``plan.derive_draft_tree``: per stack, sharing every value tensor with the
target plan, no extra weight residency). The paged engine's decode chunk is
replaced by speculative rounds:

1. ``gamma`` greedy decode steps through the draft tree,
2. one batched full-network verify over the ``gamma + 1`` positions
   (``verify_step``, ``models.model.paged_verify_step``): position
   ``i``'s argmax is what a sequential greedy decode would emit there,
3. acceptance on the host: the longest drafted prefix the target agrees
   with commits, plus the target's own next token, and the paged KV state
   is rolled back past it (``paged.rewind_pages``).

Greedy acceptance makes the emitted stream the plain greedy stream, while
the full network runs once per committed prefix instead of once per token.
Whether that is faster is priced (``plan.price_speculation``), so ``--path
auto`` can decline.

On the card both dispatches are captured CUDA graphs over the runner's
decode state, as a decode step is (``launch/engine.py``): the draft graph is
the paged decode step over the draft tree, replayed ``gamma`` times; the
verify graph builds its feed ``[cur, d_1..d_gamma]`` and its lengths
``L0`` on the device from what the draft replays left, and writes the
target's argmax into a static (bucket, gamma + 1) buffer. A round makes one
host sync, after the verify; the two dispatches are timed apart with CUDA
events. On the CPU both run eagerly; on the card a dispatch without its
graph raises.

KV protocol per round (a stream at committed length L0, next token
``cur``): the draft steps write draft-weight K/V at slots ``L0 ..
L0+gamma-1`` and emit d_1..d_gamma; the verify feeds ``[cur, d_1..d_gamma]``
and rewrites slots ``L0 .. L0+gamma`` with target-weight K/V before any
position attends them, so draft residue is never read by the verify, and
committed slots end the round holding what a sequential decode writes.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.models import model as M


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Engine-level speculative decoding settings.

    ``gamma``: drafted tokens per round (the verify scores ``gamma + 1``
    positions). ``draft_ablation``: the extra neuron ablation the draft
    applies on top of the target plan (0.5 keeps the most salient half of
    each stack's active neurons). ``acceptance``: the per-token acceptance
    the price assumes before anything is measured (``Result.spec`` reports
    the measured rate). ``force``: run speculation where the price declines
    it (fixed paths always run; ``--path auto`` declines unless forced).
    """

    gamma: int = 3
    draft_ablation: float = 0.5
    acceptance: float = 0.7
    force: bool = False

    def __post_init__(self):
        if self.gamma < 1:
            raise ValueError("gamma must be >= 1")
        if not 0.0 <= self.draft_ablation < 1.0:
            raise ValueError("draft_ablation must be in [0, 1)")
        if not 0.0 <= self.acceptance <= 1.0:
            raise ValueError("acceptance must be in [0, 1]")


@dataclasses.dataclass
class SpecStats:
    """Per-request speculative counters, summed over rounds.

    ``drafted``/``matched`` measure the draft's agreement with the target
    (acceptance = matched / drafted); ``committed`` counts the tokens
    emitted (lockstep and capacity caps can commit fewer than matched);
    ``rounds`` counts full-network verify dispatches, so rounds per token a
    stream is the full-network dispatches per token (1.0 for plain decode).
    ``draft_s``/``verify_s`` are the dispatches' device seconds on the card
    (CUDA events), wall seconds on the CPU. ``rejected`` lists (stream,
    generated index) where the target's pick beat the draft's at a verify
    position inside the pages the stream held, i.e. at a logit a plain
    decode computes too.
    """

    rounds: int = 0
    drafted: int = 0
    matched: int = 0
    committed: int = 0
    draft_s: float = 0.0
    verify_s: float = 0.0
    rejected: list = dataclasses.field(default_factory=list)

    def summary(self, cfg: SpecConfig, streams: int) -> dict:
        tokens_per_stream = self.committed / max(streams, 1)
        return {
            "gamma": cfg.gamma,
            "draft_ablation": cfg.draft_ablation,
            "rounds": self.rounds,
            "drafted": self.drafted,
            "matched": self.matched,
            "committed": self.committed,
            "acceptance_rate": self.matched / max(self.drafted, 1),
            "full_dispatches_per_token": self.rounds / max(tokens_per_stream, 1e-9),
            "draft_s": self.draft_s,
            "verify_s": self.verify_s,
            "rejected": list(self.rejected),
        }


def verify_step(cfg, params, tree, st, targ: torch.Tensor, gamma: int) -> None:
    """The verify graph's body over a runner's decode state ``st`` after
    ``gamma`` draft steps: ``st.toks[:, :gamma]`` holds ``[cur, d_1 ..
    d_{gamma-1}]``, ``st.cur`` d_gamma and ``st.lengths`` L0 + gamma. The
    feed ``[cur, d_1..d_gamma]`` goes into ``st.toks[:, :gamma + 1]``; each
    position's greedy next token into ``targ`` (bucket, gamma + 1)."""
    st.toks[:, gamma:gamma + 1].copy_(st.cur)
    logits, _ = M.paged_verify_step(cfg, params, tree, {"tokens": st.toks[:, :gamma + 1]},
                                    st.pool, st.table, st.lengths - gamma)
    targ.copy_(torch.argmax(logits, dim=-1).to(torch.int32))


class Stamps:
    """Points in a round's stream of work: CUDA events on the card (read
    after the round's one host sync), the wall clock on the CPU, where the
    work has finished when the call returns."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.points: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.points.append(ev)
        else:
            self.points.append(time.perf_counter())

    def seconds(self) -> list[float]:
        """The seconds between consecutive marks (after the host sync)."""
        if self.cuda:
            return [a.elapsed_time(b) * 1e-3 for a, b in zip(self.points, self.points[1:])]
        return [b - a for a, b in zip(self.points, self.points[1:])]
