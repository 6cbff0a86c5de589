"""DST connectivity-update schedule (port of ``repro/core/schedule.py``).

RigL / SRigL update the sparse topology every ``delta_t`` optimizer steps.
The fraction of active weights pruned (and regrown) at an update follows a
cosine annealing schedule (Dettmers & Zettlemoyer 2019):

    alpha_t = alpha/2 * (1 + cos(pi * t / t_end))   for t < t_end, else 0

with alpha = 0.3 and t_end = 75% of the training steps by default.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class DSTSchedule:
    delta_t: int = 100          # steps between topology updates
    alpha: float = 0.3          # initial drop fraction
    t_end_fraction: float = 0.75
    total_steps: int = 100_000
    grad_accum_steps: int = 1   # dense-grad averaging window before an update

    @property
    def t_end(self) -> int:
        return int(self.t_end_fraction * self.total_steps)

    def drop_fraction(self, step: int) -> np.float32:
        """Cosine-annealed drop fraction at ``step`` (0 after t_end), float32.

        Every operation is the reference's float32 operation, in its order,
        except the cosine: it is taken in float64 and rounded to float32
        (correctly rounded, the same on the CPU and the card). The
        reference's compiled float32 cosine is not always correctly rounded
        and may then differ by one ulp.
        """
        f32 = np.float32
        t = f32(step)
        t_end = f32(max(self.t_end, 1))
        arg = f32(f32(np.pi) * min(t, t_end)) / t_end
        cos = f32(math.cos(float(arg)))
        frac = f32(0.5 * self.alpha) * (f32(1.0) + cos)
        return frac if t < t_end else f32(0.0)

    def is_update_step(self, step: int) -> bool:
        """True on steps where the topology is updated (and before t_end)."""
        step = int(step)
        return step % self.delta_t == 0 and step > 0 and step < self.t_end
