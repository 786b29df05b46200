"""Speculative-decoding policy: proposal budgets and adaptive k.

CUTIE's thesis applied to serving: spend almost-free computation (a tiny
ternary draft program) to avoid expensive computation (sequential target
decode steps).  The knob that decides how much to spend is ``k`` — how
many tokens the draft proposes per verify step.  Proposing more than the
target will accept wastes draft work *and* verify FLOPs, so ``k`` tracks
a windowed acceptance-rate estimate: with per-token acceptance rate
``a``, the expected accepted run of an unbounded proposal is
``a / (1 - a)``, which is the natural operating point for ``k``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Executor-level speculative decoding policy."""

    k_max: int = 4          # most tokens the draft proposes per step
    k_min: int = 1          # adaptive floor (never below 1 proposal)
    adaptive: bool = True   # track acceptance and shrink/grow k
    window: int = 32        # verify steps in the acceptance estimate
    min_samples: int = 8    # verify steps before adapting away from k_max

    def __post_init__(self):
        if self.k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {self.k_max}")
        if not 1 <= self.k_min <= self.k_max:
            raise ValueError(f"need 1 <= k_min <= k_max, got "
                             f"k_min={self.k_min} k_max={self.k_max}")


class AdaptiveK:
    """Windowed acceptance-rate estimate -> current proposal budget."""

    def __init__(self, spec: SpecConfig):
        self.spec = spec
        self._hist: deque[tuple[int, int]] = deque(maxlen=spec.window)

    def observe(self, proposed: int, accepted: int) -> None:
        self._hist.append((proposed, accepted))

    @property
    def acceptance_rate(self) -> Optional[float]:
        prop = sum(p for p, _ in self._hist)
        if prop == 0:
            return None
        return sum(a for _, a in self._hist) / prop

    def k(self) -> int:
        spec = self.spec
        if not spec.adaptive or len(self._hist) < spec.min_samples:
            return spec.k_max
        a = self.acceptance_rate
        if a is None or a >= 1.0:
            return spec.k_max
        expected_run = a / (1.0 - a)
        return max(spec.k_min, min(spec.k_max, round(expected_run)))

    def stats(self) -> dict:
        return {
            "k_current": self.k(),
            "k_max": self.spec.k_max,
            "acceptance_rate": self.acceptance_rate,
            "window_steps": len(self._hist),
        }
