"""Phase timers: ``PhaseTimer``, ``GLOBAL_TIMER`` and ``timed``, named
wall-clock accumulators that the host pipeline attributes its time to."""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Iterator



class PhaseTimer:
    """Named wall-clock accumulators: ``with timer.phase("chain"): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def report(self) -> str:
        width = max((len(k) for k in self.totals), default=4)
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<{width}}  {tot:9.3f}s  x{n:<6d} "
                         f"{tot / max(1, n) * 1000:9.2f} ms/call")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


#: process-wide timer used by the pipeline when verbosity is enabled
GLOBAL_TIMER = PhaseTimer()


@contextlib.contextmanager
def timed(name: str, timer: PhaseTimer = None) -> Iterator[None]:
    t = timer if timer is not None else GLOBAL_TIMER
    with t.phase(name):
        yield
