"""Phase timers and a torch.profiler trace around a region (``--trace-dir``).

``PhaseTimer``, ``GLOBAL_TIMER`` and ``timed`` are the reference's
(``circminer_tpu/utils/timing.py``), copied verbatim: named wall-clock
accumulators the pipeline attributes host, device and transfer time to.
``device_trace`` is the port's counterpart of the reference's
``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch.profiler import ProfilerActivity, profile


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


@contextlib.contextmanager
def device_trace(logdir: str = None) -> Iterator[None]:
    """Profile the region with torch.profiler (host activity, and the
    card's kernels and copies when CUDA is available) and write it as a
    gzipped Chrome trace (Perfetto reads it) into ``logdir``; enabled only when a logdir is given or
    CIRCMINER_TRACE_DIR is set.  The trace holds the fused step's ``cm.*``
    spans and the names of the kernels the region launched."""
    logdir = logdir or os.environ.get("CIRCMINER_TRACE_DIR")
    if not logdir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, f"circminer_torch.{os.getpid()}.trace.json.gz")
    prof.export_chrome_trace(path)
    print(f"[INFO] trace written to {path}", file=sys.stderr)
