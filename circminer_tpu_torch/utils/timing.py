"""A torch.profiler trace around a region (``--trace-dir``).

Counterpart of ``circminer_tpu.utils.timing.device_trace`` (a
``jax.profiler`` trace).  The phase timers themselves are the reference's
``GLOBAL_TIMER``, which is plain Python and shared.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile


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
