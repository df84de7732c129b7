"""The device trace of one library pass, and what the per-layer readers
take from it.

``profiled`` runs a function under ``torch.profiler`` with CUDA activity
only, so the fused step keeps replaying as a CUDA graph and the host pays
no per-op cost, and returns its record: the window's bounds, every device
operation (kernels, copies, memsets) with its start, end and correlation
id, and the correlation ids of the ``cudaGraphLaunch`` calls.  Each device
operation of a replay carries its launch's correlation id, which is how a
replay's operations are told apart from stage 2's and from the copies
between replays.  Timestamps are the profiler's, nanoseconds of the Unix
clock, which ``time.time_ns`` also reads: the harness's spans are taken on
it to name what the host did in each idle gap.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

# the hand-written kernels of the port (csrc/*.cu): a device operation is
# theirs when its symbol holds "<name>_kernel"
HAND_KERNELS = ("xdrop", "edit_sc", "edit_end", "one_side", "chain_dp",
                "mr_pair_fold", "walk_fold", "tiny_dp", "walk_scan",
                "walk_init", "walk_pool", "walk_commit", "chain_cells",
                "extract_kbest", "extend_core", "extend_leftover",
                "pair_grid")


def profiled(fn) -> Dict:
    """Run ``fn()`` under the profiler (CUDA activity only); its record:
    {"t0_ns", "t1_ns", "device": [(name, start_ns, end_ns, corr)],
    "graph_launches": [corr]}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        fn()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    device, launches = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.name().startswith("cm."):
                device.append((e.name(), e.start_ns(), e.end_ns(),
                               e.correlation_id()))
        elif e.name().startswith("cudaGraphLaunch"):
            launches.append(e.correlation_id())
    device.sort(key=lambda d: d[1])
    return dict(t0_ns=t0, t1_ns=t1, device=device, graph_launches=launches)


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in union(intervals))


def replays(prof: Dict) -> List[List[tuple]]:
    """The device operations of each graph replay of the trace, in launch
    order (replays that show no operation are left out)."""
    groups: Dict[int, List[tuple]] = {c: [] for c in prof["graph_launches"]}
    for d in prof["device"]:
        if d[3] in groups:
            groups[d[3]].append(d)
    return [groups[c] for c in prof["graph_launches"] if groups[c]]


def is_hand(name: str) -> bool:
    return any(f"{k}_kernel" in name for k in HAND_KERNELS)


def window_busy_s(prof: Dict) -> float:
    return busy_ns([(d[1], d[2]) for d in prof["device"]]) / 1e9


def window_s(prof: Dict) -> float:
    return (prof["t1_ns"] - prof["t0_ns"]) / 1e9


def short_name(name: str) -> str:
    """A kernel's symbol without its return type and parameter list (at
    most 160 characters); copies and memsets as the profiler names them."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    for lead in ("void ", "(anonymous namespace)::"):
        if name.startswith(lead):
            name = name[len(lead):]
    return name.split("(", 1)[0][:160]


def top_ops(prof: Dict, n: int = 10) -> List[list]:
    """[[device operation's short name, seconds]] of the n that took most
    time in all."""
    tot: Dict[str, int] = {}
    for name, s, e, _ in prof["device"]:
        name = short_name(name)
        tot[name] = tot.get(name, 0) + (e - s)
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in best]


def idle_gaps(prof: Dict, spans: Sequence[Tuple[str, int, int]],
              n: int = 10) -> List[list]:
    """[[harness span open at its middle, seconds]] of the n longest
    stretches of the window in which the device ran nothing; ``spans``
    are (name, start_ns, end_ns), and where they nest the innermost (the
    shortest) names the gap."""
    busy = union([(max(d[1], prof["t0_ns"]), min(d[2], prof["t1_ns"]))
                  for d in prof["device"] if d[2] > prof["t0_ns"]
                  and d[1] < prof["t1_ns"]])
    gaps, at = [], prof["t0_ns"]
    for s, e in busy + [(prof["t1_ns"], prof["t1_ns"])]:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:n]:
        mid = (s + e) // 2
        open_ = [(b - a, sp) for sp, a, b in spans if a <= mid < b]
        out.append([min(open_)[1] if open_ else "harness", (e - s) / 1e9])
    return out


def step_device_ms(prof: Dict) -> Optional[float]:
    """Mean device-busy ms of a replay (the union of its operations)."""
    reps = replays(prof)
    if not reps:
        return None
    return sum(busy_ns([(d[1], d[2]) for d in r]) for r in reps) \
        / len(reps) / 1e6


def hand_ms(prof: Dict) -> Tuple[float, int]:
    """(device ms of the hand kernels over every replay, replays)."""
    reps = replays(prof)
    return sum((d[2] - d[1]) for r in reps for d in r
               if is_hand(d[0])) / 1e6, len(reps)
