"""Wave scheduler: lockstep batched execution of extension generators.

The reference extends one candidate at a time through a branchy recursion
(src/extend.cpp:37-125, filter.cpp:244-395).  Here every per-read pipeline
is a generator that yields alignment requests (pipeline/extend.py); this
scheduler advances *all* of them in lockstep — each wave gathers the
current requests from every live generator and solves them as a handful of
batched device dispatches (ops/align_device.py), so the DP kernels run at
batch width B = number of live candidates instead of 1.

Request order inside a read is preserved exactly (each generator is a
faithful sequential program), so results are bit-identical to the inline
path; only the *interleaving across reads* changes, which no state
depends on (per-read state lives in the generator; MatchedRead updates
happen inside each generator in program order)."""

from __future__ import annotations

from typing import Callable, List, Optional

from ..utils.timing import GLOBAL_TIMER as T


def run_waves(gens: List, svc, max_concurrent: Optional[int] = None):
    """Drive request-yielding generators to completion in lockstep.

    gens: generators yielding align-request tuples (see extend.py).
    svc:  object with solve_batch(list[req]) -> list[result].
    Returns (results, n_waves): the list of generator return values (same
    order) and the number of lockstep waves it took to drain them."""
    results = [None] * len(gens)
    active = []
    n_waves = 0
    for i, g in enumerate(gens):
        try:
            active.append((i, g, next(g)))
        except StopIteration as e:
            results[i] = e.value
    while active:
        n_waves += 1
        reqs = [r for _, _, r in active]
        with T.phase("wave_align"):
            answers = svc.solve_batch(reqs)
        nxt = []
        for (i, g, _), ans in zip(active, answers):
            try:
                nxt.append((i, g, g.send(ans)))
            except StopIteration as e:
                results[i] = e.value
        active = nxt
    return results, n_waves
