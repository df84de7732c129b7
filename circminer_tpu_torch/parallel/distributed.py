"""Multi-host runtime: torch.distributed initialization + host-striped input.

Counterpart of ``circminer_tpu/parallel/distributed.py``.  Every host runs
the same program:

  - hosts join one gloo process group through ``init_process_group`` when a
    coordinator is configured (from flags or the CIRCMINER_COORDINATOR /
    CIRCMINER_NUM_HOSTS / CIRCMINER_HOST_ID env); host 0 serves the
    rendezvous at the coordinator address,
  - FASTQ input is data-parallel striped by host: host h maps read pairs
    h, h+N, h+2N, ... of the stream (the distributed analog of the
    reference's buffer_lock round-robin, circminer.cpp:373-379),
  - each host writes its own shard outputs (out.h<k>.mapping.pam etc.);
    host 0 merges every host's remain shard for the circ stage, ordered by
    (genome_spos, global read index), which reproduces the single-host
    GNU-sort order.

Single-process use is untouched: ``maybe_initialize`` is a no-op unless a
coordinator is configured.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, Iterator, Optional, Tuple

INIT_TIMEOUT = datetime.timedelta(minutes=10)  # rendezvous and collectives


def maybe_initialize(coordinator: Optional[str] = None,
                     num_hosts: Optional[int] = None,
                     host_id: Optional[int] = None) -> Tuple[int, int]:
    """Initialize torch.distributed when configured; returns
    (host_id, num_hosts) — (0, 1) in single-process mode."""
    coordinator = coordinator or os.environ.get("CIRCMINER_COORDINATOR")
    num_hosts = int(num_hosts or os.environ.get("CIRCMINER_NUM_HOSTS", "1"))
    host_id = int(host_id if host_id is not None
                  else os.environ.get("CIRCMINER_HOST_ID", "0"))
    if coordinator:
        # one gloo process group over every host (host 0 serves the store)
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_hosts, rank=host_id,
                                timeout=INIT_TIMEOUT)
    # without a coordinator, multi-host still works in shared-filesystem
    # mode: striped input + per-host outputs + file-merged circ stage
    return host_id, num_hosts


def stripe_pairs(pairs: Iterable, host_id: int, num_hosts: int,
                 with_index: bool = False) -> Iterator:
    """Host h takes pairs h, h+N, h+2N, ... of the input stream.

    Every host streams the same FASTQ files (shared filesystem, like the
    reference's multi-round rewinds) but only materializes its own stripe;
    with_index additionally yields the global pair index (the deterministic
    tiebreak key for the merged candidate order)."""
    for i, pr in enumerate(pairs):
        if i % num_hosts == host_id:
            yield (i, pr) if with_index else pr


def shard_output_prefix(prefix: str, host_id: int, num_hosts: int) -> str:
    """Per-host output prefix: unchanged when single-host."""
    if num_hosts <= 1:
        return prefix
    return f"{prefix}.h{host_id}"
