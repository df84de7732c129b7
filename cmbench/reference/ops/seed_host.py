"""The per-read host seed lookup of the oracle mapper, free of JAX.

The reference keeps ``SeedHits`` and ``lookup_read_host`` (the numpy
seeder of the per-read Python oracle, ``--device host``) in
``circminer_tpu/ops/seed.py``, which imports jax at module level.  This
module holds verbatim copies of the two; ``pipeline/mapping.py``'s
``make_host_seeder`` imports them from here, and
``tests/test_torch_selfcontained.py`` pins them to the reference's source.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..config import Config
from ..index.build import ContigIndex
from ..utils import logging as ulog
from .encode import hash_at


class SeedHits(NamedTuple):
    """Per (read, kmer-slot) lookup result; shapes [B, n_slots]."""
    qpos: np.ndarray      # int32 query start of the k-mer (0-based), -1 unused
    start: np.ndarray     # int64 offset into entry_pos of first hit
    count: np.ndarray     # int32 number of hits (0 if none or > seed_lim)
    high_hit: np.ndarray  # bool: had hits but above seed_lim


def lookup_read_host(codes: np.ndarray, ci: ContigIndex, cfg: Config):
    """split_match_hash for one read on host. Returns SeedHits-like arrays of
    length cfg.max_seg_cnt (even slots populated)."""
    k = cfg.kmer
    w = cfg.window_size
    cs_len = cfg.checksum_len
    n_slots = cfg.max_seg_cnt
    L = codes.shape[0]

    qpos = np.full(n_slots, -1, dtype=np.int32)
    start = np.zeros(n_slots, dtype=np.int64)
    count = np.zeros(n_slots, dtype=np.int32)
    high = np.zeros(n_slots, dtype=bool)

    slot = 0
    n_valid = 0
    for i in range(0, L, k):
        if L - i < k:
            break
        qpos[slot] = i
        fh = hash_at(codes, i, k)
        occ = 0
        if fh >= 0:
            hv = fh >> (2 * cs_len)
            cv = fh & ((1 << (2 * cs_len)) - 1) if cs_len else 0
            lo, hi = ci.bucket_range(hv)
            sub = ci.entry_checksum[lo:hi]
            l = np.searchsorted(sub, cv, side="left")
            r = np.searchsorted(sub, cv, side="right")
            c = int(r - l)
            occ = c
            if c > cfg.seed_lim:
                high[slot] = True
                c = 0
            else:
                n_valid += 1 if occ > 0 else 0
            count[slot] = c
            start[slot] = lo + l
        if ulog.TRACE_LEVEL >= 2:  # match_read.cpp:227
            ulog.vaf(2, "Occ: %d\tind: %d\tmatch len: %d", occ, i, k)
        slot += 2
    if ulog.TRACE_LEVEL >= 1:  # match_read.cpp:281
        ulog.vaf(1, "Non-OV valids: %d", n_valid)
        ulog.vaf(1, "OV valids: %d", 0)
    return SeedHits(qpos, start, count, high)

