"""Batched seed lookup against the device-resident k-mer index (torch).

Device half of ``circminer_tpu/ops/seed.py``: a read is cut into
non-overlapping k-mers (stride k); each k-mer's window hash and checksum
select its exact-match range in the flat (hv, checksum)-sorted entry table
through a composite binary search, optionally narrowed first by a radix
prefix table; k-mers with more than ``seed_lim`` hits are dropped (count 0)
and counted as high hits (reference match_read.cpp:54-286).  Slots follow
the reference's ``GIMatchedKmer`` layout: non-overlapping k-mers on even
slots, odd slots empty.  ``gather_seeds_device`` then reads up to ``cap``
positions of each slot's range from the entry table.

These are plain torch functions (the reference lowers them through XLA and
has no Pallas twin); all integers are int32 as in the reference.
``build_device_prefix`` is the reference's numpy helper, copied because the
original module imports jax.  ``lookup_gather_sharded_local`` is one
shard's part of the lookup when the entry table is bucket-sharded over
several devices (``parallel/mesh.py``).
"""

from __future__ import annotations

import numpy as np
import torch

_i32 = torch.int32


def _bisect_hv_cv(entry_hv: torch.Tensor, entry_cv: torch.Tensor,
                  hv: torch.Tensor, cv: torch.Tensor, side_right,
                  iters: int, lo0: torch.Tensor = None,
                  hi0: torch.Tensor = None) -> torch.Tensor:
    """Composite binary search of (hv, cv) over the (hv, checksum)-sorted
    entry table, ``iters`` fixed steps.  ``side_right`` is a bool or a bool
    tensor broadcastable to hv (per-probe side, so the left and right
    searches share one loop); lo0/hi0 optionally restrict each probe's
    range (radix-prefix buckets).  The int16 checksum is upcast per probe.
    Returns absolute insertion offsets, int32."""
    n = entry_hv.shape[0]
    if lo0 is not None:
        lo = torch.broadcast_to(lo0, hv.shape).to(_i32)
        hi = torch.broadcast_to(hi0, hv.shape).to(_i32)
    else:
        lo = torch.zeros_like(hv)
        hi = torch.full_like(hv, n)
    if not isinstance(side_right, bool):
        side_right = torch.broadcast_to(side_right, hv.shape)
    for _ in range(iters):
        mid = (lo + hi) >> 1
        midc = torch.clamp(mid, 0, n - 1).long()
        hv_e = entry_hv[midc]
        cv_e = entry_cv[midc].to(_i32)
        if isinstance(side_right, bool):
            tie = (cv_e <= cv) if side_right else (cv_e < cv)
        else:
            tie = torch.where(side_right, cv_e <= cv, cv_e < cv)
        go_right = (hv_e < hv) | ((hv_e == hv) & tie)
        active = lo < hi
        lo, hi = (torch.where(active & go_right, mid + 1, lo),
                  torch.where(active & ~go_right, mid, hi))
    return lo


def _kmer_hash_parts(read_codes: torch.Tensor, read_lens: torch.Tensor,
                     *, k: int, cs_len: int, n_slots: int):
    """Hash math shared by the device lookups.

    Returns (hv, cv, ok, qpos, starts) over the n_nonov = (n_slots+1)//2
    non-overlapping k-mer lists: int32 window hash [B, NL], int32 checksum
    [B, NL], validity mask [B, NL], query offsets [B, NL] and the list
    starts [NL]."""
    B, L = read_codes.shape
    dev = read_codes.device
    n_nonov = (n_slots + 1) // 2
    w = k - cs_len  # window size; the hash fits int32 (2w <= 28 bits)
    x = read_codes.to(_i32)
    valid_base = x < 4
    xc = torch.where(valid_base, x, 0)

    starts = torch.arange(n_nonov, dtype=_i32, device=dev) * k
    in_read = (starts + k) <= read_lens.to(_i32)[:, None]

    # slot l covers columns [l*k, (l+1)*k): a pad + reshape, not a gather
    W = n_nonov * k
    if W > L:
        xc = torch.nn.functional.pad(xc, (0, W - L))
        valid_base = torch.nn.functional.pad(valid_base, (0, W - L))
    bases = xc[:, :W].reshape(B, n_nonov, k)
    ok = valid_base[:, :W].reshape(B, n_nonov, k).all(dim=-1) & in_read

    wbasis = 4 ** torch.arange(w - 1, -1, -1, dtype=_i32, device=dev)
    hv = (bases[..., :w] * wbasis).sum(dim=-1, dtype=_i32)
    if cs_len:
        cbasis = 4 ** torch.arange(cs_len - 1, -1, -1, dtype=_i32,
                                   device=dev)
        cv = (bases[..., w:] * cbasis).sum(dim=-1, dtype=_i32)
    else:
        cv = torch.zeros_like(hv)
    qpos = torch.where(in_read, starts[None, :], -1).to(_i32)
    return hv, cv, ok, qpos, starts


def build_device_prefix(entry_hv, window_size: int):
    """Host-side construction of the device radix-prefix table: a
    4^p + 1 offset array over the top 2p bits of the window hash (the
    device twin of NativeSeeder's radix table; p capped at 12 -> <=67 MB
    HBM).  Returns (prefix int32[4^p + 1], shift, iters) where iters is
    the static bisect depth covering the largest bucket."""
    n = int(entry_hv.shape[0])
    if n == 0:
        return None, 0, 1
    # p must not exceed window_size, or shift below goes negative
    # (undefined device shift) for window_size <= 11 + large tables
    p = min(12, window_size, max(1, int(np.ceil(np.log2(max(2, n)) / 2))))
    shift = 2 * window_size - 2 * p
    q = (np.asarray(entry_hv) >> shift).astype(np.int64)
    counts = np.bincount(q, minlength=1 << (2 * p))
    prefix = np.zeros(counts.shape[0] + 1, np.int32)
    np.cumsum(counts, out=prefix[1:])
    iters = int(np.ceil(np.log2(int(counts.max()) + 1))) + 1
    return prefix, shift, iters


def lookup_batch_device(read_codes: torch.Tensor, read_lens: torch.Tensor,
                        entry_hv: torch.Tensor, entry_checksum: torch.Tensor,
                        entry_prefix: torch.Tensor = None,
                        *, k: int, cs_len: int, n_slots: int, seed_lim: int,
                        prefix_shift: int = 0, prefix_iters: int = 0):
    """Batched seed lookup: [B, L] int8 reads -> per-slot
    (qpos, start, count, high_hit), each [B, n_slots], on the reads' device.

    Only even slots are populated.  ``entry_prefix`` (from
    ``build_device_prefix``) narrows each bisect to its radix bucket."""
    B, L = read_codes.shape
    dev = read_codes.device
    hv, cv, ok, qpos, _ = _kmer_hash_parts(
        read_codes, read_lens, k=k, cs_len=cs_len, n_slots=n_slots)
    hv_safe = torch.where(ok, hv, -1)
    NL = hv_safe.shape[1]
    # left and right searches share one bisect loop via a per-probe side
    hv2 = torch.cat([hv_safe, hv_safe], dim=1)                # [B, 2NL]
    cv2 = torch.cat([cv, cv], dim=1)
    right_f = (torch.arange(2 * NL, device=dev) >= NL)[None, :]
    if entry_prefix is not None:
        iters = max(1, prefix_iters)
        n_pref = entry_prefix.shape[0] - 1
        q = torch.clamp(torch.where(hv2 >= 0, hv2 >> prefix_shift, 0), 0,
                        n_pref - 1).long()
        both = _bisect_hv_cv(entry_hv, entry_checksum, hv2, cv2,
                             side_right=right_f, iters=iters,
                             lo0=entry_prefix[q], hi0=entry_prefix[q + 1])
    else:
        n_entries = entry_hv.shape[0]
        iters = max(1, int(np.ceil(np.log2(max(2, n_entries + 1)))) + 1)
        both = _bisect_hv_cv(entry_hv, entry_checksum, hv2, cv2,
                             side_right=right_f, iters=iters)
    left, right = both[:, :NL], both[:, NL:]

    cnt = torch.where(ok, right - left, 0).to(_i32)
    high = cnt > seed_lim
    cnt = torch.where(high, 0, cnt)

    def strided(v, fill):
        out = torch.full((B, n_slots), fill, dtype=v.dtype, device=dev)
        out[:, ::2] = v
        return out

    return (strided(qpos, -1), strided(left.to(_i32), 0), strided(cnt, 0),
            strided(high, False))


def lookup_gather_sharded_local(read_codes: torch.Tensor,
                                read_lens: torch.Tensor,
                                local_hv: torch.Tensor,
                                local_checksum: torch.Tensor,
                                local_pos: torch.Tensor,
                                bucket_lo: torch.Tensor,
                                bucket_hi: torch.Tensor,
                                *, k: int, cs_len: int, n_slots: int,
                                seed_lim: int, cap: int):
    """One shard's contribution to a bucket-sharded seed lookup: the reads
    are the full (all-gathered) query batch, the index arrays this shard's
    contiguous bucket slice (``parallel.mesh.shard_index_arrays``).  Results
    are zero for queries whose window hash another shard owns, so the
    shards' contributions combine by an all-reduce sum.

    Returns (qpos [B, NL], identical on every shard; pos [B, NL, cap];
    cnt [B, NL]; high [B, NL]), int32, over the non-overlapping k-mer
    lists."""
    hv, cv, ok, qpos, _ = _kmer_hash_parts(
        read_codes, read_lens, k=k, cs_len=cs_len, n_slots=n_slots)

    mine = ok & (hv >= bucket_lo) & (hv < bucket_hi)
    hv_safe = torch.where(mine, hv, -1)

    n_local = local_hv.shape[0]
    iters = max(1, int(np.ceil(np.log2(max(2, n_local + 1)))) + 1)
    left = _bisect_hv_cv(local_hv, local_checksum, hv_safe, cv,
                         side_right=False, iters=iters)
    right = _bisect_hv_cv(local_hv, local_checksum, hv_safe, cv,
                          side_right=True, iters=iters)

    cnt = (right - left).to(_i32)
    high = (cnt > seed_lim) & mine
    cnt = torch.where(mine & ~high, cnt, 0).to(_i32)

    offs = torch.arange(cap, dtype=_i32, device=read_codes.device)
    # the gather index clamps into the slice, as JAX's gather does
    idx = torch.clamp(left[..., None] + offs, 0, n_local - 1)
    pos = local_pos[idx.long()].to(_i32)
    mask = offs < torch.clamp(cnt, max=cap)[..., None]
    return qpos, torch.where(mask, pos, 0), cnt, high.to(_i32)


def gather_seeds_device(entry_pos: torch.Tensor, start: torch.Tensor,
                        count: torch.Tensor, *, cap: int):
    """Gather up to ``cap`` sorted positions per (read, slot).

    Returns int32 [B, n_slots, cap] positions (0 where masked) and the bool
    mask ``offs < count``.  Indices past the table clamp to its last entry,
    as the reference's clipped gather does.  Entries within a (hash,
    checksum) range are position-sorted by construction, matching the
    reference's introSortGI ordering (Sort.c)."""
    offs = torch.arange(cap, dtype=_i32, device=start.device)
    idx = torch.clamp(start[..., None] + offs, 0, entry_pos.shape[0] - 1)
    pos = entry_pos[idx.long()].to(_i32)
    mask = offs < count[..., None]
    return torch.where(mask, pos, 0), mask
