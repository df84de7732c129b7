"""Multi-device steps: data-parallel read sharding over torch.distributed,
one process per device.

Counterpart of ``circminer_tpu/parallel/mesh.py``.  JAX runs one program
over a device mesh (``shard_map``); here every rank is a process of its own
on a device of its own, holds its own block of rows, and exchanges tensors
through the collectives of a process group:

  =======================================  ====================================
  JAX                                      here
  =======================================  ====================================
  ``P("dp")`` input (``shard_reads``)      ``shard_reads``: this rank's
                                           contiguous block of rows
  ``P()`` input (``replicate``)            ``replicate``: the whole array on
                                           the rank's device
  ``lax.psum``                             ``psum``: ``all_reduce(SUM)``, int32
  ``lax.all_gather(..., tiled=True)``      ``all_gather``: gather, then
                                           concatenate along dim 0
  ``lax.axis_index``                       ``mesh.rank``
  ``lax.dynamic_slice_in_dim``             ``narrow``
  ``np.asarray`` of a sharded array        ``gather_rows``
  =======================================  ====================================

Backends are chosen by the caller, never swapped: NCCL where every rank has
a CUDA device of its own (``cuda:rank % device_count``), gloo on the CPU and
where ranks share one card (NCCL refuses two ranks on one device).  Under
gloo every collective moves its tensor through host memory (one copy each
way for a CUDA tensor): gloo's support for CUDA tensors differs by
collective and torch version, and host copies give all of them one
transport.  A world of one without a process group runs the collectives as
identities.

The genome index and the annotation tensors are replicated into every
rank's device memory (they fit for single-contig genomes); the entry table
can instead be bucket-range sharded (``shard_index``), each rank answering
the k-mers whose window hash it owns.  Every step returns the rank's own
rows, and per-row outputs equal the single-process step's on the same rows:
every stage is row-local, and the exchanged (pos, cnt, high) tensors are
exactly what the local lookup produces.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..device import resolve_device
from .distributed import INIT_TIMEOUT

BACKENDS = ("nccl", "gloo")
_i32 = torch.int32


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D device mesh: its process group (None for a
    world of one without a group), rank, world size and torch device."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    axis: str = "dp"

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)


def init_group(backend: str, init_method: str, world_size: int, rank: int,
               timeout: datetime.timedelta = INIT_TIMEOUT) -> None:
    """Join the default process group with ``backend``: "nccl" (each rank
    of this host on a CUDA device of its own, ``cuda:rank %
    device_count``) or "gloo".  A NCCL request that cannot be met raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    kw = {}
    if backend == "nccl":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0 or not dist.is_nccl_available():
            raise RuntimeError("backend 'nccl' needs CUDA devices and a "
                               "torch built with NCCL")
        if world_size > n:
            raise RuntimeError(
                f"backend 'nccl' needs a CUDA device per rank: {world_size} "
                f"ranks, {n} device(s); ranks that share a card take 'gloo'")
        kw["device_id"] = torch.device("cuda", rank % n)
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout, **kw)


def make_mesh(n_devices: int = None, axis: str = "dp", device=None) -> Mesh:
    """The mesh of this process: the default process group when one is
    initialized (its world size must equal ``n_devices``), else a world of
    one.  ``device`` defaults to ``cuda:rank % device_count`` under NCCL and
    to "cuda" otherwise; pass "cpu" (or "cuda:0" for ranks sharing a card)
    explicitly."""
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != size:
            raise ValueError(f"make_mesh({n_devices}): the process group "
                             f"has {size} ranks")
        group = dist.group.WORLD
        nccl = dist.get_backend(group) == "nccl"
        if device is None:
            device = (torch.device("cuda", rank % torch.cuda.device_count())
                      if nccl else "cuda")
        dev = resolve_device(device)
        if nccl and dev.type != "cuda":
            raise ValueError("a NCCL mesh keeps its tensors on CUDA devices")
        return Mesh(group, rank, size, dev, axis)
    if (n_devices or 1) != 1:
        raise RuntimeError(f"make_mesh({n_devices}) needs a process group "
                           f"of {n_devices} ranks, one process per device "
                           "(init_group)")
    return Mesh(None, 0, 1, resolve_device(device or "cuda"), axis)


# ---- collectives ----------------------------------------------------------

def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` where the backend moves it: host memory
    under gloo, the tensor's own device under NCCL."""
    where = "cpu" if mesh.backend == "gloo" else t.device
    return t.detach().to(where, copy=True).contiguous()


def psum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``lax.psum`` over the mesh: the elementwise int32 sum of every
    rank's ``t``."""
    if t.dtype != _i32:
        raise TypeError(f"psum sums int32 tensors (as the reference's int32 "
                        f"psums), got {t.dtype}")
    if mesh.group is None:
        return t
    x = _staged(mesh, t)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x.to(t.device)


def all_gather(mesh: Mesh, t: torch.Tensor, tiled: bool = True
               ) -> torch.Tensor:
    """``lax.all_gather`` over the mesh: every rank's ``t`` in rank order,
    concatenated along dim 0 (``tiled``) or stacked on a new dim 0."""
    if mesh.group is None:
        return t if tiled else t[None]
    x = _staged(mesh, t)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return (torch.cat(parts) if tiled else torch.stack(parts)).to(t.device)


def gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The full array of a dp-sharded output on every rank (the analog of
    ``np.asarray`` on a sharded jax array)."""
    return all_gather(mesh, t, tiled=True)


# ---- placement ------------------------------------------------------------

def shard_reads(mesh: Mesh, arr) -> torch.Tensor:
    """This rank's contiguous block of rows of a global [B, ...] host array
    (numpy or tensor), on the rank's device; B must divide evenly."""
    a = torch.from_numpy(np.ascontiguousarray(arr)) \
        if isinstance(arr, np.ndarray) else arr
    if a.shape[0] % mesh.size:
        raise ValueError(f"{a.shape[0]} rows do not split evenly over "
                         f"{mesh.size} ranks")
    rows = a.shape[0] // mesh.size
    return a.narrow(0, mesh.rank * rows, rows).contiguous().to(mesh.device)


def replicate(mesh: Mesh, arr):
    """The whole array (numpy or tensor), or every tensor of an
    ``AnnoDevice`` / ``FinishAnnoDevice``, on the rank's device."""
    if arr is None:
        return None
    if isinstance(arr, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.device)
    if isinstance(arr, torch.Tensor):
        return arr.to(mesh.device)
    if dataclasses.is_dataclass(arr):
        return dataclasses.replace(arr, **{
            f.name: getattr(arr, f.name).to(mesh.device)
            for f in dataclasses.fields(arr)
            if isinstance(getattr(arr, f.name), torch.Tensor)})
    raise TypeError(f"cannot replicate a {type(arr).__name__}")


# ---- the sharded steps ----------------------------------------------------

def make_sharded_map_step(mesh: Mesh, cfg: Config, *, k: int, cs_len: int,
                          n_slots: int, seed_lim: int, seg_pad: int,
                          seed_cap: int):
    """Mapping device step of this rank's reads against the replicated
    index and annotation:

    fn(reads, lens, entry_hv, entry_checksum, entry_pos, nb_bits, iv_spos,
    iv_epos, iv_max_end, iv_min_end, iv_max_next, iv_nseg, seg_end,
    seg_next) -> (dp10, back, seed positions, high-hit counts) of the
    rank's rows, plus the all-reduced total seed count (the collective path
    the BSJ merge uses)."""
    from ..ops.chain_device import chain_batch_device
    from ..ops.seed import gather_seeds_device, lookup_batch_device

    NL = (cfg.max_read_len + k - 1) // k

    def step(reads, lens, entry_hv, entry_checksum, entry_pos,
             nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
             iv_max_next, iv_nseg, seg_end, seg_next):
        qpos_d, start_d, cnt_d, hh_d = lookup_batch_device(
            reads, lens, entry_hv, entry_checksum,
            k=k, cs_len=cs_len, n_slots=n_slots, seed_lim=seed_lim)
        cnt_c = cnt_d[:, 0:2 * NL:2]
        qpos_c = torch.clamp(qpos_d[:, 0:2 * NL:2], min=0)
        start_c = start_d[:, 0:2 * NL:2]
        pos_b, _ = gather_seeds_device(entry_pos, start_c, cnt_c,
                                       cap=seed_cap)
        dp10, back = chain_batch_device(
            pos_b, cnt_c, qpos_c, lens,
            nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
            iv_max_next, iv_nseg, seg_end, seg_next,
            k=k, max_ed=cfg.max_ed, max_intron=cfg.max_intron,
            seg_pad=seg_pad)
        total = psum(mesh, cnt_c.sum(dtype=_i32))
        return dp10, back, pos_b, hh_d.sum(dim=1, dtype=_i32), total

    return step


def make_sharded_full_step(mesh: Mesh, statics: dict, *, contig_num: int = 0,
                           prefix_shift: int = 0, prefix_iters: int = 0):
    """The complete fused device-full map step (lookup -> chain DP ->
    k-best -> pairing -> extension pools -> category lattice) on this
    rank's reads and incoming MatchedRead state, against the replicated
    index, genome and annotations:

    fn(seqs, lens, mr_in, entry_hv, entry_checksum, entry_pos, genome, ad,
    fa, entry_prefix) -> int32 [pairs, MRF + 1] blob of the rank's pairs.
    With the single-process statics a rank sees fewer rows, so no pool can
    overflow where the single-process step's does not: the blob is
    bit-equal."""
    from ..ops.device_full import device_full_step

    def step(seqs, lens, mr_in, entry_hv, entry_checksum, entry_pos,
             genome, ad, fa, entry_prefix):
        return device_full_step(
            seqs, lens, mr_in, entry_hv, entry_checksum, entry_pos, genome,
            ad, fa, entry_prefix, contig_num=contig_num,
            prefix_shift=prefix_shift, prefix_iters=prefix_iters, **statics)

    return step


def make_index_sharded_full_step(mesh: Mesh, statics: dict, *,
                                 shard_batch: int, contig_num: int = 0):
    """The complete fused step with the entry table bucket-range sharded
    over the mesh: each rank all-gathers the query batch, answers the
    k-mers whose window hash falls in its bucket range
    (``ops.seed.lookup_gather_sharded_local``), the contributions are
    all-reduced, and each rank runs the whole finish
    (``ops.device_full.full_from_seeds``) on its own rows.

    ``shard_batch`` = pairs per rank.  fn(seqs, lens, mr_in, hv_sh, cs_sh,
    pos_sh, blo, bhi, genome, ad, fa) -> int32 [shard_batch, MRF + 1] blob
    of the rank's pairs (``shard_index`` gives the index arguments)."""
    from ..ops.device_full import full_from_seeds
    from ..ops.seed import lookup_gather_sharded_local

    st = dict(statics)
    for key in ("cs_len", "n_slots", "seed_lim", "prefix_shift",
                "prefix_iters"):
        st.pop(key, None)
    cs_len = statics["cs_len"]
    n_slots = statics["n_slots"]
    seed_lim = statics["seed_lim"]
    rows = 4 * shard_batch

    def step(seqs, lens, mr_in, lhv, lcs, lpos, blo, bhi, genome, ad, fa):
        seqs_g = all_gather(mesh, seqs)
        lens_g = all_gather(mesh, lens)
        _, pos, cnt, high = lookup_gather_sharded_local(
            seqs_g, lens_g, lhv, lcs, lpos, blo, bhi, k=st["k"],
            cs_len=cs_len, n_slots=n_slots, seed_lim=seed_lim, cap=st["cap"])
        pos, cnt, high = (psum(mesh, x) for x in (pos, cnt, high))

        def sl(a):
            return a.narrow(0, mesh.rank * rows, rows)

        hh_row = sl(high).sum(dim=1, dtype=_i32)
        return full_from_seeds(
            sl(seqs_g), sl(lens_g), mr_in, sl(pos), sl(cnt), hh_row,
            genome, ad, fa, contig_num=contig_num, **st)

    return step


def shard_index_arrays(ci, n_shards: int, window_size: int = 14):
    """Split a ContigIndex's bucket space into ``n_shards`` contiguous
    ranges for HBM sharding (SURVEY §5: the full-GRCh38 index payload
    exceeds one chip's HBM; shard hash buckets across chips).

    Returns numpy arrays stackable on a leading shard axis:
      hv_sh       int32 [D, E_max]  (window hash per local entry; padding
                                     slots hold an out-of-range sentinel)
      checksum_sh int16 [D, E_max]
      pos_sh      int32 [D, E_max]
      bucket_lo   int32 [D]         (first global bucket owned)
      bucket_hi   int32 [D]         (one past the last bucket owned)
    """
    nb = 1 << (2 * window_size)
    nbd = -(-nb // n_shards)  # ceil
    HV_SENTINEL = np.int32(2 ** 30)  # > any real 28-bit window hash
    slices = []
    e_max = 1
    for d in range(n_shards):
        lo_b = min(d * nbd, nb)
        hi_b = min(lo_b + nbd, nb)
        e_lo = int(np.searchsorted(ci.entry_hv, lo_b, side="left"))
        e_hi = int(np.searchsorted(ci.entry_hv, hi_b, side="left"))
        slices.append((ci.entry_hv[e_lo:e_hi], ci.entry_checksum[e_lo:e_hi],
                       ci.entry_pos[e_lo:e_hi], lo_b, hi_b))
        e_max = max(e_max, e_hi - e_lo)

    D = n_shards
    hv_sh = np.full((D, e_max), HV_SENTINEL, np.int32)
    checksum_sh = np.zeros((D, e_max), np.int16)
    pos_sh = np.zeros((D, e_max), np.int32)
    for d, (hv, cs, ps, _, _) in enumerate(slices):
        hv_sh[d, :hv.shape[0]] = hv
        checksum_sh[d, :cs.shape[0]] = cs
        pos_sh[d, :ps.shape[0]] = ps
    bucket_lo = np.array([s[3] for s in slices], np.int32)
    bucket_hi = np.array([s[4] for s in slices], np.int32)
    return hv_sh, checksum_sh, pos_sh, bucket_lo, bucket_hi


def make_index_sharded_map_step(mesh: Mesh, cfg: Config, *, k: int,
                                cs_len: int, n_slots: int, seed_lim: int,
                                seg_pad: int, seed_cap: int,
                                shard_batch: int):
    """Mapping step with both the reads and the k-mer index sharded over
    the mesh: queries are all-gathered, each rank answers the k-mers whose
    window hash falls in its bucket range, the contributions are
    all-reduced, and each rank chains its own ``shard_batch`` rows against
    the replicated annotation.

    fn(reads, lens, hv_sh, cs_sh, pos_sh, blo, bhi, nb_bits, iv_spos,
    iv_epos, iv_max_end, iv_min_end, iv_max_next, iv_nseg, seg_end,
    seg_next) -> (dp10, back, pos, cnt, high-hit counts) of the rank's
    rows."""
    from ..ops.chain_device import chain_batch_device
    from ..ops.seed import lookup_gather_sharded_local

    def step(reads, lens, lhv, lcs, lpos, blo, bhi,
             nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
             iv_max_next, iv_nseg, seg_end, seg_next):
        reads_g = all_gather(mesh, reads)
        lens_g = all_gather(mesh, lens)
        qpos, pos, cnt, high = lookup_gather_sharded_local(
            reads_g, lens_g, lhv, lcs, lpos, blo, bhi,
            k=k, cs_len=cs_len, n_slots=n_slots, seed_lim=seed_lim,
            cap=seed_cap)
        # owner-computes + all-reduce = the all-to-all result exchange
        pos, cnt, high = (psum(mesh, x) for x in (pos, cnt, high))

        def sl(a):
            return a.narrow(0, mesh.rank * shard_batch, shard_batch)

        pos_m, cnt_m, qpos_m, lens_m = sl(pos), sl(cnt), sl(qpos), \
            sl(lens_g)
        dp10, back = chain_batch_device(
            pos_m, cnt_m, torch.clamp(qpos_m, min=0), lens_m,
            nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
            iv_max_next, iv_nseg, seg_end, seg_next,
            k=k, max_ed=cfg.max_ed, max_intron=cfg.max_intron,
            seg_pad=seg_pad)
        return dp10, back, pos_m, cnt_m, sl(high).sum(dim=1, dtype=_i32)

    return step


def shard_index(mesh: Mesh, ci, axis: str = "dp", window_size: int = 14):
    """This rank's row of each ``shard_index_arrays`` array on its device:
    (hv [E_max], checksum [E_max], pos [E_max], bucket_lo, bucket_hi)."""
    arrs = shard_index_arrays(ci, mesh.size, window_size)
    return tuple(torch.from_numpy(np.array(a[mesh.rank])).to(mesh.device)
                 for a in arrs)


def merge_bsj_candidates(mesh: Mesh, cand: torch.Tensor,
                         count: torch.Tensor) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """All-gather every rank's [cap, 2] (spos, epos) candidate array and
    its candidate count, so every rank sees [D, cap, 2] and [D]; the final
    grouping and sort happen on rank 0 (replaces the reference's
    single-process GNU sort, process_circ.cpp:179-193)."""
    return (all_gather(mesh, cand, tiled=False),
            all_gather(mesh, count.reshape(1)))
