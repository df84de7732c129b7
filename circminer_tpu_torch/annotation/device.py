"""Device-resident annotation tensors (torch) for the chain DP gates and the
fused mapping finish.

Counterpart of ``circminer_tpu/annotation/device.py``.  The chain DP needs
three annotation queries per seed cell (gene_annotation.h:123-133,
chain.cpp:28-64): the near_border bit at the seed position, the disjoint
exon interval containing it (with max/min end aggregates), and that
interval's segment list (end, next_exon_beg) for the junction checks.  The
fused finish (``ops/device_full.py``) also needs the per-interval
transcript lists, segment attributes, gene spans, the intronic bitmask,
trans2seg and the contig -> chromosome shift table.

All are fixed-shape tensors: packed uint8 bitmasks, sorted int32 interval
bounds for vectorized bisection, and segment lists padded to ``seg_pad``
per interval.  The numpy construction is the reference's; only the final
transfer differs (``torch.from_numpy(...).to(device)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .annotation import ContigAnnotation

_I32MAX = 2 ** 31 - 1


def _put(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _clip_i32(a) -> np.ndarray:
    return np.asarray(a, np.int64).clip(0, _I32MAX).astype(np.int32)


@dataclasses.dataclass
class AnnoDevice:
    nb_bits: torch.Tensor     # uint8 packed near_border bitmask
    iv_spos: torch.Tensor     # int32 [NIV]
    iv_epos: torch.Tensor
    iv_max_end: torch.Tensor
    iv_min_end: torch.Tensor
    iv_max_next: torch.Tensor
    iv_nseg: torch.Tensor     # int32 [NIV] seg count, clipped to seg_pad
    seg_end: torch.Tensor     # int32 [NIV, seg_pad]
    seg_next: torch.Tensor    # int32 [NIV, seg_pad]
    seg_pad: int
    overflowed: bool          # some interval had more segs than seg_pad

    @classmethod
    def from_contig(cls, ca: ContigAnnotation, seg_pad: int = 16, *,
                    device) -> "AnnoDevice":
        n_iv = ca.n_intervals
        nseg = (ca.iv_seg_off[1:] - ca.iv_seg_off[:-1]).astype(np.int32)
        overflow = bool((nseg > seg_pad).any())
        seg_end = np.zeros((n_iv, seg_pad), dtype=np.int32)
        seg_next = np.zeros((n_iv, seg_pad), dtype=np.int32)
        for iv in range(n_iv):
            a = int(ca.iv_seg_off[iv])
            m = min(int(nseg[iv]), seg_pad)
            seg_end[iv, :m] = ca.seg_end[a:a + m]
            seg_next[iv, :m] = ca.seg_next[a:a + m]
        return cls(
            nb_bits=_put(ca.near_border.bits, device),
            iv_spos=_put(_clip_i32(ca.iv_spos), device),
            iv_epos=_put(_clip_i32(ca.iv_epos), device),
            iv_max_end=_put(_clip_i32(ca.iv_max_end), device),
            iv_min_end=_put(_clip_i32(ca.iv_min_end), device),
            iv_max_next=_put(_clip_i32(ca.iv_max_next), device),
            iv_nseg=_put(np.minimum(nseg, seg_pad), device),
            seg_end=_put(seg_end, device),
            seg_next=_put(seg_next, device),
            seg_pad=seg_pad,
            overflowed=overflow,
        )


def near_border_bit(nb_bits: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Vectorized near_border lookup (pos 1-based int32) -> bool."""
    p = torch.clamp(pos, 0, nb_bits.shape[0] * 8 - 1)
    byte = nb_bits[(p >> 3).long()].to(torch.int32)
    return ((byte >> (p & 7)) & 1).bool()


@dataclasses.dataclass
class FinishAnnoDevice:
    """Extra device-resident annotation for the fused mapping finish
    (ops/device_full.py): pair gating, category lattice and tlen walks.

    Shapes mirror the host accessors exactly so the fold logic can
    reproduce utils.cpp:53-320 enumeration order:
      - iv_tids:   per interval, seg-major transcript list with duplicates
                   (AnnotationDB.interval_tids order), -1 padded,
      - seg_*_p:   per interval padded segment attributes (iv_seg_off CSR
                   flattened like AnnoDevice.seg_end),
      - t2s:       trans2seg CSR (flat uint8 states + int32 offsets),
      - shifts:    contig->chromosome shift table (io/fasta.get_shift).
    """
    iv_tids: torch.Tensor       # int32 [NIV, ST_PAD], -1 pad
    iv_ntid: torch.Tensor       # int32 [NIV] true count (may exceed ST_PAD)
    iv_nseg_true: torch.Tensor  # int32 [NIV] unclipped seg count
    seg_start_p: torch.Tensor   # int32 [NIV, seg_pad]
    seg_gene_p: torch.Tensor    # int32 [NIV, seg_pad]
    gene_start: torch.Tensor    # int32 [NG]
    gene_end: torch.Tensor      # int32 [NG]
    intr_bits: torch.Tensor     # uint8 packed intronic bitmask
    trans_start: torch.Tensor   # int32 [NT]
    t2s_off: torch.Tensor       # int32 [NT + 1]
    t2s_state: torch.Tensor     # uint8 flat
    shift_bounds: torch.Tensor  # int32 [NS] ascending shift boundaries
    shift_vals: torch.Tensor    # int32 [NS] shift to subtract
    st_pad: int

    @classmethod
    def from_contig(cls, ca: ContigAnnotation, con2chr_list,
                    seg_pad: int = 16, st_pad: int = 16, *,
                    device) -> "FinishAnnoDevice":
        n_iv = ca.n_intervals
        iv_tids = np.full((n_iv, st_pad), -1, dtype=np.int32)
        iv_ntid = np.zeros(n_iv, dtype=np.int32)
        seg_start_p = np.zeros((n_iv, seg_pad), dtype=np.int32)
        seg_gene_p = np.full((n_iv, seg_pad), -1, dtype=np.int32)
        for iv in range(n_iv):
            a, b = int(ca.iv_seg_off[iv]), int(ca.iv_seg_off[iv + 1])
            m = min(b - a, seg_pad)
            seg_start_p[iv, :m] = ca.seg_start[a:a + m]
            seg_gene_p[iv, :m] = ca.seg_gene[a:a + m]
            tids = []
            for e in range(a, b):
                u = int(ca.seg_uid[e])
                if u >= 0:
                    tids.extend(ca.uid_tid[ca.uid_tid_off[u]:
                                           ca.uid_tid_off[u + 1]])
            iv_ntid[iv] = len(tids)
            iv_tids[iv, :min(len(tids), st_pad)] = tids[:st_pad]
        nseg_true = (ca.iv_seg_off[1:] - ca.iv_seg_off[:-1]).astype(np.int32)
        shifts = _clip_i32([cs.shift for cs in con2chr_list])
        return cls(
            iv_tids=_put(iv_tids, device),
            iv_ntid=_put(iv_ntid, device),
            iv_nseg_true=_put(nseg_true, device),
            seg_start_p=_put(seg_start_p, device),
            seg_gene_p=_put(seg_gene_p, device),
            gene_start=_put(_clip_i32(ca.gene_start), device),
            gene_end=_put(_clip_i32(ca.gene_end), device),
            intr_bits=_put(ca.intronic.bits, device),
            trans_start=_put(ca.trans_start_ind.astype(np.int32), device),
            t2s_off=_put(ca.t2s_off.astype(np.int32), device),
            t2s_state=_put(ca.t2s_state, device),
            shift_bounds=_put(shifts, device),
            shift_vals=_put(shifts.copy(), device),
            st_pad=st_pad,
        )
