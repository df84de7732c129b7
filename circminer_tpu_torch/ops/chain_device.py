"""Batched seed-chaining DP on the torch device (the device half of the
reference's ``circminer_tpu/ops/chain.py``, lines 206-472 and 538-557).

The host half of that module (``Chain``, ``extract_kbest``, ...) is the
port's jax-free copy in ``ops/chain.py``, pinned source-identical to the
reference; this module holds the dense device formulation:

  * ``chain_cells`` (its plain version ``_chain_cells``, the
    ``chain_cells`` kernel of csrc/chain_cells.cu on a CUDA tensor): per
    seed cell, the reference's upper bound (the
    near_border bit, the exon interval containing the seed and its end
    aggregates, gene_annotation.h:123-133) and that interval (``ol_iv``,
    or -1), whose junction segments the transitions read;
    ``_junction_tables`` gathers them by interval into the reference's
    [M, P, b] tables (segment ends, next-exon starts, and which are set),
    and ``_chain_prelude``, the two in turn, is the reference's prelude;
    each in two forms, bit-equal to each other: padded row gathers
    (``seg_compact=False``), or one column at a time (``seg_compact=True``,
    the reference's low-memory form for very large entry tables);
  * ``_chain_dp_core_lanes``: the transition DP over lists (chain.cpp:73-301)
    with the gap, maxIntron and junction gates (chain.cpp:28-64), keeping
    the first maximum as the backpointer: with the tables, the plain
    version (``_chain_dp_plain``) of the ``chain_dp`` kernel
    (csrc/chain_dp.cu), which ``chain_dp`` launches on a CUDA tensor and
    which reads the segments by interval, so that the card path builds no
    [M, P, b] table;
  * ``chain_batch_device`` = ``chain_cells`` + ``chain_dp``;
    ``gather_and_chain_device`` = seed gather + chain DP.

Scores are int32 in 0.1 units (score10 = 10 * score): alpha10 = 2e5 * k per
link, beta10 = |dist_t - dist_r|.  Tensors of the core keep the row
dimension b last ([S, b], [S, S, b]) as the reference does.  The reference
lowers the core through XLA (a Pallas kernel until its round 4).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..annotation.device import near_border_bit
from . import _ext
from .seed import gather_seeds_device

_i32 = torch.int32
_NEG = -(2 ** 29)
_I32MAX = 2 ** 31 - 1


def chain_batch_device(pos, cnt, qpos, seq_len,
                       nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
                       iv_max_next, iv_nseg, seg_end, seg_next,
                       *, k: int, max_ed: int, max_intron: int, seg_pad: int,
                       seg_compact: bool = False):
    """Batched chain DP.

    pos:  int32 [B, NL, S] seed positions (ascending per list, 0 pad)
    cnt:  int32 [B, NL]    per-list seed counts
    qpos: int32 [B, NL]    per-list query offsets (0-based)
    seq_len: int32 [B]

    Annotation tensors come from AnnoDevice.  Returns (dp10, back): int32
    [B, NL, S] final scores and flat backpointers into NL*S (or -1)."""
    B, NL, S = pos.shape
    with record_function("cm.chain_prelude"):
        cells = chain_cells(pos, cnt, qpos, seq_len, nb_bits, iv_spos,
                            iv_epos, iv_max_end, iv_min_end, iv_max_next,
                            iv_nseg, seg_end, seg_next, k=k, max_ed=max_ed,
                            seg_pad=seg_pad, seg_compact=seg_compact)
    with record_function("cm.chain_dp"):
        return chain_dp(*cells, iv_nseg, seg_end, seg_next, NL=NL, S=S, k=k,
                        max_ed=max_ed, max_intron=max_intron,
                        seg_compact=seg_compact)


def chain_dp(posf, qposf, validf, ub, mee, e1, ol_iv, iv_nseg, seg_end,
             seg_next, *, NL: int, S: int, k: int, max_ed: int,
             max_intron: int, seg_compact: bool = False):
    """The chain DP of the cells (``_chain_cells``) and the annotation's
    junction tables: (dp10, back) int32 [b, NL, S].  A cell with ``ol_iv
    >= 0`` reads the segments of that interval.  On a CPU tensor its plain
    version: the [M, P, b] tables gathered by ``_junction_tables``, then
    ``_chain_dp_core_lanes``; on a CUDA tensor the ``chain_dp`` kernel,
    which reads ``iv_nseg`` / ``seg_end`` / ``seg_next`` in place, or a
    raise (the kernel refuses rows whose lists outgrow a block's shared
    memory)."""
    if not posf.is_cuda:
        return _chain_dp_plain(posf, qposf, validf, ub, mee, e1, ol_iv,
                               iv_nseg, seg_end, seg_next, NL=NL, S=S, k=k,
                               max_ed=max_ed, max_intron=max_intron,
                               seg_compact=seg_compact)
    b = posf.shape[0]
    dp = torch.empty((b, NL, S), dtype=_i32, device=posf.device)
    back = torch.empty_like(dp)
    if b == 0 or NL * S == 0:
        return dp, back
    _ext.launch_tensors(
        "chain_dp", chain_dp_args(posf, qposf, validf, ub, mee, e1, ol_iv,
                                  iv_nseg, seg_end, seg_next, dp, back,
                                  NL=NL, S=S),
        (b, NL, S, seg_end.shape[1], k, max_ed, max_intron))
    return dp, back


def _chain_dp_plain(posf, qposf, validf, ub, mee, e1, ol_iv, iv_nseg,
                    seg_end, seg_next, *, NL: int, S: int, k: int,
                    max_ed: int, max_intron: int, seg_compact: bool = False):
    """The plain version of ``chain_dp``, on any device: the junction
    tables gathered (``_junction_tables``), ``_chain_dp_core_lanes``, its
    per-list [S, b] pieces stacked into [b, NL, S]."""
    tables = _junction_tables(ol_iv, iv_nseg, seg_end, seg_next,
                              seg_end.shape[1], seg_compact)
    dpl, bkl = _chain_dp_core_lanes(posf, qposf, validf, ub, mee, e1,
                                    *tables, NL=NL, S=S, k=k, max_ed=max_ed,
                                    max_intron=max_intron)
    dp = torch.stack(dpl, dim=0).permute(2, 0, 1).contiguous()
    back = torch.stack(bkl, dim=0).permute(2, 0, 1).contiguous()
    return dp, back


def chain_dp_args(posf, qposf, validf, ub, mee, e1, ol_iv, iv_nseg, seg_end,
                  seg_next, dp, back, *, NL: int, S: int):
    """The (tensor, dtype, shape) arguments of the ``chain_dp`` kernel, in
    its order: the [b, M] cells, the annotation's [n_iv] segment counts and
    [n_iv, P] segment tables as they are (nothing is copied), the [b, NL,
    S] outputs."""
    b, M = posf.shape[0], NL * S
    n_iv, P = seg_end.shape
    rows = [(x, _i32, (b, M)) for x in (posf, qposf)]
    rows += [(validf, torch.bool, (b, M))]
    rows += [(x, _i32, (b, M)) for x in (ub, mee, e1, ol_iv)]
    rows += [(iv_nseg, _i32, (n_iv,))]
    rows += [(x, _i32, (n_iv, P)) for x in (seg_end, seg_next)]
    return rows + [(x, _i32, (b, NL, S)) for x in (dp, back)]


def _chain_dp_core_lanes(posf, qposf, validf, ub, mee, e1, sep_c, snp_c,
                         pv_c, *, NL: int, S: int, k: int, max_ed: int,
                         max_intron: int):
    """Transition DP, lists from last to first.  Every tensor carries the
    row dimension b last ([S, b], [S, S, b], [S, P, b]); sep/snp/pv arrive
    as [M, P, b] from the prelude.  Returns per-list [S, b] scores and flat
    backpointers."""
    b = posf.shape[0]
    dev = posf.device
    P = sep_c.shape[1]
    alpha10 = 200000 * k
    pos_T, v_T, ub_T = posf.T, validf.T, ub.T
    mee_T, e1_T = mee.T, e1.T

    def seg(a, l):
        return a[l * S:(l + 1) * S]

    dpl = [torch.where(seg(v_T, l), 10 * k, _NEG).to(_i32) for l in range(NL)]
    bkl = [torch.full((S, b), -1, dtype=_i32, device=dev) for _ in range(NL)]
    tio = torch.arange(S, dtype=_i32, device=dev)[None, :, None]

    for l in range(NL - 2, -1, -1):
        pi = seg(pos_T, l)[:, None, :]               # [S, 1, b]
        ub_l = seg(ub_T, l)[:, None, :]
        mee_l = seg(mee_T, l)[:, None, :]
        e1_l = seg(e1_T, l)[:, None, :]
        v_l = seg(v_T, l)[:, None, :]
        sep_l, snp_l, pv_l = seg(sep_c, l), seg(snp_c, l), seg(pv_c, l)
        qp_l = qposf[:, l * S][None, None, :]        # per-list constant

        best_v = torch.full((S, b), _NEG, dtype=_i32, device=dev)
        best_i = torch.full((S, b), -1, dtype=_i32, device=dev)
        for j in range(l + 1, NL):
            pjv = seg(pos_T, j)[None, :, :]          # [1, St, b]
            v_j = seg(v_T, j)[None, :, :]
            qp_j = qposf[:, j * S][None, None, :]
            rd = qp_j - qp_l - k                     # [1, 1, b]
            # maxIntron rule (chain.cpp:148-150)
            minpos = torch.where(pjv > pi, pjv, _I32MAX).amin(dim=1,
                                                              keepdim=True)
            base = (v_l & (minpos <= pi + max_intron) & v_j
                    & (pjv > pi) & (pjv <= ub_l))    # [S, St, b]
            ge_allowed = (mee_l == 0) | ((pjv + k - 1) <= mee_l)
            gd = pjv - pi - k
            g_ok = ge_allowed & ((gd - rd).abs() <= max_ed)

            # junction gate (chain.cpp:28-64) over the pre-gathered segs
            jn_ok = torch.zeros((S, S, b), dtype=torch.bool, device=dev)
            jn_dist = torch.zeros((S, S, b), dtype=_i32, device=dev)
            intron_any = jn_ok
            for p in range(P):
                sep3 = sep_l[:, p:p + 1, :]          # [S, 1, b]
                snp3 = snp_l[:, p:p + 1, :]
                pv3 = pv_l[:, p:p + 1, :]
                e12end3 = sep3 - e1_l
                beg2s2 = pjv - snp3                  # [S, St, b]
                td = e12end3 + beg2s2
                pv_e = pv3 & (e12end3 >= 0)
                acc = pv_e & (beg2s2 >= 0) & ((td - rd).abs() <= max_ed)
                jn_dist = torch.where(~jn_ok & acc, td, jn_dist)
                jn_ok = jn_ok | acc
                intron_any = intron_any | (pv_e & (e12end3 < rd)
                                           & ((beg2s2 + k) < 0))
            j_ok = (pjv > e1_l) & (jn_ok | intron_any)
            j_dist = torch.where(jn_ok, jn_dist, pjv - e1_l - 1)
            ok = base & (g_ok | j_ok)
            distt = torch.where(g_ok, gd, j_dist)
            sc = torch.where(ok, alpha10 - (distt - rd).abs(), _NEG)

            cand = sc + dpl[j][None, :, :]           # [S, St, b]
            cv = cand.amax(dim=1)                    # [S, b]
            # first maximum: the earliest flat index among equal maxima
            ci = torch.where(cand == cv[:, None, :], tio, S).amin(dim=1) \
                + j * S
            upd = cv > best_v
            best_i = torch.where(upd, ci, best_i)
            best_v = torch.where(upd, cv, best_v)

        improve = best_v > dpl[l]
        dpl[l] = torch.where(improve, best_v, dpl[l])
        bkl[l] = torch.where(improve, best_i, bkl[l])
    return dpl, bkl


def _chain_prelude(pos, cnt, qpos, seq_len,
                   nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
                   iv_max_next, iv_nseg, seg_end, seg_next,
                   *, k: int, max_ed: int, seg_pad: int,
                   seg_compact: bool = False):
    """Per-cell upper bounds + pre-gathered junction tables (the
    annotation-dependent half of the chain DP), the reference's
    ``_chain_prelude``: ``_chain_cells``, then ``_junction_tables`` in
    place of the cells' intervals."""
    *cells, ol_iv = _chain_cells(
        pos, cnt, qpos, seq_len, nb_bits, iv_spos, iv_epos, iv_max_end,
        iv_min_end, iv_max_next, iv_nseg, seg_end, seg_next, k=k,
        max_ed=max_ed, seg_pad=seg_pad, seg_compact=seg_compact)
    return (*cells, *_junction_tables(ol_iv, iv_nseg, seg_end, seg_next,
                                      seg_pad, seg_compact))


def chain_cells(pos, cnt, qpos, seq_len,
                nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
                iv_max_next, iv_nseg, seg_end, seg_next,
                *, k: int, max_ed: int, seg_pad: int,
                seg_compact: bool = False):
    """The chain DP's cells, [B, M] each: (posf, qposf, validf, ub, mee,
    e1, ol_iv).  On a CPU tensor the plain version ``_chain_cells`` (its
    two ``seg_compact`` forms); on a CUDA tensor the ``chain_cells`` kernel,
    one launch for both forms (it reads each cell's segments in place), or
    a raise (no interval, no bitmap, or ``seg_pad`` above the tables'
    width).  posf is a view of ``pos``."""
    if not pos.is_cuda:
        return _chain_cells(pos, cnt, qpos, seq_len, nb_bits, iv_spos,
                            iv_epos, iv_max_end, iv_min_end, iv_max_next,
                            iv_nseg, seg_end, seg_next, k=k, max_ed=max_ed,
                            seg_pad=seg_pad, seg_compact=seg_compact)
    B, NL, S = pos.shape
    n_iv, P = seg_end.shape
    if n_iv == 0 or nb_bits.numel() == 0 or seg_pad > P:
        raise ValueError(f"chain_cells needs an interval, a bitmap byte and "
                         f"seg_pad <= P: n_iv {n_iv}, {nb_bits.numel()} "
                         f"bytes, seg_pad {seg_pad}, P {P}")
    # the mesh's steps pass strided per-list views
    pos, cnt, qpos, seq_len = (x.contiguous()
                               for x in (pos, cnt, qpos, seq_len))
    dev = pos.device
    qposf, ub, mee, e1, ol_iv = (
        torch.empty((B, NL * S), dtype=_i32, device=dev) for _ in range(5))
    validf = torch.empty((B, NL * S), dtype=torch.bool, device=dev)
    if B * NL * S:
        _ext.launch_tensors(
            "chain_cells", chain_cells_args(
                pos, cnt, qpos, seq_len, nb_bits, iv_spos, iv_epos,
                iv_max_end, iv_min_end, iv_max_next, iv_nseg, seg_end,
                seg_next, qposf, validf, ub, mee, e1, ol_iv),
            (B, NL, S, nb_bits.numel(), n_iv, P, seg_pad, k, max_ed))
    return pos.reshape(B, NL * S), qposf, validf, ub, mee, e1, ol_iv


def chain_cells_args(pos, cnt, qpos, seq_len, nb_bits, iv_spos, iv_epos,
                     iv_max_end, iv_min_end, iv_max_next, iv_nseg, seg_end,
                     seg_next, qposf, validf, ub, mee, e1, ol_iv):
    """The (tensor, dtype, shape) arguments of the ``chain_cells`` kernel,
    in its order: the chain's inputs, the annotation's bitmap and tables
    as they are, the [B, M] cells it writes."""
    B, NL, S = pos.shape
    n_iv, P = seg_end.shape
    rows = [(pos, _i32, (B, NL, S))]
    rows += [(x, _i32, (B, NL)) for x in (cnt, qpos)]
    rows += [(seq_len, _i32, (B,)), (nb_bits, torch.uint8, (nb_bits.numel(),))]
    rows += [(x, _i32, (n_iv,)) for x in (iv_spos, iv_epos, iv_max_end,
                                          iv_min_end, iv_max_next, iv_nseg)]
    rows += [(x, _i32, (n_iv, P)) for x in (seg_end, seg_next)]
    rows += [(qposf, _i32, (B, NL * S)), (validf, torch.bool, (B, NL * S))]
    return rows + [(x, _i32, (B, NL * S)) for x in (ub, mee, e1, ol_iv)]


def _chain_cells(pos, cnt, qpos, seq_len,
                 nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
                 iv_max_next, iv_nseg, seg_end, seg_next,
                 *, k: int, max_ed: int, seg_pad: int,
                 seg_compact: bool = False):
    """The plain version of ``chain_cells``, on any device: per-cell
    tensors of the chain DP, [B, M] each: (posf, qposf, validf, ub, mee,
    e1, ol_iv), ol_iv the cell's exon interval or -1 (its junction
    segments are that interval's)."""
    B, NL, S = pos.shape
    M = NL * S
    dev = pos.device
    n_iv = iv_spos.shape[0]

    posf = pos.reshape(B, M)
    slot_of = torch.arange(NL, device=dev).repeat_interleave(S)      # [M]
    idx_in_slot = torch.arange(S, dtype=_i32, device=dev).repeat(NL)
    validf = idx_in_slot[None, :] < cnt[:, slot_of]
    qposf = qpos[:, slot_of]                                          # [B, M]
    read_remain = seq_len[:, None] - qposf - k                        # [B, M]

    # ---- per-cell upper bound (gene_annotation.h:123-133, .cpp:464-533) ----
    nb = near_border_bit(nb_bits, posf)

    # interval bisect: iv_raw = (# intervals with spos <= pos) - 1
    lo = torch.zeros_like(posf)
    hi = torch.full_like(posf, n_iv)
    for _ in range(max(1, int(np.ceil(np.log2(max(2, n_iv + 1)))) + 1)):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = iv_spos[torch.clamp(mid, 0, n_iv - 1).long()] <= posf
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    iv_raw = lo - 1
    iv_c = torch.clamp(iv_raw, 0, n_iv - 1).long()
    found = (iv_raw >= 0) & (iv_epos[iv_c] >= posf) & (iv_nseg[iv_c] > 0)

    epos = posf + k - 1
    # intronic: bound by the next interval's start
    nxt = torch.clamp(iv_raw + 1, 0, n_iv - 1).long()
    has_nxt = (iv_raw + 1) < n_iv
    max_end_intr = torch.where(has_nxt, iv_spos[nxt] - 1, _I32MAX)
    ub_intr = torch.where(
        max_end_intr < epos, 0,
        torch.minimum(posf + read_remain + max_ed, max_end_intr - k + 1))

    # exonic: aggregates, recomputed over segs ending >= epos when the kmer
    # crosses the interval end; padded [B, M, P] row gathers, or one seg
    # column at a time (seg_compact: no [B, M, P] temporaries)
    if seg_compact:
        nseg_iv = iv_nseg[iv_c]
        max_end_rc = torch.zeros_like(epos)
        min_end_rc = torch.full_like(epos, 10 ** 9)
        max_next_rc = torch.zeros_like(epos)
        for p in range(seg_pad):
            se_p = seg_end[:, p][iv_c]
            sn_p = seg_next[:, p][iv_c]
            ok = (p < nseg_iv) & (se_p >= epos)
            max_end_rc = torch.maximum(max_end_rc, torch.where(ok, se_p, 0))
            min_end_rc = torch.minimum(min_end_rc,
                                       torch.where(ok, se_p, 10 ** 9))
            max_next_rc = torch.maximum(max_next_rc,
                                        torch.where(ok, sn_p, 0))
    else:
        se_iv = seg_end[iv_c]            # [B, M, P]
        sn_iv = seg_next[iv_c]
        pvalid = (torch.arange(seg_pad, device=dev)[None, None, :]
                  < iv_nseg[iv_c][..., None])
        sel = pvalid & (se_iv >= epos[..., None])
        max_end_rc = torch.where(sel, se_iv, 0).amax(dim=-1)
        min_end_rc = torch.where(sel, se_iv, 10 ** 9).amin(dim=-1)
        max_next_rc = torch.where(sel, sn_iv, 0).amax(dim=-1)
    need_rc = epos > iv_epos[iv_c]
    max_end = torch.where(need_rc, max_end_rc, iv_max_end[iv_c])
    min_end = torch.where(need_rc, min_end_rc, iv_min_end[iv_c])
    max_next = torch.where(need_rc, max_next_rc, iv_max_next[iv_c])

    exonic = (max_end > 0) & (max_end >= epos)
    ub_exon = torch.where((min_end < read_remain + epos) & (max_next != 0),
                          max_next + k - 1, max_end - k + 1)
    ub_found = torch.where(exonic, ub_exon, 0)
    mee_found = torch.where(exonic, max_end, 0)

    ub = torch.where(nb, torch.where(found, ub_found, ub_intr),
                     posf + read_remain + max_ed)
    # the intronic max_end is reported too; a crossing kmer gets ub 0,
    # which kills its transitions anyway
    mee = torch.where(nb, torch.where(found, mee_found, max_end_intr), 0)
    ol_iv = torch.where(nb & found & exonic, iv_c.to(_i32), -1)

    e1 = posf + k - 1
    return posf, qposf, validf, ub, mee, e1, ol_iv


def _junction_tables(ol_iv, iv_nseg, seg_end, seg_next, seg_pad: int,
                     seg_compact: bool = False):
    """The junction tables of the cells' intervals, as the reference's
    prelude gathers them: (sep, snp, pv), [M, P, b] views of [B, M, P]
    gathers (pv: segment p < the interval's count, for a cell with an
    interval); padded row gathers, or one column at a time
    (``seg_compact``)."""
    n_iv = seg_end.shape[0]
    dev = ol_iv.device
    has_iv = ol_iv >= 0
    iv_cc = torch.clamp(ol_iv, 0, n_iv - 1).long()
    nseg_cc = iv_nseg[iv_cc]                                     # [B, M]
    if seg_compact:
        sep = torch.stack([seg_end[:, p][iv_cc] for p in range(seg_pad)],
                          dim=-1)                                # [B, M, P]
        snp = torch.stack([seg_next[:, p][iv_cc] for p in range(seg_pad)],
                          dim=-1)
    else:
        sep, snp = seg_end[iv_cc], seg_next[iv_cc]               # [B, M, P]
    pv = (has_iv[:, :, None]
          & (torch.arange(seg_pad, dtype=_i32, device=dev)[None, None, :]
             < nseg_cc[:, :, None]))                             # [B, M, P]
    return tuple(x.permute(1, 2, 0) for x in (sep, snp, pv))


def gather_and_chain_device(entry_pos, start, cnt, qpos, seq_len,
                            nb_bits, iv_spos, iv_epos, iv_max_end,
                            iv_min_end, iv_max_next, iv_nseg, seg_end,
                            seg_next, *, cap: int, k: int, max_ed: int,
                            max_intron: int, seg_pad: int):
    """Seed gather + chain DP in one call.  Returns (pos, dp10, back)."""
    pos, _ = gather_seeds_device(entry_pos, start, cnt, cap=cap)
    dp10, back = chain_batch_device(
        pos, cnt, qpos, seq_len,
        nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
        iv_max_next, iv_nseg, seg_end, seg_next,
        k=k, max_ed=max_ed, max_intron=max_intron, seg_pad=seg_pad)
    return pos, dp10, back
