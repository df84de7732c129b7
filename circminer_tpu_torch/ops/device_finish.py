"""k-best chain extraction on the torch device (counterpart of
``circminer_tpu/ops/device_finish.py``).

The fused ``gpu-full`` step never brings chains to the host: this module
extracts them from the chain-DP tensors (dp10 | back) on the device, with
the semantics of the host extraction (``ops/chain.py::extract_kbest``, the
port of the reference's event-ordered backtrack, src/chain.cpp:234-298):

  * event cells = DP cells improved by a transition (back >= 0),
  * candidate order: score desc, list desc, index asc,
  * backtrack with repeat suppression: a candidate whose head position was
    already used as a NON-head fragment of an earlier chain is skipped,
    unless it carries the global best score,
  * cap of C chains; single-fragment fallback (lists desc, index asc)
    when no chain was emitted.

The loop is fixed-length (``iters`` event picks), so a row whose event list
is longer than ``iters`` and still unfinished sets ``incomplete``, and the
caller defers that row to the host pipeline.  Layout as in the reference:
after the sort the row dimension R is last ([T, R], [T, M, R], [C, T, R]).

``extract_kbest_device`` runs this plain version on a CPU tensor and the
``extract_kbest`` kernel (csrc/extract_kbest.cu: a warp a row on a
persistent grid, the sort as exact ranks of the unique keys, among a
row's event cells alone where their scores allow it, the walks through
the row staged in shared memory, the emission serial as here over
precomputed repeat masks) on a CUDA tensor.
"""

from __future__ import annotations

import torch

from . import _ext

_i32 = torch.int32
_NEG = -(2 ** 29)


# shared memory a row of the extract_kbest kernel must have, within the
# block's opted-in EX_SMEM_MAX (its words, csrc/extract_kbest.cu::ex_words:
# 64-bit keys [M], 64-bit blocking masks [iters] where iters <= 64, walk
# cells [iters, NL], lengths, scores and head positions [iters], emitted
# picks [C], rounded up to even; the row's back pointers and positions come
# on top where they fit, else the walks read device memory)
EX_SMEM_MAX = 232448


def extract_row_bytes(NL: int, S: int, C: int, iters: int) -> int:
    words = 2 * NL * S + 2 * iters * (iters <= 64) + iters * NL \
        + 3 * iters + C
    return 4 * (words + words % 2)


def extract_kbest_device(dp10, back, pos, qpos, cnt, *, k: int, C: int,
                         iters: int = 48):
    """dp10/back/pos int32 [R, NL, S], qpos/cnt int32 [R, NL].

    Returns (rpos [R,C,NL], qp [R,C,NL], clen [R,C], sc10 [R,C], cn [R],
    incomplete [R] bool), the layout of NativeChainer.extract_batch
    (scores as int32 score10).  On a CPU tensor the plain version
    (``extract_kbest_device_staged``, ``upto="full"``); on a CUDA tensor
    the ``extract_kbest`` kernel (csrc/extract_kbest.cu), or a raise where
    M = NL * S < iters or a row outgrows the kernel's shared memory."""
    if not dp10.is_cuda:
        return extract_kbest_device_staged(dp10, back, pos, qpos, cnt, k=k,
                                           C=C, iters=iters, upto="full")
    R, NL, S = dp10.shape
    if NL * S < iters or extract_row_bytes(NL, S, C, iters) > EX_SMEM_MAX:
        raise ValueError(f"extract_kbest takes iters <= M and at most "
                         f"{EX_SMEM_MAX} B of shared memory a row: M = "
                         f"{NL * S}, iters {iters}, C {C}, "
                         f"{extract_row_bytes(NL, S, C, iters)} B")
    dev = dp10.device
    pos, qpos, cnt = (x.contiguous() for x in (pos, qpos, cnt))
    rpos = torch.empty((R, C, NL), dtype=_i32, device=dev)
    qp = torch.empty_like(rpos)
    clen = torch.empty((R, C), dtype=_i32, device=dev)
    sc10 = torch.empty_like(clen)
    cn = torch.empty((R,), dtype=_i32, device=dev)
    incomplete = torch.empty((R,), dtype=torch.bool, device=dev)
    out = (rpos, qp, clen, sc10, cn, incomplete)
    if R:
        _ext.launch_tensors(
            "extract_kbest", extract_kbest_args(dp10, back, pos, qpos, cnt,
                                                *out, C=C),
            (R, NL, S, C, iters))
    return out


def extract_kbest_args(dp10, back, pos, qpos, cnt, rpos, qp, clen, sc10, cn,
                       incomplete, *, C: int):
    """The (tensor, dtype, shape) arguments of the ``extract_kbest`` kernel,
    in its order: the chain DP's [R, NL, S] tables and the [R, NL] lists,
    then its six outputs."""
    R, NL, S = dp10.shape
    rows = [(x, _i32, (R, NL, S)) for x in (dp10, back, pos)]
    rows += [(x, _i32, (R, NL)) for x in (qpos, cnt)]
    rows += [(x, _i32, (R, C, NL)) for x in (rpos, qp)]
    rows += [(x, _i32, (R, C)) for x in (clen, sc10)]
    return rows + [(cn, _i32, (R,)), (incomplete, torch.bool, (R,))]


def extract_kbest_device_staged(dp10, back, pos, qpos, cnt, *, k: int,
                                C: int, iters: int = 48, upto: str = "full"):
    """The plain version of ``extract_kbest_device``, on any device, with
    the reference's stage cut points: upto in ("sort", "walks", "emit",
    "assemble", "full")."""
    R, NL, S = dp10.shape
    M = NL * S
    dev = dp10.device
    dpf = dp10.reshape(R, M)
    backf = back.reshape(R, M)
    posf = pos.reshape(R, M)
    l_of = torch.arange(NL, device=dev).repeat_interleave(S)        # [M]
    s_of = torch.arange(S, dtype=_i32, device=dev).repeat(NL)
    validf = (s_of[None, :] < cnt[:, l_of]) & (backf >= 0)

    best10 = torch.where(validf, dpf, _NEG).amax(dim=1)              # [R]
    # the pick order is static (picks never change dp): sort every cell by
    # (score desc, list desc, index asc).  The secondary key is unique per
    # cell, so one int64 composite key gives the reference's two-key sort.
    sec = l_of.to(_i32) * S + (S - 1 - s_of)                          # [M]
    neg_dp = torch.where(validf, -dpf, -_NEG).to(torch.int64)
    key = neg_dp * M + (M - 1 - sec).to(torch.int64)[None, :]
    sorted_idx = torch.argsort(key, dim=1).to(_i32)
    n_valid = validf.sum(dim=1, dtype=_i32)                           # [R]
    if upto == "sort":
        return sorted_idx, n_valid

    T = iters
    # ---- from here the row dimension R is last ------------------------
    heads_T = sorted_idx[:, :T].T                                     # [T, R]
    dpf_T, backf_T, posf_T = dpf.T, backf.T, posf.T                   # [M, R]
    qposf_T = qpos[:, l_of].T

    # ---- walks of every candidate (at most NL fragments) --------------
    # every visited index is a valid flat cell (a head or a backpointer),
    # so each step is a row gather of the [M, R] tables
    cur = heads_T.long()
    active = torch.ones((T, R), dtype=torch.bool, device=dev)
    wpos_f, wqp_f, wact_f = [], [], []
    sc_T = torch.gather(dpf_T, 0, cur)
    for _ in range(NL):
        wpos_f.append(torch.gather(posf_T, 0, cur))
        wqp_f.append(torch.gather(qposf_T, 0, cur))
        wact_f.append(active)
        nxt = torch.gather(backf_T, 0, cur)
        active = active & (nxt >= 0)
        cur = torch.where(active, nxt.long(), cur)
    clen_T = torch.stack(wact_f).sum(dim=0, dtype=_i32)               # [T, R]
    hp_T = wpos_f[0]
    if upto == "walks":
        return wpos_f, wqp_f, clen_T, hp_T

    # ---- serial emission (repeat suppression is order-dependent) ------
    # coll[t', t] = head_pos(t) appears among the NON-head fragments of
    # candidate t' (chain.cpp:266-270's repeat set, for every possible
    # emitter at once); is_rep(t) = any(emitted & coll[:, t]).
    coll = torch.zeros((T, T, R), dtype=torch.bool, device=dev)
    for f in range(1, NL):
        coll |= ((wpos_f[f][:, None, :] == hp_T[None, :, :])
                 & wact_f[f][:, None, :])
    cn = torch.zeros((R,), dtype=_i32, device=dev)
    emitted = torch.zeros((T, R), dtype=torch.bool, device=dev)
    for t in range(T):
        is_rep = (emitted & coll[:, t]).any(dim=0)                    # [R]
        emit = (t < n_valid) & ~((sc_T[t] < best10) & is_rep) & (cn < C)
        emitted[t] = emit
        cn = cn + emit.to(_i32)
    if upto == "emit":
        return cn, emitted.T

    # ---- assembly: slot c <- the c-th emitted pick ---------------------
    ranke = torch.cumsum(emitted, dim=0, dtype=_i32) - 1              # [T, R]
    iota_c = torch.arange(C, dtype=_i32, device=dev)[:, None, None]   # [C,1,1]
    sel = emitted[None, :, :] & (ranke[None, :, :] == iota_c)          # [C,T,R]

    def pick_reduce(v_T):
        return torch.where(sel, v_T[None, :, :], 0).sum(dim=1, dtype=_i32)

    slot_valid = iota_c[:, 0, :] < cn[None, :]                         # [C, R]
    out_rpos_cf, out_qp_cf = [], []
    for f in range(NL):
        sel_wa = (pick_reduce(wact_f[f].to(_i32)) != 0) & slot_valid
        out_rpos_cf.append(torch.where(sel_wa, pick_reduce(wpos_f[f]), 0))
        out_qp_cf.append(torch.where(sel_wa, pick_reduce(wqp_f[f]), 0))
    out_clen_c = torch.where(slot_valid, pick_reduce(clen_T), 0)       # [C, R]
    out_sc_c = torch.where(slot_valid, pick_reduce(sc_T), 0)

    incomplete = (n_valid > iters) & (cn < C)
    if upto == "assemble":
        return (torch.stack(out_rpos_cf, 1), torch.stack(out_qp_cf, 1),
                out_clen_c, out_sc_c, cn, incomplete)

    # ---- single-fragment fallback (chain.cpp:283-298): lists desc, s asc
    fb_needed = cn == 0                                                # [R]
    perm = ((NL - 1 - torch.arange(NL, device=dev))[:, None] * S
            + torch.arange(S, device=dev)[None, :]).reshape(M)        # [M]
    # validity (in-count, not event) in perm order, [M, R]
    v_sf_T = s_of[perm][:, None] < cnt[:, l_of[perm]].T
    rank_fb = torch.cumsum(v_sf_T, dim=0, dtype=_i32) - 1
    take = v_sf_T & (rank_fb < C)
    selfb = take[None, :, :] & (rank_fb[None, :, :] == iota_c)        # [C,M,R]

    def fb_reduce(v_T):
        return torch.where(selfb, v_T[perm][None, :, :], 0).sum(
            dim=1, dtype=_i32)

    fb_rpos, fb_qp, fb_sc = fb_reduce(posf_T), fb_reduce(qposf_T), \
        fb_reduce(dpf_T)
    n_fb = torch.clamp(v_sf_T.sum(dim=0, dtype=_i32), max=C)

    fbm = fb_needed[None, :]                                           # [1, R]
    out_rpos_cf[0] = torch.where(fbm, fb_rpos, out_rpos_cf[0])
    out_qp_cf[0] = torch.where(fbm, fb_qp, out_qp_cf[0])
    for f in range(1, NL):
        out_rpos_cf[f] = torch.where(fbm, 0, out_rpos_cf[f])
        out_qp_cf[f] = torch.where(fbm, 0, out_qp_cf[f])
    fb_len = (iota_c[:, 0, :] < n_fb[None, :]).to(_i32)
    out_clen_c = torch.where(fbm, fb_len, out_clen_c)
    out_sc_c = torch.where(fbm, fb_sc, out_sc_c)
    cn = torch.where(fb_needed, n_fb, cn)

    # ---- back to [R, C, NL] / [R, C] -----------------------------------
    out_rpos = torch.stack(out_rpos_cf, dim=1).permute(2, 0, 1).contiguous()
    out_qp = torch.stack(out_qp_cf, dim=1).permute(2, 0, 1).contiguous()
    return (out_rpos, out_qp, out_clen_c.T.contiguous(),
            out_sc_c.T.contiguous(), cn, incomplete)
