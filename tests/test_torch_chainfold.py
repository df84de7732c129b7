"""The chain DP and the mr fold's pair steps, the two kernels of
csrc/chain_dp.cu and csrc/mr_fold.cu, on the CPU.

- The port's plain chain DP (``chain_device._chain_dp_plain``, which the
  ``chain_dp`` wrapper runs on a CPU tensor: the cells' interval form,
  its junction tables gathered by ``_junction_tables``) against the
  reference's ``circminer_tpu.ops.chain._chain_dp_core_lanes`` fed those
  tables, bit-equal, on inputs made from a seed with numpy: invalid cells
  and all-invalid rows, cells without an interval and intervals shared
  by several cells, score ties within and across lists, several
  accepting junction segments, minpos at exactly pi + max_intron, rows
  near the int32 limit; NL in {2, 4}, S in {4, 16}, P in {1, 4}, both
  forms of the gathers.
- A scalar transcription of each kernel's loop order (for chain_dp per
  list: the invalid cells from the later lists' running maximum, then
  per valid cell and later list the maxIntron minimum, a closed list's
  first maximum, and the targets strided over a row's G = min(S, 32)
  lanes with the (value, flat index) reduction; per read for
  mr_pair_fold, with its early-return go_for_update)
  against the plain version, with counts that show every gate, tie and
  rule taken.  On the card, chip_smoke.py phase 2 holds each kernel to
  its plain version; these transcriptions are the CPU stand-in.
- A mirror of the chain_dp kernel's layout (a warp's 32 / G rows, each
  padded to S mod 32 words): every shared-memory load of its target loop
  is one word per bank, or one broadcast word, in each warp, and so are
  its fills.
- The C enums and constants against the Python orders and config.py.
- ``cuda``-marked (skipped without a card): both kernels against their
  plain versions on the card, also inside a captured CUDA graph.

Every output is an integer: every comparison is exact (tolerance 0)."""

import glob
import re
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import chain_dp_inputs, chain_dp_warp_ties
from chip_smoke import fold_inputs as smoke_fold_inputs
from circminer_tpu.ops import chain as jchain
from circminer_tpu_torch import config as tconfig
from circminer_tpu_torch.ops import _ext
from circminer_tpu_torch.ops import chain_device as tchain
from circminer_tpu_torch.ops import device_full as tfull

I32MAX = 2 ** 31 - 1
NEG = tchain._NEG
CSRC = _ext._CSRC


def w32(x):
    """x as int32 with two's-complement wrap-around."""
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


def abs32(x):
    return w32(-x) if x < 0 else x


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def chain_inputs(seed, b, NL, S, P, **kw):
    """chip_smoke.chain_dp_inputs (the card's adversarial sweep) from a
    seed: every value from a narrow window, so that gates, ties and
    junction branches are taken often; invalid cells and all-invalid rows,
    repeated positions and segments, rows near the int32 limit."""
    return chain_dp_inputs(np.random.default_rng(seed), b, NL, S, P, **kw)


def fold_inputs(seed, B, P):
    """chip_smoke.fold_inputs from a seed: mr states of every type, pairs
    of every final type the rules compare, ed / mlen / tlen from narrow
    windows and repeated pairs (ties in go_for_update), gm set and unset
    on both sides, stopped and not live reads."""
    return smoke_fold_inputs(np.random.default_rng(seed), B, P)


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --------------------------------------------------------------------------
# the chain DP: plain version against JAX
# --------------------------------------------------------------------------

def _jax_chain_dp(arrays, kw, seg_compact=False):
    """The reference's _chain_dp_core_lanes on these cells, fed the tables
    that _junction_tables gathers: (dp, back) [b, NL, S]."""
    t = _torch(arrays)
    tables = tchain._junction_tables(*t[6:], t[8].shape[1], seg_compact)
    pre = [a for a in arrays[:6]] + [x.numpy() for x in tables]
    dpl, bkl = jchain._chain_dp_core_lanes(*(jnp.asarray(a) for a in pre),
                                           **kw)
    return (np.asarray(jnp.stack(dpl, axis=0).transpose(2, 0, 1)),
            np.asarray(jnp.stack(bkl, axis=0).transpose(2, 0, 1)))


@pytest.mark.parametrize("NL,S,P", [(NL, S, P) for NL in (2, 4)
                                    for S in (4, 16) for P in (1, 4)])
def test_chain_dp_plain_matches_jax(NL, S, P):
    arrays, kw = chain_inputs(100 * NL + 10 * S + P, 48, NL, S, P)
    want_dp, want_bk = _jax_chain_dp(arrays, kw)
    got_dp, got_bk = tchain.chain_dp(*_torch(arrays), **kw)
    assert got_dp.dtype == got_bk.dtype == torch.int32
    assert np.array_equal(got_dp.numpy(), want_dp)
    assert np.array_equal(got_bk.numpy(), want_bk)
    # invalid cells take backpointers too (NEG + a later positive score)
    inv = ~arrays[2].reshape(48, NL, S)
    assert (want_bk[inv] >= 0).any()


@pytest.mark.parametrize("S,P", [(S, P) for S in (4, 16) for P in (1, 4)])
def test_chain_dp_interval_form_matches_jax(S, P):
    """chain_dp's CPU path on the interval form, with the column-at-a-time
    gathers (seg_compact), equals the reference fed the padded gathers'
    tables; both gathers give the same tables."""
    NL = 4
    arrays, kw = chain_inputs(7 * S + P, 40, NL, S, P)
    want = _jax_chain_dp(arrays, kw)
    got = tchain.chain_dp(*_torch(arrays), **kw, seg_compact=True)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    t = _torch(arrays)
    for a, b in zip(tchain._junction_tables(*t[6:], P, False),
                    tchain._junction_tables(*t[6:], P, True)):
        assert torch.equal(a, b)
    # cells without an interval, shared intervals, several segments
    iv = arrays[6]
    assert (iv < 0).any() and len(np.unique(iv[iv >= 0])) < (iv >= 0).sum()
    assert P == 1 or (arrays[7] > 1).any()


# --------------------------------------------------------------------------
# the chain DP: the kernel's loop order, scalar
# --------------------------------------------------------------------------

def _c_const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def chain_dp_scalar(posf, qposf, validf, ub, mee, e1, ol_iv, iv_nseg,
                    seg_end, seg_next, *, NL, S, k, max_ed, max_intron, cov):
    """csrc/chain_dp.cu's loops in Python, per row: lists l from NL - 2
    down; a cell whose valid bit is clear takes NEG + the later lists'
    running first maximum; a valid cell's segments are its interval's, and
    per later list j it takes the maxIntron minimum, then NEG + list j's
    first maximum if that gate is closed, else walks the targets with the
    gates (the junction scan only where the gap gate failed, up to the
    first accepting segment) and a running strict ">" per lane, a row's
    G = min(S, 32) lanes over t = lane + G m, reduced on (value
    descending, flat index ascending).  ``cov`` counts the branches
    taken."""
    G = min(S, 32)
    b, M = posf.shape
    P = seg_end.shape[1]
    alpha10 = w32(200000 * k)
    dp = np.zeros((b, M), np.int64)
    back = np.full((b, M), -1, np.int64)
    for row in range(b):
        pos = [int(x) for x in posf[row]]
        val = [bool(x) for x in validf[row]]
        d = [10 * k if v else NEG for v in val]

        def first_max(j):
            v, i = max((d[j * S + t], -(j * S + t)) for t in range(S))
            return v, -i
        lm = {NL - 1: first_max(NL - 1)}
        sm = lm[NL - 1]
        for l in range(NL - 2, -1, -1):
            qp_l = int(qposf[row, l * S])
            for i in range(S):
                c = l * S + i
                pi, v_l = pos[c], val[c]
                if not v_l:
                    cand = w32(NEG + sm[0])
                    if cand > d[c]:
                        d[c], back[row, c] = cand, sm[1]
                        cov["invalid_with_back"] += 1
                    continue
                ub_l, mee_l, e1_l = int(ub[row, c]), int(mee[row, c]), \
                    int(e1[row, c])
                iv = int(ol_iv[row, c])
                segs = []
                for p in range(min(int(iv_nseg[iv]), P) if iv >= 0 else 0):
                    e = w32(int(seg_end[iv, p]) - e1_l)
                    if e >= 0:
                        segs.append((e, int(seg_next[iv, p])))
                lanes = [(NEG, -1)] * G
                for j in range(l + 1, NL):
                    rd = w32(int(qposf[row, j * S]) - qp_l - k)
                    minpos = min([x for x in pos[j * S:(j + 1) * S] if x > pi]
                                 + [I32MAX])
                    cov["minpos_at_bound"] += minpos == w32(pi + max_intron)
                    if minpos > w32(pi + max_intron):
                        cov["gate_closed"] += 1
                        cand = w32(NEG + lm[j][0])
                        if cand > lanes[0][0]:
                            lanes[0] = (cand, lm[j][1])
                        continue
                    for t in range(S):
                        pjv = pos[j * S + t]
                        sc = NEG
                        if val[j * S + t] and pi < pjv <= ub_l:
                            gd = w32(pjv - pi - k)
                            if (mee_l == 0 or w32(pjv + k - 1) <= mee_l) \
                                    and abs32(w32(gd - rd)) <= max_ed:
                                cov["gap"] += 1
                                sc = w32(alpha10 - abs32(w32(gd - rd)))
                            elif pjv > e1_l:
                                jn_ok = intron = False
                                n_acc = 0
                                for e, s_ in segs:
                                    beg = w32(pjv - s_)
                                    td = w32(e + beg)
                                    if beg >= 0 and abs32(w32(td - rd)) \
                                            <= max_ed:
                                        n_acc += 1
                                        if not jn_ok:
                                            jn_ok, jn_dist = True, td
                                    elif not jn_ok and e < rd \
                                            and w32(beg + k) < 0:
                                        intron = True
                                cov["several_accept"] += n_acc >= 2
                                if jn_ok or intron:
                                    cov["junction" if jn_ok
                                        else "intron"] += 1
                                    dist = jn_dist if jn_ok else \
                                        w32(pjv - e1_l - 1)
                                    sc = w32(alpha10 - abs32(w32(dist - rd)))
                        cand = w32(sc + d[j * S + t])
                        ln = t % G
                        if cand > lanes[ln][0]:
                            lanes[ln] = (cand, j * S + t)
                        elif cand == lanes[ln][0] and lanes[ln][1] >= 0:
                            cov["tie_in_list" if lanes[ln][1] // S == j
                                else "tie_across_lists"] += 1
                best_v = max(v for v, _ in lanes)
                at_best = [i for v, i in lanes if v == best_v]
                best_i = min(at_best)
                if best_v > NEG and len(at_best) > 1:
                    cov["tie_in_list" if len({x // S for x in at_best}) == 1
                        else "tie_across_lists"] += 1
                    cov["tie_across_lanes"] += 1
                if best_v > d[c]:
                    d[c], back[row, c] = best_v, best_i
            lm[l] = first_max(l)
            if lm[l][0] >= sm[0]:
                sm = lm[l]
        dp[row] = d
    return dp.reshape(b, NL, S), back.reshape(b, NL, S)


@pytest.mark.parametrize("NL,S,P", [(2, 4, 1), (4, 4, 4), (4, 16, 4),
                                    (3, 5, 20), (15, 3, 2), (3, 70, 4),
                                    (2, 130, 3)])
def test_chain_dp_loop_order_matches_plain(NL, S, P):
    """The kernel's loop order (scalar) equals the plain version, with
    every gate, tie, junction and intron branch taken."""
    # a window of positions wider than the list at wide S, so that the
    # nearest target beyond a cell is sometimes exactly at the maxIntron
    # bound
    arrays, kw = chain_inputs(7 * NL + S + 1000 * P, max(256 // S, 2) + 16,
                              NL, S, P, span=max(40, 2 * S))
    cov = Counter()
    dp, back = chain_dp_scalar(*arrays, **kw, cov=cov)
    want_dp, want_bk = tchain._chain_dp_plain(*_torch(arrays), **kw)
    assert np.array_equal(dp, want_dp.numpy())
    assert np.array_equal(back, want_bk.numpy())
    need = {"gap", "invalid_with_back", "minpos_at_bound", "gate_closed",
            "tie_in_list", "tie_across_lanes"}
    if NL > 2:
        need.add("tie_across_lists")
    if P > 1:
        need |= {"junction", "intron", "several_accept"}
    assert need <= {kk for kk, v in cov.items() if v}, cov


def test_chain_dp_wrapper_shapes_and_kernel_args():
    """The wrapper's CPU result is the plain version's, [b, NL, S]; the
    kernel's argument list names each tensor once, in the C order
    (``_ext.KERNELS["chain_dp"]``), with the dtype and shape the kernel
    reads: the [b, M] cells, the [n_iv] and [n_iv, P] tables, the
    outputs."""
    arrays, kw = chain_inputs(5, 9, 3, 4, 2)
    t = _torch(arrays)
    got = tchain.chain_dp(*t, **kw)
    want = tchain._chain_dp_plain(*t, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].shape == (9, 3, 4)
    args = tchain.chain_dp_args(*t, *got, NL=3, S=4)
    names = _ext.KERNELS["chain_dp"].tensors
    assert names == ("posf", "qposf", "validf", "ub", "mee", "e1", "ol_iv",
                     "iv_nseg", "seg_end", "seg_next", "dp", "back")
    assert len(args) == len(names)
    n_iv = t[7].shape[0]
    shapes = dict(iv_nseg=(n_iv,), seg_end=(n_iv, 2), seg_next=(n_iv, 2),
                  dp=(9, 3, 4), back=(9, 3, 4))
    for (x, dt, shape), name, y in zip(args, names, t + list(got)):
        assert x is y and shape == shapes.get(name, (9, 12)), name
        assert dt == (torch.bool if name == "validf" else torch.int32)
        assert x.dtype == dt and tuple(x.shape) == shape \
            and x.is_contiguous()
    src = _source("chain_dp.cu")
    sig = re.search(r'extern "C" int cm_chain_dp\(([^)]*)\)', src).group(1)
    params = [q.split()[-1].lstrip("*") for q in sig.split(",")]
    assert params == list(names) + list(
        _ext.KERNELS["chain_dp"].statics) + ["stream"]


# --------------------------------------------------------------------------
# the chain DP: the kernel's shared-memory layout
# --------------------------------------------------------------------------

def chain_layout(NL, S):
    """The kernel's layout (row_lanes, row_words): lanes a row G, rows a
    warp, words a row RW."""
    G = min(S, 32)
    base = 3 * NL * S + 3 * NL
    return G, 32 // G, base + ((S - base) % 32 + 32) % 32


def target_loads(NL, S):
    """Per warp-wide load of the target loops (minpos, scan; one load of
    each of pos, dp and val at the same offsets) the word each active lane
    reads: every later list j and target step t0.  Lane i of row wr
    (wr = lane // G) reads row wr's target t0 + i."""
    G, n, stride = chain_layout(NL, S)
    out = []
    for j in range(1, NL):
        for t0 in range(0, S, G):
            out.append([(lane // G) * stride + j * S + t0 + lane % G
                        for lane in range(32)
                        if lane // G < n and t0 + lane % G < S])
    return out


def _one_word_per_bank(words):
    banks = {}
    for w in words:
        banks.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in banks.values()) == 1


@pytest.mark.parametrize("NL,S", [(6, 16), (15, 128), (15, 500), (6, 3),
                                  (4, 64)])
def test_chain_dp_target_loads_have_no_bank_conflicts(NL, S):
    """Every shared load of the kernel's target loop reads, per warp, one
    word per bank or one broadcast word (32 banks of 4 bytes)."""
    loads = target_loads(NL, S)
    assert loads
    for words in loads:
        assert _one_word_per_bank(words), (NL, S, words)
    # the layouts the tests mirror are the source's
    assert chain_layout(6, 16) == (16, 2, 336)   # 306 padded to 16
    assert chain_layout(15, 500)[:2] == (32, 1)


def test_chain_dp_fill_is_conflict_free():
    """The coalesced fill and write-back meet no bank conflict: each
    lane's own cell c = i + m G of its row."""
    for NL, S in ((6, 16), (15, 128), (15, 500), (6, 3), (2, 5), (3, 31)):
        G, n, stride = chain_layout(NL, S)
        assert stride % 32 == S % 32
        for m in range(NL * S // G):
            assert _one_word_per_bank(
                [(lane // G) * stride + lane % G + m * G
                 for lane in range(32) if lane // G < n])


# --------------------------------------------------------------------------
# the mr fold's pair steps: the kernel's loop order, scalar
# --------------------------------------------------------------------------

C = tconfig


def fold_scalar(mr_in, pairs, o_t, orient, live, stopped, *, max_tlen,
                contig_num, scan_level, cov):
    """csrc/mr_fold.cu's per-read loop in Python: P pair steps of the
    orientation o_t, each concordant_explanation's five guarded updates,
    the stop, then the chimeric, BSJ and double-BSJ checks, with
    go_for_update's early returns.  ``cov`` counts what was taken."""
    B, _, P, _ = pairs.shape
    PK = {kk: i for i, kk in enumerate(tfull.PAIR_KEYS)}
    MK = {kk: i for i, kk in enumerate(tfull.MR_KEYS)}
    mr_out = np.zeros((B, len(MK)), np.int64)
    aux = np.zeros((B, len(tfull.FOLD_AUX)), np.int64)

    def mapping(f, side):
        m = {kk: f[PK[side + kk]] for kk in tfull.MM_USED}
        m["ed"] = w32(m["led"] + m["med"] + m["red"])
        return m

    for rd in range(B):
        mr = [int(x) for x in mr_in[rd]]
        o = int(o_t[rd])
        lv, st = bool(live[rd]), bool(stopped[rd])
        min1 = min2 = C.ORPHAN
        r1g = r2g = dfo = False
        for p in range(P):
            f = [int(x) for x in pairs[rd, o, p]]
            act, mp, chr_, shift = (int(x) for x in orient[rd, p])
            sm, lm = mapping(f, "l_"), mapping(f, "r_")
            flp = f[PK["fwd_left"]] != 0
            r1_sm = flp == (o == 0)

            def go(tlen, gm, type_):
                ed, mlen = w32(sm["ed"] + lm["ed"]), w32(sm["mlen"] +
                                                         lm["mlen"])
                mr_ed = w32(mr[MK["ed_r1"]] + mr[MK["ed_r2"]])
                mr_ml = w32(mr[MK["mlen_r1"]] + mr[MK["mlen_r2"]])
                if type_ != mr[MK["type"]]:
                    return type_ < mr[MK["type"]]
                mr_gm = mr[MK["gm"]] != 0
                if gm != mr_gm:
                    cov["gm_win" if gm else "gm_lose"] += 1
                    return gm
                if type_ >= C.CHIBSJ:
                    cov["bsj_order_tie"] += mr_ml == mlen
                    return mr_ml < mlen or (mr_ml == mlen and mr_ed > ed)
                cov["ed_tie"] += mr_ed == ed
                cov["tlen_tie"] += mr_ed == ed and mr[MK["tlen"]] == tlen
                return mr_ed > ed or (mr_ed == ed and (
                    mr[MK["tlen"]] > tlen or (mr[MK["tlen"]] == tlen
                                              and mr_ml < mlen)))

            def update(tlen, jun, gm, type_, apply):
                if not apply or not go(tlen, gm, type_):
                    return
                cov[f"type{type_}"] += 1
                a, b = (sm, lm) if r1_sm else (lm, sm)
                new = dict(
                    type=type_, chr=chr_, spos_r1=w32(a["spos"] - shift),
                    epos_r1=w32(a["epos"] - shift), qspos_r1=a["qspos"],
                    qepos_r1=a["qepos"], mlen_r1=a["mlen"], ed_r1=a["ed"],
                    spos_r2=w32(b["spos"] - shift),
                    epos_r2=w32(b["epos"] - shift), qspos_r2=b["qspos"],
                    qepos_r2=b["qepos"], mlen_r2=b["mlen"], ed_r2=b["ed"],
                    r1_fwd=int(a["dir"] > 0), r2_fwd=int(b["dir"] > 0),
                    tlen=tlen, junc=jun, gm=int(gm), contig=contig_num)
                for kk, v in new.items():
                    mr[MK[kk]] = v

            pact = act != 0 and lv and not st
            succ = pact and f[PK["success"]] != 0
            r1t = sm["tfinal"] if flp else lm["tfinal"]
            r2t = lm["tfinal"] if flp else sm["tfinal"]
            cc = succ and flp and r1t == C.CONCRD and r2t == C.CONCRD
            bsj_m = succ and ((r1t == C.CANDID and r2t == C.CONCRD)
                              or (r1t == C.CONCRD and r2t == C.CANDID))
            b2_m = succ and r1t == C.CANDID and r2t == C.CANDID
            chim = succ and not flp and r1t == C.CONCRD and r2t == C.CONCRD
            # concordant_explanation
            ok0 = cc and sm["spos"] <= lm["spos"]
            on_cdna = min(sm["iv_s"], sm["iv_e"], lm["iv_s"],
                          lm["iv_e"]) >= 0
            tlen_a = w32(lm["spos"] - sm["epos"] - 1 + lm["mlen"]
                         + sm["mlen"])
            near = tlen_a <= max_tlen or tlen_a <= C.MAXDISCRDTLEN
            b1_no = sm["iv_s"] < 0 or lm["iv_s"] < 0
            update(tlen_a, 0, False, C.CONGNM, ok0 and b1_no and near)
            tlen_b = w32(lm["spos"] + lm["mlen"] - sm["spos"])
            typ_b = C.CONCRD if mp == 0 else C.CONGEN
            update(tlen_b, 0, on_cdna,
                   typ_b if tlen_b <= max_tlen else C.DISCRD,
                   ok0 and not b1_no and f[PK["se"]] != 0)
            b2_no = sm["iv_e"] < 0 or lm["iv_s"] < 0
            update(tlen_a, 0, False, C.CONGNM, ok0 and b2_no and near)
            tl, inn = f[PK["ct_tl"]], f[PK["ct_inn"]]
            u2b = ok0 and not b2_no
            dfo = dfo or (u2b and f[PK["ct_df"]] != 0)
            good = 0 <= tl <= max_tlen
            update(tl, inn, on_cdna, typ_b, u2b and good)
            update(tlen_a if tl < 0 else tl, 0 if tl < 0 else inn, on_cdna,
                   C.DISCRD, u2b and not good)
            if scan_level == 0 and cc and mr[MK["type"]] == C.CONCRD:
                cov["stopped"] += not st
                st = True
            tl = w32(lm["epos"] - sm["spos"] + 1)
            update(tl, 0, False, C.CHIORF,
                   chim and mr[MK["type"]] != C.CONCRD and sm["iv_s"] >= 0
                   and lm["iv_s"] >= 0 and f[PK["sg_iv"]] != 0
                   and sm["spos"] < lm["spos"])
            update(tl, 0, False, C.CHIBSJ,
                   bsj_m and mr[MK["type"]] not in (C.CONCRD, C.DISCRD)
                   and sm["r_ok"] != 0 and lm["l_ok"] != 0
                   and f[PK["bsj_hit"]] != 0)
            update(tl, 0, False, C.CHI2BSJ,
                   b2_m and mr[MK["type"]] >= C.CHI2BSJ
                   and sm["spos"] <= lm["spos"]
                   and not (sm["r_ok"] and lm["r_ok"]
                            and sm["spos"] != lm["spos"])
                   and not (sm["l_ok"] and lm["l_ok"]
                            and sm["epos"] != lm["epos"])
                   and not (sm["l_ok"] and lm["r_ok"])
                   and f[PK["bsj_hit"]] != 0)
            if pact:
                min1, min2 = min(min1, r1t), min(min2, r2t)
                a, b = (sm, lm) if flp else (lm, sm)
                r1g = succ and (a["iv_s"] >= 0 or a["iv_e"] >= 0)
                r2g = succ and (b["iv_s"] >= 0 or b["iv_e"] >= 0)
        mr_out[rd] = mr
        aux[rd] = [st, min1, min2, r1g, r2g, dfo]
    return mr_out, aux


@pytest.mark.parametrize("P,scan_level", [(1, 0), (2, 1), (8, 0), (8, 1)])
def test_mr_pair_fold_loop_order_matches_plain(P, scan_level):
    """The kernel's per-read loop (scalar) equals the plain version, with
    every rule's type taken, ed / mlen / tlen ties and gm won and lost."""
    arrays, kw = fold_inputs(31 * P + scan_level, 250 * P, P)
    cov = Counter()
    mr, aux = fold_scalar(*arrays, **kw, scan_level=scan_level, cov=cov)
    want_mr, want_aux = tfull.mr_pair_fold(*_torch(arrays), **kw,
                                           scan_level=scan_level)
    assert np.array_equal(mr, want_mr.numpy())
    assert np.array_equal(aux, want_aux.numpy())
    if P == 8:
        need = {f"type{t}" for t in (C.CONCRD, C.DISCRD, C.CHIORF, C.CHIBSJ,
                                     C.CHI2BSJ, C.CONGEN, C.CONGNM)}
        need |= {"gm_win", "gm_lose", "ed_tie", "tlen_tie", "bsj_order_tie"}
        if scan_level == 0:
            need.add("stopped")
        assert need <= {kk for kk, v in cov.items() if v}, cov


def test_mr_pair_fold_kernel_args():
    arrays, kw = fold_inputs(3, 5, 2)
    t = _torch(arrays)
    mr, aux = tfull.mr_pair_fold(*t, **kw, scan_level=0)
    assert mr.dtype == aux.dtype == torch.int32
    assert tuple(aux.shape) == (5, len(tfull.FOLD_AUX))
    args = tfull.mr_pair_fold_args(*t, mr, aux)
    assert len(args) == len(_ext.KERNELS["mr_pair_fold"].tensors)
    for x, dt, shape in args:
        assert x.dtype == dt and tuple(x.shape) == shape \
            and x.is_contiguous()


# --------------------------------------------------------------------------
# the C sources against the Python orders
# --------------------------------------------------------------------------

def _source(name):
    with open(f"{CSRC}/{name}") as f:
        return f.read()


def _enum(src, name):
    body = re.search(rf"enum {name} \{{([^}}]*)\}}", src).group(1)
    return [e.split("=")[0].strip() for e in body.split(",") if e.strip()]


def test_fold_enums_and_constants_follow_python():
    src = _source("mr_fold.cu")
    assert _enum(src, "MrField") == ["MR_" + kk.upper()
                                     for kk in tfull.MR_KEYS] + ["MRF"]
    assert _enum(src, "MmField") == ["MM_" + kk.upper()
                                     for kk in tfull.MM_USED] + ["NMM"]
    pair = ["PF_LMM", "PF_RMM"] + ["PF_" + kk.upper()
                                   for kk in tfull.PAIR_KEYS[28:]] + ["NPF"]
    assert _enum(src, "PairField") == pair
    assert len(tfull.PAIR_KEYS) == 2 * len(tfull.MM_USED) + len(pair) - 3
    assert _enum(src, "OrientField") == ["OR_ACT", "OR_MP_TYPE",
                                         "OR_CHR_IDX", "OR_SHIFT", "NOF"]
    assert len(tfull.ORIENT_KEYS) == 4 and len(tfull.FOLD_AUX) == 6
    assert _enum(src, "AuxField")[:-1] == [
        "A_" + kk.upper().replace("DEFER_O", "DEFER")
        for kk in tfull.FOLD_AUX]
    consts = dict(re.findall(r"constexpr int (\w+) = (-?\d+);", src))
    for name in ("CONCRD", "DISCRD", "CHIORF", "CHIBSJ", "CHI2BSJ", "CONGEN",
                 "CONGNM", "CANDID", "ORPHAN", "MAXDISCRDTLEN"):
        assert int(consts[name]) == getattr(tconfig, name), name


def test_chain_constants_follow_python():
    src = _source("chain_dp.cu")
    assert "constexpr int NEG = -(1 << 29);" in src and NEG == -(1 << 29)
    # the layout mirror (chain_layout) follows row_lanes and row_words
    assert "inline int row_lanes(int S) { return S < 32 ? S : 32; }" in src
    assert """const int base = 3 * NL * S + 3 * NL;
  return base + ((S - base) % 32 + 32) % 32;""" in src


def test_library_hash_covers_every_source(tmp_path, monkeypatch):
    """One library for every csrc/*.cu: its name changes with any of
    them."""
    for name in ("a.cu", "b.cu"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_ext, "_CSRC", str(tmp_path))
    assert [p.rsplit("/", 1)[1] for p in _ext.sources()] == ["a.cu", "b.cu"]
    base = _ext.library_path()
    (tmp_path / "b.cu").write_text("// b.cu, changed\n")
    assert _ext.library_path() != base
    assert {"chain_dp.cu", "mr_fold.cu", "align_kernels.cu"} <= {
        p.rsplit("/", 1)[1] for p in glob.glob(f"{CSRC}/*.cu")}


def test_launch_tensors_checks_before_it_builds():
    """The launcher refuses CPU tensors and a wrong count of tensors or
    statics with a ValueError, before any build or launch."""
    arrays, kw = fold_inputs(1, 4, 2)
    t = _torch(arrays)
    mr_out, aux = tfull.mr_pair_fold(*t, **kw, scan_level=0)
    args = tfull.mr_pair_fold_args(*t, mr_out, aux)
    statics = (4, 2, kw["max_tlen"], kw["contig_num"], 0)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        _ext.launch_tensors("mr_pair_fold", args, statics)
    with pytest.raises(ValueError, match="takes tensors"):
        _ext.launch_tensors("mr_pair_fold", args[:-1], statics)
    with pytest.raises(ValueError, match="takes statics"):
        _ext.launch_tensors("mr_pair_fold", args, statics[:-1])


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def _cases():
    """(name, kernel call, plain call) on the card over both kernels'
    adversarial inputs, the chain DP at S = 16, 128 and 500 and with ties
    across a row's warps at S = 600."""
    out = []
    for seed, (b, NL, S, P) in enumerate([(512, 6, 16, 16), (64, 4, 128, 4),
                                          (8, 15, 500, 16), (33, 3, 5, 20)]):
        arrays, kw = chain_inputs(seed, b, NL, S, P)
        t = [x.cuda() for x in _torch(arrays)]
        out.append(("chain_dp", lambda t=t, kw=kw: tchain.chain_dp(*t, **kw),
                    lambda t=t, kw=kw: tchain._chain_dp_plain(*t, **kw)))
    arrays, kw = chain_dp_warp_ties(np.random.default_rng(9), 16)
    t = [x.cuda() for x in _torch(arrays)]
    out.append(("chain_dp", lambda t=t, kw=kw: tchain.chain_dp(*t, **kw),
                lambda t=t, kw=kw: tchain._chain_dp_plain(*t, **kw)))
    for seed, (B, P, sl) in enumerate([(4096, 8, 0), (77, 8, 1), (5, 1, 0),
                                       (1, 8, 0), (31, 8, 1), (33, 8, 0),
                                       (4097, 8, 1), (40, 16, 0)]):
        arrays, kw = fold_inputs(seed, B, P)
        t = [x.cuda() for x in _torch(arrays)]
        kw = dict(kw, scan_level=sl)
        out.append(("mr_pair_fold",
                    lambda t=t, kw=kw: tfull.mr_pair_fold(*t, **kw),
                    lambda t=t, kw=kw: tfull._mr_pair_fold_plain(*t, **kw)))
    return out


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    for name, kern, plain in _cases():
        _ext.reset_launches()
        got = kern()
        assert _ext.LAUNCHES[name] == 1
        for g, w in zip(got, plain()):
            assert torch.equal(g, w), name


@pytest.mark.cuda
def test_kernels_replay_in_a_cuda_graph(cuda_device):
    """Each wrapper captured in a CUDA graph (the step's form) replays the
    plain version's outputs."""
    for name, kern, plain in _cases():
        kern()                           # load the library outside capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kern()
        for x in out:
            x.fill_(-7)
        graph.replay()
        for g, w in zip(out, plain()):
            assert torch.equal(g, w), name
