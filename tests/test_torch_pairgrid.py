"""Phase 2's pair grid (csrc/pair_grid.cu, ``device_full.pair_grid``) on
the CPU: the grid, its rank into P_MAX slots, the chain-order walk and the
l/r-mate bundles of one staged read.

- The plain version ``_pair_grid_plain`` against the reference's
  ``_phase2`` at its ``p2_grid`` and ``p2_gath`` cut points, on
  tests/test_torch_full.py's library and batch with its shrunk DP pools
  (SMALL_POOLS), at both error rates: phase 1's state of the port, the
  operands ``pair_grid_operands`` makes of it, and the reference's keys
  read off the outputs, bit-equal in value and dtype.
- A scalar transcription of the kernel's per-read order (the staged
  chains and annotation rows, the cells, the ballot rank over 32-cell
  chunks with its carry, the cell-0 fill of empty slots, the slots' merge
  walk on the staged fragments, the bundle select) against the plain
  version on chip_smoke's adversarial ``pair_grid_inputs``, with branch
  counters that must all fire.
- Those inputs over chip_smoke's PAIR_SWEEP reach what the kernel must
  get right: n_union 0, at P_MAX and past it, chains off any interval and
  past the table, tid and segment lists at and over their pads, more
  than 64 cells, lastr + k past I32MAX, pairs at exactly MAXDISCRDTLEN.
- The ``pair_grid_args`` list and the C signature, the source's
  constants, its shared-memory formula, and the card path on CPU tensors
  that report ``is_cuda`` (one launch, inputs in place, its refusals).
- ``cuda``-marked (skipped without a card): the kernel bit-equal to the
  plain version over PAIR_SWEEP, eagerly and replayed from a CUDA graph.

Every output is an integer or a flag: every comparison is exact
(tolerance 0)."""

import re
from collections import Counter
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (I32MAX, PAIR_SWEEP, c_params, pair_case,
                        pair_grid_inputs, tensor_kernel_calls)
from circminer_tpu.ops import device_full as jfull
from circminer_tpu_torch.config import INF, MAXDISCRDTLEN
from circminer_tpu_torch.ops import _ext
from circminer_tpu_torch.ops import device_full as tfull
from test_torch_full import (FINISH_KEYS, World, _finish_inputs,
                             _one_torch_thread, _same)   # noqa: F401

SRC = f"{_ext._CSRC}/pair_grid.cu"
NI = len(tfull.MATE_INT) - 2
NB = len(tfull.SF_BOOL)
R0, LASTR, IV_L, CLEN = (tfull.SF_INT.index(n)
                         for n in ("r0", "lastr", "iv_l", "clen"))
PHASE1_KEYS = ("k", "max_ed", "max_sc", "band", "KB", "OS_POOL", "XD_POOL",
               "mat", "mis", "ind", "xd")


def w32(x):
    """x as int32 with two's-complement wrap-around."""
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


def _torch(arrays):
    return [torch.from_numpy(np.require(a, requirements="C"))
            for a in arrays]


# --------------------------------------------------------------------------
# the plain version against the reference's cut points
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[0.0, 0.01], ids=["err0", "err1"])
def world(request, tmp_path_factory):
    return World(tmp_path_factory.mktemp("tpair"), request.param)


@pytest.mark.parametrize("upto", ["p2_grid", "p2_gath"])
def test_plain_pair_grid_matches_jax_cuts(world, upto):
    kw = {key: world.statics[key] for key in FINISH_KEYS}
    inputs = _finish_inputs(world)
    want, want_def = jax.jit(partial(
        jfull.device_full_finish, contig_num=0, upto=upto, **kw))(
        *(jnp.asarray(a) for a in inputs), world.jgenome, world.jst.anno,
        world.jfa)
    st = tfull._phase1(*(torch.from_numpy(np.array(a)) for a in inputs),
                       world.tgenome, world.tad, world.tfa,
                       **{key: kw[key] for key in PHASE1_KEYS})
    pg = tfull._pair_grid_plain(
        *tfull.pair_grid_operands(st, world.tad, world.tfa), k=kw["k"],
        P=kw["P_MAX"], SEG_PAD=world.tad.seg_end.shape[1])
    same_tr, sgf, sgr = pg.grid_b.unbind(0)
    fvalid, rvalid = pg.valid.unbind(0)
    fwd_left = pg.slot_b[4]
    if upto == "p2_grid":
        union = fvalid[..., None] & rvalid[..., None, :] & (
            same_tr | sgf | sgr | (pg.tlen_g <= MAXDISCRDTLEN))
        got = dict(union=union, same_tr=same_tr, sgf=sgf, sgr=sgr,
                   tlen_g=pg.tlen_g, pvalid=pg.slot_b[0],
                   pcell=pg.slot_i[0], defer=pg.defer)
        B = union.shape[0]
        _same(pg.n_union, np.asarray(want["union"]).reshape(B, 2, -1).sum(
            -1).astype(np.int32), "n_union")
        assert np.asarray(want["pvalid"]).any()
        assert np.asarray(want["union"]).any()
    else:
        lm, rm = pg.mate_i.unbind(0)
        got = dict(defer=pg.defer, fwd_left=fwd_left)
        for kk in ("r0", "q0", "mid_dp", "clen", "dp00_ed", "dp11_score"):
            f = tfull.MATE_INT.index(kk)
            got["f_" + kk] = torch.where(fwd_left, lm[f], rm[f])
            got["v_" + kk] = torch.where(fwd_left, rm[f], lm[f])
        assert np.asarray(want["fwd_left"]).any()
        assert not np.asarray(want["fwd_left"]).all()
    assert sorted(got) == sorted(want)
    for key in want:
        _same(got[key], want[key], f"{upto}:{key}")
    _same(got["defer"], want_def, f"{upto}:defer")


# --------------------------------------------------------------------------
# the kernel's per-read order, transcribed
# --------------------------------------------------------------------------

def _clamp(x, lo, hi):
    return min(max(int(x), lo), hi)


def _is_left(A, Bf, QA, QB, a_len, b_len, read_len, NL, k, seen):
    """pair_grid.cu's is_left on staged chains."""
    def at(v, i):
        return v[_clamp(i, 0, NL - 1)]
    a_end, b_end = w32(at(A, w32(a_len - 1)) + k - 1), \
        w32(at(Bf, w32(b_len - 1)) + k - 1)
    if Bf[0] > a_end or A[0] > b_end:
        seen["walk_separated"] += 1
        return A[0] < Bf[0]
    i = j = 0
    bd, bi, bj = INF, -1, -1
    for _ in range(2 * NL):
        if not (i < a_len and j < b_len):
            seen["walk_ended"] += 1
            break
        ai, bjb = at(A, i), at(Bf, j)
        if w32(ai + k - 1) < bjb:
            d = w32(bjb - w32(ai + k - 1))
            seen["walk_a_before"] += 1
            if d < bd:
                bd, bi, bj = d, i, j
            i += 1
        elif w32(bjb + k - 1) < ai:
            d = w32(ai - w32(bjb + k - 1))
            seen["walk_b_before"] += 1
            if d < bd:
                bd, bi, bj = d, i, j
            j += 1
        else:
            seen["walk_overlap"] += 1
            bi, bj = i, j
            break
    a_bp, b_bp = at(A, bi), at(Bf, bj)
    common = max(a_bp, b_bp)
    a_ov = w32(at(QA, bi) + w32(common - a_bp))
    b_ov = w32(at(QB, bj) + w32(common - b_bp))
    both_in = a_ov < read_len and b_ov < read_len and bi >= 0
    seen["walk_both_in" if both_in else "walk_not_both_in"] += 1
    return a_ov >= b_ov if both_in else A[0] < Bf[0]


def kernel_read(arrs, b, k, P, SEG_PAD, seen):
    """pair_grid_kernel's block b in its order: stage the read, the
    annotation rows of its chains that a valid cell can use, the cells,
    the rank a warp an orientation over 32-cell chunks, the defer word,
    the slots, the bundles.  Returns the block's share of each output."""
    (sf_i, sf_b, rp4, qp4, cn4, lens4, defer, iv_tids, iv_ntid,
     iv_nseg_true, iv_nseg, seg_gene_p, gene_start, gene_end) = arrs
    _, _, KB1, NL = rp4.shape
    NIV, ST = iv_tids.shape
    SP, NG = seg_gene_p.shape[1], gene_start.shape[0]
    C4, KK = 4 * KB1, KB1 * KB1
    sf = sf_i[b].reshape(C4, NI).tolist()
    sfb = sf_b[b].reshape(C4, NB).tolist()
    rp, qp = rp4[b].reshape(C4, NL).tolist(), qp4[b].reshape(C4,
                                                             NL).tolist()
    cn, lens = cn4[b].tolist(), lens4[b].tolist()

    def chain_iv(c):
        iv = sf[c][IV_L]
        return iv if c % KB1 < cn[c // KB1] and iv >= 0 else -1
    tids, genes, over = {}, {}, []
    for c in range(C4):
        iv = chain_iv(c)
        over.append(False)
        if iv < 0:
            continue
        ivc = _clamp(iv, 0, NIV - 1)
        seen["iv_past_table"] += ivc != iv
        tids[c] = iv_tids[ivc].tolist()
        genes[c] = []
        for x in range(SP):
            g = int(seg_gene_p[ivc, x])
            if x < iv_nseg[ivc] and g >= 0:
                gc = _clamp(g, 0, NG - 1)
                seen["gene_past_table"] += gc != g
                genes[c].append((int(gene_start[gc]), int(gene_end[gc])))
            else:
                seen["segment_skipped"] += 1
        over[c] = bool(iv_ntid[ivc] > ST or iv_nseg_true[ivc] > SEG_PAD)

    def tids_meet(ta, tb):
        for v in ta:
            if v < 0:
                seen["tid_negative"] += 1
                continue
            if v in tb:
                seen["tid_shared"] += 1
                return True
        return False

    def in_gene(c, lo, hi):
        return any(gs <= lo and hi <= ge for gs, ge in genes[c])

    def tlen_of(F, V):
        return w32(w32(V[LASTR] + k) - F[R0]) if F[R0] < V[R0] \
            else w32(w32(F[LASTR] + k) - V[R0])
    grid_b = np.zeros((3, 2 * KK), bool)
    tlen_g = np.zeros(2 * KK, np.int32)
    cellf = []
    for e in range(2 * KK):
        o, cell = divmod(e, KK)
        i, j = divmod(cell, KB1)
        cf, cv = 2 * o * KB1 + i, (3 - 2 * o) * KB1 + j
        F, V = sf[cf], sf[cv]
        gv = i < cn[2 * o] and j < cn[3 - 2 * o]
        tlen = tlen_of(F, V)
        same_tr = sgf = sgr = False
        if gv:
            same_tr = F[IV_L] >= 0 and V[IV_L] >= 0 and \
                tids_meet(tids[cf], tids[cv])
            sgf = F[IV_L] >= 0 and in_gene(cf, V[R0], w32(V[LASTR] + k))
            sgr = V[IV_L] >= 0 and in_gene(cv, F[R0], w32(F[LASTR] + k))
            seen["gene_f"] += sgf
            seen["gene_r"] += sgr
        uni = gv and (same_tr or sgf or sgr or tlen <= MAXDISCRDTLEN)
        seen["union_by_tlen"] += uni and not (same_tr or sgf or sgr)
        seen["tlen_at_limit"] += gv and tlen == MAXDISCRDTLEN
        cellf.append((uni, uni and (over[cf] or over[cv]),
                      same_tr, sgf, sgr))
        grid_b[:, e] = same_tr, sgf, sgr
        tlen_g[e] = tlen
    valid = np.array([[c < cn[2 * o] for o in (0, 1) for c in range(KB1)],
                      [c < cn[3 - 2 * o] for o in (0, 1)
                       for c in range(KB1)]])
    # the rank: a warp an orientation, lanes over a 32-cell chunk
    pcell, nun, any_over = [0] * (2 * P), [0, 0], [False, False]
    for o in (0, 1):
        count = 0
        for base in range(0, KK, 32):
            lanes = [cellf[o * KK + base + lane]
                     if base + lane < KK else (False,) * 5
                     for lane in range(32)]
            um = sum(1 << lane for lane in range(32) if lanes[lane][0])
            any_over[o] |= any(f[1] for f in lanes)
            for lane in range(32):
                if not lanes[lane][0]:
                    continue
                r = count + bin(um & ((1 << lane) - 1)).count("1")
                seen["rank_carried"] += base > 0 and count > 0
                if r < P:
                    pcell[o * P + r] = base + lane
                else:
                    seen["past_P"] += 1
            count += bin(um).count("1")
        nun[o] = count
        seen["n_union_0" if count == 0 else "n_union_P" if count == P
             else "n_union_past_P" if count > P else "n_union_below_P"] += 1
    df = int(defer[b])
    if any_over[0] or any_over[1]:
        df |= tfull.DEF_PANNO
        seen["panno"] += 1
    if nun[0] > P or nun[1] > P:
        df |= tfull.DEF_UNION
    # the slots
    slot_i = np.zeros((4, 2 * P), np.int32)
    slot_b = np.zeros((5, 2 * P), bool)
    left = []
    for e in range(2 * P):
        o, p = divmod(e, P)
        cell = pcell[e]
        pi, pj = divmod(cell, KB1)
        cf, cv = 2 * o * KB1 + pi, (3 - 2 * o) * KB1 + pj
        F, V = sf[cf], sf[cv]
        pvalid = p < nun[o]
        seen["empty_slot"] += not pvalid
        fl = _is_left(rp[cf], rp[cv], qp[cf], qp[cv], F[CLEN], V[CLEN],
                      lens[2 * o], NL, k, seen)
        left.append(fl)
        _, _, s_tr, s_gf, s_gr = cellf[o * KK + cell]
        slot_i[:, e] = cell, tlen_of(F, V), F[IV_L], V[IV_L]
        slot_b[:, e] = (pvalid, pvalid and s_tr, pvalid and s_gf,
                        pvalid and s_gr, fl)
    # the bundles: mate 0 the l-mate (the forward chain where fwd_left)
    mate_i = np.zeros((2, NI + 2, 2 * P), np.int32)
    mate_b = np.zeros((2, NB, 2 * P), bool)
    for m in (0, 1):
        for os_ in range(2 * P):
            o = os_ // P
            pi, pj = divmod(pcell[os_], KB1)
            fwd = (m == 0) == left[os_]
            seen["bundle_fwd" if fwd else "bundle_rev"] += 1
            row = 2 * o if fwd else 3 - 2 * o
            c = row * KB1 + (pi if fwd else pj)
            mate_i[m, :, os_] = sf[c] + [lens[row], 4 * b + row]
            mate_b[m, :, os_] = [bool(v) for v in sfb[c]]
    return (grid_b, tlen_g, valid, slot_i, slot_b, np.array(nun, np.int32),
            mate_i, mate_b, df)


def _read_of(pg, b):
    """Block b's share of the plain version's outputs, laid out as
    kernel_read returns them."""
    B, KB1 = pg.tlen_g.shape[0], pg.tlen_g.shape[2]
    P = pg.slot_i.shape[3]
    return (pg.grid_b[:, b].reshape(3, -1).numpy(),
            pg.tlen_g[b].reshape(-1).numpy(),
            pg.valid[:, b].reshape(2, -1).numpy(),
            pg.slot_i[:, b].reshape(4, -1).numpy(),
            pg.slot_b[:, b].reshape(5, -1).numpy(), pg.n_union[b].numpy(),
            pg.mate_i[:, :, b].reshape(2, -1, 2 * P).numpy(),
            pg.mate_b[:, :, b].reshape(2, -1, 2 * P).numpy(),
            int(pg.defer[b]))


def test_kernel_order_matches_plain():
    seen = Counter()
    for B, KB1, NL, P, kw0 in ((48, 7, 6, 8, {}),
                               (24, 3, 1, 2, dict(ST=4, SP=3, SEG_PAD=3)),
                               (10, 12, 4, 40, dict(k=3)),
                               (16, 9, 17, 9, dict(ST=33, SP=5, SEG_PAD=8))):
        arrs, kw = pair_grid_inputs(np.random.default_rng(B * KB1), B, KB1,
                                    NL, P, **kw0)
        pg = tfull.pair_grid(*_torch(arrs), **kw)
        for b in range(B):
            got = kernel_read(arrs, b, kw["k"], P, kw["SEG_PAD"], seen)
            for i, (g, w) in enumerate(zip(got, _read_of(pg, b))):
                assert np.array_equal(np.asarray(g), np.asarray(w)), \
                    (B, KB1, b, i)
    for branch in ("iv_past_table", "gene_past_table", "segment_skipped",
                   "tid_negative", "tid_shared", "gene_f", "gene_r",
                   "union_by_tlen", "tlen_at_limit", "rank_carried",
                   "past_P", "n_union_0", "n_union_P", "n_union_past_P",
                   "n_union_below_P", "panno", "empty_slot",
                   "walk_separated", "walk_ended", "walk_a_before",
                   "walk_b_before", "walk_overlap", "walk_both_in",
                   "walk_not_both_in", "bundle_fwd", "bundle_rev"):
        assert seen[branch] > 0, (branch, seen)


def test_sweep_inputs_reach_the_hard_cases():
    """chip_smoke's PAIR_SWEEP (at most 512 reads a case) holds every case
    named in its comment, each in some case's plain outputs or inputs."""
    seen = Counter()
    for k, (B, KB1, NL, P, kw0) in enumerate(PAIR_SWEEP["pair_grid"]):
        arrs, kw = pair_grid_inputs(np.random.default_rng(k), min(B, 512),
                                    KB1, NL, P, **kw0)
        (sf_i, _, _, _, cn4, _, _, iv_tids, iv_ntid, iv_nseg_true, iv_nseg,
         seg_gene_p, _, _) = arrs
        NIV, ST = iv_tids.shape
        pg = tfull.pair_grid(*_torch(arrs), **kw)
        nu = pg.n_union.numpy()
        seen["n_union_0"] += (nu == 0).sum()
        seen["n_union_P"] += (nu == P).sum()
        seen["n_union_past_P"] += (nu > P).sum()
        valid = np.arange(KB1)[None, None, :] < cn4[:, :, None]
        iv = sf_i[..., IV_L]
        seen["iv_-1"] += (valid & (iv == -1)).sum()
        seen["iv_past_table"] += (valid & (iv >= NIV)).sum()
        seen["tids_over_pad"] += (iv_ntid > ST).sum()
        seen["tids_full"] += (iv_tids >= 0).all(1).sum()
        seen["tid_hole"] += ((iv_tids[:, :-1] < 0) & (iv_tids[:, 1:] >= 0)
                             ).sum()
        seen["segs_over_pad"] += (iv_nseg_true > kw["SEG_PAD"]).sum()
        seen["segs_past_width"] += (iv_nseg > seg_gene_p.shape[1]).sum()
        seen["cells_past_64"] += KB1 * KB1 > 64
        seen["P_past_32"] += P > 32
        seen["P_past_cells"] += P > KB1 * KB1
        end = sf_i[..., LASTR].astype(np.int64) + kw["k"]
        seen["end_wraps"] += (end > I32MAX).sum()
        seen["tlen_at_limit"] += (pg.tlen_g.numpy() == MAXDISCRDTLEN).sum()
        d = pg.defer.numpy()
        seen["panno"] += (d & tfull.DEF_PANNO != 0).sum()
        seen["union"] += (d & tfull.DEF_UNION != 0).sum()
    assert all(v > 0 for v in seen.values()) and len(seen) == 17, seen


# --------------------------------------------------------------------------
# the C source, the arguments and the card path on the CPU
# --------------------------------------------------------------------------

def test_source_constants_follow_the_python_ones():
    src = open(SRC).read()
    body = re.search(r"enum SfInt \{([^}]*)\}", src).group(1)
    names = [w.strip() for w in body.split(",")]
    assert names == ["SF_" + n.upper() for n in tfull.SF_INT] + ["SF_INTS"]
    assert len(tfull.SF_DP) == 16 and NI == len(tfull.SF_INT) + 16
    assert "constexpr int NI = SF_INTS + 16;" in src
    assert f"constexpr int NB = {NB};" in src
    assert tfull.MATE_INT[-2:] == ("seq_len", "arow")
    assert f"constexpr int32_t MAXDISCRDTLEN = {MAXDISCRDTLEN};" in src
    assert f"constexpr int32_t INF = {INF};" in src
    assert tfull.DEF_PANNO == 1 << 5 and tfull.DEF_UNION == 1 << 6
    assert "constexpr int32_t DEF_PANNO = 1 << 5;" in src
    assert "constexpr int32_t DEF_UNION = 1 << 6;" in src
    assert f"constexpr long long PG_SMEM_MAX = {tfull.PAIR_SMEM_MAX};" in src
    threads = int(re.search(r"constexpr int PG_THREADS = (\d+);",
                            src).group(1))
    assert threads % 32 == 0 and threads >= 64     # a warp an orientation
    assert re.search(r"__global__ void __launch_bounds__\(PG_THREADS\)\s+"
                     r"pair_grid_kernel\(", src)
    assert "pair_grid" in _ext.LAUNCHES


def test_shared_memory_follows_the_source():
    """pair_grid_smem is the source's pg_smem (its expressions evaluated
    here with the source's constants)."""
    src = open(SRC).read()
    words = re.search(r"pg_words\(int KB1[^{]*\{\s*return ([^;]*);",
                      src).group(1)
    nbytes = re.search(r"const long long bytes = ([^;]*);", src).group(1)
    const = dict(NI=NI, NB=NB, M_WORDS=12)
    assert "M_WORDS = 12" in src

    def ev(expr, **dims):
        return eval(" ".join(expr.replace("LL", "").split()), {},
                    {**const, **dims})
    for dims in (dict(KB1=7, NL=6, ST=16, SP=16, P=8),
                 dict(KB1=12, NL=4, ST=16, SP=16, P=40),
                 dict(KB1=1, NL=1, ST=1, SP=1, P=1),
                 dict(KB1=40, NL=17, ST=33, SP=5, P=9)):
        want = (4 * ev(words, **dims) + ev(nbytes, **dims) + 15) // 16 * 16
        assert tfull.pair_grid_smem(**dims) == want, dims


def test_kernel_args_follow_the_c_signature():
    args, kw = pair_case("pair_grid", PAIR_SWEEP["pair_grid"][1], "cpu", 0)
    outs = tfull.pair_grid(*args, **kw)
    spec = _ext.KERNELS["pair_grid"]
    pg_args = tfull.pair_grid_args(*args, *outs)
    assert len(pg_args) == len(spec.tensors)
    for x, dtype, shape in pg_args:
        assert x.dtype == dtype and tuple(x.shape) == tuple(shape) \
            and x.is_contiguous(), (x.dtype, tuple(x.shape), shape)
    assert c_params(SRC)[spec.sym] == [*spec.tensors, *spec.statics,
                                       "stream"]


class _Cuda(torch.Tensor):
    """A CPU tensor that takes a wrapper's card path."""
    @property
    def is_cuda(self):
        return True


def test_card_path_is_one_launch_on_the_inputs_in_place(monkeypatch):
    launched = []

    def launch(name, args, statics):
        launched.append((name, [x.data_ptr() for x, _, _ in args],
                         tuple(statics)))
    monkeypatch.setattr(_ext, "launch_tensors", launch)
    args, kw = pair_case("pair_grid", PAIR_SWEEP["pair_grid"][3], "cpu", 2)
    out = tfull.pair_grid(args[0].as_subclass(_Cuda), *args[1:], **kw)
    [(name, ptrs, statics)] = launched
    assert name == "pair_grid"
    assert ptrs[:len(args)] == [a.data_ptr() for a in args]
    assert ptrs[len(args):] == [x.data_ptr() for x in out]
    B, _, KB1, NL = args[2].shape
    assert statics == (B, KB1, NL, kw["P"], kw["k"], *args[7].shape,
                       args[11].shape[1], kw["SEG_PAD"], args[12].shape[0])


def test_card_path_refuses_what_the_kernel_cannot_stage(monkeypatch):
    """Past a block's shared memory (KB1 = 160 at NL = 6 stages 305,408
    B), for an empty table and for a staged input off a 16-byte boundary
    the card path raises, launching nothing."""
    monkeypatch.setattr(_ext, "launch_tensors", None)
    for KB1, NG, skew in ((160, 4, 0), (7, 0, 0), (7, 4, 1)):
        assert (tfull.pair_grid_smem(KB1, 6, 16, 16, 8)
                > tfull.PAIR_SMEM_MAX) == (KB1 == 160)
        i32 = torch.int32
        sf_i = torch.zeros(4 * KB1 * NI + skew, dtype=i32)[skew:]
        args = [sf_i.reshape(1, 4, KB1, NI).as_subclass(_Cuda),
                torch.zeros((1, 4, KB1, NB), dtype=torch.bool),
                *(torch.zeros((1, 4, KB1, 6), dtype=i32) for _ in range(2)),
                *(torch.zeros((1, 4), dtype=i32) for _ in range(2)),
                torch.zeros((1,), dtype=i32),
                torch.zeros((5, 16), dtype=i32),
                *(torch.zeros((5,), dtype=i32) for _ in range(3)),
                torch.zeros((5, 16), dtype=i32),
                *(torch.zeros((NG,), dtype=i32) for _ in range(2))]
        with pytest.raises(ValueError,
                           match="shared memory|non-empty|16-byte"):
            tfull.pair_grid(*args, k=20, P=8, SEG_PAD=16)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def _card_cases(device):
    for k, spec in enumerate(PAIR_SWEEP["pair_grid"]):
        args, kw = pair_case("pair_grid", spec, device, 7 + k)
        yield spec, tensor_kernel_calls("pair_grid", args, kw)


@pytest.mark.cuda
def test_pair_grid_matches_plain_on_card(cuda_device):
    for spec, (kern, plain) in _card_cases(cuda_device):
        _ext.reset_launches()
        got = kern()
        assert _ext.LAUNCHES["pair_grid"] == 1, spec
        for g, w in zip(got, plain()):
            assert g.dtype == w.dtype and torch.equal(g, w), spec


@pytest.mark.cuda
def test_pair_grid_replays_in_a_cuda_graph(cuda_device):
    for spec, (kern, plain) in _card_cases(cuda_device):
        kern()                           # load the library outside capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kern()
        for x in out:
            x.fill_(True if x.dtype == torch.bool else -7)
        graph.replay()
        for g, w in zip(out, plain()):
            assert torch.equal(g, w), spec
