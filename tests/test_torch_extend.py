"""Phase 2's extend kernels of csrc/extend.cu on the CPU: ``extend_core``
(phase 2's four extend families) and ``extend_leftover`` (the leftover
chain-level extends, the same wrap-up); the chain-order walk
``_is_left_chain``, which csrc/pair_grid.cu runs per pair slot; and the
interval bisect ``_bisect_le``, now one searchsorted.

- The port's plain ``_extend_core`` (left and right, without and with the
  walk engine's fold), ``_is_left_chain`` (NL 1-15, chain lengths 0 to NL,
  separated, touching and interleaved chains) and ``_bisect_le`` (n = 1
  to 5,000 against the reference's loop, a spread of n against the JAX
  function itself, duplicates, int32 extremes, n = 0, probes of shapes
  [B, 4, 7] and flat) against the JAX functions, bit-equal, on inputs
  made with numpy from a seed (``chip_smoke``'s generators, the kernels'
  adversarial sweep); the wrappers' plain versions against the
  reference's compositions (run_side, the leftover pair of calls, the
  gathers before its _is_left_chain).
- The arrays both callers bisect (``AnnoDevice.iv_spos``,
  ``FinishAnnoDevice.shift_bounds``) are non-decreasing on a genome of
  three chromosomes packed into one contig.
- A scalar transcription of each kernel's per-thread code (its loads
  included; pair_grid's slot thread's walk on its staged chains) against
  the plain versions, with counts that show every branch taken.
- Each ``*_args`` list (pair_grid's too) against the C signature parsed
  from its source, and the sources' constants against the Python ones.
- The card path on CPU tensors that report ``is_cuda``: one launch a call,
  the inputs handed over in place.
- ``cuda``-marked (skipped without a card): each extend kernel bit-equal
  to its plain version over chip_smoke's EXTEND_SWEEP, eagerly and
  replayed from a captured CUDA graph (pair_grid's: test_torch_pairgrid).

Every output is an integer: every comparison is exact (tolerance 0)."""

import re
from collections import Counter
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (EXTEND_SWEEP, I32MAX, PAIR_SWEEP, c_params,
                        extend_case, extend_core_inputs,
                        extend_leftover_inputs, is_left_chain_inputs,
                        pair_case, tensor_kernel_calls)
from circminer_tpu.ops import device_full as jfull
from circminer_tpu_torch.config import INF
from circminer_tpu_torch.ops import _ext
from circminer_tpu_torch.ops import device_full as tfull
from circminer_tpu_torch.ops.device_walk import FOLD_OUT, KEYS

NEG_SCORE = tfull.NEG_SCORE
SRC = f"{_ext._CSRC}/extend.cu"
PAIR_SRC = f"{_ext._CSRC}/pair_grid.cu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def w32(x):
    """x as int32 with two's-complement wrap-around."""
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


def _torch(arrays):
    return [torch.from_numpy(np.require(a, requirements="C"))
            for a in arrays]


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, want.dtype, got.shape, want.shape)
    assert np.array_equal(got, want), (what, np.argwhere(got != want)[:3])


def core_case(seed, B=40, P=8, fam=1, left=True, active=0.5):
    return extend_core_inputs(np.random.default_rng(seed), B, P, fam=fam,
                              left=left, active=active)


def _core_parts(arrays, lib):
    """(plain _extend_core's flat operands, eng) of an extend_core_inputs
    case, as tensors of ``lib`` (torch or jnp): the walk DP as given (the
    selection by wx is the wrappers' business) and the fold's rows as the
    engine's result."""
    (pos, length, ed_th, bound, has_tids, iv, exon_len, covered, wx,
     walk_inb, gen_inb, *rest) = arrays
    gdp, wdp, fold, over, act = rest[:4], rest[4:8], rest[8], rest[9], \
        rest[10]
    t = torch.from_numpy if lib is torch else jnp.asarray

    def flat(x):
        return t(np.ascontiguousarray(x).reshape(-1))
    keys = ("ed", "sclen", "indel", "score")
    ops = (flat(pos), flat(length), flat(ed_th), flat(bound),
           flat(has_tids), flat(iv >= 0), flat(exon_len),
           {k: flat(x) for k, x in zip(keys, wdp)},
           flat(covered & walk_inb), {k: flat(x) for k, x in zip(keys, gdp)},
           flat(gen_inb))
    N = pos.size
    eng = dict(active=flat(act[1]), best=dict(zip(KEYS, map(t, fold[:6]))),
               consec=t(fold[6] != 0),
               defer=t((fold[7] != 0) | over.reshape(4, N)[1]))
    return ops, eng


# --------------------------------------------------------------------------
# the plain versions against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_eng", [False, True], ids=["no_eng", "eng"])
@pytest.mark.parametrize("left", [True, False], ids=["left", "right"])
def test_plain_extend_core_matches_jax(left, with_eng):
    """_extend_core itself: bounds at I32MAX, 0, INT32_MIN and at the gate,
    positions near both int32 ends, lengths <= 0, every tie of the score
    update; without the engine (the leftover's form) and with it."""
    arrays, kw = core_case(3 + 2 * left + with_eng, left=left)
    kw = dict(left=left, max_sc=kw["max_sc"], band=kw["band"])
    ops_t, eng_t = _core_parts(arrays, torch)
    ops_j, eng_j = _core_parts(arrays, jnp)
    got = tfull._extend_core(*ops_t, eng=eng_t if with_eng else None, **kw)
    want = jax.jit(partial(jfull._extend_core, **kw))(
        *ops_j, eng=eng_j if with_eng else None)
    for what, g, w in zip(("ok", "pos", "best", "defer"), got, want):
        if isinstance(w, dict):
            assert list(g) == list(KEYS) and sorted(w) == sorted(KEYS)
            for k in w:
                _same(g[k].numpy(), w[k], f"best.{k}")
        else:
            _same(g.numpy(), w, what)
    # the case is not vacuous: every outcome occurs
    ok, pos, best, defer = (x.numpy() if torch.is_tensor(x) else x
                            for x in got)
    assert ok.any() and (~ok).any() and (best["score"] == NEG_SCORE).any()
    assert (pos != ops_t[0].numpy()).any() and defer.any()


def _jax_run_side(arrays, fam, left, max_sc, band):
    """The reference's run_side (circminer_tpu/ops/device_full.py:1060)
    on one extend_core_inputs case, its walk_fold result read from the
    fold's rows as the port's walk_fold unpacks them (held to the
    reference's by tests/test_torch_walkkernels.py)."""
    (pos, length, ed_th, bound, has_tids, iv, exon_len, covered, wx,
     walk_inb, gen_inb, *rest) = (jnp.asarray(a) for a in arrays)
    keys = ("ed", "sclen", "indel", "score")
    gen, walk_dp = dict(zip(keys, rest[:4])), dict(zip(keys, rest[4:8]))
    fold, over, act = rest[8], rest[9], rest[10]
    shp = pos.shape
    rows = fold.reshape(len(FOLD_OUT), *shp)
    eng = dict(active=act[fam], best=dict(zip(KEYS, rows[:6])),
               consec=rows[6] != 0,
               defer=(rows[7] != 0) | over.reshape(4, *shp)[fam])
    walk = jfull._ares_where(wx, walk_dp, gen)
    walk_ok = covered & jnp.where(wx, walk_inb, gen_inb)
    return jfull._extend_core_flat(pos, length, ed_th, bound, has_tids,
                                   iv >= 0, exon_len, walk, walk_ok, gen,
                                   gen_inb, eng=eng, left=left,
                                   max_sc=max_sc, band=band)


@pytest.mark.parametrize("fam,left", [(0, True), (1, True), (2, False),
                                      (3, False)])
def test_plain_extend_core_wrapper_matches_jax_run_side(fam, left):
    arrays, kw = core_case(20 + fam, B=24, fam=fam, left=left)
    got = tfull.extend_core(*_torch(arrays), **kw)
    want = _jax_run_side(arrays, fam, left, kw["max_sc"], kw["band"])
    for what, g, w in zip(("ok", "pos", "best", "defer"), got, want):
        if isinstance(w, dict):
            for i, k in enumerate(KEYS):
                _same(g[i].numpy(), w[k], f"best.{k}")
        else:
            _same(g.numpy(), w, what)
    assert got[3].any() and got[0].any()


def test_plain_extend_leftover_matches_jax():
    """The leftover wrapper against the reference's two
    _extend_core_flat calls, fed real-looking iv / exon_len (which no
    lane without transcripts reads)."""
    rng = np.random.default_rng(31)
    arrays, kw = extend_leftover_inputs(rng, 24, 7, 6)
    (rp4, qp4, pos_r, remain_end, est_mid, genL, genR, *dps) = arrays
    shp = pos_r.shape
    iv_l, iv_r = (rng.integers(-1, 9, shp).astype(np.int32)
                  for _ in range(2))
    ex_l, ex_r = (rng.integers(-2, 50, shp).astype(np.int32)
                  for _ in range(2))
    ok, pos, best = tfull.extend_leftover(*_torch(arrays), **kw)
    j = jnp.asarray
    dp = [j(x) for x in dps]
    no = jnp.zeros(shp, jnp.bool_)

    def side(s):
        return dict(zip(("ed", "sclen", "indel", "score"),
                        (x[..., s, 0] for x in dp)))
    fk = dict(max_sc=kw["max_sc"], band=kw["band"])
    lok, spos, bl, _ = jfull._extend_core_flat(
        j(rp4[..., 0]), j(qp4[..., 0]), kw["max_ed"] - j(est_mid),
        jnp.zeros(shp, jnp.int32), no, j(iv_l) >= 0, j(ex_l), side(0), no,
        side(0), j(genL), left=True, **fk)
    rok, epos, br, _ = jfull._extend_core_flat(
        j(pos_r), j(remain_end), kw["max_ed"] - j(est_mid) - bl["ed"],
        jnp.full(shp, I32MAX, jnp.int32), no, j(iv_r) >= 0, j(ex_r),
        side(1), no, side(1), j(genR), left=False, **fk)
    _same(ok.numpy(), np.stack([lok, rok]), "ok")
    _same(pos.numpy(), np.stack([spos, epos]), "pos")
    for s, b in enumerate((bl, br)):
        for i, k in enumerate(KEYS):
            _same(best[s, i].numpy(), b[k], f"best[{s}].{k}")
    assert ok[0].any() and (~ok[1]).any()


def _jax_is_left(arrays, k):
    """The reference's gathers and _is_left_chain (device_full.py:993)."""
    rp4, qp4, clen4, lens4, pi, pj = (jnp.asarray(a) for a in arrays)
    frows, vrows = jnp.array([0, 2]), jnp.array([3, 1])

    def along(x, rows, idx):
        xr = x[:, rows]
        ix = idx.reshape(*idx.shape, *([1] * (xr.ndim - 3)))
        return jnp.take_along_axis(xr, ix, axis=2)
    return jfull._is_left_chain(
        along(rp4, frows, pi), along(qp4, frows, pi), along(clen4, frows, pi),
        along(rp4, vrows, pj), along(qp4, vrows, pj), along(clen4, vrows, pj),
        jnp.broadcast_to(lens4[:, frows][..., None], pi.shape),
        rp4.shape[-1], k)


@pytest.mark.parametrize("NL", [1, 2, 3, 6, 15])
def test_plain_is_left_chain_matches_jax(NL):
    """Chain lengths 0 to NL, chains separated, touching, sharing an end
    base and interleaved, ends that wrap past I32MAX; the port's
    _is_left_chain on the slots' gathered chains."""
    for k in (20, 3):
        arrays, kw = is_left_chain_inputs(np.random.default_rng(NL + k),
                                          48, 7, NL, 8, k=k)
        got = tfull._is_left_chain_plain(*_torch(arrays), **kw)
        _same(got.numpy(), _jax_is_left(arrays, k), f"NL={NL} k={k}")
        assert got.any() and (~got).any()


def test_plain_is_left_chain_core_matches_jax():
    """_is_left_chain on fragment rows of every (a_len, b_len) in 0..NL."""
    rng = np.random.default_rng(5)
    for NL in range(1, 16):
        n = (NL + 1) ** 2 * 4
        la, lb = np.meshgrid(np.arange(NL + 1), np.arange(NL + 1))
        a_len = np.tile(la.ravel(), 4).astype(np.int32)
        b_len = np.tile(lb.ravel(), 4).astype(np.int32)
        start = rng.integers(1000, 1200, (2, n))
        rp = (start[..., None] + np.cumsum(
            rng.integers(17, 60, (2, n, NL)), axis=-1)).astype(np.int32)
        qp = np.cumsum(rng.integers(0, 24, (2, n, NL)), axis=-1).astype(
            np.int32)
        rl = rng.integers(10, 20 * NL + 5, n).astype(np.int32)
        args = (rp[0], qp[0], a_len, rp[1], qp[1], b_len, rl, NL, 20)
        got = tfull._is_left_chain(*(torch.from_numpy(x) for x in args[:7]),
                                   NL, 20)
        want = jax.jit(jfull._is_left_chain, static_argnums=(7, 8))(
            *(jnp.asarray(x) for x in args[:7]), NL, 20)
        _same(got.numpy(), want, f"NL={NL}")


def _bisect_loop(arr, x):
    """The reference's _bisect_le loop (device_full.py:50) in numpy."""
    n = arr.shape[0]
    lo = np.zeros_like(x)
    hi = np.full_like(x, n)
    for _ in range(int(np.ceil(np.log2(max(2, n + 1)))) + 1):
        active = lo < hi
        mid = (lo + hi) >> 1
        right = arr[np.clip(mid, 0, n - 1)] <= x
        lo = np.where(active & right, mid + 1, lo)
        hi = np.where(active & ~right, mid, hi)
    return lo - 1


def _sorted(rng, n):
    """A non-decreasing int32 array of n: duplicates (runs), and the int32
    extremes at both ends for a share of n."""
    arr = np.sort(rng.integers(-50, 50, n) * rng.integers(1, 4)).astype(
        np.int64)
    if n > 2 and n % 3 == 0:
        arr[0], arr[-1] = -2 ** 31, 2 ** 31 - 1
    return np.sort(arr).astype(np.int32)


def _probes(rng, arr, shape):
    """Probes at every element, one past and one before it, and at both
    int32 ends."""
    pool = np.concatenate([arr.astype(np.int64), arr.astype(np.int64) + 1,
                           arr.astype(np.int64) - 1,
                           [-2 ** 31, 2 ** 31 - 1, 0]])
    pool = np.clip(pool, -2 ** 31, 2 ** 31 - 1)
    return rng.choice(pool, size=shape).astype(np.int32)


def test_bisect_le_is_the_reference_loop_for_every_n():
    """n = 1 to 5,000: the searchsorted index equals the reference's loop
    (its numpy transcription) on probes at, before and after every
    element."""
    rng = np.random.default_rng(0)
    for n in range(1, 5001):
        arr = _sorted(rng, n)
        x = _probes(rng, arr, 64)
        got = tfull._bisect_le(torch.from_numpy(arr), torch.from_numpy(x))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), _bisect_loop(arr, x)), n


@pytest.mark.parametrize("shape", [(5, 4, 7), (96,)], ids=["B47", "flat"])
def test_bisect_le_matches_jax(shape):
    """The JAX function itself on a spread of n (powers of two and their
    neighbours, 5,000), probes of the fused step's [B, 4, 7] and flat
    shapes; at n = 0 both raise."""
    rng = np.random.default_rng(len(shape))
    for n in (1, 2, 3, 4, 7, 8, 9, 31, 32, 33, 255, 256, 257, 1000, 1023,
              1024, 1025, 4096, 5000):
        arr = _sorted(rng, n)
        x = _probes(rng, arr, shape)
        got = tfull._bisect_le(torch.from_numpy(arr), torch.from_numpy(x))
        want = jax.jit(jfull._bisect_le)(jnp.asarray(arr), jnp.asarray(x))
        _same(got.numpy(), want, f"n={n}")
        # a non-contiguous probe (the step bisects column 0 of [B, 4, KB1,
        # NL] fragments) gives the same index
        wide = torch.from_numpy(np.stack([x, x], -1))[..., 1]
        assert np.array_equal(
            tfull._bisect_le(torch.from_numpy(arr), wide).numpy(), want)
    empty = np.zeros(0, np.int32)
    x = _probes(rng, np.array([1], np.int32), shape)
    with pytest.raises(ValueError, match="non-empty"):
        tfull._bisect_le(torch.from_numpy(empty), torch.from_numpy(x))
    with pytest.raises(TypeError):
        jfull._bisect_le(jnp.asarray(empty), jnp.asarray(x))


def test_bisected_arrays_are_sorted(tmp_path):
    """Both callers' arrays are non-decreasing by construction: iv_spos
    (the monotone int32 clip of the annotation's sorted interval starts)
    and shift_bounds (the contig's chromosome shifts), here on a genome of
    three chromosomes packed into one contig."""
    from circminer_tpu_torch.annotation.annotation import AnnotationDB
    from circminer_tpu_torch.annotation.device import (AnnoDevice,
                                                       FinishAnnoDevice)
    from circminer_tpu_torch.config import Config
    from circminer_tpu_torch.io.fasta import GenomePacker
    from circminer_tpu_torch.sim import make_genome
    ref, gtf = str(tmp_path / "ref.fa"), str(tmp_path / "ref.gtf")
    for ci, chrom in enumerate(("chrA", "chrB", "chrC")):
        g = make_genome(np.random.default_rng(ci), length=30_000, n_genes=3,
                        chrom=chrom, gene_prefix=f"{chrom}.G")
        g.write_fasta(ref, width=0, append=True)
        g.write_gtf(gtf, append=True)
    cfg = Config(kmer=20, max_read_len=100)
    contigs, info = GenomePacker(ref).pack_genome()
    db = AnnotationDB.from_gtf(gtf, info, 1, cfg,
                               contig_lengths=[len(c) for c in contigs])
    assert len(contigs) == 1
    ad = AnnoDevice.from_contig(db.contigs[0], seg_pad=16, device="cpu")
    fa = FinishAnnoDevice.from_contig(db.contigs[0], db.con2chr[0],
                                      seg_pad=16, device="cpu")
    for name, arr in (("iv_spos", ad.iv_spos),
                      ("shift_bounds", fa.shift_bounds)):
        a = arr.numpy()
        assert a.dtype == np.int32 and (np.diff(a.astype(np.int64)) >= 0)\
            .all(), name
    assert fa.shift_bounds.shape[0] == 3 and ad.iv_spos.shape[0] > 10


# --------------------------------------------------------------------------
# scalar transcriptions of the kernels' per-thread code
# --------------------------------------------------------------------------

def extend_one(s, left, max_sc, band, seen):
    """csrc/extend.cu's extend_one on one slot's Side ``s`` (a dict),
    counting the branches it takes in ``seen``.  Returns (ok, pos, best
    tuple in KEYS order, defer)."""
    orig, ln, eth, bound = s["pos"], s["length"], s["ed_th"], s["bound"]
    best = [orig, w32(eth + 1), w32(ln + 1), band + 1, 0, 0]

    def better(c):
        pos_better = c[0] > best[0] if left else c[0] < best[0]
        return best[5] < c[5] or (best[5] == c[5] and pos_better)
    covered = s["iv_ok"] and s["exon_len"] >= ln
    walk_active = s["has_tids"] and s["iv_ok"] and ln > 0
    defer = (s["eng_active"] and s["eng_defer"]) if s["eng"] \
        else (walk_active and not covered)
    gate_ok = orig >= w32(bound + ln) if left else w32(orig + ln) <= bound
    do_walk = walk_active and covered and gate_ok
    seen["gate_refused"] += walk_active and covered and not gate_ok
    consecutive = do_walk
    ed, sc, ind, scr = s["wdp"]
    if do_walk and s["walk_ok"] and ed <= eth and sc <= max_sc \
            and w32(ln - sc) >= sc:
        seen["walk_gate"] += 1
        c = [w32(w32(orig - ln) + ind) if left else w32(w32(orig + ln) - ind),
             ed, sc, ind, ln, scr]
        if better(c):
            seen["walk_better"] += 1
            best = c
    if s["eng"] and s["eng_active"]:
        seen["engine"] += 1
        best = list(s["eng_best"])
        consecutive = consecutive or s["eng_consec"]
    st1 = best[1] <= eth
    pos_out = (w32(best[0] + best[2]) if left else w32(best[0] - best[2])) \
        if st1 else orig
    done = st1 and best[4] >= ln and best[2] <= max_sc
    seen["stage1"] += done
    ok = done
    ed, sc, ind, scr = s["gdp"]
    if not done and not consecutive and s["gen_ok"] and ln > 0 \
            and ed <= eth and sc <= max_sc:
        seen["gen_gate"] += 1
        gp = w32(w32(orig - ln) + ind) if left else w32(w32(orig + ln) - ind)
        c = [gp, ed, sc, ind, ln, scr]
        if better(c):
            seen["gen_better"] += 1
            best = c
            pos_out = w32(gp + sc) if left else w32(gp - sc)
            ok = done = True
    if not done and best[4] <= 0:
        seen["tail_zero"] += 1
        pos_out = orig
        best = [orig, 0, 0, 0, 0, NEG_SCORE]
    qrem = w32(ln - best[4])
    if not done and w32(qrem + best[2]) <= max_sc:
        seen["soft_clip"] += 1
        best = [pos_out, best[1], w32(best[2] + qrem), best[3], ln, best[5]]
        ok = done = True
    if not done:
        seen["last"] += 1
        ok = best[4] >= ln and best[1] <= eth
    if ln <= 0:
        seen["triv"] += 1
        ok, pos_out, best = True, orig, [bound, 0, 0, 0, 0, NEG_SCORE]
    defer = defer and ln > 0
    seen["defer"] += defer
    return ok, pos_out, tuple(best), defer


def extend_core_scalar(arrays, fam, left, max_sc, band, seen):
    """extend_core_kernel's threads in turn: its loads (the walk DP
    only where it can be taken, the fold only where the lane is active),
    extend_one, its stores."""
    flat = [np.ascontiguousarray(a).reshape(-1) for a in arrays[:19]]
    (pos, length, ed_th, bound, has_tids, iv, exon_len, covered, wx,
     walk_inb, gen_inb) = flat[:11]
    gdp, wdp = flat[11:15], flat[15:19]
    fold, over, act = arrays[19], arrays[20].reshape(-1), \
        arrays[21].reshape(-1)
    N = pos.size
    out = []
    for i in range(N):
        s = dict(pos=int(pos[i]), length=int(length[i]),
                 ed_th=int(ed_th[i]), bound=int(bound[i]),
                 has_tids=bool(has_tids[i]), iv_ok=bool(iv[i] >= 0),
                 exon_len=int(exon_len[i]), gen_ok=bool(gen_inb[i]),
                 gdp=tuple(int(x[i]) for x in gdp), eng=True)
        s["walk_ok"] = bool(covered[i]) and (bool(walk_inb[i]) if wx[i]
                                             else s["gen_ok"])
        take = bool(wx[i]) and s["walk_ok"] and s["has_tids"]
        seen["walk_dp_read"] += take
        s["wdp"] = tuple(int(x[i]) for x in wdp) if take else s["gdp"]
        s["eng_active"] = bool(act[fam * N + i])
        s.update(eng_consec=False, eng_defer=False, eng_best=(0,) * 6)
        if s["eng_active"]:
            s["eng_best"] = tuple(int(fold[r, i]) for r in range(6))
            s["eng_consec"] = bool(fold[6, i])
            s["eng_defer"] = bool(fold[7, i]) or bool(over[fam * N + i])
        out.append(extend_one(s, left, max_sc, band, seen))
    return out


def _rows_of(got):
    ok, pos, best, defer = got
    return list(zip(ok.reshape(-1).tolist(), pos.reshape(-1).tolist(),
                    zip(*(b.reshape(-1).tolist() for b in best)),
                    defer.reshape(-1).tolist()))


def test_extend_core_thread_code_matches_plain():
    """The kernel's per-slot code (loads, extend_one, both sides) against
    the plain wrapper on the sweep's generator; every branch taken."""
    seen = Counter()
    for fam, left in ((0, True), (1, True), (2, False), (3, False)):
        for active in (0.0, 0.5, 1.0):
            arrays, kw = core_case(50 + 3 * fam + int(4 * active), B=20,
                                   fam=fam, left=left, active=active)
            want = _rows_of(tfull.extend_core(*_torch(arrays), **kw))
            got = extend_core_scalar(arrays, fam, left, kw["max_sc"],
                                     kw["band"], seen)
            assert [(o, p, tuple(b), d) for o, p, b, d in got] == \
                [(bool(o), p, tuple(b), bool(d)) for o, p, b, d in want]
    for branch in ("gate_refused", "walk_gate", "walk_better", "engine",
                   "stage1", "gen_gate", "gen_better", "tail_zero",
                   "soft_clip", "last", "triv", "defer", "walk_dp_read"):
        assert seen[branch] > 0, (branch, seen)


def test_extend_leftover_thread_code_matches_plain():
    """extend_leftover_kernel: a chain's left extend from rp4 / qp4
    column 0 against 0, then its right one against I32MAX with the ed_th
    the left one left; every branch of both taken."""
    seen = Counter()
    for seed, (B, KB1, NL) in enumerate(((24, 7, 6), (5, 3, 1),
                                         (9, 16, 15))):
        arrays, kw = extend_leftover_inputs(np.random.default_rng(seed),
                                            B, KB1, NL)
        ok, pos, best = tfull.extend_leftover(*_torch(arrays), **kw)
        rp4, qp4, pos_r, rem, est, gl, gr, *dps = (
            np.ascontiguousarray(a) for a in arrays)
        N = pos_r.size
        dps = [x.reshape(N, 2, 2) for x in dps]
        for i in range(N):
            eth = w32(kw["max_ed"] - int(est.reshape(-1)[i]))
            sides = ((int(rp4.reshape(N, NL)[i, 0]),
                      int(qp4.reshape(N, NL)[i, 0]), 0, gl),
                     (int(pos_r.reshape(-1)[i]), int(rem.reshape(-1)[i]),
                      I32MAX, gr))
            for s, (p, ln, bound, gen) in enumerate(sides):
                side = dict(pos=p, length=ln, ed_th=eth, bound=bound,
                            exon_len=0, has_tids=False, iv_ok=False,
                            walk_ok=False, gen_ok=bool(gen.reshape(-1)[i]),
                            gdp=tuple(int(x[i, s, 0]) for x in dps),
                            eng=False, eng_active=False)
                side["wdp"] = side["gdp"]
                o, q, b, _ = extend_one(side, s == 0, kw["max_sc"],
                                        kw["band"], seen)
                assert (o, q, b) == (
                    bool(ok[s].reshape(-1)[i]), int(pos[s].reshape(-1)[i]),
                    tuple(int(best[s, r].reshape(-1)[i]) for r in range(6)))
                eth = w32(eth - b[1])
    for branch in ("gen_gate", "gen_better", "tail_zero", "soft_clip",
                   "last", "triv"):
        assert seen[branch] > 0, (branch, seen)
    # no walk or engine: best starts past ed_th, so stage 1 never closes
    assert seen["walk_gate"] == seen["engine"] == seen["defer"] \
        == seen["stage1"] == 0


def is_left_thread(rp4, qp4, clen4, lens4, pi, pj, t, k, seen):
    """pair_grid_kernel's slot thread t (csrc/pair_grid.cu's is_left): the
    read's [4, KB1, NL] fragments staged once, the slot's two chains
    through _mate_rows' rows, a separated pair answered from its ends, the
    merge walk that stops when done, the overlap test."""
    B, _, KB1, NL = rp4.shape
    P = pi.shape[2]
    b, o, p = t // (2 * P), (t // P) % 2, t % P
    fr, vr = 2 * o, 3 - 2 * o
    rp, qp = rp4[b].tolist(), qp4[b].tolist()      # the staged read
    fi = min(max(int(pi[b, o, p]), 0), KB1 - 1)
    vj = min(max(int(pj[b, o, p]), 0), KB1 - 1)
    A, Bf, QA, QB = rp[fr][fi], rp[vr][vj], qp[fr][fi], qp[vr][vj]
    a_len, b_len = int(clen4[b, fr, fi]), int(clen4[b, vr, vj])
    read_len = int(lens4[b, fr])

    def at(v, i):
        return v[min(max(i, 0), NL - 1)]
    a_end = w32(at(A, w32(a_len - 1)) + k - 1)
    b_end = w32(at(Bf, w32(b_len - 1)) + k - 1)
    if Bf[0] > a_end or A[0] > b_end:
        seen["separated"] += 1
        return A[0] < Bf[0]
    i = j = 0
    bd, bi, bj = INF, -1, -1
    for _ in range(2 * NL):
        if not (i < a_len and j < b_len):
            seen["walk_ended"] += 1
            break
        ai, bjb = at(A, i), at(Bf, j)
        ai_end, bj_end = w32(ai + k - 1), w32(bjb + k - 1)
        if ai_end < bjb:
            d = w32(bjb - ai_end)
            seen["a_before"] += 1
            if d < bd:
                seen["closer"] += 1
                bd, bi, bj = d, i, j
            i += 1
        elif bj_end < ai:
            d = w32(ai - bj_end)
            seen["b_before"] += 1
            if d < bd:
                seen["closer"] += 1
                bd, bi, bj = d, i, j
            j += 1
        else:
            seen["overlap"] += 1
            bi, bj = i, j
            break
    a_bp, b_bp = at(A, bi), at(Bf, bj)
    common = max(a_bp, b_bp)
    a_ov = w32(at(QA, bi) + w32(common - a_bp))
    b_ov = w32(at(QB, bj) + w32(common - b_bp))
    both_in = a_ov < read_len and b_ov < read_len and bi >= 0
    seen["both_in" if both_in else "not_both_in"] += 1
    return a_ov >= b_ov if both_in else A[0] < Bf[0]


def test_is_left_chain_thread_code_matches_plain():
    seen = Counter()
    for NL, k in ((1, 20), (2, 3), (6, 20), (15, 20), (17, 20), (6, 3)):
        arrays, kw = is_left_chain_inputs(np.random.default_rng(NL * k), 12,
                                          7, NL, 8, k=k)
        want = tfull._is_left_chain_plain(*_torch(arrays), **kw).reshape(-1)
        for t in range(want.numel()):
            assert is_left_thread(*arrays, t, k, seen) == bool(want[t]), \
                (NL, k, t)
    for branch in ("separated", "walk_ended", "a_before", "b_before",
                   "closer", "overlap", "both_in", "not_both_in"):
        assert seen[branch] > 0, (branch, seen)


# --------------------------------------------------------------------------
# the kernels' arguments, the C source, and the card path on the CPU
# --------------------------------------------------------------------------

def _args_ok(name, args):
    assert len(args) == len(_ext.KERNELS[name].tensors)
    for x, dtype, shape in args:
        assert x.dtype == dtype and tuple(x.shape) == tuple(shape) \
            and x.is_contiguous(), (name, x.dtype, tuple(x.shape), shape)


# the kernels whose arguments and card path these tests hold: csrc/
# extend.cu's and csrc/pair_grid.cu's, by their sweeps' cases
SWEEPS = {**EXTEND_SWEEP, **PAIR_SWEEP}


def _case(name, k, seed):
    case = pair_case if name in PAIR_SWEEP else extend_case
    return case(name, SWEEPS[name][k], "cpu", seed)


def _outs(name, args, kw):
    """Fresh outputs of the wrapper ``name`` for these inputs."""
    if name == "pair_grid":
        return tuple(torch.zeros_like(x)
                     for x in tfull.pair_grid(*args, **kw))
    if name == "extend_core":
        shp = args[0].shape
        return (torch.zeros(shp, dtype=torch.bool),
                torch.zeros(shp, dtype=torch.int32),
                torch.zeros((len(KEYS), *shp), dtype=torch.int32),
                torch.zeros(shp, dtype=torch.bool))
    shp = args[2].shape
    return (torch.zeros((2, *shp), dtype=torch.bool),
            torch.zeros((2, *shp), dtype=torch.int32),
            torch.zeros((2, len(KEYS), *shp), dtype=torch.int32))


ARGS_OF = {"extend_core": tfull.extend_core_args,
           "extend_leftover": tfull.extend_leftover_args,
           "pair_grid": tfull.pair_grid_args}


@pytest.mark.parametrize("name", list(SWEEPS))
def test_kernel_args_follow_the_c_signatures(name):
    """Each *_args list takes the spec's tensors, and each C entry point
    the spec's tensors, then its statics, then the stream."""
    args, kw = _case(name, 1, 0)
    _args_ok(name, ARGS_OF[name](*args, *_outs(name, args, kw)))
    spec = _ext.KERNELS[name]
    src = PAIR_SRC if name == "pair_grid" else SRC
    assert c_params(src)[spec.sym] == [*spec.tensors, *spec.statics,
                                       "stream"]


def test_source_constants_follow_the_python_ones():
    src = open(SRC).read()
    body = re.search(r"enum FoldRow \{([^}]*)\}", src).group(1)
    rows = [w.strip() for w in body.split(",")]
    assert rows == ["FD_" + r.upper() for r in FOLD_OUT] + ["FD_ROWS"]
    assert f"constexpr int32_t NEG_SCORE = {NEG_SCORE};" in src
    assert f"constexpr int32_t INF = {INF};" in open(PAIR_SRC).read()
    assert f"constexpr int32_t I32MAX = {I32MAX};" in src
    # each C entry point its own __global__ kernel and launch count
    for name in EXTEND_SWEEP:
        assert re.search(rf"__global__ void __launch_bounds__\(EXT_THREADS\)"
                         rf"\s+{name}_kernel\(", src), name
        assert name in _ext.LAUNCHES


class _Cuda(torch.Tensor):
    """A CPU tensor that takes a wrapper's card path."""
    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("name", list(SWEEPS))
def test_card_path_is_one_launch_on_the_inputs_in_place(name, monkeypatch):
    """On a CUDA tensor each wrapper launches its kernel once, handing it
    every input as it is (the same storage: nothing is copied or
    selected first) and fresh outputs, with the statics of the shapes."""
    launched = []

    def launch(kname, args, statics):
        _args_ok(kname, args)
        launched.append((kname, [x.data_ptr() for x, _, _ in args],
                         tuple(statics)))
    monkeypatch.setattr(_ext, "launch_tensors", launch)
    args, kw = _case(name, 0, 1)
    lead = 2 if name == "extend_leftover" else 0
    call = [a.as_subclass(_Cuda) if i == lead else a
            for i, a in enumerate(args)]
    kern, _ = tensor_kernel_calls(name, call, kw)
    out = kern()
    assert len(launched) == 1
    kname, ptrs, statics = launched[0]
    assert kname == name
    assert ptrs[:len(args)] == [a.data_ptr() for a in args]
    assert len(ptrs) == len(_ext.KERNELS[name].tensors)
    if name == "extend_core":
        assert statics == (args[0].numel(), kw["fam"], int(kw["left"]),
                           kw["max_sc"], kw["band"])
        assert len(out) == 4 and out[2].shape == (len(KEYS),
                                                  *args[0].shape)
    elif name == "extend_leftover":
        assert statics == (args[2].numel(), args[0].shape[-1],
                           kw["max_ed"], kw["max_sc"], kw["band"])
    else:
        B, _, KB1, NL = args[2].shape
        NIV, ST = args[7].shape
        assert statics == (B, KB1, NL, kw["P"], kw["k"], NIV, ST,
                           args[11].shape[1], kw["SEG_PAD"],
                           args[12].shape[0])
        assert out.mate_i.shape == (2, len(tfull.MATE_INT), B, 2, kw["P"])


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def _card_cases(device):
    for name, specs in EXTEND_SWEEP.items():
        for k, spec in enumerate(specs):
            args, kw = extend_case(name, spec, device, 7 + k)
            yield name, spec, tensor_kernel_calls(name, args, kw)


@pytest.mark.cuda
def test_extend_kernels_match_plain_on_card(cuda_device):
    for name, spec, (kern, plain) in _card_cases(cuda_device):
        _ext.reset_launches()
        got = kern()
        assert _ext.LAUNCHES[name] == 1, (name, spec)
        for g, w in zip(got, plain()):
            assert g.dtype == w.dtype and torch.equal(g, w), (name, spec)


@pytest.mark.cuda
def test_extend_kernels_replay_in_a_cuda_graph(cuda_device):
    """Each wrapper captured in a CUDA graph (the step's form) replays the
    plain version's outputs."""
    for name, spec, (kern, plain) in _card_cases(cuda_device):
        kern()                           # load the library outside capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kern()
        for x in out:
            x.fill_(True if x.dtype == torch.bool else -7)
        graph.replay()
        for g, w in zip(out, plain()):
            assert torch.equal(g, w), (name, spec)
