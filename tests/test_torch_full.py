"""The torch port's fused device-full step against the JAX reference on the
CPU: the DP pool family, ``device_full_finish`` at its cut points, the raw
int32 [B, MRF + 1] blob of ``device_full_step`` (defer bits included), the
seg_compact switch, and the gpu-full executor against native.

The library is tests/test_device_full.py's (80 kbp, 4 genes, linear +
circular + junk pairs) at both of its error rates, and for the executor a
third, ``pe150``: 2 x 150 bp reads at ``max_read_len`` 300 on the gene
window of the read that the reference's step ends one base short
(``case_window``; tests/test_torch_pe150.py).  Every output is an
integer, so every comparison is exact (tolerance 0).  The DP pools are
shrunk from the pipeline's sizes, identically for both packages, so the
plain torch DP versions stay quick on the CPU."""

import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from circminer_tpu.annotation.annotation import AnnotationDB
from circminer_tpu.config import Config
from circminer_tpu.index.build import build_genome_index
from circminer_tpu.io.fasta import GenomePacker
from circminer_tpu.ops import align as al
from circminer_tpu.ops import device_full as jfull
from circminer_tpu.ops import device_walk as jwalk
from circminer_tpu.ops.filter_native import NativeFilter
from circminer_tpu.pipeline.device_pipeline import \
    DeviceMappingPipeline as JaxPipeline
from circminer_tpu.pipeline.types import MatchedRead
from circminer_tpu.sim import make_genome, simulate_reads
from circminer_tpu_torch.annotation.device import (AnnoDevice,
                                                   FinishAnnoDevice)
from circminer_tpu_torch.ops import chain_device as tchain
from circminer_tpu_torch.ops import device_full as tfull
from circminer_tpu_torch.ops import device_walk as twalk
from circminer_tpu_torch.pipeline.device_pipeline import (
    ContigDeviceState, DeviceMappingPipeline, encode_pairs)
from test_device_full import FIELDS, make_pairs
from test_torch_align import _batch
from test_torch_selfcontained import port_config

BATCH = 64
W, MAX_ED, MAX_SC = 3, 4, 7
SM = al.ScoreMat()
# pools shrunk from _full_statics, for both packages alike
SMALL_POOLS = dict(OS_POOL=512, XD_POOL=1024, WPP=256, MIDP=128, ENDP=256)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _library(tmp, err):
    """tests/test_device_full.py's simulated library at error rate err."""
    rng = np.random.default_rng(int(err * 1000) + 3)
    g = make_genome(rng, length=80_000, n_genes=4)
    ref, gtf = str(tmp / "ref.fa"), str(tmp / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=100)
    contigs, info = GenomePacker(ref).pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, 1, cfg,
                               contig_lengths=[len(c) for c in contigs])
    reads, _ = simulate_reads(rng, g, 60, 30, read_len=100, err_rate=err)
    junk = []
    for i in range(8):
        s = "".join(rng.choice(list("ACGT"), 100))
        junk.append(type(reads[0])(f"junk{i}", s,
                                   reads[0].r2 if i % 2 else
                                   "".join(rng.choice(list("ACGT"), 100)),
                                   None, None))
    return cfg, gi, db, reads + junk


# the 150-bp case: read pair 5545 (s0_L21106, linear read 21106) of library
# 0 of seed 3000000013 in cmbench's chr21_pe150_l300.total, drawn from the
# configuration's chr21-scale genome; its r1 lies on gene 548 (index 547),
# where the native path ends it at 32,822,873
CASE_GENOME = dict(seed=20260817, length=47_000_000, n_genes=783,
                   dup_frac=0.05)
CASE_READS = dict(seed=3000000013, library=0, linear=21106, read_len=150,
                  frag_len=(200, 500), err_rate=0.005)
CASE_GENE, CASE_EPOS_R1 = 547, 32_822_873
PE150 = "pe150"


@functools.lru_cache(maxsize=1)
def case_window(pad=2000):
    """The case's gene cut from the chr21-scale genome with ``pad`` bases
    on each side, as a genome of its own (coordinates less ``off``), and
    the case's read: (genome, read, off)."""
    import dataclasses
    from circminer_tpu.sim import SimGenome, SimTranscript
    c = CASE_GENOME
    g = make_genome(np.random.default_rng(c["seed"]), length=c["length"],
                    n_genes=c["n_genes"], dup_frac=c["dup_frac"])
    gene = g.genes[CASE_GENE]
    assert gene.start <= CASE_EPOS_R1 <= gene.end
    r = CASE_READS
    # the library's linear reads come first, in the order drawn
    reads, _ = simulate_reads(
        np.random.default_rng([r["seed"], r["library"]]), g,
        r["linear"] + 1, 0, read_len=r["read_len"], frag_len=r["frag_len"],
        err_rate=r["err_rate"], name_prefix=f"s{r['library']}_")
    read = reads[-1]
    assert read.name == f"s0_L{r['linear']}"
    off = gene.start - pad - 1
    cut = dataclasses.replace(gene, start=gene.start - off,
                              end=gene.end - off, transcripts=[
        SimTranscript(t.tid, t.gene, [(a - off, b - off) for a, b in t.exons])
        for t in gene.transcripts])
    return SimGenome(g.chrom, g.seq[off:gene.end + pad], [cut]), read, off


def _pe150_library(tmp):
    """2 x 150 bp pairs at max_read_len 300 drawn from the case's gene
    window (linear, circular and junk), the case's pair last."""
    g, case, _ = case_window()
    ref, gtf = str(tmp / "ref.fa"), str(tmp / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=300)
    contigs, info = GenomePacker(ref).pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, 1, cfg,
                               contig_lengths=[len(c) for c in contigs])
    rng = np.random.default_rng(150)
    reads, _ = simulate_reads(rng, g, 72, 16, read_len=150,
                              frag_len=(200, 500), err_rate=0.01)
    junk = [type(case)(f"junk{i}", "".join(rng.choice(list("ACGT"), 150)),
                       case.r2, None, None) for i in range(4)]
    return cfg, gi, db, reads + junk + [case]


class World:
    """One library, one batch of its pairs, and the same statics and inputs
    for both packages."""

    def __init__(self, tmp, err):
        cfg, gi, db, reads = (_pe150_library(tmp) if err == PE150
                              else _library(tmp, err))
        self.cfg, self.gi, self.db, self.reads = cfg, gi, db, reads
        jp = JaxPipeline(db, gi, cfg, batch_size=BATCH,
                         chain_exec="device-full")
        self.jst = jp.states[0]
        self.jfa = jp.full_anno[0]
        self.jgenome = jp.full_genome[0]
        self.statics = {**jp._full_statics(), **SMALL_POOLS}
        ci = gi.contigs[0]
        self.tst = ContigDeviceState.from_contig_index(ci, port_config(cfg),
                                                       "cpu")
        self.tad = AnnoDevice.from_contig(db.contigs[0], seg_pad=16,
                                          device="cpu")
        self.tfa = FinishAnnoDevice.from_contig(db.contigs[0],
                                                db.con2chr[0], seg_pad=16,
                                                device="cpu")
        self.tgenome = torch.from_numpy(ci.codes)
        # linear, circular and junk pairs in one batch
        pairs = make_pairs(reads[-BATCH:], cfg)
        seqs, lens = encode_pairs(pairs, cfg.max_read_len)
        nf = NativeFilter(db, 0, ci.codes, cfg)
        row = NativeFilter.mr_to_state(MatchedRead.default(cfg.max_ed),
                                       nf.chr_names)
        self.seqs, self.lens = seqs, lens
        self.mr_in = np.ascontiguousarray(
            np.tile(row, (len(pairs), 1)).astype(np.int32))

    def jax_step(self):
        st = self.jst
        return np.asarray(jfull.device_full_step(
            jnp.asarray(self.seqs), jnp.asarray(self.lens),
            jnp.asarray(self.mr_in), st.entry_hv, st.entry_checksum,
            st.entry_pos, self.jgenome, st.anno, self.jfa, st.entry_prefix,
            contig_num=0, prefix_shift=st.prefix_shift,
            prefix_iters=st.prefix_iters, **self.statics))

    def torch_step(self, **over):
        st = self.tst
        return tfull.device_full_step(
            torch.from_numpy(self.seqs), torch.from_numpy(self.lens),
            torch.from_numpy(self.mr_in), st.entry_hv, st.entry_checksum,
            st.entry_pos, self.tgenome, self.tad, self.tfa, st.entry_prefix,
            contig_num=0, prefix_shift=st.prefix_shift,
            prefix_iters=st.prefix_iters, **{**self.statics, **over})


@pytest.fixture(scope="module", params=[0.0, 0.01], ids=["err0", "err1"])
def world(request, tmp_path_factory):
    return World(tmp_path_factory.mktemp("tfull"), request.param)


@pytest.fixture(scope="module")
def jax_blob(world):
    return world.jax_step()




# --------------------------------------------------------------------------
# the DP pool family
# --------------------------------------------------------------------------

# the share of a pool's rows that fall back to its full tiny DP
SHARES = {"none": 0.0, "mixed": 0.5, "all": 1.0}


def _pool_batch(seed, share, end, B=96):
    """Banded-regime pairs of which a share is cut to a tiny shape (n, m
    in 0..2w+2) where the pool falls back to its full tiny DP (END: n <= 2w
    or m <= w; the one-sided pool: n <= wv) and the rest lengthened out of
    it."""
    s, t, n, m, wv = _batch(seed, B)
    rng = np.random.default_rng(seed + 1)
    fall = rng.random(B) < share
    for b in range(B):
        if fall[b]:
            n[b] = rng.integers(0, 2 * W + 1) if end \
                else rng.integers(0, wv[b] + 1)
            m[b] = rng.integers(0, 2 * W + 3)
            s[b, n[b]:] = 0
            t[b, m[b]:] = 0
        elif end:
            n[b], m[b] = max(n[b], 2 * W + 1), max(m[b], W + 1)
        else:
            n[b] = max(n[b], 1)
            wv[b] = min(wv[b], n[b] - 1)
    tiny = (n <= 2 * W) | (m <= W) if end else n <= wv
    assert np.array_equal(tiny, fall)
    return s, t, n, m, wv


def _jt(*arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(np.array(a)) for a in arrs])


def _same(got, want, what=""):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (what, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("share", SHARES)
def test_tiny_global_and_one_side_pool_match_jax(share):
    (js, jt, jn, jm, jw), (ts, tt, tn, tm, tw) = _jt(
        *_pool_batch(1, SHARES[share], end=False))
    _same(tfull._tiny_global(ts[:, :4], tt[:, :8], torch.clamp(tn, max=4),
                             torch.clamp(tm, max=8), 4, 8),
          jfull._tiny_global(js[:, :4], jt[:, :8], jnp.minimum(jn, 4),
                             jnp.minimum(jm, 8), 4, 8), "tiny_global")
    _same(tfull._one_side_pool(ts, tt, tn, tm, tw, 128, w=W),
          jfull._one_side_pool(js, jt, jn, jm, jw, 128), "one_side_pool")


@pytest.mark.parametrize("share", SHARES)
def test_tiny_end_and_end_dp_pool_match_jax(share):
    (js, jt, jn, jm, _), (ts, tt, tn, tm, _) = _jt(
        *_pool_batch(2, SHARES[share], end=True))
    TN = 2 * W + 2
    _same(twalk._tiny_end(ts[:, :TN], tt[:, :TN], torch.clamp(tn, max=TN),
                          torch.clamp(tm, max=TN), w=W, max_ed=MAX_ED,
                          NM=TN, MM=TN),
          jwalk._tiny_end(js[:, :TN], jt[:, :TN], jnp.minimum(jn, TN),
                          jnp.minimum(jm, TN), w=W, max_ed=MAX_ED, NM=TN,
                          MM=TN), "tiny_end")
    _same(twalk._end_dp_pool(ts, tt, tn, tm, w=W, max_ed=MAX_ED, I=128),
          jwalk._end_dp_pool(js, jt, jn, jm, w=W, max_ed=MAX_ED, I=128),
          "end_dp_pool")


@pytest.mark.parametrize("left", [True, False])
def test_drop_wrap_matches_jax(left):
    rng = np.random.default_rng(3)
    B = 500
    on_s = rng.integers(0, 120, B).astype(np.int32)
    on_t = np.clip(on_s + rng.integers(-4, 5, B), 0, 127).astype(np.int32)
    score = (rng.integers(-40, 121, B)).astype(np.int32)
    m = (on_t + rng.integers(0, 12, B)).astype(np.int32)
    (a, b, c, d), (e, f, g, h) = _jt(score, on_s, on_t, m)
    kw = dict(mat=SM.mat, mis=SM.mis, w=W, max_ed=MAX_ED, max_sc=MAX_SC,
              left=left)
    _same(tfull._drop_wrap(e, f, g, h, **kw),
          jfull._drop_wrap(a, b, c, d, **kw), "drop_wrap")


@pytest.mark.parametrize("density,limit", [(0.3, 64), (0.3, 10), (0.0, 8),
                                           (1.0, 50)])
def test_compact_and_scatter_pool_match_jax(density, limit):
    """Pool packing with and without overflow: the gather index, the
    active count, the overflow mask, and the scatter back (rows past the
    active count go to the dropped sink slot)."""
    rng = np.random.default_rng(4)
    S = 200
    act = rng.random(S) < density
    vals = rng.integers(-99, 99, limit).astype(np.int32)
    (ja, jv), (ta, tv) = _jt(act, vals)
    j_inv, j_n, j_over = jfull._compact(ja, limit)
    t_inv, t_n, t_over = tfull._compact(ta, limit)
    _same((t_inv, t_n, t_over), (j_inv, j_n, j_over), "compact")
    _same(tfull._scatter_pool(tv, t_inv, t_n, S),
          jfull._scatter_pool(jv, j_inv, j_n, S), "scatter_pool")
    assert bool(np.asarray(j_over).any()) == (act.sum() > limit)


# --------------------------------------------------------------------------
# device_full_finish at its cut points, and the fused step
# --------------------------------------------------------------------------

def _finish_inputs(world):
    """The JAX lookup -> gather -> chain DP -> k-best of the batch, as
    numpy (the inputs both finishes take)."""
    from circminer_tpu.ops.chain import chain_batch_device
    from circminer_tpu.ops.device_finish import extract_kbest_device
    from circminer_tpu.ops.seed import (gather_seeds_device,
                                        lookup_batch_device)
    st, sx, cfg = world.jst, world.statics, world.cfg
    seqs, lens = jnp.asarray(world.seqs), jnp.asarray(world.lens)
    _, start, cnt, high = lookup_batch_device(
        seqs, lens, st.entry_hv, st.entry_checksum, st.entry_prefix,
        k=cfg.kmer, cs_len=sx["cs_len"], n_slots=sx["n_slots"],
        seed_lim=sx["seed_lim"], prefix_shift=st.prefix_shift,
        prefix_iters=st.prefix_iters)
    cap, k = sx["cap"], cfg.kmer
    cnt_c = jnp.minimum(cnt[:, ::2], cap)
    pos, _ = gather_seeds_device(st.entry_pos, start[:, ::2], cnt_c, cap=cap)
    NL = (seqs.shape[1] + k - 1) // k
    ql = (jnp.arange(NL, dtype=jnp.int32) * k)[None, :]
    qpos = jnp.where(ql + k <= lens[:, None], ql, 0).astype(jnp.int32)
    ad = st.anno
    dp, back = chain_batch_device(
        pos, cnt_c, qpos, lens, ad.nb_bits, ad.iv_spos, ad.iv_epos,
        ad.iv_max_end, ad.iv_min_end, ad.iv_max_next, ad.iv_nseg,
        ad.seg_end, ad.seg_next, k=k, max_ed=sx["max_ed"],
        max_intron=sx["max_intron"], seg_pad=sx["seg_pad"])
    ext = extract_kbest_device(dp, back, pos, qpos, cnt_c, k=k,
                               C=sx["KB"] + 1, iters=sx["EX_ITERS"])
    hh = jnp.sum(high[:, ::2].astype(jnp.int32), axis=1)
    return [np.asarray(a) for a in (seqs, lens, hh, *ext, world.mr_in)]


FINISH_KEYS = ("k", "max_ed", "max_sc", "band", "max_tlen", "scan_level",
               "KB", "P_MAX", "W_MAX", "OS_POOL", "XD_POOL", "mat", "mis",
               "ind", "xd", "EW", "KSCAN", "WPP", "MIDP", "ENDP")


@pytest.mark.parametrize("upto", ["phase1", "lo", "phase2"])
def test_device_full_finish_cut_points_match_jax(world, upto):
    from functools import partial
    kw = {key: world.statics[key] for key in FINISH_KEYS}
    arrs = _finish_inputs(world)
    want_d, want_def = jax.jit(partial(
        jfull.device_full_finish, contig_num=0, upto=upto, **kw))(
        *(jnp.asarray(a) for a in arrs), world.jgenome, world.jst.anno,
        world.jfa)
    got_d, got_def = tfull.device_full_finish(
        *(torch.from_numpy(np.array(a)) for a in arrs), world.tgenome,
        world.tad, world.tfa, contig_num=0, upto=upto, **kw)
    assert sorted(got_d) == sorted(want_d)
    for key in want_d:
        _same(got_d[key], want_d[key], f"{upto}:{key}")
    _same(got_def, want_def, f"{upto}:defer")


def test_device_full_step_blob_matches_jax(world, jax_blob):
    got = world.torch_step()
    assert got.dtype == torch.int32
    assert got.shape == (BATCH, tfull.MRF + 1)
    assert torch.equal(got, torch.from_numpy(np.array(jax_blob))), \
        _blob_diff(got, jax_blob)
    assert len(set(jax_blob[:, 0])) >= 3          # several categories
    assert (jax_blob[:, -1] == 0).all()           # all finished on device


def test_own_pool_budgets_keep_the_jax_blob(world, jax_blob):
    """100-bp reads: the port's step under its own X-drop and middle-DP
    budgets (the pipeline's ``_full_statics`` at the world's batch and row
    width: 4,096 and 512 rows, where the JAX step runs SMALL_POOLS' 1,024
    and 128) gives the JAX step's blob, defer bits included.  At these
    shapes the port's budgets are the reference's; larger pools change no
    read."""
    pipe = DeviceMappingPipeline(world.db, world.gi, port_config(world.cfg),
                                 batch_size=BATCH, chain_exec="device-full",
                                 device="cpu")
    sx = pipe._full_statics()
    own = {key: sx[key] for key in ("XD_POOL", "MIDP")}
    assert own == dict(XD_POOL=max(4096, 2 * BATCH),
                       MIDP=max(512, BATCH // 8))
    assert all(own[key] > SMALL_POOLS[key] for key in own)
    got = world.torch_step(**own)
    assert torch.equal(got, torch.from_numpy(np.array(jax_blob))), \
        _blob_diff(got, jax_blob)
    assert (jax_blob[:, -1] == 0).all()


# every budget starved: the step defers, and must raise the same bits
STARVED = dict(cap=4, KB=2, P_MAX=2, W_MAX=2, EX_ITERS=8, OS_POOL=16,
               XD_POOL=32, WPP=32, MIDP=8, ENDP=8, EW=1, KSCAN=2)


def _blob_diff(got, want):
    got = got.numpy()
    bad = np.nonzero((got != want).any(axis=1))[0]
    return bad[:5], got[bad[:2]], want[bad[:2]]


def test_device_full_step_defer_bits_match_jax(world):
    starved = copy.copy(world)
    starved.statics = {**world.statics, **STARVED}
    want = starved.jax_step()
    got = starved.torch_step()
    assert torch.equal(got, torch.from_numpy(np.array(want))), _blob_diff(got, want)
    causes = {name for i, name in enumerate(tfull.DEFER_CAUSES)
              if ((want[:, -1] >> i) & 1).any()}
    assert "extwalk" in causes and (want[:, -1] != 0).sum() >= 8, causes
    # the reference's causes, and the port's own last: a DP row longer
    # than the pools' windows (tests/test_torch_pe150.py)
    assert tfull.DEFER_CAUSES[:-1] == jfull.DEFER_CAUSES
    assert tfull.DEFER_CAUSES[-1] == "extent"


def test_seg_compact_reaches_the_prelude(world, jax_blob, monkeypatch):
    """The port's step forwards seg_compact to the chain prelude's cells
    (the reference's step drops it), and both forms give the JAX blob."""
    seen = []
    prelude = tchain._chain_cells

    def spy(*a, **kw):
        seen.append(kw["seg_compact"])
        return prelude(*a, **kw)

    monkeypatch.setattr(tchain, "_chain_cells", spy)
    for flag in (True, False):
        got = world.torch_step(seg_compact=flag)
        assert torch.equal(got, torch.from_numpy(np.array(jax_blob))), \
            _blob_diff(got, jax_blob)
    assert seen == [True, False]


def test_one_side_pool_rows_stay_inside_the_band(world, jax_blob,
                                                 monkeypatch):
    """The OS pool's rows past its live count may gather any gap slot
    (``_compact``), and the band does not bound an idle slot's |gdiff|:
    here they gather the idle slots in turn.  ``_phase1`` gives them wv = 0,
    so every row the one_side kernel sees has wv in [0, band], and the step
    still gives the JAX blob (``_scatter_pool`` drops those rows)."""
    os_pool = world.statics["OS_POOL"]
    compact, pool = tfull._compact, tfull._one_side_pool
    live, pools = [], []

    def compact_spy(active_flat, limit):
        inv, n_active, over = compact(active_flat, limit)
        if limit == os_pool:                 # _phase1's one_side pool
            idle = torch.nonzero(~active_flat).flatten().to(inv.dtype)
            j = torch.arange(limit)
            inv = torch.where(j >= n_active, idle[j % idle.numel()], inv)
            live.append(int(n_active))
        return inv, n_active, over

    def pool_spy(s, t, n, m, wv, I, *, w):
        pools.append((wv.clone(), w))
        return pool(s, t, n, m, wv, I, w=w)

    monkeypatch.setattr(tfull, "_compact", compact_spy)
    monkeypatch.setattr(tfull, "_one_side_pool", pool_spy)
    got = world.torch_step()
    assert torch.equal(got, torch.from_numpy(np.array(jax_blob))), \
        _blob_diff(got, jax_blob)
    (n_live,), ((wv, w),) = live, pools
    assert w == world.statics["band"]
    assert n_live < wv.shape[0] == os_pool
    assert int(wv.min()) >= 0 and int(wv.max()) <= w


# --------------------------------------------------------------------------
# the gpu-full executor
# --------------------------------------------------------------------------

def small_pools(pipe, patch=SMALL_POOLS):
    """Shrink the fused step's pools (as tests/test_device_walk.py patches
    the reference's _full_statics)."""
    orig = pipe._full_statics
    pipe._full_statics = lambda: {**orig(), **patch}
    return pipe


def map_fields(pipe, reads, cfg):
    pairs = make_pairs(reads, cfg)
    pipe.warmup()
    assert pipe.map_stream(iter(pairs)) == len(pairs)
    return [tuple(getattr(p[0].mr, f) for f in FIELDS) for p in pairs]


@pytest.mark.parametrize("world", [0.0, 0.01, PE150],
                         ids=["err0", "err1", PE150], indirect=True)
def test_gpu_full_pipeline_matches_native(world):
    """Every field of every pair, the executor against native: 100-bp
    reads at both error rates, and 2 x 150 bp reads at max_read_len 300,
    of which the fused step defers some (the case's pair among them)."""
    cfg, gi, db, reads = world.cfg, world.gi, world.db, world.reads
    full = small_pools(DeviceMappingPipeline(
        db, gi, port_config(cfg), batch_size=BATCH, chain_exec="device-full",
        device="cpu"))
    native = DeviceMappingPipeline(db, gi, port_config(cfg), batch_size=BATCH,
                                   chain_exec="native")
    got = map_fields(full, reads, cfg)
    want = map_fields(native, reads, cfg)
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert not bad, bad[:3]
    fs = full.full_stats
    assert fs["reads"] == len(reads)
    assert fs["deferred"] < 0.5 * fs["reads"], fs
    # 100-bp reads need no DP row past the pools' windows; the case does
    assert (fs["causes"].get("extent", 0) > 0) == (cfg.max_read_len > 100)
