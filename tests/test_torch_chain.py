"""The torch port's chain half of the fused path against the JAX reference on
the CPU: device annotation tensors, the seed gather, the dense chain DP in
both seg_compact forms, the k-best extraction, and the gpu-chain executor.

Every output is an integer, so every comparison is exact (tolerance 0).
The inputs are made from seeds with numpy and handed to both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from circminer_tpu.annotation import device as jdev
from circminer_tpu.annotation.annotation import AnnotationDB
from circminer_tpu.config import CATEGORY_NAMES, Config
from circminer_tpu.index.build import build_genome_index
from circminer_tpu.io.fasta import GenomePacker
from circminer_tpu.ops import chain as jchain
from circminer_tpu.ops import device_finish as jfin
from circminer_tpu.ops import seed as jseed
from circminer_tpu.ops.chain_native import NativeChainer
from circminer_tpu.ops.encode import encode_seq, revcomp
from circminer_tpu.pipeline.device_pipeline import \
    DeviceMappingPipeline as JaxPipeline
from circminer_tpu.sim import make_genome, simulate_reads
from circminer_tpu_torch.annotation import device as tdev
from circminer_tpu_torch.ops import chain_device as tchain
from circminer_tpu_torch.ops import device_finish as tfin
from circminer_tpu_torch.ops import seed as tseed
from circminer_tpu_torch.pipeline.device_pipeline import DeviceMappingPipeline
from test_device_full import FIELDS, make_pairs
from test_torch_selfcontained import port_config

CAP = 16
ANNO_FIELDS = ("nb_bits", "iv_spos", "iv_epos", "iv_max_end", "iv_min_end",
               "iv_max_next", "iv_nseg", "seg_end", "seg_next")
FINISH_FIELDS = ("iv_tids", "iv_ntid", "iv_nseg_true", "seg_start_p",
                 "seg_gene_p", "gene_start", "gene_end", "intr_bits",
                 "trans_start", "t2s_off", "t2s_state", "shift_bounds",
                 "shift_vals")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: intra-op threads only contend with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tests/test_device_finish.py library: 80 kbp, 4 genes, 10%
    segmental duplications (multi-hit seeds), 100 pairs."""
    tmp = tmp_path_factory.mktemp("tchain")
    rng = np.random.default_rng(11)
    g = make_genome(rng, length=80_000, n_genes=4, dup_frac=0.1)
    ref, gtf = str(tmp / "ref.fa"), str(tmp / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=100)
    contigs, info = GenomePacker(ref).pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, 1, cfg,
                               contig_lengths=[len(c) for c in contigs])
    reads, _ = simulate_reads(rng, g, 60, 40, read_len=100, err_rate=0.01)
    return cfg, gi, db, reads


@pytest.fixture(scope="module")
def seeds(world):
    """Encoded rows (4 per pair), the JAX device lookup over them, and the
    annotation tensors of both packages."""
    cfg, gi, db, reads = world
    ci = gi.contigs[0]
    rows = []
    for r in reads:
        s1, s2 = encode_seq(r.r1), encode_seq(r.r2)
        rows += [s1, revcomp(s1), s2, revcomp(s2)]
    L = cfg.max_read_len
    seqs = np.zeros((len(rows), L), np.int8)
    lens = np.zeros(len(rows), np.int32)
    for i, s in enumerate(rows):
        seqs[i, :len(s)] = s
        lens[i] = len(s)
    qpos, start, cnt, _ = jseed.lookup_batch_device(
        jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(ci.entry_hv),
        jnp.asarray(ci.entry_checksum.astype(np.int32)), k=cfg.kmer,
        cs_len=cfg.checksum_len, n_slots=cfg.max_seg_cnt,
        seed_lim=cfg.seed_lim)
    start = np.asarray(start)[:, ::2]
    cnt = np.asarray(cnt)[:, ::2]
    qpos = np.maximum(np.asarray(qpos)[:, ::2], 0)
    jad = jdev.AnnoDevice.from_contig(db.contigs[0], seg_pad=16)
    tad = tdev.AnnoDevice.from_contig(db.contigs[0], seg_pad=16,
                                      device="cpu")
    return dict(seqs=seqs, lens=lens, start=start, cnt=cnt, qpos=qpos,
                jad=jad, tad=tad)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_anno_device_matches_jax(world, seeds):
    jad, tad = seeds["jad"], seeds["tad"]
    for name in ANNO_FIELDS:
        _eq(getattr(tad, name).numpy(), getattr(jad, name), name)
    assert (tad.seg_pad, tad.overflowed) == (jad.seg_pad, jad.overflowed)
    assert tad.nb_bits.dtype == torch.uint8


def test_finish_anno_device_matches_jax(world):
    cfg, gi, db, _ = world
    want = jdev.FinishAnnoDevice.from_contig(db.contigs[0], db.con2chr[0],
                                             seg_pad=16)
    got = tdev.FinishAnnoDevice.from_contig(db.contigs[0], db.con2chr[0],
                                            seg_pad=16, device="cpu")
    for name in FINISH_FIELDS:
        _eq(getattr(got, name).numpy(), getattr(want, name), name)
    assert got.st_pad == want.st_pad
    assert got.t2s_state.dtype == got.intr_bits.dtype == torch.uint8


def test_near_border_bit_matches_jax(seeds):
    jad = seeds["jad"]
    nbits = jad.nb_bits.shape[0] * 8
    rng = np.random.default_rng(5)
    pos = np.concatenate([rng.integers(-50, nbits + 50, 4000),
                          [-1, 0, 1, nbits - 1, nbits, 2 ** 31 - 1]]
                         ).astype(np.int32)
    want = jdev.near_border_bit(jad.nb_bits, jnp.asarray(pos))
    got = tdev.near_border_bit(seeds["tad"].nb_bits, _t(pos))
    _eq(got.numpy(), want)
    assert np.asarray(want).any() and not np.asarray(want).all()


def test_gather_seeds_matches_jax_and_clamps(world, seeds):
    cfg, gi, _, _ = world
    ep = gi.contigs[0].entry_pos.astype(np.int32)
    n = ep.shape[0]
    start, cnt = seeds["start"].copy(), seeds["cnt"].copy()
    # rows whose range runs past the end of the table: JAX clamps there
    start[:4, 0] = [n - 1, n - 3, n - CAP + 1, n]
    cnt[:4, 0] = CAP
    for cap in (CAP, 4):
        cnt_c = np.minimum(cnt, cap)
        want = jseed.gather_seeds_device(jnp.asarray(ep), jnp.asarray(start),
                                         jnp.asarray(cnt_c), cap=cap)
        got = tseed.gather_seeds_device(_t(ep), _t(start), _t(cnt_c),
                                        cap=cap)
        _eq(got[0].numpy(), want[0], f"pos cap={cap}")
        _eq(got[1].numpy(), want[1], f"mask cap={cap}")
    w = np.asarray(want[0])[:4, 0]          # [4 rows, cap]
    assert (w[[0, 3]] == ep[-1]).all() and w[1, -1] == ep[-1]


def _chain_inputs(world, seeds):
    cfg, gi, _, _ = world
    ep = gi.contigs[0].entry_pos.astype(np.int32)
    cnt = np.minimum(seeds["cnt"], CAP)
    pos = np.asarray(jseed.gather_seeds_device(
        jnp.asarray(ep), jnp.asarray(seeds["start"]), jnp.asarray(cnt),
        cap=CAP)[0])
    return pos, cnt, seeds["qpos"], seeds["lens"]


def _jax_chain(world, seeds):
    cfg = world[0]
    pos, cnt, qpos, lens = _chain_inputs(world, seeds)
    ad = seeds["jad"]
    dp, back = jchain.chain_batch_device(
        *(jnp.asarray(a) for a in (pos, cnt, qpos, lens)),
        ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end, ad.iv_min_end,
        ad.iv_max_next, ad.iv_nseg, ad.seg_end, ad.seg_next, k=cfg.kmer,
        max_ed=cfg.max_ed, max_intron=cfg.max_intron, seg_pad=ad.seg_pad)
    return np.asarray(dp), np.asarray(back)


@pytest.fixture(scope="module")
def jax_chain(world, seeds):
    return _jax_chain(world, seeds)


@pytest.mark.parametrize("seg_compact", [False, True])
def test_chain_batch_device_matches_jax(world, seeds, jax_chain, seg_compact):
    cfg = world[0]
    pos, cnt, qpos, lens = _chain_inputs(world, seeds)
    ad = seeds["tad"]
    dp, back = tchain.chain_batch_device(
        *(_t(a) for a in (pos, cnt, qpos, lens)),
        ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end, ad.iv_min_end,
        ad.iv_max_next, ad.iv_nseg, ad.seg_end, ad.seg_next, k=cfg.kmer,
        max_ed=cfg.max_ed, max_intron=cfg.max_intron, seg_pad=ad.seg_pad,
        seg_compact=seg_compact)
    _eq(dp.numpy(), jax_chain[0], "dp10")
    _eq(back.numpy(), jax_chain[1], "back")
    assert (jax_chain[1] >= 0).sum() > 100   # real chains were linked


def test_chain_prelude_forms_are_bit_equal(world, seeds):
    cfg = world[0]
    ad = seeds["tad"]
    args = [_t(a) for a in _chain_inputs(world, seeds)] + [
        ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end, ad.iv_min_end,
        ad.iv_max_next, ad.iv_nseg, ad.seg_end, ad.seg_next]
    kw = dict(k=cfg.kmer, max_ed=cfg.max_ed, seg_pad=ad.seg_pad)
    wide = tchain._chain_prelude(*args, seg_compact=False, **kw)
    slim = tchain._chain_prelude(*args, seg_compact=True, **kw)
    for a, b in zip(wide, slim):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_chain_dp_reads_the_prelude_tables_in_place(world, seeds,
                                                    monkeypatch):
    """On the card path the chain_dp kernel's junction-table arguments are
    the annotation's own iv_nseg / seg_end / seg_next storage and its cell
    arguments the cells' own, in both forms: nothing is copied, and no
    [b, M, P] tensor is made from the cells to the launch.  (The card path
    is taken on CPU tensors that report is_cuda, the launch recorded.)"""
    cfg = world[0]
    ad = seeds["tad"]
    pos, cnt, qpos, lens = (_t(a) for a in _chain_inputs(world, seeds))
    annos = [ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end,
             ad.iv_min_end, ad.iv_max_next, ad.iv_nseg, ad.seg_end,
             ad.seg_next]
    B, NL, S = pos.shape
    P = ad.seg_pad
    launched = []

    def launch(name, args, statics):
        launched.append((name, args, statics))

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for x in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(x, torch.Tensor):
                    made.append(x.numel())
            return out

    for seg_compact in (False, True):
        cells = tchain._chain_cells(pos, cnt, qpos, lens, *annos,
                                    k=cfg.kmer, max_ed=cfg.max_ed,
                                    seg_pad=P, seg_compact=seg_compact)
        launched.clear()
        made = []
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
            m.setattr(tchain._ext, "launch_tensors", launch)
            with Shapes():
                tchain.chain_dp(*cells, ad.iv_nseg, ad.seg_end, ad.seg_next,
                                NL=NL, S=S, k=cfg.kmer, max_ed=cfg.max_ed,
                                max_intron=cfg.max_intron,
                                seg_compact=seg_compact)
        [(name, kargs, statics)] = launched
        assert name == "chain_dp" and statics[3] == P
        mine = list(cells) + [ad.iv_nseg, ad.seg_end, ad.seg_next]
        assert len(kargs) == len(mine) + 2 == len(
            tchain._ext.KERNELS["chain_dp"].tensors)
        for (x, dt, shape), y in zip(kargs, mine):
            assert x.data_ptr() == y.data_ptr(), seg_compact
            assert x.dtype == dt and tuple(x.shape) == shape
        assert made and max(made) <= B * NL * S < B * NL * S * P, made


def _extract_inputs(world, seeds, jax_chain):
    pos, cnt, qpos, _ = _chain_inputs(world, seeds)
    dp, back = jax_chain
    return dp, back, pos, qpos, cnt


@pytest.mark.parametrize("upto", ["sort", "emit", "full"])
def test_extract_kbest_device_matches_jax(world, seeds, jax_chain, upto):
    cfg = world[0]
    arrs = _extract_inputs(world, seeds, jax_chain)
    kw = dict(k=cfg.kmer, C=7, iters=48)
    want = jfin.extract_kbest_device_staged(
        *(jnp.asarray(a) for a in arrs), upto=upto, **kw)
    got = tfin.extract_kbest_device_staged(*(_t(a) for a in arrs),
                                           upto=upto, **kw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _eq(g.numpy(), w, f"{upto}[{i}]")


def test_extract_kbest_device_matches_native_on_ties(world, seeds,
                                                     jax_chain):
    """Rows whose event cells all carry one score: the order among ties
    (list desc, index asc) decides every chain, on the device and in the
    host C++ extraction alike."""
    cfg = world[0]
    dp, back, pos, qpos, cnt = _extract_inputs(world, seeds, jax_chain)
    dp = dp.copy()
    ev = back >= 0
    tied = np.nonzero(ev.reshape(len(dp), -1).sum(axis=1) >= 2)[0][::2]
    assert len(tied) >= 10
    for r in tied:
        dp[r][ev[r]] = dp[r][ev[r]].max()
    C = cfg.max_chain_len
    rp, qp, cl, sc10, cn, inc = (a.numpy() for a in tfin.extract_kbest_device(
        *(_t(a) for a in (dp, back, pos, qpos, cnt)), k=cfg.kmer, C=C,
        iters=48))
    n_rp, n_qp, n_cl, n_sc, n_cn = NativeChainer.extract_batch(
        dp, back, pos, qpos, cnt, cfg.kmer, C, n_threads=1)
    done = ~inc
    assert done[tied].sum() >= 0.9 * len(tied)
    np.testing.assert_array_equal(cn[done], n_cn[done])
    np.testing.assert_array_equal(cl[done], n_cl[done])
    np.testing.assert_array_equal(rp[done], n_rp[done])
    np.testing.assert_array_equal(qp[done], n_qp[done])
    np.testing.assert_array_equal(sc10[done] / 10.0, n_sc[done])


@pytest.fixture(scope="module")
def full_lib(tmp_path_factory):
    """tests/test_device_full.py's library (error rate 1%)."""
    from test_torch_full import _library
    return _library(tmp_path_factory.mktemp("tchain_lib"), 0.01)


def _map(pipe, reads, cfg, warm=True):
    pairs = make_pairs(reads, cfg)
    if warm:
        pipe.warmup()
    assert pipe.map_stream(iter(pairs)) == len(pairs)
    return [tuple(getattr(p[0].mr, f) for f in FIELDS) for p in pairs]


def test_gpu_chain_pipeline_matches_native_and_jax(full_lib):
    cfg, gi, db, reads = full_lib
    port = DeviceMappingPipeline(db, gi, port_config(cfg), batch_size=64,
                                 chain_exec="device-chain", device="cpu")
    got = _map(port, reads, cfg)
    native = _map(DeviceMappingPipeline(db, gi, port_config(cfg),
                                        batch_size=64, chain_exec="native"),
                  reads, cfg)
    ref = _map(JaxPipeline(db, gi, cfg, batch_size=64,
                           chain_exec="device-chain"), reads, cfg,
               warm=False)   # the JAX warm-up compiles every bucket shape
    for name, want in (("native", native), ("jax device-chain", ref)):
        bad = [(i, CATEGORY_NAMES[g[0]], g, w)
               for i, (g, w) in enumerate(zip(got, want)) if g != w]
        assert not bad, (name, bad[:3])
    assert len({g[0] for g in got}) >= 3      # several categories
    assert port.states[0].anno is not None
