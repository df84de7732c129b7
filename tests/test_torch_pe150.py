"""2 x 150 bp reads at ``max_read_len`` 300 in the fused device-full step,
on the CPU, against the native path and the JAX reference.

The case: pair 5545 of library 0 of seed 3000000013 in cmbench's
``chr21_pe150_l300.total`` (``s0_L21106``: r1 150 bp, four edits, over the
junction of exons 1 and 3 of gene 548).  The native path ends r1 at
32,822,873, base 150.  The DP pools of the fused step gather windows of
``I - 1`` = 127 bases; the walk's end DP of that r1 needs 128 query bases
past the junction, so the reference's step cuts the row and ends the read
one base short (a defect of the reference).  The port's step marks every
read with a DP row past the windows (``DEF_EXTENT``), and the pipeline
replays it on the host.  The world is ``tests/test_torch_full.py``'s
``pe150``: the case's gene cut from the chr21-scale genome, 2 x 150 bp
pairs drawn from it, the case's pair last."""

import dataclasses

import numpy as np
import pytest
import torch

from circminer_tpu_torch.ops import device_full as tfull
from circminer_tpu_torch.pipeline.device_pipeline import \
    DeviceMappingPipeline
from test_device_full import FIELDS
from test_torch_full import (BATCH, CASE_EPOS_R1, PE150, SMALL_POOLS, World,
                             _blob_diff, case_window, map_fields,
                             small_pools)
from test_torch_selfcontained import port_config

I = 128          # the DP extent of the pools (device_full_finish's I)
MRF = tfull.MRF
QEPOS_R1, MLEN_R1, EPOS_R1 = (tfull.MR_KEYS.index(k)
                              for k in ("qepos_r1", "mlen_r1", "epos_r1"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pe150(tmp_path_factory):
    return World(tmp_path_factory.mktemp("pe150"), PE150)


@pytest.fixture(scope="module")
def finish_call(pe150):
    """The port's step on the world's last batch: its [B, MRF + 1] blob as
    numpy, and the positional arguments it handed its finish (the
    extracted chains, the inputs of ``_phase1``)."""
    seen = []
    finish = tfull.device_full_finish

    def spy(*a, **kw):
        seen.append(a)
        return finish(*a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfull, "device_full_finish", spy)
        got = pe150.torch_step().numpy()
    (args,) = seen
    return got, args


@pytest.fixture(scope="module")
def blobs(pe150, finish_call):
    """The step's [B, MRF + 1] blob of the world's last batch: (JAX's,
    the port's), as numpy, and the chains the port's step extracted (the
    inputs of its finish)."""
    got, args = finish_call
    chains = {key: args[i].numpy() for key, i in (
        ("lens", 1), ("rp", 3), ("qp", 4), ("cl", 5), ("cn", 7))}
    return np.array(pe150.jax_step()), got, chains


def test_case_ends_where_the_native_path_ends(pe150):
    """gpu-full gives the case's pair the native path's every field: r1
    ends at base 150 of the read, 32,822,873 on the genome, after the
    step deferred the pair for its long row alone."""
    _, _, off = case_window()
    cfg, db, gi = pe150.cfg, pe150.db, pe150.gi
    case = pe150.reads[-1:]
    full = small_pools(DeviceMappingPipeline(
        db, gi, port_config(cfg), batch_size=BATCH, chain_exec="device-full",
        device="cpu"))
    native = DeviceMappingPipeline(db, gi, port_config(cfg), batch_size=BATCH,
                                   chain_exec="native")
    (got,), (want,) = map_fields(full, case, cfg), map_fields(native, case,
                                                               cfg)
    assert got == want
    f = dict(zip(FIELDS, got))
    assert (f["qepos_r1"], f["mlen_r1"], f["ed_r1"]) == (150, 150, 4)
    assert f["epos_r1"] + off == CASE_EPOS_R1
    assert full.full_stats == {"reads": 1, "deferred": 1,
                               "causes": {"extent": 1},
                               "xd_pool": SMALL_POOLS["XD_POOL"]}


def test_case_the_reference_step_ends_the_read_one_base_short(blobs):
    """The JAX step finishes the case's pair on the device with r1 one
    base short and no defer bit: the defect is the reference's.  The
    port's step computes the same fields and defers the pair."""
    want, got, _ = blobs
    jrow, trow = want[-1], got[-1]
    assert (jrow[QEPOS_R1], jrow[MLEN_R1]) == (149, 149)
    assert jrow[-1] == 0
    np.testing.assert_array_equal(trow[:MRF], jrow[:MRF])
    assert trow[-1] == tfull.DEF_EXTENT


def _extent_rule(chains, k, band):
    """The reads with a DP row past the windows of I - 1 bases, from the
    batch's chains (numpy): a valid chain's end of remain bases (a
    reference window of remain + band), or a middle gap that the one-sided
    pool takes with its query or reference past I - 1."""
    lens, rp, qp, cl, cn = (chains[key] for key in ("lens", "rp", "qp",
                                                     "cl", "cn"))
    B = lens.shape[0] // 4
    KB1, NL = cl.shape[1], rp.shape[-1]
    rp = rp.reshape(B, 4, KB1, NL).astype(np.int64)
    qp = qp.reshape(B, 4, KB1, NL).astype(np.int64)
    clen = cl.reshape(B, 4, KB1)
    valid = np.arange(KB1)[None, None, :] < cn.reshape(B, 4)[:, :, None]
    last = np.clip(clen - 1, 0, NL - 1)[..., None]
    remain_beg = qp[..., 0]
    remain_end = lens.reshape(B, 4)[:, :, None] \
        - (np.take_along_axis(qp, last, -1)[..., 0] + k)
    long_end = valid & (np.maximum(remain_beg, remain_end) + band > I - 1)
    gqlen = qp[..., 1:] - (qp[..., :-1] + k)
    gdiff = (rp[..., 1:] - rp[..., :-1]) - (qp[..., 1:] - qp[..., :-1])
    frag = valid[..., None] & (np.arange(NL - 1) < (clen - 1)[..., None])
    need = frag & (gqlen > 0) & (np.abs(gdiff) <= band)
    long_gap = need & (np.maximum(gqlen, np.maximum(gqlen + gdiff, 0))
                       > I - 1)
    return long_end.reshape(B, -1).any(1) | long_gap.reshape(B, -1).any(1)


def test_pe150_defer_bits_follow_the_reference_rules(pe150, blobs):
    """Every row of a batch of 2 x 150 bp pairs: the port's step gives
    the JAX step's 20 fields and defer bits, and DEF_EXTENT on exactly the
    reads whose chains need a DP row past the windows, the case's pair
    among them and not all."""
    want, got, chains = blobs
    np.testing.assert_array_equal(got[:, :MRF], want[:, :MRF])
    ext = (got[:, -1] & tfull.DEF_EXTENT) != 0
    assert np.array_equal(got[:, -1] & ~tfull.DEF_EXTENT, want[:, -1]), \
        _blob_diff(torch.from_numpy(got), want)
    np.testing.assert_array_equal(
        ext, _extent_rule(chains, pe150.cfg.kmer, pe150.statics["band"]))
    assert ext[-1] and 0 < ext.sum() < len(ext)


def test_a_copy_of_full_stats_keeps_its_counts(pe150):
    """The benchmark copies ``full_stats`` by ``dict()`` when its window
    closes and maps one more library before its readers run: the copy's
    cause counts stay those of the window."""
    cfg = pe150.cfg
    full = small_pools(DeviceMappingPipeline(
        pe150.db, pe150.gi, port_config(cfg), batch_size=BATCH,
        chain_exec="device-full", device="cpu"))
    map_fields(full, pe150.reads[-1:], cfg)
    snap = dict(full.full_stats)
    map_fields(full, pe150.reads[-1:], cfg)
    xd = {"xd_pool": SMALL_POOLS["XD_POOL"]}
    assert snap == {"reads": 1, "deferred": 1, "causes": {"extent": 1}, **xd}
    assert full.full_stats == {"reads": 2, "deferred": 2,
                               "causes": {"extent": 2}, **xd}


PHASE1_STATICS = ("k", "max_ed", "max_sc", "band", "KB", "OS_POOL", "mat",
                  "mis", "ind", "xd")


def _xdrop_rows(st):
    """Each read's live X-drop rows: ``_phase1``'s mask of active chain-end
    slots (genomic and walk, left and right) summed over its four rows."""
    v = st["valid"]
    xa = ((v & (st["remain_beg"] > 0) & st["genL_inb"]).int()
          + (v & (st["remain_end"] > 0) & st["genR_inb"]).int()
          + (v & st["wxL"] & st["walkL_inb"]).int()
          + (v & st["wxR"] & st["walkR_inb"]).int())
    return xa.reshape(xa.shape[0], -1).sum(dim=1)


def test_xdrop_pool_holds_a_large_batch_of_150bp_pairs(pe150, finish_call):
    """``_phase1`` on the world's 2 x 150 bp pairs that ask three X-drop
    rows or more, tiled to the least B at which they ask more than the
    reference's budget of max(4096, 2B) rows: some read overflows that
    budget.  Under the pipeline's budget at that B and L none does, every
    copy of a read gets the first copy's pooled DP results, and every read
    live under both budgets gets the same results and defer bits."""
    _, args = finish_call
    n0 = args[0].shape[0] // 4
    kw = {key: pe150.statics[key] for key in PHASE1_STATICS}
    # a pool of one row: the demand without the DP
    rows = _xdrop_rows(tfull._phase1(*args, XD_POOL=1, **kw))
    pick = torch.nonzero(rows >= 3).flatten()
    tile = 4096 // int(rows[pick].sum()) + 1
    n = len(pick)
    B = tile * n

    def reads(a):
        r = a.shape[0] // n0
        a = a.reshape(n0, r, *a.shape[1:])[pick].reshape(-1, *a.shape[1:])
        return a.repeat(tile, *[1] * (a.dim() - 1))

    tiled = [reads(a) for a in args[:10]] + list(args[10:13])
    sx = DeviceMappingPipeline(
        pe150.db, pe150.gi, port_config(pe150.cfg), batch_size=B,
        chain_exec="device-full", device="cpu")._full_statics()
    ref = max(4096, 2 * B)
    assert int(rows[pick].sum()) * tile > ref and sx["XD_POOL"] > ref
    kw = {key: sx[key] for key in PHASE1_STATICS}

    def phase1(xd_pool):
        st = tfull._phase1(*tiled, XD_POOL=xd_pool, **kw)
        # defer [B]; the four pooled DP results, [4, B, 4, KB1, 2, 2]
        return st["defer"], torch.stack(st["dp"])

    d_ref, dp_ref = phase1(ref)
    d_own, dp_own = phase1(sx["XD_POOL"])
    over = (d_ref & tfull.DEF_XDPOOL) != 0
    assert over.any()
    assert not ((d_own & tfull.DEF_XDPOOL) != 0).any()
    assert torch.equal(dp_own.reshape(4, tile, n, -1),
                       dp_own[:, :n].reshape(4, 1, n, -1).expand(
                           4, tile, n, -1))
    live = ~over
    assert torch.equal(d_ref[live], d_own[live])
    assert torch.equal(dp_ref[:, live], dp_own[:, live])


@pytest.mark.parametrize("B,L", [(64, 100), (64, 300), (4096, 100),
                                 (4096, 150), (4096, 300), (8192, 300)])
def test_pool_budgets_are_fixed_from_the_batch_and_row_width(pe150, B, L):
    """The fused step's X-drop and middle-DP budgets follow the batch B and
    the row width L alone, never below the reference's formulas
    (max(4096, 2B), max(512, B // 8)): at the benchmark's B = 4,096 and L =
    300 they hold 16,384 and 3,072 rows, at least 1.25 times the most a
    batch of 2 x 150 bp pairs was measured to ask (11,381 and 1,892 rows on
    the card); every other budget is the reference's."""
    cfg = dataclasses.replace(port_config(pe150.cfg), max_read_len=L)
    sx = DeviceMappingPipeline(pe150.db, pe150.gi, cfg, batch_size=B,
                               chain_exec="device-full",
                               device="cpu")._full_statics()
    ref = dict(XD_POOL=max(4096, 2 * B), MIDP=max(512, B // 8),
               OS_POOL=max(2048, B), WPP=max(512, (3 * B) // 2),
               ENDP=max(1024, B // 4))
    own = ("XD_POOL", "MIDP")
    assert all(sx[key] >= ref[key] for key in own)
    assert all(sx[key] == ref[key] for key in ref if key not in own)
    if (B, L) == (4096, 300):
        assert (sx["XD_POOL"], sx["MIDP"]) == (16384, 3072)
        assert sx["XD_POOL"] >= 1.25 * 11381 and sx["MIDP"] >= 1.25 * 1892
    if B <= 1024 or L < 150:
        assert sx["XD_POOL"] == ref["XD_POOL"]
