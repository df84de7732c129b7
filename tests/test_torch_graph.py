"""The gpu-full step as one captured CUDA graph (``ops/step_graph.py``).

On the CPU: a sync audit of ``device_full_step`` (one step of
tests/test_torch_full.py's tiny world with the kernel wrappers stubbed
to their output shapes, under a TorchDispatchMode: no op that makes the
host wait for the card, no boolean-mask indexing, every lifted scalar from
a named site, each kernel wrapper called as often as a replay counts it
and handed the dtypes and shapes its kernel takes, and the chain
prelude's, the chain DP's, the extraction's, the pair steps', the walk
scan's and the walk fold's spans free of unrolled loops); the runner's
refusal of
the CPU; its key; the tracing flag the pipeline reads; and the CPU
pipeline's eager plain step, bit-equal to a direct call of the step.

``cuda``-marked (skipped without a card): replays bit-equal to the eager
step on three batches other than the capture batch (one short and padded),
launches counted per replay, a contig switch that captures anew and drops
the old graph, a device_trace region that runs eagerly, a capture that
fails at a synchronising op, and each named lift site captured on the
card.  Every output is an integer: every comparison is exact."""

import contextlib
import dataclasses
import gc
import gzip
import os
import traceback
import weakref
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from circminer_tpu_torch.ops import _ext
from circminer_tpu_torch.ops import chain_device as tchain
from circminer_tpu_torch.ops import device_finish as tfin
from circminer_tpu_torch.ops import device_full as tfull
from circminer_tpu_torch.ops import device_walk as twalk
from circminer_tpu_torch.ops.step_graph import StepGraph, step_key
from circminer_tpu_torch.pipeline.device_pipeline import (
    DeviceMappingPipeline, from_host)
from circminer_tpu_torch.utils import timing
from test_device_full import make_pairs
from test_torch_full import BATCH, World, small_pools
from test_torch_selfcontained import port_config

aten = torch.ops.aten
PORT = os.path.dirname(os.path.dirname(os.path.abspath(tfull.__file__)))

# ops that make the host wait for the device (a value or a data-dependent
# size read back); any of them breaks a CUDA graph capture
SYNCING = {aten._local_scalar_dense, aten.item, aten.nonzero,
           aten.masked_select, aten.is_nonzero, aten.equal,
           aten.repeat_interleave, aten._unique2, aten.unique_consecutive,
           aten.unique_dim}
INDEXING = {aten.index, aten.index_put, aten.index_put_,
            aten._index_put_impl_}
# every site of the step that lifts a Python scalar into a tensor (file in
# the port, statement): each is captured on the card by
# test_named_lift_sites_capture_on_card, with the shape and name of the
# tensor it writes
LIFT_SITES = {
    ("ops/device_full.py", "x_left[..., 0, :] = True"):
        ("x_left", (BATCH, 4, 7, 2, 2), torch.bool),
}
# kernel launches of one step (PERF.md's per-step counts)
PER_STEP = {"xdrop": 5, "edit_end": 4, "one_side": 1, "edit_sc": 0,
            "chain_dp": 1, "mr_pair_fold": 2, "walk_fold": 4, "walk_scan": 4,
            "tiny_dp": 5, "chain_cells": 1, "extract_kbest": 1,
            "walk_init": 1, "walk_pool": 4, "walk_commit": 4,
            "extend_core": 4, "extend_leftover": 1, "pair_grid": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("tgraph"), 0.01)


def _state(world):
    return dataclasses.replace(world.tst, anno=world.tad, fanno=world.tfa,
                               genome=world.tgenome)


class Audit(TorchDispatchMode):
    """Counts every aten op, in total and by the innermost cm.* span open
    (``span``); keeps the syncing ones, the boolean-mask indexing and the
    site of every lifted scalar."""

    def __init__(self):
        super().__init__()
        self.ops, self.by_span = Counter(), Counter()
        self.spans = []
        self.syncing, self.mask_index, self.lifts = [], [], []

    @contextlib.contextmanager
    def span(self, name):
        """Stands in for the step's ``record_function`` spans."""
        self.spans.append(name)
        try:
            yield
        finally:
            self.spans.pop()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops[str(func)] += 1
        self.by_span[self.spans[-1] if self.spans else "outside"] += 1
        packet = func.overloadpacket
        if packet in SYNCING:
            self.syncing.append(str(func))
        if packet in INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            self.mask_index.append(str(func))
        if func is aten.lift_fresh.default:
            for fr in reversed(traceback.extract_stack()):
                if fr.filename.startswith(PORT):
                    self.lifts.append((os.path.relpath(fr.filename, PORT),
                                       fr.line.strip()))
                    break
            else:
                self.lifts.append(("outside the port", ""))
        return func(*args, **kwargs)


def _kernel_args_ok(args):
    """Each (tensor, dtype, shape) the launcher would check, less the
    device: what the step hands the kernel is what it takes."""
    for x, dtype, shape in args:
        assert x.dtype == dtype and tuple(x.shape) == tuple(shape) \
            and x.is_contiguous(), (x.dtype, tuple(x.shape), dtype, shape)


def _stubs(calls):
    """The kernel wrappers as they are called from the step, each
    returning zeros of its output shape and counting its calls; all but
    the four DP kernels' check the arguments their kernels would get."""
    def out(name, s, k):
        calls[name] += 1
        z = torch.zeros(s.shape[0], dtype=torch.int32, device=s.device)
        return z if k == 1 else (z,) * k

    def chain_cells(pos, cnt, qpos, seq_len, *anno, **kw):
        calls["chain_cells"] += 1
        B, NL, S = pos.shape
        cells = [torch.zeros((B, NL * S), dtype=torch.int32)
                 for _ in range(5)]
        validf = torch.zeros((B, NL * S), dtype=torch.bool)
        _kernel_args_ok(tchain.chain_cells_args(pos, cnt, qpos, seq_len,
                                                *anno, cells[0], validf,
                                                *cells[1:]))
        return pos.reshape(B, NL * S), cells[0], validf, *cells[1:]

    def extract_kbest_device(dp10, back, pos, qpos, cnt, *, C, **kw):
        calls["extract_kbest"] += 1
        R, NL, _ = dp10.shape
        rpos = torch.zeros((R, C, NL), dtype=torch.int32)
        clen = torch.zeros((R, C), dtype=torch.int32)
        cn = torch.zeros((R,), dtype=torch.int32)
        out = (rpos, rpos.clone(), clen, clen.clone(), cn,
               torch.zeros((R,), dtype=torch.bool))
        _kernel_args_ok(tfin.extract_kbest_args(dp10, back, pos, qpos, cnt,
                                                *out, C=C))
        return out

    def chain_dp(*pre, NL, S, **kw):
        calls["chain_dp"] += 1
        dp = torch.zeros((pre[0].shape[0], NL, S), dtype=torch.int32)
        _kernel_args_ok(tchain.chain_dp_args(*pre, dp, dp, NL=NL, S=S))
        return dp, dp

    def mr_pair_fold(mr, *args, **kw):
        calls["mr_pair_fold"] += 1
        aux = torch.zeros((mr.shape[0], len(tfull.FOLD_AUX)),
                          dtype=torch.int32)
        _kernel_args_ok(tfull.mr_pair_fold_args(mr, *args, mr, aux))
        return mr, aux

    def walk_fold_lanes(*args, **kw):
        calls["walk_fold"] += 1
        out = torch.zeros((len(twalk.FOLD_OUT), args[8].shape[0]),
                          dtype=torch.int32)
        _kernel_args_ok(twalk.walk_fold_args(*args, out))
        return out

    def walk_scan(ws, *args, **kw):
        calls["walk_scan"] += 1
        out = torch.zeros_like(ws)
        _kernel_args_ok(twalk.walk_scan_args(ws, *args, out))
        return out

    def tiny_dp(s, t, n, m, tiny, banded, *, end, **kw):
        calls["tiny_dp"] += 1
        out = torch.zeros((s.shape[0], 2) if end else (s.shape[0],),
                          dtype=torch.int32)
        _kernel_args_ok(twalk.tiny_dp_args(s, t, n, m, tiny, banded, out,
                                           end=end))
        return out

    def edit_end_rows(s, *a, **kw):
        calls["edit_end"] += 1
        return torch.zeros((s.shape[0], 2), dtype=torch.int32)

    def xdrop_rows(s, *a, **kw):
        calls["xdrop"] += 1
        return torch.zeros((s.shape[0], 3), dtype=torch.int32)

    def walk_init(act4, pos4, len4, aiv4, row4, qs04, fiv, riv, iv_epos,
                  iv_tids, trans_start, t2s_off, *, EW, WPP, **kw):
        calls["walk_init"] += 1
        N, STW = fiv.shape[0], min(iv_tids.shape[1], twalk.STW)
        i32, b8 = torch.int32, torch.bool
        out = twalk.WalkInit(
            inv=torch.zeros((WPP,), dtype=i32),
            n_act=torch.zeros((), dtype=i32),
            over=torch.zeros((4 * N,), dtype=b8),
            act=torch.zeros((STW, WPP), dtype=b8),
            p_live=torch.zeros((WPP,), dtype=b8),
            over_tid=torch.zeros((WPP,), dtype=b8),
            ws=torch.zeros((len(twalk.WS_KEYS), STW, WPP), dtype=i32),
            slot=torch.zeros((len(twalk.SLOT_KEYS), STW, WPP), dtype=i32),
            lane=torch.zeros((len(twalk.LANE_KEYS), WPP), dtype=i32),
            prow=torch.zeros((len(twalk.PROW_KEYS), WPP), dtype=i32),
            events=torch.zeros((STW, EW, twalk.EV_NF, WPP), dtype=i32),
            nev=torch.zeros((STW, WPP), dtype=i32))
        _kernel_args_ok(twalk.walk_init_args(
            act4, pos4, len4, aiv4, row4, qs04, fiv, riv, iv_epos, iv_tids,
            trans_start, t2s_off, out))
        return out

    def walk_pool(ws, lane, prow, seqsf, genome, *, MIDP, ENDP, I=128,
                  **kw):
        calls["walk_pool"] += 1
        _, STW, WPP = ws.shape
        i32, i8 = torch.int32, torch.int8
        out = twalk.WalkPool(
            m_win=torch.zeros((2, MIDP, I - 1), dtype=i8),
            m_rows=torch.zeros((len(twalk.POOL_ROWS), MIDP), dtype=i32),
            m_tiny=torch.zeros((MIDP,), dtype=torch.bool),
            e_win=torch.zeros((2, ENDP, I - 1), dtype=i8),
            e_rows=torch.zeros((len(twalk.POOL_ROWS), ENDP), dtype=i32),
            n=torch.zeros((2,), dtype=i32),
            maps=torch.zeros((2, STW, WPP), dtype=i32))
        _kernel_args_ok(twalk.walk_pool_args(ws, lane, prow, seqsf, genome,
                                             out))
        return out

    def walk_commit(ws, *args, **kw):
        calls["walk_commit"] += 1
        out = torch.zeros_like(ws)
        _kernel_args_ok(twalk.walk_commit_args(ws, *args, out))
        return out

    def extend_core(pos, *args, **kw):
        calls["extend_core"] += 1
        shp = pos.shape
        out = (torch.zeros(shp, dtype=torch.bool),
               torch.zeros(shp, dtype=torch.int32),
               torch.zeros((len(twalk.KEYS), *shp), dtype=torch.int32),
               torch.zeros(shp, dtype=torch.bool))
        _kernel_args_ok(tfull.extend_core_args(pos, *args, *out))
        return out

    def extend_leftover(rp4, qp4, pos_r, *args, **kw):
        calls["extend_leftover"] += 1
        shp = pos_r.shape
        out = (torch.zeros((2, *shp), dtype=torch.bool),
               torch.zeros((2, *shp), dtype=torch.int32),
               torch.zeros((2, len(twalk.KEYS), *shp), dtype=torch.int32))
        _kernel_args_ok(tfull.extend_leftover_args(rp4, qp4, pos_r, *args,
                                                   *out))
        return out

    def pair_grid(sf_i, sf_b, rp4, qp4, *args, P, **kw):
        calls["pair_grid"] += 1
        B, _, KB1, _ = rp4.shape
        i32, b8 = torch.int32, torch.bool
        out = tfull.PairGrid(
            torch.zeros((3, B, 2, KB1, KB1), dtype=b8),
            torch.zeros((B, 2, KB1, KB1), dtype=i32),
            torch.zeros((2, B, 2, KB1), dtype=b8),
            torch.zeros((4, B, 2, P), dtype=i32),
            torch.zeros((5, B, 2, P), dtype=b8),
            torch.zeros((B, 2), dtype=i32),
            torch.zeros((2, len(tfull.MATE_INT), B, 2, P), dtype=i32),
            torch.zeros((2, len(tfull.SF_BOOL), B, 2, P), dtype=b8),
            torch.zeros((B,), dtype=i32))
        pg_args = tfull.pair_grid_args(sf_i, sf_b, rp4, qp4, *args, *out)
        assert len(pg_args) == len(_ext.KERNELS["pair_grid"].tensors)
        _kernel_args_ok(pg_args)
        return out

    return {
        (tfull, "one_side_batch"): lambda s, *a, **kw: out("one_side", s, 1),
        (tfull, "xdrop_batch"): lambda s, *a, **kw: out("xdrop", s, 3),
        (twalk, "xdrop_rows"): xdrop_rows,
        (twalk, "edit_end_rows"): edit_end_rows,
        (tchain, "chain_cells"): chain_cells,
        (tchain, "chain_dp"): chain_dp,
        (tfin, "extract_kbest_device"): extract_kbest_device,
        (tfull, "mr_pair_fold"): mr_pair_fold,
        (twalk, "walk_fold_lanes"): walk_fold_lanes,
        (twalk, "walk_scan"): walk_scan,
        (twalk, "walk_init"): walk_init,
        (twalk, "walk_pool"): walk_pool,
        (twalk, "walk_commit"): walk_commit,
        (twalk, "tiny_dp"): tiny_dp,
        (tfull, "tiny_dp"): tiny_dp,
        (tfull, "extend_core"): extend_core,
        (tfull, "extend_leftover"): extend_leftover,
        (tfull, "pair_grid"): pair_grid,
    }


def _audited_step(world, monkeypatch, **over):
    """One step of the tiny world with the kernel wrappers stubbed, under
    the Audit; returns (blob, audit, calls)."""
    calls = Counter()
    for (mod, name), fn in _stubs(calls).items():
        monkeypatch.setattr(mod, name, fn)
    st = world.tst
    args = [torch.from_numpy(a) for a in (world.seqs, world.lens,
                                           world.mr_in)]
    audit = Audit()
    for mod in (tfull, tchain):
        monkeypatch.setattr(mod, "record_function", audit.span)
    with audit:
        blob = tfull.device_full_step(
            *args, st.entry_hv, st.entry_checksum, st.entry_pos,
            world.tgenome, world.tad, world.tfa, st.entry_prefix,
            contig_num=0, prefix_shift=st.prefix_shift,
            prefix_iters=st.prefix_iters, **{**world.statics, **over})
    return blob, audit, calls


def test_fused_step_never_waits_for_the_device(world, monkeypatch):
    """One step of the tiny world under a TorchDispatchMode: none of the
    ops that read a device value back to the host, no boolean-mask
    indexing, every lifted scalar from a named site, and the kernels
    launched 5 (xdrop), 4 (edit_end), 1 (one_side), 1 (chain_cells), 1
    (chain_dp), 1 (extract_kbest), 2 (mr_pair_fold), 4 (walk_fold), 4
    (walk_scan), 5 (tiny_dp), 1 (walk_init), 4 (walk_pool), 4
    (walk_commit), 4 (extend_core), 1 (extend_leftover) and 1
    (pair_grid) times.
    The step dispatches 2,148 aten ops with the kernels stubbed, 282 of
    them in cm.phase2 outside its nested spans: 2,136 before phase 1's
    rule that defers a read with a DP row past the pools' windows (the
    cause ``extent``), 2,648 before pair_grid
    took phase 2's pair grid, slots, chain order and mate bundles, 5,122
    before extend_core, extend_leftover, is_left_chain and the one-op
    interval bisect, 5,127 while walk_init and walk_pool each allocated a
    device workspace of tile counts, 6,849 before walk_init, walk_pool and
    walk_commit, 8,053 before chain_cells and extract_kbest, 8,062 before
    tiny_dp took its pools' select of the fallback rows, 39,031 before the
    walk's kernels."""
    blob, audit, calls = _audited_step(world, monkeypatch)
    assert tuple(blob.shape) == (BATCH, tfull.MRF + 1)
    assert not audit.syncing, Counter(audit.syncing)
    assert not audit.mask_index, Counter(audit.mask_index)
    assert audit.lifts and set(audit.lifts) <= set(LIFT_SITES), audit.lifts
    assert dict(calls) == {k: v for k, v in PER_STEP.items() if v}
    total = sum(audit.ops.values())
    print(f"device_full_step at B = {BATCH}, kernels stubbed: {total} aten "
          f"ops per step; top {audit.ops.most_common(5)}; by innermost "
          f"span {audit.by_span.most_common()}")
    assert total == 2_148
    assert audit.by_span["cm.phase2"] == 282, audit.by_span


def test_walk_scan_and_fold_are_one_kernel_each(world, monkeypatch):
    """With the kernels stubbed, cm.walk_fold dispatches a handful of aten
    ops per family (its zero-filled output, the reshapes and the pool
    overflow's or), and cm.walk_waves at most 17 a wave beside 31 for the
    set-up and the lane defers (its wrappers' outputs and workspace, the
    pools' unbinds),
    as many at twice the world's KSCAN: the card path unrolls neither the
    fold's events nor the scan's steps, and the waves' pools and commit
    are kernels.  cm.walk_waves took 1,821 ops before walk_init, walk_pool
    and walk_commit; the walk's two spans 32,183 before the walk's
    kernels."""
    K = world.statics["KSCAN"]
    by_k = {}
    for kscan in (K, 2 * K):
        _, audit, calls = _audited_step(world, monkeypatch, KSCAN=kscan)
        assert (calls["walk_fold"], calls["walk_scan"], calls["tiny_dp"]) \
            == (4, 4, 5)
        by_k[kscan] = audit.by_span
    walk, fold = by_k[K]["cm.walk_waves"], by_k[K]["cm.walk_fold"]
    print(f"cm.walk_waves {walk}, cm.walk_fold {fold} aten ops per step")
    assert 0 < fold <= 4 * 16, fold
    assert 0 < walk <= 17 * world.statics["EW"] + 31, walk
    assert walk == by_k[2 * K]["cm.walk_waves"], \
        (walk, by_k[2 * K]["cm.walk_waves"])
    assert calls["walk_init"] == 1
    assert calls["walk_pool"] == calls["walk_commit"] == world.statics["EW"]


def test_chain_dp_and_pair_steps_are_one_kernel_each(world, monkeypatch):
    """With the kernels stubbed, cm.chain_dp dispatches only a handful of
    aten ops per step (the outputs and the stub), and cm.mr_fold as many
    at twice the world's P_MAX: the card path unrolls neither loop."""
    P = world.statics["P_MAX"]
    by_p = {}
    for p_max in (P, 2 * P):
        _, audit, calls = _audited_step(world, monkeypatch, P_MAX=p_max)
        assert calls["chain_dp"] == 1 and calls["mr_pair_fold"] == 2
        by_p[p_max] = audit.by_span
    assert by_p[P]["cm.chain_dp"] <= 8, by_p[P]["cm.chain_dp"]
    assert 0 < by_p[P]["cm.mr_fold"] == by_p[2 * P]["cm.mr_fold"], \
        (by_p[P]["cm.mr_fold"], by_p[2 * P]["cm.mr_fold"])


def test_chain_prelude_and_extraction_are_one_kernel_each(world,
                                                         monkeypatch):
    """With the kernels stubbed, cm.chain_prelude and cm.extract_kbest
    dispatch a handful of aten ops per step (the contiguous inputs, the
    outputs and the stub): 191 and 1,026 before their kernels."""
    _, audit, calls = _audited_step(world, monkeypatch)
    assert calls["chain_cells"] == calls["extract_kbest"] == 1
    assert 0 < audit.by_span["cm.chain_prelude"] <= 8, audit.by_span
    assert 0 < audit.by_span["cm.extract_kbest"] <= 8, audit.by_span


def test_runner_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA graphs"):
        StepGraph("cpu")


def test_key_follows_contig_shape_statics_and_tables(world):
    st = _state(world)
    statics = world.statics
    base = step_key(0, st, (4 * BATCH, 100), statics)
    assert step_key(0, st, (4 * BATCH, 100), dict(statics)) == base
    anno = dataclasses.replace(st.anno, seg_end=st.anno.seg_end.clone())
    others = [
        step_key(1, st, (4 * BATCH, 100), statics),
        step_key(0, st, (8 * BATCH, 100), statics),
        step_key(0, st, (4 * BATCH, 120), statics),
        step_key(0, st, (4 * BATCH, 100), {**statics, "EW": 5}),
        step_key(0, st, (4 * BATCH, 100), {**statics, "seg_compact": True}),
        step_key(0, dataclasses.replace(st, entry_pos=st.entry_pos.clone()),
                 (4 * BATCH, 100), statics),
        step_key(0, dataclasses.replace(st, genome=st.genome.clone()),
                 (4 * BATCH, 100), statics),
        step_key(0, dataclasses.replace(st, anno=anno), (4 * BATCH, 100),
                 statics),
    ]
    assert all(k != base for k in others)
    assert len(set(others)) == len(others)


def test_device_trace_sets_the_tracing_flag(tmp_path, monkeypatch):
    monkeypatch.delenv("CIRCMINER_TRACE_DIR", raising=False)
    with timing.device_trace(None):
        assert not timing.tracing()
    with timing.device_trace(str(tmp_path)):
        assert timing.tracing()
    assert not timing.tracing()
    assert any(f.endswith(".trace.json.gz") for f in os.listdir(tmp_path))


def test_cpu_pipeline_runs_the_eager_plain_step(world):
    """DeviceMappingPipeline(device="cpu") makes no StepGraph and its blob
    is bit-equal to a direct call of device_full_step."""
    cfg = world.cfg
    pipe = small_pools(DeviceMappingPipeline(
        world.db, world.gi, port_config(cfg), batch_size=BATCH,
        chain_exec="device-full", device="cpu"))
    assert pipe.step_graph and pipe._step_graph() is None
    cf = pipe._dispatch_full(make_pairs(world.reads[-BATCH:], cfg), 0)
    got = torch.from_numpy(from_host(cf["full"]))
    assert pipe.full_graph is None
    assert torch.equal(got, world.torch_step())


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the graph there)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card(world, cuda_device):
    """A gpu-full pipeline on the card, warmed up (contig 0 captured)."""
    pipe = small_pools(DeviceMappingPipeline(
        world.db, world.gi, port_config(world.cfg), batch_size=BATCH,
        chain_exec="device-full", device="cuda"))
    pipe.warmup()
    assert pipe.full_graph.captures == 1
    return pipe


def _blob(pipe, pairs, contig=0, eager=False):
    pipe.step_graph = not eager
    try:
        return from_host(pipe._dispatch_full(pairs, contig)["full"])
    finally:
        pipe.step_graph = True


def _batches(world):
    reads = world.reads
    return [reads[:BATCH], reads[BATCH // 2:BATCH // 2 + BATCH],
            reads[-17:]]


@pytest.mark.cuda
def test_replays_equal_the_eager_step_on_other_batches(world, card):
    """The graph was captured on warmup's empty batch; three other batches,
    the last 17 pairs padded to BATCH, replay bit-equal to the eager step
    on the card."""
    g = card.full_graph
    for recs in _batches(world):
        pairs = make_pairs(recs, world.cfg)
        got = _blob(card, pairs)
        want = _blob(card, pairs, eager=True)
        assert np.array_equal(got, want), np.nonzero((got != want).any(1))
    assert g.captures == 1 and g.replays >= 4


@pytest.mark.cuda
def test_launches_are_counted_per_replay(world, card):
    pairs = make_pairs(world.reads[:BATCH], world.cfg)
    _ext.reset_launches()
    _blob(card, pairs, eager=True)
    assert dict(_ext.LAUNCHES) == PER_STEP
    assert card.full_graph.launches == PER_STEP
    _ext.reset_launches()
    for _ in range(3):
        _blob(card, pairs)
    assert dict(_ext.LAUNCHES) == {k: 3 * v for k, v in PER_STEP.items()}


@pytest.mark.cuda
def test_contig_switch_captures_anew_and_drops_the_old_graph(world, card):
    """A second contig (contig 0's tables uploaded again: new addresses)
    captures its own graph and drops contig 0's; going back captures
    again."""
    g = card.full_graph
    n0 = g.captures
    pairs = make_pairs(world.reads[:BATCH], world.cfg)
    st0 = card.states[0]
    card.states.append(dataclasses.replace(
        st0, entry_pos=st0.entry_pos.clone(), genome=st0.genome.clone()))
    card.filters.append(card.filters[0])
    try:
        old = weakref.ref(g.live)
        got = _blob(card, pairs, contig=1)
        gc.collect()
        assert old() is None and g.captures == n0 + 1
        assert g.key[0] == 1
        assert np.array_equal(got, _blob(card, pairs, contig=1, eager=True))
        back = _blob(card, pairs, contig=0)
        assert g.captures == n0 + 2 and g.key[0] == 0
        assert np.array_equal(back, _blob(card, pairs, eager=True))
    finally:
        card.states.pop()
        card.filters.pop()


@pytest.mark.cuda
def test_device_trace_runs_the_step_eagerly(world, card, tmp_path, capsys):
    g = card.full_graph
    pairs = make_pairs(world.reads[:BATCH], world.cfg)
    want = _blob(card, pairs)
    n = (g.captures, g.replays)
    with timing.device_trace(str(tmp_path)):
        got = _blob(card, pairs)
    assert (g.captures, g.replays) == n
    assert np.array_equal(got, want)
    assert "runs eagerly" in capsys.readouterr().err
    path, = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with gzip.open(path, "rt") as f:
        assert "cm.walk_waves" in f.read()


@pytest.mark.cuda
def test_capture_fails_at_the_op_that_syncs(cuda_device):
    """A step that reads a value back to the host cannot be captured: the
    runner raises, naming the line, and keeps no graph."""
    g = StepGraph("cuda")
    x = np.arange(8, dtype=np.int32)

    def step(a, b, c):
        return a[: int(a.sum().item())]      # the line that syncs

    with pytest.raises(RuntimeError, match=r"\.item\(\)"):
        g.capture(("k",), step, x, x, x)
    assert g.live is None and g.captures == 0


@pytest.mark.cuda
def test_named_lift_sites_capture_on_card(cuda_device):
    """Each named site's statement, captured in a CUDA graph on the card,
    writes on replay what it writes eagerly."""
    for (_, code), (name, shape, dtype) in LIFT_SITES.items():
        eager = torch.zeros(shape, dtype=dtype, device="cuda")
        exec(code, {name: eager})
        x = torch.zeros(shape, dtype=dtype, device="cuda")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            exec(code, {name: x})
        x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(x, eager) and bool(eager.any()), code
