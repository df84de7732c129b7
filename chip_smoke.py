#!/usr/bin/env python
"""Smoke run of the PyTorch + CUDA port (circminer_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab OLD.cu NEW.cu ...   # kernel sources A/B
    python3 chip_smoke.py --replay [TREE]    # the step's replay, one tree

Phases (any failure ends the run with a non-zero exit and no result line):

  1. device report: the card's name and power limit (nvidia-smi) and the
     kernels' build time (nvcc, from csrc/ in this checkout);
  2. each hand-written CUDA kernel (xdrop, edit_sc, edit_end, one_side) and
     the fused [B, 10] wave_all_batch against their plain torch versions on
     the card, bit-equal, at the wave service's shape (B = 1024, I = 128,
     Config() band/max_ed/max_sc, default ScoreMat), each kernel timed by
     the profiler's device events (the plain versions by CUDA events)
     beside its bound (bytes over HBM bandwidth against int32
     operations over the ALU peak, from these inputs) and its chain floor;
     then all four bit-equal at every band w in SWEEP_W and B in SWEEP_B;
     then the chain DP (chain_dp) and the mr fold's pair steps
     (mr_pair_fold) bit-equal to their plain versions over adversarial
     inputs: CHAIN_SWEEP (S = 16, 128, 500; NL = 2, 6, 15; P = 3, 16, 20)
     and FOLD_SWEEP (at both scan_levels; read counts ragged against the
     fold's 32-read blocks); the walk's kernels (walk_fold, tiny_dp,
     walk_scan, walk_init, walk_pool, walk_commit) bit-equal to their
     plain versions over WALK_SWEEP (every event kind, I32MAX bounds,
     bands up to w = 62, the main path's pool shapes, tiny-DP pools where
     no row, half and every row falls back; lane tables past WPP lanes and
     tid lists past STW, pools that overflow, dedup ties across slots,
     windows off the genome and across the reads' rows, counts past EW),
     eagerly and replayed from a CUDA graph; the chain stage's ends
     (chain_cells in both seg_compact forms, extract_kbest) bit-equal to
     their plain versions over END_SWEEP (chr21's main shapes, one
     interval, gpu-chain's widest bucket, fallback, capped and incomplete
     rows, scores at and past the other cells' key 2^29, rows of exactly
     0, 1, 31, 32, 33 and iters + 1 event cells, more than 64 picks, a
     row of 15,000 cells whose walks read device memory), eagerly and
     replayed from a CUDA graph; phase 2's extend kernels (extend_core
     on phase 2's families, extend_leftover on the leftover extends)
     bit-equal to their plain versions over EXTEND_SWEEP (chr21's main
     shapes, bounds at I32MAX, 0, INT32_MIN and at the gate, positions
     near both int32 ends, lengths <= 0, no, some and every lane held by
     the walk engine), eagerly and replayed from a CUDA graph; phase 2's
     pair grid (pair_grid) bit-equal to its plain version over PAIR_SWEEP
     (chr21's main shape, 81 and 144 cells a read, P_MAX past 32 and past
     the cells, n_union 0, at P_MAX and past it, intervals -1 and past the
     table, tid and segment lists at and over their pads, chains
     separated, touching and interleaved, NL 1-17, ends past I32MAX,
     pairs at exactly MAXDISCRDTLEN), eagerly and replayed; and
     chain_dp timed
     beside its
     plain version and bound at gpu-chain's S = 128 and 500 buckets
     (CHAIN_BUCKETS, which no chr21 read fills);
  3. the seed lookup on the card against the host C++ NativeSeeder on one
     batch of the phase-4 index: start, cnt and high bit-equal;
  4. the slice end to end at bench.py's default chr21 configuration (47 Mbp
     genome, 783 genes, 5% segmental duplications, Config(kmer=20,
     max_read_len=120), seeds 20260817 / 20260818), index resident on the
     card: 16,384 read pairs in batches of 4,096 through the port's
     gpu-wave executor then stage 2, and through the native executor; every
     pair's MatchedRead and the called event sets must be equal, and every
     kernel must have been launched by the gpu-wave run;
  5. the gpu-chain executor (lookup + dense chain DP on the card) on the
     same reads: equal to native pair for pair and event for event, with
     the chain_dp launches by occupancy bucket, each with one chain_cells
     launch;
  6. the main path, the gpu-full executor (the fused device_full_step
     on the card as one CUDA graph, captured at warm-up and replayed per
     batch; deferred reads replayed on the host) on the same reads: equal
     to native, with the xdrop, one_side, edit_end, chain_cells, chain_dp,
     extract_kbest, mr_pair_fold, walk_fold, walk_scan, tiny_dp,
     walk_init, walk_pool, walk_commit, extend_core, extend_leftover and
     pair_grid kernels each launched on that run, counted per replay
     (replays times the launches the capture recorded; chain_cells,
     chain_dp, extract_kbest, walk_init, extend_leftover and
     pair_grid once, mr_pair_fold twice, walk_fold, walk_scan,
     walk_pool, walk_commit and extend_core four times, tiny_dp five
     times per replay); reported:
     pairs/s, reads deferred
     and their causes, and the device-busy share and per-stage device
     time (the cm.* spans) of one torch.profiler run of a map of the
     first 8,192 pairs with the step run eagerly (a replay shows no
     spans);
  7. one device_full_step on the first 256 pairs on the card (kernels) and
     on the CPU (plain versions) with the same statics: the raw int32
     [B, MRF + 1] blobs bit-equal, and the card step with the per-column
     chain prelude (seg_compact=True, the form the pipeline takes above
     300 M index entries) bit-equal to it too; then one more 4,096-pair
     step, run eagerly, with the
     kernels' inputs recorded: launches per step and rows of each kernel,
     each bit-equal to its plain version there and timed, with its bound
     (the chain ends', the chain DP's, the fold's, the walk kernels' and
     the extend kernels' inputs too; each
     walk kernel beside an empty kernel on its grid, the [launch-floor]
     line, and with the fallback rows of tiny_dp's pools and the fold's
     live lanes per family; each wave kernel's device ms by kernel; the
     extraction's rows by event count and by the rank path they take,
     extract_paths);
  8. stage 2 of the gpu-full path on the card: the BSJ pairs of the
     phase-6 map (sorted as bench.py sorts them) through the port's
     ProcessCirc.run(device_ext=True) (speculate-and-select waves on the
     four DP kernels): circ_res and candidate lines equal to the host native
     stage 2, edit_sc launched; both wall times and the device / host
     request counts reported; edit_sc's inputs recorded there, each row
     count bit-equal to its plain version and timed;
  9. the auto executor: its probe on the card under a fresh decision cache
     (CIRCMINER_CACHE_DIR), the measured detail and the choice; a second
     pipeline takes the choice from the cache without probing;
 10. single-end mapping of the 16,384 R1 reads (map_stream_se) with the
     device, device-chain, device-full and auto executors: every read's
     MatchedRead equal to native's; reads/s per executor;
 11. the port's CLI (--index, then paired-end --device gpu-wave, gpu-chain,
     gpu-full (traced with --trace-dir) and native, single-end -s with
     --device auto, gpu-full and native) on a small synthetic dataset:
     circ_report, mapping.pam and candidates.pam byte-equal to native, and
     the trace names cm.walk_waves and a hand kernel; then two concurrent
     --device gpu-full processes joined by --coordinator (a gloo process
     group, --num-hosts 2): circ_report byte-equal to the single-host run;
 12. the port's bench (python -m circminer_tpu_torch.bench --smoke) with
     --exec gpu-full --circ-device --repeat 2 and with --exec native: one
     JSON line each, the reference bench's keys, equal events;
 13. multi-contig rounds, tools/grch38_run.py --mini on the port: the data
     of circminer_tpu_torch.tools.grch38_run.phase_sim (3 simulated
     chromosomes of 3, 2 and 1 Mbp), 20,000 pairs, a 2 Mbp
     contig budget (CIRCMINER_CONTIG_SIZE) that packs them into 3 contigs,
     indexed, mapped round by round and called by the port's CLI (run in
     this process, with hooks) under --device gpu-full (stage 2 on the
     card) and native: every true event called, mapping.pam, circ_report
     and candidates.pam byte-equal (the tool's phase_eval), all four
     kernels launched by the map
     and stage 2 after their warm-ups; the gpu-full map in graph mode with
     one capture per contig; per-round pairs and deferrals,
     pairs/s and peak device memory reported;
 14. (run after phase 8) the sharded steps of parallel/mesh.py on one
     4,096-pair chr21 batch: make_sharded_full_step and
     make_index_sharded_full_step at world size 1 under NCCL (in this
     process) and at world size 2 under gloo (two rank processes on this
     card), each gathered blob bit-equal to the single-process step;
     merge_bsj_candidates carries the gpu-full map's BSJ rows; step and
     collective ms reported;
 15. (run after phase 7) one 4,096-pair chr21 step of phase 6's pipeline
     with seg_compact forced False and True: bit-equal blobs; per form
     the ms per step (CUDA events, 3 steps after a warm-up), the peak
     device memory of one step, and in one profiled run of the step's
     chain prefix the one chain_cells launch both forms take on the card
     and its device ms;
 16. (run after phase 7) the fused step's CUDA graph (ops/step_graph.py)
     on 4,096-pair chr21 batches: one eager step under
     torch.cuda.set_sync_debug_mode("error") (its aten ops counted, its
     launches those the capture records), a capture on batch 0 (capture
     and instantiation seconds, private pool bytes beside the bytes of the
     [b, M, P] junction tables that the chain DP reads by interval
     instead), four replays on
     other batches (the last a short one, padded) each bit-equal to the
     eager step on the same batch, ms per step graph against eager (CUDA
     events, in turns), peak device memory, and the device-busy share and
     device ops per step of one profiled graph-mode map of phase 6's reads,
     each hand kernel of the gpu-full path among them.

A [phases] line gives each phase's wall seconds.

The port owns every module it runs (simulator, index build, annotation,
extension generators and its C++ engines, built from native/*.cpp into
build/circminer_tpu_torch/); nothing of JAX and nothing of the reference
package circminer_tpu is imported, and the run checks both at the end.  The last stdout line is
{"ok": true, "device": {...}}; the line before it carries the card's name
and power limit, and the one before that the per-kernel JSON (launches on
the gpu-full path: the map of phase 6 (per graph replay) plus its stage 2
in phase 8, each counted from the end of its warm-up; launches_contigs in phase 13's
gpu-full map and stage 2, counted so too;
launches_mesh in phase 14's world-1 steps; ms, plain_ms, bound_ms at
B = 1024 for the DP kernels, at the main path's recorded inputs for
chain_cells, chain_dp, extract_kbest, mr_pair_fold, the walk's six
kernels (tiny_dp's at its largest
pool, phase 1's 4,096 rows), extend_core (phase 2's pair slots),
extend_leftover (the leftover's chains) and pair_grid (phase 2's reads);
main_ms per launch at the row counts of the main path; chain_dp's
buckets at CHAIN_BUCKETS).
"""

import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED_GENOME, SEED_READS = 20260817, 20260818
KERNEL_SOURCE = "circminer_tpu_torch/csrc/align_kernels.cu"
WALK_SOURCE = "circminer_tpu_torch/csrc/walk.cu"
WAVE_SOURCE = "circminer_tpu_torch/csrc/walk_wave.cu"
EXTEND_SOURCE = "circminer_tpu_torch/csrc/extend.cu"
PAIR_SOURCE = "circminer_tpu_torch/csrc/pair_grid.cu"
SOURCES = {"chain_dp": "circminer_tpu_torch/csrc/chain_dp.cu",
           "mr_pair_fold": "circminer_tpu_torch/csrc/mr_fold.cu",
           "walk_fold": WALK_SOURCE, "tiny_dp": WALK_SOURCE,
           "walk_scan": WALK_SOURCE, "walk_init": WAVE_SOURCE,
           "walk_pool": WAVE_SOURCE, "walk_commit": WAVE_SOURCE,
           "chain_cells": "circminer_tpu_torch/csrc/chain_cells.cu",
           "extract_kbest": "circminer_tpu_torch/csrc/extract_kbest.cu",
           "extend_core": EXTEND_SOURCE, "extend_leftover": EXTEND_SOURCE,
           "pair_grid": PAIR_SOURCE}
WALK_KERNELS = ("walk_fold", "tiny_dp", "walk_scan")
# the walk's lane set-up and wave body (csrc/walk_wave.cu)
WAVE_KERNELS = ("walk_init", "walk_pool", "walk_commit")
# the chain stage's two ends: the prelude's cells and the k-best extraction
END_KERNELS = ("chain_cells", "extract_kbest")
# phase 2's extend wrap-up and the same wrap-up on the leftover extends
EXTEND_KERNELS = ("extend_core", "extend_leftover")
# phase 2's per-read pair work: the grid, its slots, the chain order and
# the l/r-mate bundles
PAIR_KERNELS = ("pair_grid",)
DP_KERNELS = ("xdrop", "edit_sc", "edit_end", "one_side")
# in the gpu-full map
FULL_KERNELS = ("xdrop", "one_side", "edit_end", "chain_dp", "mr_pair_fold",
                *WALK_KERNELS, *WAVE_KERNELS, *END_KERNELS, *EXTEND_KERNELS,
                *PAIR_KERNELS)
# launches of one gpu-full step (and so of one replay)
PER_STEP = {"chain_dp": 1, "mr_pair_fold": 2, "walk_fold": 4, "walk_scan": 4,
            "tiny_dp": 5, "chain_cells": 1, "extract_kbest": 1,
            "walk_init": 1, "walk_pool": 4, "walk_commit": 4,
            "extend_core": 4, "extend_leftover": 1, "pair_grid": 1}
# the keys of every line of the reference bench (bench.py:329-343)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "executor",
              "backend", "n_pairs", "genome_len", "events", "true_events",
              "events_matched", "phases"}
REPLACES = {
    "xdrop": "circminer_tpu/ops/pallas_align.py:406",      # _xdrop_kernel
    "edit_sc": "circminer_tpu/ops/pallas_align.py:182",    # _edit_sc_kernel
    "edit_end": "circminer_tpu/ops/align_device.py:48",    # edit_end_scan_ref
    "one_side": "circminer_tpu/ops/align_device.py:122",   # one_side_scan_ref
    "chain_dp": "circminer_tpu/ops/chain.py:251",    # _chain_dp_core_lanes
    "mr_pair_fold": "circminer_tpu/ops/device_full.py:1510",   # pair_body
    # walk_fold's fori_loop (:628)
    "walk_fold": "circminer_tpu/ops/device_walk.py:544",
    # _tiny_end's lax.scan (:113); also device_full.py:101 _tiny_global
    "tiny_dp": "circminer_tpu/ops/device_walk.py:65",
    # scan_step, run by fori_loop(0, KSCAN) at :366
    "walk_scan": "circminer_tpu/ops/device_walk.py:247",
    # walk_waves' lane set-up (:163-235): _compact, the lane gathers, the
    # common-transcript pack
    "walk_init": "circminer_tpu/ops/device_walk.py:163",
    # wave_body's dedup, _compacts and window gathers (:374-452)
    "walk_pool": "circminer_tpu/ops/device_walk.py:374",
    # wave_body's scatter-back, overflow, emit and middle commit (:420-520)
    "walk_commit": "circminer_tpu/ops/device_walk.py:420",
    # _chain_prelude's cells: the bisect at :380, the seg_compact forms :407
    "chain_cells": "circminer_tpu/ops/chain.py:355",
    # extract_kbest_device_staged: lax.sort :84, pick_body :144 / :158
    "extract_kbest": "circminer_tpu/ops/device_finish.py:58",
    # _extend_core (flat :327), called by run_side (:1060-1085)
    "extend_core": "circminer_tpu/ops/device_full.py:214",
    # device_full_finish's two _extend_core_flat calls (:1353-1370)
    "extend_leftover": "circminer_tpu/ops/device_full.py:1353",
    # _phase2's pair grid (:875-908), rank and inverse (:910-926), grid_at
    # (:928), side_fields (:964), _is_left_chain (:801, called at :993)
    # and sel (:996)
    "pair_grid": "circminer_tpu/ops/device_full.py:861",
}


class SmokeFailure(Exception):
    pass


# wall seconds of each phase, in the order they ran (the [phases] line)
PHASE_S = {}
_LAP = [time.perf_counter()]


def lap(name):
    """Book the wall time since the last lap to phase ``name``."""
    now = time.perf_counter()
    PHASE_S[name] = round(now - _LAP[0], 1)
    _LAP[0] = now


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters, warm_s=0.0):
    """Mean device ms per call of fn over iters calls, after one warm-up
    call, or after calling it for warm_s seconds (so that a short kernel
    is timed at the card's working clock, not while it ramps up from
    idle)."""
    import torch
    t_end = time.perf_counter() + warm_s
    fn()
    torch.cuda.synchronize()
    while time.perf_counter() < t_end:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


# device records of the primer launches the tracer dropped, per device_ms
# session (reported with the summary)
PRIMER_LOST = []


def device_ms(fn, kernel, iters, warm_s=0.2, primer=512, rest=False):
    """Mean device time per launch of the CUDA kernel whose symbol holds
    ``kernel`` (with ``rest``, plus every other device record of fn's
    calls), over iters calls of fn, from the profiler's device events:
    a kernel shorter than its wrapper's host cost would otherwise be timed
    at the rate the host can launch it.  Once a process has traced a long
    run, the tracer drops the device records of the first launches of each
    session (2-27 of them on the H100 host), so every session starts with
    ``primer`` launches of another kernel (torch's one-cycle spin_kernel)
    that are not counted; a session that kept fewer than nine in ten of
    fn's launches is traced again, up to 3 times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda_ms(fn, 1, warm_s)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(primer):
                torch.cuda._sleep(1)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ev = [e for e in dev if kernel in e.name]
        n_kern = len(ev)
        PRIMER_LOST.append(primer - sum("spin_kernel" in e.name for e in dev))
        if len(ev) >= iters * 9 // 10:
            break
    check(len(ev) >= iters * 9 // 10, f"the profiler saw {len(ev)} "
          f"launches of {kernel} in {iters} calls, three times")
    if rest:
        ev = [e for e in dev if "spin_kernel" not in e.name]
    return sum(e.time_range.elapsed_us() for e in ev) / n_kern / 1e3


def device_split(fn, iters=50, primer=512, holds="walk_"):
    """{kernel: mean device ms per call} over iters calls of fn, from the
    profiler's device records of the kernels whose symbol holds ``holds``:
    one call's records in launch order, a kernel that a call launches more
    than once named by its turn (``walk_compact_kernel#1``, ``#2``).  A
    session that lost a record (the tracer drops a later session's first
    records; ``device_ms``) is traced again, up to 3 times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda_ms(fn, 1, 0.2)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(primer):
                torch.cuda._sleep(1)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and holds in e.name),
                    key=lambda e: e.time_range.start)
        if ev and len(ev) % iters == 0:
            break
    check(ev and len(ev) % iters == 0, f"the profiler kept {len(ev)} "
          f"records of {iters} calls, three times")
    k = len(ev) // iters
    names = [e.name.replace("(anonymous namespace)::", "").split("(")[0]
             for e in ev[:k]]
    check(all(e.name == ev[i % k].name for i, e in enumerate(ev)),
          f"the calls' records differ in order: {names}")
    labels = [n if names.count(n) == 1 else f"{n}#{names[:i + 1].count(n)}"
              for i, n in enumerate(names)]
    return {lab: sum(e.time_range.elapsed_us() for e in ev[i::k])
            / iters / 1e3 for i, lab in enumerate(labels)}


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------

def card_report():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# --------------------------------------------------------------------------

def kernel_inputs(rng, B, w, I=128):
    """Wave-shaped pair batch (as tests/test_pallas_align.py builds it):
    near-identical pairs, insertions, deletions and unrelated pairs, ~10%
    with an N base, plus a few degenerate rows; wv in [0, w], with every
    fourth row at w and the next at 0.  Indel and row shapes follow w held
    to [1, 20], so that wide bands keep reads of realistic length."""
    import numpy as np
    wv_max, w = w, min(max(w, 1), 20)
    L = I - 1
    s = np.zeros((B, L), np.int8)
    t = np.zeros((B, L), np.int8)
    ns = np.zeros(B, np.int32)
    ms = np.zeros(B, np.int32)
    for b in range(B):
        m = int(rng.integers(w + 1, 110))
        base = rng.integers(0, 4, size=m + 2 * w).astype(np.int8)
        kind = b % 5
        if kind == 0:                       # near-identical
            sv = base[:m].copy()
            for _ in range(int(rng.integers(0, 3))):
                sv[rng.integers(0, m)] = rng.integers(0, 4)
        elif kind == 1:                     # insertion in s
            n = min(m + int(rng.integers(1, w + 1)), 110)
            sv = np.concatenate([base[:m], rng.integers(0, 4, size=n - m)
                                 .astype(np.int8)])
        elif kind == 2:                     # deletion
            sv = base[:max(2 * w + 1, m - int(rng.integers(1, w + 1)))].copy()
        elif kind == 3:                     # unrelated
            sv = rng.integers(0, 4, size=int(rng.integers(2 * w + 1, 110))
                              ).astype(np.int8)
        else:                               # degenerate / boundary shapes
            sv = rng.integers(0, 5, size=int(rng.integers(0, 2 * w + 2))
                              ).astype(np.int8)
            m = int(rng.integers(0, w + 3))
        n = len(sv)
        if n and rng.random() < 0.1:        # sprinkle N
            sv[rng.integers(0, n)] = 4
        s[b, :n] = sv
        t[b, :m] = base[:m]
        ns[b], ms[b] = n, m
    wv = rng.integers(0, wv_max + 1, size=B).astype(np.int32)
    wv[0::4], wv[1::4] = wv_max, 0
    return s, t, ns, ms, wv


# the band widths / batch sizes the kernels are held to their plain versions
# at (one lane per item up to w = 6, or 13 for one_side, lane groups above
# it; B = 1 and 33 leave partial blocks)
SWEEP_W = (0, 1, 2, 3, 5, 8, 14, 31, 127)
SWEEP_B = (1, 33, 1024, 8192)
# H100 SXM peaks at 700 W (NVIDIA's data sheet): HBM3 bandwidth, and int32
# ALU throughput = 132 SMs x 64 INT32 lanes x the 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 132 * 64 * CLOCK_HZ
# int32 operations one DP cell needs at least: edit cells compare the bases,
# add the diagonal, take two mins and add the gap (5), edit_end tests the
# column (6), edit_sc packs and keeps its candidate key (12); an X-drop cell
# selects its substitution score, adds, takes two maxes and adds the gap
# (6), prunes (8) and keeps the running (value, i) max (9)
CELL_OPS = {"xdrop": 9, "edit_sc": 12, "edit_end": 6, "one_side": 5}
# dependent int32 operations per anti-diagonal (the next diagonal cannot
# start before they are done), each ~4 cycles of latency: the cell
# recurrence (add, min/max, add, min/max, the band mask) and, for X-drop and
# edit_sc, the diagonal's max that the next diagonal's prune or candidate
# test reads
CHAIN_OPS = {"xdrop": 12, "edit_sc": 12, "edit_end": 6, "one_side": 6}
CHAIN_CYCLES_PER_OP = 4


def kernel_cases(s, t, n, m, wv, w, max_ed, max_sc, sm):
    """name -> (wrapper call, plain version call, output columns)."""
    from circminer_tpu_torch.ops import align_device as ad
    from circminer_tpu_torch.ops import pallas_align as pa
    xd = dict(w=w, mat=sm.mat, mis=sm.mis, ind=sm.ind, xd=sm.xd)
    es = dict(w=w, max_ed=max_ed, max_sc=max_sc)
    return {
        "xdrop": (lambda: pa.xdrop_batch(s, t, n, m, **xd),
                  lambda: pa.xdrop_scan(s, t, n, m, **xd), 3),
        "edit_sc": (lambda: pa.edit_sc_batch(s, t, n, m, **es),
                    lambda: pa.edit_sc_scan(s, t, n, m, **es), 4),
        "edit_end": (lambda: ad.edit_end_batch(s, t, n, m, w=w,
                                               max_ed=max_ed),
                     lambda: ad.edit_end_scan(s, t, n, m, w=w,
                                              max_ed=max_ed), 2),
        "one_side": (lambda: ad.one_side_batch(s, t, n, m, wv, w=w),
                     lambda: ad.one_side_scan(s, t, n, m, wv), 1),
    }


def as_matrix(r):
    import torch
    if isinstance(r, torch.Tensor):
        return r if r.dim() == 2 else r[:, None]
    return torch.stack(r, dim=1)


def hold_to_plain(name, kern, plain, n, m, tag=""):
    """Kernel output vs plain version: bit-equal, or SmokeFailure."""
    import torch
    got, want = as_matrix(kern()), as_matrix(plain())
    if got.is_cuda:
        torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}{tag}: {tuple(got.shape)} {got.dtype} vs plain "
          f"{tuple(want.shape)} {want.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    if err:
        bad = (got != want).any(dim=1).nonzero()[:5, 0]
        raise SmokeFailure(
            f"{name}{tag} differs from its plain version (max abs err {err}) "
            f"at rows {bad.tolist()}: n={n[bad].tolist()} "
            f"m={m[bad].tolist()} got={got[bad].tolist()} "
            f"want={want[bad].tolist()}")
    return err


def xdrop_live(s, t, n, m, w, sm, I=128):
    """Per item, the in-band cells the X-drop DP visits and the diagonal it
    stops at (its dead band, or n + m): the band-local recurrence in numpy
    (window of w + 2 slots from lb - 1, as the kernel keeps it)."""
    import numpy as np
    B = s.shape[0]
    L = max(s.shape[1], 1)
    sc = np.where(s >= 4, 4, s).astype(np.int64)
    tc = np.where(t >= 4, 5, t).astype(np.int64)
    NEG = -10 ** 7
    W = min(w, 2 * I - 2) + 2
    q = np.arange(W)[None, :]
    wn, wm = np.minimum(n, w), np.minimum(m, w)
    kend = np.minimum(2 * I - 1, n + m)
    lb, ub = np.ones(B, np.int64), np.ones(B, np.int64)
    pre_ub, pre_opt, cur_opt = (np.zeros(B, np.int64) for _ in range(3))
    alive = (n > 0) & (m > 0)
    cells, stop = np.zeros(B, np.int64), np.where(alive, kend, 0)
    a = lb - 1
    P = np.where((q <= 1) & (q <= wn[:, None]) & (1 - q <= wm[:, None]),
                 sm.ind, NEG)
    PP = np.where(q == 0, 0, NEG).repeat(B, axis=0)
    rows = np.arange(B)[:, None]
    for k in range(2, int(kend.max(initial=1)) + 1):
        act = alive & (k <= kend)
        if not act.any():
            break
        p = a[:, None] + q
        j = k - p
        sv = sc[rows, np.clip(p - 1, 0, L - 1)] if s.shape[1] else 0
        tv = tc[rows, np.clip(j - 1, 0, L - 1)] if s.shape[1] else 0
        PPm = np.concatenate([np.full((B, 1), NEG), PP[:, :-1]], axis=1)
        Pm = np.concatenate([np.full((B, 1), NEG), P[:, :-1]], axis=1)
        v = np.maximum(PPm + np.where(sv != tv, sm.mis, sm.mat),
                       np.maximum(Pm, P) + sm.ind)
        band = (p >= np.maximum(lb, k - m)[:, None]) & (p <= np.minimum(
            np.minimum(ub, k - 1), np.minimum(n, I - 1))[:, None])
        N = np.where((j == 0) & (p <= wn[:, None]), sm.ind * p, NEG)
        N = np.where((p == 0) & (j >= 0) & (j <= wm[:, None]), sm.ind * j, N)
        pruned = np.where(v + sm.xd < pre_opt[:, None], NEG, v)
        N = np.where(band, pruned, N)
        cells += np.where(act, band.sum(axis=1), 0)
        vmax = np.where(band, v, NEG).max(axis=1)
        cur_opt = np.where(act & (vmax >= cur_opt), vmax, cur_opt)
        new_ub = np.where(band & (pruned > NEG), p, -1).max(axis=1)
        odd = (k - w) % 2 == 1 if k > w else False
        lb2 = np.where((k - lb == m) | (k > w and not odd), lb + 1, lb)
        ub2 = np.where((ub < n) & (k <= w or odd), ub + 1, ub)
        dead = ((pre_ub == -1) & (new_ub == -1)) | (lb2 > ub2)
        pre_ub = np.where(act, new_ub, pre_ub)
        pre_opt = np.where(act, np.maximum(pre_opt, cur_opt), pre_opt)
        delta = np.where(act, lb2 - lb, 0)[:, None] == 1
        lb, ub = np.where(act, lb2, lb), np.where(act, ub2, ub)
        stop = np.where(act & dead, k, stop)
        alive = alive & ~(act & dead)
        shift = (lambda x: np.where(delta, np.concatenate(
            [x[:, 1:], np.full((B, 1), NEG)], axis=1), x))
        PP, P = shift(P), shift(N)
        a = a + delta[:, 0]
    return cells, stop


def work(name, s, t, n, m, wv, w, sm):
    """(DP cells these inputs need, diagonals of the longest item)."""
    import numpy as np
    if name == "xdrop":
        cells, stop = xdrop_live(s, t, n, m, w, sm)
        return int(cells.sum()), int(stop.max(initial=0))
    i = np.arange(128)[None, :]     # cells (i, j), i <= n, j <= m, in band
    if name == "one_side":
        lo, hi = i, np.minimum(i + wv[:, None], m[:, None])
    else:
        lo, hi = np.maximum(0, i - w), np.minimum(i + w, m[:, None])
    per_row = np.where(i <= n[:, None], np.maximum(0, hi - lo + 1), 0)
    return int(per_row.sum()), int(np.minimum(255, n + m).max(initial=0))


def bounds(name, B, L, ncols, cells, diags):
    """(bound ms, what sets it, chain floor ms): bytes each input read once
    and each output written once over HBM bandwidth, against the cells'
    int32 operations over the ALU peak; the floor is the longest item's
    diagonals times one diagonal's dependent chain."""
    nbytes = B * (2 * L + 4 * 2 + 4 * ncols) + (4 * B if name == "one_side"
                                                else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = cells * CELL_OPS[name] / INT32_OPS_PER_S * 1e3
    floor = diags * CHAIN_OPS[name] * CHAIN_CYCLES_PER_OP / CLOCK_HZ * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", floor)


def measure(name, kern, plain, ncols, host, w, sm, iters=200,
            plain_iters=3):
    """Time one kernel (device time per launch) and its plain version (per
    call, CUDA events) on the card; add its bound and chain floor from these
    inputs (``host``: numpy s, t, n, m, wv)."""
    s, t, n, m, wv = host
    cells, diags = work(name, s, t, n, m, wv, w, sm)
    bound_ms, bound_by, floor = bounds(name, s.shape[0], s.shape[1], ncols,
                                       cells, diags)
    return dict(ms=device_ms(kern, f"{name}_kernel", iters),
                plain_ms=cuda_ms(plain, plain_iters),
                bound_ms=bound_ms, bound_by=bound_by, chain_floor_ms=floor,
                cells=cells, diagonals=diags)


def phase_kernels(device, B=1024, seed=7):
    """Each kernel (and wave_all_batch) vs its plain version on ``device``
    at the wave service's shape, timed, with its bound; then every kernel
    bit-equal over the SWEEP_W x SWEEP_B grid.  Returns {name: dict}."""
    import numpy as np
    import torch
    from circminer_tpu_torch.config import Config
    from circminer_tpu_torch.ops import align_device as ad
    from circminer_tpu_torch.ops.align import ScoreMat

    c, sm = Config(), ScoreMat()
    w, me, ms_ = c.band_width, c.max_ed, c.max_sc
    host = kernel_inputs(np.random.default_rng(seed), B, w)
    s, t, n, m, wv = (torch.from_numpy(a).to(device) for a in host)
    cases = kernel_cases(s, t, n, m, wv, w, me, ms_, sm)
    statics = dict(w=w, max_ed=me, max_sc=ms_, mat=sm.mat, mis=sm.mis,
                   ind=sm.ind, xd=sm.xd)
    res = {}
    for name, (kern, plain, ncols) in cases.items():
        err = hold_to_plain(name, kern, plain, n, m)
        res[name] = dict(max_abs_err=err, **measure(
            name, kern, plain, ncols, host, w, sm))
        r = res[name]
        log(f"[kernels] {name}: bit-equal to plain on B={B}, w={w}: "
            f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.3f} ms; bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}, {r['cells']} cells), "
            f"chain floor {r['chain_floor_ms']:.4f} ms over "
            f"{r['diagonals']} diagonals")
    hold_to_plain("wave_all_batch",
                  lambda: ad.wave_all_batch(s, t, n, m, wv, **statics),
                  lambda: ad.wave_all_scan(s, t, n, m, wv, **statics), n, m)
    log(f"[kernels] wave_all_batch: bit-equal to plain on B={B}")
    for w_ in SWEEP_W:
        for B_ in SWEEP_B:
            arrs = kernel_inputs(np.random.default_rng(w_ * 10007 + B_), B_,
                                 w_)
            s, t, n, m, wv = (torch.from_numpy(a).to(device) for a in arrs)
            for name, (kern, plain, _) in kernel_cases(
                    s, t, n, m, wv, w_, me, ms_, sm).items():
                hold_to_plain(name, kern, plain, n, m,
                              f" (w={w_}, B={B_})")
    log(f"[kernels] all four kernels bit-equal to plain at w in {SWEEP_W} "
        f"x B in {SWEEP_B}")
    return res


def chain_dp_inputs(rng, b, NL, S, P, *, k=3, max_ed=2, max_intron=6,
                    span=40):
    """Adversarial inputs of the chain DP (numpy, the shapes of
    ``_chain_cells`` and the annotation's tables): every value drawn from a
    window of ``span`` so that each gate, tie and junction branch is taken
    often; ~40% of cells and ~10% of rows invalid, repeated positions,
    minpos at exactly pi + max_intron, and ~5% of rows near the int32
    limit, where the sums wrap.  ~70% of cells have an interval of their
    own, whose segment ends lie near the cell's e1; ~10% share one of a few
    intervals; ~20% have none (ol_iv -1).  An interval's segments are the
    prefix p < iv_nseg, repeated in part (several accept at once)."""
    import numpy as np
    M = NL * S

    def r(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int64)
    pos = r(0, span, (b, M))
    pos[:, 1::3] = pos[:, 0:M - 1:3][:, :pos[:, 1::3].shape[1]]   # ties
    big = rng.random(b) < 0.05
    big[-1] = True
    pos[big] += 2 ** 31 - 2 * span
    qp = np.repeat(np.arange(NL)[None, :] * k + r(-1, 2, (b, NL)), S, 1)
    valid = rng.random((b, M)) < 0.6
    valid[rng.random(b) < 0.1] = False
    valid[0] = False
    ub = pos + r(-2, span // 2, (b, M))
    ub[big] = 2 ** 31 - 1
    mee = np.where(rng.random((b, M)) < 0.4, 0,
                   pos + r(0, 2 * k + 2, (b, M)))
    e1 = pos + k - 1
    # intervals: one per cell (0 .. b*M - 1), then n_sh shared ones
    n_sh = max(1, b * M // 64)
    u = rng.random((b, M))
    ol_iv = np.where(u < 0.7, np.arange(b * M).reshape(b, M),
                     np.where(u < 0.8, b * M + r(0, n_sh, (b, M)), -1))
    owner = np.concatenate([e1.reshape(-1),
                            e1.reshape(-1)[r(0, b * M, n_sh)]])
    seg_end = owner[:, None] + r(-2, 6, (b * M + n_sh, P))
    seg_next = r(0, span, (b * M + n_sh, P))
    rep = rng.random((b * M + n_sh, 1)) < 0.5
    seg_end[:, 1:] = np.where(rep, seg_end[:, :-1], seg_end[:, 1:])
    seg_next[:, 1:] = np.where(rep, seg_next[:, :-1], seg_next[:, 1:])
    big_iv = np.concatenate([np.repeat(big, M), np.zeros(n_sh, bool)])
    seg_next[big_iv] += 2 ** 31 - 2 * span
    iv_nseg = r(0, P + 1, b * M + n_sh)

    def i32(x):
        return x.astype(np.int32)     # wraps, as the device sums do
    arrays = (i32(pos), i32(qp), valid, i32(ub), i32(mee), i32(e1),
              i32(ol_iv), i32(iv_nseg), i32(seg_end), i32(seg_next))
    return arrays, dict(NL=NL, S=S, k=k, max_ed=max_ed,
                        max_intron=max_intron)


def chain_dp_warp_ties(rng, b, NL=3, S=600, P=4):
    """chain_dp_inputs at S above 512, where a row's 16 warps take two cells
    of a list each, with the last list's valid bits at two cells only: one
    in the first cells of a later warp (32 .. 87), one among warp 0's
    second cells (512 .. 543).  Their scores tie, so the list's first
    maximum is the smaller cell, in the later warp."""
    import numpy as np
    arrays, kw = chain_dp_inputs(rng, b, NL, S, P)
    valid = arrays[2].copy()
    last = valid[:, (NL - 1) * S:]
    last[:] = False
    rows = np.arange(b)
    last[rows, rng.integers(32, 88, b)] = True
    last[rows, rng.integers(512, 544, b)] = True
    return (*arrays[:2], valid, *arrays[3:]), kw


def fold_inputs(rng, B, P, *, max_tlen=60):
    """Adversarial inputs of the mr fold's pair steps (numpy): mr states of
    every type, pairs of every final type the rules compare, ed / mlen /
    tlen values from narrow windows (ties in go_for_update), gm on and off
    both sides, ~10% stopped and ~10% not live reads, and ~10% pairs past
    MAXDISCRDTLEN."""
    import numpy as np
    from circminer_tpu_torch.ops.device_full import (MM_USED, MR_KEYS,
                                                     PAIR_KEYS)

    def r(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int32)
    mr = r(0, 40, (B, len(MR_KEYS)))
    mr[:, MR_KEYS.index("type")] = np.array(
        [0, 1, 5, 5, 7, 9, 11, 13], np.int32)[r(0, 8, B)]
    mr[:, MR_KEYS.index("gm")] = r(0, 2, B)
    for f in ("mlen_r1", "mlen_r2"):
        mr[:, MR_KEYS.index(f)] = r(48, 52, B)
    for f in ("ed_r1", "ed_r2"):
        mr[:, MR_KEYS.index(f)] = r(0, 3, B)
    mr[:, MR_KEYS.index("tlen")] = r(-2, 5, B)
    shp = (B, 2, P)
    field = {
        "spos": r(0, 80, shp), "qspos": r(0, 10, shp),
        "qepos": r(0, 100, shp), "mlen": r(48, 52, shp),
        "led": r(0, 2, shp), "med": r(0, 3, shp), "red": r(0, 2, shp),
        "dir": r(-1, 2, shp),
        "tfinal": np.array([0, 0, 0, 0, 9, 9, 9, 11, 5], np.int32)[
            r(0, 9, shp)],
        "iv_s": r(-1, 3, shp), "iv_e": r(-1, 3, shp),
        "l_ok": r(0, 2, shp), "r_ok": r(0, 2, shp)}
    cols = {}
    for side in ("l_", "r_"):
        f = {kk: v[rng.permutation(B)] for kk, v in field.items()}
        f["epos"] = f["spos"] + r(0, 80, shp)
        far = rng.random(shp) < 0.1
        f["spos"] = np.where(far, f["spos"] + 30000, f["spos"])
        for kk in MM_USED:
            cols[side + kk] = f[kk]
    cols.update(se=r(0, 2, shp), sg_iv=r(0, 2, shp), bsj_hit=r(0, 2, shp),
                ct_tl=np.where(rng.random(shp) < 0.2,
                               r(max_tlen - 5, max_tlen + 6, shp),
                               r(-2, 5, shp)), ct_inn=r(0, 3, shp),
                ct_df=r(0, 2, shp), success=(rng.random(shp) < 0.8)
                .astype(np.int32), fwd_left=r(0, 2, shp))
    pairs = np.stack([cols[kk] for kk in PAIR_KEYS], axis=-1)
    # ~30% of reads repeat their first pair: exact ties in go_for_update
    dup = rng.random(B) < 0.3
    pairs[dup] = pairs[dup][:, :, :1]
    orient = np.stack([(rng.random((B, P)) < 0.8).astype(np.int32),
                       r(0, 3, (B, P)), r(0, 3, (B, P)), r(0, 5, (B, P))],
                      axis=-1)
    o_t = r(0, 2, B)
    live = rng.random(B) < 0.9
    stopped = rng.random(B) < 0.1
    return (mr, pairs, o_t, orient, live, stopped), dict(
        max_tlen=max_tlen, contig_num=int(rng.integers(0, 3)))


I32MAX = 2 ** 31 - 1


def _wrap32(x):
    """int64 numpy values as int32, with two's-complement wrap-around."""
    import numpy as np
    return ((np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32
            - 2 ** 31).astype(np.int32)


def walk_fold_inputs(rng, WPP, N, *, fam, left, ST=8, EW=4):
    """Adversarial inputs of the walk fold (``walk_fold_lanes``, numpy):
    every event kind, values from narrow windows (score and pos ties in
    both update rules), xp exactly at bnd + aux / bnd - aux and at
    bnd + need / bnd - need for a fifth of the events each, bounds at
    I32MAX and INT32_MIN, negative ed_th, a pool with lanes of every
    family (about half of them the folded one's) and dead rows past n_act
    that repeat live rows' slots."""
    import numpy as np

    def r(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int32)
    n_act = int(min(4 * N, rng.integers(max(1, 3 * WPP // 4), WPP + 1)))
    n_mine = min(N, n_act // 2)
    others = np.setdiff1d(np.arange(4 * N), np.arange(fam * N,
                                                      (fam + 1) * N))
    live = np.concatenate([rng.choice(N, n_mine, replace=False) + fam * N,
                           rng.choice(others, n_act - n_mine,
                                      replace=False)])
    inv = np.sort(live).astype(np.int32)
    inv = np.concatenate([inv, inv[r(0, n_act, WPP - n_act)]])
    ed_th = np.where(rng.random(N) < 0.15, r(-3, 0, N), r(0, 6, N))
    pick = rng.random(N)
    bound = np.select([pick < 0.2, pick < 0.4, pick < 0.5],
                      [I32MAX, -I32MAX - 1, 0], r(80, 140, N)).astype(
                          np.int32)
    p_pos, p_len = r(95, 106, WPP), r(30, 60, WPP)
    shp = (ST * EW, WPP)
    kind = rng.choice(5, size=shp, p=[0.15, 0.35, 0.1, 0.3, 0.1])
    aux, xp = r(0, 16, shp), r(60, 150, shp)
    bnd = bound[inv % N][None, :].astype(np.int64)
    need = p_len[None, :].astype(np.int64) - aux
    off = np.where(kind >= 3, need, aux)
    at = rng.random(shp)
    xp = np.where(at < 0.2, _wrap32(bnd + off), np.where(
        at < 0.4, _wrap32(bnd - off), xp))
    # consec: an end event at the lane's own position
    xp = np.where((at > 0.8) & (kind >= 3), p_pos[None, :], xp)
    ev = np.stack([kind.astype(np.int32), xp.astype(np.int32), aux,
                   r(0, 3, shp), r(-2, 3, shp), r(0, 9, shp),
                   r(-4, 4, shp)], axis=1)           # [ST * EW, EV_NF, WPP]
    act = rng.random((ST, WPP)) < 0.75
    p_live = np.arange(WPP) < n_act
    lane_defer = rng.random(WPP) < 0.2
    return ((np.ascontiguousarray(ev), act, inv, np.array(n_act, np.int32),
             p_live, p_pos, p_len, lane_defer, ed_th.astype(np.int32),
             bound), dict(fam=fam, left=left, max_ed=4, max_sc=7, band=3))


def tiny_dp_inputs(rng, B, w, *, end, share=1.0, L=127):
    """Adversarial inputs of the tiny DP (``tiny_dp``, numpy): bases from
    {0, 1} mostly (ties in ed and in |indel| between candidates), N (4)
    and padding (127) among them, lengths from -1 past the clamp, m near
    n; END at TN = TM = max(8, 2w + 2), GLOBAL at 4 x 8.  A share of the
    rows (0, 1 or between) falls back to the tiny DP; the others carry a
    banded answer to pass through, from a narrow window and int32's
    ends."""
    import numpy as np
    NM, MM = (max(8, 2 * w + 2),) * 2 if end else (4, 8)
    alphabet = np.array([0, 1] * 7 + [2, 3, 4, 127], np.int8)
    s = alphabet[rng.integers(0, len(alphabet), (B, L))]
    t = np.where(rng.random((B, L)) < 0.5, s, alphabet[rng.integers(
        0, len(alphabet), (B, L))]).astype(np.int8)
    n = rng.integers(-1, NM + 3, B)
    m = np.where(rng.random(B) < 0.8, n + rng.integers(-w - 1, w + 2, B),
                 rng.integers(-1, MM + 3, B))
    # a third of the rows: 0101... against 1010..., m = n - 1, where the
    # candidates at indel +d and -d tie (the strict key keeps the first)
    alt = rng.random(B) < 0.3
    ph = np.arange(L)[None, :] + rng.integers(0, 2, (B, 1))
    s = np.where(alt[:, None], ph % 2, s).astype(np.int8)
    t = np.where(alt[:, None], (ph + 1) % 2, t).astype(np.int8)
    m = np.where(alt, n - 1, m)
    tiny = rng.random(B) < share
    shape = (B, 2) if end else (B,)
    banded = np.where(rng.random(shape) < 0.1, rng.choice(
        [I32MAX, -I32MAX - 1, 10 ** 7], shape), rng.integers(-9, 10, shape))
    return ((s, t, n.astype(np.int32), m.astype(np.int32), tiny,
             banded.astype(np.int32)),
            dict(NM=NM, MM=MM, w=w, max_ed=2 + w // 2, end=end))


def walk_scan_inputs(rng, STW, WPP, *, NIV=200, NS=300, KSCAN=12):
    """Adversarial inputs of the interval scan (``walk_scan``, numpy): a
    genome that ends inside the annotation's last quarter (references out
    of bounds on the right) and positions near 0 (on the left),
    transcripts that start before interval 0 and run past the table,
    t2s states 0, 1 and 2, lanes in every status (mostly scanning), exlen
    and remref from a window around 0 (empty flushes, negative rr2) and
    covered near qlen."""
    import numpy as np

    def r(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int32)
    ln = r(1, 40, NIV)
    spos = np.cumsum(ln + r(0, 30, NIV)).astype(np.int32)
    epos = (spos + ln - 1).astype(np.int32)
    G = int(epos[3 * NIV // 4])
    t2s = rng.choice(3, NS, p=[0.25, 0.35, 0.4]).astype(np.uint8)
    shp = (STW, WPP)
    tstart, tlen = r(-2, NIV, shp), r(0, 25, shp)
    toff = r(-3, NS, shp)
    i_abs = tstart + r(-2, 27, shp)
    ivc = np.clip(i_abs, 0, NIV - 1)
    near0 = rng.random(shp) < 0.1
    xpos = np.where(near0, r(-3, 30, shp), spos[ivc] + r(-3, 4, shp))
    qlen = r(10, 100, WPP)
    covered = np.minimum(r(0, 100, shp), qlen[None, :] + 2)
    stat = np.where(rng.random(shp) < 0.85, 0, r(1, 6, shp))
    exlen = np.where(rng.random(shp) < 0.2, 0, r(-2, 80, shp))
    ws = np.stack([i_abs, xpos, exlen, covered, r(0, 2, shp), stat,
                   *(r(-5, 100, shp) for _ in range(5)),
                   r(-10, 120, shp)]).astype(np.int32)
    # a fifth of the lanes start at their first slot's interval (a left
    # walk's empty flush)
    pos = np.where(rng.random(WPP) < 0.2, spos[ivc[0]], r(-5, G + 10, WPP))
    lane = np.stack([r(0, 2, WPP), qlen, pos])
    slot = np.stack([tstart, toff, tlen]).astype(np.int32)
    return ((ws, slot, lane.astype(np.int32), spos, epos, t2s),
            dict(KSCAN=KSCAN, G=G))


def walk_anno(rng, NIV, NT, ST, *, G=None, NS=None):
    """A walk annotation (numpy): NIV ordered intervals, a genome of G
    bases ending inside the last quarter (references out of bounds on the
    right), NT transcripts over runs of intervals (some starting before
    interval 0 or running past the table), their t2s states (0, 1, 2) and
    per interval ST tid slots from a small alphabet with duplicates, -1
    pads, tids past NT and lists of more than 8 shared tids."""
    import numpy as np

    def r(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int32)
    ln = r(1, 40, NIV)
    spos = np.cumsum(ln + r(0, 30, NIV)).astype(np.int32)
    epos = (spos + ln - 1).astype(np.int32)
    G = int(epos[3 * NIV // 4]) if G is None else G
    tlen = r(1, 12, NT)
    t2s_off = np.concatenate([[0], np.cumsum(tlen)]).astype(np.int32)
    NS = int(t2s_off[-1]) if NS is None else NS
    t2s = rng.choice(3, NS, p=[0.2, 0.4, 0.4]).astype(np.uint8)
    trans_start = r(-2, NIV, NT)
    tids = np.where(rng.random((NIV, ST)) < 0.8, r(0, min(NT + 2, 14),
                                                    (NIV, ST)), -1)
    # a tenth of the intervals list one run of 10 tids (> STW in common)
    wide = rng.random(NIV) < 0.1
    tids[wide, :min(ST, 10)] = np.arange(min(ST, 10))
    return dict(iv_spos=spos, iv_epos=epos, iv_tids=tids.astype(np.int32),
                trans_start=trans_start, t2s_off=t2s_off, t2s_state=t2s,
                G=G)


def walk_init_inputs(rng, N, WPP, *, share, NIV=60, NT=30, ST=16, EW=4,
                     band=3, left4=(True, True, False, False)):
    """Adversarial inputs of the walk's lane set-up (``walk_init``, numpy):
    a share of the [4, N] slots active (past WPP lanes at a high share),
    lane tables with positions and anchor intervals out of range on both
    sides, pair anchors (fiv, riv) off the table, and walk_anno's tid
    lists (shared tids past STW, duplicates, pads, tids past NT)."""
    import numpy as np

    def r(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int32)
    an = walk_anno(rng, NIV, NT, ST)
    act4 = rng.random((4, N)) < share
    tab = [r(-5, an["G"] + 10, (4, N)), r(-2, 120, (4, N)),
           r(-2, NIV + 2, (4, N)), r(-1, 50, (4, N)), r(-3, 60, (4, N))]
    fiv, riv = r(-2, NIV + 2, N), r(-2, NIV + 2, N)
    # a third of the pairs anchor both mates in one interval (every tid
    # shared)
    same = rng.random(N) < 0.3
    riv = np.where(same, fiv, riv).astype(np.int32)
    return ((act4, *tab, fiv, riv, an["iv_epos"], an["iv_tids"],
             an["trans_start"], an["t2s_off"]),
            dict(left4=left4, band=band, EW=EW, WPP=WPP))


def walk_state_inputs(rng, STW, WPP, *, G, R=40, L=150):
    """A scan state after a wave's scan (numpy): every status, pending
    geometry from narrow windows and slot 0's copied into later slots for
    a third of the (slot, lane) pairs (dedup ties across slots), lengths
    from -3 to past the windows' I - 1, references at and past the
    genome's ends, query windows at and past the reads' row ends; the lane
    constants (is_left, qlen, pos) and the pools' rows (row, qs0); R reads
    of L bases and a genome of G bases (codes 0-4)."""
    import numpy as np

    def r(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int32)
    shp = (STW, WPP)
    stat = rng.choice(6, shp, p=[0.1, 0.3, 0.1, 0.3, 0.1, 0.1])
    xpos = np.where(rng.random(shp) < 0.5, r(-3, 40, shp),
                    r(G - 40, G + 3, shp))
    pend = [xpos, r(-3, 140, shp), r(0, 12, shp), r(-3, 140, shp)]
    pend[1] = np.where(rng.random(shp) < 0.5, pend[1] % 8, pend[1])
    pend[3] = np.where(rng.random(shp) < 0.5, pend[3] % 8, pend[3])
    tie = rng.random(shp) < 0.35
    for f in pend:
        f[:] = np.where(tie, f[:1], f)
    qlen = r(0, 135, WPP)
    ws = np.stack([r(-2, 60, shp), r(-3, G + 3, shp), r(-3, 40, shp),
                   r(0, 40, shp), r(0, 2, shp), stat.astype(np.int32),
                   r(-2, 62, shp), pend[0], pend[1], pend[2], pend[3],
                   r(-5, 140, shp)]).astype(np.int32)
    lane = np.stack([r(0, 2, WPP), qlen, r(-5, G + 5, WPP)])
    prow = np.stack([r(-1, R + 1, WPP), r(-3, L, WPP)])
    seqsf = rng.integers(0, 5, R * L).astype(np.int8)
    genome = rng.integers(0, 5, G).astype(np.int8)
    return ws, lane.astype(np.int32), prow.astype(np.int32), seqsf, genome


def walk_pool_inputs(rng, STW, WPP, *, MIDP, ENDP, band=3, G=3000, L=150):
    """Adversarial inputs of a wave's pools (``walk_pool``, numpy): a
    walk_state_inputs state; MIDP / ENDP below the leaders to overflow,
    or above them to leave dead rows."""
    ws, lane, prow, seqsf, genome = walk_state_inputs(rng, STW, WPP, G=G,
                                                      L=L)
    return ((ws, lane, prow, seqsf, genome),
            dict(L=L, band=band, MIDP=MIDP, ENDP=ENDP))


def walk_commit_inputs(rng, STW, WPP, *, MIDP, ENDP, EW=4, NIV=60, band=3,
                       G=3000):
    """Adversarial inputs of a wave's commit (``walk_commit``): a
    walk_state_inputs state and its pools' maps and rows (the plain
    ``walk_pool``: leaders, followers, overflowed leaders), the middle
    DPs' (ed, indel) and the end DPs' (score, on_s, on_t) from narrow
    windows and int32's ends (scores below 0 and floor divisions of
    negatives), pending intervals off the table, prefilled events and
    counts from -1 past EW (numpy, but the maps)."""
    import numpy as np
    import torch
    from circminer_tpu_torch.ops import device_walk as dw

    def r(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int32)
    (ws, lane, prow, seqsf, genome), kw = walk_pool_inputs(
        rng, STW, WPP, MIDP=MIDP, ENDP=ENDP, band=band, G=G)
    pool = dw._walk_pool_plain(*(torch.from_numpy(a) for a in (
        ws, lane, prow, seqsf, genome)), **kw, I=128)
    an = walk_anno(rng, NIV, 8, 4)
    md = np.where(rng.random((MIDP, 2)) < 0.1, rng.choice(
        [I32MAX, -I32MAX - 1, 10 ** 7], (MIDP, 2)), r(-4, 9, (MIDP, 2)))
    xres = np.stack([np.where(rng.random(ENDP) < 0.1, rng.choice(
        [I32MAX, -I32MAX - 1], ENDP), r(-30, 60, ENDP)),
        r(-2, 130, ENDP), r(-2, 130, ENDP)], axis=1)
    events = r(-9, 10, (STW, EW, 7, WPP))
    nev = r(-1, EW + 2, (STW, WPP))
    return ((ws, pool.maps.numpy(), md.astype(np.int32),
             xres.astype(np.int32), pool.e_rows.numpy(), lane,
             an["iv_spos"], an["iv_epos"], events, nev),
            dict(mat=1, mis=-3, band=band, max_ed=2 + band // 2, max_sc=7))


def chain_cells_inputs(rng, B, NL, S, *, n_iv=40, P=4, k=5, max_ed=2):
    """Adversarial inputs of the chain prelude's cells (``chain_cells``,
    numpy): ascending interval starts with gaps, adjacent intervals and
    repeated starts; positions before the first interval, in gaps, inside
    intervals, within k of an interval's end (the k-mer crosses it), past
    the last, at byte edges of a near-border bitmap that stops short
    of the genome, negative, and ~5% of rows near INT32_MAX (the sums
    wrap); segment counts 0 .. P, segment ends around the interval's end
    with next-exon starts of 0 among them; aggregates drawn apart from the
    segments (0 among them); counts from -1 past S; read lengths that make
    read_remain negative.  n_iv = 1 is one interval."""
    import numpy as np

    def r(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int64)
    M = NL * S
    ln = r(1, 12, n_iv)
    gap = np.where(rng.random(n_iv) < 0.2, 0, r(1, 9, n_iv))
    spos = 20 + np.cumsum(ln + gap) - ln
    for i in np.nonzero(rng.random(n_iv) < 0.1)[0]:
        if i:
            spos[i] = spos[i - 1]                  # a repeated start
    epos = spos + ln - 1
    G = int(epos.max()) + 24
    iv_nseg = np.where(rng.random(n_iv) < 0.2, 0, r(1, P + 1, n_iv))
    seg_end = epos[:, None] + r(-3, 10, (n_iv, P))
    seg_next = np.where(rng.random((n_iv, P)) < 0.2, 0, r(1, G, (n_iv, P)))
    aggr = [epos + r(-3, 10, n_iv) for _ in range(3)]
    for a in aggr:
        a[rng.random(n_iv) < 0.15] = 0
    nb_bits = r(0, 256, max(1, G // 8 - 2)).astype(np.uint8)
    # positions: a kind per cell
    iv_of = r(0, n_iv, (B, M))
    kind = rng.choice(7, size=(B, M), p=[0.3, 0.25, 0.1, 0.1, 0.1, 0.1,
                                          0.05])
    pos = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3, kind == 4, kind == 5],
        [spos[iv_of] + r(0, 12, (B, M)),            # inside or just past
         epos[iv_of] - r(0, k, (B, M)),             # the k-mer crosses
         epos[iv_of] + r(1, 9, (B, M)),             # a gap
         r(-3, int(spos[0]) + 1, (B, M)),           # before the first
         int(epos[-1]) + r(0, 30, (B, M)),          # past the last
         8 * r(0, G // 8 + 3, (B, M)) + r(-1, 1, (B, M))],   # byte edges
        r(-20, G + 40, (B, M)))
    big = rng.random(B) < 0.05
    big[-1] = True
    pos[big] += 2 ** 31 - G - 2
    cnt = r(-1, S + 2, (B, NL))
    qpos = r(-1, k * NL + 2, (B, NL))
    seq_len = r(0, k * NL + 30, B)
    seq_len[rng.random(B) < 0.05] = -2 ** 31 + 3
    arrays = (_wrap32(pos).reshape(B, NL, S), *map(_wrap32, (
        cnt, qpos, seq_len)), nb_bits, *map(_wrap32, (
            spos, epos, *aggr, iv_nseg, seg_end, seg_next)))
    return arrays, dict(k=k, max_ed=max_ed, seg_pad=P)


def extract_kbest_inputs(rng, R, NL, S, *, iters=48, C=7, k=5):
    """Adversarial inputs of the k-best extraction (``extract_kbest``,
    numpy): per row a share of event cells from none (the single-fragment
    fallback) through sparse to dense (event cells that outnumber
    ``iters``), and a quarter of the rows with exactly 0, 1, 31, 32, 33 or
    iters + 1 event cells; back pointers into the next list (walks of
    every length up to NL) or any cell (walks that loop); scores from a
    narrow window (ties), rows where every cell ties, and _NEG (an event
    key that ties with the other cells' 2^29), INT32_MIN (key INT32_MIN,
    first), INT32_MAX and scores strictly between INT32_MIN and _NEG
    (-2^30, _NEG - 1: events ranked after every other cell) among them;
    positions from a window of 2, 8 or 1,000 a row, so that a head is
    often a non-head fragment of an earlier chain (repeats, with and
    without the best score); counts mostly S, else from -1 past S."""
    import numpy as np

    def r(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int64)
    M = NL * S
    dp = 10 * k + 10 * r(0, 6, (R, M))
    odd = rng.random((R, M))
    dp = np.where(odd < 0.03, -2 ** 29, np.where(
        odd < 0.05, -2 ** 31, np.where(odd < 0.06, 2 ** 31 - 1, np.where(
            odd < 0.065, -2 ** 30, np.where(odd < 0.07, -2 ** 29 - 1,
                                            dp)))))
    dp[rng.random(R) < 0.2] = 10 * k + 30
    l_of = np.arange(M) // S
    nxt = np.where(l_of < NL - 1, (l_of + 1) * S + r(0, S, (R, M)), -1)
    nxt = np.where(rng.random((R, M)) < 0.05, r(0, M, (R, M)), nxt)
    share = np.array([0.0, 0.05, 0.2, 0.6, 0.95])[r(0, 5, R)]
    back = np.where(rng.random((R, M)) < share[:, None], nxt, -1)
    # an event cell needs back >= 0: the last list's come from loops only
    pos = r(0, 1, (R, M)) + r(0, 1, (R, 1)) + rng.integers(
        0, np.array([2, 8, 1000])[r(0, 3, R)][:, None], (R, M))
    cnt = np.where(rng.random((R, NL)) < 0.8, S, r(-1, S + 2, (R, NL)))
    qpos = r(0, k * NL + 5, (R, NL))
    # rows of an exact event count: every cell in count, n cells pointing
    # back (into the next list, or anywhere from the last)
    counts = np.array([0, 1, 31, 32, 33, iters + 1])[r(0, 6, R)]
    anywhere = np.where(nxt >= 0, nxt, r(0, M, (R, M)))
    for row in np.flatnonzero(rng.random(R) < 0.25):
        cnt[row] = S
        back[row] = -1
        cells = rng.permutation(M)[:counts[row]]
        back[row, cells] = anywhere[row, cells]
    return ((_wrap32(dp).reshape(R, NL, S),
             back.astype(np.int32).reshape(R, NL, S),
             pos.astype(np.int32).reshape(R, NL, S),
             qpos.astype(np.int32), cnt.astype(np.int32)),
            dict(k=k, C=C, iters=iters))


def _dp_fields(rng, shape):
    """An end / genomic DP's (ed, sclen, indel, score), numpy int32: ed
    from -1 past max_ed 4, sclen past max_sc 7 (and at length - sclen =
    sclen for short lengths), scores from a narrow window (ties)."""
    import numpy as np
    return [rng.integers(lo, hi, size=shape).astype(np.int32)
            for lo, hi in ((-1, 7), (0, 10), (-3, 4), (-4, 4))]


def _positions(rng, shape, lo=1000, hi=1100):
    """Positions from a narrow window, with a tenth each near I32MAX (pos
    + length wraps), near 0 and near INT32_MIN."""
    import numpy as np
    pick = rng.random(shape)
    near = rng.integers(0, 40, size=shape)
    return np.select([pick < 0.1, pick < 0.2, pick < 0.3],
                     [I32MAX - near, near - 20, -I32MAX - 1 + near],
                     rng.integers(lo, hi, size=shape)).astype(np.int32)


def extend_core_inputs(rng, B, P, *, fam=0, left=True, active=0.5):
    """Adversarial inputs of one phase-2 extend family (``extend_core``,
    numpy, over [B, 2, P] slots): positions near I32MAX, 0 and INT32_MIN,
    lengths <= 0 for a tenth, bounds at I32MAX, 0, INT32_MIN and exactly
    at the gate (pos = bound + length left, pos + length = bound right),
    exon lengths at the covered edge, the walk and genomic DPs with ed,
    sclen, position and score ties against each other and the fold's best,
    and ``active`` the share of lanes the walk engine holds (its fold rows
    random everywhere: the extend reads them only there)."""
    import numpy as np
    shp = (B, 2, P)
    N = B * 2 * P

    def r(lo, hi, shape=shp):
        return rng.integers(lo, hi, size=shape).astype(np.int32)

    def coin(p, shape=shp):
        return rng.random(shape) < p
    length = np.where(coin(0.1), r(-3, 1), r(1, 40))
    pos = _positions(rng, shp)
    gate = _wrap32(pos.astype(np.int64) + (-length if left else length))
    pick = rng.random(shp)
    bound = np.select([pick < 0.15, pick < 0.3, pick < 0.4, pick < 0.6],
                      [I32MAX, 0, -I32MAX - 1, gate],
                      _wrap32(gate.astype(np.int64) + r(-3, 4))).astype(
                          np.int32)
    iv = np.where(coin(0.2), -1, r(0, 50))
    exon_len = np.where(coin(0.2), 0, length + r(-3, 5))
    covered = ((iv >= 0) & (exon_len >= length)) ^ coin(0.1)
    fold = np.stack([_wrap32(pos.reshape(-1).astype(np.int64)
                             + r(-5, 6, N)), r(-1, 7, N), r(0, 10, N),
                     r(-3, 4, N), r(-2, 45, N), r(-4, 4, N),
                     coin(0.3, N).astype(np.int32),
                     coin(0.2, N).astype(np.int32)])
    return ((pos, length, r(-2, 7), bound, coin(0.7), iv,
             exon_len.astype(np.int32), covered, coin(0.4), coin(0.85),
             coin(0.85), *_dp_fields(rng, shp), *_dp_fields(rng, shp),
             fold, coin(0.1, 4 * N), coin(active, (4, *shp))),
            dict(fam=fam, left=left, max_sc=7, band=3))


def extend_leftover_inputs(rng, B, KB1, NL):
    """Adversarial inputs of the leftover extends (``extend_leftover``,
    numpy, over [B, 4, KB1] chains): pos_l (rp4[..., 0]) and pos_r near
    0, INT32_MIN and I32MAX (the bounds 0 and I32MAX at and past the
    gate), remain_beg (qp4[..., 0]) and remain_end <= 0 for a tenth,
    est_mid past max_ed 4 (negative ed_th), the DP fields' ties."""
    import numpy as np
    shp = (B, 4, KB1)

    def r(lo, hi, shape=shp):
        return rng.integers(lo, hi, size=shape).astype(np.int32)

    def remain():
        return np.where(rng.random(shp) < 0.1, r(-3, 1), r(1, 40))
    rp4 = r(0, 10 ** 6, (*shp, NL))
    rp4[..., 0] = _positions(rng, shp, 0, 60)
    qp4 = r(0, 200, (*shp, NL))
    qp4[..., 0] = remain()
    return ((rp4, qp4, _positions(rng, shp), remain(), r(0, 7),
             rng.random(shp) < 0.85, rng.random(shp) < 0.85,
             *_dp_fields(rng, (*shp, 2, 2))), dict(max_ed=4, max_sc=7, band=3))


def is_left_chain_inputs(rng, B, KB1, NL, P, *, k=20):
    """Adversarial inputs of the chain-order walk (``_is_left_chain_plain``,
    numpy): a read's chains start near one base (a few near I32MAX, where
    an end + k - 1 wraps), with fragment gaps from k - 3 to 3k, so that a
    pair's two chains are separated, touch (one's end one before the
    other's start), share an end base or interleave; chain lengths 0 to
    NL; query offsets around the read length (both in, one out); any
    chain of each row picked by pi / pj."""
    import numpy as np

    def r(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int64)
    base = np.where(rng.random(B) < 0.05, I32MAX - 40 * k * NL,
                    r(1000, 10 ** 7, B))
    start = base[:, None, None] + r(-4 * k, 4 * k, (B, 4, KB1))
    gaps = r(k - 3, 3 * k, (B, 4, KB1, NL))
    gaps[..., 0] = 0
    rp4 = start[..., None] + np.cumsum(gaps, axis=-1)
    qp4 = np.cumsum(r(0, k + 4, (B, 4, KB1, NL)), axis=-1)
    lens4 = r(max(1, k * NL // 2), k * NL + 5, (B, 4))
    return ((_wrap32(rp4), qp4.astype(np.int32),
             r(0, NL + 1, (B, 4, KB1)).astype(np.int32),
             lens4.astype(np.int32), r(0, KB1, (B, 2, P)).astype(np.int32),
             r(0, KB1, (B, 2, P)).astype(np.int32)), dict(k=k))


def pair_grid_inputs(rng, B, KB1, NL, P, *, k=20, NIV=60, ST=16, SP=16,
                     NG=40, SEG_PAD=16):
    """Adversarial inputs of phase 2's pair grid (``pair_grid``, numpy):
    chain counts from 0 to past KB1; a read's chains within a spread of
    none, a few thousand, tens of thousands or millions of bases, so that
    none, some or all of its cells lie within MAXDISCRDTLEN (n_union 0, at
    P and past it), a twentieth near I32MAX (lastr + k wraps); fragments
    as ``is_left_chain_inputs`` makes them (separated, touching and
    interleaved chains); intervals -1, from the read's own few (shared
    tids and genes) and past NIV (clamped); tid lists from a pool of 12,
    empty, short, full and counted past their pad, a tenth with a -1
    inside; segment genes -1, past NG and past the interval's segment
    count, segment counts past SP and SEG_PAD; genes around the reads,
    some spanning everything; the other fields and flags random; defer
    words with bits already set."""
    import numpy as np
    from circminer_tpu_torch.config import MAXDISCRDTLEN
    from circminer_tpu_torch.ops.device_full import SF_BOOL, SF_INT

    def r(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int64)

    def coin(p, shape):
        return rng.random(shape) < p
    C = (B, 4, KB1)
    base = np.where(coin(0.05, B), I32MAX - 2 * k * NL,
                    r(10 ** 5, 10 ** 8, B))
    spread = rng.choice([0, 3000, 30000, 3 * 10 ** 6], size=B)
    start = base[:, None, None] + (rng.random(C) * spread[:, None, None]
                                   ).astype(np.int64) + r(-4 * k, 4 * k, C)
    gaps = r(k - 3, 3 * k, (*C, NL))
    gaps[..., 0] = 0
    rp4 = start[..., None] + np.cumsum(gaps, axis=-1)
    qp4 = np.cumsum(r(0, k + 4, (*C, NL)), axis=-1)
    clen = r(0, NL + 1, C)
    last = np.clip(clen - 1, 0, NL - 1)[..., None]
    lastr = np.take_along_axis(rp4, last, -1)[..., 0]
    lastq = np.take_along_axis(qp4, last, -1)[..., 0]
    lens4 = r(max(1, k * NL // 2), k * NL + 5, (B, 4))
    # intervals: -1, one of the read's three, past NIV
    pool = r(0, NIV, (B, 1, 1, 3))
    pick = rng.random(C)
    iv_l = np.select([pick < 0.2, pick < 0.25], [-1, NIV + r(0, 5, C)],
                     np.take_along_axis(pool, r(0, 3, (*C, 1)), -1)[..., 0])
    fields = dict(r0=rp4[..., 0], q0=qp4[..., 0], lastq=lastq, lastr=lastr,
                  remain_beg=qp4[..., 0], remain_end=lens4[:, :, None]
                  - (lastq + k), pos_l=rp4[..., 0], pos_r=lastr + k - 1,
                  iv_l=iv_l, iv_r=np.where(coin(0.2, C), -1, r(0, NIV, C)),
                  exon_len_l=r(-5, 200, C), exon_len_r=r(-5, 200, C),
                  mid_dp=r(-1, 7, C), clen=clen)
    sf_i = np.concatenate([np.stack([fields[n] for n in SF_INT], -1),
                           r(-4, 10, (*C, 16))], -1)
    sf_b = coin(0.5, (*C, len(SF_BOOL)))
    cn4 = np.where(coin(0.1, (B, 4)), 0, r(0, KB1 + 3, (B, 4)))
    defer = rng.choice([0, 1, 2, 1 << 5, 1 << 6, 3 << 5, 1 << 11], size=B)
    # the annotation
    ntid = rng.choice([0, 1, 2, 3, ST, ST + 5], size=NIV)
    iv_tids = np.where(np.arange(ST)[None, :] < ntid[:, None],
                       r(0, 12, (NIV, ST)), -1)
    hole = coin(0.1, NIV)
    iv_tids[hole, r(0, ST, int(hole.sum()))] = -1
    nseg_true = r(0, max(SP, SEG_PAD) + 4, NIV)
    iv_nseg = np.where(coin(0.8, NIV), np.minimum(nseg_true, SP),
                       r(0, SP + 3, NIV))
    seg_gene_p = np.select(
        [np.arange(SP)[None, :] >= nseg_true[:, None],
         coin(0.05, (NIV, SP)), coin(0.05, (NIV, SP))],
        [-1, -1, NG + r(0, 3, (NIV, SP))], r(0, NG, (NIV, SP)))
    centre = np.concatenate([base, r(0, I32MAX, NG)])[r(0, B + NG, NG)]
    gene_start = np.clip(centre - r(0, 3 * 10 ** 6, NG), 0, I32MAX)
    gene_end = np.clip(centre + r(0, 3 * 10 ** 6, NG), 0, I32MAX)
    wide = coin(0.1, NG)
    gene_start[wide], gene_end[wide] = 0, I32MAX
    # a tenth of the chains span exactly a gene of their read's first
    # interval (both bounds of the containment test at equality)
    ivc = np.clip(pool[:, 0, 0, 0], 0, NIV - 1)
    g = np.clip(seg_gene_p[ivc, 0], 0, NG - 1)[:, None, None] \
        + np.zeros(C, np.int64)
    snap = coin(0.1, C)
    fields["r0"] = np.where(snap, gene_start[g], fields["r0"])
    fields["lastr"] = np.where(snap, gene_end[g] - k, fields["lastr"])
    # a fifth of the reads with a pair at tlen MAXDISCRDTLEN, a fifth at
    # one past it (orientation 0: chains (0, 0) and (3, 0); 1: (2, 0) and
    # (1, 0))
    for fr, vr, past in ((0, 3, 0), (2, 1, 1)):
        edge = coin(0.2, B)
        fs, r0, lastr = (fields["r0"][:, fr, 0], fields["r0"][:, vr, 0],
                         fields["lastr"][:, vr, 0])
        r0[edge] = fs[edge] + 1
        lastr[edge] = fs[edge] + MAXDISCRDTLEN + past - k
    sf_i[..., SF_INT.index("r0")] = fields["r0"]
    sf_i[..., SF_INT.index("lastr")] = fields["lastr"]
    i32 = np.int32
    return ((_wrap32(sf_i), sf_b, _wrap32(rp4), qp4.astype(i32),
             cn4.astype(i32), lens4.astype(i32), defer.astype(i32),
             iv_tids.astype(i32), ntid.astype(i32), nseg_true.astype(i32),
             iv_nseg.astype(i32), seg_gene_p.astype(i32),
             gene_start.astype(i32), gene_end.astype(i32)),
            dict(k=k, P=P, SEG_PAD=SEG_PAD))


# the chain DP's adversarial sweep, (S, NL, P, rows): the gpu-chain
# buckets' S (16, 128, 500), lists of reads up to 300 bases at k = 20 (NL
# up to 15), P = seg_pad 16 (registers), 3 and 20 (the scan from memory)
CHAIN_SWEEP = ((16, 2, 16, 4096), (16, 6, 16, 4096), (16, 15, 16, 1024),
               (16, 6, 3, 257), (16, 6, 20, 257), (128, 2, 16, 256),
               (128, 6, 16, 256), (128, 15, 16, 64), (500, 2, 16, 64),
               (500, 6, 16, 32), (500, 15, 16, 8))
# the fold's, (reads, P_MAX), each at scan_level 0 and 1: read counts
# ragged against its 32-read blocks, P_MAX above its 8 staged steps
FOLD_SWEEP = ((4096, 8), (33, 1), (1, 2), (4096, 2), (31, 8), (4097, 8),
              (65, 9), (40, 16))
# a floor of the fold's int32 operations per (read, pair step): its masks
# and selects (~40) and the gates of its eight guarded updates (~60)
FOLD_STEP_OPS = 100


def tensor_kernel_calls(name, args, kw):
    """(kernel wrapper call, plain version call) of a ``launch_tensors``
    kernel (chain_dp, mr_pair_fold, one of WALK_KERNELS, WAVE_KERNELS,
    END_KERNELS, EXTEND_KERNELS or PAIR_KERNELS) on these arguments, each
    returning a tuple of tensors (walk_commit's: the events and counts it
    updates in place on copies of its inputs', then the new state)."""
    from circminer_tpu_torch.ops import chain_device as cd
    from circminer_tpu_torch.ops import device_finish as fin
    from circminer_tpu_torch.ops import device_full as df
    from circminer_tpu_torch.ops import device_walk as dw
    fns = {"chain_dp": (cd.chain_dp, cd._chain_dp_plain),
           "chain_cells": (cd.chain_cells, cd._chain_cells),
           "extract_kbest": (fin.extract_kbest_device,
                             fin.extract_kbest_device_staged),
           "mr_pair_fold": (df.mr_pair_fold, df._mr_pair_fold_plain),
           "walk_fold": (dw.walk_fold_lanes, dw._walk_fold_plain),
           "tiny_dp": (dw.tiny_dp, dw._tiny_dp_plain),
           "walk_scan": (dw.walk_scan, dw._walk_scan_plain),
           "walk_init": (dw.walk_init, dw._walk_init_plain),
           "walk_pool": (dw.walk_pool, dw._walk_pool_plain),
           "walk_commit": (dw.walk_commit, dw._walk_commit_plain),
           "extend_core": (df.extend_core, df._extend_core_plain),
           "extend_leftover": (df.extend_leftover,
                               df._extend_leftover_plain),
           "pair_grid": (df.pair_grid, df._pair_grid_plain)}
    kern, plain = fns[name]
    if name in WALK_KERNELS:                   # one tensor out
        return (lambda: (kern(*args, **kw),), lambda: (plain(*args, **kw),))
    if name == "walk_commit":
        def commit(fn):
            ev, nev = args[8].clone(), args[9].clone()
            ws = fn(*args[:8], ev, nev, **kw)
            return ev, nev, ws
        return lambda: commit(kern), lambda: commit(plain)
    if name in WAVE_KERNELS:                   # a named tuple out
        return (lambda: tuple(kern(*args, **kw)),
                lambda: tuple(plain(*args, **kw)))
    return lambda: kern(*args, **kw), lambda: plain(*args, **kw)


def hold_outputs(name, kern, plain, tag=""):
    """Each output of the kernel bit-equal to the plain version's (same
    dtype and shape), or SmokeFailure; returns the max abs error (0)."""
    import torch
    got, want = kern(), plain()
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name}{tag} output {i}: {g.dtype} {tuple(g.shape)} vs plain "
              f"{w.dtype} {tuple(w.shape)}")
        if not torch.equal(g, w):
            err = int((g.long() - w.long()).abs().max())
            g, w = g.reshape(-1, *g.shape[1:]), w.reshape(-1, *w.shape[1:])
            bad = (g != w).reshape(g.shape[0], -1).any(1).nonzero()[:3, 0]
            raise SmokeFailure(
                f"{name}{tag} output {i} differs from its plain version "
                f"(max abs err {err}) at rows {bad.tolist()}: "
                f"{g[bad[:1]].tolist()} vs {w[bad[:1]].tolist()}")
    return 0


def phase_chain_fold(device, seed=11):
    """Phase 2 for the chain DP and the mr fold's pair steps: each kernel
    bit-equal to its plain version on the card over the adversarial
    CHAIN_SWEEP (and chain_dp_warp_ties) and FOLD_SWEEP."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    for S, NL, P, b in CHAIN_SWEEP:
        arrs, kw = chain_dp_inputs(
            np.random.default_rng(seed + 31 * S + 7 * NL + P), b, NL, S, P)
        args = [torch.from_numpy(a).to(device) for a in arrs]
        hold_outputs("chain_dp", *tensor_kernel_calls("chain_dp", args, kw),
                     f" (S={S}, NL={NL}, P={P}, b={b})")
    arrs, kw = chain_dp_warp_ties(np.random.default_rng(seed), 64)
    args = [torch.from_numpy(a).to(device) for a in arrs]
    hold_outputs("chain_dp", *tensor_kernel_calls("chain_dp", args, kw),
                 " (ties across a row's warps, S=600)")
    t1 = time.perf_counter()
    for B, P in FOLD_SWEEP:
        for scan_level in (0, 1):
            arrs, kw = fold_inputs(
                np.random.default_rng(seed + B + 10 * P + scan_level), B, P)
            args = [torch.from_numpy(a).to(device) for a in arrs]
            hold_outputs("mr_pair_fold", *tensor_kernel_calls(
                "mr_pair_fold", args, dict(kw, scan_level=scan_level)),
                f" (B={B}, P={P}, scan_level={scan_level})")
    log(f"[kernels] chain_dp bit-equal to plain over (S, NL, P, rows) in "
        f"{CHAIN_SWEEP} and ties across a row's warps at S = 600 "
        f"({t1 - t0:.1f} s); mr_pair_fold over (B, P) in "
        f"{FOLD_SWEEP} x scan_level 0, 1 ({time.perf_counter() - t1:.1f} "
        f"s); adversarial inputs (chain_dp_inputs, fold_inputs)")


# the walk kernels' adversarial sweep, per kernel its cases: walk_fold
# (B, P_MAX, WPP, fam, left[, EW = 4]) at the main path's B = 4,096 (WPP
# 6,144) for every family and at ragged shapes; tiny_dp (rows, w, end, share of
# fallback rows) at the main path's pools (END on 512 rows, GLOBAL on
# 4,096 and 8,192) with no row, half the rows and every row falling back,
# and over bands up to w = 62 (TM = 126: the row in shared memory);
# walk_scan (STW, WPP, KSCAN) at the main path's 8 x 6,144 and ragged
# shapes; walk_init (N, WPP, active share, ST, left4) at the main path's
# 65,536 pair slots into 6,144 lanes below and past WPP, ragged, ST below
# STW, no active slot, at an 8,192-pair step's 131,072 pair slots into
# 12,288 lanes (four 32-flag groups a thread), a 16,384-pair step's
# 262,144 into 24,576 (eight, every group's mask in registers) and
# 300,000 (ten: two groups read again); walk_pool (STW, WPP, MIDP, ENDP,
# band) at the main path's pools, pools that overflow, dead rows past
# every leader, one slot, a wide band, an 8,192-pair step's 12,288 lanes
# and 30,000 ragged lanes (one and two lanes a thread), and 200,000 lanes
# that outgrow shared memory (13 lanes a thread, 10 kept; END rows past
# the CTAs' tables, live and dead); walk_commit (STW, WPP, MIDP, ENDP,
# EW, band) the same and EW 1 and 7
WALK_SWEEP = {
    "walk_fold": ((4096, 8, 6144, 0, True), (4096, 8, 6144, 1, True),
                  (4096, 8, 6144, 2, False), (4096, 8, 6144, 3, False),
                  (33, 2, 70, 1, False), (1, 1, 3, 0, True),
                  (64, 8, 129, 2, True), (64, 8, 129, 3, False, 7)),
    "tiny_dp": ((512, 3, True, 0.0), (512, 3, True, 0.5),
                (512, 3, True, 1.0), (4096, 3, False, 0.0),
                (4096, 3, False, 0.5), (4096, 3, False, 1.0),
                (8192, 3, False, 0.5), (1, 0, True, 1.0), (33, 1, True, 0.5),
                (1024, 5, True, 0.5), (300, 14, True, 1.0),
                (257, 31, True, 0.5), (129, 62, True, 1.0)),
    "walk_scan": ((8, 6144, 12), (8, 6144, 1), (3, 33, 30), (1, 1, 12),
                  (8, 129, 24)),
    "walk_init": ((65536, 6144, 0.02, 16, 0), (65536, 6144, 0.1, 16, 0),
                  (64, 40, 0.5, 16, 1), (200, 512, 0.9, 16, 2),
                  (33, 7, 0.3, 5, 0), (16, 100, 0.0, 3, 3),
                  (64, 40, 0.5, 20, 1), (131072, 12288, 0.02, 16, 0),
                  (131072, 12288, 0.1, 16, 0), (262144, 24576, 0.02, 16, 0),
                  (300000, 24576, 0.1, 16, 1)),
    "walk_pool": ((8, 6144, 512, 1024, 3), (8, 6144, 64, 96, 3),
                  (8, 40, 512, 300, 3), (3, 50, 8, 4, 0), (1, 33, 5, 70, 1),
                  (8, 300, 600, 10, 14), (8, 12288, 1024, 2048, 3),
                  (5, 30000, 64, 96, 3), (8, 200000, 4096, 60000, 3),
                  (5, 200000, 64, 300000, 3)),
    "walk_commit": ((8, 6144, 512, 1024, 4, 3), (8, 6144, 64, 96, 4, 3),
                    (8, 60, 16, 16, 4, 3), (3, 50, 8, 4, 1, 0),
                    (8, 200, 64, 128, 7, 5), (2, 33, 5, 70, 2, 1)),
}
# walk_init's left4 options (by WALK_SWEEP index): the main path's and
# others
LEFT4 = ((True, True, False, False), (False, True, True, False),
         (True, False, True, False), (False, False, False, True))


def walk_case(name, spec, device, seed):
    """(tensors on ``device``, kw) of one WALK_SWEEP case of ``name``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if name == "walk_fold":
        B, P, WPP, fam, left, *EW = spec
        arrs, kw = walk_fold_inputs(rng, WPP, B * 2 * P, fam=fam, left=left,
                                    EW=EW[0] if EW else 4)
    elif name == "tiny_dp":
        B, w, end, share = spec
        arrs, kw = tiny_dp_inputs(rng, B, w, end=end, share=share)
    elif name == "walk_init":
        N, WPP, share, ST, left = spec
        arrs, kw = walk_init_inputs(rng, N, WPP, share=share, ST=ST,
                                    left4=LEFT4[left])
    elif name == "walk_pool":
        STW, WPP, MIDP, ENDP, band = spec
        arrs, kw = walk_pool_inputs(rng, STW, WPP, MIDP=MIDP, ENDP=ENDP,
                                    band=band)
    elif name == "walk_commit":
        STW, WPP, MIDP, ENDP, EW, band = spec
        arrs, kw = walk_commit_inputs(rng, STW, WPP, MIDP=MIDP, ENDP=ENDP,
                                      EW=EW, band=band)
    else:
        STW, WPP, KSCAN = spec
        arrs, kw = walk_scan_inputs(rng, STW, WPP, KSCAN=KSCAN)
    return [torch.from_numpy(np.require(a, requirements="C")).to(device)
            for a in arrs], kw


def phase_walk(device, seed=17):
    """Phase 2 for the walk's kernels (walk_fold, tiny_dp, walk_scan,
    walk_init, walk_pool, walk_commit): each bit-equal to its plain version
    on the card over WALK_SWEEP, once eagerly and once replayed from a
    captured CUDA graph (its outputs overwritten before the replay)."""
    import torch
    t0 = time.perf_counter()
    n = 0
    for name, specs in WALK_SWEEP.items():
        for k, spec in enumerate(specs):
            args, kw = walk_case(name, spec, device, seed + 37 * k)
            kern, plain = tensor_kernel_calls(name, args, kw)
            hold_outputs(name, kern, plain, f" ({spec})")
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = kern()
            for x in out:
                x.fill_(-7)
            graph.replay()
            hold_outputs(name, lambda: out, plain, f" ({spec}, replayed)")
            n += 1
    log(f"[kernels] walk_fold, tiny_dp, walk_scan, walk_init, walk_pool and "
        f"walk_commit bit-equal to plain, eagerly and replayed from a CUDA "
        f"graph, over {n} cases "
        f"{ {k: v for k, v in WALK_SWEEP.items()} } "
        f"({time.perf_counter() - t0:.1f} s; adversarial inputs: "
        f"walk_fold_inputs, tiny_dp_inputs, walk_scan_inputs, "
        f"walk_init_inputs, walk_pool_inputs, walk_commit_inputs)")


# the chain ends' adversarial sweep: chain_cells (rows, NL, S,
# chain_cells_inputs options) at chr21's main shape (16,384 rows of 6 x
# 16, seg_pad 16), one interval, one segment slot, and gpu-chain's widest
# bucket (NL = 15, S = 500: M = 7,500 cells a row), each in both
# seg_compact forms; extract_kbest (rows, NL, S, iters, C) at chr21's
# main shape (C = KB + 1 = 7, EX_ITERS = 48), ragged and long lists, picks
# above M / 2, no pick, no slot, C above 32, picks above the blocking masks'
# 64, and a row of 15,000 cells, too wide to stage in shared memory (its
# walks read device memory); every case's rows hold the 2^29 boundary's
# scores and exact event counts (extract_kbest_inputs)
END_SWEEP = {
    "chain_cells": ((16384, 6, 16, dict(n_iv=2000, P=16)),
                    (257, 6, 16, dict(n_iv=1)), (33, 3, 7, dict(P=1)),
                    (128, 15, 500, dict(n_iv=500, P=16)), (1, 1, 1, {})),
    "extract_kbest": ((16384, 6, 16, 48, 7), (4097, 6, 16, 48, 7),
                      (300, 3, 20, 48, 7), (64, 15, 16, 48, 7),
                      (33, 2, 30, 60, 3), (9, 6, 16, 0, 7),
                      (12, 6, 16, 48, 0), (40, 1, 40, 40, 40),
                      (64, 3, 40, 100, 9), (4, 15, 1000, 48, 7)),
}


def end_case(name, spec, device, seed):
    """(tensors on ``device``, kw) of one END_SWEEP case of ``name``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if name == "chain_cells":
        B, NL, S, opt = spec
        arrs, kw = chain_cells_inputs(rng, B, NL, S, **opt)
    else:
        R, NL, S, iters, C = spec
        arrs, kw = extract_kbest_inputs(rng, R, NL, S, iters=iters, C=C)
    return [torch.from_numpy(np.require(a, requirements="C")).to(device)
            for a in arrs], kw


def phase_chain_ends(device, seed=23):
    """Phase 2 for the chain stage's ends (chain_cells in both seg_compact
    forms, extract_kbest): each bit-equal to its plain version on the card
    over END_SWEEP, once eagerly and once replayed from a captured CUDA
    graph (its outputs overwritten before the replay)."""
    import torch
    t0 = time.perf_counter()
    n = 0
    for name, specs in END_SWEEP.items():
        for k, spec in enumerate(specs):
            args, kw = end_case(name, spec, device, seed + 41 * k)
            forms = ((dict(kw, seg_compact=False), dict(kw, seg_compact=True))
                     if name == "chain_cells" else (kw,))
            for kwf in forms:
                kern, plain = tensor_kernel_calls(name, args, kwf)
                tag = f" ({spec}, {kwf})"
                hold_outputs(name, kern, plain, tag)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out = kern()
                # chain_cells' posf is a view of its input
                for x in out[1:] if name == "chain_cells" else out:
                    x.fill_(True if x.dtype == torch.bool else -7)
                graph.replay()
                hold_outputs(name, lambda: out, plain, tag + " replayed")
                n += 1
    log(f"[kernels] chain_cells (both seg_compact forms) and extract_kbest "
        f"bit-equal to plain, eagerly and replayed from a CUDA graph, over "
        f"{n} cases {END_SWEEP} ({time.perf_counter() - t0:.1f} s; "
        f"adversarial inputs: chain_cells_inputs, extract_kbest_inputs)")


# phase 2's extend kernels' adversarial sweep: extend_core (B, P_MAX, fam,
# left, share of engine lanes) at the main path's 4,096 x 2 x 8 slots for
# every family with chr21's ~5% engine lanes, and at ragged shapes with no,
# half and every lane held by the engine; extend_leftover (B, KB1, NL) at
# chr21's 4,096 x 4 x 7 chains of NL = 6 and ragged
EXTEND_SWEEP = {
    "extend_core": ((4096, 8, 0, True, 0.05), (4096, 8, 1, True, 0.05),
                    (4096, 8, 2, False, 0.05), (4096, 8, 3, False, 0.05),
                    (33, 3, 1, False, 0.5), (1, 1, 0, True, 1.0),
                    (257, 8, 2, True, 0.9), (64, 16, 3, False, 0.0)),
    "extend_leftover": ((4096, 7, 6), (33, 3, 1), (1, 1, 15),
                        (300, 16, 15)),
}


def extend_case(name, spec, device, seed):
    """(tensors on ``device``, kw) of one EXTEND_SWEEP case of ``name``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if name == "extend_core":
        B, P, fam, left, active = spec
        arrs, kw = extend_core_inputs(rng, B, P, fam=fam, left=left,
                                      active=active)
    else:
        arrs, kw = extend_leftover_inputs(rng, *spec)
    return [torch.from_numpy(np.require(a, requirements="C")).to(device)
            for a in arrs], kw


def phase_extend(device, seed=29, sweep=None, case=None, what=None):
    """Phase 2 for phase 2's extend kernels (extend_core, extend_leftover;
    or, with ``sweep``, ``case`` and ``what``, another sweep's kernels):
    each bit-equal to its plain version on the card over EXTEND_SWEEP,
    once eagerly and once replayed from a captured CUDA graph (its
    outputs overwritten before the replay)."""
    import torch
    t0 = time.perf_counter()
    n = 0
    for name, specs in (sweep or EXTEND_SWEEP).items():
        for k, spec in enumerate(specs):
            args, kw = (case or extend_case)(name, spec, device,
                                             seed + 43 * k)
            kern, plain = tensor_kernel_calls(name, args, kw)
            hold_outputs(name, kern, plain, f" ({spec})")
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = kern()
            for x in out:
                x.fill_(True if x.dtype == torch.bool else -7)
            graph.replay()
            hold_outputs(name, lambda: out, plain, f" ({spec}, replayed)")
            n += 1
    what = what or ("extend_core (phase 2's families) and extend_leftover "
                    "(the leftover extends), adversarial inputs from "
                    "extend_core_inputs and extend_leftover_inputs")
    log(f"[kernels] {what}: bit-equal to plain, eagerly and replayed from a "
        f"CUDA graph, over {n} cases {sweep or EXTEND_SWEEP} "
        f"({time.perf_counter() - t0:.1f} s)")


# phase 2's pair grid's adversarial sweep, (B, KB1, NL, P_MAX, {k, ST, SP,
# SEG_PAD}): chr21's 4,096 reads of KB1 = 7 chains, NL = 6 and P_MAX = 8;
# KB1 = 9 and 12 (81 and 144 cells: the rank carried over three and five
# 32-cell chunks), P_MAX past 32 and past KB1^2 (slots past every cell),
# one read of one chain, NL past 16, tid lists past 32 and pads of 3 and 4
# (lists over their pads), SEG_PAD other than the segment lists' width
PAIR_SWEEP = {
    "pair_grid": ((4096, 7, 6, 8, {}), (33, 3, 1, 2, dict(ST=4, SP=3,
                                                          SEG_PAD=3)),
                  (64, 9, 15, 8, {}), (40, 12, 4, 40, dict(k=3)),
                  (1, 1, 1, 1, {}), (257, 7, 17, 9, dict(ST=33, SP=5,
                                                         SEG_PAD=8)),
                  (100, 7, 6, 60, {})),
}


def pair_case(name, spec, device, seed):
    """(tensors on ``device``, kw) of one PAIR_SWEEP case."""
    import numpy as np
    import torch
    B, KB1, NL, P, kw = spec
    arrs, kw = pair_grid_inputs(np.random.default_rng(seed), B, KB1, NL, P,
                                **kw)
    return [torch.from_numpy(np.require(a, requirements="C")).to(device)
            for a in arrs], kw


def phase_pair(device, seed=31):
    """Phase 2 for phase 2's pair grid (pair_grid): bit-equal to its plain
    version on the card over PAIR_SWEEP, eagerly and replayed from a
    captured CUDA graph."""
    phase_extend(device, seed, PAIR_SWEEP, pair_case,
                 "pair_grid (phase 2's grid, slots, chain order and mate "
                 "bundles), adversarial inputs from pair_grid_inputs")


# gpu-chain's occupancy buckets above S = 16 at their row chunks
# (DeviceMappingPipeline._chunk_for) and the default config's NL = 15
# (max_read_len 300, k 20): (S, rows)
CHAIN_BUCKETS = ((128, 2048), (500, 128))


def phase_chain_buckets(device, seed=13, NL=15, P=16):
    """chain_dp at gpu-chain's S = 128 and 500 buckets on the adversarial
    inputs (no chr21 read fills them): bit-equal to its plain version,
    its device ms, the plain version's ms and its bound.  Returns
    {"S<S>": record}."""
    import numpy as np
    import torch
    out = {}
    for S, b in CHAIN_BUCKETS:
        arrs, kw = chain_dp_inputs(np.random.default_rng(seed + S), b, NL,
                                   S, P)
        args = [torch.from_numpy(a).to(device) for a in arrs]
        kern, plain = tensor_kernel_calls("chain_dp", args, kw)
        err = hold_outputs("chain_dp", kern, plain,
                           f" (bucket S={S}, NL={NL}, P={P}, b={b})")
        bound_ms, bound_by, ops = tensor_kernel_bound("chain_dp", args, kw)
        r = dict(rows=b, NL=NL, P=P, max_abs_err=err,
                 ms=device_ms(kern, "chain_dp_kernel", 3, warm_s=0.0),
                 plain_ms=cuda_ms(plain, 1), bound_ms=bound_ms,
                 bound_by=bound_by, ops=ops)
        out[f"S{S}"] = r
        log(f"[kernels] chain_dp at the gpu-chain bucket S={S} ({b} rows, "
            f"NL={NL}, P={P}, adversarial inputs): bit-equal to plain; "
            f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.1f} ms; bound "
            f"{bound_ms:.6f} ms ({bound_by}, {ops} int32 ops)")
    return out


def chain_dp_work(posf, qposf, validf, ub, mee, e1, ol_iv, iv_nseg, seg_end,
                  seg_next, *, NL, S, k, max_ed, max_intron, **_):
    """int32 operations the chain DP needs on these inputs, counted as the
    kernel does its work: 2 per cell for its list's first maximum (compare
    and select), 3 per invalid source cell (its candidate from the later
    lists' maximum: add, compare, select); per valid source cell and later
    list 2 per target for the maxIntron minimum, then 3 where that gate is
    closed (the list's maximum) or else 8 per target (the candidate's add,
    compare and select, the base gates), 8 per target past the base gates
    (the gap distance and gate) and 6 per junction segment scanned (those
    with pv_e, up to the first that accepts, where the gap gate failed and
    pjv > e1)."""
    import torch
    from circminer_tpu_torch.ops.chain_device import _junction_tables
    sep_c, snp_c, pv_c = _junction_tables(ol_iv, iv_nseg, seg_end, seg_next,
                                          seg_end.shape[1])
    b, P = posf.shape[0], sep_c.shape[1]
    pos_T, v_T, ub_T, mee_T, e1_T = posf.T, validf.T, ub.T, mee.T, e1.T
    src = slice(0, (NL - 1) * S)
    ops = 2 * b * NL * S + 3 * int((~v_T[src]).sum())
    for l in range(NL - 1):
        sl = slice(l * S, (l + 1) * S)
        pi, v_l = pos_T[sl][:, None, :], v_T[sl][:, None, :]
        ub_l, mee_l, e1_l = (x[sl][:, None, :] for x in (ub_T, mee_T, e1_T))
        for j in range(l + 1, NL):
            pjv = pos_T[j * S:(j + 1) * S][None]
            rd = qposf[:, j * S] - qposf[:, l * S] - k
            minpos = torch.where(pjv > pi, pjv, 2 ** 31 - 1).amin(
                dim=1, keepdim=True)
            gate = v_l & (minpos <= pi + max_intron)
            ops += 2 * S * int(v_l.sum()) + 3 * int((v_l & ~gate).sum()) \
                + 8 * S * int(gate.sum())
            base = (gate & v_T[j * S:(j + 1) * S][None] & (pjv > pi)
                    & (pjv <= ub_l))
            gd = pjv - pi - k
            g_ok = ((mee_l == 0) | ((pjv + k - 1) <= mee_l)) \
                & ((gd - rd).abs() <= max_ed)
            need = base & ~g_ok & (pjv > e1_l)
            ops += 8 * int(base.sum())
            for p in range(P):
                e12 = sep_c[sl, p:p + 1] - e1_l
                beg = pjv - snp_c[sl, p:p + 1]
                take = need & pv_c[sl, p:p + 1] & (e12 >= 0)
                ops += 6 * int(take.sum())
                need = need & ~(take & (beg >= 0)
                                & ((e12 + beg - rd).abs() <= max_ed))
    return ops


def chain_dp_bytes(posf, qposf, validf, ub, mee, e1, ol_iv, iv_nseg,
                   seg_end, seg_next, *, NL, S, **_):
    """Bytes the chain DP must move on these inputs, each read once: the
    position and valid bit of every cell, one query offset per list and
    the two int32 outputs; for a valid source cell (lists 0 .. NL-2) its
    three bounds and its interval; and for each interval that such a cell
    reads, its segment count, the segment ends below the count and the
    next-exon starts where some reading cell has e12end = sep - e1 >= 0.
    Nothing else enters the result."""
    import torch
    b, M = posf.shape
    P = seg_end.shape[1]
    vs = validf[:, :(NL - 1) * S]
    cell_iv = ol_iv[:, :(NL - 1) * S][vs]
    cell_e1 = e1[:, :(NL - 1) * S][vs]
    has = cell_iv >= 0
    iv, e1v = cell_iv[has].long(), cell_e1[has]
    pv = torch.arange(P, device=posf.device)[None, :] < iv_nseg[iv][:, None]
    e_ok = pv & (seg_end[iv] - e1v[:, None] >= 0)
    need = torch.zeros((seg_end.shape[0], P, 2), dtype=torch.int32,
                       device=posf.device)
    need[:, :, 0].index_put_((iv,), pv.to(torch.int32), accumulate=True)
    need[:, :, 1].index_put_((iv,), e_ok.to(torch.int32), accumulate=True)
    return (b * M * (4 + 1) + b * NL * 4 + 2 * b * M * 4
            + int(vs.sum()) * 4 * 4 + 4 * int(torch.unique(iv).numel())
            + 4 * int((need > 0).sum()))


# floors of the walk kernels' int32 operations: per event the fold reads
# (its kind tests, two bound tests with their sums, the candidate's five
# sums and the update rule's compares and selects), per DP cell of the
# tiny DP (the mismatch test, three sums, two minima, the column mask),
# and per scan step (two gathers' clamps, the accumulate, the break, the
# five window tests, the status chain and the advance)
FOLD_EVENT_OPS = 30
TINY_CELL_OPS = 8
SCAN_STEP_OPS = 60


def walk_work(name, args, kw):
    """(bytes, int32 ops) that a walk kernel needs on these inputs, each
    input read once and each output written once.  walk_fold: every pool
    row's inv and n_act, then for each live lane of the family its scalars
    and the events of its active transcripts; tiny_dp: every row's tiny
    bit and answer; a fallback row's lengths and the bases and cells
    inside them, another row's banded answer; walk_scan: the state in and
    out,
    the constants, the annotation's tables, and the steps taken while a
    slot scans (counted by running the plain version one step at a
    time)."""
    import torch
    from circminer_tpu_torch.ops import device_walk as dw
    if name == "walk_fold":
        (events, act, inv, n_act, p_live, _, _, _, ed_th, _) = args
        N = ed_th.shape[0]
        ST, WPP = act.shape
        EW = events.shape[0] // ST
        rows = torch.arange(WPP, device=inv.device) < n_act
        mine = rows & (inv // N == kw["fam"]) & p_live
        n_ev = EW * int((act & mine[None, :]).sum())
        nbytes = WPP * 4 + 4 + int(mine.sum()) * (18 + ST) \
            + n_ev * dw.EV_NF * 4 + len(dw.FOLD_OUT) * N * 4
        return nbytes, n_ev * FOLD_EVENT_OPS
    if name == "tiny_dp":
        s, t, n, m, tiny, banded = args
        nn = torch.clamp(n[tiny], 0, kw["NM"])
        mm = torch.clamp(m[tiny], 0, kw["MM"])
        B, nf = s.shape[0], int(tiny.sum())
        word = 4 * (2 if kw["end"] else 1)
        nbytes = B + B * word + (B - nf) * word + nf * 8 \
            + int(nn.sum()) + int(mm.sum())
        return nbytes, TINY_CELL_OPS * int((nn.long() * mm.long()).sum())
    ws, slot, lane, iv_spos, iv_epos, t2s = args
    steps, cur = 0, ws
    for _ in range(kw["KSCAN"]):
        steps += int((cur[dw.WS_KEYS.index("stat")] == dw.WK_SCAN).sum())
        cur = dw._walk_scan_plain(cur, *args[1:], KSCAN=1, G=kw["G"])
    nbytes = 2 * ws.numel() * 4 + slot.numel() * 4 + lane.numel() * 4 \
        + 2 * iv_spos.numel() * 4 + t2s.numel()
    return nbytes, steps * SCAN_STEP_OPS


# floors of the extend kernels' int32 operations: per extend of a slot
# (extend_one's compares, selects and wrapped sums)
EXT_EXTEND_OPS = 60


def extend_work(name, args, kw):
    """(bytes, int32 ops) that an extend kernel needs on these inputs, each
    input the kernel reads read once and each output written once.
    extend_core: every slot's scalars, flags and genomic DP, wx's walk
    flag, the walk DP where it can be taken and the fold's eight rows and
    overflow bit where the lane is active; its four outputs.
    extend_leftover: per chain both sides' position, length, flag and
    genomic DP, est_mid, and both sides' outputs."""
    import torch
    if name == "extend_core":
        (pos, _, _, _, has_tids, _, _, covered, wx, walk_inb, gen_inb,
         *rest) = args
        act = rest[10][kw["fam"]]
        n = pos.numel()
        walk_ok = covered & torch.where(wx, walk_inb, gen_inb)
        n_wdp = int((wx & walk_ok & has_tids).sum())
        n_act = int(act.sum())
        nbytes = n * (6 * 4 + 5 + 4 * 4) + int(wx.sum()) + n_wdp * 16 \
            + n_act * (8 * 4 + 1) + n * (1 + 4 + 6 * 4 + 1)
        return nbytes, n * EXT_EXTEND_OPS
    n = args[2].numel()
    return n * (5 * 4 + 2 + 2 * 4 * 4 + 2 * (1 + 4 + 6 * 4)), \
        2 * n * EXT_EXTEND_OPS


# floors of pair_grid's int32 operations: per grid cell (validity, tlen,
# union, the rank's share), per tid compare and per segment of the
# gene-span tests, per slot (its fields, the walk's ends and overlap), per
# step of the merge walk, per bundle field written
PG_CELL_OPS = 20
PG_TID_OPS = 2
PG_GENE_OPS = 4
PG_SLOT_OPS = 30
PG_STEP_OPS = 10
PG_FIELD_OPS = 2


def pair_walks(rp4, clen4, pcell, *, k):
    """Replay ``_is_left_chain``'s merge walk on every slot of these
    inputs as ``pair_grid``'s kernel runs it (a separated pair reads only
    its chains' ends): per slot its forward and reverse chain's flat index
    into [B * 4 * KB1], whether they are separated, the furthest fragment
    each walk reads, the overlap's fragments (bi, bj) and the walk's steps,
    each [B * 2 * P]."""
    import torch
    from circminer_tpu_torch.config import INF
    dev = pcell.device
    B, _, KB1, NL = rp4.shape
    P = pcell.shape[2]
    n = pcell.numel()
    b = torch.arange(B, device=dev).view(B, 1, 1)
    o = torch.arange(2, device=dev).view(1, 2, 1)
    pi, pj = (pcell // KB1).reshape(-1), (pcell % KB1).reshape(-1)
    ca = ((b * 4 + 2 * o) * KB1).expand(B, 2, P).reshape(-1) + pi
    cb = ((b * 4 + 3 - 2 * o) * KB1).expand(B, 2, P).reshape(-1) + pj
    pos, clen = rp4.reshape(-1, NL), clen4.reshape(-1)
    A, Bf, alen, blen = pos[ca], pos[cb], clen[ca], clen[cb]

    def at(x, idx):
        return x.gather(1, idx.clamp(0, NL - 1).long()[:, None])[:, 0]
    km1 = k - 1
    a_end, b_end = at(A, alen - 1) + km1, at(Bf, blen - 1) + km1
    apart = (Bf[:, 0] > a_end) | (A[:, 0] > b_end)
    i, j, reach_a, reach_b, steps = (
        torch.zeros(n, dtype=torch.int32, device=dev) for _ in range(5))
    bd = torch.full((n,), INF, dtype=torch.int32, device=dev)
    bi, bj = (torch.full((n,), -1, dtype=torch.int32, device=dev)
              for _ in range(2))
    go = ~apart
    for _ in range(2 * NL):
        go &= (i < alen) & (j < blen)
        ai, bjv = at(A, i), at(Bf, j)
        reach_a = torch.where(go, torch.maximum(reach_a, i), reach_a)
        reach_b = torch.where(go, torch.maximum(reach_b, j), reach_b)
        steps += go.int()
        a_first = ai + km1 < bjv
        b_first = ~a_first & (bjv + km1 < ai)
        d = torch.where(a_first, bjv - (ai + km1), ai - (bjv + km1))
        take = go & (((a_first | b_first) & (d < bd)) | ~(a_first | b_first))
        bd = torch.where(go & (a_first | b_first) & (d < bd), d, bd)
        bi, bj = torch.where(take, i, bi), torch.where(take, j, bj)
        i, j = i + (go & a_first), j + (go & b_first)
        go &= a_first | b_first
    return ca, cb, apart, reach_a, reach_b, bi, bj, steps


def pair_grid_bytes(sf_i, sf_b, rp4, qp4, cn4, lens4, defer, iv_tids,
                    iv_ntid, iv_nseg_true, iv_nseg, seg_gene_p, gene_start,
                    gene_end, *, k, P, SEG_PAD):
    """The bytes ``pair_grid`` needs on these inputs, each read once and
    each output written once: every field and flag of the chains that
    some slot takes (a bundle's fields), r0 and lastr of every other chain
    (the grid's tlen), iv_l of every other valid chain; of each slot
    chain its first and last position and, where its pair is not
    separated, the positions the merge walk reaches and the overlap's
    query offset (``pair_walks``); cn4, lens4 and defer; each distinct
    interval of a valid chain on an interval, its tid list, counts and
    segment genes, and each distinct gene those name; every output."""
    import torch
    from circminer_tpu_torch.ops import device_full as df
    B, _, KB1, NL = rp4.shape
    NI, NB = sf_i.shape[3], sf_b.shape[3]
    NIV, ST = iv_tids.shape
    SP, NG = seg_gene_p.shape[1], gene_start.shape[0]
    pcell = df._pair_grid_plain(
        sf_i, sf_b, rp4, qp4, cn4, lens4, defer, iv_tids, iv_ntid,
        iv_nseg_true, iv_nseg, seg_gene_p, gene_start, gene_end, k=k, P=P,
        SEG_PAD=SEG_PAD).slot_i[0]
    ca, cb, apart, reach_a, reach_b, bi, bj, _ = pair_walks(
        rp4, sf_i[..., df.SF_INT.index("clen")], pcell, k=k)
    n_ch = B * 4 * KB1
    used = torch.zeros(n_ch, dtype=torch.bool, device=rp4.device)
    used[ca], used[cb] = True, True
    valid = (torch.arange(KB1, device=rp4.device)[None, None, :]
             < cn4[:, :, None]).reshape(-1)
    iv = sf_i[..., df.SF_INT.index("iv_l")].reshape(-1)
    n_used = int(used.sum())
    sf_bytes = n_used * (4 * NI + NB) + (n_ch - n_used) * 8 \
        + int((valid & ~used).sum()) * 4
    # the walks' positions (each distinct chain's first to its furthest
    # reach, and its last) and the overlaps' query offsets
    clen = sf_i[..., df.SF_INT.index("clen")].reshape(-1)
    last = (clen - 1).clamp(0, NL - 1)
    reach = torch.zeros(n_ch, dtype=torch.int32, device=rp4.device)
    near = ~apart
    for c, r in ((ca, reach_a), (cb, reach_b)):
        reach.scatter_reduce_(0, c[near], r[near], "amax")
    n_pos = int(((reach + 1 + (last > reach)) * used).sum())
    offs = torch.cat([ca[near] * NL + bi[near].clamp(0, NL - 1),
                      cb[near] * NL + bj[near].clamp(0, NL - 1)])
    n_q = int(torch.unique(offs).numel())
    # the annotation rows of valid chains on intervals, and their genes
    ivs = torch.unique(iv[valid & (iv >= 0)].clamp(0, NIV - 1))
    g = seg_gene_p[ivs.long()]
    named = (torch.arange(SP, device=g.device)[None, :]
             < iv_nseg[ivs.long()][:, None]) & (g >= 0)
    n_gene = int(torch.unique(g[named].clamp(0, NG - 1)).numel())
    anno = ivs.numel() * (4 * ST + 12 + 4 * SP) + n_gene * 8
    KK, S = KB1 * KB1, B * 2 * P
    outs = B * 2 * KK * (3 + 4) + B * 2 * KB1 * 2 + S * (4 * 4 + 5) \
        + B * 2 * 4 + 2 * S * (4 * len(df.MATE_INT) + NB) + B * 4
    return sf_bytes + 4 * (n_pos + n_q) + B * (16 + 16 + 4) + anno + outs


def pair_grid_work(sf_i, sf_b, rp4, qp4, cn4, lens4, defer, iv_tids,
                   iv_ntid, iv_nseg_true, iv_nseg, seg_gene_p, gene_start,
                   gene_end, *, k, P, SEG_PAD):
    """int32 operations ``pair_grid`` needs on these inputs: per cell
    PG_CELL_OPS; per valid cell of two chains on intervals the reference's
    ST^2 tid compares, per valid cell side on an interval its SP segment
    tests; per slot PG_SLOT_OPS and PG_STEP_OPS a step of its merge walk;
    per bundle field PG_FIELD_OPS."""
    import torch
    from circminer_tpu_torch.ops import device_full as df
    B, _, KB1, NL = rp4.shape
    ST, SP = iv_tids.shape[1], seg_gene_p.shape[1]
    kb = torch.arange(KB1, device=rp4.device)
    rows = torch.tensor([[0, 3], [2, 1]], device=rp4.device)  # (fr, vr)
    cn = cn4[:, rows]                                     # [B, 2, 2]
    iv = sf_i[..., df.SF_INT.index("iv_l")][:, rows]      # [B, 2, 2, KB1]
    on = (kb < cn[..., None]) & (iv >= 0)
    ok = (kb < cn[..., None])
    f_on, v_on = on[:, :, 0, :, None], on[:, :, 1, None, :]
    gv = ok[:, :, 0, :, None] & ok[:, :, 1, None, :]
    n_tid = int((gv & f_on & v_on).sum())
    n_gene = int((gv & f_on).sum() + (gv & v_on).sum())
    pcell = df._pair_grid_plain(
        sf_i, sf_b, rp4, qp4, cn4, lens4, defer, iv_tids, iv_ntid,
        iv_nseg_true, iv_nseg, seg_gene_p, gene_start, gene_end, k=k, P=P,
        SEG_PAD=SEG_PAD).slot_i[0]
    steps = pair_walks(rp4, sf_i[..., df.SF_INT.index("clen")], pcell,
                       k=k)[-1]
    S = B * 2 * P
    return (B * 2 * KB1 * KB1 * PG_CELL_OPS + n_tid * ST * ST * PG_TID_OPS
            + n_gene * SP * PG_GENE_OPS + S * PG_SLOT_OPS
            + int(steps.sum()) * PG_STEP_OPS
            + 2 * S * (len(df.MATE_INT) + len(df.SF_BOOL)) * PG_FIELD_OPS)


# floors of the wave kernels' int32 operations: per flag of a compaction
# (its test, count and rank), per compare of a lane's common-tid membership
# (ST x ST a lane) and per word a lane's set-up writes; per (slot, lane)
# the status tests (walk_pool's two pool tests, walk_commit's kind tests);
# per compare of the pools' dedup (a pending slot against each earlier
# pending slot of its lane in its pool) and per window byte; per pending
# (slot, lane) of the commit (the _drop_wrap sums and selects, the event
# and the commit's updates)
WAVE_FLAG_OPS = 4
WAVE_MEMB_OPS = 2
WAVE_TEST_OPS = 4
WAVE_DEDUP_OPS = 4
WAVE_BYTE_OPS = 4
WAVE_COMMIT_OPS = 40


def wave_work(name, args, kw):
    """(bytes, int32 ops) that a wave kernel needs on these inputs: each
    input word that its function reads counted once, each output written
    once (the plain version's outputs give the sizes and the sets that
    depend on the data).  walk_init: the [4N] flags; of each distinct flat
    slot a lane gathers, its five table words; of each distinct pair, its
    two anchors; of each distinct anchor interval, its tid list; of each
    distinct anchor interval of a lane, its end; of each distinct (tstart,
    toff, tlen) a slot takes, three transcript words.  walk_pool: every
    slot's status; the three geometry fields of each slot in a pool (a
    row's leader reads its own again) and of flat S - 1 where dead rows
    gather it; the four lane words of each distinct lane a pool row
    gathers; the window bytes inside each distinct gathered row's
    lengths.  walk_commit: the state; the MID map where the status pends
    a middle or trailing DP, the END map where it pends an end DP; the
    side of each lane that reads an end DP or commits a middle one; of
    each distinct pool row read, its (ed, indel), or its (score, on_s,
    on_t) and need; of each distinct interval a right middle commit
    reads, its start and end; the count, the new count and the event of
    each slot that emits."""
    import torch
    from circminer_tpu_torch.ops import device_walk as dw

    def distinct(x):
        return int(torch.unique(x).numel())

    def out_bytes(tensors):
        return sum(x.numel() * x.element_size() for x in tensors)
    if name == "walk_init":
        act4, aiv4, fiv, riv, iv_tids = (args[0], args[3], args[6],
                                         args[7], args[9])
        N, (NIV, ST) = fiv.shape[0], iv_tids.shape
        out = dw._walk_init_plain(*args, **kw)
        flat = torch.unique(out.inv.long())
        pairs = torch.unique(flat % N)
        ivs = distinct(torch.cat([fiv[pairs], riv[pairs]]).clamp(0, NIV - 1))
        aivs = distinct(aiv4.reshape(-1)[flat].clamp(0, NIV - 1))
        trans = torch.unique(out.slot.reshape(len(dw.SLOT_KEYS), -1),
                             dim=1).shape[1]
        nbytes = act4.numel() + flat.numel() * 5 * 4 \
            + pairs.numel() * 2 * 4 + ivs * ST * 4 + aivs * 4 \
            + trans * 3 * 4 + out_bytes(out)
        ops = act4.numel() * WAVE_FLAG_OPS \
            + int(out.n_act) * ST * ST * WAVE_MEMB_OPS \
            + out.nev.numel() * (len(dw.WS_KEYS) + 10)
        return nbytes, ops
    ws = args[0]
    _, STW_, WPP = ws.shape
    S = STW_ * WPP
    stat = ws[dw.WS_KEYS.index("stat")]
    m_in = (stat == dw.WK_PMID) | (stat == dw.WK_PTRAIL)
    e_in = stat == dw.WK_PEND
    if name == "walk_pool":
        out = dw._walk_pool_plain(*args, **kw)
        W = out.m_win.shape[2]
        inside, flats, dead = 0, [], False
        for rows, n in ((out.m_rows, out.n[0]), (out.e_rows, out.n[1])):
            P = rows.shape[1]
            # the live rows' leaders, and row n once for the dead rows
            keep = torch.arange(P, device=ws.device) <= n
            inside += int((torch.clamp(rows[:2], 0, W) * keep).sum())
            flats.append(rows[2][keep])
            dead |= int(n) < P
        pending = (m_in | e_in).reshape(-1)
        geometry = int(pending.sum()) + int(dead and not bool(pending[-1]))
        lanes = distinct(torch.cat(flats) % WPP)
        nbytes = S * 4 + geometry * 3 * 4 + lanes * 4 * 4 + inside \
            + out_bytes(out)
        earlier = 0
        for m in (m_in.int(), e_in.int()):
            earlier += int(((torch.cumsum(m, 0) - m) * m).sum())
        ops = S * WAVE_TEST_OPS + earlier * WAVE_DEDUP_OPS \
            + (out.m_win.numel() + out.e_win.numel()) * WAVE_BYTE_OPS
        return nbytes, ops
    maps, lane, iv_spos = args[1], args[5], args[6]
    m_map, e_map = maps.unbind(0)
    pendnd = stat == dw.WK_PENDND
    mid = (stat == dw.WK_PMID) & (m_map != dw.MAP_OVER)
    emit = (m_in & (m_map != dw.MAP_OVER)) | (e_in & (e_map != dw.MAP_OVER)) \
        | pendnd
    left = lane[dw.LANE_KEYS.index("is_left")] != 0
    sided = int(((e_in & (e_map >= 0)) | mid).any(0).sum())
    pend_iv = ws[dw.WS_KEYS.index("pend_iv")]
    ivs = distinct(pend_iv[mid & ~left[None, :]].clamp(
        0, iv_spos.shape[0] - 1))
    nbytes = 2 * ws.numel() * 4 + int((m_in | e_in).sum()) * 4 + sided * 4 \
        + distinct(m_map[m_in & (m_map >= 0)]) * 2 * 4 \
        + distinct(e_map[e_in & (e_map >= 0)]) * 4 * 4 + ivs * 2 * 4 \
        + int(emit.sum()) * (dw.EV_NF + 2) * 4
    ops = S * WAVE_TEST_OPS \
        + int((m_in | e_in | pendnd).sum()) * WAVE_COMMIT_OPS
    return nbytes, ops


# floors of the chain ends' int32 operations: per cell of chain_cells (its
# valid bit, the bit lookup, the bounds' sums, minima and selects), per
# bisect step (the load's compare and the halving) and per segment scanned
# (a compare, three selects); per cell of extract_kbest (its event test and
# key), per compare of a comparison sort of a row's M keys, per walked
# fragment (two loads, the back-pointer test), per repeat test of the
# emission (a fragment's length and position compares), per output word
CC_CELL_OPS = 40
CC_BISECT_OPS = 3
CC_SEGMENT_OPS = 4
EX_CELL_OPS = 6
EX_SORT_OPS = 2
EX_FRAGMENT_OPS = 6
EX_REPEAT_OPS = 4


def chain_cells_work(pos, cnt, qpos, seq_len, nb_bits, iv_spos, iv_epos,
                     iv_max_end, iv_min_end, iv_max_next, iv_nseg, seg_end,
                     seg_next, *, seg_pad, k, **_):
    """(bytes, int32 ops) that chain_cells needs on these inputs: each
    cell's position in and six words out (validf a byte), the per-list
    count and query offset, each read length; the bitmap bytes, the
    intervals (six words: the cell's and the next one's start) and the
    segments (of intervals whose k-mer crosses the end) that some cell
    reads, each once; the operations per cell, per bisect step taken
    (counted by running the bisect on these positions) and per segment
    scanned."""
    import torch
    B, NL, S = pos.shape
    n_iv = iv_spos.shape[0]
    p = pos.reshape(-1).long()
    pb = torch.clamp(p, 0, nb_bits.numel() * 8 - 1) >> 3
    lo = torch.zeros_like(p)
    hi = torch.full_like(p, n_iv)
    steps = 0
    while bool((lo < hi).any()):
        act = lo < hi
        steps += int(act.sum())
        mid = (lo + hi) >> 1
        right = iv_spos[torch.clamp(mid, 0, n_iv - 1)].long() <= p
        lo = torch.where(act & right, mid + 1, lo)
        hi = torch.where(act & ~right, mid, hi)
    iv = torch.clamp(lo - 1, min=0)
    ivs = torch.unique(torch.cat([iv, lo[lo < n_iv]]))
    cross = ((p + k - 1) > iv_epos[iv].long())
    nseg = torch.clamp(iv_nseg[iv].long(), 0, seg_pad)
    seg_ivs = torch.unique(iv[cross])
    seg_words = int(torch.clamp(iv_nseg[seg_ivs].long(), 0, seg_pad).sum())
    cells = B * NL * S
    nbytes = cells * (4 + 5 * 4 + 1) + B * NL * 8 + B * 4 \
        + int(torch.unique(pb).numel()) + 6 * 4 * int(ivs.numel()) \
        + 2 * 4 * seg_words
    ops = cells * CC_CELL_OPS + steps * CC_BISECT_OPS \
        + int(nseg[cross].sum()) * CC_SEGMENT_OPS
    return nbytes, ops


def extract_kbest_work(dp10, back, pos, qpos, cnt, *, C, iters, **_):
    """(bytes, int32 ops) that extract_kbest needs on these inputs: each
    row's scores, back pointers, counts and query offsets in (every cell's
    event bit and key), the positions of the cells its walks and its
    fallback read, the outputs out; the operations per cell, a comparison
    sort's M log2 M compares a row (not the kernel's M^2 ranks), per walked
    fragment and per repeat test (counted by running the plain version's
    walks and emission on these inputs), per output word."""
    import math
    import torch
    from circminer_tpu_torch.ops.device_finish import \
        extract_kbest_device_staged
    R, NL, S = dp10.shape
    M = NL * S
    kw = dict(k=0, C=C, iters=iters)
    sidx, nv = extract_kbest_device_staged(dp10, back, pos, qpos, cnt,
                                           upto="sort", **kw)
    cn, emitted = extract_kbest_device_staged(dp10, back, pos, qpos, cnt,
                                              upto="emit", **kw)
    T = min(iters, M)
    live = torch.arange(T, device=dp10.device)[None, :] < nv[:, None]
    cur = sidx[:, :T].long()
    bk = back.reshape(R, M).long()
    act = live.clone()
    frags = 0
    lens = torch.zeros((R, T), dtype=torch.long, device=dp10.device)
    for _ in range(NL):
        frags += int(act.sum())
        lens += act
        nxt = torch.gather(bk, 1, cur)
        act = act & (nxt >= 0)
        cur = torch.where(act, nxt, cur)
    # a pick below the row's best score, taken while fewer than C were
    # emitted, tests the non-head fragments of the picks emitted before it
    dpf = dp10.reshape(R, M)
    l_of = torch.arange(M, device=dp10.device) // S
    ev = (torch.arange(M, device=dp10.device) % S < cnt[:, l_of]) & (bk >= 0)
    best = torch.where(ev, dpf, -2 ** 29).amax(dim=1, keepdim=True)
    below = torch.gather(dpf, 1, sidx[:, :T].long()) < best
    frag = torch.where(emitted[:, :T], lens - 1, 0)
    n_before = torch.cumsum(emitted[:, :T].long(), dim=1) \
        - emitted[:, :T].long()
    tested = live & below & (n_before < C)
    tests = int(torch.where(tested, torch.cumsum(frag, dim=1) - frag,
                            0).sum())
    fallback = int((cn == 0).sum())
    out_words = R * (2 * C * NL + 2 * C + 1)
    nbytes = R * M * 8 + R * NL * 8 + 4 * frags + 8 * C * fallback \
        + 4 * out_words + R
    ops = R * M * EX_CELL_OPS \
        + R * M * max(1, math.ceil(math.log2(M))) * EX_SORT_OPS \
        + frags * EX_FRAGMENT_OPS + tests * EX_REPEAT_OPS + out_words
    return nbytes, ops


def extract_paths(dp10, back, pos, qpos, cnt, *, C, iters, **_):
    """What the extraction's inputs ask of its kernel: rows by event count
    (n_valid) and by rank path (among the events alone, where every event
    key is below the other cells' 2^29, else among every cell), and
    whether a row's back pointers and positions fit the block's shared
    memory beside its words (walks from shared or device memory)."""
    import torch
    from circminer_tpu_torch.ops import device_finish as fin
    R, NL, S = dp10.shape
    M = NL * S
    dev = dp10.device
    l_of = torch.arange(NL, device=dev).repeat_interleave(S)
    s_of = torch.arange(S, dtype=torch.int32, device=dev).repeat(NL)
    ev = (s_of[None, :] < cnt[:, l_of]) & (back.reshape(R, M) >= 0)
    late = (ev & (-dp10.reshape(R, M) >= 2 ** 29)).any(1)
    nv = ev.sum(1)
    hist = torch.bincount(nv, minlength=1).tolist()
    words = fin.extract_row_bytes(NL, S, C, iters) + 8 * M
    return dict(n_valid={n: c for n, c in enumerate(hist) if c},
                rows_ranked_among_events=int((~late).sum()),
                rows_ranked_among_every_cell=int(late.sum()),
                more_than_32_events=int((nv > 32).sum()),
                walks_staged=words <= fin.EX_SMEM_MAX)


def tensor_kernel_bound(name, args, kw):
    """(bound ms, what sets it, int32 ops): the bytes these inputs need,
    each read once and each output written once, over HBM bandwidth,
    against the operations over the ALU peak.  The fold reads one
    orientation's half of the pairs."""
    if name == "chain_dp":
        nbytes = chain_dp_bytes(*args, **kw)
        ops = chain_dp_work(*args, **kw)
    elif name == "chain_cells":
        nbytes, ops = chain_cells_work(*args, **kw)
    elif name == "extract_kbest":
        nbytes, ops = extract_kbest_work(*args, **kw)
    elif name in WALK_KERNELS:
        nbytes, ops = walk_work(name, args, kw)
    elif name in WAVE_KERNELS:
        nbytes, ops = wave_work(name, args, kw)
    elif name in EXTEND_KERNELS:
        nbytes, ops = extend_work(name, args, kw)
    elif name == "pair_grid":
        nbytes, ops = pair_grid_bytes(*args, **kw), pair_grid_work(*args,
                                                                    **kw)
    else:
        mr, pairs = args[0], args[1]
        B, _, P, F = pairs.shape
        nbytes = B * (20 * 4 + P * F * 4 + 4 + P * 4 * 4 + 2 + 20 * 4 + 6 * 4)
        ops = B * P * FOLD_STEP_OPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", ops)


def recording_tensor_kernels(store):
    """Wrap the wrappers of the ``launch_tensors`` kernels (chain_cells,
    chain_dp, extract_kbest_device, mr_pair_fold, walk_fold_lanes, tiny_dp,
    walk_scan, walk_init, walk_pool, walk_commit, extend_core,
    extend_leftover, pair_grid) where the step calls them, so that the
    first inputs of each (kernel, rows) are kept in ``store`` and every
    call is counted there; returns the function that undoes it.  A
    walk_fold's and walk_init's rows are its pool lanes, walk_scan's and
    walk_commit's its (slot, lane) pairs, walk_pool's its two pools' rows,
    the extend kernels' their slots (extend_leftover's chains), pair_grid's
    its reads."""
    from circminer_tpu_torch.ops import chain_device as cd
    from circminer_tpu_torch.ops import device_finish as fin
    from circminer_tpu_torch.ops import device_full as df
    from circminer_tpu_torch.ops import device_walk as dw
    sites = [("chain_cells", cd, "chain_cells"),
             ("extract_kbest", fin, "extract_kbest_device"),
             ("chain_dp", cd, "chain_dp"),
             ("mr_pair_fold", df, "mr_pair_fold"),
             ("walk_fold", dw, "walk_fold_lanes"), ("tiny_dp", dw, "tiny_dp"),
             ("tiny_dp", df, "tiny_dp"), ("walk_scan", dw, "walk_scan"),
             ("walk_init", dw, "walk_init"), ("walk_pool", dw, "walk_pool"),
             ("walk_commit", dw, "walk_commit"),
             ("extend_core", df, "extend_core"),
             ("extend_leftover", df, "extend_leftover"),
             ("pair_grid", df, "pair_grid")]
    saved = [(mod, attr, getattr(mod, attr)) for _, mod, attr in sites]

    def rows(name, args, kw):
        if name in EXTEND_KERNELS:
            return args[{"extend_core": 0, "extend_leftover": 2}[name]].numel()
        if name == "walk_fold":
            return args[1].shape[1]
        if name in ("walk_scan", "walk_commit"):
            return args[0].shape[1] * args[0].shape[2]
        if name == "walk_init":
            return kw["WPP"]
        if name == "walk_pool":
            return kw["MIDP"] + kw["ENDP"]
        return args[0].shape[0]

    def wrap(name, fn):
        def rec(*args, **kw):
            key = (name, rows(name, args, kw))
            if key not in store:
                store[key] = dict(args=[a.clone() for a in args],
                                  kw=dict(kw), count=0)
            store[key]["count"] += 1
            return fn(*args, **kw)
        return rec
    for (name, mod, attr), (_, _, fn) in zip(sites, saved):
        setattr(mod, attr, wrap(name, fn))

    def undo():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return undo


# csrc/walk.cu's WalkKernel: the kernel whose grid cm_walk_empty takes
WALK_EMPTY = {"walk_fold": 0, "tiny_dp": 1, "walk_scan": 2}
# csrc/walk_wave.cu's WaveKernel: the entry point whose grids cm_wave_empty
# takes
WAVE_EMPTY = {"walk_init": 0, "walk_pool": 1, "walk_commit": 2}
# the device record that times a wave kernel, and whether its other
# records count too
WAVE_TIMED = {"walk_init": ("walk_init_kernel", False),
              "walk_pool": ("walk_pool_kernel", False),
              "walk_commit": ("walk_commit_kernel", False)}


def wave_floor_ms(name, args, kw, iters=50):
    """Device ms of an empty kernel launched on the grid (blocks,
    clusters, threads, dynamic shared memory) that the wave kernel
    ``name`` takes for these inputs (csrc/walk_wave.cu::cm_wave_empty):
    the launch's share of that kernel's time."""
    import ctypes
    import torch
    from circminer_tpu_torch.ops import _ext
    fn = _ext._load().cm_wave_empty
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if name == "walk_init":          # (STW, WPP, N, MIDP, ENDP, W)
        shapes = (0, kw["WPP"], args[6].shape[0], 0, 0, 0)
    elif name == "walk_pool":
        shapes = (args[0].shape[1], args[0].shape[2], 0, kw["MIDP"],
                  kw["ENDP"], kw.get("I", 128) - 1)
    else:
        shapes = (args[0].shape[1], args[0].shape[2], 0, 0, 0, 0)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        check(fn(WAVE_EMPTY[name], *shapes, stream) == 1,
              f"the empty kernel on {name}'s grid failed to launch")
    return device_ms(call, "wave_empty_kernel", iters)


def walk_floor_ms(name, args, kw, iters=50):
    """Device ms of an empty kernel launched on the grid that the walk
    kernel ``name`` takes for these inputs (csrc/walk.cu::cm_walk_empty):
    the launch's share of that kernel's time."""
    import ctypes
    import torch
    from circminer_tpu_torch.ops import _ext
    fn = _ext._load().cm_walk_empty
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if name == "walk_fold":
        rows, NM, MM = args[1].shape[1], 0, 0
    elif name == "tiny_dp":
        rows, NM, MM = args[0].shape[0], kw["NM"], kw["MM"]
    else:
        rows, NM, MM = args[0].shape[1] * args[0].shape[2], 0, 0
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        check(fn(WALK_EMPTY[name], rows, NM, MM, stream) == 0,
              f"the empty kernel on {name}'s grid failed to launch")
    return device_ms(call, "walk_empty_kernel", iters)


def walk_shares(name, args):
    """What the walk kernels' recorded inputs ask of them: tiny_dp's rows
    that fall back to the DP; the fold's live lanes per family (all four
    share one pool), whether each family's lanes are one contiguous run
    of pool rows, and the share of active transcripts of its lanes."""
    import torch
    if name == "tiny_dp":
        tiny = args[4]
        return dict(fallback_rows=int(tiny.sum()),
                    fallback_share=float(tiny.float().mean()))
    if name != "walk_fold":
        return {}
    events, act, inv, n_act, p_live = args[:5]
    N = args[8].shape[0]
    live = (torch.arange(inv.shape[0], device=inv.device) < n_act) & p_live
    fam = torch.where(live, inv // N, -1)
    lanes, runs, act_share = [], [], []
    for f in range(4):
        rows = (fam == f).nonzero()[:, 0]
        lanes.append(int(rows.numel()))
        runs.append(bool(rows.numel() == 0
                         or int(rows[-1] - rows[0]) + 1 == rows.numel()))
        act_share.append(float(act[:, rows].float().mean())
                         if rows.numel() else 0.0)
    return dict(pool_rows=inv.shape[0], family_lanes=lanes,
                family_contiguous=runs, family_active_share=act_share)


def time_tensor_kernels(store, where, iters=50):
    """Per (kernel, rows) of ``store`` (``recording_tensor_kernels``): its
    calls ``where``, bit-equality with the plain version on the recorded
    inputs, its device ms per launch (profiler), the plain version's ms
    (CUDA events) and its bound; for the walk's kernels the launch floor
    of their grid and what their inputs ask of them (``walk_shares``); for
    the wave kernels the floor of their grid (``wave_floor_ms``) and their
    device ms by kernel (``device_split``)."""
    res = {}
    for (name, rows), rec in sorted(store.items()):
        args, kw = rec["args"], rec["kw"]
        kern, plain = tensor_kernel_calls(name, args, kw)
        err = hold_outputs(name, kern, plain, f" ({where}, {rows} rows)")
        bound_ms, bound_by, ops = tensor_kernel_bound(name, args, kw)
        timed, rest = WAVE_TIMED.get(name, (f"{name}_kernel", False))
        r = dict(rows=rows, launches=rec["count"], max_abs_err=err,
                 ms=device_ms(kern, timed, iters, rest=rest),
                 plain_ms=cuda_ms(plain, 3), bound_ms=bound_ms,
                 bound_by=bound_by, ops=ops)
        if name in WAVE_KERNELS:
            r.update(floor_ms=wave_floor_ms(name, args, kw),
                     split=device_split(kern))
            log(f"[main-shapes] {name}'s device ms by kernel at {rows} "
                f"rows: {r['split']}")
        if name in WALK_KERNELS:
            shares = walk_shares(name, args)
            r.update(floor_ms=walk_floor_ms(name, args, kw), **shares)
            if shares:
                log(f"[main-shapes] {name}'s inputs at {rows} rows: "
                    f"{shares}")
        if name == "extract_kbest":
            log(f"[main-shapes] extract_kbest's inputs at {rows} rows: "
                f"{extract_paths(*args, **kw)}")
        res.setdefault(name, []).append(r)
        log(f"[main-shapes] {name} x{rec['count']} {where} at {rows} rows "
            f"({kw}): bit-equal to plain; "
            f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.3f} ms; bound "
            f"{bound_ms:.6f} ms ({bound_by}, {ops} int32 ops)")
    floors = {f"{name} at {r['rows']}": (r["ms"], r["floor_ms"])
              for name in (*WALK_KERNELS, *WAVE_KERNELS)
              for r in res.get(name, ())}
    log(f"[launch-floor] {where}, ms per launch of each walk kernel beside "
        f"an empty kernel on its grid (kernel, empty): {floors}")
    return res


def recording_inputs(store):
    """Wrap ``_ext.launch`` so that the first input of each (kernel, rows)
    shape is kept in ``store`` with its statics and every launch is counted
    there too; returns the function that undoes it."""
    from circminer_tpu_torch.ops import _ext
    launch = _ext.launch

    def record(name, s, t, n, m, wv, ncols, I, statics):
        key = (name, s.shape[0])
        if key not in store:
            store[key] = dict(args=[x.clone() for x in (s, t, n, m)] + [
                None if wv is None else wv.clone()], statics=statics,
                count=0)
        store[key]["count"] += 1
        return launch(name, s, t, n, m, wv, ncols, I, statics)
    _ext.launch = record

    def undo():
        _ext.launch = launch
    return undo


def time_recorded(store, where):
    """Per (kernel, rows) of ``store`` (``recording_inputs``): its launches
    ``where``, bit-equality with the plain version on the recorded inputs,
    and its time, bound and chain floor there."""
    from circminer_tpu_torch.ops.align import ScoreMat
    sm = ScoreMat()
    res = {}
    for (name, rows), rec in sorted(store.items()):
        s, t, n, m, wv = rec["args"]
        st = rec["statics"]
        if name == "xdrop":
            w, me, ms_ = st[0], 0, 0
            sm = ScoreMat(*st[1:])    # (w, mat, mis, ind, xd)
        elif name == "one_side":
            w, me, ms_ = st[0], 0, 0
        else:
            w, me = st[0], st[1]
            ms_ = st[2] if name == "edit_sc" else 0
        kern, plain, ncols = kernel_cases(s, t, n, m, wv, w, me, ms_,
                                          sm)[name]
        hold_to_plain(name, kern, plain, n, m, f" ({where}, {rows} rows)")
        host = [None if x is None else x.cpu().numpy() for x in rec["args"]]
        r = dict(rows=rows, launches=rec["count"],
                 active_rows=int(((n > 0) & (m > 0)).sum()),
                 **measure(name, kern, plain, ncols, host, w, sm))
        res.setdefault(name, []).append(r)
        log(f"[main-shapes] {name} x{rec['count']} {where} at {rows} rows "
            f"({r['active_rows']} with n, m > 0): bit-equal to plain; "
            f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.3f} ms; bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}), chain floor "
            f"{r['chain_floor_ms']:.4f} ms over {r['diagonals']} diagonals")
    return res


def phase_main_shapes(pipe, reads, cfg, batch):
    """One more 4,096-pair step of the gpu-full map, run eagerly, with the
    kernels' inputs recorded, each timed there (``time_recorded``)."""
    import torch
    store, store2 = {}, {}
    undo = recording_inputs(store)
    undo2 = recording_tensor_kernels(store2)
    pipe.step_graph = False       # a replay calls no wrapper
    try:
        pipe.map_stream(iter(make_pairs(reads[:batch], cfg)))
        torch.cuda.synchronize()
    finally:
        pipe.step_graph = True
        undo()
        undo2()
    where = f"per {batch}-pair step"
    return time_recorded(store, where), time_tensor_kernels(store2, where)


def phase_seg_compact(full, reads, cfg, device, batch=4096):
    """Phase 15: one chr21 step of phase 6's pipeline in both forms of the
    chain prelude (seg_compact False / True): bit-equal blobs; per form the
    ms per step (CUDA events, 3 steps after a warm-up), the peak device
    memory of one step, and in one profiled run of the step's chain prefix
    (bisect_device_full's "chain" stage: lookup, gather and chain DP on the
    step's inputs; a profiled whole step costs ~25 s of the profiler's own
    host time) the one chain_cells launch that both forms take on the card
    and its device ms (the cm.* spans leave out the ctypes-launched
    kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from circminer_tpu_torch.ops import _ext
    from circminer_tpu_torch.tools.bisect_device_full import stage_functions
    pipe = full["pipe"]
    st = pipe.states[0]
    args = full_step_args(pipe, make_pairs(reads[:batch], cfg), device,
                          batch)
    blobs, forms = {}, {}
    for flag in (False, True):
        statics = {**pipe._full_statics(), "seg_compact": flag}

        def step():
            return run_full_step(pipe, st, args, statics)
        chain = stage_functions(cfg, pipe, statics)["chain"]
        ms = cuda_ms(step, 3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
        blobs[flag] = step().cpu()
        peak = torch.cuda.max_memory_allocated(device)
        _ext.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(512):      # the tracer's lost first records
                torch.cuda._sleep(1)
            chain(*args)
            torch.cuda.synchronize()
        cells = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                 and "chain_cells_kernel" in e.name]
        prelude = sum(e.time_range.elapsed_us() for e in cells) / 1e3
        check(_ext.LAUNCHES["chain_cells"] == 1 and len(cells) == 1,
              f"seg_compact={flag}: the chain prefix launched chain_cells "
              f"{_ext.LAUNCHES['chain_cells']} times ({len(cells)} traced), "
              f"not once")
        forms[flag] = dict(ms=ms, peak_gb=peak / 1e9,
                           step_gb=(peak - before) / 1e9,
                           prelude_ms=prelude)
        log(f"[seg-compact] seg_compact={flag}: {ms:.1f} ms per {batch}-pair "
            f"step (CUDA events, 3 steps after a warm-up), peak device "
            f"memory {peak / 1e9:.3f} GB ({(peak - before) / 1e9:.3f} GB "
            f"above the resident tables); the chain prefix's prelude is one "
            f"chain_cells launch, {prelude:.4f} ms of device time")
    bad = (blobs[False] != blobs[True]).any(dim=1).nonzero()[:, 0]
    check(len(bad) == 0, f"seg_compact=True differs from False on "
          f"{len(bad)} of {batch} chr21 rows, first {bad[:3].tolist()}")
    log(f"[seg-compact] both forms bit-equal on {batch} chr21 pairs")
    return forms


def count_aten_ops(fn):
    """(fn(), the number of aten ops it dispatched)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))
    mode = Count()
    mode.n = 0
    with mode:
        out = fn()
    return out, mode.n


def phase_graph(full, reads, cfg, device, batch=4096):
    """Phase 16: the fused step as one CUDA graph (ops/step_graph.py) on
    chr21 batches of phase 6's pipeline: an eager step under the sync
    debug mode "error", a capture on batch 0, four replays on other
    batches bit-equal to the eager step, graph against eager ms, memory,
    and the device-busy share of one profiled graph-mode map."""
    import torch
    from circminer_tpu_torch.ops import _ext
    from circminer_tpu_torch.ops.step_graph import StepGraph, step_key
    pipe = full["pipe"]
    st = pipe.states[0]
    statics = pipe._full_statics()
    spans = [(0, batch), (batch, 2 * batch), (2 * batch, 3 * batch),
             (3 * batch, 4 * batch), (batch, batch + 1000)]
    host = [full_step_host(pipe, make_pairs(reads[a:b], cfg), batch)
            for a, b in spans]

    def step(*args):
        return run_full_step(pipe, st, args, statics)

    def eager(arrays):
        return step(*(torch.from_numpy(a).to(device) for a in arrays))
    first = [torch.from_numpy(a).to(device) for a in host[0]]
    torch.cuda.synchronize()
    _ext.reset_launches()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, n_ops = count_aten_ops(lambda: step(*first))
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    per_step = dict(_ext.LAUNCHES)
    log(f"[graph] one eager {batch}-pair step under "
        f"set_sync_debug_mode('error'): no synchronising op; {n_ops} aten "
        f"ops; launches {per_step}")
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    graph = StepGraph(device)
    graph.capture(step_key(0, st, host[0][0].shape, statics), step,
                  *host[0])
    check(graph.launches == per_step, f"the capture recorded launches "
          f"{graph.launches}, one eager step launched {per_step}")
    peak = torch.cuda.max_memory_allocated(device)
    for i, arrays in enumerate(host[1:], 1):
        graph.load(*arrays)
        got = graph.replay().cpu()
        want = eager(arrays).cpu()
        bad = (got != want).any(dim=1).nonzero()[:, 0]
        check(len(bad) == 0, f"replay on batch {i} differs from the eager "
              f"step on {len(bad)} rows, first {bad[:3].tolist()}")
    rows, NL = 4 * batch, (cfg.max_read_len + cfg.kmer - 1) // cfg.kmer
    cap, P = statics["cap"], st.anno.seg_pad
    tables = rows * NL * cap * P * (4 + 4 + 1)
    log(f"[graph] capture on batch 0: {graph.capture_s:.3f} s recording, "
        f"{graph.instantiate_s:.3f} s ending and instantiating; private "
        f"pool {graph.pool_bytes} B (the [b, M, P] junction tables that the "
        f"chain DP reads by interval instead would take {tables} B at "
        f"b = {rows}, M = {NL} x {cap}, P = {P}); four "
        f"replays on batches 1-4 (the last "
        f"{spans[-1][1] - spans[-1][0]} pairs, padded) bit-equal to the "
        f"eager step; peak device memory of the capture {peak / 1e9:.3f} "
        f"GB ({(peak - before) / 1e9:.3f} GB above the tables)")
    last = [torch.from_numpy(a).to(device) for a in host[-1]]
    ms = {}
    for tag in ("graph", "eager", "eager", "graph"):
        fn = graph.replay if tag == "graph" else (lambda: step(*last))
        ms.setdefault(tag, []).append(cuda_ms(fn, 10 if tag == "graph"
                                              else 3))
    log(f"[graph] ms per {batch}-pair step (CUDA events; in turns graph, "
        f"eager, eager, graph): graph {ms['graph']}, eager {ms['eager']}")
    graph.drop()
    r0 = pipe.full_graph.replays
    wall, busy, _, kern, n_dev, hand = profile_map(pipe, reads, cfg)
    n_rep = pipe.full_graph.replays - r0
    log(f"[graph] profiled graph-mode map of {len(reads)} pairs: wall "
        f"{wall:.3f} s, device busy {busy:.4f} s "
        f"({100.0 * busy / wall:.2f}%); {n_dev} device ops over {n_rep} "
        f"replays and the host replay's copies ({n_dev / n_rep:.0f} per "
        f"replay); device records of the hand kernels {hand}")
    missing = [name for name, n in hand.items() if n == 0]
    check(not missing, f"the profiled replays show no device record of "
          f"{missing}")
    for name, t in kern:
        log(f"[graph]   kernel {name[:70]}: device {t:.2f} ms")
    return dict(ms=ms, capture_s=graph.capture_s,
                instantiate_s=graph.instantiate_s,
                pool_bytes=graph.pool_bytes, peak_gb=peak / 1e9,
                busy=busy, wall=wall, n_ops=n_ops, dev_ops=n_dev / n_rep)


def c_params(src):
    """{C symbol: its parameter names, in order} of the cm_* kernel entry
    points that a kernel source defines: each source's own signature (an
    older source may take other arguments than ``_ext.KERNELS`` says)."""
    import re
    with open(src) as f:
        text = f.read()
    return {m.group(1): [q.split()[-1].lstrip("*")
                         for q in m.group(2).split(",")]
            for m in re.finditer(r"\bint (cm_\w+)\(([^)]*)\)", text)}


# the --ab cases: the DP kernels' rows at band w = 3, chain_dp's (S, NL,
# rows) at P = 16 (chr21's main shape on adversarial inputs and
# gpu-chain's two wide buckets; then one chr21 step's recorded inputs),
# the fold's (reads, P_MAX), the walk kernels' WALK_SWEEP specs and the
# chain ends' END_SWEEP specs (chr21's main shape, chain_cells also at
# gpu-chain's widest bucket; each then one chr21 step's recorded inputs);
# each with its iterations per timing
AB_ROWS = (1024, 4096, 8192, 512)
AB_CHAIN = ((16, 6, 16384), (128, 15, 2048), (500, 15, 128))
AB_FOLD = ((4096, 8),)
AB_END = {"chain_cells": ((16384, 6, 16, dict(n_iv=2000, P=16)),
                          (128, 15, 500, dict(n_iv=500, P=16))),
          "extract_kbest": ((16384, 6, 16, 48, 7),)}
AB_WALK = {"walk_fold": ((4096, 8, 6144, 0, True),),
           "tiny_dp": tuple((B, 3, end, share) for B, end in (
               (512, True), (4096, False)) for share in (0.0, 0.5, 1.0)),
           "walk_scan": ((8, 6144, 12),),
           "walk_init": ((65536, 6144, 0.02, 16, 0),),
           "walk_pool": ((8, 6144, 512, 1024, 3),),
           "walk_commit": ((8, 6144, 512, 1024, 4, 3),)}
# the outputs of each wave kernel, and those it updates in place
WAVE_OUTS = {"walk_init": ("inv", "n_act", "over", "act", "p_live",
                           "over_tid", "ws", "slot", "lane", "prow",
                           "events", "nev"),
             "walk_pool": ("m_win", "m_rows", "m_tiny", "e_win", "e_rows",
                           "n", "maps"),
             "walk_commit": ("events", "nev", "ws_out")}
IN_PLACE = ("events", "nev")
AB_EXTEND = {"extend_core": ((4096, 8, 0, True, 0.05),),
             "extend_leftover": ((4096, 7, 6),)}
AB_PAIR = {"pair_grid": ((4096, 7, 6, 8, {}),)}
# the outputs of each extend kernel and of pair_grid
EXTEND_OUTS = {"extend_core": ("ok", "pos_out", "best", "defer"),
               "extend_leftover": ("ok", "pos", "best"),
               "pair_grid": ("grid_b", "tlen_g", "valid", "slot_i", "slot_b",
                             "n_union", "mate_i", "mate_b", "defer_out")}
AB_ITERS = {"chain_dp": 20, "mr_pair_fold": 50, "chain_cells": 50,
            "extract_kbest": 50}


def ab_cases(names, w=3, seed=19):
    """(kernel, tag, {parameter name: tensor or int}, output names, the
    plain version's outputs) for the kernels in ``names``, on the card.
    chain_dp's values hold both interfaces: the cells' intervals with the
    annotation's tables, and the [b, M, P] tables (sep, snp, pv) that an
    older source takes."""
    import numpy as np
    import torch
    from circminer_tpu_torch.ops import _ext
    from circminer_tpu_torch.ops import chain_device as cd
    from circminer_tpu_torch.ops import device_full as df
    from circminer_tpu_torch.ops.align import ScoreMat
    sm = ScoreMat()
    statics = dict(w=w, mat=sm.mat, mis=sm.mis, ind=sm.ind, xd=sm.xd,
                   max_ed=4, max_sc=7)
    if set(names) & set(_ext.DP_KERNELS):
        for B in AB_ROWS:
            host = kernel_inputs(np.random.default_rng(B), B, w)
            s, t, n, m, wv = (torch.from_numpy(a).cuda() for a in host)
            cases = kernel_cases(s, t, n, m, wv, w, 4, 7, sm)
            for name in _ext.DP_KERNELS:
                if name in names:
                    yield (name, f"B={B} w={w}",
                           dict(statics, s=s, t=t, n=n, m=m, wv=wv, B=B,
                                L=s.shape[1]),
                           ("out",), (as_matrix(cases[name][1]()),))

    def chain_case(tag, args, kw):
        P = args[8].shape[1]
        tabs = [x.permute(2, 0, 1).contiguous()
                for x in cd._junction_tables(*args[6:], P)]
        vals = dict(zip(_ext.KERNELS["chain_dp"].tensors, args),
                    sep=tabs[0], snp=tabs[1], pv=tabs[2],
                    b=args[0].shape[0], P=P, **kw)
        return ("chain_dp", tag, vals, ("dp", "back"),
                cd._chain_dp_plain(*args, **kw))
    if "chain_dp" in names:
        for S, NL, b in AB_CHAIN:
            arrs, kw = chain_dp_inputs(np.random.default_rng(seed + S), b,
                                       NL, S, 16)
            yield chain_case(f"S={S} NL={NL} b={b}",
                             [torch.from_numpy(a).cuda() for a in arrs], kw)
        [rec] = chr21_step_inputs("chain_dp")
        yield chain_case(f"chr21 step, b={rec['args'][0].shape[0]}",
                         rec["args"], rec["kw"])
    for name in (*WALK_KERNELS, *WAVE_KERNELS, *END_KERNELS, *AB_EXTEND,
                 *AB_PAIR):
        if name not in names:
            continue
        spec = _ext.KERNELS[name]
        case_of, specs = ((end_case, AB_END[name]) if name in END_KERNELS
                          else (extend_case, AB_EXTEND[name])
                          if name in AB_EXTEND
                          else (pair_case, AB_PAIR[name]) if name in AB_PAIR
                          else (walk_case, AB_WALK[name]))
        cases = [(str(case), *case_of(name, case, torch.device("cuda"),
                                      seed + k))
                 for k, case in enumerate(specs)]
        cases += [(f"chr21 step, {rec['rows']} rows", rec["args"],
                   rec["kw"]) for rec in chr21_step_inputs(name)]
        # the outputs: a walk kernel's one, a wave kernel's (walk_commit's
        # events and counts in place, then its state), the chain ends' six
        # (chain_cells' posf is its input)
        out_names = WAVE_OUTS.get(name) or EXTEND_OUTS.get(name) or \
            spec.tensors[-(1 if name in WALK_KERNELS else 6):]
        for tag, args, kw in cases:
            yield (name, tag, *ab_values(name, args, kw, out_names))
    if "mr_pair_fold" in names:
        for B, P in AB_FOLD:
            arrs, kw = fold_inputs(np.random.default_rng(seed), B, P)
            args = [torch.from_numpy(a).cuda() for a in arrs]
            kw = dict(kw, scan_level=0)
            yield ("mr_pair_fold", f"B={B} P={P}",
                   dict(zip(_ext.KERNELS["mr_pair_fold"].tensors, args),
                        B=B, P=P, **kw),
                   ("mr_out", "aux"), df._mr_pair_fold_plain(*args, **kw))


def ab_values(name, args, kw, out_names):
    """({parameter name: tensor or int} of the wrapper's own launch of
    ``launch_tensors`` kernel ``name`` on these arguments, ``out_names``,
    the plain version's outputs of those names)."""
    import torch
    from circminer_tpu_torch.ops import _ext
    spec = _ext.KERNELS[name]
    kern, plain = tensor_kernel_calls(name, args, kw)
    got = launch_record(kern)
    vals = dict(zip(spec.tensors, got["args"]),
                **dict(zip(spec.statics, got["statics"])))
    if name == "walk_commit":         # the counts and events it was given
        vals.update(events=args[8], nev=args[9])
    want = plain()
    return vals, out_names, want[-len(out_names):]


def ab_buffers(name, vals, outs):
    """The buffers, by parameter name, that ``phase_ab`` hands a source's
    kernel ``name``: ``vals`` (``ab_values``) with the fresh outputs
    ``outs`` in place of the wrapper's.  A ctypes call checks no buffer,
    so each output must have the shape and dtype of the wrapper's buffer
    of its name, or SmokeFailure (an output paired with another's name,
    or sized for other shapes, would run the kernel past its buffers)."""
    import torch
    for o, x in outs.items():
        ref = vals.get(o)
        if torch.is_tensor(ref):
            check(x.shape == ref.shape and x.dtype == ref.dtype,
                  f"{name}: the output {o} given to the source is {x.dtype} "
                  f"{tuple(x.shape)}, its wrapper's {ref.dtype} "
                  f"{tuple(ref.shape)}")
    return dict(vals, **outs)


def launch_record(call):
    """{"args": tensors, "statics": ints} that a wrapper hands
    ``_ext.launch_tensors`` in ``call()`` (the kernel runs as well)."""
    from circminer_tpu_torch.ops import _ext
    got, launch = {}, _ext.launch_tensors

    def rec(name, args, statics):
        got.update(args=[x for x, _, _ in args], statics=statics)
        return launch(name, args, statics)
    _ext.launch_tensors = rec
    try:
        call()
    finally:
        _ext.launch_tensors = launch
    return got


_CHR21_STEP = {}


def chr21_step_inputs(name):
    """The inputs of the ``launch_tensors`` kernel ``name`` in one eager
    chr21 gpu-full step of 4,096 pairs (the main path's), one record
    {"args", "kw", "count", "rows"} per row count; the step runs once per
    process."""
    import torch
    from circminer_tpu_torch.pipeline.device_pipeline import (
        DeviceMappingPipeline)
    if not _CHR21_STEP:
        cfg, gi, db, reads, _ = chr21_setup()
        pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=4096,
                                     chain_exec="device-full",
                                     extend_exec="native",
                                     device=torch.device("cuda"))
        pipe.warmup()
        pipe.step_graph = False
        undo = recording_tensor_kernels(_CHR21_STEP)
        try:
            pipe.map_stream(iter(make_pairs(reads[:4096], cfg)))
            torch.cuda.synchronize()
        finally:
            undo()
    return [dict(rec, rows=rows)
            for (n, rows), rec in sorted(_CHR21_STEP.items()) if n == name]


def selecting_tiny_dp(fn, args, tiny, banded, out):
    """One call of a ``tiny_dp`` source from before the kernel took the
    pool's fallback mask: its kernel answers every row into ``out``, then
    the pool's torch.where keeps the fallback rows (END: one on each of the
    unbound (ed, indel) columns).  Returns the call, which returns the
    selected columns."""
    import torch

    def call():
        fn(*args)
        if out.dim() == 1:
            return (torch.where(tiny, out, banded),)
        return tuple(torch.where(tiny, a, b)
                     for a, b in zip(out.unbind(1), banded.unbind(1)))
    return call


def phase_ab(sources):
    """``python3 chip_smoke.py --ab A.cu B.cu ...``: the kernels of several
    versions of the CUDA sources on one card, each source built alone with
    the port's nvcc flags.  Per case of ``ab_cases`` the sources that
    define its kernel are held bit-equal to the plain version and timed
    by the profiler's device events in turns (A B ... then ... B A), each
    called with its own parameters, laid out by name (a ``tiny_dp``
    source without the fallback mask is timed with the pool's select that
    it needs, ``selecting_tiny_dp``).  Returns {source:
    {kernel: {case: mean ms of the two turns}}}."""
    import ctypes
    import torch
    from circminer_tpu_torch.ops import _ext
    flags = [f for f in _ext.NVCC_FLAGS if f not in ("-Xptxas", "-v")] + [
        "-shared"]
    out_dir = os.path.join(HERE, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for k, src in enumerate(sources):
        so = os.path.join(out_dir, f"lib{k}_{os.path.basename(src)}.so")
        procs.append((src, so, subprocess.Popen(
            [_ext._nvcc(), *flags, "-o", so, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    libs, params = {}, {}
    for src, so, proc in procs:          # the builds run side by side
        _, err = proc.communicate()
        check(proc.returncode == 0, f"nvcc {src} failed:\n{err[-3000:]}")
        libs[src], params[src] = ctypes.CDLL(so), c_params(src)
    syms = {spec.sym: name for name, spec in _ext.KERNELS.items()}
    names = {syms[sym] for src in sources for sym in params[src]
             if sym in syms}
    stream = torch.cuda.current_stream().cuda_stream
    times = {src: {} for src in sources}
    for name, tag, vals, out_names, want in ab_cases(names):
        sym = _ext.KERNELS[name].sym
        have = [src for src in sources if sym in params[src]]
        for turn in (have, have[::-1]):
            for src in turn:
                # walk_fold writes its slots; walk_commit updates the
                # events and counts it is given
                outs = {o: vals[o].clone()
                        if name == "walk_commit" and o in IN_PLACE else
                        torch.zeros_like(x) for o, x in zip(out_names, want)}
                got = ab_buffers(name, vals, outs)
                args = [ctypes.c_void_p(v.data_ptr()) if torch.is_tensor(v)
                        else ctypes.c_int(v)
                        for v in (got[q] for q in params[src][sym][:-1])]
                args.append(ctypes.c_void_p(stream))
                fn = getattr(libs[src], sym)
                check(fn(*args) == 0, f"{src} {name} failed to launch")
                select = name == "tiny_dp" and "tiny" not in params[src][sym]
                call = (selecting_tiny_dp(fn, args, vals["tiny"],
                                          vals["banded"], outs["out"])
                        if select else lambda: fn(*args))
                if select:
                    cols = call()
                    outs["out"] = torch.stack(cols, 1) if len(cols) > 1 \
                        else cols[0]
                torch.cuda.synchronize()
                check(all(torch.equal(outs[o], x)
                          for o, x in zip(out_names, want)),
                      f"{src} {name} differs from its plain version ({tag})")
                timed, rest = WAVE_TIMED.get(name, (f"{name}_kernel", False))
                ms = device_ms(call, timed, AB_ITERS.get(name, 200),
                               rest=select or rest)
                times[src].setdefault(name, {}).setdefault(
                    tag, []).append(ms)
                log(f"[ab] {os.path.basename(src)} {name} {tag}: "
                    f"{ms:.5f} ms" + (" with the pool's torch.where"
                                      if select else ""))
                if name in WAVE_KERNELS:
                    log(f"[ab] {os.path.basename(src)} {name} {tag}: device "
                        f"ms by kernel {device_split(call)}")
    return {src: {name: {tag: sum(v) / len(v) for tag, v in per.items()}
                  for name, per in kern.items()}
            for src, kern in times.items()}


def phase_replay(batch=4096, turns=3, iters=10):
    """``python3 chip_smoke.py --replay [TREE]``: the gpu-full map of the
    16,384 chr21 pairs (its step captured at warm-up, one replay per
    batch) and then the device ms per replay of its graph (CUDA events,
    ``turns`` times ``iters`` replays of the last batch), and the aten ops
    of one eager step on the first batch: the step's A/B across commits,
    one process per tree, in turns."""
    import torch
    cfg, gi, db, reads, _ = chr21_setup()
    device = torch.device("cuda")
    r = run_slice(cfg, gi, db, reads, "device-full", "native", device,
                  batch)
    pipe = r["pipe"]
    graph = pipe.full_graph
    check(graph.captures == 1, f"{graph.captures} captures")
    replay_ms = [cuda_ms(graph.replay, iters) for _ in range(turns)]
    args = full_step_args(pipe, make_pairs(reads[:batch], cfg), device,
                          batch)
    _, n_ops = count_aten_ops(lambda: run_full_step(
        pipe, pipe.states[0], args, pipe._full_statics()))
    return dict(map_pairs_per_s=r["n"] / r["map_s"], map_s=r["map_s"],
                pool_bytes=graph.pool_bytes, replay_ms=replay_ms,
                eager_aten_ops=n_ops)


# --------------------------------------------------------------------------
# phases 3 + 4: the chr21-scale slice
# --------------------------------------------------------------------------

def chr21_setup(genome_len=47_000_000, n_pairs=16_384):
    """bench.py's default configuration: genome, index, annotation, reads."""
    import numpy as np
    from circminer_tpu_torch.annotation.annotation import AnnotationDB
    from circminer_tpu_torch.config import Config
    from circminer_tpu_torch.index.build import build_genome_index
    from circminer_tpu_torch.io.fasta import GenomePacker
    from circminer_tpu_torch.sim import make_genome, simulate_reads

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED_GENOME)
    n_genes = max(3, genome_len // 60_000)
    cfg = Config(kmer=20, max_read_len=120, threads=0)
    g = make_genome(rng, length=genome_len, n_genes=n_genes, dup_frac=0.05)
    with tempfile.TemporaryDirectory() as tmp:
        ref, gtf = os.path.join(tmp, "ref.fa"), os.path.join(tmp, "ref.gtf")
        g.write_fasta(ref)
        g.write_gtf(gtf)
        contigs, info = GenomePacker(ref).pack_genome()
        gi = build_genome_index(contigs, cfg)
        db = AnnotationDB.from_gtf(gtf, info, len(contigs), cfg,
                                   contig_lengths=[len(c) for c in contigs])
    n_circ = n_pairs // 5
    reads, truth = simulate_reads(np.random.default_rng(SEED_READS), g,
                                  n_pairs - n_circ, n_circ, read_len=100,
                                  err_rate=0.005)
    log(f"[setup] genome {genome_len} bp, {n_genes} genes, "
        f"{sum(c.n_entries for c in gi.contigs)} index entries, "
        f"{len(reads)} pairs, {time.perf_counter() - t0:.1f} s")
    return cfg, gi, db, reads, truth


def make_pairs(reads, cfg):
    from circminer_tpu_torch.ops.encode import encode_seq, revcomp
    from circminer_tpu_torch.pipeline.mapping import ReadRecord
    from circminer_tpu_torch.pipeline.types import MatchedRead
    out = []
    for r in reads:
        s1, s2 = encode_seq(r.r1), encode_seq(r.r2)
        out.append((ReadRecord(r.name, s1, revcomp(s1), "I" * len(r.r1),
                               len(r.r1), MatchedRead.default(cfg.max_ed)),
                    ReadRecord(r.name, s2, revcomp(s2), "I" * len(r.r2),
                               len(r.r2), None)))
    return out


def mr_key(mr):
    """The MatchedRead fields every executor must agree on."""
    return (mr.type, mr.chr_r1, mr.spos_r1, mr.epos_r1, mr.qspos_r1,
            mr.qepos_r1, mr.mlen_r1, mr.ed_r1, mr.chr_r2, mr.spos_r2,
            mr.epos_r2, mr.qspos_r2, mr.qepos_r2, mr.mlen_r2, mr.ed_r2,
            mr.tlen, mr.junc_num, mr.gm_compatible, mr.r1_forward)


def phase_lookup(cfg, gi, reads, device, batch=4096):
    """Device lookup of one batch vs the host C++ NativeSeeder; returns the
    device ms per batch (CUDA events; None off the card)."""
    import numpy as np
    import torch
    from circminer_tpu_torch.ops.seed_native import NativeSeeder
    from circminer_tpu_torch.pipeline.device_pipeline import (
        ContigDeviceState, encode_pairs, lookup_even)
    ci = gi.contigs[0]
    st = ContigDeviceState.from_contig_index(ci, cfg, device)
    pairs = make_pairs(reads[:batch], cfg)
    seqs, lens = encode_pairs(pairs, cfg.max_read_len)
    reads_d = torch.from_numpy(seqs).to(device)
    lens_d = torch.from_numpy(lens).to(device)
    packed = lookup_even(reads_d, lens_d, st, cfg).cpu().numpy()
    _, start, cnt, high = NativeSeeder(ci, cfg).lookup(seqs, lens)
    NL = cfg.n_kmer_lists
    for name, got, want in (("start", packed[:, :NL], start),
                            ("cnt", packed[:, NL:2 * NL], cnt),
                            ("high", packed[:, 2 * NL], high)):
        check(np.array_equal(got, want),
              f"device lookup {name} differs from NativeSeeder on "
              f"{int((got != want).sum())} of {got.size} values")
    ms = (cuda_ms(lambda: lookup_even(reads_d, lens_d, st, cfg), 10)
          if device.type == "cuda" else None)
    log(f"[lookup] {seqs.shape[0]} rows ({batch} pairs) bit-equal to "
        f"NativeSeeder (start, cnt, high); "
        + (f"{ms:.4f} ms per batch on the card" if ms is not None else ""))
    return ms


def run_slice(cfg, gi, db, reads, chain_exec, extend_exec, device,
              batch=4096, on_main_path=None):
    """Map + call one fresh copy of the read set; returns per-pair keys,
    called events and timings."""
    import torch
    from circminer_tpu_torch.config import CHIBSJ, CHI2BSJ
    from circminer_tpu_torch.pipeline.circ import ProcessCirc
    from circminer_tpu_torch.pipeline.device_pipeline import (
        DeviceMappingPipeline)
    pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=batch,
                                 chain_exec=chain_exec,
                                 extend_exec=extend_exec, device=device)
    pipe.warmup()
    pairs = make_pairs(reads, cfg)
    if on_main_path is not None:
        on_main_path(pipe)
    t0 = time.perf_counter()
    n = pipe.map_stream(iter(pairs))
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bsj = [(r1, r2) for r1, r2 in pairs if r1.mr.type in (CHIBSJ, CHI2BSJ)]
    for r1, _ in bsj:
        r1.mr.genome_spos = r1.mr.spos_r1
    bsj.sort(key=lambda pr: pr[0].mr.genome_spos)
    with tempfile.TemporaryDirectory() as tmp:
        pc = ProcessCirc(db, gi, cfg, os.path.join(tmp, "slice"))
        pc.run(bsj)
    circ_s = time.perf_counter() - t0
    check(n == len(reads), f"mapped {n} of {len(reads)} pairs")
    return dict(keys=[mr_key(p[0].mr) for p in pairs],
                events=sorted({(c.spos, c.epos) for c in pc.circ_res}),
                map_s=map_s, circ_s=circ_s, pipe=pipe, n=n, bsj=len(bsj),
                bsj_pairs=bsj)


def phase_slice(cfg, gi, db, reads, truth, device, batch=4096):
    from circminer_tpu_torch.ops import _ext
    launches = {}

    def reset(pipe):
        _ext.reset_launches()

    wave = run_slice(cfg, gi, db, reads, "device", "device", device, batch,
                     on_main_path=reset)
    launches.update(_ext.LAUNCHES)
    native = run_slice(cfg, gi, db, reads, "native", "native", None, batch)
    diff = [i for i, (a, b) in enumerate(zip(wave["keys"], native["keys"]))
            if a != b]
    check(not diff, f"gpu-wave differs from native on {len(diff)} pairs, "
          f"first {diff[:3]}: {[wave['keys'][i] for i in diff[:3]]} vs "
          f"{[native['keys'][i] for i in diff[:3]]}")
    check(wave["events"] == native["events"],
          f"called events differ: gpu-wave {len(wave['events'])}, native "
          f"{len(native['events'])}")
    check(len(wave["events"]) > 0, "no circRNA event called")
    if device.type == "cuda":  # on the CPU the wrappers run plain versions
        for name in DP_KERNELS:
            check(launches[name] > 0,
                  f"kernel {name} was not launched on the main path")
    truth_set = set(truth)
    matched = sum(1 for e in wave["events"] if e in truth_set)
    sv, ws = wave["pipe"].align_svc, wave["pipe"].wave_stats
    n = wave["n"]
    for tag, r in (("gpu-wave", wave), ("native", native)):
        log(f"[slice] {tag}: {n} pairs, map {r['map_s']:.3f} s "
            f"({n / r['map_s']:.1f} pairs/s), map+call "
            f"{r['map_s'] + r['circ_s']:.3f} s "
            f"({n / (r['map_s'] + r['circ_s']):.1f} pairs/s), "
            f"{r['bsj']} BSJ pairs, {len(r['events'])} events")
    log(f"[slice] gpu-wave == native on all {n} pairs and "
        f"{len(wave['events'])} events; {matched} of {len(truth)} true "
        f"events matched; {ws['waves']} waves over {ws['batches']} batches, "
        f"{sv.n_dispatch} dispatches, {sv.n_device} device / {sv.n_host} "
        f"host requests; launches {launches}")
    return launches, wave, native


def check_equal_to_native(tag, run, native):
    diff = [i for i, (a, b) in enumerate(zip(run["keys"], native["keys"]))
            if a != b]
    check(not diff, f"{tag} differs from native on {len(diff)} pairs, "
          f"first {diff[:3]}: {[run['keys'][i] for i in diff[:3]]} vs "
          f"{[native['keys'][i] for i in diff[:3]]}")
    check(run["events"] == native["events"],
          f"called events differ: {tag} {len(run['events'])}, native "
          f"{len(native['events'])}")
    n = run["n"]
    log(f"[{tag}] {n} pairs, map {run['map_s']:.3f} s "
        f"({n / run['map_s']:.1f} pairs/s), map+call "
        f"{run['map_s'] + run['circ_s']:.3f} s "
        f"({n / (run['map_s'] + run['circ_s']):.1f} pairs/s); equal to "
        f"native on all {n} pairs and {len(run['events'])} events")


def phase_chain(cfg, gi, db, reads, native, device, batch=4096):
    """gpu-chain against native; the chain_dp kernel's launches by
    occupancy bucket (S) of the run, each with its chain_cells launch."""
    from circminer_tpu_torch.ops import _ext
    from circminer_tpu_torch.ops import chain_device as cd
    wrapper, by_s = cd.chain_dp, {}

    def counted(*args, **kw):
        by_s[kw["S"]] = by_s.get(kw["S"], 0) + 1
        return wrapper(*args, **kw)

    def main_path(pipe):
        _ext.reset_launches()
        by_s.clear()
    cd.chain_dp = counted
    try:
        chain = run_slice(cfg, gi, db, reads, "device-chain", "native",
                          device, batch, on_main_path=main_path)
    finally:
        cd.chain_dp = wrapper
    check_equal_to_native("gpu-chain", chain, native)
    check(_ext.LAUNCHES["chain_dp"] == _ext.LAUNCHES["chain_cells"]
          == sum(by_s.values()) > 0,
          f"gpu-chain launched chain_dp {_ext.LAUNCHES['chain_dp']} and "
          f"chain_cells {_ext.LAUNCHES['chain_cells']} times for {by_s} "
          f"calls by bucket")
    log(f"[gpu-chain] chain_dp launches by occupancy bucket S: "
        f"{dict(sorted(by_s.items()))}")
    return chain


def full_step_args(pipe, pairs, device, batch):
    """The fused step's inputs for one batch of ``batch`` pairs, as the
    pipeline makes them (rows padded to 4 * batch, default MatchedRead
    state), on ``device``."""
    import torch
    return [torch.from_numpy(a).to(device)
            for a in full_step_host(pipe, pairs, batch)]


def full_step_host(pipe, pairs, batch):
    """``full_step_args`` as host arrays: seqs, lens, mr_in."""
    import numpy as np
    from circminer_tpu_torch.ops.filter_native import NativeFilter
    from circminer_tpu_torch.pipeline.types import MatchedRead
    from circminer_tpu_torch.pipeline.device_pipeline import encode_pairs
    cfg = pipe.cfg
    rows = 4 * batch
    seqs = np.zeros((rows, cfg.max_read_len), np.int8)
    lens = np.zeros(rows, np.int32)
    s, ln = encode_pairs(pairs, cfg.max_read_len)
    seqs[:len(s)], lens[:len(ln)] = s, ln
    row = NativeFilter.mr_to_state(MatchedRead.default(cfg.max_ed),
                                   pipe.filters[0].chr_names)
    mr_in = np.tile(row, (rows // 4, 1)).astype(np.int32)
    return seqs, lens, mr_in


def run_full_step(pipe, st, args, statics):
    from circminer_tpu_torch.ops.device_full import device_full_step
    return device_full_step(*args, st.entry_hv, st.entry_checksum,
                            st.entry_pos, st.genome, st.anno, st.fanno,
                            st.entry_prefix, contig_num=0,
                            prefix_shift=st.prefix_shift,
                            prefix_iters=st.prefix_iters, **statics)


def profile_map(pipe, reads, cfg):
    """One traced map run: (wall s, device-busy s, {span: (cpu ms, device
    ms of the kernels it launched)}, [(kernel, device ms)] top 8, device
    ops: kernels, copies and memsets, {hand kernel of FULL_KERNELS: its
    device records})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pairs = make_pairs(reads, cfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.map_stream(iter(pairs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events: kernels, copies and memsets (one stream, so they
    # do not overlap), without the device copies of the cm.* span markers
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.name.startswith("cm.")]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e6
    per_kernel = {}
    for e in dev_ev:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    kern = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    spans = {e.key: (e.cpu_time_total / 1e3, e.device_time_total / 1e3)
             for e in prof.key_averages()
             if e.key.startswith("cm.") and e.device_type == DeviceType.CPU}
    hand = {name: sum(f"{name}_kernel" in e.name for e in dev_ev)
            for name in FULL_KERNELS}
    return wall, busy, spans, kern, len(dev_ev), hand


def phase_full(cfg, gi, db, reads, native, device, batch=4096):
    """The main path: gpu-full (its step one CUDA graph, replayed per
    batch) against native, its kernel launches counted per replay, stats,
    and one profiled map with the step run eagerly (the cm.* spans)."""
    from circminer_tpu_torch.ops import _ext
    at = {}

    def main_path(pipe):
        _ext.reset_launches()
        at["replays"] = pipe.full_graph.replays
    full = run_slice(cfg, gi, db, reads, "device-full", "native", device,
                     batch, on_main_path=main_path)
    launches = dict(_ext.LAUNCHES)
    check_equal_to_native("gpu-full", full, native)
    pipe = full["pipe"]
    graph = pipe.full_graph
    replays = graph.replays - at["replays"]
    per_replay = graph.launches
    check(graph.captures == 1 and replays == -(-len(reads) // batch),
          f"gpu-full: {graph.captures} captures and {replays} replays for "
          f"{len(reads)} pairs in batches of {batch}")
    for name in FULL_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the gpu-full path")
    check(launches == {k: replays * per_replay[k] for k in launches},
          f"gpu-full launches {launches} are not {replays} replays of "
          f"{per_replay}")
    check(all(per_replay[k] == v for k, v in PER_STEP.items()),
          f"a replay launched {per_replay}, not {PER_STEP} of the kernels "
          f"it must launch a fixed number of times")
    fs = copy.deepcopy(pipe.full_stats)   # the profiled run below adds to it
    check(fs["reads"] == len(reads), f"device-full saw {fs['reads']} reads")
    log(f"[gpu-full] {fs['reads']} reads, {fs['deferred']} deferred "
        f"({100.0 * fs['deferred'] / fs['reads']:.2f}%), causes "
        f"{dict(sorted(fs['causes'].items()))}; {replays} graph replays, "
        f"launches {launches} ({per_replay} per replay); capture "
        f"{graph.capture_s:.3f} s, instantiation {graph.instantiate_s:.3f} "
        f"s at warm-up")
    # the profiler's own host cost is ~25 s per eager step: two steps
    pipe.step_graph = False
    try:
        wall, busy, spans, kern, _, _ = profile_map(
            pipe, reads[:2 * batch], cfg)
    finally:
        pipe.step_graph = True
    log(f"[gpu-full] profiled map of {2 * batch} pairs, step run eagerly: "
        f"wall {wall:.3f} s, device busy {busy:.4f} s "
        f"({100.0 * busy / wall:.2f}%)")
    for key in sorted(spans, key=lambda k: -spans[k][1]):
        cpu, dev = spans[key]
        log(f"[gpu-full]   span {key}: cpu {cpu:.1f} ms, device "
            f"{dev:.2f} ms")
    for name, ms in kern:
        log(f"[gpu-full]   kernel {name[:70]}: device {ms:.2f} ms")
    return full, launches, dict(busy=busy, wall=wall, stats=fs)


def phase_step_vs_plain(cfg, gi, db, reads, full, n_pairs=256):
    """One device_full_step on the card (kernels) and on the CPU (plain
    versions) with the same inputs and statics: bit-equal blobs."""
    import torch
    from circminer_tpu_torch.annotation.device import (AnnoDevice,
                                                       FinishAnnoDevice)
    from circminer_tpu_torch.pipeline.device_pipeline import (
        ContigDeviceState)
    pipe = full["pipe"]
    statics = pipe._full_statics()
    pairs = make_pairs(reads[:n_pairs], cfg)
    st_gpu = pipe.states[0]
    st_cpu = ContigDeviceState.from_contig_index(gi.contigs[0], cfg, "cpu")
    st_cpu.anno = AnnoDevice.from_contig(db.contigs[0], pipe.seg_pad,
                                         device="cpu")
    st_cpu.fanno = FinishAnnoDevice.from_contig(
        db.contigs[0], db.con2chr[0], pipe.seg_pad, device="cpu")
    st_cpu.genome = torch.from_numpy(gi.contigs[0].codes)
    args_gpu = full_step_args(pipe, pairs, torch.device("cuda"), n_pairs)
    args_cpu = full_step_args(pipe, pairs, torch.device("cpu"), n_pairs)
    t0 = time.perf_counter()
    got = run_full_step(pipe, st_gpu, args_gpu, statics).cpu()
    t1 = time.perf_counter()
    want = run_full_step(pipe, st_cpu, args_cpu, statics)
    t2 = time.perf_counter()
    # the per-column chain prelude (seg_compact, the form above 300 M index
    # entries) on the card against the padded form's plain CPU step
    got_sc = run_full_step(pipe, st_gpu, args_gpu,
                           {**statics, "seg_compact": True}).cpu()
    for tag, blob in (("", got), (" with seg_compact=True", got_sc)):
        check(blob.dtype == want.dtype == torch.int32
              and blob.shape == want.shape,
              f"step blobs{tag} {blob.dtype} {tuple(blob.shape)} vs "
              f"{want.dtype} {tuple(want.shape)}")
        bad = (blob != want).any(dim=1).nonzero()[:, 0]
        check(len(bad) == 0, f"device_full_step{tag} on the card differs "
              f"from the plain CPU step on {len(bad)} of {n_pairs} rows, "
              f"first {bad[:3].tolist()}: {blob[bad[:2]].tolist()} vs "
              f"{want[bad[:2]].tolist()}")
    n_def = int((want[:, -1] != 0).sum())
    log(f"[step-vs-plain] device_full_step on {n_pairs} pairs: card blob "
        f"bit-equal to the plain CPU step ({n_def} deferred rows; card "
        f"{t1 - t0:.2f} s, CPU {t2 - t1:.2f} s, statics of the "
        f"{pipe.batch}-pair pipeline, seg_compact="
        f"{statics['seg_compact']}), and so is the card step with "
        f"seg_compact=True")


# --------------------------------------------------------------------------
# phases 8-10: stage 2 on the card, auto, single-end
# --------------------------------------------------------------------------

def circ_key(c):
    return (c.chr, c.rname, c.spos, c.epos, c.type, c.start_signal,
            c.end_signal, c.start_bp_ref, c.end_bp_ref)


def phase_stage2(cfg, gi, db, full, device):
    """Stage 2 of the gpu-full map's BSJ pairs on the card against the host
    native stage 2; returns the kernel launches of the device run."""
    from circminer_tpu_torch.ops import _ext
    from circminer_tpu_torch.pipeline.circ import ProcessCirc
    bsj = full["bsj_pairs"]
    with tempfile.TemporaryDirectory() as tmp:
        host = ProcessCirc(db, gi, cfg, os.path.join(tmp, "host"))
        t0 = time.perf_counter()
        host.run(list(bsj))
        host_s = time.perf_counter() - t0
        card = ProcessCirc(db, gi, cfg, os.path.join(tmp, "card"),
                           device=device)
        _ext.reset_launches()
        t0 = time.perf_counter()
        with launches_after_warm():      # the run's own launches
            card.run(list(bsj), device_ext=True)
        torch_sync(device)
        card_s = time.perf_counter() - t0
        launches = dict(_ext.LAUNCHES)
        # the kernels' inputs come from a second, untimed run: recording
        # copies them, and card_s stays the uninstrumented time
        store = {}
        undo = recording_inputs(store)
        try:
            ProcessCirc(db, gi, cfg, os.path.join(tmp, "rec"),
                        device=device).run(list(bsj), device_ext=True)
            torch_sync(device)
        finally:
            undo()
    got = [circ_key(c) for c in card.circ_res]
    want = [circ_key(c) for c in host.circ_res]
    if got != want:
        first = next((a, b) for a, b in zip(got + [None], want + [None])
                     if a != b)
        raise SmokeFailure(f"stage 2 on the card differs from the host: "
                           f"{len(got)} vs {len(want)} circ_res, first "
                           f"differing {first}")
    check(card.candid_lines == host.candid_lines,
          f"stage-2 candidate lines differ: {len(card.candid_lines)} vs "
          f"{len(host.candid_lines)}")
    check(len(want) > 0, "stage 2 called no circRNA read")
    check(launches["edit_sc"] > 0, "edit_sc was not launched by stage 2")
    st = card.dev_align_stats
    log(f"[stage2] {len(bsj)} BSJ pairs: card {card_s:.3f} s (device "
        f"extension), host native {host_s:.3f} s; {len(want)} circ_res and "
        f"{len(host.candid_lines)} candidate lines equal; dev_align_stats "
        f"{st}; launches {launches}")
    # edit_sc runs only here: time it at the rows the stage-2 waves send
    shapes = time_recorded({k: v for k, v in store.items()
                            if k[0] == "edit_sc"}, "in stage 2")
    return launches, dict(card_s=card_s, host_s=host_s, stats=st,
                          shapes=shapes)


def torch_sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_auto(cfg, gi, db, device, batch=4096):
    """The auto probe on the card under the current (fresh) decision cache,
    then a second pipeline that must take the choice from the cache."""
    from circminer_tpu_torch.pipeline.device_pipeline import (
        DeviceMappingPipeline)

    def auto():
        return DeviceMappingPipeline(db, gi, cfg, batch_size=batch,
                                     chain_exec="auto", device=device)
    pipe = auto()
    path, key = pipe._decision_cache_path()
    check(not os.path.exists(path), f"decision cache not fresh: {path}")
    t0 = time.perf_counter()
    pipe.warmup()
    probe_s = time.perf_counter() - t0
    choice = pipe.chain_exec
    with open(path) as f:
        rec = json.load(f)
    check(rec.get("key") == key and rec.get("executor") == choice,
          f"cached decision {rec} does not match the probe's {choice}")
    log(f"[auto] probe on the card ({probe_s:.2f} s with warm-up) -> "
        f"{choice}; detail {json.dumps(rec)}")

    def no_probe():
        raise SmokeFailure("the second auto pipeline probed again")
    again = auto()
    again._probe_decision = no_probe
    again.warmup()
    check(again.chain_exec == choice, f"cached choice {again.chain_exec} "
          f"differs from the probe's {choice}")
    log(f"[auto] a second pipeline took {choice} from the cache")
    return rec


def make_se(reads, cfg):
    from circminer_tpu_torch.ops.encode import encode_seq, revcomp
    from circminer_tpu_torch.pipeline.mapping import ReadRecord
    from circminer_tpu_torch.pipeline.types import MatchedRead
    out = []
    for r in reads:
        s1 = encode_seq(r.r1)
        out.append(ReadRecord(r.name, s1, revcomp(s1), "I" * len(r.r1),
                              len(r.r1), MatchedRead.default(cfg.max_ed)))
    return out


def phase_se(cfg, gi, db, reads, device, batch=4096):
    """map_stream_se of the R1 reads under every executor against native;
    returns reads/s per executor."""
    from circminer_tpu_torch.pipeline.device_pipeline import (
        DeviceMappingPipeline)
    keys, rates = {}, {}
    for ex in ("native", "device", "device-chain", "device-full", "auto"):
        pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=batch,
                                     chain_exec=ex, device=device)
        pipe.warmup()
        recs = make_se(reads, cfg)
        t0 = time.perf_counter()
        n = pipe.map_stream_se(iter(recs))
        torch_sync(device)
        dt = time.perf_counter() - t0
        check(n == len(reads), f"SE {ex}: mapped {n} of {len(reads)} reads")
        keys[ex] = [mr_key(r.mr) for r in recs]
        rates[ex] = n / dt
        tag = f"auto ({pipe.chain_exec})" if ex == "auto" else ex
        log(f"[se] {tag}: {n} reads in {dt:.3f} s ({rates[ex]:.1f} reads/s)")
    for ex, k in keys.items():
        diff = [i for i, (a, b) in enumerate(zip(k, keys["native"]))
                if a != b]
        check(not diff, f"SE {ex} differs from native on {len(diff)} reads, "
              f"first {diff[:3]}: {[k[i] for i in diff[:2]]} vs "
              f"{[keys['native'][i] for i in diff[:2]]}")
    conc = sum(1 for k in keys["native"] if k[0] == 0)
    log(f"[se] device, device-chain, device-full and auto equal native on "
        f"all {len(reads)} reads ({conc} concordant)")
    return rates


# --------------------------------------------------------------------------
# phase 11: the CLI
# --------------------------------------------------------------------------

def trace_names(trace_dir, names):
    """Which of ``names`` the gzipped Chrome trace in ``trace_dir`` holds
    (a text search: the trace runs to hundreds of MB)."""
    import gzip
    files = os.listdir(trace_dir)
    check(len(files) == 1 and files[0].endswith(".trace.json.gz"),
          f"--trace-dir wrote {files}")
    path = os.path.join(trace_dir, files[0])
    found = set()
    with gzip.open(path, "rt") as f:
        for chunk in iter(lambda: f.read(1 << 24), ""):
            found |= {n for n in names if n in chunk}
    return found, os.path.getsize(path)


def phase_cli(torch_device="cuda", genome_len=100_000, n_reads=1000,
              batch=4096):
    import numpy as np
    from circminer_tpu_torch.sim import make_genome, simulate_reads, write_fastq
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(42)
        g = make_genome(rng, length=genome_len, n_genes=4)
        ref = os.path.join(d, "ref.fa")
        g.write_fasta(ref)
        g.write_gtf(os.path.join(d, "ref.gtf"))
        n_circ = n_reads // 5
        reads, _ = simulate_reads(rng, g, n_reads - n_circ, n_circ,
                                  read_len=100, err_rate=0.005)
        write_fastq(reads, os.path.join(d, "R1.fq"),
                    os.path.join(d, "R2.fq"))

        def cli(*args):
            cmd = [sys.executable, "-m", "circminer_tpu_torch.cli", *args]
            res = subprocess.run(cmd, cwd=d, env=env, capture_output=True,
                                 text=True, timeout=600)
            check(res.returncode == 0, f"{' '.join(cmd)} failed "
                  f"({res.returncode}):\n{res.stderr[-3000:]}")
            return res.stderr

        def same(tag, ref, suffixes):
            for suffix in suffixes:
                with open(os.path.join(d, tag + suffix), "rb") as f:
                    a = f.read()
                with open(os.path.join(d, ref + suffix), "rb") as f:
                    b = f.read()
                check(a == b, f"CLI {suffix}: {tag} and {ref} differ")
                check(len(a) > 0, f"CLI {ref}{suffix} is empty")

        cli("--index", "-r", "ref.fa", "-k", "20")
        common = ["-r", "ref.fa", "-g", "ref.gtf", "--pam", "--torch-device",
                  torch_device, "--batch-size", str(batch)]
        pe = common + ["-1", "R1.fq", "-2", "R2.fq"]
        cli(*pe, "-o", "native", "--device", "native")
        for dev in ("gpu-wave", "gpu-chain", "gpu-full"):
            trace = ["--trace-dir", "trace"] if dev == "gpu-full" else []
            err = cli(*pe, "-o", dev, "--device", dev, *trace)
            same(dev, "native", (".circ_report", ".mapping.pam",
                                 ".candidates.pam"))
            check(not trace or "runs eagerly" in err, "the traced gpu-full "
                  "CLI run did not say that its step runs eagerly")
            info = [ln.strip() for ln in err.splitlines()
                    if "wave engine" in ln or "device-full:" in ln
                    or "stage-2 device" in ln]
            log(f"[cli] {n_reads} pairs: circ_report, mapping.pam and "
                f"candidates.pam of --device {dev} byte-equal to --device "
                f"native; {'; '.join(info)}")
        want = {"cm.walk_waves", "xdrop_kernel", "edit_sc_kernel",
                "edit_end_kernel", "one_side_kernel"}
        found, size = trace_names(os.path.join(d, "trace"), want)
        check("cm.walk_waves" in found and len(found) > 1,
              f"the gpu-full trace names only {sorted(found)} of "
              f"{sorted(want)}")
        log(f"[cli] --trace-dir: {size} B gzipped Chrome trace naming "
            f"{sorted(found)}")
        se = common + ["-s", "R1.fq"]
        cli(*se, "-o", "se_native", "--device", "native")
        for dev in ("auto", "gpu-full"):
            err = cli(*se, "-o", f"se_{dev}", "--device", dev)
            same(f"se_{dev}", "se_native", (".mapping.pam",))
            info = [ln.strip() for ln in err.splitlines()
                    if "auto executor" in ln]
            log(f"[cli] -s {n_reads} reads: mapping.pam of --device {dev} "
                f"byte-equal to --device native {'; '.join(info)}")
        phase_coordinated_cli(d, env, pe, "gpu-full")


def phase_coordinated_cli(d, env, pe, single):
    """Two concurrent --device gpu-full processes on the card joined in one
    gloo process group through --coordinator (each maps its stripe; host 0
    runs stage 2 over both remain shards): circ_report byte-equal to the
    single-host run ``single`` in directory ``d``."""
    from circminer_tpu_torch.graft_entry import _free_port
    cmd = [sys.executable, "-m", "circminer_tpu_torch.cli", *pe, "-o",
           "coord", "--device", "gpu-full", "--coordinator",
           f"127.0.0.1:{_free_port()}", "--num-hosts", "2"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--host-id", str(h)], cwd=d, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for h in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:       # a rank that hangs is stopped, not left
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for h, (p, (_, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0 and f"host {h} of 2 (gloo process group)"
              in err, f"coordinated host {h} failed ({p.returncode}):\n"
              f"{err[-3000:]}")
    with open(os.path.join(d, "coord.circ_report"), "rb") as f:
        got = f.read()
    with open(os.path.join(d, single + ".circ_report"), "rb") as f:
        want = f.read()
    check(got == want and len(want) > 0, "the coordinated two-process "
          "circ_report differs from the single-host run's")
    log(f"[mesh-cli] two coordinated --device gpu-full processes (gloo "
        f"group): circ_report byte-equal to the single-host run "
        f"({len(want)} B); {wall:.1f} s wall")


# --------------------------------------------------------------------------
# phase 13: multi-contig rounds (the port's analog of grch38_run.py --mini)
# --------------------------------------------------------------------------

MINI_SEED = 20260821     # tools.grch38_run's seed


@contextlib.contextmanager
def launches_after_warm():
    """Within it, every warm-up of the stage-2 device service
    (DeviceAlignService.warm, one launch of each DP kind before the
    streamed region) sets the launch counts back to 0 when it is done, so
    that the counts read after stage 2 are its own run's."""
    from circminer_tpu_torch.ops import _ext
    from circminer_tpu_torch.ops.align_device import DeviceAlignService
    warm = DeviceAlignService.warm

    def warm_then_reset(self):
        warm(self)
        _ext.reset_launches()
    DeviceAlignService.warm = warm_then_reset
    try:
        yield
    finally:
        DeviceAlignService.warm = warm


def cli_map_and_call(argv, device):
    """The port's CLI in this process (cli.main with hooks), paired-end with
    stage 2: per-round pairs and deferrals, map and stage-2 wall times, and
    the kernel launches of the map and of stage 2, each counted from the
    end of its warm-up."""
    from circminer_tpu_torch import cli
    from circminer_tpu_torch.ops import _ext
    r = dict(rounds=[], t=time.perf_counter())

    def mapping(pipe):
        inner = pipe.map_stream
        r["contigs"] = len(pipe.states)
        r["pipe"] = pipe

        def per_round(src, contig=0, **kw):
            before = copy.deepcopy(pipe.full_stats)
            t0 = time.perf_counter()
            n = inner(src, contig=contig, **kw)
            causes = {k: v - before["causes"].get(k, 0)
                      for k, v in pipe.full_stats["causes"].items()
                      if v != before["causes"].get(k, 0)}
            r["rounds"].append(dict(
                contig=contig, pairs=n, s=time.perf_counter() - t0,
                deferred=pipe.full_stats["deferred"] - before["deferred"],
                causes=causes))
            return n
        pipe.map_stream = per_round
        torch_sync(device)
        _ext.reset_launches()
        r["t"] = time.perf_counter()

    def mapped(pipe):
        torch_sync(device)
        r["map_s"] = time.perf_counter() - r["t"]
        r["n"] = r["rounds"][0]["pairs"]
        r["map_launches"] = dict(_ext.LAUNCHES)
        r["t"] = time.perf_counter()

    def called(pc):
        torch_sync(device)
        r["call_s"] = time.perf_counter() - r["t"]
        r["call_launches"] = dict(_ext.LAUNCHES)

    with launches_after_warm():
        rc = cli.main(argv, dict(mapping=mapping, mapped=mapped,
                                 called=called))
    check(rc == 0, f"circminer_tpu_torch.cli {' '.join(argv)} returned {rc}")
    r["launches"] = {k: r["map_launches"][k] + r["call_launches"][k]
                     for k in REPLACES}
    return r


def phase_contigs(device, batch=4096):
    """grch38_run.py --mini on the port's CLI (in this process): 20,000
    pairs over 3 contigs (CIRCMINER_CONTIG_SIZE = 2 Mbp at --index),
    --device gpu-full (stage 2 on the card) and native: every true event
    called, PAM, circ_report and candidates.pam byte-equal, and all four
    kernels launched by the gpu-full map and its stage 2."""
    import torch
    from circminer_tpu_torch import cli
    from circminer_tpu_torch.tools.grch38_run import (MINI_MBP, phase_eval,
                                                      phase_sim)
    old = os.environ.get("CIRCMINER_CONTIG_SIZE")
    os.environ["CIRCMINER_CONTIG_SIZE"] = "2000000"
    try:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            phase_sim(d, [(c, bp * 1_000_000) for c, bp in MINI_MBP],
                      20_000, circ_frac=0.2, dup_frac=0.05, seed=MINI_SEED)
            ref, gtf = os.path.join(d, "ref.fa"), os.path.join(d, "ref.gtf")
            check(cli.main(["--index", "-r", ref, "-k", "20"]) == 0,
                  "--mini --index failed")
            with open(os.path.join(d, "truth.json")) as f:
                n_true = len({tuple(e) for e in json.load(f)["events"]})
            log(f"[contigs] simulated {sum(bp for _, bp in MINI_MBP)} Mbp "
                f"in {len(MINI_MBP)} chromosomes (tools.grch38_run."
                f"phase_sim), {n_true} true events, indexed, "
                f"{time.perf_counter() - t0:.1f} s")
            common = ["-r", ref, "-g", gtf, "-1", os.path.join(d, "R1.fq"),
                      "-2", os.path.join(d, "R2.fq"), "--pam", "-l", "100",
                      "--batch-size", str(batch), "--torch-device",
                      device.type]
            runs = {}
            for tag in ("native", "gpu-full"):
                torch.cuda.reset_peak_memory_stats(device)
                runs[tag] = r = cli_map_and_call(
                    common + ["-o", os.path.join(d, tag), "--device", tag],
                    device)
                r["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
                check(r["contigs"] == 3, f"--mini packed into {r['contigs']} "
                      f"contigs, not 3")
                ev = phase_eval(d, os.path.join(d, tag))
                check(ev["accuracy_gate"] and ev["true_events"] == n_true,
                      f"{tag}: {ev['true_events'] - ev['events_matched']} of "
                      f"{ev['true_events']} true events not called, first "
                      f"{ev['missed'][:3]}")
                log(f"[contigs] {tag}: {r['n']} pairs over {r['contigs']} "
                    f"contigs, map {r['map_s']:.3f} s ({r['n'] / r['map_s']:.1f}"
                    f" pairs/s), map+call {r['map_s'] + r['call_s']:.3f} s "
                    f"({r['n'] / (r['map_s'] + r['call_s']):.1f} pairs/s); all "
                    f"{n_true} true events called ({ev['called_events']} "
                    f"called)")
                for rd in r["rounds"]:
                    log(f"[contigs]   {tag} round {rd['contig'] + 1}: "
                        f"{rd['pairs']} pairs in, {rd['deferred']} deferred "
                        f"{dict(sorted(rd['causes'].items()))}, "
                        f"{rd['s']:.3f} s")
            for suffix in (".mapping.pam", ".circ_report", ".candidates.pam"):
                with open(os.path.join(d, "gpu-full" + suffix), "rb") as f:
                    a = f.read()
                with open(os.path.join(d, "native" + suffix), "rb") as f:
                    b = f.read()
                check(a == b and len(b) > 0,
                      f"--mini {suffix}: gpu-full and native differ")
    finally:
        if old is None:
            os.environ.pop("CIRCMINER_CONTIG_SIZE")
        else:
            os.environ["CIRCMINER_CONTIG_SIZE"] = old
    full = runs["gpu-full"]
    for name in REPLACES:
        check(full["launches"][name] > 0, f"kernel {name} was not launched "
              f"by the --mini gpu-full map or its stage 2")
    graph = full["pipe"].full_graph
    check(graph is not None and graph.captures == full["contigs"],
          f"--mini gpu-full: {graph and graph.captures} graph captures for "
          f"{full['contigs']} contigs")
    log(f"[contigs] gpu-full in graph mode: {graph.captures} captures "
        f"(one per contig), {graph.replays} replays; the last capture "
        f"{graph.capture_s:.3f} s recording, {graph.instantiate_s:.3f} s "
        f"instantiating")
    log(f"[contigs] gpu-full == native (mapping.pam, circ_report, "
        f"candidates.pam); peak device memory {full['peak_gb']:.3f} GB; "
        f"launches after the warm-ups: map {full['map_launches']}, stage 2 "
        f"{full['call_launches']}")
    return runs


# --------------------------------------------------------------------------
# phase 14: the sharded steps (parallel/mesh.py)
# --------------------------------------------------------------------------

def mesh_payload(full, reads, cfg, gi, db, batch=4096):
    """The sharded steps' problem: one chr21 batch of ``batch`` pairs of the
    gpu-full map as that pipeline steps it (its statics, index, genome and
    annotation, on the CPU for the ranks to load), and the map's BSJ rows
    (genome_spos, global pair index) striped over 2 ranks."""
    import dataclasses
    import numpy as np
    from circminer_tpu_torch.annotation.device import (AnnoDevice,
                                                       FinishAnnoDevice)
    pipe = full["pipe"]
    args = full_step_args(pipe, make_pairs(reads[:batch], cfg), "cpu", batch)
    st = pipe.states[0]
    ci = gi.contigs[0]
    index = {r.name: i for i, r in enumerate(reads)}
    rows = [(r1.mr.genome_spos, index[r1.rname]) for r1, _ in
            full["bsj_pairs"]]
    per = [[row for row in rows if row[1] % 2 == d] for d in range(2)]
    cap = max(len(p) for p in per)
    cand = np.full((2, cap, 2), 2 ** 30, np.int32)
    for d, part in enumerate(per):
        cand[d, :len(part)] = part
    return dict(
        cfg=cfg, ci=dataclasses.replace(ci, _entry_key=None),
        ad=AnnoDevice.from_contig(db.contigs[0], pipe.seg_pad, device="cpu"),
        fa=FinishAnnoDevice.from_contig(db.contigs[0], db.con2chr[0],
                                        pipe.seg_pad, device="cpu"),
        seqs4=args[0].numpy(), lens4=args[1].numpy(), mr_in=args[2].numpy(),
        statics=pipe._full_statics(), seed_cap=16,
        prefix=None if st.entry_prefix is None else
        st.entry_prefix.cpu().numpy(), prefix_shift=st.prefix_shift,
        prefix_iters=st.prefix_iters, contig_num=0,
        steps=("full", "index_full", "merge"),
        cand=cand.reshape(-1, 2), cand_count=np.array([len(p) for p in per],
                                                      np.int32)), rows


def collective_shape(payload):
    """(rows, L, NL, cap) of the index-sharded full step's exchanges on
    ``payload`` (mesh_payload)."""
    rows, L = payload["seqs4"].shape
    k = payload["cfg"].kmer
    return [rows, L, (L + k - 1) // k, payload["statics"]["cap"]]


def time_collectives(mesh, rows, L, NL, cap, iters=5):
    """Mean ms (CUDA events) of each collective of the index-sharded full
    step alone, at its shapes on ``mesh``: the all-gather of this rank's
    [rows / D, L] int8 queries and the psum of the [rows, NL, cap] int32
    seed positions."""
    import torch
    from circminer_tpu_torch.parallel import mesh as pm
    seqs = torch.zeros((rows // mesh.size, L), dtype=torch.int8,
                       device=mesh.device)
    pos = torch.zeros((rows, NL, cap), dtype=torch.int32, device=mesh.device)
    return {f"all_gather seqs {tuple(seqs.shape)} int8":
            cuda_ms(lambda: pm.all_gather(mesh, seqs), iters),
            f"psum pos {tuple(pos.shape)} int32":
            cuda_ms(lambda: pm.psum(mesh, pos), iters)}


def collectives_rank(spec):
    """``chip_smoke.py --collectives-rank SPEC``: one rank of
    collectives_world (a gloo group, the rank on cuda:0)."""
    import torch.distributed as dist
    from circminer_tpu_torch.parallel import mesh as pm
    pm.init_group("gloo", spec["init"], spec["size"], spec["rank"])
    try:
        ms = time_collectives(pm.make_mesh(spec["size"], device="cuda:0"),
                              *spec["shape"])
    finally:
        dist.destroy_process_group()
    if spec["rank"] == 0:
        with open(spec["out"], "w") as f:
            json.dump(ms, f)
    return 0


def collectives_world(n, shape, timeout=300):
    """time_collectives at world size ``n`` under gloo, every rank on this
    card, in ``n`` processes of this script that share one deadline; rank
    0's result."""
    from circminer_tpu_torch.graft_entry import _free_port
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        init = f"tcp://127.0.0.1:{_free_port()}"
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--collectives-rank",
             json.dumps(dict(rank=r, size=n, init=init, shape=shape,
                             out=out))], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n)]
        deadline = time.monotonic() + timeout
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:      # a rank that hangs is stopped, not left
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(len(logs) == n and all(p.returncode == 0 for p in procs),
              f"collective ranks failed ({[p.returncode for p in procs]}):\n"
              + "\n".join(x[-2000:] for x in logs))
        with open(out) as f:
            return json.load(f)


def phase_mesh(full, reads, cfg, gi, db, device, batch=4096):
    """make_sharded_full_step and make_index_sharded_full_step on one
    4,096-pair chr21 batch: at world size 1 under a NCCL group in this
    process, and at world size 2 under gloo with both ranks on this card
    (NCCL refuses two ranks on one device), each gathered blob bit-equal to
    the single-process gpu-full step's; merge_bsj_candidates carries the
    gpu-full map's BSJ rows.  Returns the world-1 run's kernel launches."""
    import numpy as np
    import torch.distributed as dist
    from circminer_tpu_torch.graft_entry import (_free_port, run_ranks,
                                                 sharded_outputs)
    from circminer_tpu_torch.ops import _ext
    from circminer_tpu_torch.parallel import mesh as pm
    pipe = full["pipe"]
    args = full_step_args(pipe, make_pairs(reads[:batch], cfg), device, batch)
    want = run_full_step(pipe, pipe.states[0], args,
                         pipe._full_statics()).cpu().numpy()
    t0 = time.perf_counter()
    payload, rows = mesh_payload(full, reads, cfg, gi, db, batch)
    log(f"[mesh] payload: {batch} pairs, {len(rows)} BSJ rows, "
        f"{time.perf_counter() - t0:.1f} s")

    def held(tag, out):
        for name in ("full", "index_full"):
            check(out[name].shape == want.shape and
                  np.array_equal(out[name], want),
                  f"{tag} {name} step differs from the single-process step "
                  f"on {int((out[name] != want).any(axis=1).sum())} rows")
        log(f"[mesh] {tag}: sharded and index-sharded full steps bit-equal "
            f"to the single-process step ({want.shape[0]} pairs); step ms "
            f"{ {k: round(v, 3) for k, v in out['ms'].items()} }; "
            f"collectives alone {out['collective_ms']} ms")

    shape = collective_shape(payload)
    pm.init_group("nccl", f"tcp://127.0.0.1:{_free_port()}", 1, 0)
    try:
        mesh = pm.make_mesh(1)
        _ext.reset_launches()
        one = sharded_outputs(mesh, dict(payload,
                                         steps=("full", "index_full")))
        launches = dict(_ext.LAUNCHES)
        check(one["backend"] == "nccl", f"backend {one['backend']}")
        one["collective_ms"] = time_collectives(mesh, *shape)
    finally:
        dist.destroy_process_group()
    for name in FULL_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
              f"sharded steps")
    held("world 1, nccl", one)
    t0 = time.perf_counter()
    two = run_ranks(2, payload, backend="gloo", device="cuda", timeout=600)
    check(two["backend"] == "gloo" and two["size"] == 2,
          f"ranks ran {two['backend']} x {two['size']}")
    wall = time.perf_counter() - t0
    two["collective_ms"] = collectives_world(2, shape)
    held(f"world 2, gloo, both ranks on cuda:0 ({wall:.1f} s with start-up)",
         two)
    cg, ng = two["merge"]
    got = {tuple(r) for r in cg.reshape(-1, 2) if r[0] != 2 ** 30}
    check(got == set(rows) and int(ng.sum()) == len(rows) and
          cg.shape[0] == 2, f"merge_bsj_candidates gathered {len(got)} of "
          f"{len(rows)} BSJ rows")
    log(f"[mesh] merge_bsj_candidates: {cg.shape} candidates and counts "
        f"{ng.tolist()} on every rank, the union of the gpu-full map's "
        f"{len(rows)} BSJ rows; launches at world 1 {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 12: the bench
# --------------------------------------------------------------------------

def phase_bench(device, size=()):
    """The port's bench in its smoke configuration (``size`` cuts it
    further): gpu-full with the stage-2 device extension, two repeats,
    against native, on ``device``."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def bench(*args):
        cmd = [sys.executable, "-m", "circminer_tpu_torch.bench", "--smoke",
               "--torch-device", device.type, *size, *args]
        res = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                             text=True, timeout=600)
        check(res.returncode == 0, f"{' '.join(cmd)} failed "
              f"({res.returncode}):\n{res.stderr[-3000:]}")
        last = res.stdout.strip().splitlines()[-1]
        try:
            rec = json.loads(last)
        except ValueError:
            raise SmokeFailure(f"bench printed no JSON last line: {last!r}")
        log(f"[bench] {' '.join(args)}: {last}")
        return rec

    full = bench("--exec", "gpu-full", "--circ-device", "--repeat", "2")
    native = bench("--exec", "native")
    for tag, rec, extra in (
            ("gpu-full", full, {"runs", "spread_pct", "deferred_pct",
                                "defer_causes"}),
            ("native", native, set())):
        check(set(rec) == BENCH_KEYS | extra,
              f"bench {tag} keys {sorted(rec)}")
    check(full["backend"] == device.type and full["executor"] == "gpu-full",
          f"bench ran {full['executor']} on {full['backend']}")
    check((full["events"], full["events_matched"])
          == (native["events"], native["events_matched"]) and
          full["events"] > 0,
          f"bench events: gpu-full {full['events']}/"
          f"{full['events_matched']}, native {native['events']}/"
          f"{native['events_matched']}")
    return full, native


# --------------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "circminer_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(circminer_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--replay"]:
        # the package of TREE (another checkout, e.g. a parent commit
        # unpacked with git archive), timed by this script's phases
        tree = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else HERE)
        sys.path.insert(0, tree)
        print(json.dumps(dict(phase_replay(), tree=tree,
                              card=card_report())))
        return 0
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--collectives-rank"]:
        return collectives_rank(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--ab"]:
        card = card_report()
        try:
            ab = phase_ab(sys.argv[2:])
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"ab": ab}))
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    try:
        from circminer_tpu_torch.ops import _ext
        t_all = time.perf_counter()
        _LAP[0] = t_all
        card = card_report()
        log(f"[device] {card}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")
        t0 = time.perf_counter()
        _ext.build()
        log(f"[build] {_ext.library_path()} in "
            f"{time.perf_counter() - t0:.1f} s")
        device = torch.device("cuda")
        lap("1 device+build")
        kern = phase_kernels(device)
        phase_chain_fold(device)
        phase_walk(device)
        phase_chain_ends(device)
        phase_extend(device)
        phase_pair(device)
        buckets = phase_chain_buckets(device)
        lap("2 kernels")
        cfg, gi, db, reads, truth = chr21_setup()
        lap("chr21 setup")
        lookup_ms = phase_lookup(cfg, gi, reads, device)
        lap("3 lookup")
        _, wave, native = phase_slice(cfg, gi, db, reads, truth, device)
        lap("4 gpu-wave+native")
        chain = phase_chain(cfg, gi, db, reads, native, device)
        lap("5 gpu-chain")
        full, full_launches, full_m = phase_full(cfg, gi, db, reads, native,
                                                 device)
        lap("6 gpu-full")
        phase_step_vs_plain(cfg, gi, db, reads, full)
        main_shapes, tensor_kern = phase_main_shapes(full["pipe"], reads,
                                                    cfg, 4096)
        lap("7 step vs plain")
        graph = phase_graph(full, reads, cfg, device)
        lap("16 graph")
        seg = phase_seg_compact(full, reads, cfg, device)
        lap("15 seg_compact")
        s2_launches, s2 = phase_stage2(cfg, gi, db, full, device)
        launches = {k: full_launches[k] + s2_launches[k] for k in REPLACES}
        lap("8 stage 2")
        mesh_launches = phase_mesh(full, reads, cfg, gi, db, device)
        lap("14 mesh")
        with tempfile.TemporaryDirectory() as cache:
            # the auto phases and the CLI probe into a fresh decision cache
            os.environ["CIRCMINER_CACHE_DIR"] = cache
            auto = phase_auto(cfg, gi, db, device)
            lap("9 auto")
            se_rates = phase_se(cfg, gi, db, reads, device)
            lap("10 SE")
            phase_cli()
            lap("11 CLI")
            os.environ.pop("CIRCMINER_CACHE_DIR")
        bench_full, bench_native = phase_bench(device)
        lap("12 bench")
        mini = phase_contigs(device)
        lap("13 --mini")
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib",
                                               "circminer_tpu"))
        check(not leaked, f"JAX or reference modules were imported: "
              f"{leaked[:5]}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    n = wave["n"]

    def rates(r):
        return (f"map {n / r['map_s']:.1f} pairs/s, map+call "
                f"{n / (r['map_s'] + r['circ_s']):.1f} pairs/s")
    fs = full_m["stats"]

    def mini_rate(tag):
        return round(mini[tag]["n"] / mini[tag]["map_s"], 1)
    log(f"[summary] lookup {lookup_ms:.4f} ms/batch; gpu-full "
        f"{rates(full)}, {fs['deferred']}/{fs['reads']} deferred, step "
        f"graph {min(graph['ms']['graph']):.1f} vs eager "
        f"{min(graph['ms']['eager']):.1f} ms/batch, device busy graph "
        f"{100.0 * graph['busy'] / graph['wall']:.2f}% vs eager "
        f"{100.0 * full_m['busy'] / full_m['wall']:.2f}%; gpu-chain "
        f"{rates(chain)}; gpu-wave {rates(wave)}; native {rates(native)}; "
        f"stage 2 on the card {s2['card_s']:.3f} s vs host "
        f"{s2['host_s']:.3f} s; SE reads/s "
        f"{ {k: round(v, 1) for k, v in se_rates.items()} }; auto -> "
        f"{auto['executor']}; bench gpu-full {bench_full['value']} vs "
        f"native {bench_native['value']} reads/s; --mini 3 contigs map "
        f"pairs/s gpu-full {mini_rate('gpu-full')}, native "
        f"{mini_rate('native')}; seg_compact step ms / peak GB False "
        f"{seg[False]['ms']:.1f} / {seg[False]['peak_gb']:.3f}, True "
        f"{seg[True]['ms']:.1f} / {seg[True]['peak_gb']:.3f}; total "
        f"{time.perf_counter() - t_all:.1f} s")
    log(f"[phases] wall seconds {json.dumps(PHASE_S)}")
    log(f"[profiler] {len(PRIMER_LOST)} traced sessions dropped "
        f"{min(PRIMER_LOST)}-{max(PRIMER_LOST)} of their 512 primer "
        f"records (in session order: {PRIMER_LOST})")
    # main_ms: per launch at each row count the gpu-full step sends, and
    # edit_sc's at each row count of the stage-2 waves
    main_shapes.update(s2["shapes"])
    main_shapes.update(tensor_kern)
    main_ms = {name: {str(r["rows"]): r["ms"] for r in main_shapes[name]}
               for name in REPLACES}
    # the launch_tensors kernels (chain DP, fold, walk): ms, plain ms and
    # bound at the main path's recorded inputs (their largest row count)
    for name in SOURCES:
        kern[name] = max(tensor_kern[name], key=lambda r: r["rows"])
    kern["chain_dp"]["buckets"] = buckets
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": SOURCES.get(name, KERNEL_SOURCE),
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": None,
         "chain_floor_ms": kern[name].get("chain_floor_ms"),
         "main_ms": main_ms[name],
         "launches_contigs": mini["gpu-full"]["launches"][name],
         "launches_mesh": mesh_launches[name],
         **({"buckets": kern[name]["buckets"]} if "buckets" in kern[name]
            else {})} for name in REPLACES]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
