"""Benchmark of the torch port: paired-end reads/s for the full map + call.

    python -m circminer_tpu_torch.bench [--smoke|--toy|--chr21]
        [--exec auto|gpu|gpu-chain|gpu-full|gpu-wave|native] [--circ-device]
        [--repeat N] [--sweep-ed LO..HI] [--dump-events PATH]
        [--torch-device cuda|cpu]

The counterpart of the reference's root ``bench.py``: the same simulated
genome, annotation and read set (seeds 20260817 / 20260818,
``Config(kmer=20, max_read_len=120, threads=0)``; the chr21 configuration
by default: 47 Mbp, 783 genes, 5% segmental duplications, 1 M pairs), the
same timed region (map, then stage 2 on the sorted BSJ reads) and the same
JSON keys.  It prints one JSON line on stdout (one per e, then none, with
--sweep-ed):

  {"metric": "pe_reads_per_sec_chip_map_call", "value": N, "unit":
   "reads/s", "vs_baseline": N, "executor": ..., "backend": ..., ...}

``--exec`` names the port's executors (``cli.EXECUTORS``); ``backend`` is
the torch device type.  Each repeat maps fresh read state with fresh
pipeline statistics, and every number of the line (events, deferral,
phases) comes from the run whose time is reported.  Setup (genome, index,
annotation) is made anew each run and reported apart.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import sys
import tempfile
import time

import numpy as np

BASELINE_READS_PER_SEC = 10_000.0
METRIC = "pe_reads_per_sec_chip_map_call"


def parse_args(argv=None):
    from .cli import EXECUTORS
    ap = argparse.ArgumentParser(prog="circminer_tpu_torch.bench")
    ap.add_argument("--smoke", action="store_true", help="small quick run")
    ap.add_argument("--toy", action="store_true",
                    help="the 5 Mbp / 20K-pair toy configuration")
    ap.add_argument("--chr21", action="store_true",
                    help="chr21-scale run: 47 Mbp genome, ~780 genes, 5%% "
                         "segmental duplications, 1M read pairs (the "
                         "default when no size flag is given)")
    ap.add_argument("--n-reads", type=int, default=None)
    ap.add_argument("--genome-len", type=int, default=None)
    ap.add_argument("--err-rate", type=float, default=0.005)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                    help="torch device of the device executors (cpu runs "
                         "their plain torch versions)")
    ap.add_argument("--dump-events", default=None, metavar="PATH",
                    help="write called + true event coordinates (JSON) for "
                         "offline FP/FN analysis")
    ap.add_argument("--circ-device", action="store_true",
                    help="run the stage-2 extension DPs on the torch device "
                         "(speculate-and-select waves; equal outputs)")
    ap.add_argument("--sweep-ed", default=None, metavar="LO..HI",
                    help="run the whole map+call once per max edit distance "
                         "e in LO..HI; one JSON line per e")
    ap.add_argument("--repeat", type=int, default=None,
                    help="run the timed map+call region N times on fresh "
                         "read state and report the best (default 3 for the "
                         "chr21 configuration, 1 for --smoke/--toy/"
                         "--dump-events)")
    ap.add_argument("--exec", dest="executor", default="auto",
                    choices=sorted(EXECUTORS),
                    help="the port's mapping executor (as the CLI's "
                         "--device)")
    return ap.parse_args(argv)


def setup(genome_len, n_genes, dup_frac, cfg):
    """The reference bench's genome, index and annotation."""
    from .annotation.annotation import AnnotationDB
    from .index.build import build_genome_index
    from .io.fasta import GenomePacker
    from .sim import make_genome
    rng = np.random.default_rng(20260817)
    g = make_genome(rng, length=genome_len, n_genes=n_genes,
                    dup_frac=dup_frac)
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.fa")
        gtf = os.path.join(tmp, "ref.gtf")
        g.write_fasta(ref)
        g.write_gtf(gtf)
        contigs, info = GenomePacker(ref).pack_genome()
        gi = build_genome_index(contigs, cfg)
        db = AnnotationDB.from_gtf(gtf, info, len(contigs), cfg,
                                   contig_lengths=[len(c) for c in contigs])
    return g, gi, db


def make_pair(r, max_ed):
    from .ops.encode import encode_seq, revcomp
    from .pipeline.mapping import ReadRecord
    from .pipeline.types import MatchedRead
    s1, s2 = encode_seq(r.r1), encode_seq(r.r2)
    return (ReadRecord(r.name, s1, revcomp(s1), "I" * len(r.r1), len(r.r1),
                       MatchedRead.default(max_ed)),
            ReadRecord(r.name, s2, revcomp(s2), "I" * len(r.r2), len(r.r2),
                       None))


def run_once(pipe, db, gi, cfg, reads, truth, circ_device, device):
    """One timed map + call on fresh read state; returns the run's record."""
    import torch
    from .config import CHI2BSJ, CHIBSJ, CONCRD
    from .utils.timing import GLOBAL_TIMER as T
    from .pipeline.circ import ProcessCirc
    pairs = [make_pair(r, cfg.max_ed) for r in reads]
    pipe.reset_stats()
    T.reset()
    t0 = time.time()
    n = pipe.map_stream(iter(pairs))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    map_s = time.time() - t0
    t0 = time.time()
    with T.phase("circ_select"):
        bsj = [(r1, r2) for r1, r2 in pairs
               if r1.mr.type in (CHIBSJ, CHI2BSJ)]
        for r1, _ in bsj:
            r1.mr.genome_spos = r1.mr.spos_r1
        bsj.sort(key=lambda pr: pr[0].mr.genome_spos)
    with tempfile.TemporaryDirectory() as tmp:
        pc = ProcessCirc(db, gi, cfg, os.path.join(tmp, "bench_out"),
                         device=device)
        pc.run(bsj, device_ext=circ_device)
    circ_s = time.time() - t0
    called = sorted({(c.spos, c.epos) for c in pc.circ_res})
    truth_set = set(truth)
    sv = pipe.align_svc
    return dict(
        rps=n / (map_s + circ_s) if map_s + circ_s > 0 else 0.0,
        map_s=map_s, circ_s=circ_s, n=n,
        conc=sum(1 for r1, _ in pairs if r1.mr.type == CONCRD),
        bsj=len(bsj), called=called,
        matched=sum(1 for e in called if e in truth_set),
        support={f"{c.spos},{c.epos}": getattr(c, "nreads", 1)
                 for c in pc.circ_res},
        full_stats=copy.deepcopy(pipe.full_stats),
        wave_stats=dict(pipe.wave_stats),
        svc=(sv.n_dispatch, sv.n_device, sv.n_host) if sv else None,
        circ_dev=getattr(pc, "dev_align_stats", None),
        phases=T.report())


def main(argv=None) -> int:
    args = parse_args(argv)
    from .config import Config
    from .sim import simulate_reads
    from .cli import EXECUTORS
    from .device import resolve_device
    from .pipeline.device_pipeline import DeviceMappingPipeline

    device = resolve_device(args.torch_device)
    if args.smoke:
        n_reads = args.n_reads or 500
        genome_len = args.genome_len or 100_000
        dup_frac = 0.0
    elif args.toy:
        n_reads = args.n_reads or 20_000
        genome_len = args.genome_len or 5_000_000
        dup_frac = 0.0
    else:
        # chr21 scale is the default bench (BASELINE.md config 1)
        n_reads = args.n_reads or 1_000_000
        genome_len = args.genome_len or 47_000_000
        dup_frac = 0.05
    n_genes = max(3, genome_len // 60_000)
    # threads=0 -> every core (the reference's `-t <big>` clamp semantics)
    cfg = Config(kmer=20, max_read_len=120, threads=0)
    t0 = time.time()
    g, gi, db = setup(genome_len, n_genes, dup_frac, cfg)
    setup_s = time.time() - t0
    n_circ = n_reads // 5
    reads, truth = simulate_reads(np.random.default_rng(20260818), g,
                                  n_reads - n_circ, n_circ, read_len=100,
                                  err_rate=args.err_rate)
    chain_exec, extend_exec = EXECUTORS[args.executor]
    # the read set keeps millions of numpy objects alive; everything here
    # is refcount-managed, so the cyclic collector is pure run-to-run noise
    gc.disable()

    def pipeline(cfg_run):
        pipe = DeviceMappingPipeline(db, gi, cfg_run, batch_size=args.batch,
                                     chain_exec=chain_exec,
                                     extend_exec=extend_exec, device=device)
        t0 = time.time()
        pipe.warmup()
        return pipe, time.time() - t0

    def executor_name(pipe):
        """The executor that ran (auto reports its choice)."""
        ran = (pipe.chain_exec, pipe.extend_exec)
        return next(k for k, v in EXECUTORS.items() if v == ran)

    if args.sweep_ed:
        lo, hi = (int(x) for x in args.sweep_ed.split(".."))
        for e in range(lo, hi + 1):
            cfg_e = Config(**{**cfg.__dict__, "max_ed": e}).validate()
            pipe, _ = pipeline(cfg_e)
            r = run_once(pipe, db, gi, cfg_e, reads, truth,
                         args.circ_device, device)
            rec = {"metric": METRIC, "max_ed": e, "value": round(r["rps"], 2),
                   "unit": "reads/s", "executor": executor_name(pipe),
                   "backend": device.type, "n_pairs": r["n"],
                   "conc": r["conc"], "bsj_reads": r["bsj"],
                   "events": len(r["called"]), "true_events": len(truth),
                   "events_matched": r["matched"],
                   "phases": {"map_s": round(r["map_s"], 2),
                              "circ_s": round(r["circ_s"], 2)}}
            # the baseline is calibrated for the default max_ed = 4
            if e == cfg.max_ed:
                rec["vs_baseline"] = round(r["rps"] / BASELINE_READS_PER_SEC,
                                           4)
            print(json.dumps(rec), flush=True)
            del pipe
        return 0

    pipe, warm_s = pipeline(cfg)
    repeat = args.repeat
    if repeat is None:
        repeat = 1 if (args.smoke or args.toy or args.dump_events) else 3
    runs = [run_once(pipe, db, gi, cfg, reads, truth, args.circ_device,
                     device) for _ in range(max(1, repeat))]
    best = max(runs, key=lambda r: r["rps"])

    if args.dump_events:
        with open(args.dump_events, "w") as f:
            json.dump({"called": [list(e) for e in best["called"]],
                       "truth": [list(e) for e in truth],
                       "support": best["support"]}, f)
    fs = best["full_stats"]
    if fs["reads"]:
        sys.stderr.write(
            f"[bench] device-full: {fs['reads']} reads, {fs['deferred']} "
            f"deferred to host ({100.0 * fs['deferred'] / fs['reads']:.1f}%)"
            f"\n")
        if fs["causes"]:
            hist = ", ".join(f"{k}={v}" for k, v in sorted(
                fs["causes"].items(), key=lambda kv: -kv[1]))
            sys.stderr.write(f"[bench] defer causes: {hist}\n")
    sys.stderr.write(
        f"[bench] backend={device.type} executor={executor_name(pipe)} "
        f"reads={best['n']} genome={genome_len} setup={setup_s:.1f}s "
        f"warm={warm_s:.1f}s map={best['map_s']:.1f}s "
        f"circ={best['circ_s']:.1f}s CONCRD={best['conc']} "
        f"BSJ={best['bsj']} events={len(best['called'])} (true events="
        f"{len(truth)}, matched={best['matched']})\n")
    sys.stderr.write(best["phases"] + "\n")
    ws = best["wave_stats"]
    if ws["batches"]:
        nd, ndev, nhost = best["svc"]
        sys.stderr.write(
            f"[bench] wave engine: {ws['waves']} waves / {ws['batches']} "
            f"batches ({ws['waves'] / ws['batches']:.1f}/batch), {nd} "
            f"dispatches, {ndev} device / {nhost} host requests\n")
    if best["circ_dev"]:
        st = best["circ_dev"]
        sys.stderr.write(
            f"[bench] stage-2 device extension: {st['n_dispatch']} "
            f"dispatches, {st['n_device']} device / {st['n_host']} host "
            f"requests\n")

    rps = best["rps"]
    rec = {
        "metric": METRIC,
        "value": round(rps, 2),
        "unit": "reads/s",
        "vs_baseline": round(rps / BASELINE_READS_PER_SEC, 4),
        "executor": executor_name(pipe),
        "backend": device.type,
        "n_pairs": best["n"],
        "genome_len": genome_len,
        "events": len(best["called"]),
        "true_events": len(truth),
        "events_matched": best["matched"],
        "phases": {"setup_s": round(setup_s, 2), "warm_s": round(warm_s, 2),
                   "map_s": round(best["map_s"], 2),
                   "circ_s": round(best["circ_s"], 2)},
    }
    if len(runs) > 1:
        rvals = [round(r["rps"], 2) for r in runs]
        rec["runs"] = rvals
        rec["spread_pct"] = round(
            100.0 * (max(rvals) - min(rvals)) / max(rvals), 1)
    if fs["reads"]:
        rec["deferred_pct"] = round(100.0 * fs["deferred"] / fs["reads"], 1)
        rec["defer_causes"] = fs["causes"]
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
