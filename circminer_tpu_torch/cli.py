"""Command-line interface of the torch port.

Takes every flag of the reference's CLI (``circminer_tpu/cli.py``), with
the port's executors:

    python -m circminer_tpu_torch.cli --index -r ref.fa -k 20
    python -m circminer_tpu_torch.cli -r ref.fa -g ref.gtf -1 R1.fq -2 R2.fq \\
        -o out --pam [--device auto] [--torch-device cuda|cpu]
    python -m circminer_tpu_torch.cli -r ref.fa -g ref.gtf -s R.fq -o out --pam

``--device``: ``auto`` (default) = ``gpu`` or ``native``, whichever a short
probe at start-up (or its cached result, or ``CIRCMINER_EXECUTOR``) finds
faster on this host; ``gpu`` = seed lookup on the torch device, chaining
and the finish in host C++; ``gpu-chain`` = lookup and chain DP on the
device, k-best extraction and the finish in host C++; ``gpu-full`` = the
whole map step on the device (the fused device-full step), deferred reads
replayed in host C++, and the stage-2 extension DPs on the device too;
``gpu-wave`` = the lookup of ``auto`` plus wave-batched extension on the
hand-written DP kernels; ``native`` = everything in host C++; ``host`` =
the per-read Python oracle.  ``--torch-device`` picks the torch device of
the device executors (``cuda`` by default; ``cpu`` runs their plain torch
versions).  ``--trace-dir`` (or ``CIRCMINER_TRACE_DIR``) writes a
torch.profiler Chrome trace of the search stages.

Multi-host runs (``--num-hosts N --host-id h``, with ``--coordinator
host:port`` for a gloo process group; see ``parallel/distributed.py``):
host h maps pairs h, h+N, ... of the input into ``OUT.h<h>.*``; host 0
waits for every host's remain shard and runs stage 2 over all of them,
writing the single ``OUT.circ_report``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

from .config import (Config, CONCRD, CHIBSJ, CHI2BSJ, DISCARDMAPREPORT,
                     PAMFORMAT, SAMFORMAT)

# --device -> (chain_exec, extend_exec) of the port's pipeline; "host" (the
# per-read oracle) runs no pipeline
EXECUTORS = {"auto": ("auto", "native"),
             "gpu": ("device", "native"),
             "gpu-chain": ("device-chain", "native"),
             "gpu-full": ("device-full", "native"),
             "gpu-wave": ("auto", "device"),
             "native": ("native", "native")}


def build_parser() -> argparse.ArgumentParser:
    # the reference's flags (circminer_tpu/cli.py build_parser), with the
    # port's executors for --device and the port's own options
    p = argparse.ArgumentParser(
        prog="circminer-torch",
        description="circRNA detection, PyTorch + CUDA port of circminer-tpu")
    p.add_argument("-i", "--index", action="store_true")
    p.add_argument("-m", "--compact-index", action="store_true")
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-g", "--gtf")
    p.add_argument("-s", "--seq")
    p.add_argument("-1", "--seq1", dest="seq1")
    p.add_argument("-2", "--seq2", dest="seq2")
    p.add_argument("-k", "--kmer", type=int, default=20)
    p.add_argument("-l", "--rlen", type=int, default=300)
    p.add_argument("-o", "--output", default="output")
    p.add_argument("-t", "--thread", type=int, default=1)
    p.add_argument("-d", "--verbosity", type=int, default=0)
    p.add_argument("-a", "--scan-lev", type=int, default=0)
    p.add_argument("-e", "--max-ed", type=int, default=4)
    p.add_argument("-c", "--max-sc", type=int, default=7)
    p.add_argument("-w", "--band", type=int, default=3)
    p.add_argument("-S", "--seed-lim", type=int, default=500)
    p.add_argument("-T", "--max-tlen", type=int, default=500)
    p.add_argument("-I", "--max-intron", type=int, default=2_000_000)
    p.add_argument("-C", "--max-chain-list", type=int, default=30)
    p.add_argument("-q", "--stage", type=int, default=2)
    p.add_argument("-z", "--keep-intermediate", action="store_true")
    p.add_argument("-Z", "--internal-sort", action="store_true")
    p.add_argument("-A", "--sam", action="store_true")
    p.add_argument("-P", "--pam", action="store_true")
    p.add_argument("--device", choices=sorted(EXECUTORS) + ["host"],
                   default="auto",
                   help="mapping executor: auto = gpu or native, picked by "
                        "a start-up probe (default); gpu = seed lookup on "
                        "the torch device, chain + finish in host C++; "
                        "gpu-chain = lookup + chain DP on the device; "
                        "gpu-full = the fused map step and the stage-2 "
                        "extension DPs on the device; gpu-wave = auto's "
                        "lookup + wave-batched extension on the CUDA DP "
                        "kernels; native = all host C++; host = per-read "
                        "Python oracle")
    p.add_argument("--mrsfast-format", action="store_true",
                   help="with --index: also write the reference's mrsFAST "
                        "binary index format for interop/parity checks")
    p.add_argument("--coordinator",
                   help="coordinator address (host:port) of a gloo "
                        "process group for multi-host runs; also via "
                        "CIRCMINER_COORDINATOR")
    p.add_argument("--num-hosts", type=int, default=None)
    p.add_argument("--host-id", type=int, default=None)
    p.add_argument("--trace-dir",
                   help="write a torch.profiler Chrome trace of the search "
                        "stages here (also CIRCMINER_TRACE_DIR)")
    p.add_argument("--batch-size", type=int, default=4096,
                   help="reads or read pairs per device batch (the fused "
                        "gpu-full step sizes its DP pools from it)")
    p.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device of the device executors (cpu runs "
                        "their plain torch versions)")
    return p


def config_from_args(args) -> Config:
    report = SAMFORMAT if args.sam else (PAMFORMAT if args.pam
                                         else DISCARDMAPREPORT)
    return Config(
        kmer=args.kmer, max_read_len=args.rlen, max_ed=args.max_ed,
        max_sc=args.max_sc, band_width=args.band, seed_lim=args.seed_lim,
        max_tlen=args.max_tlen, max_intron=args.max_intron,
        max_chain_len=args.max_chain_list, scan_level=args.scan_lev,
        stage=args.stage, report_mapping=report,
        paired_end=args.seq2 is not None,
        compact_index=args.compact_index,
        final_cleaning=not args.keep_intermediate,
        internal_sort=args.internal_sort, threads=args.thread,
    ).validate()


def run_index(args, cfg: Config) -> int:
    from .io.fasta import GenomePacker
    from .index.build import build_genome_index, save_genome_index
    gp = GenomePacker(args.reference)
    print("[INFO] packing reference genome...", file=sys.stderr)
    contigs, info = gp.pack_genome()
    print(f"[INFO] building index over {len(contigs)} contig(s)...",
          file=sys.stderr)
    gi = build_genome_index(contigs, cfg)
    save_genome_index(gi, gp.index_fname, compact=cfg.compact_index)
    print(f"[INFO] index written to {gp.index_fname}.npz", file=sys.stderr)
    if args.mrsfast_format:
        from .index.mrsfast_format import write_mrsfast_index
        write_mrsfast_index(gi, gp.index_fname,
                            full=not cfg.compact_index)
        print(f"[INFO] mrsFAST-format index written to {gp.index_fname}",
              file=sys.stderr)
    return 0


def run_search(args, cfg, hooks=None) -> int:
    import torch.distributed as dist
    from .utils.timing import device_trace
    had_group = dist.is_initialized()
    try:
        with device_trace(args.trace_dir):
            return _run_search_stages(args, cfg, hooks or {})
    finally:
        # a coordinated run destroys the process group it made, and only
        # that one: a caller's own group outlives the call
        if dist.is_initialized() and not had_group:
            dist.destroy_process_group()


def _host_mappers(db, gi, cfg, n_contigs):
    from .pipeline.mapping import Mapper, make_host_seeder
    return [Mapper(db, c, gi.contigs[c].codes, cfg,
                   make_host_seeder(gi.contigs[c], cfg))
            for c in range(n_contigs)]


def _run_search_stages(args, cfg, hooks) -> int:
    import os
    import time
    from .annotation.annotation import AnnotationDB
    from .index.build import load_genome_index
    from .io.fasta import GenomePacker, chrloc2conloc
    from .io.fastq import (FastqReader, RemainWriter, iter_sorted_remain,
                           read_pairs)
    from .pipeline.output import SamOutput
    from .pipeline.types import round_skip
    from .utils.logging import set_trace_level
    from .pipeline.circ import ProcessCirc
    from .pipeline.device_pipeline import DeviceMappingPipeline
    from .parallel.distributed import (maybe_initialize, stripe_pairs,
                                       shard_output_prefix)

    def hook(point, obj):
        if point in hooks:
            hooks[point](obj)

    set_trace_level(args.verbosity)
    host_id, n_hosts = maybe_initialize(args.coordinator, args.num_hosts,
                                        args.host_id)
    if n_hosts > 1:
        import torch.distributed as dist
        print(f"[INFO] host {host_id} of {n_hosts}"
              + (" (gloo process group)" if dist.is_initialized() else ""),
              file=sys.stderr)
    out_prefix = shard_output_prefix(args.output, host_id, n_hosts)
    gp = GenomePacker(args.reference)
    info = gp.load_index_info()
    if os.path.exists(gp.index_fname + ".npz"):
        gi = load_genome_index(gp.index_fname)
    else:
        from .index.mrsfast_format import read_mrsfast_index
        gi = read_mrsfast_index(gp.index_fname)
    cfg = Config(**{**cfg.__dict__, "kmer": gi.kmer})
    n_contigs = GenomePacker.packed_contig_cnt(info)
    print(f"[INFO] loaded index: {n_contigs} contig(s), kmer={gi.kmer}",
          file=sys.stderr)
    db = AnnotationDB.from_gtf(
        args.gtf, info, n_contigs, cfg,
        contig_lengths=[c.length for c in gi.contigs])
    print("[INFO] GTF loaded", file=sys.stderr)
    fmt = {SAMFORMAT: "sam", PAMFORMAT: "pam"}.get(cfg.report_mapping)
    last_round = n_contigs

    def pipeline(chain_exec, extend_exec):
        pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=args.batch_size,
                                     chain_exec=chain_exec,
                                     extend_exec=extend_exec,
                                     device=args.torch_device)
        pipe.warmup()
        return pipe

    if not cfg.paired_end:
        # single-end (filter.cpp:86-121; circminer.cpp:399-402); no circ
        # stage: back-splice evidence needs a paired full mate
        out = SamOutput(args.output, fmt, info)
        if args.device != "host":
            # SE has no wave finish: gpu-wave maps as auto, as in the
            # reference
            pipe = pipeline(EXECUTORS[args.device][0], "native")
            n = pipe.map_stream_se(FastqReader(args.seq, cfg), out, fmt)
        else:
            mappers = _host_mappers(db, gi, cfg, n_contigs)
            n = 0
            for rec in FastqReader(args.seq, cfg):
                for mapper in mappers:
                    state = mapper.process_read_se(rec)
                    if cfg.scan_level == 0 and state == CONCRD:
                        break
                if fmt == "sam":
                    out.write_sam_se(rec)
                elif fmt == "pam":
                    out.write_pam_se(rec)
                n += 1
        out.close()
        print(f"[INFO] SE mapping done: {n} reads", file=sys.stderr)
        return 0

    if cfg.stage != 1:
        out = SamOutput(out_prefix, fmt, info)
        remain = RemainWriter(out_prefix, last_round)

        def conloc(chrname, s, e):
            return chrloc2conloc(db.chr2con, chrname, s, e)

        def pairs_with_ordinal():
            # the circ-stage sort tie-breaks on the global pair ordinal, so
            # a multi-host merge reproduces the single-host stream order;
            # host h maps pairs h, h+N, ... of the stream
            for k, (r1, r2) in stripe_pairs(
                    read_pairs(args.seq1, args.seq2, cfg), host_id, n_hosts,
                    with_index=True):
                r1.ordinal = k
                yield r1, r2

        if args.device != "host":
            pipe = pipeline(*EXECUTORS[args.device])
            hook("mapping", pipe)
            n = pipe.map_stream_all_contigs(pairs_with_ordinal(), out,
                                            remain, conloc)
            hook("mapped", pipe)
            if pipe.wave_stats["batches"]:
                ws, sv = pipe.wave_stats, pipe.align_svc
                print(f"[INFO] wave engine: {ws['waves']} waves over "
                      f"{ws['batches']} batch(es), {sv.n_dispatch} "
                      f"dispatches, {sv.n_device} device / {sv.n_host} host "
                      f"requests", file=sys.stderr)
            fs = pipe.full_stats
            if fs["reads"]:
                print(f"[INFO] device-full: {fs['reads']} reads, "
                      f"{fs['deferred']} deferred to the host "
                      f"{dict(sorted(fs['causes'].items()))}",
                      file=sys.stderr)
        else:
            mappers = _host_mappers(db, gi, cfg, n_contigs)
            n = 0
            for rec1, rec2 in pairs_with_ordinal():
                # every contig in one pass; the per-round skip keeps the
                # scanLevel 0 and 1 semantics (circminer.cpp:386-394)
                for mapper in mappers:
                    mapper.process_read_pe(rec1, rec2)
                    if round_skip(rec1.mr, rec1.seq_len, rec2.seq_len,
                                  cfg.scan_level):
                        break
                if fmt:
                    out.write_pam_pe(rec1, rec2) if fmt == "pam" else \
                        out.write_sam_pe(rec1, rec2)
                if rec1.mr.type in (CHIBSJ, CHI2BSJ):
                    remain.write(rec1, rec2, rec1.mr, conloc)
                n += 1
        out.close()
        remain.close()
        if n_hosts > 1:  # completion sentinel for host 0's shard wait
            with open(f"{out_prefix}_{last_round}_remain.done", "w"):
                pass
        print(f"[INFO] mapping done: {n} pairs", file=sys.stderr)

    if cfg.stage != 0:
        if n_hosts > 1:
            # stage 2 runs on host 0 over every host's remain shard (shared
            # filesystem); the other hosts are done after mapping
            if host_id != 0:
                return 0
            shards = [shard_output_prefix(args.output, h, n_hosts)
                      for h in range(n_hosts)]
            r1p = [f"{p}_{last_round}_remain_R1.fastq" for p in shards]
            r2p = [f"{p}_{last_round}_remain_R2.fastq" for p in shards]
            for p in shards:   # wait for stragglers, as the reference does
                while not os.path.exists(f"{p}_{last_round}_remain.done"):
                    time.sleep(1.0)
        else:
            r1p = f"{args.output}_{last_round}_remain_R1.fastq"
            r2p = f"{args.output}_{last_round}_remain_R2.fastq"
        recs = iter_sorted_remain(r1p, r2p, cfg, internal=cfg.internal_sort)
        # gpu-full also runs the stage-2 extension DPs on the device
        # (speculate-and-select waves), as the reference's tpu-full does
        device_ext = args.device == "gpu-full"
        pc = ProcessCirc(db, gi, cfg, args.output,
                         device=args.torch_device if device_ext else "cpu")
        pc.run(recs, device_ext=device_ext)
        if device_ext:
            st = pc.dev_align_stats
            print(f"[INFO] stage-2 device extension: {st['n_dispatch']} "
                  f"dispatches, {st['n_device']} device / {st['n_host']} "
                  f"host requests", file=sys.stderr)
        pc.report_events(args.output + ".circ_report")
        pc.write_candidates(args.output + ".candidates.pam")
        hook("called", pc)
        print(f"[INFO] circRNA detection done: {len(pc.circ_res)} candidate "
              f"reads, report at {args.output}.circ_report", file=sys.stderr)
    return 0


def main(argv: List[str] = None, hooks: Optional[Dict] = None) -> int:
    """Run the CLI on ``argv``.  ``hooks`` (for an in-process caller that
    measures the paired-end path) maps a point of the search to a callable
    given that stage's object: "mapping" (the pipeline, warmed up, before
    the streamed map), "mapped" (the pipeline, after it) and "called" (the
    ProcessCirc, after stage 2 wrote its report)."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.index:
        return run_index(args, cfg)
    if not args.gtf or (not args.seq and not args.seq1):
        print("error: search mode needs -g and -1/-2 (or -s)",
              file=sys.stderr)
        return 1
    if args.batch_size < 1:
        print("error: --batch-size must be at least 1", file=sys.stderr)
        return 1
    return run_search(args, cfg, hooks)


if __name__ == "__main__":
    sys.exit(main())
