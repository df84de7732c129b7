"""The benchmark of the PyTorch and CUDA port on one H100: read pairs read,
mapped and called per second over whole libraries.

    python3 -m cmbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``cmbench/configs/``:
genome, read geometry, the port's ``Config`` and pipeline) and a traffic
mix (``cmbench/traffic/``: pairs a library, circular share, libraries).
One run:

1. set-up (``setup_s``, from the process's start): the configuration's
   genome, index and annotation (``inputs.py``; cached in
   ``cmbench/.cache/``), the gpu-full pipeline (``DeviceMappingPipeline``
   with ``chain_exec="device-full"``: its ``warmup`` captures the step's
   CUDA graph) and one warm-up pass over a batch of the first library.
   The libraries drawn from ``--seed`` as FASTQ under ``TMPDIR`` are the
   harness's traffic, which no user pays for: their time is left out of
   ``setup_s``;
2. the window: library passes back to back, alternating the libraries,
   until ``--seconds`` have passed (the pass in flight finishes).  A pass
   reads the library with ``read_pairs``, maps it with ``map_stream``,
   selects and sorts its back-splice pairs, calls them with
   ``ProcessCirc(...).run(bsj, device_ext=True)`` and writes the
   ``circ_report``, as the CLI's gpu-full does.  Each pass keeps a hash of
   each pair's state, its events and its report (``compare.outputs``) and
   lets go of the rest, which a collection after the pass frees, so that
   every pass starts from the same heap.  ``pairs_per_s`` is every pair of
   every pass over the window's wall time;
3. with ``--trace 1``, per-layer metrics instead: host spans and the
   pipeline's GLOBAL_TIMER phases over the window, ``torch.profiler``
   (CUDA activity only) over the second pass, and the hand kernels' bounds
   summed over every batch of that pass's library, recorded in eager steps
   after the window (``work/``); each metric is read by its own reader,
   ``cmbench/metrics/<name>.py``;
4. the check (``compare.py``): once the window has closed and the
   device's peak memory is read, the frozen reference (``reference/``)
   maps and calls each library on the host, and every pass of the window
   is held against it, pair by pair.

The last line of standard output is the result as one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error.  A run without a card, or with fewer cards than the cell asks for,
fails and prints no result.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from cmbench import compare, inputs, trace  # noqa: E402

# build and kernel caches of the program and its libraries: fixed paths
# inside the checkout (the port's own nvcc and g++ builds go to its fixed
# build/circminer_tpu_torch/ there)
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def process_start() -> float:
    """The Unix time at which this process started (its start in
    /proc/self/stat, else the time this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return min(_T_IMPORT, btime + ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, StopIteration, IndexError):
        return _T_IMPORT


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="cmbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cuda_device(chips: int):
    """The first card, or SystemExit when CUDA is missing or has fewer
    cards than the cell asks for: a run never falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("cmbench: torch.cuda.is_available() is false; "
                         "the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"cmbench: the cell asks for {chips} card(s), "
                         f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def load_reader(name: str) -> Callable:
    """``cmbench/metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"cmbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """The harness's host spans around its calls into each layer: totals
    over the window, and (name, start_ns, end_ns) intervals while
    ``keep`` is set (the profiled pass)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.keep = False
        self.intervals: List[tuple] = []

    def add(self, name: str, t0_ns: int, t1_ns: int) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + (t1_ns - t0_ns) / 1e9
        if self.keep:
            self.intervals.append((name, t0_ns, t1_ns))


def timed_pairs(it, spans: Optional[Spans]):
    """The pairs of ``it``; with ``spans``, each pull timed as ``io``."""
    if spans is None:
        yield from it
        return
    clock = time.time_ns
    while True:
        t0 = clock()
        pr = next(it, None)
        spans.add("io", t0, clock())
        if pr is None:
            return
        yield pr


class Program:
    """The system under test: the port's gpu-full pipeline and its stage 2,
    set up once for a configuration."""

    def __init__(self, config: dict, device, name: str, fa: str, gtf: str):
        import circminer_tpu_torch as port
        from circminer_tpu_torch.pipeline.device_pipeline import \
            DeviceMappingPipeline
        from circminer_tpu_torch.cli import EXECUTORS
        self.device = device
        self.cfg = inputs.run_config(port, config)
        t0 = time.time()
        self.gi, self.db = inputs.indexed("port", port, name, config,
                                          self.cfg, fa, gtf)
        sys.stderr.write(f"[cmbench] the port's index and annotation: "
                         f"{time.time() - t0:.3f} s\n")
        chain_exec, extend_exec = EXECUTORS[config["pipeline"]["executor"]]
        self.pipe = DeviceMappingPipeline(
            self.db, self.gi, self.cfg,
            batch_size=config["pipeline"]["batch_size"],
            chain_exec=chain_exec, extend_exec=extend_exec, device=device)
        self.pipe.warmup()

    def library_pass(self, lib: dict, out_path: str,
                     spans: Optional[Spans] = None, limit: int = None):
        """One pass over a library: read, map, select and sort the BSJ
        pairs, call them on the device, write the report.  Returns (pairs,
        BSJ pairs, each pair's MatchedRead in library order, the
        ProcessCirc)."""
        import torch
        from circminer_tpu_torch.config import CHI2BSJ, CHIBSJ
        from circminer_tpu_torch.io.fastq import read_pairs
        from circminer_tpu_torch.pipeline.circ import ProcessCirc
        recs = []

        def source():
            it = read_pairs(lib["r1"], lib["r2"], self.cfg)
            if limit is not None:
                it = itertools.islice(it, limit)
            for pr in timed_pairs(it, spans):
                recs.append(pr)
                yield pr
        clock = time.time_ns
        t0 = clock()
        n = self.pipe.map_stream(source())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = clock()
        bsj = [(r1, r2) for r1, r2 in recs if r1.mr.type in (CHIBSJ,
                                                              CHI2BSJ)]
        for r1, _ in bsj:
            r1.mr.genome_spos = r1.mr.spos_r1
        bsj.sort(key=lambda pr: pr[0].mr.genome_spos)
        pc = ProcessCirc(self.db, self.gi, self.cfg, out_path + ".prefix",
                         device=self.device)
        pc.run(bsj, device_ext=True)
        pc.report_events(out_path)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = clock()
        if spans is not None:
            spans.add("map", t0, t1)
            spans.add("stage2", t1, t2)
        return n, len(bsj), [r1.mr for r1, _ in recs], pc

    def map_bounds(self, lib: dict) -> dict:
        """The hand kernels' bounds over a map of the whole library in
        eager steps, each launch counted on its own inputs: {"bounds":
        {kernel: ms summed over the steps}, "steps": steps}."""
        from circminer_tpu_torch.io.fastq import read_pairs
        from cmbench.work import record
        dp, tensors, bounds = {}, {}, {}
        self.pipe.step_graph = False       # a replay calls no wrapper
        try:
            with record.recording(dp, tensors, bounds):
                self.pipe.map_stream(read_pairs(lib["r1"], lib["r2"],
                                                self.cfg))
        finally:
            self.pipe.step_graph = True
        steps = sum(e["count"] for (name, _), e in tensors.items()
                    if name == "chain_cells")
        return dict(bounds=bounds, steps=steps)


def reference_outputs(config: dict, name: str, fa: str, gtf: str,
                      libs: List[dict], out_dir: str,
                      cfg_change: Optional[dict] = None
                      ) -> Dict[int, compare.Outputs]:
    """The frozen reference's outputs of each library: host C++ mapping,
    BSJ select and sort, host stage 2, report.  ``cfg_change`` alters the
    reference's Config (the control)."""
    import cmbench.reference as ref
    from cmbench.reference.config import CHI2BSJ, CHIBSJ
    from cmbench.reference.io.fastq import read_pairs
    from cmbench.reference.native_map import NativeMapper
    from cmbench.reference.pipeline.circ import ProcessCirc
    cfg = inputs.run_config(ref, config)
    gi, db = inputs.indexed("reference", ref, name, config, cfg, fa, gtf)
    # every core: the engines' outputs do not depend on the thread count
    cfg = ref.config.Config(**{**cfg.__dict__, "threads": 0,
                               **(cfg_change or {})}).validate()
    mapper = NativeMapper(db, gi, cfg, config["pipeline"]["batch_size"])
    out = {}
    for i, lib in enumerate(libs):
        recs = list(read_pairs(lib["r1"], lib["r2"], cfg))
        mapper.map_pairs(recs)
        bsj = [(r1, r2) for r1, r2 in recs if r1.mr.type in (CHIBSJ,
                                                              CHI2BSJ)]
        for r1, _ in bsj:
            r1.mr.genome_spos = r1.mr.spos_r1
        bsj.sort(key=lambda pr: pr[0].mr.genome_spos)
        path = os.path.join(out_dir, f"ref{i}.circ_report")
        pc = ProcessCirc(db, gi, cfg, path + ".prefix")
        pc.run(bsj)
        pc.report_events(path)
        with open(path, "rb") as f:
            out[i] = compare.outputs([r1.mr for r1, _ in recs],
                                     pc.circ_res, pc.candid_lines, f.read(),
                                     keep_states=True)
    return out


def run_cell(name: str, config: dict, traffic: dict, seed: int,
             seconds: float, trace_on: bool, device, t_start: float,
             work_dir: str, per_layer: Optional[List[str]] = None) -> dict:
    """One run of a cell (everything but the look for a card); returns
    the result's object.  ``per_layer`` names the metrics that a traced
    run reads."""
    import torch
    from circminer_tpu_torch.utils.timing import GLOBAL_TIMER
    on_card = device.type == "cuda"
    stamps = [("start", t_start), ("imports", time.time())]
    fa, gtf = inputs.genome_files(name, config)
    stamps.append(("genome", time.time()))
    libs = inputs.write_libraries(fa, config, traffic, seed, work_dir)
    stamps.append(("libraries", time.time()))
    traffic_s = stamps[-1][1] - stamps[-2][1]
    prog = Program(config, device, name, fa, gtf)
    stamps.append(("pipeline", time.time()))
    # warm-up: one batch of the first library through the whole pass
    prog.library_pass(libs[0], os.path.join(work_dir, "warm.circ_report"),
                      limit=prog.pipe.batch)
    stamps.append(("warm pass", time.time()))
    sys.stderr.write("[cmbench] set-up s: " + ", ".join(
        f"{n} {b - a:.3f}" for (_, a), (n, b) in zip(stamps, stamps[1:]))
        + " (libraries not in setup_s)\n")
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    gc.collect()
    gc.freeze()        # set-up's objects: no collection walks them again
    gc.disable()
    spans = Spans() if trace_on else None
    prof = None
    passes, libs_of, pass_s = [], [], []
    n_pairs = n_bsj = n_batches = 0
    prog.pipe.reset_stats()
    GLOBAL_TIMER.reset()
    setup_s = time.time() - t_start - traffic_s
    t0 = time.perf_counter()
    while True:
        k = len(passes)
        lib = k % len(libs)
        out = os.path.join(work_dir, f"pass{k}.circ_report")

        def one_pass(lib=lib, out=out):
            return prog.library_pass(libs[lib], out, spans)
        if trace_on and k == 1 and on_card:
            spans.keep = True
            box = []
            prof = trace.profiled(lambda: box.append(one_pass()))
            spans.keep = False
            n, nb, mrs, pc = box.pop()
        else:
            n, nb, mrs, pc = one_pass()
        with open(out, "rb") as f:
            passes.append(compare.outputs(mrs, pc.circ_res, pc.candid_lines,
                                          f.read(),
                                          keep_states=lib not in libs_of))
        os.remove(out)
        del mrs, pc
        gc.collect()   # what the pass left in cycles, as a CLI run frees it
        pass_s.append(time.perf_counter() - t0 - sum(pass_s))
        libs_of.append(lib)
        n_pairs += n
        n_bsj += nb
        n_batches += -(-n // prog.pipe.batch)
        # every library at least once, and the profiled pass in a trace
        if time.perf_counter() - t0 >= seconds and len(passes) >= len(libs):
            break
    window_s = time.perf_counter() - t0
    sys.stderr.write(f"[cmbench] window {window_s:.3f} s, {len(passes)} "
                     f"passes, {n_pairs} pairs, {n_bsj} BSJ pairs; pass s: "
                     + " ".join(f"{x:.3f}" for x in pass_s) + "\n")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    timer = dict(totals=dict(GLOBAL_TIMER.totals),
                 counts=dict(GLOBAL_TIMER.counts))
    full_stats = dict(prog.pipe.full_stats)
    gc.enable()
    gc.unfreeze()
    result = dict(correct=False, attempted=n_pairs, failed=0, metrics={})
    if trace_on:
        work = None
        if prof is not None:
            # the profiled pass's library, batch for batch
            t_w = time.perf_counter()
            work = prog.map_bounds(libs[1 % len(libs)])
            sys.stderr.write(f"[cmbench] bounds of {work['steps']} eager "
                             f"steps: {time.perf_counter() - t_w:.3f} s\n")
        run = dict(pairs=n_pairs, batches=n_batches, passes=len(passes),
                   bsj_pairs=n_bsj, timer=timer, spans=dict(spans.totals),
                   full_stats=full_stats, profile=prof, work=work)
        for metric in per_layer or []:
            spec = next(m for m in inputs.load_benchmark()["per_layer"]
                        if m["name"] == metric)
            value = load_reader(metric)(run)
            if value is not None:
                result["metrics"][metric] = dict(value=value,
                                                 unit=spec["unit"])
        if prof is not None:
            result["breakdown"] = dict(
                device_ops=trace.top_ops(prof),
                idle_gaps=trace.idle_gaps(prof, spans.intervals))
    else:
        result["metrics"] = dict(
            pairs_per_s=dict(value=n_pairs / window_s, unit="pairs/s"),
            setup_s=dict(value=setup_s, unit="s"))
    result["device"] = dict(
        platform="gpu" if on_card else device.type,
        kind=torch.cuda.get_device_name(device) if on_card else "cpu",
        count=1, memory_peak_bytes=int(peak))
    if trace_on and prof is not None:
        result["device"].update(busy_s=trace.window_busy_s(prof),
                                window_s=trace.window_s(prof))
    # the check: the program's state freed first, then the reference
    del prog
    if on_card:
        torch.cuda.empty_cache()
    wants = reference_outputs(config, name, fa, gtf, libs, work_dir)
    checks = compare.judge(
        passes, libs_of, wants,
        log=lambda line: sys.stderr.write(f"[cmbench] {line}\n"))
    result["failed"] = checks["pair_mismatches"]
    result["correct"] = all(checks[k] <= lim
                            for k, lim in compare.LIMITS.items())
    result["checks"] = {k: dict(value=v, limit=compare.LIMITS[k])
                        for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    t_start = process_start()
    args = parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(inputs.CACHE, sub)
    bench = inputs.load_benchmark()
    w, config, traffic = inputs.cell(bench, args.workload)
    device = cuda_device(w["chips"])
    per_layer = [m["name"] for m in bench["per_layer"]
                 if args.workload in m.get("workloads", [args.workload])]
    work_dir = tempfile.mkdtemp(prefix="cmbench_")
    try:
        result = run_cell(w["config"], config, traffic, args.seed,
                          args.seconds, bool(args.trace), device, t_start,
                          work_dir, per_layer)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    bad = compare.forbidden_modules(sys.modules)
    if bad:
        sys.stderr.write(f"cmbench: modules loaded that the run may not "
                         f"hold: {', '.join(bad)}\n")
        return 3
    for k, c in result["checks"].items():
        sys.stderr.write(f"check {k} {c['value']} limit {c['limit']}\n")
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
