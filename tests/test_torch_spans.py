"""The port's host phases as spans (``utils/timing.py::PhaseTimer``) and the
benchmark's readers of them, on the CPU.

Outside a torch.profiler region a phase keeps totals and counts only;
while a profiler records it also keeps its interval on the profiler's
clock, nested phases one each.  A profiled gpu-full library pass of the
benchmark's program (a tiny genome, 160 pairs at 64-pair batches, stage 2
on the device path's plain kernels) records the spans the benchmark reads:
``read_batch`` a batch, stage 2's set-up, its parts and its report.  A
traced run of the harness, its profiler and card calls stubbed on the CPU,
hands them to the readers and names its idle gaps after them."""

import os
import time
import types

import pytest
import torch

from circminer_tpu_torch.utils.timing import GLOBAL_TIMER, PhaseTimer
from cmbench import inputs, program_spans, run as bench_run, trace

TINY = {"library_pairs": 160,
        "genome": {"length": 80_000, "n_genes": 4, "dup_frac": 0.0,
                   "seed": 5},
        "reads": {"read_len": 100, "frag_len": [150, 350],
                  "err_rate": 0.005},
        "config": {"kmer": 20, "max_read_len": 100, "max_ed": 4,
                   "threads": 1},
        "pipeline": {"executor": "gpu-full", "batch_size": 64}}
ENRICHED = {"circ_frac": 0.2, "libraries": 1}
MS = 1_000_000
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture
def global_timer():
    """GLOBAL_TIMER emptied, and so again afterwards."""
    GLOBAL_TIMER.reset()
    yield GLOBAL_TIMER
    GLOBAL_TIMER.reset()


def test_switch_off_keeps_totals_only():
    t = PhaseTimer()
    t0 = time.perf_counter()
    for _ in range(3):
        with t.phase("outer"):
            with t.phase("inner"):
                time.sleep(0.002)
    wall = time.perf_counter() - t0
    t.add("added", 0.5)
    assert t.intervals == []
    assert dict(t.counts) == {"outer": 3, "inner": 3, "added": 1}
    assert 3 * 0.002 <= t.totals["inner"] <= t.totals["outer"] <= wall
    assert t.totals["added"] == 0.5
    assert "outer" in t.report()
    t.reset()
    assert not t.totals and not t.counts and t.intervals == []


def test_switch_on_nests_and_sums_to_the_totals():
    t = PhaseTimer()
    before = time.time_ns()
    with torch.profiler.profile(activities=CPU):
        for _ in range(2):
            with t.phase("outer"):
                time.sleep(0.001)
                with t.phase("inner"):
                    time.sleep(0.002)
    assert [name for name, _, _ in t.intervals] == ["inner", "outer"] * 2
    for (_, a, b), (_, c, d) in zip(t.intervals[::2], t.intervals[1::2]):
        assert before <= c <= a <= b <= d <= time.time_ns()
    for name in ("outer", "inner"):
        spans = [(a, b) for n, a, b in t.intervals if n == name]
        assert t.counts[name] == 2
        assert sum(b - a for a, b in spans) / 1e9 == \
            pytest.approx(t.totals[name], rel=1e-12)
    t.reset()
    assert t.intervals == []


def test_a_profiled_phase_brackets_its_profiler_events():
    """A phase's interval holds a record_function event taken inside it:
    the profiler's clock."""
    t = PhaseTimer()
    with torch.profiler.profile(activities=CPU) as prof:
        for i in range(3):
            with t.phase("host"):
                with torch.profiler.record_function(f"probe{i}"):
                    time.sleep(0.002)
    assert len(t.intervals) == 3
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for i, (_, a, b) in enumerate(t.intervals):
        e = events[f"probe{i}"]
        assert a <= e.start_ns() < e.end_ns() <= b
    with t.phase("host"):
        pass
    assert len(t.intervals) == 3     # the profiler has stopped


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The benchmark's cache directory (genome, indexes, the reference's
    build), moved under the tests' tmp and shared by this file's runs."""
    old = inputs.CACHE
    inputs.CACHE = str(tmp_path_factory.mktemp("cache"))
    yield inputs.CACHE
    inputs.CACHE = old


@pytest.fixture(scope="module")
def library_pass(tmp_path_factory, cache):
    """One gpu-full pass of a tiny library through the benchmark's program,
    under a CPU profiler, so that GLOBAL_TIMER keeps intervals: (pairs, BSJ
    pairs, the ProcessCirc, the intervals, the counts)."""
    work = str(tmp_path_factory.mktemp("libs"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fa, gtf = inputs.genome_files("tiny", TINY)
        (lib,) = inputs.write_libraries(fa, TINY, ENRICHED, 4242, work)
        prog = bench_run.Program(TINY, torch.device("cpu"), "tiny", fa, gtf)
        GLOBAL_TIMER.reset()
        with torch.profiler.profile(activities=CPU):
            pairs, bsj, _, pc = prog.library_pass(
                lib, os.path.join(work, "pass.circ_report"))
        yield (pairs, bsj, pc, list(GLOBAL_TIMER.intervals),
               dict(GLOBAL_TIMER.counts))
    finally:
        GLOBAL_TIMER.reset()
        torch.set_num_threads(n)


def test_map_stream_reads_one_batch_a_span(library_pass):
    """One read_batch a batch, each before the batch's dispatch, and one
    more that finds the end of the source."""
    pairs, _, _, spans, counts = library_pass
    batches = -(-pairs // TINY["pipeline"]["batch_size"])
    assert pairs == TINY["library_pairs"] and batches == 3
    assert counts["read_batch"] == batches + 1
    assert counts["full_dispatch"] == batches
    order = [name for name, _, _ in sorted(spans, key=lambda s: s[1])
             if name in ("read_batch", "full_dispatch")]
    assert order == ["read_batch", "full_dispatch"] * batches \
        + ["read_batch"]


def test_stage2_spans_its_setup_parts_and_report(library_pass):
    _, bsj, pc, spans, counts = library_pass
    assert bsj > 0
    for name in ("circ_init", "circ_load_contig", "circ_dev_setup",
                 "circ_report", "circ_dev_spec", "circ_dev_waves",
                 "circ_dev_select"):
        assert counts[name] >= 1, name
    assert counts["circ_init"] == counts["circ_dev_setup"] == \
        counts["circ_report"] == 1
    assert counts["align_dispatch"] == pc.dev_align_stats["n_dispatch"]
    (setup,) = [(a, b) for n, a, b in spans if n == "circ_dev_setup"]
    warm = [(a, b) for n, a, b in spans if n == "align_dispatch"][0]
    assert setup[0] <= warm[0] <= warm[1] <= setup[1]


def hand_made_run():
    """Two batches and a pass of four BSJ pairs over a 40-ms profiled
    window: the card busy 1-4, 5-6, 10-15 and 30-31 ms (30 ms idle); the
    program's spans around it."""
    device = [("Memcpy HtoD", 1 * MS, 4 * MS, 7),
              ("walk_scan_kernel", 5 * MS, 6 * MS, 7),
              ("xdrop_kernel", 10 * MS, 15 * MS, 9),
              ("edit_end_kernel", 30 * MS, 31 * MS, 40)]
    spans = [("read_batch", 0, 5 * MS),                # idle 0-1, 4-5
             ("circ_dev_spec", 16 * MS, 26 * MS),      # idle 16-26
             ("circ_init", 17 * MS, 18 * MS),          # inside the last
             ("read_batch", -9 * MS, -5 * MS)]         # before the window
    return dict(pairs=128, batches=2, passes=1, bsj_pairs=4,
                timer=dict(totals={"read_batch": 0.1, "full_dispatch": 0.004,
                                   "full_capture": 0.002, "full_fetch": 0.001,
                                   "circ_init": 0.001,
                                   "circ_load_contig": 0.02,
                                   "circ_dev_setup": 0.03,
                                   "circ_dev_spec": 0.008,
                                   "circ_dev_waves": 0.012,
                                   "circ_dev_select": 0.002},
                           counts={"read_batch": 3, "align_dispatch": 6}),
                spans={}, full_stats={"reads": 128, "deferred": 0,
                                      "causes": {}},
                profile=dict(t0_ns=0, t1_ns=40 * MS, device=device,
                             graph_launches=[7, 9]),
                work=None, program_spans=spans)


NEW_READERS = [
    ("io.read_ms_per_batch", 50.0, "read_batch"),
    ("pipeline.dispatch_ms_per_batch", 3.0, "full_dispatch"),
    ("pipeline.fetch_wait_ms_per_batch", 0.5, "full_fetch"),
    ("stage2.fixed_ms_per_pass", 51.0, "circ_init"),
    ("stage2.spec_ms_per_bsj_pair", 2.0, "circ_dev_spec"),
    ("stage2.waves_ms_per_bsj_pair", 3.0, "circ_dev_waves"),
    ("stage2.select_ms_per_bsj_pair", 0.5, "circ_dev_select"),
    ("stage2.dispatches_per_bsj_pair", 1.5, "align_dispatch"),
    ("device.idle_named_pct", 100.0 * 12 / 30, "profile"),
]


@pytest.mark.parametrize("name,want,needs", NEW_READERS)
def test_a_new_reader_reads_its_spans(name, want, needs):
    r = hand_made_run()
    assert bench_run.load_reader(name)(r) == pytest.approx(want)
    if needs == "profile":
        r["profile"] = None
    else:
        r["timer"]["totals"].pop(needs, None)
        r["timer"]["counts"].pop(needs, None)
    assert bench_run.load_reader(name)(r) is None


def test_the_replay_reader_reads_full_replay_per_batch():
    """``pipeline.replay_ms_per_batch``: the host replay's ms a batch, 0.0
    in a window that deferred no read (no ``full_replay`` phase), None in
    a window of no batch or no read."""
    read = bench_run.load_reader("pipeline.replay_ms_per_batch")
    r = hand_made_run()
    assert read(r) == 0.0
    r["timer"]["totals"]["full_replay"] = 0.05
    r["timer"]["counts"]["full_replay"] = 2
    assert read(r) == pytest.approx(25.0)
    r["full_stats"] = {"reads": 0, "deferred": 0, "causes": {}}
    assert read(r) is None
    r = hand_made_run()
    r["batches"] = 0
    assert read(r) is None


@pytest.mark.parametrize("name,cause", [("pipeline.deferred_xdpool_pct",
                                         "xdpool")])
def test_a_cause_reader_reads_its_share_of_the_reads(name, cause):
    """A deferral cause's reader: the reads that carry the cause over the
    reads (a read may carry several), 0.0 where no read carries it, None
    where the window mapped no read."""
    read = bench_run.load_reader(name)
    r = hand_made_run()
    assert read(r) == 0.0
    r["full_stats"] = {"reads": 128, "deferred": 40,
                       "causes": {cause: 32, "extwalk": 12}}
    assert read(r) == pytest.approx(25.0)
    r["full_stats"]["causes"].pop(cause)
    assert read(r) == 0.0
    r["full_stats"] = {"reads": 0, "deferred": 0, "causes": {}}
    assert read(r) is None


def test_idle_named_pct_reads_the_program_timer(global_timer):
    """Where the run hands no spans (the harness as it is), the reader
    takes the port's GLOBAL_TIMER intervals inside the profiled window,
    which a profiler's region keeps; it fails aloud where the timer kept
    none there, and gives None for a port whose timer keeps no
    intervals."""
    with torch.profiler.profile(activities=CPU):
        t0 = time.time_ns()
        with global_timer.phase("read_batch"):
            time.sleep(0.004)
        time.sleep(0.004)
        t1 = time.time_ns()
    (_, a, b), = global_timer.intervals
    r = hand_made_run()
    del r["program_spans"]
    r["profile"] = dict(t0_ns=t0, t1_ns=t1, device=[("k", t1 - 1, t1, 1)],
                        graph_launches=[])
    want = 100.0 * (b - a) / (t1 - 1 - t0)
    assert bench_run.load_reader("device.idle_named_pct")(r) == \
        pytest.approx(want)
    r["profile"].update(t0_ns=b + 1, device=[("k", t1 - 1, t1, 1)])
    with pytest.raises(RuntimeError, match="profiled window"):
        bench_run.load_reader("device.idle_named_pct")(r)
    global_timer.reset()
    with pytest.raises(RuntimeError, match="profiled window"):
        bench_run.load_reader("device.idle_named_pct")(r)


def test_idle_named_pct_of_a_port_without_intervals(global_timer,
                                                    monkeypatch):
    r = hand_made_run()
    del r["program_spans"]
    monkeypatch.delattr(global_timer, "intervals")
    assert program_spans.kept(r) is None
    assert bench_run.load_reader("device.idle_named_pct")(r) is None


def test_coverage_and_clock_check_of_a_hand_made_pass():
    prof = hand_made_run()["profile"]
    spans = [("read_batch", 0, 2 * MS), ("full_dispatch", 2 * MS, 3 * MS),
             ("read_batch", 3 * MS, 8 * MS),
             ("full_dispatch", 9 * MS, 10 * MS),
             ("read_batch", 10 * MS, 12 * MS)]
    clock = program_spans.clock_check(prof, spans)
    # replay 7 starts at 1 ms, before its dispatch opens; 9 at 10 ms
    assert (clock["replays"], clock["dispatches"], clock["ok"]) == (2, 2, 1)
    cov = program_spans.coverage([("map", 0, 12 * MS)], spans)
    assert cov["map"]["covered_pct"] == pytest.approx(100.0 * 11 / 12)
    assert cov["map"]["uncovered"] == [dict(s=0.001, after="read_batch",
                                            before="full_dispatch")]


def test_a_traced_harness_run_reads_the_program_spans(tmp_path, monkeypatch,
                                                      cache, global_timer):
    """``cmbench.run.run_cell`` traced as on the card, on the CPU (two
    libraries of one batch): the pipeline on the CPU, the card's calls no-ops, ``trace.profiled`` a CPU
    profiler with one device operation at the pass's end.  The run reads
    all nine program metrics, ``trace.idle_gaps`` gets the program's spans
    and names a gap after one, and ``program_spans.reporting`` sees the
    harness's calls of ``trace``: a harness that stopped calling them
    through the module would fail here."""
    class CpuProgram(bench_run.Program):
        def __init__(self, config, device, *args):
            super().__init__(config, torch.device("cpu"), *args)

        def map_bounds(self, lib):
            return dict(bounds={}, steps=0)

    def profiled(fn):
        with torch.profiler.profile(activities=CPU):
            t0 = time.time_ns()
            fn()
            t1 = time.time_ns()
        return dict(t0_ns=t0, t1_ns=t1, graph_launches=[],
                    device=[("xdrop_kernel", t1 - MS // 10, t1, 1)])
    monkeypatch.setattr(bench_run, "Program", CpuProgram)
    monkeypatch.setattr(trace, "profiled", profiled)
    for name, value in (("synchronize", None), ("empty_cache", None),
                        ("reset_peak_memory_stats", None),
                        ("max_memory_allocated", 0),
                        ("get_device_name", "stub")):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, value=value: value)
    names = [name for name, *_ in NEW_READERS]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    found = {}
    try:
        with program_spans.reporting(found):
            res = bench_run.run_cell(
                "tiny", {**TINY, "library_pairs": 64},
                {**ENRICHED, "libraries": 2}, 4242, 0.0, True,
                types.SimpleNamespace(type="cuda"), time.time(),
                str(tmp_path), names)
    finally:
        torch.set_num_threads(n)
    assert res["correct"]
    assert sorted(res["metrics"]) == sorted(names)
    assert res["metrics"]["device.idle_named_pct"]["value"] > 50.0
    program = {"read_batch", "encode", "full_dispatch", "full_fetch",
               "full_writeback", "circ_init", "circ_load_contig",
               "circ_dev_setup", "circ_dev_spec", "circ_dev_waves",
               "circ_dev_select", "circ_report", "align_dispatch"}
    assert any(name in program for name, _ in res["breakdown"]["idle_gaps"])
    assert program <= set(found["program_totals"])
    assert found["gaps"] and found["pass_end_s"] > 0
    for harness in ("map", "stage2"):
        assert found["coverage"][harness]["covered_pct"] > 50.0
