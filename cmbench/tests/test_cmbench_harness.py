"""The harness as data and its gates, on the CPU: BENCHMARK.json's names
and files, traffic per seed, the per-layer readers on a synthetic trace and
timer dump, the module check, the refusal to run without a card, and a
run driven on the CPU with the timed path broken in each way the cells
can break, which has to come out not correct."""

import filecmp
import json
import os
import re
import subprocess
import sys

import pytest

from cmbench import compare, inputs, run, trace
from conftest import ENRICHED, ROOT, TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return inputs.load_benchmark()


def test_names_units_and_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert all(k in cfg for k in c["reduced"])
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "cmbench", "traffic",
                                           w["traffic"] + ".json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(ROOT, "cmbench", "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_traffic_is_deterministic_per_seed(cache, tmp_path):
    fa, _ = inputs.genome_files("tiny", TINY)
    runs = []
    for k, seed in enumerate((2 ** 31 + 11, 2 ** 31 + 11, 5)):
        d = tmp_path / str(k)
        d.mkdir()
        runs.append(inputs.write_libraries(fa, TINY, ENRICHED, seed,
                                           str(d)))
    for a, b in zip(runs[0], runs[1]):
        assert filecmp.cmp(a["r1"], b["r1"], shallow=False)
        assert filecmp.cmp(a["r2"], b["r2"], shallow=False)
    assert not filecmp.cmp(runs[0][0]["r1"], runs[2][0]["r1"],
                           shallow=False)
    # two distinct libraries a seed, each of the configuration's size
    assert not filecmp.cmp(runs[0][0]["r1"], runs[0][1]["r1"],
                           shallow=False)
    with open(runs[0][0]["r1"]) as f:
        assert sum(1 for _ in f) == 4 * TINY["library_pairs"]


def test_generator_draws_what_the_ports_sim_draws():
    """cmbench/sim.py's reads, base for base, are those of the port's
    sim.py on the same genome and seed."""
    import numpy as np
    from circminer_tpu_torch import sim as port
    from cmbench import sim
    g = port.make_genome(np.random.default_rng(5), length=200_000,
                         n_genes=4, dup_frac=0.05)
    import dataclasses
    mine = sim.make_genome(np.random.default_rng(5), length=200_000,
                           n_genes=4, dup_frac=0.05)
    assert dataclasses.asdict(mine) == dataclasses.asdict(g)
    kw = dict(read_len=150, frag_len=(200, 500), err_rate=0.01)
    a = port.simulate_reads(np.random.default_rng(2 ** 40 + 3), g, 600,
                            200, **kw)
    b = sim.simulate_reads(np.random.default_rng(2 ** 40 + 3), g, 600, 200,
                           **kw)
    assert [(r.name, r.r1, r.r2, r.truth, r.circ_bp) for r in a[0]] == \
        [(r.name, r.r1, r.r2, r.truth, r.circ_bp) for r in b[0]]
    assert a[1] == b[1]


def synthetic_run():
    """Two replays (graph launches 7 and 9) of three operations each, one
    a hand kernel, a copy between them and a stage-2 kernel after."""
    ms = 1_000_000
    device = [
        ("Memcpy HtoD (Pinned -> Device)", 0 * ms, 1 * ms, 5),
        ("void walk_scan_kernel(int)", 1 * ms, 3 * ms, 7),
        ("vectorized_gather_kernel", 2 * ms, 4 * ms, 7),
        ("elementwise_kernel", 5 * ms, 6 * ms, 7),
        ("void walk_scan_kernel(int)", 10 * ms, 12 * ms, 9),
        ("vectorized_gather_kernel", 12 * ms, 14 * ms, 9),
        ("elementwise_kernel", 14 * ms, 15 * ms, 9),
        ("void xdrop_kernel(int)", 30 * ms, 31 * ms, 40),
    ]
    prof = dict(t0_ns=0, t1_ns=40 * ms, device=device,
                graph_launches=[7, 8, 9])
    return dict(pairs=8192, batches=2, passes=1, bsj_pairs=4,
                timer=dict(totals={"encode": 0.010, "full_state": 0.004,
                                   "full_writeback": 0.002,
                                   "full_replay": 0.004, "full_fetch": 9.0},
                           counts={"encode": 2}),
                spans={"io": 0.5, "map": 1.0, "stage2": 0.2},
                full_stats={"reads": 8192, "deferred": 164, "causes": {}},
                profile=prof, work={"bounds": {"walk_scan": 2.0},
                                    "steps": 2})


@pytest.mark.parametrize("name,want", [
    ("io.ms_per_batch", 250.0),
    ("pipeline.host_ms_per_batch", 10.0),
    ("pipeline.deferred_pct", 100.0 * 164 / 8192),
    ("step.device_ms", 4.5),           # replay 7: 1-4 and 5-6; 9: 10-15
    ("step.device_ops", 3.0),
    ("hand_kernels_roofline", 50.0),   # 2 ms bound in 2 steps over 2 + 2 ms
    ("kernels.share_pct", 100.0 * 2 / 4.5),
    ("device.idle_pct", 100.0 * (1 - 11 / 40)),
    ("stage2.ms_per_bsj_pair", 50.0),
])
def test_readers_on_a_synthetic_trace(name, want):
    assert run.load_reader(name)(synthetic_run()) == pytest.approx(want)


def test_readers_return_nothing_without_data():
    r = synthetic_run()
    r.update(profile=None, work=None, spans={}, bsj_pairs=0,
             full_stats={"reads": 0, "deferred": 0})
    for m in bench()["per_layer"]:
        if m["name"] != "pipeline.host_ms_per_batch":
            assert run.load_reader(m["name"])(r) is None, m["name"]


def test_breakdown_of_a_synthetic_trace():
    prof = synthetic_run()["profile"]
    ops = trace.top_ops(prof)
    assert sorted(ops[:2]) == [["vectorized_gather_kernel", 0.004],
                               ["walk_scan_kernel", 0.004]]
    assert ops[2] == ["elementwise_kernel", 0.002]
    spans = [("io", 6_000_000, 9_000_000), ("map", 0, 20_000_000),
             ("stage2", 20_000_000, 40_000_000)]
    gaps = trace.idle_gaps(prof, spans)
    assert gaps[0] == ["stage2", 0.015]     # 15-30 ms
    assert ["io", 0.004] in gaps           # 6-10 ms, io at its middle
    assert len(gaps) <= 10


def test_module_check_compares_whole_top_level_names():
    assert compare.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "circminer_tpu",
         "circminer_tpu.ops", "circminer_tpu_torch", "circminer_tpu_torch.x",
         "jaxtyping", "numpy"]) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "circminer_tpu",
         "circminer_tpu.ops"])


def test_a_run_without_a_card_fails_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    w = bench()["workloads"][0]["name"]
    res = subprocess.run(
        [sys.executable, "-m", "cmbench.run", "--workload", w, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "cuda" in res.stderr.lower()


def cpu_run(tmp_path, seconds=0.0):
    import time
    import torch
    return run.run_cell("tiny", TINY, ENRICHED, 4242, seconds, False,
                        torch.device("cpu"), time.time(), str(tmp_path))


def test_a_cpu_run_is_correct(cache, tmp_path, one_thread):
    res = cpu_run(tmp_path, seconds=0.5)
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] >= 2 * TINY["library_pairs"]
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 for c in res["checks"].values())


def _unchanged(self, cf):
    """The step hands back the state it was given: nothing written."""


def _half(orig):
    def dispatch(self, recs, contig):
        return orig(self, recs[:(len(recs) + 1) // 2], contig)
    return dispatch


def _altered(orig):
    def finish(self, cf):
        orig(self, cf)
        cf["recs"][0][0].mr.tlen += 1
    return finish


def _event_altered(orig):
    def report(self, path):
        if self.circ_res:
            self.circ_res[0].epos += 1
        orig(self, path)
    return report


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered", "event_altered"])
def test_a_broken_timed_path_is_not_correct(fault, cache, tmp_path,
                                            monkeypatch, one_thread):
    from circminer_tpu_torch.pipeline.circ import ProcessCirc
    from circminer_tpu_torch.pipeline.device_pipeline import \
        DeviceMappingPipeline as P
    if fault == "state_unchanged":
        monkeypatch.setattr(P, "_finish_full", _unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(P, "_dispatch_full", _half(P._dispatch_full))
    elif fault == "answer_altered":
        monkeypatch.setattr(P, "_finish_full", _altered(P._finish_full))
    else:
        monkeypatch.setattr(ProcessCirc, "report_events",
                            _event_altered(ProcessCirc.report_events))
    res = cpu_run(tmp_path)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card, tmp_path):
    w = bench()["workloads"][0]["name"]
    res = subprocess.run(
        [sys.executable, "-m", "cmbench.run", "--workload", w, "--seed",
         "7", "--seconds", "5", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
