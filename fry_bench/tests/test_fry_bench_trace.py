"""The trace's arithmetic and the window's bookkeeping, on made-up
events: the busy time, which launches an operation claims, the
roofline's refusal to count a launch twice, and the jobs whose outputs
a run keeps."""

import random

import pytest

from fry_bench import harness
from fry_bench.trace import HBM_BYTES_PER_S, Trace, merged

SCAN = "void (anonymous namespace)::lookback_scan_kernel<(anonymous namespace)::FwdOp>(...)"
PROBE = "void hamming1_probe_kernel<Sel>(...)"


def test_busy_time_counts_overlaps_once():
    assert merged([(3.0, 4.0), (0.0, 1.0), (0.5, 2.0)]) == [(0.0, 2.0), (3.0, 4.0)]
    tr = Trace(ops=[("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0)])
    assert tr.busy_s == pytest.approx(3.0)


def _trace():
    return Trace(
        ops=[(SCAN, 1.0, 1.001), (PROBE, 0.2, 0.2005), (SCAN, 5.0, 5.002), ("Memcpy HtoD", 5.1, 5.2)],
        stages=[("stage:gpl", 0.0, 0.5), ("stage:quant", 0.9, 2.0), ("stage:atac_sort", 4.9, 6.0)],
        window_s=6.0)


def test_an_operation_claims_its_kernels_in_its_stages():
    tr = _trace()
    assert tr.claimed(["lookback_scan_kernel<"]) == [0, 2]
    assert tr.claimed(["lookback_scan_kernel<"], ["quant"]) == [0]
    assert tr.claimed(["lookback_scan_kernel<"], ["atac_sort"]) == [2]
    assert tr.claimed(["hamming1_probe_kernel"]) == [1]
    assert tr.claimed(["lookback_scan_kernel<"], ["collate"]) == []


def _run(counts):
    run = harness.Run(jobs=[{"_job": (0.0, 6.0)}], trace=_trace(), counts=counts)
    return run, harness.metric_reader("hand_kernels_roofline")


def test_roofline_sums_the_bounds_of_the_operations_that_ran():
    run, read = _run({"wta_pairs": 1000, "wta_groups": 500, "rescue_queries": 10,
                      "rescue_kept": 4})
    bound = (8 * 1000 + 8 * 500 + 16 * 10 + 8 * 4) / HBM_BYTES_PER_S
    assert read(run) == pytest.approx(100 * bound / (0.001 + 0.0005))
    # the sort's work counted as well: its launch in atac_sort joins
    run.counts.update(sort_rows=2000, sort_runs=100)
    bound += (2000 + 4 * 100) / HBM_BYTES_PER_S
    assert read(run) == pytest.approx(100 * bound / (0.001 + 0.0005 + 0.002))


def test_an_operation_without_launches_adds_no_bound():
    run, read = _run({"wta_pairs": 1000, "wta_groups": 500})
    run.trace.ops = [op for op in run.trace.ops if op[0] != SCAN]
    assert read(run) is None


def test_a_launch_two_operations_claim_gives_no_reading(monkeypatch):
    ops = harness.kernel_ops()
    twin = dict(next(op for op in ops if op["name"] == "wta_scans"), name="wta_twin")
    monkeypatch.setattr(harness, "kernel_ops", lambda: ops + [twin])
    run, read = _run({"wta_pairs": 1000, "wta_groups": 500})
    assert read(run) is None


def test_a_run_keeps_the_first_job_one_sample_and_the_last(tmp_path):
    picks = []
    for seed in range(200):
        work = tmp_path / str(seed)
        rng, sample = random.Random(seed), None
        for j in range(7):
            (work / f"job{j}").mkdir(parents=True)
            sample = harness._drop_previous(work, j, sample, rng)
        assert sorted(p.name for p in work.iterdir()) == sorted({"job0", f"job{sample}", "job6"})
        picks.append(sample)
    # every job between the first and the last is drawn, about alike
    counts = [picks.count(j) for j in range(1, 6)]
    assert min(counts) >= 20, counts
