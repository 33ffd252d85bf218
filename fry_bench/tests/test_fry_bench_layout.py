"""Every configuration, traffic and metric that ``BENCHMARK.json`` names
is found by name; the result line has the contract's keys; the no-JAX
check; the entry point without a card."""

import json
import os
import re
import subprocess
import sys
import types

import pytest

from fry_bench import check, harness
from fry_bench.tests.conftest import ROOT, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_everything_named_is_found():
    spec = harness.bench()
    assert spec["command"] == ["python3", "fry_bench/run.py"] and spec["paths"] == ["fry_bench"]
    for cfg in spec["configs"]:
        doc = json.loads((ROOT / cfg["file"]).read_text())
        assert doc["name"] == cfg["name"] and doc["source"] == cfg["source"]
        assert set(cfg["reduced"]) == set(doc["reduced"]) <= set(doc["sizes"])
        assert doc["assumed"] and doc["control"]
        assert (harness.HERE / "gen" / f"{doc['generator']}.py").exists()
    for wl in spec["workloads"]:
        cell = harness.load_cell(wl["name"], spec)
        for st in cell.traffic.get("setup", []) + cell.traffic["stages"]:
            assert (harness.HERE / "reference" / f"{st['reference']}.py").exists()
            harness._argv(st["argv"], dict(cell.params, data="d", setup="s", job="j",
                                           device="cuda"))
        assert wl["chips"] == 1
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and callable(harness.metric_reader(m["name"]))
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m["workloads"]) <= {w["name"] for w in spec["workloads"]}
        # each cell it is read in reports the end-to-end metric it moves
        assert all(harness._reports(e2e[m["moves"]], w) for w in m["workloads"])
    for wl in spec["workloads"]:
        cell = harness.load_cell(wl["name"], spec)
        names = {m["name"] for m in cell.metrics_e2e}
        assert "setup_s" in names and len(names) >= 2 and cell.metrics_layer
    ops = harness.kernel_ops()
    assert {op["name"] for op in ops} >= {"rescue_probe", "wta_scans", "sort_scans"}
    assert all(op["kernels"] and op["bytes"] for op in ops)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace, capsys):
    res = harness.run_cell(tiny_cell("atac_10x.sort"), 1, 0.2, trace, "cpu")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    spec = harness.bench()
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"stage_s.atac_gpl", "stage_s.atac_sort", "device_idle_pct"} <= set(res["metrics"])
        assert set(res["metrics"]) <= {m["name"] for m in spec["per_layer"]}
    else:
        assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]
                                       if harness._reports(m, "atac_10x.sort")}
    json.dumps(res)


def test_rna_cell_reports_its_rate_per_layer(capsys):
    res = harness.run_cell(tiny_cell("rna_10xv3_usa.crlike"), 3, 0.2, False, "cpu")
    assert set(res["metrics"]) == {"peak_dev_mib", "setup_s"}
    res = harness.run_cell(tiny_cell("rna_10xv3_usa.crlike"), 3, 0.2, True, "cpu")
    assert {"records_per_s.rna", "stage_s.gpl", "stage_s.collate", "stage_s.quant"} <= set(
        res["metrics"])
    assert res["metrics"]["records_per_s.rna"]["value"] > 0 and res["correct"]


def test_no_jax_check_compares_whole_top_level_names():
    mod = types.ModuleType("x")
    assert harness.forbidden_modules({"alevin_fry_tpu": mod, "os": mod}) == ["alevin_fry_tpu"]
    assert harness.forbidden_modules({"alevin_fry_tpu.ops.em": mod}) == ["alevin_fry_tpu.ops.em"]
    assert harness.forbidden_modules({"jax.numpy": mod, "jaxlib": mod, "flax": mod}) == [
        "flax", "jax.numpy", "jaxlib"]
    assert harness.forbidden_modules({"alevin_fry_tpu_torch": mod,
                                      "alevin_fry_tpu_torch.cli": mod, "jaxtyping": mod}) == []


def test_a_run_loads_no_jax(capsys):
    harness.run_cell(tiny_cell("rna_10xv3_usa.crlike"), 2, 0.2, False, "cpu")
    assert harness.forbidden_modules() == []


def test_entry_point_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "fry_bench/run.py", "--workload",
                           "atac_10x.sort", "--seed", "1", "--seconds", "1"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_diff_counts_units():
    import numpy as np

    k = np.arange(5, dtype=np.uint64)
    assert check.diff("u64_map", (k, k), (k, k)) == 0
    assert check.diff("u64_map", (k, k + (k == 2)), (k, k)) == 2
    assert check.diff("u64_map", (k[:4], k[:4]), (k, k)) == 1
    b = np.frombuffer(b"abcd\n", np.uint8)
    assert check.diff("bytes", b, b) == 0
    assert check.diff("bytes", b[:3], b) == 2
    assert check.diff("json", {"a": 1, "b": [2]}, {"a": 1, "b": [3]}) == 1
