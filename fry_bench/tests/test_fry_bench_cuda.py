"""On the card: one short run of each cell through the entry point, at
the cell's own size, is correct and prints the contract's last line; a
checkout that holds only ``BENCHMARK.json`` and the benchmark's files
prints no result.  Skipped where torch sees no card."""

import json
import shutil
import subprocess
import sys

import pytest

from fry_bench import harness
from fry_bench.tests.conftest import ROOT


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in harness.bench()["workloads"]])
def test_one_short_run_of_each_cell(name):
    _card()
    proc = subprocess.run([sys.executable, "fry_bench/run.py", "--workload", name, "--seed",
                           "2147483659", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    for m in harness.load_cell(name).metrics_e2e:
        assert res["metrics"][m["name"]]["value"] > 0


@pytest.mark.cuda
def test_without_the_program_no_result(tmp_path):
    _card()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "fry_bench", tmp_path / "fry_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "fry_bench/run.py", "--workload", "atac_10x.sort",
                           "--seed", "1", "--seconds", "1"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
