"""On the card: one short run of ``flex_16plex.main`` through the entry
point, at the cell's own size, is correct with every Flex artifact
compared, and its traced run reads the cell's per-layer metrics.
Skipped where torch sees no card."""

import json
import subprocess
import sys

import pytest

from fry_bench import harness
from fry_bench.tests.conftest import ROOT

CELL = "flex_16plex.main"


def _run(trace: int) -> dict:
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run([sys.executable, "fry_bench/run.py", "--workload", CELL, "--seed",
                           "2147483677", "--seconds", "1", "--trace", str(trace)], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_one_short_run_of_the_flex_cell():
    res = _run(0)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    names = set(res["checks"])
    assert {"gpl:sample_permit_map.bin", "gpl:sample_info.json", "collate:map.collated.rad",
            "collate:collation_manifest.bin", "quant:alevin/quants_mat.mtx",
            "quant:alevin/quants_mat_rows.txt", "quant:quant.json"} <= names
    assert len([n for n in names if n.startswith("gpl:sample_BC")]) == 2 * 16
    for m in harness.load_cell(CELL).metrics_e2e:
        assert res["metrics"][m["name"]]["value"] > 0


@pytest.mark.cuda
def test_traced_flex_run_reads_its_metrics():
    res = _run(1)
    assert res["correct"], res["checks"]
    for name in ("sample_map_s.flex", "tier_s.flex", "tier_queries_per_s.flex",
                 "hand_kernels_roofline.flex", "stage_s.flex_gpl", "stage_s.flex_collate",
                 "stage_s.flex_quant", "device_idle_pct.flex"):
        assert res["metrics"][name]["value"] > 0, name
    assert res["metrics"]["hand_kernels_roofline.flex"]["value"] <= 100
