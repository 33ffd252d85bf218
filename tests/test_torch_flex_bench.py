"""The benchmark's Flex cell (``flex_16plex.main``, ``fry_bench/``) at a
size a CPU test holds: the port through ``harness.run_cell(...,
"cpu")`` agrees with the plain reference on every compared artifact;
the ``no_rescue`` control fails the per-sample permit files and the
collated file; the three references and the generator import nothing
of the program, the JAX package or JAX; the generator is a function of
its seed."""

import ast
import hashlib
from pathlib import Path

import numpy as np
import pytest

from fry_bench import control, harness
from fry_bench.gen import flex_hard

CELL = "flex_16plex.main"
# 4 samples x 100 cells from a pool of 200 (each GEM barcode in about 2
# samples), 60,000 reads, a 20,000-entry list: every code path of the
# full size (rotations, 1-edit sample correction, the per-sample rescue
# and 1-edit tier, the manifest) still runs
TINY = dict(n_samples=4, cells_per_sample=100, gem_pool=200, n_reads=60_000, n_genes=400,
            permit_list_size=20_000, reads_per_chunk=5_000)
SAMPLES = [f"BC{i + 1:03d}" for i in range(TINY["n_samples"])]


def _tiny():
    cell = harness.load_cell(CELL)
    cell.config["sizes"].update(TINY)
    return cell


@pytest.fixture(autouse=True)
def _port_env(monkeypatch):
    """The port reads these; a reference test module in the same
    process may have set them."""
    for var in ("AFT_RESCUE_BACKEND", "AFT_COORDINATOR", "AFT_NUM_PROCESSES",
                "AFT_PROCESS_ID", "AFT_GPL_MESH"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_tiny_flex_cell_is_correct_on_the_cpu(seed, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    res = harness.run_cell(_tiny(), seed, 0.5, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["checks"].values())
    want = {"jobs_failed", "gpl:sample_permit_map.bin", "gpl:sample_info.json",
            "collate:map.collated.rad", "collate:collation_manifest.bin",
            "quant:alevin/quants_mat.mtx", "quant:alevin/quants_mat_rows.txt",
            "quant:alevin/quants_mat_cols.txt", "quant:quant.json"}
    want |= {f"gpl:sample_{s}/permit_{k}.bin" for s in SAMPLES for k in ("freq", "map")}
    assert set(res["checks"]) == want
    assert set(res["metrics"]) == {"peak_dev_mib", "setup_s"}


def test_no_rescue_control_fails_permit_files_and_collated(tmp_path):
    found = control.readings(_tiny(), 7, tmp_path)
    for s in SAMPLES:
        assert found[f"gpl:sample_{s}/permit_freq.bin"] > 0, found
        assert found[f"gpl:sample_{s}/permit_map.bin"] > 0, found
    assert found["collate:map.collated.rad"] > 0, found
    # what the rescue cannot move stays exact
    assert found["gpl:sample_permit_map.bin"] == 0
    assert found["quant:alevin/quants_mat_cols.txt"] == 0


def test_flex_references_import_nothing_of_the_program():
    here = Path(harness.HERE)
    paths = [here / "reference" / f"flex_{s}.py" for s in ("gpl", "collate", "quant")]
    paths.append(here / "gen" / "flex_hard.py")
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in ("alevin_fry_tpu_torch", "alevin_fry_tpu", "jax",
                                               "jaxlib", "torch"), (path, m)


def _digest(d: Path) -> dict:
    return {p.relative_to(d).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_generator_is_a_function_of_its_seed(tmp_path):
    sizes = dict(harness.load_cell(CELL).config["sizes"], **TINY)
    a = flex_hard.make(tmp_path / "a", 41, **sizes)
    b = flex_hard.make(tmp_path / "b", 41, **sizes)
    c = flex_hard.make(tmp_path / "c", 2 ** 31 + 41, **sizes)
    assert _digest(tmp_path / "a") == _digest(tmp_path / "b")
    for k in ("sbc", "bc", "umi", "aln_offsets", "refs", "dirs", "permit"):
        assert np.array_equal(a[k], b[k]), k
    assert a["sample_list"] == b["sample_list"]
    digest_a, digest_c = _digest(tmp_path / "a"), _digest(tmp_path / "c")
    assert set(digest_c) == set(digest_a)
    # the probe-to-gene map depends on the sizes alone
    assert {k for k in digest_a if digest_a[k] != digest_c[k]} == {
        "rad/map.rad", "samples.tsv", "permit.txt"}
    assert not np.array_equal(a["bc"][:1000], c["bc"][:1000])
