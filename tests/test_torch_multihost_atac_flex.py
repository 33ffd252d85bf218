"""Multi-process runs of the port (ATAC and Flex): two ranks over gloo on
the CPU (``tools/stage_worker.py`` through ``tests/two_process.py``)
must write the reference's one-process host path bytes
(``tests/reference_host_path.py``) on the same seeded data:

* the Flex chain of the reference's multi-host test (force 4 cells a
  sample, collate -m 97, quant -r trivial), and the unfiltered list with
  the 1-edit sample correction, the fast collate and quant -r cr-like on
  synth_hard's Flex data (K4's twin in every rank's rescue and collate);
* the ATAC chain (gpl, sort -m 97, collate -m 97, deduplicate), plain and
  with ``-c``: the sort's buckets and the collate's gather over gloo, the
  deduplicated BEDs concatenated at rank 0, the four counters summed.

Every comparison is exact: the artifacts are bytes, the stage JSONs
equal field for field without the fields that name a run's directories.
"""

from pathlib import Path

import numpy as np
import pytest

from alevin_fry_tpu.ops.barcodes import pack_seq, revcomp_packed, unpack_seq
from reference_host_path import (
    ATAC_STAGE_JSONS, FLEX_STAGE_JSONS, artifact_mismatches, atac_artifacts, flex_artifacts,
    make_flex_permit_list, run_reference_atac, run_reference_flex,
)
from synth import make_packed_bc, write_atac_rad, write_multi_bc_rad
from synth_hard import make_hard_flex_dataset
from two_process import cmdline, run_two

CPU = ["-t", "2", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _no_policy_env(monkeypatch):
    for var in ("AFT_RESCUE_BACKEND", "AFT_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
                "AFT_NUM_PROCESSES", "AFT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)


def _flex_stages(d: Path, out: Path, gpl: list, collate: list, quant: list,
                 ori: str) -> list:
    return [
        ["gpl", ["generate-permit-list", "-i", str(d / "rad"), "-d", ori, "-o",
                 str(out / "gpl"), "--sample-bc-list", str(d / "samples.tsv"), *gpl, *CPU]],
        ["collate", ["collate", "-i", str(out / "gpl"), "-r", str(d / "rad"), *collate,
                     *CPU]],
        ["quant", ["quant", "-i", str(out / "gpl"), "-m", str(d / "t2g.tsv"), "-o",
                   str(out / "quant"), *quant, *CPU]],
    ]


def _check_flex(tmp: Path, d: Path, stages: list, **ref):
    summaries, logs = run_two(stages, tmp / "logs")
    run_reference_flex(d, tmp / "ref", {k: cmdline(a) for k, a in stages}, threads=2, **ref)
    arts = flex_artifacts(tmp / "port")
    assert arts == flex_artifacts(tmp / "ref")
    assert artifact_mismatches(tmp / "port", tmp / "ref", arts, FLEX_STAGE_JSONS) == []
    assert any("multi-host multi-BC gpl" in lg for lg in logs)
    assert any("multi-host multi-BC collate" in lg for lg in logs)
    return summaries


@pytest.mark.parametrize("mode", ["fast", "two-round"])
def test_two_process_multi_bc_chain_matches_single(tmp_path, mode):
    """The reference's case: two samples sharing their cells, force 4
    cells a sample, collate -m 97 (fast, and two-round), quant -r
    trivial."""
    d = tmp_path / "d"
    samples = [make_packed_bc(100, 8), make_packed_bc(200, 8)]
    (d / "rad").mkdir(parents=True)
    write_multi_bc_rad(d / "rad" / "map.rad", [f"gene_{i}" for i in range(8)], 2, 4, 9,
                       samples, share_cell_barcodes=True)
    (d / "samples.tsv").write_text("".join(f"{unpack_seq(bc, 8)}\tsample{i}\n"
                                           for i, bc in enumerate(samples)))
    (d / "t2g.tsv").write_text("".join(f"gene_{i}\tg{i // 2}\n" for i in range(8)))
    stages = _flex_stages(d, tmp_path / "port", ["-f", "4"],
                          ["-m", "97", "--collation-mode", mode], ["-r", "trivial"], "both")
    _check_flex(tmp_path, d, stages, expected_ori="both", cell_filter_spec="force:4",
                max_records=97, collation_mode=mode, quant_opts={"resolution": "trivial"})


def test_two_process_flex_unfiltered_one_edit_matches_single(tmp_path):
    """synth_hard's Flex data (sample- and cell-barcode errors): gpl -u
    --sample-correction-mode 1-edit (K4's twin once a sample on every
    rank), the fast collate (its 1-edit tier on every rank's chunks)
    and quant -r cr-like."""
    d = tmp_path / "d"
    d.mkdir()
    make_hard_flex_dataset(d, np.random.RandomState(13), n_samples=3, n_cells_per_sample=60,
                           n_reads=20_000, n_genes=100, chunk=4_000)
    make_flex_permit_list(d, 60, 2_000, 13)
    stages = _flex_stages(d, tmp_path / "port",
                          ["-u", str(d / "permit.txt"), "-m", "10",
                           "--sample-correction-mode", "1-edit"], [], ["-r", "cr-like"], "fw")
    summaries = _check_flex(tmp_path, d, stages, min_reads=10,
                            gpl_opts={"sample_correction_mode": "1-edit"})
    for s in summaries:
        assert s["stages"]["gpl"]["twin_calls"]["K4/K5"] > 0
        assert s["stages"]["collate"]["twin_calls"]["K4/K5"] > 0
        assert all(s["stages"]["quant"]["twin_calls"][k] > 0 for k in ("K1", "K2", "K3"))


def _atac_data(d: Path) -> Path:
    """The reference's multi-host case: four chunks of 60 fragments over
    two chromosomes, three whitelisted barcodes, 10% non-proper pairs,
    with the reverse-complement whitelist."""
    rng = np.random.RandomState(53)
    lens = [250_000, 150_000]
    cells = ["AAAAAAAA", "CCCCCCCC", "GGGGGGGG"]
    chunks = []
    for _ in range(4):
        recs = []
        for _ in range(60):
            b, c = cells[rng.randint(3)], int(rng.randint(2))
            recs.append((pack_seq(b), [(c, 4 if rng.rand() < 0.9 else 2,
                                        int(rng.randint(0, lens[c] - 3000)),
                                        int(rng.randint(50, 2500)))]))
        chunks.append(recs + recs[:7])  # duplicates within a cell
    (d / "rad").mkdir(parents=True)
    write_atac_rad(d / "rad" / "map.rad", ["chr1", "chr2"], lens, chunks, bc_len=8)
    (d / "wl.txt").write_text("".join(
        unpack_seq(int(revcomp_packed(np.asarray([pack_seq(b)], np.uint64), 8)[0]), 8) + "\n"
        for b in cells))
    return d


@pytest.mark.parametrize("compress", [False, True])
def test_two_process_atac_chain_matches_single(tmp_path, compress):
    d = _atac_data(tmp_path / "d")
    out, gpl = tmp_path / "port", str(tmp_path / "port" / "gpl")
    c = ["-c"] if compress else []
    bed = "map.bed.gz" if compress else "map.bed"
    stages = [
        ["gpl", ["atac", "generate-permit-list", "-i", str(d / "rad"), "-o", gpl,
                 "-u", str(d / "wl.txt"), "-m", "1", *CPU]],
        ["sort", ["atac", "sort", "-i", gpl, "-r", str(d / "rad"), "-m", "97", *c, *CPU],
         [[f"{gpl}/{bed}", str(out / "sort" / bed)]]],
        ["collate", ["atac", "collate", "-i", gpl, "-r", str(d / "rad"), "-m", "97", *c,
                     *CPU]],
        ["deduplicate", ["atac", "deduplicate", "-i", gpl, *CPU]],
    ]
    summaries, logs = run_two(stages, tmp_path / "logs")
    _secs, counters = run_reference_atac(d, tmp_path / "ref",
                                         {k: cmdline(a) for k, a, *_ in stages}, min_reads=1,
                                         max_records=97, threads=2, compress=compress)
    assert artifact_mismatches(out, tmp_path / "ref", atac_artifacts(compress),
                               ATAC_STAGE_JSONS) == []
    assert summaries[0]["stages"]["deduplicate"]["dedup"] == counters
    assert summaries[1]["stages"]["deduplicate"]["dedup"] == counters
    for what in ("atac gpl", "atac sort", "collate", "atac dedup"):
        assert sum(f"multi-host {what}" in lg for lg in logs) == 2, what
    assert not [p for p in Path(gpl).iterdir() if p.name.startswith(("_", ".map.bed"))]
