"""The port's ATAC path — atac generate-permit-list -> sort, collate ->
deduplicate through its CLI with ``--device cpu`` — against the
reference package's host path on the same data, and its device sort
and run-length count (``ops/atac_device.sort_rle``) against
``np.lexsort`` and the reference's ``sort_rle_host``.

The eight data artifacts must match byte for byte, the three stage
JSONs field for field without the fields naming each run's directories
(tests/reference_host_path.py), and deduplicate's four counters
exactly: the outputs are integers and bytes.  Inputs come from numpy
seeds (synth_hard) and the deterministic RAD writer of synth.py.
"""

import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from alevin_fry_tpu.ops.atac_device import sort_rle_host
from alevin_fry_tpu.radz import _native as ref_native
from alevin_fry_tpu_torch.atac import dedup, sort as port_sort
from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.ops import hamming
from alevin_fry_tpu_torch.ops.atac_device import sort_rle
from alevin_fry_tpu_torch.ops.barcodes import pack_seq, revcomp_packed, unpack_seqs_to_strings
from alevin_fry_tpu_torch.pipeline import collate
from alevin_fry_tpu_torch.radz import _native, read_prelude
from reference_host_path import (
    ATAC_DATA_ARTIFACTS, ATAC_STAGE_JSONS, artifact_mismatches, move_sorted_bed,
    run_reference_atac,
)
from synth import write_atac_rad
from synth_hard import make_hard_atac_dataset

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _port_rescue_env(monkeypatch):
    """The port reads AFT_RESCUE_BACKEND, where ``host`` raises.  A
    reference test module imported into the same process may have set
    it for the reference's goldens, so each test starts without it."""
    monkeypatch.delenv("AFT_RESCUE_BACKEND", raising=False)


@pytest.fixture(scope="module")
def atac_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("atac")
    make_hard_atac_dataset(d, np.random.RandomState(11), n_cells=200, n_frags=50_000,
                           n_chrs=4, chr_len=2_000_000, ambient_factor=8)
    return d


def _atac_synth_data(d: Path) -> Path:
    """A small ATAC RAD file (two chromosomes, 8-base barcodes, one
    1-edit variant of a whitelisted barcode, duplicates, multimappers,
    non-proper pairs, fragments over 2 kb) whose header holds a chunk
    count of 0, with its reverse-complement whitelist."""
    rng = np.random.RandomState(4)
    cells = ["AAAAAAAA", "CCCCCCCC", "AAAAAAAT"]
    recs = []
    for _ in range(90):
        alns = []
        for _ in range(1 + int(rng.rand() < 0.1)):
            chrom = int(rng.randint(2))
            alns.append((chrom, 4 if rng.rand() < 0.9 else 2,
                         int(rng.randint(0, (240_000, 140_000)[chrom])),
                         int(rng.randint(50, 2500))))
        recs.append((pack_seq(cells[rng.randint(3)]), alns))
    recs += recs[:20]
    rad = d / "rad" / "map.rad"
    rad.parent.mkdir(parents=True)
    write_atac_rad(rad, ["chr1", "chr2"], [250_000, 150_000], [recs[:50], recs[50:]],
                   bc_len=8)
    with open(rad, "r+b") as fh:
        prelude, _ftm, _ = read_prelude(fh)
        fh.seek(1 + 8 + prelude.hdr.names_nbytes())
        fh.write(struct.pack("<Q", 0))
    wl = revcomp_packed(np.asarray([pack_seq(c) for c in cells[:2]], np.uint64), 8)
    (d / "wl.txt").write_text("".join(b + "\n" for b in unpack_seqs_to_strings(wl, 8)))
    return d


def run_port_atac(d: Path, out: Path, max_records: int, min_reads: int,
                  monkeypatch, compress: bool = False) -> tuple:
    """The four ATAC stages through the port's CLI, sort and collate
    with ``-c`` when ``compress``; returns the command line each stage
    recorded and deduplicate's counters."""
    stats = {}
    real = dedup.deduplicate
    monkeypatch.setattr(dedup, "deduplicate",
                        lambda *a, **k: stats.update(real(*a, **k)) or stats)
    gpl = str(out / "gpl")
    dev = ["-t", "2", "--device", "cpu"]
    m = ["-m", str(max_records), *(["-c"] if compress else [])]
    stages = {
        "gpl": ["atac", "generate-permit-list", "-i", str(d / "rad"), "-o", gpl,
                "-u", str(d / "wl.txt"), "-m", str(min_reads), *dev],
        "sort": ["atac", "sort", "-i", gpl, "-r", str(d / "rad"), *m, *dev],
        "collate": ["atac", "collate", "-i", gpl, "-r", str(d / "rad"), *m, *dev],
        "deduplicate": ["atac", "deduplicate", "-i", gpl, *dev],
    }
    for name, argv in stages.items():
        assert port_main(argv) == 0
        if name == "sort":
            move_sorted_bed(out)
    return {k: "alevin-fry-tpu " + " ".join(v) for k, v in stages.items()}, stats


def _check_against_reference(d, tmp_path, max_records, min_reads, monkeypatch):
    cmdlines, stats = run_port_atac(d, tmp_path / "port", max_records, min_reads,
                                    monkeypatch)
    _secs, ref_stats = run_reference_atac(d, tmp_path / "ref", cmdlines, min_reads,
                                          max_records, threads=2)
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref",
                               ATAC_DATA_ARTIFACTS, ATAC_STAGE_JSONS) == []
    assert stats == ref_stats
    return stats


def _count_calls(monkeypatch, module, name) -> list:
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("backend,max_records", [
    ("auto", 30_000_000), ("auto", 5_000), ("pallas", 5_000),
])
def test_atac_path_matches_reference_on_synth_hard(atac_data, tmp_path, backend,
                                                   max_records, monkeypatch):
    """In memory and out of core (``-m 5000`` sends both sort and
    collate to their spill buckets), with the rescue on K4 or K5."""
    monkeypatch.setenv("AFT_RESCUE_BACKEND", backend)
    monkeypatch.setattr(collate, "COLLATE_BLOCK_RECORDS", 7_000)
    spills = (_count_calls(monkeypatch, port_sort, "_sort_out_of_core"),
              _count_calls(monkeypatch, collate, "_collate_out_of_core"))
    k5 = _count_calls(monkeypatch, hamming, "neighbor_counts_brute")
    stats = _check_against_reference(atac_data, tmp_path, max_records, 10, monkeypatch)
    assert [len(c) for c in spills] == ([1, 1] if max_records == 5_000 else [0, 0])
    assert len(k5) == (backend == "pallas")
    assert all(stats.values())
    # the rescue corrected some barcodes: the map holds more keys than
    # the permit list has barcodes
    n_keys = np.fromfile(tmp_path / "port" / "gpl" / "permit_map.bin", np.uint64)[0]
    n_kept = np.fromfile(tmp_path / "port" / "gpl" / "permit_freq.bin", np.uint64)[2]
    assert n_keys > n_kept


def test_atac_path_matches_reference_with_zero_chunk_count(tmp_path, monkeypatch):
    """A header chunk count of 0 makes every reader stream to EOF."""
    d = _atac_synth_data(tmp_path / "d")
    for max_records in (10_000, 20):
        _check_against_reference(d, tmp_path / str(max_records), max_records, 1,
                                 monkeypatch)


def test_atac_path_matches_reference_without_native_codec(tmp_path, monkeypatch):
    """With the native codec unavailable both packages take their NumPy
    paths (the columnar collate and the NumPy BED formatter)."""
    for native in (_native, ref_native):
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_TRIED", True)
    d = _atac_synth_data(tmp_path / "d")
    _check_against_reference(d, tmp_path, 10_000, 1, monkeypatch)


def test_atac_unported_options_raise(tmp_path, monkeypatch):
    d = _atac_synth_data(tmp_path / "d")
    gpl = str(tmp_path / "gpl")
    base = ["atac", "generate-permit-list", "-i", str(d / "rad"), "-o", gpl,
            "-u", str(d / "wl.txt"), "-m", "1", "--device", "cpu"]
    monkeypatch.setenv("AFT_GPL_MESH", "4")
    with pytest.raises(NotImplementedError, match="device mesh"):
        port_main(base)
    monkeypatch.delenv("AFT_GPL_MESH")
    assert port_main(base) == 0
    # -c is ported: sort and collate write map.bed.gz and map.collated.rad.sz
    for sub in ("sort", "collate"):
        assert port_main(["atac", sub, "-i", gpl, "-r", str(d / "rad"), "-c",
                          "--device", "cpu"]) == 0
    assert (tmp_path / "gpl" / "map.bed.gz").exists()
    assert (tmp_path / "gpl" / "map.collated.rad.sz").exists()
    monkeypatch.setenv("AFT_COORDINATOR", "localhost:1234")
    with pytest.raises(NotImplementedError, match="multi-host"):
        port_main(["atac", "sort", "-i", gpl, "-r", str(d / "rad"), "--device", "cpu"])


def _lexsort_rle(cols):
    n = len(cols[0])
    order = np.lexsort(tuple(cols[::-1]))
    sc = [c[order] for c in cols]
    new = np.ones(n, bool)
    new[1:] = np.any([c[1:] != c[:-1] for c in sc], axis=0) if n > 1 else []
    si = np.flatnonzero(new)
    return [c[si] for c in sc], np.diff(np.append(si, n))


def _sort_cases():
    rng = np.random.RandomState(17)
    hi = lambda k: rng.randint(0, 1 << 63, k, dtype=np.uint64)  # noqa: E731
    return {
        "one word": [rng.randint(0, 9, 700), rng.randint(0, 1 << 20, 700) % 13],
        "two words": [rng.randint(0, 1 << 30, 600) % 5, rng.randint(0, 1 << 40, 600) % 7,
                      rng.randint(0, 1 << 40, 600)],
        "three words": [rng.randint(0, 1 << 62, 500) % 4 << 60,
                        rng.randint(0, 1 << 62, 500) % 3 << 55,
                        rng.randint(0, 1 << 62, 500) % 5 << 50],
        "bit 63 set": [(hi(800) % np.uint64(3)) * np.uint64(1 << 62) + np.uint64(1 << 63),
                       hi(800) % np.uint64(4), rng.randint(0, 3, 800)],
        "64-bit column": [np.concatenate([hi(300) | np.uint64(1 << 63),
                                          np.array([2**64 - 1, 0], np.uint64)]),
                          rng.randint(0, 2, 302)],
        "heavy duplicates": [rng.randint(0, 3, 3000), rng.randint(0, 2, 3000),
                             rng.randint(0, 4, 3000), rng.randint(0, 2, 3000)],
        "n = 1": [np.array([5]), np.array([2**64 - 1], np.uint64)],
        "n = 0": [np.zeros(0, np.int64), np.zeros(0, np.uint64)],
    }


@pytest.mark.parametrize("case", list(_sort_cases()))
def test_sort_rle_matches_lexsort_and_reference(case):
    cols = [np.asarray(c) for c in _sort_cases()[case]]
    got, cnt = sort_rle(cols, CPU)
    if case == "three words":
        from alevin_fry_tpu_torch.ops.atac_device import pack_words

        assert len(pack_words(cols)[0]) == 3
    want, want_cnt = _lexsort_rle(cols) if len(cols[0]) else ([c[:0] for c in cols],
                                                               np.zeros(0, np.int64))
    np.testing.assert_array_equal(cnt, want_cnt)
    for g, w, c in zip(got, want, cols):
        assert g.dtype == c.dtype
        np.testing.assert_array_equal(g, w)
    if len(cols[0]):
        ref, ref_cnt = sort_rle_host(cols)
        np.testing.assert_array_equal(cnt, ref_cnt)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, np.asarray(r).astype(g.dtype))
    assert cnt.dtype == np.int64 and cnt.sum() == len(cols[0])


def test_sort_rle_rejects_negative_columns():
    with pytest.raises(ValueError, match="non-negative"):
        sort_rle([np.array([1, -2, 3])], CPU)
