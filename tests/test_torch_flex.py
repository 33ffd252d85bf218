"""The port's Flex (multi-barcode) path — generate-permit-list with the
per-sample cell filters, the hierarchical collate (fast and two-round,
in memory and out of core, plain and ``-c``) and quant's sample branches
— through its CLI with ``--device cpu``, against the reference package's
host path on the same data.

Every data artifact (``sample_permit_map.bin``, each sample's
``permit_map.bin`` and ``permit_freq.bin``, the collated RAD, the
manifest, the unmapped sidecar and quant's four files) must match byte
for byte, and the four stage JSONs field for field
(tests/reference_host_path.py).  Inputs come from the deterministic
writer ``synth.py::write_multi_bc_rad`` (the reference's seven cases of
tests/test_multi_bc.py, each as a parity case) and from numpy seeds
(``synth_hard.make_hard_flex_dataset``: rotation sample barcodes with
sequencing errors, one cell-barcode pool shared by every sample, sparse
plate positions).
"""

import json
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest

from alevin_fry_tpu.ops.barcodes import find_neighbors_batch as ref_find_neighbors_batch
from alevin_fry_tpu.ops.barcodes import unpack_seq
from alevin_fry_tpu.pipeline.collate import collate as ref_collate
from alevin_fry_tpu.radz import RadWriter
from alevin_fry_tpu.radz import _native as ref_native
from alevin_fry_tpu.radz import collation as ref_collation
from alevin_fry_tpu.radz import unmapped as ref_unmapped
from alevin_fry_tpu_torch import spans
from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.ops import barcodes as port_barcodes
from alevin_fry_tpu_torch.pipeline import quant
from alevin_fry_tpu_torch.radz import bincodeio, collation, read_prelude, unmapped
from alevin_fry_tpu_torch.radz.chunkio import decode_all_chunks
from alevin_fry_tpu_torch.radz.records import RecordSchema
from reference_host_path import (
    FLEX_STAGE_JSONS, artifact_mismatches, flex_artifacts, host_policies,
    make_flex_permit_list, run_reference_flex,
)
from synth import make_multi_bc_prelude, make_packed_bc, write_multi_bc_rad
from synth_hard import make_hard_flex_dataset

SAMPLE_BC_LEN, NUM_REFS = 8, 10
GPL_JSONS = ("gpl/generate_permit_list.json", "gpl/sample_info.json")


@pytest.fixture(autouse=True)
def _port_rescue_env(monkeypatch):
    """The port reads AFT_RESCUE_BACKEND, where ``host`` raises; a
    reference test module in the same process may have set it."""
    monkeypatch.delenv("AFT_RESCUE_BACKEND", raising=False)


def _run_port(d: Path, out: Path, gpl=(), collate=(), quant_flags=("-r", "cr-like"),
              ori: str = "fw", samples: str = "samples.tsv", t2g: str = "t2g.tsv") -> dict:
    """The three Flex stages through the port's CLI on ``d/rad`` into
    ``out/gpl`` and ``out/quant``; returns the command line each stage
    recorded (the reference is given the same)."""
    dev = ["-t", "2", "--device", "cpu"]
    stages = {
        "gpl": ["generate-permit-list", "-i", str(d / "rad"), "-d", ori, "-o", str(out / "gpl"),
                "--sample-bc-list", str(d / samples), *gpl, *dev],
        "collate": ["collate", "-i", str(out / "gpl"), "-r", str(d / "rad"), *collate, *dev],
        "quant": ["quant", "-i", str(out / "gpl"), "-m", str(d / t2g), "-o", str(out / "quant"),
                  *quant_flags, *dev],
    }
    for argv in stages.values():
        assert port_main(argv) == 0
    return {k: "alevin-fry-tpu " + " ".join(v) for k, v in stages.items()}


def _same(port: Path, ref: Path, compressed: bool = False) -> None:
    arts = flex_artifacts(port, compressed)
    assert arts == flex_artifacts(ref, compressed)
    assert artifact_mismatches(port, ref, arts, FLEX_STAGE_JSONS) == []


# --- the reference's seven cases (tests/test_multi_bc.py) -------------------

def _uniform_data(d: Path, entries, used, cells: int, reads: int, share: bool,
                  name_column: bool = True) -> Path:
    """write_multi_bc_rad data in ``d``: the samples of plate positions
    ``used`` among ``entries`` (name, packed barcode), the whole plate in
    ``d/samples.tsv`` (barcode, name; barcode alone without
    ``name_column``) and a plain t2g."""
    (d / "rad").mkdir(parents=True)
    write_multi_bc_rad(d / "rad" / "map.rad", [f"gene_{i}" for i in range(NUM_REFS)],
                       len(used), cells, reads, [entries[p][1] for p in used],
                       share_cell_barcodes=share)
    (d / "samples.tsv").write_text("".join(
        unpack_seq(bc, SAMPLE_BC_LEN) + (f"\t{name}" if name_column else "") + "\n"
        for name, bc in entries))
    (d / "t2g.tsv").write_text("".join(f"gene_{i}\tgene_{i}\n" for i in range(NUM_REFS)))
    return d


def _two_samples():
    return [("sample_a", make_packed_bc(100, SAMPLE_BC_LEN)),
            ("sample_b", make_packed_bc(200, SAMPLE_BC_LEN))]


def _full_chain(tmp: Path, used, entries, quant_flags=("-r", "trivial"), collate=()) -> Path:
    """The reference's ``_run_full``: force 4 cells a sample, collate,
    quant; both packages; returns the port's run directory."""
    d = _uniform_data(tmp / "d", entries, used, 4, 8, True)
    cm = _run_port(d, tmp / "port", gpl=["-f", "4"], collate=collate,
                   quant_flags=quant_flags, ori="both")
    run_reference_flex(d, tmp / "ref", cm, "both", "force:4",
                       collation_mode="two-round" if "two-round" in collate else "fast",
                       threads=2, quant_opts={"resolution": quant_flags[1]})
    _same(tmp / "port", tmp / "ref")
    return tmp / "port"


def test_flex_gpl_matches_reference(tmp_path):
    """test_multi_bc_generate_permit_list: a one-column sample list,
    -f 5 over two samples of 5 cells."""
    entries = [(unpack_seq(bc, SAMPLE_BC_LEN), bc) for _n, bc in _two_samples()]
    d = _uniform_data(tmp_path / "d", entries, [0, 1], 5, 10, False, name_column=False)
    argv = ["generate-permit-list", "-i", str(d / "rad"), "-d", "both",
            "-o", str(tmp_path / "port" / "gpl"), "--sample-bc-list", str(d / "samples.tsv"),
            "-f", "5", "--device", "cpu"]
    assert port_main(argv) == 0
    with host_policies():
        from alevin_fry_tpu.pipeline.gpl import (
            CellFilterMethod, GenPermitListOpts, generate_permit_list,
        )

        generate_permit_list(GenPermitListOpts(
            input_dir=d / "rad", output_dir=tmp_path / "ref" / "gpl",
            fmeth=CellFilterMethod("force", count=5), expected_ori="both",
            cmdline="alevin-fry-tpu " + " ".join(argv), sample_bc_list=d / "samples.tsv",
        ))
    arts = [a for a in flex_artifacts(tmp_path / "port") if a.startswith("gpl/sample_")]
    assert len(arts) == 5
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref", arts, GPL_JSONS) == []
    info = json.loads((tmp_path / "port" / "gpl" / "sample_info.json").read_text())
    assert info["num_samples"] == info["num_barcodes"] == 2 and info["matched_reads"] == 100
    gj = json.loads((tmp_path / "port" / "gpl" / "generate_permit_list.json").read_text())
    assert gj["multi_barcode"] is True and "gpl_options" not in gj


def test_flex_sample_and_cell_identity_match_reference(tmp_path):
    """The shared-cell-barcode identity test: two samples holding the
    same four cell barcodes stay eight cells, kept apart by the row
    prefix."""
    port = _full_chain(tmp_path, [0, 1], _two_samples())
    rows = (port / "quant" / "alevin" / "quants_mat_rows.txt").read_text().splitlines()
    assert len(rows) == len(set(rows)) == 8
    assert {r.split("_")[1] for r in rows} == {"a", "b"}


def test_flex_sparse_plate_positions_match_reference(tmp_path):
    """simpleaf#195: plate positions {0, 3, 7} of 8 are used; the
    collated records carry the manifest ordinals 0-2, not the plate
    positions, and featureDump.txt has ten fields a row."""
    entries = [(f"sample_{i:02d}", make_packed_bc(100 + i * 37, SAMPLE_BC_LEN))
               for i in range(8)]
    port = _full_chain(tmp_path, [0, 3, 7], entries)
    fd = (port / "quant" / "featureDump.txt").read_text().splitlines()
    assert {len(line.split("\t")) for line in fd} == {10} and len(fd) == 13
    assert {line.split("\t")[1] for line in fd[1:]} == {"sample_00", "sample_03", "sample_07"}
    m = collation.CollationManifest.read_from_file(port / "gpl" / "collation_manifest.bin")
    assert [g.name for g in m.sample_groups] == ["sample_00", "sample_03", "sample_07"]
    assert [g.chunk_start for g in m.sample_groups] == [0, 4, 8]
    from alevin_fry_tpu_torch.radz import read_prelude
    from alevin_fry_tpu_torch.radz.chunkio import decode_all_chunks
    from alevin_fry_tpu_torch.radz.records import RecordSchema

    with open(port / "gpl" / "map.collated.rad", "rb") as fh:
        prelude, _ftm, _ = read_prelude(fh)
        batch = decode_all_chunks(fh, RecordSchema.from_prelude(prelude),
                                  prelude.hdr.num_chunks)
    assert sorted(set(batch.barcode(0).tolist())) == [0, 1, 2]


def test_collation_manifest_round_trip_between_packages(tmp_path):
    """The port writes what the reference reads and the other way round,
    in bincode 1.x fixint layout."""
    groups = [(0x1234, "sample_A", 0, 100, 50_000), (0x5678, None, 100, 80, 40_000)]
    pm = collation.CollationManifest(["sample", "cell"])
    rm = ref_collation.CollationManifest(["sample", "cell"])
    for g in groups:
        pm.add_sample_group(collation.SampleGroup(*g))
        rm.add_sample_group(ref_collation.SampleGroup(*g))
    pm.write_to_file(tmp_path / "port.bin")
    rm.write_to_file(tmp_path / "ref.bin")
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()
    assert (tmp_path / "port.bin").read_bytes()[:34] == (
        struct.pack("<Q", 2) + struct.pack("<Q", 6) + b"sample" + struct.pack("<Q", 4) + b"cell")
    back = ref_collation.CollationManifest.read_from_file(tmp_path / "port.bin")
    assert [(g.key, g.name, g.chunk_start, g.num_chunks, g.num_records)
            for g in back.sample_groups] == groups
    back = collation.CollationManifest.read_from_file(tmp_path / "ref.bin")
    assert back.levels == ["sample", "cell"]
    assert (back.total_chunks(), back.total_records()) == (180, 90_000)


def test_unmapped_sidecar_layouts_match_reference(tmp_path):
    """The multi-key (sample, cell) map, entries sorted by key, and the
    single-key one are the reference's bytes; read_collated sniffs
    both."""
    s, c, n = (np.array([1, 1, 0], np.uint64), np.array([9, 4, 7], np.uint64),
               np.array([5, 6, 2], np.uint32))
    unmapped.write_collated_multi(tmp_path / "port.bin", s, c, n)
    ref_unmapped.write_collated_multi(tmp_path / "ref.bin", s, c, n)
    raw = (tmp_path / "port.bin").read_bytes()
    assert raw == (tmp_path / "ref.bin").read_bytes()
    assert raw == struct.pack("<Q", 3) + b"".join(
        struct.pack("<QQI", *t) for t in ((0, 7, 2), (1, 4, 6), (1, 9, 5)))
    bcs, cts, nf = unmapped.read_collated(tmp_path / "port.bin")
    assert nf == 2 and list(bcs) == [7, 4, 9] and list(cts) == [2, 6, 5]
    unmapped.write_collated_multi(tmp_path / "empty.bin", *(np.zeros(0, t) for t in
                                                            (np.uint64, np.uint64, np.uint32)))
    assert (tmp_path / "empty.bin").read_bytes() == struct.pack("<Q", 0)


def test_flex_sample_names_override_matches_reference(tmp_path):
    """--sample-names renames the samples, directories included."""
    entries = _two_samples()
    d = _uniform_data(tmp_path / "d", entries, [0, 1], 3, 6, False)
    (d / "names.tsv").write_text("".join(
        f"{unpack_seq(bc, SAMPLE_BC_LEN)}\twell{w}\n" for w, (_n, bc) in zip("AB", entries)))
    cm = _run_port(d, tmp_path / "port", gpl=["-f", "3", "--sample-names", str(d / "names.tsv")],
                   ori="both")
    run_reference_flex(d, tmp_path / "ref", cm, "both", "force:3",
                       gpl_opts={"sample_names": d / "names.tsv"}, threads=2)
    _same(tmp_path / "port", tmp_path / "ref")
    info = json.loads((tmp_path / "port" / "gpl" / "sample_info.json").read_text())
    assert [e["name"] for e in info["samples"]] == ["wellA", "wellB"]
    assert (tmp_path / "port" / "gpl" / "sample_wellA" / "permit_freq.bin").exists()


@pytest.mark.parametrize("mode", ["fast", "two-round"])
def test_flex_out_of_core_and_two_round_match_in_memory_and_reference(tmp_path, mode):
    """Past --max-records the collate spills to buckets of cell ranks and
    writes the in-memory bytes; on data whose noisy barcodes all have a
    unique 1-edit representative, two-round equals fast; each against
    the reference's run of the same command lines."""
    d = _uniform_data(tmp_path / "d", _two_samples(), [0, 1], 5, 9, True)
    collate = ["--collation-mode", mode]
    cm = _run_port(d, tmp_path / "port", gpl=["-f", "5"], collate=collate, ori="both")
    run_reference_flex(d, tmp_path / "ref", cm, "both", "force:5", collation_mode=mode,
                       threads=2)
    _same(tmp_path / "port", tmp_path / "ref")
    assert json.loads((tmp_path / "port" / "gpl" / "collate.json").read_text()).get(
        "collation_mode") == ("two-round" if mode == "two-round" else None)
    names = ("map.collated.rad", "collation_manifest.bin")
    in_mem = {n: (tmp_path / "port" / "gpl" / n).read_bytes() for n in names}
    for run, extra in (("port", ["-m", "11", *collate]), ("port", []), ("ref", None)):
        gpl = tmp_path / run / "gpl"
        if extra is None:
            with host_policies():
                ref_collate(gpl, d / "rad", 2, 11, cmdline=cm["collate"], collation_mode=mode)
        else:
            assert port_main(["collate", "-i", str(gpl), "-r", str(d / "rad"), *extra,
                              "--device", "cpu"]) == 0
        assert not (gpl / "_collate_tmp").exists()
        assert {n: (gpl / n).read_bytes() for n in names} == in_mem


# --- synth_hard's Flex data --------------------------------------------------

@pytest.fixture(scope="module")
def hard_flex(tmp_path_factory):
    """Four samples at sparse plate positions, three rotations each, one
    pool of 100 cell barcodes shared by all, sample- and cell-barcode
    errors, and a 5,000-entry unfiltered list (the pool and random
    codes)."""
    d = tmp_path_factory.mktemp("hard_flex")
    make_hard_flex_dataset(d, np.random.RandomState(13), n_samples=4, n_cells_per_sample=100,
                           n_reads=60_000, n_genes=200)
    make_flex_permit_list(d, 100, 5_000, 13)
    # every other pool barcode, from the most reads down
    lines = (d / "permit.txt").read_text().splitlines()[:100]
    (d / "explicit.txt").write_text("".join(f"{b}\n" for b in lines[::2]))
    return d


FILTERS = {
    "unfiltered": (["-m", "10"], None),
    "knee": (["-k"], "knee"),
    "force": (["-f", "60"], "force:60"),
    "expect": (["-e", "40"], "expect:40"),
    "explicit": (None, "explicit"),
}


@pytest.mark.parametrize("method", list(FILTERS))
def test_hard_flex_chain_matches_reference_for_each_filter(hard_flex, tmp_path, method):
    flags, spec = FILTERS[method]
    if method == "unfiltered":
        flags = ["-u", str(hard_flex / "permit.txt"), *flags]
    if method == "explicit":
        flags, spec = ["-b", str(hard_flex / "explicit.txt")], f"explicit:{hard_flex}/explicit.txt"
    cm = _run_port(hard_flex, tmp_path / "port", gpl=flags)
    run_reference_flex(hard_flex, tmp_path / "ref", cm, cell_filter_spec=spec, threads=2)
    _same(tmp_path / "port", tmp_path / "ref")
    info = json.loads((tmp_path / "port" / "gpl" / "sample_info.json").read_text())
    assert info["total_cells"] > 0 and info["unmatched_reads"] > 0
    rows = (tmp_path / "port" / "quant" / "alevin" / "quants_mat_rows.txt").read_text()
    assert len({r.split("_")[0] for r in rows.splitlines()}) == 4


def _reverse_complement(seq: str) -> str:
    return seq.translate(str.maketrans("ACGT", "TGCA"))[::-1]


@pytest.mark.parametrize("ori,correction", [("forward", "exact"), ("forward", "1-edit"),
                                            ("reverse", "exact"), ("reverse", "1-edit")])
def test_hard_flex_sample_orientation_and_correction_match_reference(hard_flex, tmp_path, ori,
                                                                     correction):
    """--sample-bc-ori reverse takes a list of reverse complements to
    the same samples; 1-edit sample correction keeps reads that exact
    drops."""
    samples = hard_flex / "samples.tsv"
    if ori == "reverse":
        samples = tmp_path / "samples_rc.tsv"
        samples.write_text("".join(
            "\t".join([_reverse_complement(f[0]), _reverse_complement(f[1]), f[2]]) + "\n"
            for f in (line.split("\t") for line in
                      (hard_flex / "samples.tsv").read_text().splitlines())))
    flags = ["-u", str(hard_flex / "permit.txt"), "--sample-correction-mode", correction,
             "--sample-bc-ori", ori]
    cm = _run_port(hard_flex, tmp_path / "port", gpl=flags, samples=str(samples))
    run_reference_flex(hard_flex, tmp_path / "ref", cm, threads=2, gpl_opts={
        "sample_bc_list": samples, "sample_correction_mode": correction, "sample_bc_ori": ori})
    _same(tmp_path / "port", tmp_path / "ref")
    info = json.loads((tmp_path / "port" / "gpl" / "sample_info.json").read_text())
    assert info["sample_bc_ori"] == ori.capitalize()
    truth = json.loads((hard_flex / "truth_flex.json").read_text())
    # exact correction drops every read with a sample-barcode error
    exact = correction == "exact"
    assert (info["unmatched_reads"] >= truth["sample_bc_1sub"]) == exact


def test_hard_flex_compressed_collate_matches_reference(hard_flex, tmp_path):
    """collate -c writes map.collated.rad.sz, the same bytes as one snappy
    stream, and quant reads it."""
    cm = _run_port(hard_flex, tmp_path / "port", gpl=["-u", str(hard_flex / "permit.txt")],
                   collate=["-c"])
    run_reference_flex(hard_flex, tmp_path / "ref", cm, compress=True, threads=2)
    _same(tmp_path / "port", tmp_path / "ref", compressed=True)


@pytest.fixture(scope="module")
def hard_flex_collated(hard_flex, tmp_path_factory):
    """The port's gpl (unfiltered list) and collate on hard_flex."""
    out = tmp_path_factory.mktemp("hard_flex_run")
    cm = _run_port(hard_flex, out, gpl=["-u", str(hard_flex / "permit.txt")])
    return out, cm


QUANTS = {
    "cr-like": (["-r", "cr-like"], {"resolution": "cr-like"}),
    "trivial": (["-r", "trivial"], {"resolution": "trivial"}),
    "cr-like-em": (["-r", "cr-like-em"], {"resolution": "cr-like-em"}),
    "parsimony": (["-r", "parsimony"], {"resolution": "parsimony"}),
    "cr-like-d": (["-r", "cr-like", "-d"], {"resolution": "cr-like", "dump_eq": True}),
    "parsimony-em-d": (["-r", "parsimony-em", "-d"],
                       {"resolution": "parsimony-em", "dump_eq": True}),
}


@pytest.mark.parametrize("name", list(QUANTS))
def test_hard_flex_quant_resolutions_match_reference(hard_flex, hard_flex_collated, tmp_path,
                                                     monkeypatch, name):
    """The sample branch sits above quant's dispatch: the row prefixes,
    the sample column and every matrix under each resolution, with the
    cells streamed in several blocks (per-block results merged)."""
    from reference_host_path import run_reference_quant

    flags, ref_opts = QUANTS[name]
    out, cm = hard_flex_collated
    monkeypatch.setattr(quant, "QUANT_BLOCK_RECORDS", 15_000)
    argv = ["quant", "-i", str(out / "gpl"), "-m", str(hard_flex / "t2g.tsv"),
            "-o", str(tmp_path / "port" / "quant"), *flags, "-t", "2", "--device", "cpu"]
    assert port_main(argv) == 0
    run_reference_quant(out / "gpl", tmp_path / "ref" / "quant", hard_flex / "t2g.tsv",
                        "alevin-fry-tpu " + " ".join(argv), 2, **ref_opts)
    arts = [a for a in flex_artifacts(out) if a.startswith("quant/")]
    if ref_opts.get("dump_eq"):
        arts += ["quant/alevin/geqc_counts.mtx", "quant/alevin/gene_eqclass.txt.gz"]
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref", arts,
                               ["quant/quant.json"]) == []
    fd = (tmp_path / "port" / "quant" / "featureDump.txt").read_text().splitlines()
    assert fd[0].startswith("CB\tsample_name\t") and len(fd) > 300
    # cells of 100 records and more took the resolution's own path
    nrec = np.asarray([int(line.split("\t")[3]) for line in fd[1:]])
    assert (nrec >= 100).any() and (nrec < 100).any()


def test_flex_collate_refuses_keys_past_64_bits(hard_flex, hard_flex_collated, tmp_path):
    """Four samples need two bits beside 32-base cell barcodes' 64: both
    packages refuse with the reference's message."""
    out, _cm = hard_flex_collated
    gpl = tmp_path / "gpl"
    shutil.copytree(out / "gpl", gpl)
    for fp in gpl.glob("sample_*/permit_freq.bin"):
        _bclen, k, v = bincodeio.read_permit_freq(fp)
        bincodeio.write_permit_freq(fp, 32, k, v)
    rad = hard_flex / "rad"
    with pytest.raises(ValueError) as port_err:
        port_main(["collate", "-i", str(gpl), "-r", str(rad), "--device", "cpu"])
    with pytest.raises(ValueError) as ref_err:
        ref_collate(gpl, rad, 2)
    assert str(port_err.value) == str(ref_err.value)
    assert "4 samples requires 2 bits plus 64 bits" in str(port_err.value)


# --- K4 in the fast collate's 1-edit tier ------------------------------------

def _tier_case(rng, length: int, nk: int):
    """A unique sorted kept list and queries (none of them kept) with 0,
    1 and 2 or more kept codes within Hamming distance 1."""
    mask = np.uint64((1 << (2 * length)) - 1)
    kept = np.unique(rng.randint(0, 1 << 62, nk, dtype=np.int64).astype(np.uint64) & mask)
    # pairs of kept codes one substitution apart: a code between them is
    # within distance 1 of both
    pos = rng.randint(0, length, len(kept) // 4).astype(np.uint64) * np.uint64(2)
    twins = kept[: len(pos)] ^ (np.uint64(1) << pos)
    kept = np.unique(np.concatenate([kept, twins]))
    picks = kept[rng.randint(0, len(kept), 3000)]
    shift = rng.randint(0, length, 3000).astype(np.uint64) * np.uint64(2)
    one_edit = picks ^ (np.uint64(rng.randint(1, 4)) << shift)
    two_edit = one_edit ^ (np.uint64(3) << ((shift + np.uint64(2)) % np.uint64(2 * length)))
    between = twins ^ (np.uint64(2) << pos[: len(twins)])
    far = rng.randint(0, 1 << 62, 3000, dtype=np.int64).astype(np.uint64) & mask
    queries = np.concatenate([one_edit, two_edit, between, far])
    return kept, np.setdiff1d(queries, kept)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("length", [8, 16, 32])
def test_k4_twin_equals_the_reference_collate_tier(length, native, monkeypatch):
    """The port's find_neighbors (K4's twin on the CPU) and the
    reference's find_neighbors_batch (native or NumPy) give equal counts
    on unique sorted kept lists, and equal representatives wherever the
    count is 1, the only case the tier keeps."""
    if not native:
        monkeypatch.setattr(ref_native, "_LIB", None)
        monkeypatch.setattr(ref_native, "_TRIED", True)
    assert ref_native.available() == native
    import torch

    kept, queries = _tier_case(np.random.RandomState(length), length, 4000)
    got_n, got_rep = port_barcodes.find_neighbors(queries, kept, length, torch.device("cpu"))
    want_n, want_rep = ref_find_neighbors_batch(queries, kept, length)
    np.testing.assert_array_equal(got_n, want_n)
    one = got_n == 1
    np.testing.assert_array_equal(got_rep[one], want_rep[one])
    assert {0, 1, 2} <= set(got_n.tolist())


# --- the composite lookup: a hand-built case ----------------------------------

CELL_BC_LEN, CASE_READS = 16, 100
_X, _Y, _P, _Q, _R = (make_packed_bc(i, CELL_BC_LEN) for i in (11, 12, 13, 14, 15))
# one substitution from X; two cells each one substitution from Y
_X1, _Y1, _Y2 = _X ^ 1, _Y ^ (1 << 6), _Y ^ (2 << 20)
_SAMPLES = [(n, make_packed_bc(100 + 37 * i, SAMPLE_BC_LEN))
            for i, n in enumerate(("sample_a", "sample_b", "sample_c"))]
_A, _B, _C = (bc for _n, bc in _SAMPLES)
_B_EDIT = _B ^ (3 << 4)               # one substitution from B's probe barcode
_UNLISTED = make_packed_bc(999, SAMPLE_BC_LEN)
# (probe barcode, cell barcode, reads in hundreds, forward); gpl reads the
# first list, collate both
GPL_READS = [(_A, _X, 30, True), (_A, _P, 25, True), (_A, _R, 24, True), (_B, _X1, 30, True),
             (_B, _Y1, 25, True), (_B, _Y2, 24, True), (_B, _Q, 20, True),
             (_B_EDIT, _Q, 1.5, True), (_UNLISTED, _P, 4, True), (_A, _P, 3, False)]
COLLATE_ONLY_READS = [
    (_B, _X, 7, True),          # X is A's cell; in B only X1 is listed: rescued to X1
    (_B, _Y, 6, True),          # Y1 and Y2 are both listed in B: dropped
    (_B_EDIT, _X, 2, True),     # a corrected probe barcode, its cell rescued in B
]
# C had no reads in gpl, so it has no permit_freq.bin: its reads drop
C_READS = [(_C, _P, 5, True), (_C, _X, 5, True)]
# the counts the case must give (a hundred reads a unit)
CASE_COUNTS = {"sample_exact": 17_800, "sample_corrected": 150, "sample_dropped": 400,
               "tier_exact": 17_950, "tier_queries": 2_500, "tier_rescued": 900,
               "tier_dropped": 1_600}
CASE_ARTIFACTS = ("gpl/sample_permit_map.bin", "gpl/map.collated.rad",
                  "gpl/collation_manifest.bin", "gpl/unmapped_bc_count_collated.bin",
                  "gpl/sample_sample_a/permit_map.bin", "gpl/sample_sample_a/permit_freq.bin",
                  "gpl/sample_sample_b/permit_map.bin", "gpl/sample_sample_b/permit_freq.bin")
CASE_JSONS = ("gpl/generate_permit_list.json", "gpl/sample_info.json", "gpl/collate.json")


def _write_case_rad(path: Path, groups) -> None:
    prelude, ftv = make_multi_bc_prelude([f"gene_{i}" for i in range(NUM_REFS)],
                                         SAMPLE_BC_LEN, CELL_BC_LEN, 12)
    path.parent.mkdir(parents=True)
    with open(path, "wb") as fh:
        w = RadWriter(fh, prelude, ftv)
        for g, (sbc, cbc, hundreds, forward) in enumerate(groups):
            n = int(hundreds * CASE_READS)
            w.write_chunk(
                read_cols={"b0": np.full(n, sbc, np.uint64), "b1": np.full(n, cbc, np.uint64),
                           "u": (np.arange(n, dtype=np.uint64) + np.uint64(g << 16))},
                aln_offsets=np.arange(n + 1, dtype=np.int64),
                refs=(np.arange(n) % NUM_REFS).astype(np.uint32),
                dirs=np.full(n, forward, bool),
            )
        w.finalize()


@pytest.fixture(scope="module")
def case_data(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("composite_case")
    _write_case_rad(d / "rad_gpl" / "map.rad", GPL_READS)
    _write_case_rad(d / "rad" / "map.rad", GPL_READS + COLLATE_ONLY_READS + C_READS)
    _write_case_rad(d / "rad_ref" / "map.rad", GPL_READS + COLLATE_ONLY_READS)
    (d / "samples.tsv").write_text("".join(
        f"{unpack_seq(bc, SAMPLE_BC_LEN)}\t{name}\n" for name, bc in _SAMPLES))
    return d


def _run_reference_case(d: Path, out: Path, mode: str, cm: dict) -> None:
    """The reference's gpl and collate of the case into ``out/gpl``, with
    the port's command lines ``cm``; its collate reads ``d/rad_ref``."""
    with host_policies():
        from alevin_fry_tpu.pipeline.gpl import (
            CellFilterMethod, GenPermitListOpts, generate_permit_list,
        )

        generate_permit_list(GenPermitListOpts(
            input_dir=d / "rad_gpl", output_dir=out / "gpl",
            fmeth=CellFilterMethod("force", count=4), expected_ori="fw", threads=2,
            cmdline=cm["gpl"], sample_bc_list=d / "samples.tsv",
            sample_correction_mode="1-edit",
        ))
        ref_collate(out / "gpl", d / "rad_ref", 2, cmdline=cm["collate"], collation_mode=mode)


def _run_case(d: Path, out: Path, mode: str, max_records=None) -> tuple:
    """The port's gpl (``-f 4``, 1-edit sample correction) on ``d/rad_gpl``
    and its collate on ``d/rad``; returns the command lines and the two
    roots' counts."""
    argvs = {
        "gpl": ["generate-permit-list", "-i", str(d / "rad_gpl"), "-d", "fw", "-o",
                str(out / "gpl"), "-f", "4", "--sample-bc-list", str(d / "samples.tsv"),
                "--sample-correction-mode", "1-edit"],
        "collate": ["collate", "-i", str(out / "gpl"), "-r", str(d / "rad"),
                    "--collation-mode", mode,
                    *(["-m", str(max_records)] if max_records else [])],
    }
    counts = {}
    for argv in argvs.values():
        argv += ["-t", "2", "--device", "cpu"]
        n0 = len(spans.SPANS)
        assert port_main(argv) == 0
        root = spans.SPANS[-1]
        assert root.parent is None and len(spans.SPANS) > n0
        counts.update({k: v for k, v in root.attrs.items() if k in CASE_COUNTS})
    return {k: "alevin-fry-tpu " + " ".join(v) for k, v in argvs.items()}, counts


@pytest.fixture(scope="module")
def case_default(case_data, tmp_path_factory):
    """The default run of the case (K4, the native library) in each mode,
    in memory and out of core: each mode's artifacts' bytes and counts."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("AFT_RESCUE_BACKEND", raising=False)
        for mode in ("fast", "two-round"):
            for max_records in (None, 5_000):
                run = tmp_path_factory.mktemp(f"case_{mode}")
                _cm, counts = _run_case(case_data, run, mode, max_records)
                out[mode, max_records] = (
                    {a: (run / a).read_bytes() for a in CASE_ARTIFACTS}, counts)
    return out


@pytest.mark.parametrize("mode", ["fast", "two-round"])
def test_composite_case_matches_reference(case_data, tmp_path, mode):
    """A cell listed in sample A and read in sample B, where only its
    1-edit neighbour is listed, is rescued to that neighbour within B; a
    read of B with two listed 1-edit neighbours drops, and so do the
    reads of a sample without ``permit_freq.bin`` and of a probe barcode
    that maps to no sample: the port's gpl and collate, in memory and out
    of core, write the reference's bytes, and the fast mode counts what
    the case holds.  The reference's fast collate raises on reads of a
    sample without ``permit_freq.bin`` (an empty identity search), so it
    collates the reads without C's: all of those drop, so the bytes are
    the same."""
    cm, counts = _run_case(case_data, tmp_path / "port", mode)
    smk, _smv = bincodeio.read_u64_map_file(tmp_path / "port" / "gpl" / "sample_permit_map.bin")
    assert _B_EDIT in set(smk.tolist()) and _UNLISTED not in set(smk.tolist())
    assert not (tmp_path / "port" / "gpl" / "sample_sample_c").exists()
    _run_reference_case(case_data, tmp_path / "ref", mode, cm)
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref", CASE_ARTIFACTS,
                               CASE_JSONS) == []
    want = dict(CASE_COUNTS)
    if mode == "two-round":
        want = {k: v for k, v in want.items() if k.startswith("sample_")}
    assert counts == want
    # X1 took the reads of X in B; no read kept Y or sample C
    with open(tmp_path / "port" / "gpl" / "map.collated.rad", "rb") as fh:
        prelude, _ftm, _ = read_prelude(fh)
        batch = decode_all_chunks(fh, RecordSchema.from_prelude(prelude),
                                  prelude.hdr.num_chunks)
    keys, n = np.unique(np.stack([batch.barcode(0), batch.barcode(-1)], 1), axis=0,
                        return_counts=True)
    pairs = {(int(s), int(c)): int(k) for (s, c), k in zip(keys, n)}
    assert pairs[1, _X1] == 3_900
    assert _Y not in {c for _s, c in pairs} and {s for s, _c in pairs} == {0, 1}
    # out of core: the same bytes
    assert port_main(["collate", "-i", str(tmp_path / "port" / "gpl"), "-r",
                      str(case_data / "rad"), "--collation-mode", mode, "-m", "5000",
                      "--device", "cpu"]) == 0
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref", CASE_ARTIFACTS,
                               CASE_JSONS[:2]) == []


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("backend", [None, "pallas"])
@pytest.mark.parametrize("mode", ["fast", "two-round"])
def test_composite_case_is_the_same_under_each_rescue_backend_and_lookup(
        case_data, case_default, tmp_path, mode, backend, native, monkeypatch):
    """K4 or K5 (``AFT_RESCUE_BACKEND=pallas``) in the 1-edit tier: the
    same bytes and counts as the default run, in memory and out of core;
    and the reference without its native codec (binary search for every
    lookup, NumPy for its 1-edit tier) writes those bytes too."""
    if backend:
        monkeypatch.setenv("AFT_RESCUE_BACKEND", backend)
    for max_records in (None, 5_000):
        run = tmp_path / f"run_{max_records}"
        cm, counts = _run_case(case_data, run, mode, max_records)
        arts, want = case_default[mode, max_records]
        assert {a: (run / a).read_bytes() for a in CASE_ARTIFACTS} == arts
        assert counts == want
        if max_records is None:
            cm_in_memory = cm
    if not native:
        monkeypatch.setattr(ref_native, "_LIB", None)
        monkeypatch.setattr(ref_native, "_TRIED", True)
        assert not ref_native.available()
        _run_reference_case(case_data, tmp_path / "ref", mode, cm_in_memory)
        # the gpl JSON records each run's command line, so only the
        # in-memory run's (the reference's) compares
        for max_records, jsons in ((None, CASE_JSONS[:2]), (5_000, ())):
            assert artifact_mismatches(tmp_path / f"run_{max_records}", tmp_path / "ref",
                                       CASE_ARTIFACTS, jsons) == []
