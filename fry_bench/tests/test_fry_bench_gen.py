"""The generators are deterministic by seed, and the benchmark's RAD
writer's files read back through the port's own reader."""

import numpy as np
import pytest

from fry_bench.tests.conftest import tiny_cell


def _make(cell, seed, d):
    import importlib

    gen = importlib.import_module(f"fry_bench.gen.{cell.config['generator']}")
    return gen.make(d, seed, **cell.config["sizes"])


def _files(d):
    return {p.relative_to(d).as_posix(): p.read_bytes() for p in sorted(d.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("name", ["rna_10xv3_usa.crlike", "atac_10x.sort"])
def test_same_seed_same_data_other_seed_other_data(name, tmp_path):
    cell = tiny_cell(name)
    seed = 2 ** 33 + 17  # more than 32 bits
    a = _make(cell, seed, tmp_path / "a")
    b = _make(cell, seed, tmp_path / "b")
    c = _make(cell, seed + 1, tmp_path / "c")
    assert _files(tmp_path / "a") == _files(tmp_path / "b")
    assert _files(tmp_path / "a")["rad/map.rad"] != _files(tmp_path / "c")["rad/map.rad"]
    assert np.array_equal(a["bc"], b["bc"]) and not np.array_equal(a["bc"], c["bc"])
    assert a["n_records"] == b["n_records"] > 0


def _decode(path):
    from alevin_fry_tpu_torch.radz import read_prelude
    from alevin_fry_tpu_torch.radz.chunkio import decode_all_chunks
    from alevin_fry_tpu_torch.radz.records import RecordSchema

    with open(path, "rb") as fh:
        prelude, ftm, _ = read_prelude(fh)
        schema = RecordSchema.from_prelude(prelude)
        return prelude, ftm, decode_all_chunks(fh, schema, prelude.hdr.num_chunks)


def test_rna_rad_reads_back_through_the_port(tmp_path):
    cell = tiny_cell("rna_10xv3_usa.crlike")
    data = _make(cell, 5, tmp_path)
    prelude, ftm, batch = _decode(tmp_path / "rad" / "map.rad")
    assert list(prelude.hdr.ref_names) == data["ref_names"]
    assert prelude.hdr.num_chunks == data["num_chunks"]
    assert (ftm["cblen"], ftm["ulen"]) == (16, 12)
    assert np.array_equal(batch.barcode(), data["bc"])
    assert np.array_equal(batch.read_cols["u"], data["umi"])
    assert np.array_equal(batch.aln_offsets, data["aln_offsets"])
    assert np.array_equal(batch.refs, data["refs"])
    assert np.array_equal(batch.dirs, data["dirs"])


def test_atac_rad_reads_back_through_the_port(tmp_path):
    cell = tiny_cell("atac_10x.sort")
    data = _make(cell, 6, tmp_path)
    prelude, ftm, batch = _decode(tmp_path / "rad" / "map.rad")
    assert list(prelude.hdr.ref_names) == data["ref_names"]
    assert np.array_equal(ftm["ref_lengths"], data["ref_lens"])
    assert np.array_equal(batch.barcode(), data["bc"])
    assert np.array_equal(batch.aln_offsets, data["aln_offsets"])
    assert np.array_equal(batch.refs, data["chr"])
    for col in ("type", "start_pos", "frag_len"):
        want = data["start" if col == "start_pos" else col]
        assert np.array_equal(batch.aln_cols[col], want)


def test_unmapped_counts_and_lists_read_back(tmp_path):
    from alevin_fry_tpu_torch.radz import unmapped
    from alevin_fry_tpu_torch.utils import read_barcode_file

    from fry_bench.gen import rad

    data = _make(tiny_cell("rna_10xv3_usa.crlike"), 8, tmp_path)
    bcs, cts = unmapped.read_raw_unmapped(tmp_path / "rad" / "unmapped_bc_count.bin")
    order = np.argsort(bcs)
    assert np.array_equal(bcs[order], data["unmapped_bc"])
    assert np.array_equal(cts[order], data["unmapped_ct"])
    listed, length = read_barcode_file(tmp_path / "permit.txt")
    assert length == 16 and np.array_equal(listed, data["permit"])
    adata = _make(tiny_cell("atac_10x.sort"), 8, tmp_path / "atac")
    wl, _ = read_barcode_file(tmp_path / "atac" / "wl.txt")
    assert np.array_equal(rad.revcomp(wl, 16), adata["permit"])
