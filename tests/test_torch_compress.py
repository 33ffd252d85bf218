"""Compressed output (``-c``) of the port against the reference package:
the snappy framing codec (alevin_fry_tpu_torch/radz/snappyz.py) against
``alevin_fry_tpu/radz/snappyz.py``, and against that package's pure
path without its native codec; RNA ``collate -c`` from the byte-level,
columnar and out-of-core writers, and quant from the ``.sz``; the ATAC
``sort -c`` (``map.bed.gz``), ``collate -c`` and deduplicate from the
``.sz``.

Snappy streams and RAD files must match byte for byte, a gzip file in
its decompressed bytes and its header apart from the MTIME field, and
the stage JSONs field for field without the fields naming each run's
directories (tests/reference_host_path.py).  The reference's pure path
stores every snappy chunk as it is, where the port compresses: there
the streams must be equal, and each side's reader must read the other's
file.  Inputs come from numpy seeds (synth_hard, RandomState).
"""

import gzip
import io
import struct

import numpy as np
import pytest

from alevin_fry_tpu.radz import _native as ref_native
from alevin_fry_tpu.radz import snappyz as ref_snappyz
from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.pipeline import collate
from alevin_fry_tpu_torch.radz import _native, snappyz
from reference_host_path import (
    ATAC_STAGE_JSONS, STAGE_JSONS, artifact_mismatches, atac_artifacts, gzip_differs,
    rna_artifacts, run_reference, run_reference_atac,
)
from synth_hard import make_hard_atac_dataset, make_hard_dataset
from test_torch_atac import run_port_atac


@pytest.fixture(autouse=True)
def _port_rescue_env(monkeypatch):
    """The port reads AFT_RESCUE_BACKEND, where ``host`` raises; a
    reference test module in the same process may have set it."""
    monkeypatch.delenv("AFT_RESCUE_BACKEND", raising=False)


def _no_ref_native(monkeypatch):
    """The reference without its native codec: its pure paths."""
    monkeypatch.setattr(ref_native, "_LIB", None)
    monkeypatch.setattr(ref_native, "_TRIED", True)
    assert not ref_native.available()


def _read_across(port: bytes, ref: bytes) -> bytes:
    """The stream of two framing files, the port's and the reference's,
    read by each package's reader: all four reads must agree."""
    got = {reader(io.BytesIO(f)).read() for f in (port, ref)
           for reader in (snappyz.SnappyFrameReader, ref_snappyz.SnappyFrameReader)}
    assert len(got) == 1
    return got.pop()


def _chunk_types(stream: bytes) -> list:
    types, pos = [], 0
    while pos < len(stream):
        word = struct.unpack_from("<I", stream, pos)[0]
        types.append(word & 0xFF)
        pos += 4 + (word >> 8)
    return types


def _streams() -> dict:
    rng = np.random.RandomState(21)
    records = np.repeat(rng.randint(0, 50, 30_000).astype(np.uint32), 3).tobytes()
    return {
        "empty": b"",
        "one byte": b"\x07",
        "chunk - 1": records[:65535],
        "chunk": records[:65536],
        "chunk + 1": records[:65537],
        "records": records,
        "runs": b"ab" * 40_000 + bytes(range(256)) * 300,
        "random": rng.randint(0, 256, 150_000).astype(np.uint8).tobytes(),
    }


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("case", list(_streams()))
def test_snappy_frames_match_reference_codec(case, native, monkeypatch):
    """The same framing bytes as the reference's writer however the
    stream is cut into writes, read back by both readers; against the
    reference's pure path, which stores every chunk, the same chunking
    and stream, each file read by the other side's reader."""
    data = _streams()[case]
    if not native:
        _no_ref_native(monkeypatch)
    want = io.BytesIO()
    ref_snappyz.frame_compress_stream(data, want)
    cuts = sorted(np.random.RandomState(len(data)).randint(0, len(data) + 1, 7).tolist())
    outs = set()
    for bounds in ([0, len(data)], [0, *cuts, len(data)]):
        got = io.BytesIO()
        w = snappyz.SnappyFrameWriter(got)
        for a, b in zip(bounds[:-1], bounds[1:]):
            w.write(data[a:b])
        w.flush()
        outs.add(got.getvalue())
    assert len(outs) == 1
    port = outs.pop()
    types, ref_types = _chunk_types(port), _chunk_types(want.getvalue())
    assert types[0] == 0xFF and len(types) == 1 + -(-len(data) // 65536) == len(ref_types)
    if case in ("records", "runs"):
        assert 0x00 in types  # block-compressed chunks
    if native:
        assert port == want.getvalue()
    else:
        assert set(ref_types[1:]) <= {0x01}
    assert _read_across(port, want.getvalue()) == data


def test_snappy_reader_seeks_and_drops_history(monkeypatch):
    """Reads in pieces, a seek back within the history, forward seeks
    that decode further chunks, and no seek back once history is
    dropped; the reference's pure-Python block decoder decodes the
    port's blocks (overlapping copies among them), and its CRC-32C table
    gives the port's checksums."""
    data = _streams()["runs"] + _streams()["records"]
    big = data * 12  # past the 4 MiB the reader keeps before trimming
    buf = io.BytesIO()
    snappyz.frame_compress_stream(big, buf)
    r = snappyz.SnappyFrameReader(io.BytesIO(buf.getvalue()))
    assert r.read(100) == big[:100]
    assert r.seek(-60, 1) == 40 and r.read(10) == big[40:50]
    r.drop_history()
    at = 5_000_000
    assert r.seek(at) == at and r.read(5) == big[at:at + 5] and r.tell() == at + 5
    with pytest.raises(OSError):
        r.seek(0)
    assert r.read() == big[at + 5:] and r.read(3) == b""
    blocks = [_native.snappy_compress(data[s:s + 65536]) for s in range(0, len(data), 65536)]
    assert b"".join(snappyz.block_decompress(b) for b in blocks) == data
    crcs = [_native.crc32c(data[:1000]), _native.crc32c(b"")]
    _no_ref_native(monkeypatch)
    assert b"".join(ref_snappyz.block_decompress(b) for b in blocks) == data
    assert [ref_snappyz.crc32c(data[:1000]), ref_snappyz.crc32c(b"")] == crcs
    assert snappyz.block_decompress(ref_snappyz.block_compress_literal(data[:70_000])) == \
        data[:70_000]


@pytest.fixture(scope="module")
def hard_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("hard_compress")
    make_hard_dataset(d, np.random.RandomState(17), n_cells=300, n_reads=120_000,
                      n_genes=400)
    return d


def _run_rna(d, out, collate_args) -> dict:
    dev = ["-t", "2", "--device", "cpu"]
    stages = {
        "gpl": ["generate-permit-list", "-i", str(d / "rad"), "-d", "fw",
                "-o", str(out / "gpl"), "-u", str(d / "permit.txt"), "-m", "10", *dev],
        "collate": ["collate", "-i", str(out / "gpl"), "-r", str(d / "rad"),
                    *collate_args, *dev],
        "quant": ["quant", "-i", str(out / "gpl"), "-m", str(d / "t2g_3col.tsv"),
                  "-o", str(out / "quant"), "-r", "cr-like", *dev],
    }
    for argv in stages.values():
        assert port_main(argv) == 0
    return {k: "alevin-fry-tpu " + " ".join(v) for k, v in stages.items()}


# writer -> (collate -m, the port's byte-level path off, the reference
# without its native codec)
RNA_WRITERS = {
    "byte-level": (30_000_000, False, False),
    "columnar": (30_000_000, True, False),
    "out of core, -m 40": (40, False, False),
    "out of core, -m 700": (700, False, False),
    "no native codec": (30_000_000, False, True),
}


@pytest.mark.parametrize("writer", list(RNA_WRITERS))
def test_rna_collate_compressed_matches_reference(hard_data, tmp_path, writer, monkeypatch):
    """Each of the port's collate writers gives the reference's
    map.collated.rad.sz, and quant reads it to the reference's
    matrices; the reference without its native codec stores the chunks
    as they are, so there the two files hold the same stream, and each
    side's reader reads the other's file."""
    max_records, columnar, no_native = RNA_WRITERS[writer]
    monkeypatch.setattr(collate, "COLLATE_BLOCK_RECORDS", 30_000)
    if columnar:
        monkeypatch.setattr(collate, "_collate_in_memory_native", lambda *a, **k: False)
    if no_native:
        _no_ref_native(monkeypatch)
    cmdlines = _run_rna(hard_data, tmp_path / "port", ["-c", "-m", str(max_records)])
    run_reference(hard_data, tmp_path / "ref", cmdlines, True, threads=2, compress=True,
                  max_records=max_records)
    sz = "gpl/map.collated.rad.sz"
    names = [n for n in rna_artifacts(compressed=True) if not (no_native and n == sz)]
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref", names, STAGE_JSONS) == []
    gpl = tmp_path / "port" / "gpl"
    assert not (gpl / "map.collated.rad").exists() and not (gpl / "_collate_tmp").exists()
    port, ref = (tmp_path / "port" / sz).read_bytes(), (tmp_path / "ref" / sz).read_bytes()
    types = _chunk_types(port)
    assert len(types) > 10 and 0x00 in types
    assert (0x00 in _chunk_types(ref)) != no_native
    assert len(_read_across(port, ref)) > 0


def test_quant_from_sz_equals_quant_from_rad(hard_data, tmp_path):
    """The same collation, written plain and compressed: quant writes
    the same four artifacts from either."""
    _run_rna(hard_data, tmp_path / "plain", [])
    _run_rna(hard_data, tmp_path / "sz", ["-c"])
    names = [n for n in rna_artifacts() if n.startswith("quant/")]
    assert len(names) == 4
    for n in names:
        assert (tmp_path / "plain" / n).read_bytes() == (tmp_path / "sz" / n).read_bytes(), n
    with collate.open_collated(tmp_path / "sz" / "gpl") as (fh, _prelude, _ftm):
        body = fh.read()
    plain = (tmp_path / "plain" / "gpl" / "map.collated.rad").read_bytes()
    assert len(body) > 0 and plain.endswith(body)


@pytest.fixture(scope="module")
def atac_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("atac_compress")
    make_hard_atac_dataset(d, np.random.RandomState(19), n_cells=150, n_frags=40_000,
                           n_chrs=3, chr_len=2_000_000, ambient_factor=8)
    return d


@pytest.mark.parametrize("max_records,no_native", [
    (30_000_000, False), (5_000, False), (30_000_000, True),
])
def test_atac_compressed_matches_reference(atac_data, tmp_path, max_records, no_native,
                                           monkeypatch):
    """sort -c writes map.bed.gz, collate -c map.collated.rad.sz, and
    deduplicate reads it: in memory, out of core and against the
    reference without its native codec (whose ``.sz`` stores its chunks:
    the same stream, each side's reader reading the other's file),
    equal to the reference (map.bed.gz up to its MTIME)."""
    monkeypatch.setattr(collate, "COLLATE_BLOCK_RECORDS", 7_000)
    if no_native:
        _no_ref_native(monkeypatch)
    cmdlines, stats = run_port_atac(atac_data, tmp_path / "port", max_records, 10,
                                    monkeypatch, compress=True)
    _secs, ref_stats = run_reference_atac(atac_data, tmp_path / "ref", cmdlines, 10,
                                          max_records, threads=2, compress=True)
    sz = "gpl/map.collated.rad.sz"
    names = [n for n in atac_artifacts(compressed=True) if not (no_native and n == sz)]
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref", names,
                               ATAC_STAGE_JSONS) == []
    assert len(_read_across((tmp_path / "port" / sz).read_bytes(),
                            (tmp_path / "ref" / sz).read_bytes())) > 0
    assert stats == ref_stats and all(stats.values())
    bed = gzip.decompress((tmp_path / "port" / "sort" / "map.bed.gz").read_bytes())
    assert bed.count(b"\n") > 100
    assert gzip_differs(gzip.compress(bed), gzip.compress(bed[:-1]))
