"""The port's two whole-input passes of generate-permit-list, against the
reference package on the CPU: the barcode-list reader
(``utils.read_barcode_file``, parsed in bulk from the file's bytes) and
ATAC's genomic-bin count (``np.bincount`` over each gpl block).

The reader must give the reference's packed array and length on every
input, or raise ``ValueError`` with the text of the reference's
assertion; the sorted set the callers take of it must be
``np.unique``'s.  The bins must come out byte-identical in ``bin_recs.bin``
however the input is cut into gpl blocks.
"""

import gzip
from pathlib import Path

import numpy as np
import pytest

from alevin_fry_tpu.utils import read_barcode_file as ref_read_barcode_file
from alevin_fry_tpu_torch import spans
from alevin_fry_tpu_torch.atac import gpl as port_atac_gpl
from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.ops.barcodes import pack_seq, revcomp_packed, unpack_seqs_to_strings
from alevin_fry_tpu_torch.utils import read_barcode_file, sorted_unique
from reference_host_path import host_policies
from synth import write_atac_rad


def _gz(raw: bytes) -> bytes:
    return gzip.compress(raw, mtime=0)


# (file bytes, bclen)
READER_CASES = {
    "plain": (b"ACGTACGT\nTTTTGGGG\nCCCCAAAA\n", None),
    "gzip": (_gz(b"ACGTACGT\nTTTTGGGG\nCCCCAAAA\n"), None),
    "gzip_two_members": (_gz(b"ACGTA\nTTT") + _gz(b"GC\nGGGGA\n"), None),
    "crlf": (b"ACGTACGT\r\nTTTTGGGG\r\nCCCCAAAA\r\n", None),
    "blank_and_whitespace_lines": (b"\n\nACGTA\n   \n\t\r\nTTTTG\n\x0b\x0c\n\n", None),
    "leading_trailing_spaces_tabs": (b"  ACGTA\t\n\tTTTTG  \n \t GGGGC\t \r\n", None),
    "no_final_newline": (b"ACGTACGT\nTTTTGGGG", None),
    "lowercase_and_n": (b"acgtnNNa\nNNNNNNNN\nACgtNnTt\n", None),
    "bytes_outside_the_bases": (b"AC-TA\nA C T\nZZZZ\x00\n", None),
    "bclen_given": (b"ACGTACGT\nTTTTGGGG\n", 8),
    "bclen_mismatching": (b"ACGTACGT\nTTTTGGGG\n", 7),
    "empty_file": (b"", None),
    "empty_file_bclen": (b"", 16),
    "only_whitespace": (b" \n\t\r\n\n", None),
    "mixed_lengths_mid_file": (b"ACGTA\nACGTA\n  ACGTA \nACGT\nACGTAC\n", None),
}


def _read(fn, path, bclen, error):
    try:
        return fn(path, bclen)
    except error as ex:
        return str(ex)


@pytest.mark.parametrize("case", list(READER_CASES))
def test_read_barcode_file_matches_reference(case, tmp_path):
    """Packed array, its order and dtype, and the length, or the error
    text, exactly as the reference's line-by-line reader gives them; the
    open span counts the entries parsed."""
    raw, bclen = READER_CASES[case]
    path = tmp_path / "list.txt"
    path.write_bytes(raw)
    want = _read(ref_read_barcode_file, path, bclen, AssertionError)
    with spans.span("list_parse", "codec") as sp:
        got = _read(read_barcode_file, path, bclen, ValueError)
    if isinstance(want, str):
        assert got == want
        return
    assert not isinstance(got, str), got
    assert got[1] == want[1]
    assert got[0].dtype == want[0].dtype == np.uint64
    np.testing.assert_array_equal(got[0], want[0])
    assert sp.attrs["listed"] == len(want[0])


@pytest.mark.parametrize("values", [
    [], [7], [3, 1, 3, 3, 0, 1], list(range(50, 0, -1)) * 2,
    [2**64 - 1, 0, 2**63, 2**63 - 1, 2**63, 5, 2**64 - 1],
], ids=["empty", "one", "repeats", "reversed_twice", "past_2_63"])
def test_sorted_unique_matches_np_unique(values):
    """The lists' sorted set: ``np.unique``'s values, order and dtype."""
    a = np.asarray(values, np.uint64)
    got = sorted_unique(a)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, np.unique(a))


def _atac_blocks_data(d: Path, ref_lens=(250_000, 150_000), past_end: bool = False) -> Path:
    """An ATAC RAD file of 8-base barcodes in four chunks: two of
    fragments, one of multimapped fragments only (a block with no bin to
    count), then an empty chunk (an empty block), with its
    reverse-complement whitelist.  ``past_end`` places one fragment past
    the last reference's end, in a bin past the last one."""
    rng = np.random.RandomState(7)
    cells = ["AAAAAAAA", "CCCCCCCC", "AAAAAAAT", "GGGGTTTT"]

    def frag(chrom):
        return (chrom, 4, int(rng.randint(0, ref_lens[chrom])), int(rng.randint(50, 2500)))

    def unique(n):
        return [(pack_seq(cells[rng.randint(4)]), [frag(int(rng.randint(2)))]) for _ in range(n)]

    multi = [(pack_seq(cells[rng.randint(4)]), [frag(0), frag(1)]) for _ in range(30)]
    chunks = [unique(70), unique(60), multi, []]
    if past_end:
        chunks[1].append((pack_seq(cells[0]), [(1, 4, ref_lens[1] + 200_000, 300)]))
    rad = d / "rad" / "map.rad"
    rad.parent.mkdir(parents=True)
    write_atac_rad(rad, ["chr1", "chr2"], list(ref_lens), chunks, bc_len=8)
    wl = revcomp_packed(np.asarray([pack_seq(c) for c in cells[:3]], np.uint64), 8)
    (d / "wl.txt").write_text("".join(b + "\n" for b in unpack_seqs_to_strings(wl, 8)))
    return d


def _port_atac_gpl(d: Path, out: Path) -> int:
    return port_main(["atac", "generate-permit-list", "-i", str(d / "rad"), "-o", str(out),
                      "-u", str(d / "wl.txt"), "-m", "3", "-t", "2", "--device", "cpu"])


@pytest.mark.parametrize("block_records", [25, 20_000_000])
def test_atac_bins_match_reference_over_blocks(block_records, tmp_path, monkeypatch):
    """``bin_recs.bin`` (and the other gpl artifacts) byte-identical to
    the reference's, with the input cut into several gpl blocks (one of
    them empty, one with no uniquely mapped fragment) or read as one."""
    monkeypatch.delenv("AFT_RESCUE_BACKEND", raising=False)
    monkeypatch.setattr(port_atac_gpl, "GPL_BLOCK_RECORDS", block_records)
    d = _atac_blocks_data(tmp_path)
    blocks = []
    real = port_atac_gpl.iter_decoded_blocks
    monkeypatch.setattr(port_atac_gpl, "iter_decoded_blocks",
                        lambda *a, **k: (blocks.append(b.n_reads) or b for b in real(*a, **k)))
    assert _port_atac_gpl(d, tmp_path / "port") == 0
    assert blocks == ([70, 60, 30, 0] if block_records == 25 else [160])
    with host_policies():
        from alevin_fry_tpu.atac.gpl import AtacGplOpts, generate_permit_list
        generate_permit_list(AtacGplOpts(
            input_dir=d / "rad", output_dir=tmp_path / "ref", unfiltered_pl=d / "wl.txt",
            min_reads=3, rc=True, threads=2,
        ))
    for name in ("bin_recs.bin", "bin_lens.bin", "permit_freq.bin", "permit_map.bin"):
        port, ref = (tmp_path / side / name for side in ("port", "ref"))
        assert port.read_bytes() == ref.read_bytes(), name
    bins = np.fromfile(tmp_path / "port" / "bin_recs.bin", np.uint64)
    assert bins[0] == 5 and bins[1:].sum() == 130  # the length, then each bin's count


def test_atac_bin_past_the_last_raises(tmp_path, monkeypatch):
    """A fragment whose bin lies past the last bin raises ``ValueError``
    (``np.bincount`` would grow the counts silently)."""
    monkeypatch.delenv("AFT_RESCUE_BACKEND", raising=False)
    d = _atac_blocks_data(tmp_path, past_end=True)
    with pytest.raises(ValueError, match="past the 5 bins"):
        _port_atac_gpl(d, tmp_path / "port")
