"""convert (BAM/SAM -> RAD) and view in the port against the reference
package, byte for byte.

Each case runs both packages on the same inputs: the cases of the
reference's own tests (tests/test_tools.py: view, SAM with and without
``--filter_best``, BAM in one gzip member, the reference's pure-Python
scanner, multi-member BGZF against plain gzip; a corrupt BAM, a corrupt
BGZF member and a CRC mismatch raise), a seeded BAM of a few thousand
records with every case convert must handle (tests/bam_cases.py) in
BGZF, plain gzip and SAM, with and without ``-f``, against the
reference's native and pure-Python scanners, across scan-batch and
chunk boundaries;
the view of the goldens' dataset; convert -> generate-permit-list ->
collate -> quant on the CPU against the reference's host path; and the
two subcommands through ``python -m alevin_fry_tpu_torch``.
"""

import gzip
import io
import os
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from alevin_fry_tpu.pipeline import convert as ref_convert
from alevin_fry_tpu.pipeline.view import view as ref_view
from alevin_fry_tpu.radz import _native as ref_native
from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.ops.barcodes import pack_seq
from alevin_fry_tpu_torch.pipeline import convert
from alevin_fry_tpu_torch.pipeline.view import view
from alevin_fry_tpu_torch.radz import _native, read_prelude
from bam_cases import bgzf_member, make_bam_dataset
from synth import write_rna_rad
from test_torch_pipeline import _check_against_reference

REPO = Path(__file__).resolve().parent.parent
# rates high enough that a few thousand records hold every case many times
TROUBLE = {"one_n": 0.03, "two_n": 0.02, "unmapped": 0.05, "supplementary": 0.05,
           "missing_as": 0.05, "b_tag": 0.05, "reverse": 0.1}


@pytest.fixture(autouse=True)
def _port_rescue_env(monkeypatch):
    """The port reads AFT_RESCUE_BACKEND, where ``host`` raises; a
    reference module imported into this process may have set it."""
    monkeypatch.delenv("AFT_RESCUE_BACKEND", raising=False)


def _without_ref_native(monkeypatch):
    """The reference without its native codec: its pure-Python scanner
    and a plain gzip stream."""
    monkeypatch.setattr(ref_native, "_LIB", None)
    monkeypatch.setattr(ref_native, "_TRIED", True)
    assert not ref_native.available()


def _both(src: Path, tmp: Path, filter_best: bool = False) -> bytes:
    """Convert ``src`` with both packages; asserts equal bytes and view
    text (with the header), returns the RAD bytes."""
    ref_convert.bam2rad(src, tmp / "ref.rad", filter_best=filter_best)
    convert.bam2rad(src, tmp / "port.rad", filter_best=filter_best)
    got = (tmp / "port.rad").read_bytes()
    assert got == (tmp / "ref.rad").read_bytes()
    assert _view_text(tmp / "port.rad", view) == _view_text(tmp / "ref.rad", ref_view)
    return got


def _view_text(rad: Path, fn, header: bool = True) -> str:
    buf = io.StringIO()
    n = fn(rad, print_header=header, out=buf)
    assert n == sum(1 for line in buf.getvalue().splitlines() if line.startswith("ID:"))
    return buf.getvalue()


# --- the reference's tool cases (tests/test_tools.py) ----------------------

def _write_sam(path, recs, refs):
    with open(path, "w") as fh:
        fh.write("@HD\tVN:1.6\n")
        for r in refs:
            fh.write(f"@SQ\tSN:{r}\tLN:1000\n")
        for qname, flag, rname, cr, ur, score in recs:
            fh.write(f"{qname}\t{flag}\t{rname}\t1\t255\t4M\t*\t0\t0\tACGT\tIIII\t"
                     f"CR:Z:{cr}\tUR:Z:{ur}\tAS:i:{score}\n")


def _bam_payload(bodies, refs) -> bytes:
    bam = io.BytesIO()
    bam.write(b"BAM\x01" + struct.pack("<i", 0) + struct.pack("<i", len(refs)))
    for nm in refs:
        bam.write(struct.pack("<i", len(nm) + 1) + nm.encode() + b"\x00" + struct.pack("<i", 1000))
    for body in bodies:
        bam.write(struct.pack("<i", len(body)) + body)
    return bam.getvalue()


def _tiny_bam_record(qname: bytes, tid: int, cr: bytes, ur: bytes, score: int) -> bytes:
    core = struct.pack("<iiBBHHHiiii", tid, 0, len(qname) + 1, 255, 0, 0, 0, 4, -1, -1, 0)
    aux = b"CRZ" + cr + b"\x00URZ" + ur + b"\x00ASi" + struct.pack("<i", score)
    return core + qname + b"\x00" + b"\x12\x48" + b"\xff" * 4 + aux


def _tool_case(name: str, tmp: Path, monkeypatch) -> Path:
    """The input of the reference test ``name`` (tests/test_tools.py)."""
    if name.startswith("sam"):
        sam = tmp / "aln.sam"
        _write_sam(sam, [
            ("r1", 0, "tx_a", "AAAA", "CCC", 10),   # forward
            ("r1", 16, "tx_b", "AAAA", "CCC", 8),   # a second alignment, reverse, lower AS
            ("r2", 16, "tx_b", "GGGG", "TTT", 5),
            ("r3", 4, "tx_a", "TTTT", "AAA", 1),    # unmapped: skipped
            ("r4", 0, "tx_a", "NNAA", "CCC", 1),    # two Ns: dropped
        ], ["tx_a", "tx_b"])
        return sam
    if name in ("bam", "bam-python"):
        if name == "bam-python":
            _without_ref_native(monkeypatch)
        p = tmp / "t.bam"
        with gzip.open(p, "wb") as fh:
            fh.write(_bam_payload([_tiny_bam_record(b"r1", 0, b"AAAA", b"CCC", 7)], ["tx_a"]))
        return p
    rng = np.random.RandomState(3)  # bgzf: 400 records in members of 777 bytes
    bodies = [_tiny_bam_record(f"read{r}".encode(), int(rng.randint(2)),
                               b"ACGT"[r % 4:r % 4 + 1] * 8, b"CCCAAA", 5 + r % 7)
              for r in range(400)]
    payload = _bam_payload(bodies, ["tx_a", "tx_b"])
    p = tmp / "t_bgzf.bam"
    p.write_bytes(b"".join(bgzf_member(payload[i:i + 777], 6)
                           for i in range(0, len(payload), 777)))
    with gzip.open(tmp / "t_gz.bam", "wb") as fh:
        fh.write(payload)
    return p


@pytest.mark.parametrize("name,filter_best,n_lines", [
    ("sam", False, 3), ("sam-f", True, 2), ("bam", False, 1), ("bam-python", False, 1),
    ("bgzf", False, 400),
])
def test_reference_tool_cases(name, filter_best, n_lines, tmp_path, monkeypatch):
    src = _tool_case(name, tmp_path, monkeypatch)
    _both(src, tmp_path, filter_best)
    text = _view_text(tmp_path / "port.rad", view, header=False)
    assert len(text.splitlines()) == n_lines
    if name == "sam":
        lines = text.splitlines()
        assert lines[0].endswith("DIR:true\ttx_a") and lines[1].endswith("DIR:false\ttx_b")
        assert "CB:GGGG" in lines[2] and lines[2].endswith("DIR:false\ttx_b")
    if name.startswith("bam"):
        assert "CB:AAAA" in text and "UMI:CCC" in text
    if name == "bgzf":
        # the sniffer routes each file to its reader, and both read the same
        assert isinstance(convert._open_bam_stream(src), convert._BgzfReader)
        assert not isinstance(convert._open_bam_stream(tmp_path / "t_gz.bam"),
                              convert._BgzfReader)
        convert.bam2rad(tmp_path / "t_gz.bam", tmp_path / "gz.rad")
        assert (tmp_path / "gz.rad").read_bytes() == (tmp_path / "port.rad").read_bytes()


def test_view_matches_reference(tmp_path):
    """The reference's view case: two reads, one with two alignments."""
    p = tmp_path / "map.rad"
    write_rna_rad(p, ["tx_a", "tx_b"], [[
        (pack_seq("AAAA"), pack_seq("CCC"), [(0, True), (1, False)]),
        (pack_seq("GGGG"), pack_seq("TTT"), [(1, True)]),
    ]], bc_len=4, umi_len=3)
    for header in (True, False):
        text = _view_text(p, view, header)
        assert text == _view_text(p, ref_view, header)
    assert text.splitlines() == [
        "ID:0\tHI:1\tNH:2\tCB:AAAA\tUMI:CCC\tDIR:true\ttx_a",
        "ID:0\tHI:2\tNH:2\tCB:AAAA\tUMI:CCC\tDIR:false\ttx_b",
        "ID:1\tHI:1\tNH:1\tCB:GGGG\tUMI:TTT\tDIR:true\ttx_b",
    ]


def test_view_of_goldens_dataset(tmp_path):
    """view -H of tests/make_goldens.py's dataset is tests/goldens/view.txt."""
    import make_goldens

    rad_dir = make_goldens.build_dataset(tmp_path)
    golden = (REPO / "tests" / "goldens" / "view.txt").read_text()
    assert _view_text(rad_dir / "map.rad", view) == golden


# --- corrupt and degenerate inputs ------------------------------------------

def _corrupt_case(name: str, tmp: Path) -> Path:
    p = tmp / "bad.bam"
    if name == "block-size":  # block_size 1: structurally invalid
        with gzip.open(p, "wb") as fh:
            fh.write(_bam_payload([], ["tx_a"]) + (struct.pack("<i", 1) + b"\x00") * 50)
        return p
    rec = _tiny_bam_record(b"r1", 0, b"AAAA", b"CCC", 7)
    if name == "missing-cr":
        with gzip.open(p, "wb") as fh:
            fh.write(_bam_payload([rec.replace(b"CRZAAAA\x00", b"XXZAAAA\x00")], ["tx_a"]))
        return p
    if name == "no-kept-read":  # every record unmapped
        unm = rec[:14] + struct.pack("<H", 4) + rec[16:]
        with gzip.open(p, "wb") as fh:
            fh.write(_bam_payload([unm, unm], ["tx_a"]))
        return p
    if name == "truncated-record":
        with gzip.open(p, "wb") as fh:
            fh.write(_bam_payload([rec], ["tx_a"])[:-3])
        return p
    payload = _bam_payload([rec] * 200, ["tx_a"])
    members = [bytearray(bgzf_member(payload[i:i + 1000], 6))
               for i in range(0, len(payload), 1000)]
    if name == "bgzf-body":  # a flipped byte inside the first member's deflate stream
        members[0][40] ^= 0xFF
    elif name == "bgzf-crc":  # a flipped bit in its CRC: inflates, fails the check
        members[0][-8] ^= 0x01
    elif name == "bgzf-truncated":
        members[-1] = members[-1][:-5]
    p.write_bytes(b"".join(map(bytes, members)))
    return p


@pytest.mark.parametrize("name", ["block-size", "missing-cr", "no-kept-read",
                                  "truncated-record", "bgzf-body", "bgzf-crc",
                                  "bgzf-truncated"])
def test_corrupt_input_raises(name, tmp_path):
    """Each package raises ValueError on the same input, and leaves the
    same (partial) output behind."""
    src = _corrupt_case(name, tmp_path)
    with pytest.raises(ValueError):
        convert.bam2rad(src, tmp_path / "port.rad")
    if name.startswith("bgzf") and not ref_native.available():
        return  # the reference reads BGZF through its native library only
    with pytest.raises(ValueError):
        ref_convert.bam2rad(src, tmp_path / "ref.rad")
    port, ref = tmp_path / "port.rad", tmp_path / "ref.rad"
    assert port.exists() == ref.exists()
    assert not port.exists() or port.read_bytes() == ref.read_bytes()


def test_bgzf_crc_mismatch_raises_in_the_reader(tmp_path):
    """The reference's CRC case: a member that inflates to the right size
    but fails its CRC32 raises in the reader itself."""
    payload = bytes(range(256)) * 40
    members = [bytearray(bgzf_member(payload[i:i + 1000], 6))
               for i in range(0, len(payload), 1000)]
    members[0][-8] ^= 0x01
    p = tmp_path / "crc.bam"
    p.write_bytes(b"".join(map(bytes, members)))
    rd = convert._BgzfReader(p)
    with pytest.raises(ValueError):
        rd.read(len(payload))
    rd.close()


# --- the generated trouble cases --------------------------------------------

@pytest.fixture(scope="module")
def bam_inputs(tmp_path_factory):
    """The same seeded records as BGZF (members of 777 bytes), one gzip
    member and SAM."""
    root = tmp_path_factory.mktemp("bam")
    out = {}
    for fmt in ("bgzf", "gzip", "sam"):
        stats = make_bam_dataset(root / fmt, 5, 4000, n_cells=20, n_genes=50, read_len=9,
                                 fmt=fmt, block_payload=777, threads=2, rates=TROUBLE)
        out[fmt] = Path(stats["path"])
    return out


@pytest.mark.parametrize("filter_best", [False, True], ids=["all", "filter-best"])
@pytest.mark.parametrize("fmt,scanner", [("bgzf", "native"), ("bgzf", "python"),
                                         ("gzip", "native"), ("gzip", "python"),
                                         ("sam", "text")])
def test_generated_input_matches_reference(bam_inputs, fmt, scanner, filter_best, tmp_path,
                                           monkeypatch):
    """The port writes the reference's bytes (the reference scanning with
    its native or its pure-Python scanner), and the BAM and SAM forms of
    the same records give the same RAD."""
    if scanner == "python":
        _without_ref_native(monkeypatch)
    got = _both(bam_inputs[fmt], tmp_path, filter_best)
    ref_convert.bam2rad(bam_inputs["sam"], tmp_path / "sam.rad", filter_best=filter_best)
    assert got == (tmp_path / "sam.rad").read_bytes()


@pytest.mark.parametrize("scan_buf,scanner", [(333, "native"), (333, "python"),
                                              (4096, "native")])
def test_batch_and_chunk_boundaries_change_no_byte(bam_inputs, scan_buf, scanner, tmp_path,
                                                   monkeypatch):
    """Scan batches of a few records (qname runs and skipped records
    carried across them and across BGZF members) and chunks of 97 reads
    in both packages (the reference with its native or its pure-Python
    scanner): the same bytes.  A chunk ends after the batch in which it
    reached 97 reads, so the batch size is part of the bytes."""
    for module in (convert, ref_convert):
        monkeypatch.setattr(module, "_SCAN_BUF", scan_buf)
        monkeypatch.setattr(module, "BUF_LIMIT", 97)
    if scanner == "python":
        _without_ref_native(monkeypatch)
    for filter_best in (False, True):
        _both(bam_inputs["bgzf"], tmp_path, filter_best)
        with open(tmp_path / "port.rad", "rb") as fh:
            assert read_prelude(fh)[0].hdr.num_chunks > 10


def test_convert_chain_matches_reference_host_path(tmp_path):
    """convert -> generate-permit-list -u (the rescue corrects some
    barcodes) -> collate -> quant -r cr-like (3-column t2g) on the CPU:
    the port's RAD is the reference's, and every artifact of the stages
    on it byte-identical to the reference's host path."""
    g = tmp_path / "g"
    make_bam_dataset(g, 9, 30_000, n_cells=30, n_genes=60, threads=2)
    assert port_main(["convert", "-b", str(g / "aln.bam"), "-o", str(g / "rad" / "map.rad"),
                  "-t", "2"]) == 0
    ref_convert.bam2rad(g / "aln.bam", tmp_path / "ref.rad")
    assert (g / "rad" / "map.rad").read_bytes() == (tmp_path / "ref.rad").read_bytes()
    _check_against_reference(g, tmp_path, usa=True, min_reads=10)


@pytest.mark.parametrize("flags", [[], ["-f"]], ids=["convert", "convert-f"])
def test_cli_convert_and_view(bam_inputs, flags, tmp_path):
    """``python -m alevin_fry_tpu_torch convert`` and ``view -H`` give the
    reference's RAD bytes and text."""
    rad = tmp_path / "port.rad"
    run = lambda *argv: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "alevin_fry_tpu_torch", *argv], cwd=str(REPO),
        capture_output=True, text=True, timeout=300, check=True).stdout
    run("convert", "-b", str(bam_inputs["bgzf"]), "-o", str(rad), "-t", "2", *flags)
    ref_convert.bam2rad(bam_inputs["bgzf"], tmp_path / "ref.rad", filter_best=bool(flags))
    assert rad.read_bytes() == (tmp_path / "ref.rad").read_bytes()
    assert run("view", "-r", str(rad), "-H") == _view_text(tmp_path / "ref.rad", ref_view)
    assert run("view", "--rad", str(rad)) == _view_text(tmp_path / "ref.rad", ref_view, False)


def test_native_open_waits_out_a_rewrite(tmp_path, monkeypatch):
    """A library file that is short when opened (being written anew by
    a concurrent rebuild) is opened once the write ends."""
    lib = _native._find_lib()
    if lib is None:
        pytest.skip("native library not built")
    blob = Path(lib).read_bytes()
    dst = tmp_path / "libradc.so"
    dst.write_bytes(blob[:100])
    monkeypatch.setattr(_native, "_OPEN_WAIT_S", 0.05)

    def finish():  # a new file takes the short one's name, as the linker's does
        time.sleep(0.3)
        (tmp_path / "new.so").write_bytes(blob)
        os.replace(tmp_path / "new.so", dst)

    writer = threading.Thread(target=finish)
    writer.start()
    try:
        handle = _native._open(str(dst))
    finally:
        writer.join()
    assert hasattr(handle, "radc_bam_scan") and hasattr(handle, "radc_bgzf_inflate")
    short = tmp_path / "short.so"  # a new path: dlopen keeps the loaded one
    short.write_bytes(blob[:100])
    monkeypatch.setattr(_native, "_OPEN_ATTEMPTS", 3)
    with pytest.raises(OSError):
        _native._open(str(short))
