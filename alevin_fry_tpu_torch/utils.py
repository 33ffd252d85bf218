"""Shared pipeline utilities (reference: alevin_fry_tpu/utils.py and
src/utils.rs): strands, the stage-JSON version gate, the tg-map
parsers, barcode-list reading and JSON output."""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from . import spans
from .ops.barcodes import pack_rows

# bio_types::strand::Strand symbols: Forward "+", Reverse "-", Unknown "."
STRAND_FW = "+"
STRAND_RC = "-"
STRAND_BOTH = "."

# the bytes that ``bytes.strip()`` strips: space, \t, \n, \v, \f, \r
_ASCII_SPACE = np.zeros(256, bool)
_ASCII_SPACE[list(b" \t\n\x0b\x0c\r")] = True


def strand_from_ori_arg(ori: str) -> str:
    u = ori.upper()
    if u == "FW":
        return STRAND_FW
    if u == "RC":
        return STRAND_RC
    if u in ("BOTH", "EITHER"):
        return STRAND_BOTH
    raise ValueError(f"{ori} is not a valid option for --expected-ori")


def read_strand_mask(dirs: np.ndarray, aln_offsets: np.ndarray, strand: str) -> np.ndarray:
    """Per-read mask: does the read have >= 1 alignment on ``strand``
    (src/cellfilter.rs:1283-1418)."""
    n = len(aln_offsets) - 1
    if strand == STRAND_BOTH:
        return np.ones(n, bool)
    if n == 0:
        return np.zeros(0, bool)
    per_aln = dirs if strand == STRAND_FW else ~dirs
    out = np.maximum.reduceat(per_aln.astype(np.int8), aln_offsets[:-1])
    out[np.diff(aln_offsets) == 0] = 0
    return out.astype(bool)


def aln_strand_mask(dirs: np.ndarray, strand: str) -> np.ndarray:
    """Per-alignment mask for collation-time orientation filtering."""
    if strand == STRAND_BOTH:
        return np.ones(len(dirs), bool)
    return dirs if strand == STRAND_FW else ~dirs


def record_layout(schema) -> Tuple[int, int, int]:
    """Byte layout of one RAD record for the native codec: (offset and
    width of the cell barcode in the read header, offset of the
    reference id in an alignment)."""
    bc_name = schema.barcode_fields[-1]
    bc_off = 0
    for name, w in schema.read_fields:
        if name == bc_name:
            bc_width = w
            break
        bc_off += w
    ref_off = 0
    for name, w in schema.aln_fields:
        if name == schema.ref_field:
            break
        ref_off += w
    return bc_off, bc_width, ref_off


# --- version compat (src/utils.rs:1096-1142) ---------------------------------

@dataclass(frozen=True)
class VersionInfo:
    major: int
    minor: int
    patch: int

    @classmethod
    def parse(cls, s: str) -> "VersionInfo":
        parts = s.split(".")
        if len(parts) != 3:
            raise ValueError(
                f"The version string should be of the format x.y.z; it was `{s}`"
            )
        return cls(int(parts[0]), int(parts[1]), int(parts[2]))

    def is_compatible_with(self, other: "VersionInfo") -> None:
        if (self.major, self.minor) != (other.major, other.minor):
            raise ValueError(
                f"running alevin-fry-tpu v{self.major}.{self.minor}.{self.patch} "
                f"on v{other.major}.{other.minor}.{other.patch} results; please "
                "regenerate the results with a compatible version"
            )


def check_version_compat(calling_version: str, json_path: Path) -> dict:
    """Read a stage JSON and enforce the version_str gate
    (src/collate.rs:74-95)."""
    with open(json_path) as fh:
        mdata = json.load(fh)
    vs = mdata.get("version_str")
    if vs is None:
        raise ValueError(
            f"{json_path} does not contain a version_str field; please re-run "
            "the earlier stage"
        )
    VersionInfo.parse(calling_version).is_compatible_with(VersionInfo.parse(vs))
    return mdata


# --- tg-map parsing (src/utils.rs:470-645) -----------------------------------

def parse_tg_map(
    tg_map: Path, ref_names: List[str]
) -> Tuple[np.ndarray, List[str], Dict[str, int], bool]:
    """Parse a 2- or 3-column transcript-to-gene TSV.

    Returns (tid_to_gid[uint32], gene_names, gene_name_to_id, usa_mode).
    3-column maps use the USA id scheme: each gene owns two adjacent
    ids, even for spliced and odd for unspliced.  Every transcript of
    the RAD header must be covered."""
    rname_to_id = {n: i for i, n in enumerate(ref_names)}
    with open(tg_map) as fh:
        first = fh.readline()
        ncols = len(first.rstrip("\n").split("\t"))
        fh.seek(0)
        if ncols == 2:
            return _parse_tg(fh, rname_to_id, len(ref_names), usa=False)
        if ncols == 3:
            return _parse_tg(fh, rname_to_id, len(ref_names), usa=True)
    raise ValueError("Transcript-gene mapping must have either 2 or 3 columns.")


def _parse_tg(fh, rname_to_id, ref_count, usa: bool):
    """Gene ids follow first encounter over the file; a 3-column map
    gives each gene two ids (spliced even, unspliced odd)."""
    tid_to_gid = np.full(ref_count, np.iinfo(np.uint32).max, np.uint32)
    gene_names: List[str] = []
    gene_name_to_id: Dict[str, int] = {}
    found = 0
    step = 2 if usa else 1
    for lineno, line in enumerate(fh, 1):
        line = line.rstrip("\n")
        if not line.strip():
            continue
        parts = line.split("\t")
        if len(parts) < (3 if usa else 2):
            raise ValueError(
                f"tg-map line {lineno} does not have {3 if usa else 2} "
                f"tab-separated columns: {line!r}"
            )
        tname, gname = parts[0], parts[1]
        gid = gene_name_to_id.get(gname)
        if gid is None:
            gid = step * len(gene_names)
            gene_name_to_id[gname] = gid
            gene_names.append(gname)
        tid = rname_to_id.get(tname)
        if tid is None:
            continue
        found += 1
        if not usa:
            tid_to_gid[tid] = gid
            continue
        status = parts[2].upper()
        if status not in ("S", "U"):
            raise ValueError("Third column in 3 column txp-to-gene file must be S or U")
        tid_to_gid[tid] = gid + (status == "U")
    if found != ref_count:
        raise ValueError(
            "The tg-map must contain a gene mapping for all transcripts in the header"
        )
    return tid_to_gid, gene_names, gene_name_to_id, usa


# --- misc --------------------------------------------------------------------

def read_barcode_file(path: Path, bclen: int | None = None) -> Tuple[np.ndarray, int]:
    """One barcode per line (optionally gzipped) -> (packed uint64
    array in file order, barcode length).  Lines end at ``\n``; each is
    stripped of ASCII whitespace as ``bytes.strip`` strips it, and blank
    ones are skipped.  Every barcode must have ``bclen`` bases when it is
    given, else the first one's.

    The whole file is parsed in bulk.  Adjacent whitespace bytes form
    runs; a line starts after the run that holds the newline before it
    and ends where the run that holds its own newline starts.  The
    parsed entries are counted as ``listed`` on the open span."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] == b"\x1f\x8b":  # gzip's magic
        raw = gzip.decompress(raw)
    # a newline before the first line and one after the last
    data = np.empty(len(raw) + 2, np.uint8)
    data[1:-1] = np.frombuffer(raw, np.uint8)
    data[0] = data[-1] = ord("\n")
    del raw
    # every whitespace byte is <= 32
    ws = np.flatnonzero(data <= 32)
    ws = ws[_ASCII_SPACE[data[ws]]]
    # the non-whitespace bytes before each whitespace byte: one value a run
    before = ws - np.arange(len(ws))
    new_run = np.empty(len(ws), bool)
    new_run[0] = True
    np.not_equal(before[1:], before[:-1], out=new_run[1:])
    run_first = np.flatnonzero(new_run)
    run_end = np.append(run_first[1:], len(ws))
    run_of = np.cumsum(new_run) - 1
    nl = np.flatnonzero(data[ws] == ord("\n"))
    run = run_of[nl]
    # line i lies between newlines i and i + 1, stripped
    start = before[nl] + run_end[run]
    lens = before[nl[1:]] + run_first[run[1:]] - start[:-1]
    kept = np.flatnonzero(lens > 0)
    spans.add("listed", len(kept))
    if not len(kept):
        return np.zeros(0, np.uint64), bclen or 0
    start, lens = start[kept], lens[kept]
    length = bclen or int(lens[0])
    bad = np.flatnonzero(lens != length)
    if len(bad):
        raise ValueError(f"found barcodes of different lengths {length} and {lens[bad[0]]}")
    return pack_rows(np.lib.stride_tricks.sliding_window_view(data, length)[start]), length


def sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` of a 1-D array, by a sort and a compare of
    neighbours: NumPy 2.3 finds a plain ``np.unique`` through a hash
    table, which takes seconds on a list's millions of barcodes."""
    a = np.sort(a)
    first = np.ones(len(a), bool)
    np.not_equal(a[1:], a[:-1], out=first[1:])
    return a[first]


def is_velo_mode(input_dir: Path) -> bool:
    with open(Path(input_dir) / "generate_permit_list.json") as fh:
        return bool(json.load(fh).get("velo_mode") or False)


def write_json(path: Path, obj: dict) -> None:
    """Write a stage's JSON inside a ``write`` span that counts its
    bytes."""
    with spans.span("write", "codec"):
        with open(path, "w") as fh:
            json.dump(obj, fh, indent=2)
        spans.wrote(path)
