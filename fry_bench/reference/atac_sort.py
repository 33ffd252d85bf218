"""atac sort, worked out from the generated fragments and the gpl
reference's correction map (alevin-fry's ``atac/sort.rs``): the
uniquely mapped records with a correctable barcode become rows (chromosome,
start, length, corrected barcode); equal rows collapse to one with their
count; the rows sort by chromosome, start, length and barcode; each
shorter than 2,000 bases is a BED line ``chr start end barcode count``,
the barcode reverse-complemented in ``rc`` mode.  The expected
``map.bed`` is formatted byte for byte."""

from __future__ import annotations

import numpy as np

from ..gen import rad
from .rescue import correct
from .text import rows, table

MAX_FRAG_LEN = 2000


def expect(data: dict, params: dict, state: dict) -> dict:
    keys, vals = state["map"]
    offs = data["aln_offsets"]
    distinct, inv = state["barcodes"]
    hit_d, corrected_d = correct(keys, vals, distinct)
    hit, corrected = hit_d[inv], corrected_d[inv]
    keep = hit & (np.diff(offs) == 1)
    first = offs[:-1][keep]
    chrom = data["chr"][first].astype(np.uint64)
    start = data["start"][first].astype(np.uint64)
    flen = data["frag_len"][first].astype(np.uint64)
    bc = corrected[keep]
    state["counts"]["sort_rows"] = int(keep.sum())
    # chromosome, start and length fill one 64-bit word; the barcode is next
    hi = (chrom << np.uint64(48)) | (start << np.uint64(16)) | flen
    order = np.lexsort((bc, hi))
    hi, bc = hi[order], bc[order]
    new = np.ones(len(hi), bool)
    new[1:] = (hi[1:] != hi[:-1]) | (bc[1:] != bc[:-1])
    starts = np.flatnonzero(new)
    state["counts"]["sort_runs"] = int(len(starts))
    count = np.diff(np.append(starts, len(hi)))
    hi, bc = hi[starts], bc[starts]
    chrom = (hi >> np.uint64(48)).astype(np.int64)
    start = ((hi >> np.uint64(16)) & np.uint64(0xFFFFFFFF)).astype(np.int64)
    flen = (hi & np.uint64(0xFFFF)).astype(np.int64)
    short = flen < MAX_FRAG_LEN
    chrom, start, flen, bc, count = (chrom[short], start[short], flen[short], bc[short],
                                     count[short])
    if params["rc"]:
        bc = rad.revcomp(bc, data["bc_len"])
    bed = rows(len(chrom), [
        ("pick", table(data["ref_names"]), chrom), ("lit", b"\t"), ("int", start),
        ("lit", b"\t"), ("int", start + flen), ("lit", b"\t"),
        ("fixed", rad.unpack_ascii(bc, data["bc_len"])), ("lit", b"\t"), ("int", count),
        ("lit", b"\n")])
    return {"map.bed": ("bytes", bed)}
