"""collate, worked out from the generated reads and the permit list the
gpl reference kept: each read's barcode goes through the correction map,
its alignments off the expected orientation drop, and a read left with
none drops; the cells come by descending read count (ties by barcode),
each one chunk of its reads in file order, the corrected barcode in
place.  The expected ``map.collated.rad`` is encoded byte for byte by
the benchmark's own RAD writer; the unmapped-read counts are summed by
corrected barcode."""

from __future__ import annotations

import numpy as np

from ..gen import rad
from .rescue import correct
from .rna_gpl import read_compatible


def expect(data: dict, params: dict, state: dict) -> dict:
    keys, vals = state["map"]
    cells, cell_ct = state["cells"]
    offs, refs = data["aln_offsets"], data["refs"]
    keep_aln, has_aln = read_compatible(data["dirs"], offs, params["expected_ori"])
    distinct, inv = state["barcodes"]
    hit_d, corrected_d = correct(keys, vals, distinct)
    hit, corrected = hit_d[inv], corrected_d[inv]
    kept = np.flatnonzero(hit & has_aln)
    # cells by descending read count, ties by barcode: each distinct
    # barcode's cell rank, through the sorted cells
    by_rank = np.lexsort((cells, -cell_ct.astype(np.int64)))
    ranked = cells[by_rank]
    rank_of_cell = np.empty(len(cells), np.int64)
    rank_of_cell[by_rank] = np.arange(len(cells))
    rank_d = rank_of_cell[np.minimum(np.searchsorted(cells, corrected_d), len(cells) - 1)]
    rank = rank_d[inv[kept]]
    order = kept[np.argsort(rank, kind="stable")]
    per_cell = np.bincount(rank, minlength=len(cells))

    # the kept alignments of the reads in collated order
    nal = np.diff(offs)[order]
    first = np.cumsum(nal) - nal
    src = np.repeat(offs[:-1][order], nal) + (np.arange(int(nal.sum())) - np.repeat(first, nal))
    kept_aln = keep_aln[src]
    src = src[kept_aln]
    nal_kept = (np.add.reduceat(kept_aln.astype(np.int64), first) if len(order)
                else np.zeros(0, np.int64))
    out_offs = np.zeros(len(order) + 1, np.int64)
    np.cumsum(nal_kept, out=out_offs[1:])
    dirs = data["dirs"][src]
    alns = refs[src] | np.where(dirs, rad.ORI_BIT, np.uint32(0))
    nonempty = per_cell > 0
    chunk_offs = np.zeros(int(nonempty.sum()) + 1, np.int64)
    np.cumsum(per_cell[nonempty], out=chunk_offs[1:])
    schema = data["schema"]
    body = rad.encode_chunks(schema, [corrected[order], data["umi"][order]], out_offs, [alns],
                             chunk_offs)
    collated = np.concatenate([np.frombuffer(schema.prelude(len(chunk_offs) - 1), np.uint8),
                               body])
    state["collated"] = {
        "cell_bcs": ranked[nonempty], "cell_of_read": np.repeat(
            np.arange(len(chunk_offs) - 1), np.diff(chunk_offs)),
        "umi": data["umi"][order], "aln_offsets": out_offs, "refs": refs[src]}

    un_hit, un_corr = correct(keys, vals, data["unmapped_bc"])
    un_bc, inv = np.unique(un_corr[un_hit], return_inverse=True)
    un_ct = np.bincount(inv, weights=data["unmapped_ct"][un_hit].astype(np.float64),
                        minlength=len(un_bc)).astype(np.uint64)
    return {
        "map.collated.rad": ("bytes", collated),
        "unmapped_bc_count_collated.bin": ("u64_u32_map", (un_bc, un_ct)),
    }
