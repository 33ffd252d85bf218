"""Multi-barcode (10x Flex) collate in the fast mode, in memory, worked
out from the generated reads and the gpl reference's samples and cells
(alevin-fry's ``collate.rs:1150-2475``):

* a read's sample barcode goes through the sample map; a read whose
  sample is known and that has an alignment in the expected orientation
  has its cell barcode corrected against its sample's kept cells: the
  identity tier, then the 1-edit tier (exactly one kept cell one
  substitution away); its other alignments drop, and a read left
  uncorrected drops;
* the cells are the (sample, cell) composite keys: samples in list
  order, each sample's cells by descending read count, ties by barcode;
  each cell one chunk of its reads in file order, the corrected cell
  barcode in ``b1`` and the manifest ordinal (the sample's place among
  the samples that hold a cell) in ``b0``;
* the collation manifest lists those samples: the levels ``sample`` and
  ``cell``, then per sample its canonical barcode, its name, its first
  chunk, its chunks and its records, in bincode.

The expected ``map.collated.rad`` is encoded byte for byte by the
benchmark's own RAD writer.  The control (``no_rescue``) runs no 1-edit
tier.
"""

from __future__ import annotations

import struct

import numpy as np

from ..gen import rad
from .rescue import _lookup, unique_neighbour
from .rna_gpl import read_compatible


def _text(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<Q", len(b)) + b


def manifest(groups) -> bytes:
    """bincode of the levels and the sample groups ``(key, name,
    chunk_start, num_chunks, num_records)``."""
    out = [struct.pack("<Q", 2), _text("sample"), _text("cell"), struct.pack("<Q", len(groups))]
    for key, name, start, n_chunks, n_records in groups:
        out += [struct.pack("<Q", key), b"\x01", _text(name),
                struct.pack("<QQQ", start, n_chunks, n_records)]
    return b"".join(out)


def expect(data: dict, params: dict, state: dict) -> dict:
    length = data["bc_len"]
    sample, compat = state["sample"], state["compat"]
    cells_of = state["cells_of"]
    cbits = np.uint64(2 * length)
    cell_mask = (np.uint64(1) << cbits) - np.uint64(1)
    # the composite keys (sample, cell) of the kept cells, sorted
    comp = np.concatenate([np.zeros(0, np.uint64)] + [
        (np.uint64(si) << cbits) | cells for si, (cells, _ct) in enumerate(cells_of)])
    reads = np.flatnonzero((sample >= 0) & compat)
    # each distinct (sample, cell barcode) of those reads is corrected once
    key, of_read = np.unique((sample[reads].astype(np.uint64) << cbits) | data["bc"][reads],
                             return_inverse=True)
    # the identity tier, then the 1-edit tier within the key's sample
    ok, _ = _lookup(comp, key)
    queries = kept = 0
    if state.get("control") != "no_rescue":
        miss = np.flatnonzero(~ok)
        bounds = np.searchsorted(key[miss] >> cbits, np.arange(len(cells_of) + 1, dtype=np.uint64))
        for si, (cells, _ct) in enumerate(cells_of):
            q = miss[bounds[si]:bounds[si + 1]]
            if not len(q) or not len(cells):
                continue
            one, found = unique_neighbour(key[q] & cell_mask, cells, length)
            key[q[one]] = (np.uint64(si) << cbits) | found[one]
            ok[q[one]] = True
            queries, kept = queries + len(q), kept + len(cells)
    counts = state["counts"]
    counts["rescue_queries"] = counts.get("rescue_queries", 0) + queries
    counts["rescue_kept"] = counts.get("rescue_kept", 0) + kept

    # the cells in collated order: samples in list order, then descending
    # read count, ties by barcode; each kept read's cell rank, in file order
    n_cells = [len(c) for c, _ in cells_of]
    first = np.concatenate([[0], np.cumsum(n_cells)]).astype(np.int64)
    ranked, rank_of_comp = [], []
    for si, (cells, ct) in enumerate(cells_of):
        by_rank = np.lexsort((cells, -ct.astype(np.int64)))
        rank = np.empty(len(cells), np.int64)
        rank[by_rank] = first[si] + np.arange(len(cells))
        ranked.append(cells[by_rank])
        rank_of_comp.append(rank)
    rank_of_comp = np.concatenate([np.zeros(0, np.int64)] + rank_of_comp)
    kept_read = ok[of_read]
    use, fixed = reads[kept_read], key[of_read[kept_read]]
    rank_of_key = np.zeros(len(key), np.int64)
    rank_of_key[ok] = rank_of_comp[np.searchsorted(comp, key[ok])]
    rank = rank_of_key[of_read[kept_read]]
    by_rank = np.argsort(rank, kind="stable")
    order, fixed = use[by_rank], (fixed & cell_mask)[by_rank]
    per_cell = np.bincount(rank, minlength=int(first[-1]))
    present = [si for si, n in enumerate(n_cells) if n]
    ordinal = np.zeros(len(cells_of), np.int64)
    ordinal[present] = np.arange(len(present))

    # the kept alignments of the reads in collated order
    offs = data["aln_offsets"]
    per_aln, _ = read_compatible(data["dirs"], offs, params["expected_ori"])
    nal = np.diff(offs)[order]
    start = np.cumsum(nal) - nal
    src = np.repeat(offs[:-1][order], nal) + (np.arange(int(nal.sum())) - np.repeat(start, nal))
    keep = per_aln[src]
    src = src[keep]
    nal_kept = (np.add.reduceat(keep.astype(np.int64), start) if len(order)
                else np.zeros(0, np.int64))
    out_offs = np.zeros(len(order) + 1, np.int64)
    np.cumsum(nal_kept, out=out_offs[1:])
    alns = data["refs"][src] | np.where(data["dirs"][src], rad.ORI_BIT, np.uint32(0))
    nonempty = per_cell > 0
    chunk_offs = np.zeros(int(nonempty.sum()) + 1, np.int64)
    np.cumsum(per_cell[nonempty], out=chunk_offs[1:])
    schema = data["schema"]
    body = rad.encode_chunks(schema, [ordinal[sample[order]], fixed, data["umi"][order]],
                             out_offs, [alns], chunk_offs)
    collated = np.concatenate([np.frombuffer(schema.prelude(len(chunk_offs) - 1), np.uint8),
                               body])

    groups, chunk = [], 0
    for si in present:
        n_ch = int(nonempty[first[si]:first[si + 1]].sum())
        groups.append((state["canon"][si], state["sample_names"][si], chunk, n_ch,
                       int(per_cell[first[si]:first[si + 1]].sum())))
        chunk += n_ch
    cell_sample = np.repeat(np.arange(len(cells_of)), n_cells)[nonempty]
    state["collated"] = {
        "cell_bcs": np.concatenate(ranked)[nonempty] if ranked else np.zeros(0, np.uint64),
        "cell_sample": cell_sample,
        "cell_of_read": np.repeat(np.arange(len(chunk_offs) - 1), np.diff(chunk_offs)),
        "umi": data["umi"][order], "aln_offsets": out_offs, "refs": data["refs"][src]}
    return {
        "map.collated.rad": ("bytes", collated),
        "collation_manifest.bin": ("bytes", np.frombuffer(manifest(groups), np.uint8)),
    }
