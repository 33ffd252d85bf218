"""quant ``-r cr-like`` with a 3-column (USA) transcript-to-gene map,
worked out from the collated reads of the collate reference
(alevin-fry's ``resolve_num_molecules_crlike_from_vec`` and the USA
rules of ``extract_counts``):

* each read's transcripts map to USA gene ids (``2 g`` spliced,
  ``2 g + 1`` unspliced) and repeat once per read;
* per (cell, UMI) the genes seen by the most reads are the tie set;
* a tie set of one gene counts in its spliced or unspliced column; of
  two, in the ambiguous column of a gene's own pair, else in the spliced
  gene's column when exactly one is spliced, else not at all; of three
  to ten, where exactly one gene is spliced, in its ambiguous column if
  its unspliced partner is there too, else in its spliced column;
  otherwise not at all;
* the matrix holds one count per (cell, UMI) in its column.
"""

from __future__ import annotations

import numpy as np

from ..gen import rad
from .text import rows


def _bits(n: int) -> int:
    return max(int(n) - 1, 1).bit_length()


def usa_columns(gene: np.ndarray, grp: np.ndarray, n_groups: int, n_genes: int):
    """Each (cell, UMI) group's column, from its tie set's genes ``gene``
    (ascending within a group, ``grp`` its group): (column, counted)."""
    size = np.bincount(grp, minlength=n_groups)
    first = np.zeros(n_groups + 1, np.int64)
    np.cumsum(size, out=first[1:])
    col = np.zeros(n_groups, np.int64)
    ok = np.zeros(n_groups, bool)
    g0 = gene[np.minimum(first[:-1], len(gene) - 1)].astype(np.int64)
    one = size == 1
    col[one] = np.where(g0[one] % 2 == 0, g0[one] // 2, n_genes + g0[one] // 2)
    ok[one] = True
    two = size == 2
    g1 = g0[two]
    g2 = gene[first[:-1][two] + 1].astype(np.int64)
    same = g1 // 2 == g2 // 2
    s1, s2 = g1 % 2 == 0, g2 % 2 == 0
    col[two] = np.where(same, 2 * n_genes + g1 // 2, np.where(s1, g1 // 2, g2 // 2))
    ok[two] = same | (s1 != s2)
    many = (size >= 3) & (size <= 10)
    spliced = (gene % 2 == 0) & many[grp]
    n_spl = np.bincount(grp[spliced], minlength=n_groups)
    sg = np.zeros(n_groups, np.int64)
    sg[grp[spliced]] = gene[spliced]
    partner = np.zeros(n_groups, bool)
    is_p = many[grp] & (gene % 2 == 1) & (gene - 1 == sg[grp])
    partner[grp[is_p]] = True
    m = many & (n_spl == 1)
    col[m] = np.where(partner[m], 2 * n_genes + sg[m] // 2, sg[m] // 2)
    ok[m] = True
    return col, ok


def expect(data: dict, params: dict, state: dict) -> dict:
    col = state["collated"]
    n_genes, tpg = data["n_genes"], data["txps_per_gene"]
    cell_bcs = col["cell_bcs"]
    n_cells, n_cols = len(cell_bcs), 3 * n_genes
    offs, refs = col["aln_offsets"], col["refs"].astype(np.int64)
    n_reads = len(offs) - 1
    usa = (refs // tpg) * 2 + (refs % tpg) % 2
    read = np.repeat(np.arange(n_reads, dtype=np.int64), np.diff(offs))
    gbits = _bits(2 * n_genes)
    # the keys come grouped by read: a stable sort only orders each read's
    # few genes
    pair = np.sort((read << gbits) | usa, kind="stable")
    pair = pair[np.concatenate(([True], pair[1:] != pair[:-1]))] if len(pair) else pair
    p_read, p_gene = pair >> gbits, pair & ((1 << gbits) - 1)
    state["counts"]["wta_pairs"] = int(len(pair))

    ubits = 2 * data["umi_len"]
    cbits = _bits(n_cells)
    if cbits + ubits + gbits > 63:
        raise ValueError("cells, UMIs and genes do not pack into 63 bits")
    key = ((col["cell_of_read"][p_read].astype(np.int64) << (ubits + gbits))
           | (col["umi"][p_read].astype(np.int64) << gbits) | p_gene)
    trip, t_ct = np.unique(key, return_counts=True)
    g_key = trip >> gbits
    new = np.ones(len(trip), bool)
    new[1:] = g_key[1:] != g_key[:-1]
    grp = np.cumsum(new) - 1
    starts = np.flatnonzero(new)
    win = t_ct == np.maximum.reduceat(t_ct, starts)[grp]
    w_grp = grp[win]
    n_groups = len(starts)
    state["counts"]["wta_groups"] = int(n_groups)
    column, ok = usa_columns(trip[win] & ((1 << gbits) - 1), w_grp, n_groups, n_genes)
    g_cell = g_key[starts] >> ubits
    cell_col, counts = np.unique(g_cell[ok] * n_cols + column[ok], return_counts=True)
    r, c = cell_col // n_cols, cell_col % n_cols

    mtx = np.concatenate([
        np.frombuffer(b"%%MatrixMarket matrix coordinate real general\n"
                      b"% written by alevin-fry-tpu\n"
                      + f"{n_cells} {n_cols} {len(r)}\n".encode(), np.uint8),
        rows(len(r), [("int", r + 1), ("lit", b" "), ("int", c + 1), ("lit", b" "),
                      ("int", counts), ("lit", b"\n")])])
    bc_rows = rows(n_cells, [("fixed", rad.unpack_ascii(cell_bcs, data["bc_len"])),
                             ("lit", b"\n")])
    names = [f"g_{g}" for g in range(n_genes)]
    cols = "".join(f"{g}{s}\n" for s in ("", "-U", "-A") for g in names).encode()
    expressed = np.zeros(n_cells, bool)
    expressed[r] = True
    return {
        "alevin/quants_mat.mtx": ("bytes", mtx),
        "alevin/quants_mat_rows.txt": ("bytes", bc_rows),
        "alevin/quants_mat_cols.txt": ("bytes", np.frombuffer(cols, np.uint8)),
        "quant.json": ("json", {
            "num_quantified_cells": n_cells, "num_genes": n_cols, "usa_mode": True,
            "empty_resolved_cell_numbers": np.flatnonzero(~expressed).tolist()}),
    }
