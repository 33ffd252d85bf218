"""quant ``-r cr-like`` with a 2-column probe-to-gene map on a
hierarchically collated (Flex) directory, worked out from the collate
reference's cells (alevin-fry's ``resolve_num_molecules_crlike_from_vec``
and ``quant.rs:1180-1222,1314-1333``):

* each read's probes map to their genes, each gene once a read;
* per (cell, UMI) the genes seen by the most reads are the tie set; a
  tie set of one gene counts one in that gene's column, a larger one
  counts nothing;
* each row is named ``<sample>_<cell barcode>``, the sample named by
  the manifest ordinal of the cell's first record.
"""

from __future__ import annotations

import numpy as np

from ..gen import rad
from .rna_quant import _bits
from .text import rows, table


def expect(data: dict, params: dict, state: dict) -> dict:
    col = state["collated"]
    n_genes = data["n_genes"]
    cell_bcs = col["cell_bcs"]
    n_cells = len(cell_bcs)
    offs = col["aln_offsets"]
    gene = col["refs"].astype(np.int64) // data["probes_per_gene"]
    read = np.repeat(np.arange(len(offs) - 1, dtype=np.int64), np.diff(offs))
    gbits = _bits(n_genes)
    # a sort and a compare of neighbours: each read's genes once
    pair = np.sort((read << gbits) | gene)
    pair = pair[np.concatenate(([True], pair[1:] != pair[:-1]))] if len(pair) else pair
    p_read, p_gene = pair >> gbits, pair & ((1 << gbits) - 1)
    state["counts"]["wta_pairs"] = int(len(pair))

    ubits = 2 * data["umi_len"]
    if _bits(n_cells) + ubits + gbits > 63:
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
    state["counts"]["wta_groups"] = int(len(starts))
    ties = np.bincount(grp[win], minlength=len(starts))
    one = win & (ties[grp] == 1)
    cell_col, counts = np.unique((trip[one] >> (ubits + gbits)) * n_genes
                                 + (trip[one] & ((1 << gbits) - 1)), return_counts=True)
    r, c = cell_col // n_genes, cell_col % n_genes

    mtx = np.concatenate([
        np.frombuffer(b"%%MatrixMarket matrix coordinate real general\n"
                      b"% written by alevin-fry-tpu\n"
                      + f"{n_cells} {n_genes} {len(r)}\n".encode(), np.uint8),
        rows(len(r), [("int", r + 1), ("lit", b" "), ("int", c + 1), ("lit", b" "),
                      ("int", counts), ("lit", b"\n")])])
    bc_rows = rows(n_cells, [("pick", table(state["sample_names"]), col["cell_sample"]),
                             ("lit", b"_"), ("fixed", rad.unpack_ascii(cell_bcs, data["bc_len"])),
                             ("lit", b"\n")])
    cols = "".join(f"g_{g}\n" for g in range(n_genes)).encode()
    expressed = np.zeros(n_cells, bool)
    expressed[r] = True
    return {
        "alevin/quants_mat.mtx": ("bytes", mtx),
        "alevin/quants_mat_rows.txt": ("bytes", bc_rows),
        "alevin/quants_mat_cols.txt": ("bytes", np.frombuffer(cols, np.uint8)),
        "quant.json": ("json", {
            "num_quantified_cells": n_cells, "num_genes": n_genes, "usa_mode": False,
            "empty_resolved_cell_numbers": np.flatnonzero(~expressed).tolist()}),
    }
