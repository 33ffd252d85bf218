"""Multi-barcode (10x Flex) generate-permit-list with an unfiltered list
(``-u``) and ``--sample-correction-mode 1-edit``, worked out from the
generated reads (alevin-fry's ``cellfilter.rs:556-1279``):

* the sample list maps each observed rotation to its canonical barcode;
  under ``1-edit`` every substitution and indel neighbour of a rotation
  (``get_all_snps``, ``get_all_indels``, ``utils.rs:917-981``) maps to
  the canonical barcode of the first rotation in file order that has it
  as a neighbour, and a rotation itself keeps its own
  (``docs/parity.md:48-53``);
* the reads with an alignment in the expected orientation are counted
  by (sample, cell barcode) where the sample barcode maps; each sample's
  cells are kept and rescued on their own (``rescue.py``), against the
  one cell-barcode list.
"""

from __future__ import annotations

import numpy as np

from .rescue import _lookup, keep_and_rescue
from .rna_gpl import read_compatible


def one_edit_neighbours(code: int, length: int) -> list:
    """A barcode's 1-edit neighbours as alevin-fry forms them, positions
    counted from the low bits: every substitution, then at each
    interior position an insertion (the low part shifted down one base)
    and a deletion (the low part shifted up one base into the high
    part, the new base at the end), the barcode itself left out."""
    out = []
    for pos in range(length):
        cleared = code & ~(3 << 2 * pos)
        out += [cleared | (b << 2 * pos) for b in range(4)]
    for pos in range(1, length):
        low = code & ((1 << 2 * pos) - 1)
        high = code ^ low
        for b in range(4):
            out.append(high | (b << 2 * (pos - 1)) | (low >> 2))
            out.append(high | b | (low << 2))
    return [c for c in out if c != code]


def sample_map(sample_list, length: int, one_edit: bool):
    """``{observed: canonical}`` of the sample list's rows in file order
    (a later row of the same observed barcode replaces its canonical)."""
    out = {}
    for obs, canon, _name in sample_list:
        out[obs] = canon
    if one_edit:
        rotations = list(out.items())
        for obs, canon in rotations:
            for n in one_edit_neighbours(obs, length):
                out.setdefault(n, canon)
    return out


def expect(data: dict, params: dict, state: dict) -> dict:
    smap = sample_map(data["sample_list"], data["sample_bc_len"],
                      params["sample_correction_mode"] == "1-edit")
    canon = list(dict.fromkeys(c for _o, c, _n in data["sample_list"]))
    names = {c: n for _o, c, n in data["sample_list"]}
    keys = np.fromiter(sorted(smap), np.uint64, len(smap))
    # each key's sample: its canonical barcode's place in file order
    place = {c: i for i, c in enumerate(canon)}
    sample_of_key = np.asarray([place[smap[int(k)]] for k in keys], np.int64)
    _, compat = read_compatible(data["dirs"], data["aln_offsets"], params["expected_ori"])
    known, idx = _lookup(keys, data["sbc"])
    sample = np.where(known, sample_of_key[idx], -1)
    observed = np.fromiter(sorted(o for o, _c, _n in data["sample_list"]), np.uint64)
    exact, _ = _lookup(observed, data["sbc"])
    state.update(sample_keys=keys, sample_of_key=sample_of_key, sample=sample,
                 canon=canon, sample_names=[names[c] for c in canon], compat=compat)
    state["counts"].update(
        sample_exact=int((compat & exact).sum()),
        sample_corrected=int((compat & known & ~exact).sum()),
        sample_dropped=int((compat & ~known).sum()))

    # the composite histogram: (sample, cell barcode) of the reads counted
    cbits = np.uint64(2 * data["bc_len"])
    use = compat & known
    comp, counts = np.unique((sample[use].astype(np.uint64) << cbits) | data["bc"][use],
                             return_counts=True)
    comp_sample = (comp >> cbits).astype(np.int64)
    comp_bc = comp & ((np.uint64(1) << cbits) - np.uint64(1))
    listed, _ = _lookup(np.sort(data["permit"]), comp_bc)

    arts, entries, cells_of, queries, kept = {}, [], [], 0, 0
    for si, c in enumerate(canon):
        name = names[c]
        sel = comp_sample == si
        entry = {"name": name, "barcode": f"0x{c:x}", "num_reads": 0, "num_cells": 0}
        entries.append(entry)
        if not sel.any():
            cells_of.append((np.zeros(0, np.uint64), np.zeros(0, np.uint64)))
            continue
        bcs = comp_bc[sel]
        cells, cell_ct, (mk, mv), sizes = keep_and_rescue(
            bcs[listed[sel]], bcs, counts[sel], data["bc_len"], params["min_reads"],
            state.get("control", ""))
        cells_of.append((cells, cell_ct))
        if sizes["rescue_queries"] and sizes["rescue_kept"]:
            queries += sizes["rescue_queries"]
            kept += sizes["rescue_kept"]
        entry.update(num_reads=int(cell_ct.sum()), num_cells=int(len(cells)))
        arts[f"sample_{name}/permit_freq.bin"] = ("permit_freq", (data["bc_len"], cells, cell_ct))
        arts[f"sample_{name}/permit_map.bin"] = ("u64_map", (mk, mv))
    state["cells_of"] = cells_of
    state["counts"].update(rescue_queries=queries, rescue_kept=kept,
                           composite_cells=sum(len(c) for c, _ in cells_of))
    return {
        "sample_permit_map.bin": ("u64_map", (keys, np.asarray(
            [smap[int(k)] for k in keys], np.uint64))),
        **arts,
        "sample_info.json": ("json", {
            "num_samples": len(canon), "num_barcodes": 2,
            "total_cells": sum(e["num_cells"] for e in entries),
            "total_reads": len(data["sbc"]),
            "matched_reads": int(use.sum()), "unmatched_reads": int((compat & ~known).sum()),
            "sample_correction_mode": ("OneEdit" if params["sample_correction_mode"] == "1-edit"
                                       else "Exact"),
            "sample_bc_ori": "Forward", "samples": entries}),
    }
