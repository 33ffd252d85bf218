"""atac generate-permit-list (``-u``), worked out from the generated
fragments: every record's barcode is counted, the whitelist (read
reverse-complemented in the default ``rc`` mode) keeps and rescues
(``rescue.py``), and the uniquely mapped records' start positions are
counted in 100 kb bins per chromosome (alevin-fry's
``atac/cellfilter.rs``)."""

from __future__ import annotations

import numpy as np

from ..gen import rad
from .rescue import keep_and_rescue

BIN = 100_000


def bin_offsets(ref_lens: np.ndarray) -> np.ndarray:
    """Cumulative bins before each chromosome (lengths over the bin
    size, rounded up in single precision, as alevin-fry computes them)."""
    n = np.ceil(np.asarray(ref_lens).astype(np.float32) / np.float32(BIN)).astype(np.int64)
    return np.concatenate([[0], np.cumsum(n)]).astype(np.uint64)


def expect(data: dict, params: dict, state: dict) -> dict:
    offs = data["aln_offsets"]
    nal = np.diff(offs)
    # every record's barcode as an index into the distinct ones, which
    # the sort corrects once each
    bcs, inv, counts = np.unique(data["bc"], return_inverse=True, return_counts=True)
    state["barcodes"] = (bcs, inv)
    # the file holds the whitelist reverse-complemented; rc mode undoes it
    listed = data["permit"] if params["rc"] else rad.revcomp(data["permit"], data["bc_len"])
    cells, cell_ct, (keys, vals), sizes = keep_and_rescue(
        listed, bcs, counts, data["bc_len"], params["min_reads"], state.get("control", ""))
    state.update(cells=(cells, cell_ct), map=(keys, vals))
    state["counts"].update(sizes)
    blens = bin_offsets(data["ref_lens"])
    one = offs[:-1][nal == 1]
    b = blens[data["chr"][one]].astype(np.int64) + data["start"][one].astype(np.int64) // BIN
    bins = np.bincount(b, minlength=int(blens[-1])).astype(np.uint64)
    return {
        "permit_freq.bin": ("permit_freq", (data["bc_len"], cells, cell_ct)),
        "permit_map.bin": ("u64_map", (keys, vals)),
        "bin_recs.bin": ("u64_vec", bins),
        "bin_lens.bin": ("u64_vec", blens),
        "generate_permit_list.json": ("json", {
            "max-ambig-record": int(nal.max()), "num-chunks": data["num_chunks"],
            "max-rec-in-bin": int(bins.max()), "permit-list-type": "unfiltered"}),
    }
