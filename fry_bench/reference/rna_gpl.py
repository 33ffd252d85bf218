"""generate-permit-list with an unfiltered permit list (``-u``), worked
out from the generated reads: the barcodes of the reads with an
alignment in the expected orientation are counted, then kept and
rescued (``rescue.py``)."""

from __future__ import annotations

import numpy as np

from .rescue import keep_and_rescue


def read_compatible(dirs: np.ndarray, aln_offsets: np.ndarray, expected_ori: str):
    """Per alignment: in the expected orientation; per read: has one."""
    per_aln = {"fw": dirs, "rc": ~dirs}.get(expected_ori, np.ones(len(dirs), bool))
    n_ok = np.add.reduceat(per_aln.astype(np.int64), aln_offsets[:-1])
    n_ok[np.diff(aln_offsets) == 0] = 0
    return per_aln, n_ok > 0


def expect(data: dict, params: dict, state: dict) -> dict:
    _, compat = read_compatible(data["dirs"], data["aln_offsets"], params["expected_ori"])
    # every read's barcode as an index into the distinct ones, which the
    # later stages correct once each
    distinct, inv = np.unique(data["bc"], return_inverse=True)
    state["barcodes"] = (distinct, inv)
    counts = np.bincount(inv[compat], minlength=len(distinct))
    bcs, counts = distinct[counts > 0], counts[counts > 0]
    cells, cell_ct, (keys, vals), sizes = keep_and_rescue(
        data["permit"], bcs, counts, data["bc_len"], params["min_reads"],
        state.get("control", ""))
    state.update(cells=(cells, cell_ct), map=(keys, vals))
    state["counts"].update(sizes)
    return {
        "permit_freq.bin": ("permit_freq", (data["bc_len"], cells, cell_ct)),
        "permit_map.bin": ("u64_map", (keys, vals)),
        "generate_permit_list.json": ("json", {
            "max-ambig-record": int(np.diff(data["aln_offsets"])[compat].max()),
            "permit-list-type": "unfiltered"}),
    }
