"""The unfiltered permit list's keep-and-rescue rule, shared by the RNA
and ATAC generate-permit-list references (alevin-fry's
``cellfilter.rs``, ``process_unfiltered``): a listed barcode with at
least ``min_reads`` reads is a cell; every other observed barcode (not
listed, or listed with fewer reads) whose one-substitution neighbours
hold exactly one cell is corrected to it, and its reads count for that
cell.  The control (``no_rescue``) corrects nothing."""

from __future__ import annotations

import numpy as np

# queries a block of the neighbour search: 3 x length variants each
BLOCK = 200_000


def _lookup(keys_sorted: np.ndarray, q: np.ndarray):
    idx = np.minimum(np.searchsorted(keys_sorted, q), max(len(keys_sorted) - 1, 0))
    hit = keys_sorted[idx] == q if len(keys_sorted) else np.zeros(q.shape, bool)
    return hit, idx


def unique_neighbour(queries: np.ndarray, cells: np.ndarray, length: int):
    """For each query: whether exactly one of the sorted ``cells`` lies one
    substitution away, and that cell."""
    ok = np.zeros(len(queries), bool)
    rep = np.zeros(len(queries), np.uint64)
    shifts = np.uint64(2) * np.arange(length, dtype=np.uint64)
    for s in range(0, len(queries), BLOCK):
        q = queries[s:s + BLOCK].astype(np.uint64)
        old = (q[:, None] >> shifts) & np.uint64(3)
        # the three other bases at every position
        variants = np.stack([
            q[:, None] ^ (((old + np.uint64(k)) & np.uint64(3) ^ old) << shifts)
            for k in (1, 2, 3)], axis=2).reshape(len(q), -1)
        hit, idx = _lookup(cells, variants)
        n_hit = hit.sum(axis=1)
        first = np.argmax(hit, axis=1)
        ok[s:s + BLOCK] = n_hit == 1
        rep[s:s + BLOCK] = cells[idx[np.arange(len(q)), first]] if len(cells) else 0
    return ok, rep


def keep_and_rescue(listed: np.ndarray, bcs: np.ndarray, counts: np.ndarray, length: int,
                    min_reads: int, control: str = ""):
    """``listed``: the permit list; ``bcs``, ``counts``: the read histogram.
    Returns the cells and their corrected read counts (sorted by
    barcode), the correction map (keys sorted) and the rescue's sizes."""
    listed = np.unique(listed)
    in_list, _ = _lookup(listed, bcs)
    is_cell = in_list & (counts >= min_reads)
    cells, cell_ct = bcs[is_cell], counts[is_cell].astype(np.uint64)
    queries, q_ct = bcs[~is_cell], counts[~is_cell]
    ok, rep = unique_neighbour(queries, cells, length)
    if control == "no_rescue":
        ok[:] = False
    np.add.at(cell_ct, np.searchsorted(cells, rep[ok]), q_ct[ok].astype(np.uint64))
    keys = np.concatenate([cells, queries[ok]])
    vals = np.concatenate([cells, rep[ok]])
    order = np.argsort(keys, kind="stable")
    return cells, cell_ct, (keys[order], vals[order]), {
        "rescue_queries": int(len(queries)), "rescue_kept": int(len(cells))}


def correct(map_keys: np.ndarray, map_vals: np.ndarray, bcs: np.ndarray):
    """Each barcode through the correction map: (found, corrected)."""
    hit, idx = _lookup(map_keys, bcs)
    return hit, np.where(hit, map_vals[idx] if len(map_vals) else 0, 0).astype(np.uint64)
