"""Unmapped-read barcode counts sidecar.

The upstream mapper writes ``unmapped_bc_count.bin`` next to the RAD
file; collate corrects its barcodes and writes
``unmapped_bc_count_collated.bin``, which quant reads to compute the
per-cell mapping rate (reference: src/collate.rs:344-393 via
libradicl's unmapped module; quant.rs:1444-1454).

Layouts (all little-endian):

* mapper input, legacy: repeated raw ``bc:u64 | count:u32`` pairs
  (the fallback the reference decodes at src/collate.rs:372-384).
* collated single-barcode output: bincode(1.x, fixint)
  ``HashMap<u64, u32>`` — ``n:u64`` then ``n`` × ``(key:u64, val:u32)``
  entries.  This is byte-compatible with what the reference's own ATAC
  collate writes for the *same* filename (src/atac/collate.rs:255-260)
  and with the historical alevin-fry single-barcode layout; we emit
  entries sorted by key for determinism (bincode map decoding is
  order-insensitive).
* collated multi-barcode output: bincode ``HashMap<(u64, u64), u32>``
  keyed ``(corrected_sample, corrected_cell)`` (src/collate.rs:264-331
  semantics) — ``n:u64`` then ``n`` × 20-byte entries.

Readers sniff the layout from the length prefix: a single map is
``8 + 12n`` bytes, a multi map ``8 + 20n``, raw legacy pairs ``12n``.
A missing or unreadable file degrades to empty counts, matching the
reference's unwrap_or_else fallback at quant.rs:1448-1453.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np


def _split_pairs(raw: bytes, n: int, key_w: int) -> Tuple[np.ndarray, np.ndarray]:
    """View ``n`` records of (key bytes, u32 count); key little-endian."""
    recsz = key_w + 4
    arr = np.frombuffer(raw, np.uint8, count=n * recsz).reshape(n, recsz)
    key = np.zeros(n, np.uint64)
    for k in range(key_w):
        key |= arr[:, k].astype(np.uint64) << np.uint64(8 * k)
    cts = arr[:, key_w:].copy().view(np.uint32).ravel()
    return key, cts


def read_raw_unmapped(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """Read the mapper's unmapped-count file: legacy (u64, u32) raw
    pairs, or an already-bincode map.  Missing/odd files yield empty."""
    p = Path(path)
    if not p.exists():
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    raw = p.read_bytes()
    if len(raw) >= 8:
        (n,) = struct.unpack_from("<Q", raw)
        if len(raw) == 8 + 12 * n:  # bincode HashMap<u64,u32>
            return _split_pairs(raw[8:], n, 8)
    if len(raw) % 12 == 0 and len(raw) > 0:
        n = len(raw) // 12
        return _split_pairs(raw, n, 8)
    return np.zeros(0, np.uint64), np.zeros(0, np.uint32)


def write_collated_single(path: Path, bcs: np.ndarray, counts: np.ndarray) -> None:
    """bincode HashMap<u64,u32>, entries sorted by key."""
    bcs = np.asarray(bcs, np.uint64)
    counts = np.asarray(counts, np.uint32)
    order = np.argsort(bcs, kind="stable")
    bcs, counts = bcs[order], counts[order]
    rec = np.zeros((len(bcs), 12), np.uint8)
    rec[:, :8] = bcs.view(np.uint8).reshape(-1, 8)
    rec[:, 8:] = counts.view(np.uint8).reshape(-1, 4)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(bcs)))
        fh.write(rec.tobytes())


def write_collated_multi(
    path: Path, sample_bcs: np.ndarray, cell_bcs: np.ndarray, counts: np.ndarray
) -> None:
    """bincode HashMap<(u64,u64),u32> keyed (sample, cell), entries
    sorted by (sample, cell)."""
    sample_bcs = np.asarray(sample_bcs, np.uint64)
    cell_bcs = np.asarray(cell_bcs, np.uint64)
    counts = np.asarray(counts, np.uint32)
    order = np.lexsort((cell_bcs, sample_bcs))
    rec = np.zeros((len(counts), 20), np.uint8)
    rec[:, :8] = sample_bcs[order].view(np.uint8).reshape(-1, 8)
    rec[:, 8:16] = cell_bcs[order].view(np.uint8).reshape(-1, 8)
    rec[:, 16:] = counts[order].view(np.uint8).reshape(-1, 4)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(counts)))
        fh.write(rec.tobytes())


def read_collated(path: Path):
    """Read a collated unmapped-counts file; returns (key_bcs, counts,
    num_fields) where key_bcs is the *last* (cell) key field."""
    p = Path(path)
    if not p.exists():
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32), 1
    raw = p.read_bytes()
    if len(raw) >= 8:
        (n,) = struct.unpack_from("<Q", raw)
        if len(raw) == 8 + 12 * n:  # single: HashMap<u64,u32>
            bcs, cts = _split_pairs(raw[8:], n, 8)
            return bcs, cts, 1
        if len(raw) == 8 + 20 * n:  # multi: HashMap<(u64,u64),u32>
            arr = np.frombuffer(raw[8:], np.uint8, count=n * 20).reshape(n, 20)
            cell = np.zeros(n, np.uint64)
            for k in range(8):
                cell |= arr[:, 8 + k].astype(np.uint64) << np.uint64(8 * k)
            cts = arr[:, 16:].copy().view(np.uint32).ravel()
            return cell, cts, 2
    if len(raw) % 12 == 0 and len(raw) > 0:  # legacy raw pairs
        bcs, cts = _split_pairs(raw, len(raw) // 12, 8)
        return bcs, cts, 1
    return np.zeros(0, np.uint64), np.zeros(0, np.uint32), 1


class UnmappedLookup:
    """Binary-search lookup of unmapped counts by (cell) barcode."""

    def __init__(self, bcs: np.ndarray, counts: np.ndarray):
        order = np.argsort(bcs, kind="stable")
        self.bcs = np.asarray(bcs, np.uint64)[order]
        # aggregate duplicates (multi-sample keys share cell bcs)
        if len(self.bcs):
            uniq, inv = np.unique(self.bcs, return_inverse=True)
            agg = np.zeros(len(uniq), np.uint64)
            np.add.at(agg, inv, np.asarray(counts, np.uint64)[order])
            self.bcs, self.counts = uniq, agg
        else:
            self.counts = np.zeros(0, np.uint64)

    @classmethod
    def from_file(cls, path: Path) -> "UnmappedLookup":
        bcs, cts, _ = read_collated(path)
        return cls(bcs, cts)

    def get(self, bcs: np.ndarray) -> np.ndarray:
        """Vectorized count lookup (0 where missing)."""
        bcs = np.asarray(bcs, np.uint64)
        if len(self.bcs) == 0:
            return np.zeros(len(bcs), np.uint64)
        idx = np.searchsorted(self.bcs, bcs)
        idx_c = np.minimum(idx, len(self.bcs) - 1)
        hit = (idx < len(self.bcs)) & (self.bcs[idx_c] == bcs)
        return np.where(hit, self.counts[idx_c], np.uint64(0))
