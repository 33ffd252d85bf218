"""cr-like winner-take-all counting: host preparation of the keys and
the device entry point (port of ``alevin_fry_tpu/ops/crlike.py``).

Each read's alignments project to genes and deduplicate per read on the
host (NumPy plus the native segmented sort); the (cell, umi,
gene) triplets then pack into int64 keys of at most 62 bits, or, when
their fields need more (long UMIs), go as one int64 word per field, and
``ops/crlike_device.py`` resolves them on the chosen device.  There is
no host fallback: a device failure raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..radz import _native

from .crlike_device import PAD, resolve_crlike_wta_device, resolve_crlike_wta_words


def _bits_for(n: int) -> int:
    return max(int(n) - 1, 1).bit_length()


def _sort_unique_counts(key: np.ndarray, seg_offsets=None):
    """Sort + run-length encode a uint64 key array -> (unique keys,
    run counts); the native segmented kernel when the segments are
    known."""
    if seg_offsets is not None and _native.available() and len(key) > 4096:
        return _native.sort_rle_u64_segments(
            np.ascontiguousarray(key, np.uint64), seg_offsets
        )
    key = np.sort(key)
    if not len(key):
        return key, np.zeros(0, np.int64)
    new = np.ones(len(key), bool)
    new[1:] = key[1:] != key[:-1]
    starts = np.flatnonzero(new)
    return key[starts], np.diff(np.append(starts, len(key)))


def _dedup_read_genes(
    refs: np.ndarray, aln_offsets: np.ndarray, tid_to_gid: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Project alignments to genes and deduplicate within each read ->
    (pair_read, pair_gene)."""
    n = len(aln_offsets) - 1
    read_of_aln = np.repeat(np.arange(n, dtype=np.int64), np.diff(aln_offsets))
    genes = tid_to_gid[refs]
    gbits = _bits_for(int(genes.max()) + 1 if len(genes) else 1)
    rbits = _bits_for(n if n else 1)
    if gbits + rbits <= 63:
        # alignments are contiguous per read: sort only within reads
        key = (read_of_aln.astype(np.uint64) << np.uint64(gbits)) | genes.astype(np.uint64)
        key, _ = _sort_unique_counts(key, np.ascontiguousarray(aln_offsets, np.int64))
        return (key >> np.uint64(gbits)).astype(np.int64), (
            key & np.uint64((1 << gbits) - 1)
        ).astype(tid_to_gid.dtype)
    order = np.lexsort((genes, read_of_aln))
    r_s, g_s = read_of_aln[order], genes[order]
    first = np.ones(len(r_s), bool)
    first[1:] = (r_s[1:] != r_s[:-1]) | (g_s[1:] != g_s[:-1])
    return r_s[first], g_s[first]


def wta_counts_device(
    cell_of_read: np.ndarray,
    umi: np.ndarray,
    refs: np.ndarray,
    aln_offsets: np.ndarray,
    tid_to_gid: np.ndarray,
    n_rows: int,
    device: torch.device,
    usa: bool = False,
):
    """cr-like WTA resolution and counting on ``device``: gene-unique
    (plain) or USA slotting (``usa``; gene ids interleaved, ``n_rows``
    the three-section space).  Returns COO (rows, cols, counts f32)
    sorted by (cell, column)."""
    pair_read, pair_gene = _dedup_read_genes(refs, aln_offsets, tid_to_gid)
    c = cell_of_read[pair_read]
    u = umi[pair_read]
    g = pair_gene
    if len(c) == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float32)
    cbits = _bits_for(int(c.max()) + 1)
    ubits = _bits_for(int(u.max()) + 1)
    gbits = _bits_for(int(g.max()) + 1)
    # one packed key up to 62 bits, so that no key reaches INT64_MAX,
    # the resolver's padding; beyond, one word per field
    if cbits + ubits + gbits > 62:
        if int(c.max()) * n_rows + n_rows > PAD:
            raise ValueError(f"{int(c.max()) + 1} cells x {n_rows} columns do "
                             "not fit the int64 output words")
        words = (c.astype(np.int64), np.ascontiguousarray(u, np.uint64).view(np.int64),
                 g.astype(np.int64))
        return resolve_crlike_wta_words(
            *(torch.from_numpy(w).to(device) for w in words), gbits, n_rows, usa=usa
        )
    key = (
        (c.astype(np.int64) << (ubits + gbits))
        | (u.astype(np.int64) << gbits)
        | g.astype(np.int64)
    )
    return resolve_crlike_wta_device(
        torch.from_numpy(key).to(device), ubits, gbits, n_rows, usa=usa
    )
