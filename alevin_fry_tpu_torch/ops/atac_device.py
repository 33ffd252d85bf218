"""Lexicographic sort and run-length count of integer columns on the
device, for the ATAC sort and deduplicate stages (port of
``alevin_fry_tpu/ops/atac_device.py``: ``_sort_rle_fn`` :98,
``sort_rle_device`` :249 and ``sort_rle`` :231).

The reference sorts ``HitInfo{chr, start, frag_len, barcode}`` rows per
genomic-bin bucket (src/atac/sort.rs:45-131) and per cell with the cell
as the outer key (src/atac/deduplicate.rs:175-226), then counts the
runs of equal rows.  Here the columns pack MSB-first into 64-bit words
on the host (a column never splits across words, so the words'
lexicographic order is the columns'), the words go to the device as
int64, and there:

* stable ``torch.sort`` passes from the least significant word up give
  the lexicographic order; each pass sorts its word with bit 63
  flipped, so the signed sort is the unsigned order (32-base barcodes
  and 64-bit columns use bit 63);
* a run starts at every row that differs from its predecessor in any
  word;
* the run lengths are the segment totals of :func:`segscan.seg_sum`
  (kernels K1 and K2);
* a gather of the run starts compacts the unique rows.

The result equals ``np.lexsort(cols[::-1])`` followed by run lengths.
There is no word budget and no padding: any number of words is sorted,
at the exact length.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import segscan

I64_MIN = -(1 << 63)
# K1 keeps an int32 running sum over all rows, so one call takes fewer
# than 2^31 rows; a bucket of --max-records rows (30M by default) or a
# block of the collated file (30M reads) is far below
MAX_ROWS = (1 << 31) - 1


def pack_words(cols: Sequence[np.ndarray]) -> Tuple[List[np.ndarray], list]:
    """Pack non-negative integer columns MSB-first into uint64 words,
    first fit in column order (a column never splits across words).
    Returns (words, layouts), a layout being the (column, width) pairs
    of one word from its most significant bits down."""
    layouts: list = []
    cur: list = []
    used = 0
    for i, c in enumerate(cols):
        w = max(int(c.max()).bit_length(), 1) if len(c) else 1
        if used + w > 64:
            layouts.append(cur)
            cur, used = [], 0
        cur.append((i, w))
        used += w
    layouts.append(cur)
    words = []
    for lay in layouts:
        word = np.zeros(len(cols[0]), np.uint64)
        shift = sum(w for _, w in lay)
        for ci, w in lay:
            shift -= w
            word |= cols[ci].astype(np.uint64) << np.uint64(shift)
        words.append(word)
    return words, layouts


def unpack_cols(words: Sequence[np.ndarray], layouts, dtypes) -> List[np.ndarray]:
    """Inverse of :func:`pack_words`, each column in its given dtype."""
    out: list = [None] * len(dtypes)
    for word, lay in zip(words, layouts):
        shift = sum(w for _, w in lay)
        for ci, w in lay:
            shift -= w
            mask = np.uint64((1 << w) - 1)
            out[ci] = ((word >> np.uint64(shift)) & mask).astype(dtypes[ci])
    return out


def sort_rle(cols: Sequence[np.ndarray], device: torch.device):
    """Sort the rows of equal-length non-negative integer columns
    lexicographically (first column most significant) on ``device``
    and count the runs of equal rows.  Returns (unique rows' columns,
    each in its input dtype, and the run lengths as int64)."""
    cols = [np.asarray(c) for c in cols]
    n = len(cols[0]) if cols else 0
    if n == 0:
        return [c[:0] for c in cols], np.zeros(0, np.int64)
    if n >= MAX_ROWS:
        raise ValueError(f"sort_rle takes fewer than {MAX_ROWS} rows, got {n}")
    for c in cols:
        if c.dtype.kind not in "iu" or len(c) != n:
            raise TypeError("sort_rle takes integer columns of one length")
        if c.dtype.kind == "i" and int(c.min()) < 0:
            raise ValueError("sort_rle takes non-negative columns")
    words, layouts = pack_words(cols)
    dev_words = [torch.from_numpy(w.view(np.int64)).to(device) for w in words]
    perm = None
    for w in reversed(dev_words):
        key = (w if perm is None else w[perm]) ^ I64_MIN
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    sw = [w[perm] for w in dev_words]
    new = torch.zeros(n, dtype=torch.bool, device=device)
    new[0] = True
    for w in sw:
        new[1:] |= w[1:] != w[:-1]
    counts = segscan.seg_sum(torch.ones(n, dtype=torch.int32, device=device), new)
    starts = torch.nonzero(new).squeeze(1)
    both = torch.stack([counts[starts].to(torch.int64), *(w[starts] for w in sw)])
    host = both.cpu().numpy()
    uniq = unpack_cols([row.view(np.uint64) for row in host[1:]], layouts,
                       [c.dtype for c in cols])
    return uniq, host[0]
