"""cr-like winner-take-all (WTA) resolution on the device.

Port of ``alevin_fry_tpu/ops/crlike_device.py``: ``_kernel`` (:200),
``_kernel_usa`` (:335, both branches) and ``resolve_crlike_wta_device``
(:915).  One pass over packed
(cell, umi, gene) keys — sort, run-length aggregate, segmented argmax
with tie sets, then gene-unique counting (plain) or the USA
spliced / unspliced / ambiguous slot rules — with the segmented sums,
maxima and look-backs on kernels K1-K3 (``ops/segscan.py``).  Sorts,
shifts, masks and the group ordinal are plain PyTorch ops on the same
device.

Semantics follow resolve_num_molecules_crlike_from_vec
(src/pugutils.rs:644-749) and the USA rules of extract_counts
(src/utils.rs:656-739, src/quant.rs:516-589).

The (cell, umi, gene) triplets come in one of two forms:

* packed into one int64 key of at most 62 bits (10x: 16-base barcodes,
  12-base UMIs), sorted with padding PAD = INT64_MAX, which a signed
  sort puts last (``interop.py``);
* wider, as three int64 words, one each for cell, UMI and gene, sorted
  at their exact length with stable ``torch.sort`` passes from the gene
  up, each word with bit 63 flipped so that a UMI of 32 bases, which
  uses bit 63, sorts unsigned (as ``ops/atac_device.py`` sorts).

Either way the sort yields the same runs: a triplet starts where any
field differs, a (cell, umi) group where the cell or the UMI does; the
resolution after it is shared.  Output is the compact COO (rows, cols,
counts f32) sorted by (cell, column), selected on the device at the run
starts and fetched with one copy.
"""

from __future__ import annotations

import numpy as np
import torch

from .atac_device import lex_order
from .segscan import last_marked, seg_reduce, seg_sum

PAD = (1 << 63) - 1


def _starts(key: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """First row of each run of equal keys, among valid rows."""
    prev = torch.cat([key[:1] ^ 1, key[:-1]])
    return (key != prev) & valid


def _counted(cg: torch.Tensor):
    """Sort the (cell, column) words of the counted molecules and
    aggregate: (unique words, counts) on the device."""
    cg = torch.sort(cg).values
    valid = cg != PAD
    start = _starts(cg, valid)
    count = seg_sum(valid.to(torch.int32), start)
    return cg[start], count[start]


def _sorted_packed(key: torch.Tensor, ubits: int, gbits: int):
    """Sort packed keys (PAD last) -> (cell, gene, valid, triplet
    starts, (cell, umi) group starts) per row."""
    key = torch.sort(key).values
    valid = key != PAD
    trip_start = _starts(key, valid)
    grp_start = _starts(key >> gbits, valid)
    return key >> (ubits + gbits), key & ((1 << gbits) - 1), valid, trip_start, grp_start


def _sorted_words(cell: torch.Tensor, umi: torch.Tensor, gene: torch.Tensor):
    """Sort (cell, umi, gene) int64 words lexicographically, the UMI as
    unsigned -> the rows of :func:`_sorted_packed` (every row valid)."""
    perm = lex_order([cell, umi, gene])
    cell, umi, gene = cell[perm], umi[perm], gene[perm]
    grp_start = torch.ones_like(cell, dtype=torch.bool)
    grp_start[1:] = (cell[1:] != cell[:-1]) | (umi[1:] != umi[:-1])
    trip_start = grp_start.clone()
    trip_start[1:] |= gene[1:] != gene[:-1]
    return cell, gene, torch.ones_like(grp_start), trip_start, grp_start


def _trip_groups(valid, trip_start, grp_start, gene=None):
    """Group ordinals and the winner rows: the triplets of largest count
    in their (cell, umi) group or, given ``gene`` (prefer-ambig), the
    triplets of the gene pairs {2k, 2k+1} of largest summed count."""
    grp_ord = torch.cumsum(grp_start, 0, dtype=torch.int32)
    t_count = seg_sum(valid.to(torch.int32), trip_start)
    tc = torch.where(trip_start, t_count, torch.zeros_like(t_count))
    if gene is not None:
        # a pair's triplets are adjacent in the sorted rows: a pair run
        # starts with its group or where gene >> 1 changes
        gp = gene >> 1
        pair_start = grp_start | (trip_start & torch.cat([gp[:1] ^ 1, gp[:-1]]).ne(gp))
        p_count = seg_sum(tc, pair_start)
        tc = torch.where(trip_start, p_count, torch.zeros_like(p_count))
    gmax = seg_reduce(tc, trip_start, grp_start, grp_ord)
    winner = trip_start & (tc == gmax)
    return grp_ord, winner


def _kernel(rows, n_rows: int):
    """Gene-unique counting: +1 at (cell, gene) for each (cell, umi)
    whose winner tie set is a single gene.  ``rows`` are the sorted
    rows of :func:`_sorted_packed` or :func:`_sorted_words`."""
    cell, gene, valid, trip_start, grp_start = rows
    _, winner = _trip_groups(valid, trip_start, grp_start)
    tie_sz = seg_sum(winner.to(torch.int32), grp_start)
    unique_win = winner & (tie_sz == 1)
    return _counted(torch.where(unique_win, cell * n_rows + gene, PAD))


def _kernel_usa(rows, n_rows: int, prefer_ambig: bool = False):
    """USA slotting: per (cell, umi) the winner tie set maps to a
    spliced / unspliced / ambiguous slot by the reference's len-1 / 2 /
    3..10 rules.  Gene ids are the interleaved USA ids (even spliced,
    odd unspliced); ``n_rows`` is the three-section output space.  With
    ``prefer_ambig`` counts add up per gene pair and a winning pair
    keeps every variant observed (pugutils.rs:505-641)."""
    cell, gene, valid, trip_start, grp_start = rows
    grp_ord, winner = _trip_groups(valid, trip_start, grp_start,
                                   gene if prefer_ambig else None)
    tie_sz, wrank = seg_sum(winner.to(torch.int32), grp_start, with_rank=True)
    # one emission row per group, its last winner: winners ascend by gene
    # within the group, so that row's own gene is the group's largest
    last_win = winner & (wrank == tie_sz)

    gi = gene.to(torch.int32)
    even = (gi & 1) == 0
    uoff = n_rows // 3
    aoff = 2 * (n_rows // 3)

    g1p = last_marked(gi, winner, grp_ord, strict=True)
    sg = last_marked(gi, winner & even, grp_ord)
    nspl = seg_sum((winner & even).to(torch.int32), grp_start)
    # the unspliced partner of the unique spliced gene sorts right after
    # it, so its previous winner is exactly its even pair mate
    podd = winner & ~even & (g1p == gi - 1)
    partner = seg_sum(podd.to(torch.int32), grp_start) > 0

    l_ = tie_sz
    g2 = gi
    g1 = torch.where(l_ == 1, gi, g1p)
    sp1 = (g1 & 1) == 0
    sp2 = (g2 & 1) == 0
    same = (g1 & ~1) == (g2 & ~1)
    slot1 = torch.where(sp2, g2 >> 1, uoff + (g2 >> 1))
    slot2 = torch.where(
        same, aoff + (g1 >> 1), torch.where(sp1 & ~sp2, g1 >> 1, g2 >> 1)
    )
    ok2 = same | (sp1 & ~sp2) | (~sp1 & sp2)
    slot3 = torch.where(partner, aoff + (sg >> 1), sg >> 1)
    ok3 = nspl == 1
    slot = torch.where(l_ == 1, slot1, torch.where(l_ == 2, slot2, slot3))
    ok = torch.where(
        l_ == 1, torch.ones_like(ok2),
        torch.where(l_ == 2, ok2, (l_ >= 3) & (l_ <= 10) & ok3),
    )
    return _counted(torch.where(last_win & ok, cell * n_rows + slot.to(torch.int64), PAD))


def _counts(rows, gbits: int, n_rows: int, usa: bool, prefer_ambig: bool):
    """The counted (cell * n_rows + column) words and their counts, on
    the rows' device."""
    if usa and gbits + 1 > 31:
        raise ValueError("USA gene ids must fit the 31-bit look-back values")
    if prefer_ambig and not usa:
        raise ValueError("prefer-ambig applies to USA mode only")
    return _kernel_usa(rows, n_rows, prefer_ambig) if usa else _kernel(rows, n_rows)


def _resolve(rows, gbits: int, n_rows: int, usa: bool, prefer_ambig: bool):
    uniq, cnt = _counts(rows, gbits, n_rows, usa, prefer_ambig)
    both = torch.stack([uniq, cnt.to(torch.int64)]).cpu().numpy()
    return (
        both[0] // n_rows,
        both[0] % n_rows,
        both[1].astype(np.float32),
    )


def _empty_coo():
    z = np.zeros(0, np.int64)
    return z, z, np.zeros(0, np.float32)


def resolve_crlike_wta_device(
    key: torch.Tensor, ubits: int, gbits: int, n_rows: int, usa: bool = False,
    prefer_ambig: bool = False,
):
    """Resolve deduplicated packed (cell, umi, gene) int64 keys on
    ``key``'s device.  Returns host COO triplets (rows, cols, counts
    f32) sorted by (cell, column), identical to the reference's
    ``resolve_crlike_wta_device`` on the same keys."""
    if key.dtype != torch.int64:
        raise TypeError("keys are int64")
    if len(key) == 0:
        return _empty_coo()
    return _resolve(_sorted_packed(key, ubits, gbits), gbits, n_rows, usa, prefer_ambig)


def resolve_crlike_wta_words(
    cell: torch.Tensor, umi: torch.Tensor, gene: torch.Tensor, gbits: int,
    n_rows: int, usa: bool = False, prefer_ambig: bool = False,
):
    """:func:`resolve_crlike_wta_device` for triplets too wide to pack:
    deduplicated (cell, umi, gene) as three int64 tensors on one device,
    the UMI's bits as they are (a UMI of 32 bases is negative), cell and
    gene non-negative, ``gene < 2**gbits`` and ``cell * n_rows`` below
    INT64_MAX.  The same COO triplets as the packed form gives."""
    if not cell.dtype == umi.dtype == gene.dtype == torch.int64:
        raise TypeError("cell, umi and gene words are int64")
    if not len(cell) == len(umi) == len(gene):
        raise ValueError("cell, umi and gene words differ in length")
    if len(cell) == 0:
        return _empty_coo()
    return _resolve(_sorted_words(cell, umi, gene), gbits, n_rows, usa, prefer_ambig)
