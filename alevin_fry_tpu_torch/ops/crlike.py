"""UMI resolution: the cr-like winner-take-all counting on the device,
and the host resolutions (port of ``alevin_fry_tpu/ops/crlike.py``).

:func:`wta_counts_device`: each read's alignments project to genes and
deduplicate per read on the host (NumPy plus the native segmented sort);
the (cell, umi, gene) triplets then pack into int64 keys of at most 62
bits, or, when their fields need more (long UMIs), go as one int64 word
per field, and ``ops/crlike_device.py`` resolves them on the chosen
device.  There is no host fallback: a device failure raises.

The host side, in NumPy as in the reference, serves the resolutions
that keep each (cell, UMI)'s tie set: :func:`resolve_crlike` (the
winner-take-all or prefer-ambiguity tie sets, pugutils.rs:505-749),
:func:`group_eqclasses` (per-cell gene-level equivalence classes, the
EM's and ``--dump-eqclasses``' input), the USA slot rules
(utils.rs:656-739) and label transform (utils.rs:825-909), and
:func:`resolve_trivial` (pugutils.rs:852-911).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .. import spans
from ..radz import _native

from .crlike_device import PAD, resolve_crlike_wta_device, resolve_crlike_wta_words


def _bits_for(n: int) -> int:
    return max(int(n) - 1, 1).bit_length()


@dataclass
class UmiGroups:
    """Per-(cell, umi) resolved tie sets, CSR: ``labels`` ascending
    distinct gene ids per group."""

    cell: np.ndarray           # (G,) int64 cell index per group
    umi: np.ndarray            # (G,) uint64
    label_offsets: np.ndarray  # (G+1,) int64
    labels: np.ndarray         # flat uint32 gene ids


@dataclass
class CellEqClasses:
    """Per-cell gene-level equivalence classes, CSR over CSR: the classes
    of cell ``cell_ids[i]`` are ``cell_eq_offsets[i]:cell_eq_offsets[i+1]``;
    class j has labels ``labels[label_offsets[j]:label_offsets[j+1]]``
    and count ``counts[j]``."""

    cell_ids: np.ndarray         # (C,) distinct cell indices, ascending
    cell_eq_offsets: np.ndarray  # (C+1,)
    label_offsets: np.ndarray    # (E+1,)
    labels: np.ndarray           # flat uint32
    counts: np.ndarray           # (E,) uint32


def _segments_of_sorted(col: np.ndarray):
    """Offsets of the runs of a nondecreasing column, or None if it is
    empty or not nondecreasing."""
    n = len(col)
    if n == 0 or not bool((col[1:] >= col[:-1]).all()):
        return None
    starts = np.flatnonzero(col[1:] != col[:-1]) + 1
    return np.concatenate(([0], starts, [n])).astype(np.int64)


def _sort_unique_counts(key: np.ndarray, seg_offsets=None):
    """Sort + run-length encode a uint64 key array -> (unique keys,
    run counts); the native segmented kernel when the segments are
    known, else one NumPy sort."""
    if seg_offsets is not None:
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
    prefer_ambig: bool = False,
):
    """cr-like WTA resolution and counting on ``device``: gene-unique
    (plain) or USA slotting (``usa``; gene ids interleaved, ``n_rows``
    the three-section space; ``prefer_ambig`` counts per spliced /
    unspliced gene pair).  Returns COO (rows, cols, counts f32) sorted
    by (cell, column).  The deduplication and key packing on the host
    are a ``key_pack`` span, the resolver on ``device`` a ``wta`` span."""
    with spans.span("key_pack", "resolution"):
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
        wide = cbits + ubits + gbits > 62
        if wide:
            if int(c.max()) * n_rows + n_rows > PAD:
                raise ValueError(f"{int(c.max()) + 1} cells x {n_rows} columns do "
                                 "not fit the int64 output words")
            words = (c.astype(np.int64), np.ascontiguousarray(u, np.uint64).view(np.int64),
                     g.astype(np.int64))
        else:
            key = (
                (c.astype(np.int64) << (ubits + gbits))
                | (u.astype(np.int64) << gbits)
                | g.astype(np.int64)
            )
    with spans.span("wta", "resolution"):
        if wide:
            return resolve_crlike_wta_words(
                *(torch.from_numpy(w).to(device) for w in words), gbits, n_rows, usa=usa,
                prefer_ambig=prefer_ambig,
            )
        return resolve_crlike_wta_device(
            torch.from_numpy(key).to(device), ubits, gbits, n_rows, usa=usa,
            prefer_ambig=prefer_ambig,
        )


# --- host resolution (pugutils.rs:505-749) ------------------------------------

def resolve_crlike(
    cell_of_read: np.ndarray,
    umi: np.ndarray,
    refs: np.ndarray,
    aln_offsets: np.ndarray,
    tid_to_gid: np.ndarray,
    prefer_ambig: bool = False,
) -> UmiGroups:
    """Each (cell, umi)'s tie set: the genes of largest read count
    (``prefer_ambig``: every observed variant of the gene pairs of
    largest count), all cells at once."""
    pair_read, pair_gene = _dedup_read_genes(refs, aln_offsets, tid_to_gid)
    c = cell_of_read[pair_read]
    u = umi[pair_read]
    g = pair_gene
    cbits = _bits_for(int(c.max()) + 1 if len(c) else 1)
    ubits = _bits_for(int(u.max()) + 1 if len(u) else 1)
    gbits = _bits_for(int(g.max()) + 1 if len(g) else 1)
    if cbits + ubits + gbits <= 64:
        key = (
            (c.astype(np.uint64) << np.uint64(ubits + gbits))
            | (u.astype(np.uint64) << np.uint64(gbits))
            | g.astype(np.uint64)
        )
        # reads arrive grouped by cell: sort within cell runs
        uniq, counts = _sort_unique_counts(key, _segments_of_sorted(c))
        tg = (uniq & np.uint64((1 << gbits) - 1)).astype(pair_gene.dtype)
        tu = (uniq >> np.uint64(gbits)) & np.uint64((1 << ubits) - 1)
        tc = (uniq >> np.uint64(ubits + gbits)).astype(np.int64)
        t_counts = counts.astype(np.uint32)
    else:
        order = np.lexsort((g, u, c))
        c, u, g = c[order], u[order], g[order]
        new_t = np.ones(len(c), bool)
        if len(c):
            new_t[1:] = (c[1:] != c[:-1]) | (u[1:] != u[:-1]) | (g[1:] != g[:-1])
        t_start = np.flatnonzero(new_t)
        tc, tu, tg = c[t_start], u[t_start], g[t_start]
        t_counts = np.diff(np.append(t_start, len(c))).astype(np.uint32)
    if prefer_ambig:
        return _winners_prefer_ambig(tc, tu, tg, t_counts)
    return _winners_wta(tc, tu, tg, t_counts)


def _winners_wta(tc, tu, tg, t_counts) -> UmiGroups:
    if len(tc) == 0:
        return UmiGroups(cell=tc, umi=tu, label_offsets=np.zeros(1, np.int64),
                         labels=tg.astype(np.uint32))
    new_g = np.ones(len(tc), bool)
    new_g[1:] = (tc[1:] != tc[:-1]) | (tu[1:] != tu[:-1])
    g_start = np.flatnonzero(new_g)
    gid = np.cumsum(new_g) - 1
    gmax = np.maximum.reduceat(t_counts, g_start)
    win = t_counts == gmax[gid]
    offsets = np.zeros(len(g_start) + 1, np.int64)
    np.cumsum(np.add.reduceat(win.astype(np.int64), g_start), out=offsets[1:])
    return UmiGroups(cell=tc[g_start], umi=tu[g_start], label_offsets=offsets,
                     labels=tg[win].astype(np.uint32))


def _winners_prefer_ambig(tc, tu, tg, t_counts) -> UmiGroups:
    """Counts aggregate per gene pair (the spliced id); a winning pair
    keeps every variant observed (pugutils.rs:505-641)."""
    pair = tg & ~np.uint32(1)
    new_p = np.ones(len(tc), bool)
    if len(tc):
        new_p[1:] = (tc[1:] != tc[:-1]) | (tu[1:] != tu[:-1]) | (pair[1:] != pair[:-1])
    pid = np.cumsum(new_p) - 1
    n_pairs = int(pid[-1]) + 1 if len(tc) else 0
    pair_counts = np.zeros(n_pairs, np.uint64)
    np.add.at(pair_counts, pid, t_counts.astype(np.uint64))
    p_start = np.flatnonzero(new_p)
    pc, pu = tc[p_start], tu[p_start]
    new_g = np.ones(n_pairs, bool)
    if n_pairs:
        new_g[1:] = (pc[1:] != pc[:-1]) | (pu[1:] != pu[:-1])
    gid_of_pair = np.cumsum(new_g) - 1
    n_groups = int(gid_of_pair[-1]) + 1 if n_pairs else 0
    gmax = np.zeros(n_groups, np.uint64)
    np.maximum.at(gmax, gid_of_pair, pair_counts)
    win = (pair_counts == gmax[gid_of_pair])[pid]
    label_counts = np.zeros(n_groups, np.int64)
    np.add.at(label_counts, gid_of_pair[pid[win]], 1)
    offsets = np.zeros(n_groups + 1, np.int64)
    np.cumsum(label_counts, out=offsets[1:])
    g_start = np.flatnonzero(new_g)
    return UmiGroups(cell=pc[g_start], umi=pu[g_start], label_offsets=offsets,
                     labels=tg[win].astype(np.uint32))


# --- USA slotting (utils.rs:656-739 / quant.rs:516-589) -----------------------

def usa_slots_for_groups(groups: UmiGroups, num_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each group's USA output slot -> (slot, valid): len 1 direct, len 2
    one gene's pair -> ambiguous else the spliced one, len 3..10 the
    single-spliced rule; ``valid`` is False where the UMI is dropped."""
    unspliced_off = num_rows // 3
    ambig_off = 2 * unspliced_off
    G = len(groups.cell)
    lens = np.diff(groups.label_offsets)
    slot = np.zeros(G, np.int64)
    valid = np.zeros(G, bool)
    labels = groups.labels
    offs = groups.label_offsets

    m1 = lens == 1
    if m1.any():
        g0 = labels[offs[:-1][m1]]
        slot[m1] = np.where((g0 & 1) == 0, g0 >> 1, unspliced_off + (g0 >> 1))
        valid[m1] = True

    m2 = lens == 2
    if m2.any():
        s = offs[:-1][m2]
        g1 = labels[s].astype(np.int64)
        g2 = labels[s + 1].astype(np.int64)
        same = (g1 & ~1) == (g2 & ~1)
        sp1 = (g1 & 1) == 0
        sp2 = (g2 & 1) == 0
        sl = np.where(
            same, ambig_off + (g1 >> 1),
            np.where(sp1 & ~sp2, g1 >> 1, np.where(~sp1 & sp2, g2 >> 1, -1)),
        )
        slot[m2] = np.where(sl >= 0, sl, 0)
        valid[m2] = sl >= 0

    mm = (lens >= 3) & (lens <= 10)
    if mm.any():
        elem_group = np.repeat(np.arange(G), lens)
        in_mm = mm[elem_group]
        eg = elem_group[in_mm]
        el = labels[in_mm]
        spl = (el & 1) == 0
        nspl = np.zeros(G, np.int64)
        np.add.at(nspl, eg[spl], 1)
        sgene = np.zeros(G, np.uint32)
        sgene[eg[spl]] = el[spl]  # the one spliced gene where nspl == 1
        partner = np.zeros(G, bool)
        is_partner = (~spl) & ((el & ~np.uint32(1)) == (sgene[eg] & ~np.uint32(1)))
        np.bitwise_or.at(partner, eg[is_partner], True)
        ok = mm & (nspl == 1)
        slot[ok] = np.where(partner[ok], ambig_off + (sgene[ok] >> 1), sgene[ok] >> 1)
        valid[ok] = True
    return slot, valid


def nonusa_unique_slots(groups: UmiGroups) -> Tuple[np.ndarray, np.ndarray]:
    """Plain gene-unique counting: only single-gene tie sets count."""
    valid = np.diff(groups.label_offsets) == 1
    slot = np.zeros(len(valid), np.int64)
    slot[valid] = groups.labels[groups.label_offsets[:-1][valid]]
    return slot, valid


def counts_from_slots(cell, slot, valid, n_cells: int, n_rows: int):
    """+1 per valid (cell, slot) -> COO (rows, cols, counts f32) sorted
    by (cell, slot)."""
    c = cell[valid]
    key = c.astype(np.uint64) * np.uint64(n_rows) + slot[valid].astype(np.uint64)
    uniq, cts = _sort_unique_counts(key, _segments_of_sorted(c))
    uniq = uniq.astype(np.int64)
    return uniq // n_rows, uniq % n_rows, cts.astype(np.float32)


# --- gene-level equivalence classes (the EM's and the dump's input) -----------

def group_eqclasses(groups: UmiGroups) -> CellEqClasses:
    """Group identical label sets within each cell and count them (the
    reference's gene_eqclass_hash, pugutils.rs:676-679).  Classes are
    numbered by cell, then by a 128-bit content hash of the label list,
    as the reference numbers them."""
    G = len(groups.cell)
    lens = np.diff(groups.label_offsets)
    h1 = np.full(G, np.uint64(1469598103934665603))
    h2 = np.full(G, np.uint64(0x9E3779B97F4A7C15))
    elem_group = np.repeat(np.arange(G), lens)
    el = groups.labels.astype(np.uint64)
    P1 = np.uint64(1099511628211)
    P2 = np.uint64(0x100000001B3)
    pos_in_group = np.arange(len(el), dtype=np.int64) - np.repeat(
        groups.label_offsets[:-1], lens
    )
    for p in range(int(lens.max()) if G else 0):
        sel = pos_in_group == p
        gidx = elem_group[sel]
        h1[gidx] = (h1[gidx] * P1) ^ el[sel]
        h2[gidx] = (h2[gidx] * P2) ^ (el[sel] + np.uint64(0x9E3779B9))
    h1 ^= lens.astype(np.uint64)

    order = np.lexsort((h2, h1, groups.cell))
    c_s, h1_s, h2_s = groups.cell[order], h1[order], h2[order]
    new_e = np.ones(G, bool)
    if G:
        new_e[1:] = (c_s[1:] != c_s[:-1]) | (h1_s[1:] != h1_s[:-1]) | (h2_s[1:] != h2_s[:-1])
    eq_of_sorted = np.cumsum(new_e) - 1
    E = int(eq_of_sorted[-1]) + 1 if G else 0
    counts = np.zeros(E, np.uint32)
    np.add.at(counts, eq_of_sorted, 1)

    rep = order[np.flatnonzero(new_e)]  # one group per class
    rep_lens = lens[rep]
    label_offsets = np.zeros(E + 1, np.int64)
    np.cumsum(rep_lens, out=label_offsets[1:])
    gather = np.repeat(groups.label_offsets[:-1][rep], rep_lens) + (
        np.arange(int(label_offsets[-1])) - np.repeat(label_offsets[:-1], rep_lens)
    )
    cell_ids, cell_counts = np.unique(c_s[np.flatnonzero(new_e)], return_counts=True)
    cell_eq_offsets = np.zeros(len(cell_ids) + 1, np.int64)
    np.cumsum(cell_counts, out=cell_eq_offsets[1:])
    return CellEqClasses(cell_ids=cell_ids, cell_eq_offsets=cell_eq_offsets,
                         label_offsets=label_offsets, labels=groups.labels[gather],
                         counts=counts)


def usa_transform_labels(label_offsets: np.ndarray, labels: np.ndarray,
                         num_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each label's USA slot, a spliced gene followed by its unspliced
    partner collapsing into one ambiguous id (extract_usa_eqmap,
    utils.rs:825-909), over label sets of ascending distinct gene ids ->
    (label_offsets, labels uint32)."""
    unspliced_off = num_rows // 3
    ambig_off = 2 * unspliced_off
    E = len(label_offsets) - 1
    lens = np.diff(label_offsets)
    el = np.asarray(labels, np.uint32)
    n = len(el)
    eg = np.repeat(np.arange(E), lens)
    pos = np.arange(n, dtype=np.int64) - np.repeat(label_offsets[:-1], lens)
    nxt = np.zeros(n, np.uint32)
    nxt[:-1] = el[1:]
    has_next = pos < np.repeat(lens - 1, lens)
    spl = (el & 1) == 0
    merge = spl & has_next & ((el & ~np.uint32(1)) == (nxt & ~np.uint32(1)))
    consumed = np.zeros(n, bool)
    consumed[1:] = merge[:-1]  # gene ids are distinct in a label: no chains
    slot = np.where(
        merge, ambig_off + (el >> 1), np.where(spl, el >> 1, unspliced_off + (el >> 1)),
    ).astype(np.uint32)
    keep = ~consumed
    new_lens = np.zeros(E, np.int64)
    np.add.at(new_lens, eg[keep], 1)
    new_offsets = np.zeros(E + 1, np.int64)
    np.cumsum(new_lens, out=new_offsets[1:])
    return new_offsets, slot[keep]


# --- trivial resolution (pugutils.rs:852-911) ---------------------------------

def resolve_trivial(
    cell_of_read: np.ndarray,
    umi: np.ndarray,
    refs: np.ndarray,
    aln_offsets: np.ndarray,
    tid_to_gid: np.ndarray,
    n_cells: int,
    n_genes: int,
):
    """Drop reads whose alignments reach more than one gene, count
    distinct UMIs per (cell, gene) -> COO (rows, cols, counts f32) sorted
    by (cell, gene), and per cell the multimapping rate: the share of
    its distinct (transcript list, UMI) pairs that reach several genes."""
    n = len(aln_offsets) - 1
    num_aln = np.diff(aln_offsets)
    read_of_aln = np.repeat(np.arange(n, dtype=np.int64), num_aln)
    genes = tid_to_gid[refs].astype(np.uint32)

    first_gene = np.zeros(n, np.uint32)
    first_gene[read_of_aln[::-1]] = genes[::-1]  # the first alignment wins
    single = np.ones(n, bool)
    np.logical_and.at(single, read_of_aln, genes == first_gene[read_of_aln])

    # the transcript-level class is the verbatim transcript list: hash it
    h = np.full(n, np.uint64(1469598103934665603))
    h2 = np.full(n, np.uint64(14029467366897019727))
    P1 = np.uint64(1099511628211)
    P2 = np.uint64(0x100000001B3)
    r64 = refs.astype(np.uint64)
    pos_in_read = np.arange(len(refs), dtype=np.int64) - np.repeat(aln_offsets[:-1], num_aln)
    for p in range(int(num_aln.max()) if n else 0):
        sel = pos_in_read == p
        ridx = read_of_aln[sel]
        h[ridx] = (h[ridx] * P1) ^ r64[sel]
        h2[ridx] = (h2[ridx] * P2) ^ (r64[sel] + np.uint64(0x9E3779B9))
    h ^= num_aln.astype(np.uint64)

    order = np.lexsort((umi, h2, h, cell_of_read))
    c_s, h_s, h2_s, u_s = cell_of_read[order], h[order], h2[order], umi[order]
    new_umi = np.ones(n, bool)
    if n:
        new_umi[1:] = ((c_s[1:] != c_s[:-1]) | (h_s[1:] != h_s[:-1])
                       | (h2_s[1:] != h2_s[:-1]) | (u_s[1:] != u_s[:-1]))
    total_umis = np.zeros(n_cells, np.int64)
    multi_umis = np.zeros(n_cells, np.int64)
    np.add.at(total_umis, c_s[new_umi], 1)
    np.add.at(multi_umis, c_s[new_umi & ~single[order]], 1)
    mmrate = np.where(total_umis > 0, multi_umis / np.maximum(total_umis, 1), 0.0)

    cs, gs, us = cell_of_read[single], first_gene[single], umi[single]
    key_order = np.lexsort((us, gs, cs))
    cs, gs, us = cs[key_order], gs[key_order], us[key_order]
    uniq = np.ones(len(cs), bool)
    if len(cs):
        uniq[1:] = (cs[1:] != cs[:-1]) | (gs[1:] != gs[:-1]) | (us[1:] != us[:-1])
    ukey, cts = np.unique(cs[uniq] * np.int64(n_genes) + gs[uniq], return_counts=True)
    return ukey // n_genes, ukey % n_genes, cts.astype(np.float32), mmrate
