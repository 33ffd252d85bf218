"""Parsimonious UMI graph (PUG) resolution (port of
``alevin_fry_tpu/ops/pug.py``), the ``parsimony`` family of quant.

Per cell, nodes are (equivalence class, UMI) pairs; edges join UMIs
within Hamming distance 1 (or identical ones with ``--umi-edit-dist 0``)
that share a transcript, directed by their read counts (pugutils.rs:76-99).
The weakly connected components are covered greedily by the largest
monochromatic arborescences, each of which counts one molecule for the
gene set its labels share; a component larger than
``--large-graph-thresh`` falls back to the cr-like rule and flags the
cell (pugutils.rs:916-982, 1055-1072).

:func:`resolve_parsimony_cells` splits the work as the JAX package does
on an accelerator (``_resolve_parsimony_native`` :589-639): the native
codec builds every cell's graph on the host and exports it as CSR
(``csrc/radc.cpp::radc_pug_graph_build`` / ``_export``), the connected
components run on the device (kernel K7, ``ops/pug_device.py``; its twin
for the CPU), and the native cover finishes each cell from the component
labels (``radc_pug_cover``).  No cell's components leave the device, and
a failure raises.  Long-read
records (alignment probabilities) take the per-cell host path below,
copied from the JAX package as it is, with its own union-find.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..radz import _native
from .crlike import CellEqClasses
from .pug_device import cc_labels


def _hamming1_matrix(u1: np.ndarray, u2: np.ndarray) -> np.ndarray:
    """Pairwise 2-bit Hamming distances clipped to {0,1,2+} between two
    UMI vectors; returns an int8 matrix with values 0, 1 or 2."""
    x = u1[:, None] ^ u2[None, :]
    two = (x | (x >> np.uint64(1))) & np.uint64(0x5555555555555555)
    # popcount via bit tricks on u64
    v = two
    v = v - ((v >> np.uint64(1)) & np.uint64(0x5555555555555555))
    v = (v & np.uint64(0x3333333333333333)) + (
        (v >> np.uint64(2)) & np.uint64(0x3333333333333333)
    )
    v = (v + (v >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    pc = (v * np.uint64(0x0101010101010101)) >> np.uint64(56)
    return np.minimum(pc, 2).astype(np.int8)


class _DSU:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, x: int) -> int:
        p = self.p
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return x

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


def _build_cell_eqclasses(
    umis: np.ndarray, refs: np.ndarray, offs: np.ndarray,
    tid_to_gid: np.ndarray, gene_level: bool,
    aln_probs: np.ndarray | None = None,
):
    """Group a cell's reads into equivalence classes.

    Transcript-level identity is the verbatim refs list (the reference
    keys its eqid_map by the raw slice, eq_class.rs:859); gene-level
    identity is the sorted+deduped gene projection
    (eq_class.rs:723-775).  Returns (labels_per_eq, sorted_labels,
    umi_count_lists, prob_rows) where prob_rows (long-read payloads
    only) holds, per eqclass, per UMI rank, the flattened per-read
    alignment-probability rows (stride = label length; the reference's
    AttributeMap layout, eq_class.rs:350-420)."""
    n = len(offs) - 1
    key_to_eq: Dict[bytes, int] = {}
    eq_labels: List[np.ndarray] = []
    eq_sorted: List[np.ndarray] = []
    eq_umis: List[List[int]] = []
    eq_read_probs: List[List[Tuple[int, np.ndarray]]] = []
    with_probs = aln_probs is not None
    for i in range(n):
        r = refs[offs[i] : offs[i + 1]]
        if gene_level:
            lab = np.unique(tid_to_gid[r])
            key = lab.tobytes()
        else:
            lab = r
            key = r.tobytes()
        e = key_to_eq.get(key)
        if e is None:
            e = len(eq_labels)
            key_to_eq[key] = e
            eq_labels.append(lab.astype(np.uint32))
            eq_sorted.append(np.sort(lab.astype(np.uint32)))
            eq_umis.append([])
            eq_read_probs.append([])
        eq_umis[e].append(int(umis[i]))
        if with_probs:
            eq_read_probs[e].append((int(umis[i]), aln_probs[offs[i] : offs[i + 1]]))
    # collapse duplicate UMIs with counts, sorted by UMI
    eq_umi_arr: List[Tuple[np.ndarray, np.ndarray]] = []
    eq_probs: List[List[np.ndarray]] | None = [] if with_probs else None
    for e, lst in enumerate(eq_umis):
        u, c = np.unique(np.asarray(lst, np.uint64), return_counts=True)
        eq_umi_arr.append((u, c.astype(np.uint32)))
        if with_probs:
            # per umi rank: concatenate the prob rows of its reads
            rows_by_umi: Dict[int, List[np.ndarray]] = {}
            for uu, row in eq_read_probs[e]:
                rows_by_umi.setdefault(uu, []).append(row)
            eq_probs.append(
                [np.concatenate(rows_by_umi[int(uu)]) for uu in u]
            )
    return eq_labels, eq_sorted, eq_umi_arr, eq_probs


def _probs_for_eq_umi_tx(eq_probs, eqid: int, umi_rank: int, tx_index: int,
                         label_len: int) -> np.ndarray:
    """Column slice of the flat per-UMI probability rows — literally
    ``flat[tx_index::label_len]`` matching EqMap::probs_for_eq_umi_tx
    (eq_class.rs:1039-1059)."""
    flat = eq_probs[eqid][umi_rank]
    return flat[tx_index::label_len]


def _add_edges(adj, base_x, ux, cx, base_y, uy, cy, exact: bool, same_class: bool):
    """Add PUG edges between the UMI lists of two classes (or within one
    when same_class).  Direction rule per pugutils.rs:76-99."""
    h = _hamming1_matrix(ux, uy)
    if same_class:
        iu, ju = np.triu_indices(len(ux), k=1)
        pairs = zip(iu.tolist(), ju.tolist())
    else:
        ii, jj = np.nonzero(h <= (0 if exact else 1))
        pairs = zip(ii.tolist(), jj.tolist())
    for i, j in pairs:
        d = h[i, j]
        if exact:
            if d != 0:
                continue
            adj[base_x + i].append(base_y + j)
            adj[base_y + j].append(base_x + i)
            continue
        if d == 0:
            adj[base_x + i].append(base_y + j)
            adj[base_y + j].append(base_x + i)
        elif d == 1:
            fx, fy = int(cx[i]), int(cy[j])
            if fx > 2 * fy - 1:
                adj[base_x + i].append(base_y + j)
            elif fy > 2 * fx - 1:
                adj[base_y + j].append(base_x + i)
            else:
                adj[base_x + i].append(base_y + j)
                adj[base_y + j].append(base_x + i)


def _resolve_one_cell(
    umis: np.ndarray, refs: np.ndarray, offs: np.ndarray,
    tid_to_gid: np.ndarray,
    pug_exact_umi: bool, large_graph_thresh: int, gene_level: bool,
    aln_probs: np.ndarray | None = None,
) -> Tuple[Dict[bytes, list], bool]:
    """Returns ({sorted-gene-label-bytes: [label, count, prob_rows]},
    used_alt); prob_rows is a list of per-molecule probability rows
    (long-read payloads) or empty."""
    with_probs = aln_probs is not None
    eq_labels, eq_sorted, eq_umis, eq_probs = _build_cell_eqclasses(
        umis, refs, offs, tid_to_gid, gene_level, aln_probs
    )
    nec = len(eq_labels)
    node_base = np.zeros(nec + 1, np.int64)
    for e in range(nec):
        node_base[e + 1] = node_base[e] + len(eq_umis[e][0])
    nv = int(node_base[-1])
    adj: List[List[int]] = [[] for _ in range(nv)]

    # inverted index: transcript -> classes containing it
    ref_to_eqs: Dict[int, List[int]] = {}
    for e in range(nec):
        for t in eq_sorted[e]:
            ref_to_eqs.setdefault(int(t), []).append(e)

    for e in range(nec):
        ux, cx = eq_umis[e]
        _add_edges(adj, int(node_base[e]), ux, cx, int(node_base[e]), ux, cx,
                   pug_exact_umi, same_class=True)
        seen = set()
        for t in eq_sorted[e]:
            for e2 in ref_to_eqs[int(t)]:
                if e2 <= e or e2 in seen:
                    continue
                seen.add(e2)
                uy, cy = eq_umis[e2]
                _add_edges(adj, int(node_base[e]), ux, cx, int(node_base[e2]),
                           uy, cy, pug_exact_umi, same_class=False)

    # weakly connected components
    dsu = _DSU(nv)
    for a in range(nv):
        for b in adj[a]:
            dsu.union(a, b)
    comps: Dict[int, List[int]] = {}
    for vtx in range(nv):
        comps.setdefault(dsu.find(vtx), []).append(vtx)

    # node -> eqclass lookup
    node_eq = np.zeros(nv, np.int64)
    for e in range(nec):
        node_eq[node_base[e] : node_base[e + 1]] = e

    gene_eqc: Dict[bytes, list] = {}
    used_alt = False

    def _project(label_sorted: np.ndarray) -> np.ndarray:
        if gene_level:
            return label_sorted
        return np.unique(tid_to_gid[label_sorted])

    def bump(genes: np.ndarray, prob_row=None):
        kb = genes.tobytes()
        cur = gene_eqc.get(kb)
        if cur is None:
            cur = [genes, 0, []]
            gene_eqc[kb] = cur
        cur[1] += 1
        if prob_row is not None:
            cur[2].append(np.asarray(prob_row, np.float64))

    def _node_umi_rank(vtx: int) -> Tuple[int, int]:
        e = int(node_eq[vtx])
        return e, vtx - int(node_base[e])

    for comp in comps.values():
        if len(comp) == 1:
            tv = comp[0]
            e = int(node_eq[tv])
            tl = eq_sorted[e]
            genes = _project(tl)
            assert len(genes) > 0, "can't find representative gene(s) for a molecule"
            prob_row = None
            if with_probs:
                if len(tl) == 1:
                    prob_row = [1.0]
                else:
                    _, rank = _node_umi_rank(tv)
                    prob_row = []
                    for i in range(len(tl)):
                        col = _probs_for_eq_umi_tx(eq_probs, e, rank, i, len(tl))
                        prob_row.append(float(col.mean()) if len(col) else 0.0)
            bump(genes, prob_row)
            continue
        if len(comp) > large_graph_thresh:
            _large_component_crlike(
                comp, node_eq, node_base, eq_sorted, eq_umis, tid_to_gid,
                gene_level, gene_eqc,
            )
            used_alt = True
            continue
        uncovered = set(comp)
        while uncovered:
            num_remaining = len(uncovered)
            best_mcc: List[int] = []
            best_txp = -1
            best_prob = 0.0
            best_txp_probs: List[Tuple[int, float]] = []
            for v in sorted(uncovered):
                if with_probs:
                    cand_mcc, cand_txp, cand_prob, eq_txs_prob = (
                        _collapse_vertices_weighted(
                            v, uncovered, adj, node_eq, eq_sorted, eq_probs,
                            node_base,
                        )
                    )
                    if best_prob < cand_prob:
                        best_mcc = cand_mcc
                        best_prob = cand_prob
                        best_txp = cand_txp
                        best_txp_probs = eq_txs_prob
                else:
                    cand_mcc, cand_txp = _collapse_vertices(
                        v, uncovered, adj, node_eq, eq_sorted
                    )
                    if len(best_mcc) < len(cand_mcc):
                        best_mcc = cand_mcc
                        best_txp = cand_txp
                if len(cand_mcc) == num_remaining:
                    break
            assert best_txp != -1, "Could not find a covering transcript"
            # intersect labels over the mcc
            global_txps = set(int(t) for t in eq_sorted[node_eq[best_mcc[0]]])
            for vtx in best_mcc[1:]:
                lab = eq_sorted[node_eq[vtx]]
                global_txps.intersection_update(int(t) for t in lab)
            gt = np.asarray(sorted(global_txps), np.uint32)
            genes = _project(gt)
            assert len(genes) > 0, "can't find representative gene(s) for a molecule"
            prob_row = None
            if with_probs:
                # pugutils.rs:1191-1204: probs of intersection txps
                # sorted by txp id; a single txp collapses to [1.0]
                sel = sorted(
                    (t, p) for t, p in best_txp_probs if t in global_txps
                )
                prob_row = [1.0] if len(sel) == 1 else [p for _, p in sel]
            bump(genes, prob_row)
            for vtx in best_mcc:
                uncovered.discard(vtx)
    return gene_eqc, used_alt


def _collapse_vertices_weighted(v, uncovered, adj, node_eq, eq_sorted,
                                eq_probs, node_base):
    """Probability-weighted arborescence search
    (collapse_vertices_weighted, pugutils.rs:398-502): per candidate
    transcript, BFS as in the unweighted case while averaging the
    per-vertex alignment probabilities at the *starting vertex's*
    transcript index; the highest average probability wins."""
    e0 = int(node_eq[v])
    vlab = eq_sorted[e0]
    rank0 = v - int(node_base[e0])
    best: List[int] = []
    best_txp = -1
    best_prob = 0.0
    eq_txps_prob: List[Tuple[int, float]] = []
    for tx_index, txp in enumerate(vlab):
        t = int(txp)
        visited = {v}
        mcc = []
        probs = []
        col = _probs_for_eq_umi_tx(eq_probs, e0, rank0, tx_index, len(vlab))
        probs.append(float(col.mean()) if len(col) else 0.0)
        q = deque([v])
        while q:
            cv = q.popleft()
            mcc.append(cv)
            for nxt in adj[cv]:
                if nxt not in uncovered or nxt in visited:
                    continue
                visited.add(nxt)
                en = int(node_eq[nxt])
                lab = eq_sorted[en]
                j = np.searchsorted(lab, t)
                if j < len(lab) and lab[j] == t:
                    q.append(nxt)
                    rn = nxt - int(node_base[en])
                    col = _probs_for_eq_umi_tx(
                        eq_probs, en, rn, tx_index, len(lab)
                    )
                    probs.append(float(col.mean()) if len(col) else 0.0)
        avg = sum(probs) / len(probs)
        if best_prob < avg:
            best = mcc
            best_txp = t
            best_prob = avg
        eq_txps_prob.append((t, avg))
    return best, best_txp, best_prob, eq_txps_prob


def _collapse_vertices(v, uncovered, adj, node_eq, eq_sorted):
    """Largest monochromatic arborescence from v (pugutils.rs:308-391):
    for each transcript in v's label, BFS over outgoing edges restricted
    to uncovered vertices whose label contains that transcript; the
    first strictly-largest tree wins."""
    best: List[int] = []
    best_txp = -1
    vlab = eq_sorted[node_eq[v]]
    for txp in vlab:
        t = int(txp)
        visited = {v}
        mcc = []
        q = deque([v])
        while q:
            cv = q.popleft()
            mcc.append(cv)
            for nxt in adj[cv]:
                if nxt not in uncovered or nxt in visited:
                    continue
                visited.add(nxt)
                lab = eq_sorted[node_eq[nxt]]
                j = np.searchsorted(lab, t)
                if j < len(lab) and lab[j] == t:
                    q.append(nxt)
        if len(best) < len(mcc):
            best = mcc
            best_txp = t
    return best, best_txp


def _large_component_crlike(
    comp, node_eq, node_base, eq_sorted, eq_umis, tid_to_gid, gene_level,
    gene_eqc,
):
    """cr-like fallback within an oversized component
    (pugutils.rs:916-982): collect the component's (umi, freq) pairs per
    class, emit (umi, gene, count) triplets, winner-take-all."""
    trips: List[Tuple[int, int, int]] = []
    for vtx in comp:
        e = int(node_eq[vtx])
        rank = vtx - int(node_base[e])
        u = int(eq_umis[e][0][rank])
        c = int(eq_umis[e][1][rank])
        if gene_level:
            gset = eq_sorted[e]
        else:
            gset = np.unique(tid_to_gid[eq_sorted[e]])
        for g in gset:
            trips.append((u, int(g), c))
    trips.sort()
    # streaming winner-take-all identical to
    # resolve_num_molecules_crlike_from_vec (pugutils.rs:644-749)
    curr_umi, curr_gn, _ = trips[0]
    max_count = 0
    count_aggr = 0
    best: List[int] = []
    first = True

    def commit(genes: List[int]):
        arr = np.asarray(genes, np.uint32)
        kb = arr.tobytes()
        cur = gene_eqc.get(kb)
        if cur is None:
            cur = [arr, 0, []]
            gene_eqc[kb] = cur
        cur[1] += 1

    for idx, (u, g, c) in enumerate(trips):
        if first:
            curr_umi, curr_gn = u, g
            count_aggr = max_count = c
            best = [g]
            first = False
        elif u != curr_umi:
            commit(best)
            curr_umi, curr_gn = u, g
            best = [g]
            count_aggr = max_count = c
        else:
            if g == curr_gn:
                count_aggr += c
            else:
                count_aggr = c
                curr_gn = g
            if count_aggr > max_count:
                max_count = count_aggr
                if best != [g]:
                    best = [g]
            elif count_aggr == max_count:
                best.append(g)
        if idx == len(trips) - 1:
            commit(best)


def _resolve_parsimony_split(cell, umi, refs, offs, cells, tid_to_gid, pug_exact_umi,
                             large_graph_thresh, gene_level, device):
    """The native graph build, K7's components on ``device``, the native
    cover; returns :func:`resolve_parsimony_cells`' tuple."""
    boundaries = np.searchsorted(cell, cells, side="left")
    cell_read_offsets = np.append(boundaries, len(cell)).astype(np.int64)
    handle, n_nodes, deg, nbrs_flat = _native.pug_graph_build(
        cell_read_offsets, umi, refs, offs, tid_to_gid, gene_level, pug_exact_umi,
    )
    try:
        comp = cc_labels(n_nodes, deg, nbrs_flat, device)
        n_eqc, used_alt, counts, lens, labels = _native.pug_cover(
            handle, cell_read_offsets, offs, tid_to_gid, gene_level, large_graph_thresh, comp,
        )
    finally:
        _native.pug_free(handle)
    label_offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=label_offsets[1:])
    cell_eq_offsets = np.zeros(len(cells) + 1, np.int64)
    np.cumsum(n_eqc, out=cell_eq_offsets[1:])
    eqc = CellEqClasses(
        cell_ids=np.asarray(cells, np.int64),
        cell_eq_offsets=cell_eq_offsets,
        label_offsets=label_offsets,
        labels=labels,
        counts=counts.astype(np.uint32),
    )
    return eqc, [int(c) for c in np.asarray(cells)[used_alt]], None


def resolve_parsimony_cells(
    sub: dict,
    tid_to_gid: np.ndarray,
    pug_exact_umi: bool,
    large_graph_thresh: int,
    gene_level: bool,
    device: torch.device,
    aln_probs: np.ndarray | None = None,
) -> Tuple[CellEqClasses, List[int], List[List[np.ndarray]] | None]:
    """Resolve every cell in ``sub`` (cell / umi / refs / offs arrays of
    whole cells in collated order) by the PUG algorithm; returns the
    cells' gene-level equivalence classes, the cells that took the
    large-component fallback and, for long-read payloads, each class's
    probability rows.  A cell's classes are ordered by (label length,
    label bytes)."""
    cell = sub["cell"]
    umi = sub["umi"]
    refs = sub["refs"]
    offs = sub["offs"]
    cells = np.unique(cell)
    if aln_probs is None:
        return _resolve_parsimony_split(cell, umi, refs, offs, cells, tid_to_gid,
                                        pug_exact_umi, large_graph_thresh, gene_level, device)

    alt_cells: List[int] = []
    cell_ids = []
    cell_eq_counts = []
    labels_flat: List[np.ndarray] = []
    counts_flat: List[int] = []
    label_lens: List[int] = []
    probs_flat: List[List[np.ndarray]] = []

    # per-cell read ranges
    boundaries = np.searchsorted(cell, cells, side="left")
    boundaries = np.append(boundaries, len(cell))
    for k, ci in enumerate(cells):
        rs, re = boundaries[k], boundaries[k + 1]
        o = offs[rs : re + 1] - offs[rs]
        r = refs[offs[rs] : offs[re]]
        u = umi[rs:re]
        ap = aln_probs[offs[rs] : offs[re]]
        # A component is "large" when strictly greater than the
        # threshold (pugutils.rs:1055); the parsimony CLI default is 1000.
        gene_eqc, used_alt = _resolve_one_cell(
            u, r, o, tid_to_gid, pug_exact_umi, large_graph_thresh,
            gene_level, ap,
        )
        if used_alt:
            alt_cells.append(int(ci))
        # deterministic label order: sort by label bytes
        items = sorted(gene_eqc.items(), key=lambda kv: (len(kv[1][0]), kv[0]))
        cell_ids.append(int(ci))
        cell_eq_counts.append(len(items))
        for _, (lab, ct, pr) in items:
            labels_flat.append(lab)
            counts_flat.append(ct)
            label_lens.append(len(lab))
            probs_flat.append(pr)

    E = len(counts_flat)
    label_offsets = np.zeros(E + 1, np.int64)
    np.cumsum(np.asarray(label_lens, np.int64), out=label_offsets[1:])
    eqc = CellEqClasses(
        cell_ids=np.asarray(cell_ids, np.int64),
        cell_eq_offsets=np.concatenate(
            [[0], np.cumsum(np.asarray(cell_eq_counts, np.int64))]
        ),
        label_offsets=label_offsets,
        labels=(
            np.concatenate(labels_flat).astype(np.uint32)
            if labels_flat else np.zeros(0, np.uint32)
        ),
        counts=np.asarray(counts_flat, np.uint32),
    )
    return eqc, alt_cells, probs_flat
