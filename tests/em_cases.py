"""Inputs of the EM tests: batches of equivalence classes made from numpy
seeds, for tests/test_torch_em.py and tests/test_torch_parsimony.py (the
twin against the JAX package), tests/test_torch_cuda.py and chip_smoke.py
phase 2 (kernel K6 against its twin), with label weights for the
weighted (long-read) EM.  Imports nothing of either package."""

import numpy as np

# (cells, rows, most classes, longest label + 1, zero-length, wide cell,
# dense cell)
EM_CASES = {
    "small": (40, 12, 9, 4, False, 0, None),
    "zero-length": (40, 12, 9, 4, True, 0, None),
    # a cell whose alphas, abundances and inverses pass 227 KB: global memory
    "global-route": (20, 90_000, 30, 5, False, 30_000, None),
    "10k-cells": (10_000, 60_000, 200, 6, False, 0, None),
    # a cell whose state fits K6's shared memory but not beside its layout
    # (2,000 classes of 20 of its 2,000 ids: 40,000 labels), with and
    # without USA partners and weights: K6's route (b)
    "shared-route": (20, 30_000, 30, 5, False, 0, (2_000, 2_000, 20)),
}


def usa_offsets(n_rows: int):
    """The USA offsets quant gives the EM for ``n_rows`` rows."""
    return n_rows // 3, 2 * n_rows // 3


def em_batch(seed, n_cells=40, n_rows=12, max_classes=9, max_len=4, zero_len=False, wide=0,
             dense=None):
    """(cell_eq_offsets, label_offsets, labels, counts) of ``n_cells``
    random cells (1 to ``max_classes - 1`` classes of 1 to ``max_len - 1``
    ascending distinct ids below ``n_rows``, counts 1-19; with
    ``zero_len`` also cells with no class and classes with no label),
    then an all-singleton cell, a cell with no class, a cell that runs
    100 rounds, with ``wide`` a cell of ``wide`` two-id classes over
    ``2 * wide`` ids and, with ``dense`` = (classes, ids, length), a cell
    of that many classes of ``length`` distinct ids below ``ids``."""
    rng = np.random.RandomState(seed)
    lo_n = 0 if zero_len else 1
    n_cls = rng.randint(lo_n, max_classes, n_cells)
    E = int(n_cls.sum())
    lens = rng.randint(lo_n, max_len, E)
    ids = np.where(np.arange(max_len - 1) < lens[:, None],
                   rng.randint(0, n_rows, (E, max_len - 1)), n_rows)
    ids.sort(axis=1)
    keep = ids < n_rows
    keep[:, 1:] &= ids[:, 1:] != ids[:, :-1]
    lens = keep.sum(1)
    labels = [ids[keep]]
    counts = [rng.randint(1, 20, E)]
    fixed = [[([0], 3), ([2], 5), ([0], 2)], [], [([0, 1], 10_000), ([0], 2), ([1], 1)]]
    if wide:
        fixed.append([([2 * i, 2 * i + 1], int(rng.randint(1, 9))) for i in range(wide)])
    if dense:
        n_dense, n_ids, length = dense
        fixed.append([(np.sort(rng.choice(n_ids, length, replace=False)).tolist(),
                       int(rng.randint(1, 9))) for _ in range(n_dense)])
    for cell in fixed:
        labels.append(np.asarray([g for lab, _ in cell for g in lab], np.int64))
        counts.append(np.asarray([n for _, n in cell], np.int64))
        lens = np.concatenate([lens, [len(lab) for lab, _ in cell]]).astype(np.int64)
        n_cls = np.append(n_cls, len(cell))
    ceo = np.concatenate(([0], np.cumsum(n_cls))).astype(np.int64)
    lo = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
    return (ceo, lo, np.concatenate(labels).astype(np.uint32),
            np.concatenate(counts).astype(np.uint32))


def em_case(kind: str, seed: int = 3):
    """(batch, rows) of one of :data:`EM_CASES`."""
    n_cells, n_rows, max_classes, max_len, zero_len, wide, dense = EM_CASES[kind]
    return em_batch(seed, n_cells, n_rows, max_classes, max_len, zero_len, wide, dense), n_rows


def label_weights(n_labels: int, seed: int = 5) -> np.ndarray:
    """Random float32 weights of the weighted EM, one per label, one in
    ten of them 0."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n_labels) * (rng.rand(n_labels) > 0.1)).astype(np.float32)


# the longest class of a cell sets the order of the weighted EM's sums
# (NumPy's pairwise order changes at 8 and past 128 values)
LMAX_CELLS = (7, 8, 9, 16, 128, 129, 137, 300)


def weighted_case(seed: int = 4):
    """(batch, rows, weights): em_case's 10k-cells batch cut to 120
    cells, then one cell for each length of :data:`LMAX_CELLS`, its
    longest class beside 30 classes of 2-9 labels."""
    rng = np.random.RandomState(seed)
    (ceo, lo, labels, counts), n_rows = em_case("10k-cells")
    ceo = ceo[:121]
    lo, labels, counts = lo[:ceo[-1] + 1], labels[:lo[ceo[-1]]], counts[:ceo[-1]]
    for lmax in LMAX_CELLS:
        lens = np.append(rng.randint(2, 10, 30), lmax)
        labs = [np.sort(rng.choice(n_rows, k, replace=False)) for k in lens]
        labels = np.concatenate([labels, *labs]).astype(np.uint32)
        lo = np.concatenate([lo, lo[-1] + np.cumsum(lens)])
        counts = np.concatenate([counts, rng.randint(1, 20, len(lens))]).astype(np.uint32)
        ceo = np.append(ceo, ceo[-1] + len(lens))
    return (ceo, lo, labels, counts), n_rows, label_weights(len(labels), seed)


# the bootstraps' cells, (classes, longest class) each; a cell of at most
# 64, 256 or 1,024 classes falls on a rung whose longest class sets the
# width of its denominators' sums (4: left to right; 8 and more: NumPy's
# pairwise order), a larger one sums them in order
BOOT_CASES = {
    # the 64 rung at width 4 (4-label classes), the 256 rung at width 16,
    # the 1,024 rung at width 4, an all-singleton cell
    "rungs": (300, [(5, 4), (40, 4), (64, 4), (65, 9), (200, 9), (300, 4), (20, 1)]),
    # a cell past the ladder beside a rung cell whose classes reach 20 labels
    "past-ladder": (300, [(3, 2), (1100, 5), (600, 20)]),
    # cells past the shared-memory limit: one past the ladder (30,000
    # classes of 1-2 ids), one on the 1,024 rung at width 128 (1,000
    # classes of 1-70 ids, some 35,000 ids)
    "global-route": (90_000, [(30_000, 2), (1000, 70), (10, 3)]),
    # a cell whose replicate state fits K6's shared memory but not beside
    # its layout (600 classes of 1-70 of 6,000 ids): K6's route (b)
    "shared-route": (6_000, [(600, 70), (5, 3)]),
}


def boot_case(kind: str, seed: int = 3):
    """(batch, rows) of one of :data:`BOOT_CASES`: each cell's classes
    have 1 to its longest number of distinct ids (one class of exactly
    that many), counts 1-5; the global-route cells draw their ids from
    disjoint ranges, so the cell has as many distinct ids as labels."""
    n_rows, cells = BOOT_CASES[kind]
    rng = np.random.RandomState(seed)
    lens, labels, counts = [], [], []
    for n_cls, longest in cells:
        k = rng.randint(1, longest + 1, n_cls)
        k[0] = longest
        if kind == "global-route" and n_cls * longest > 5_000:
            base = np.cumsum(np.concatenate(([0], k[:-1])))
            labels += [b + np.arange(m) for b, m in zip(base, k)]
        else:
            labels += [np.sort(rng.choice(n_rows, m, replace=False)) for m in k]
        lens.append(k)
        counts.append(rng.randint(1, 6, n_cls))
    ceo = np.concatenate(([0], np.cumsum([n for n, _ in cells]))).astype(np.int64)
    lo = np.concatenate(([0], np.cumsum(np.concatenate(lens)))).astype(np.int64)
    return (ceo, lo, np.concatenate(labels).astype(np.uint32),
            np.concatenate(counts).astype(np.uint32)), n_rows
