"""Bootstrap replicates of the per-cell EM (port of
``alevin_fry_tpu/ops/bootstrap.py``).

Mirrors run_bootstrap (em.rs:427-568): per cell, the class counts are
resampled from a multinomial with the observed counts as weights (as
many draws as the cell has counts), the EM runs again from a random
init, and the replicates' mean and variance per (cell, gene) are what
quant writes (``alevin/bootstraps_mean.mtx``, ``bootstraps_var.mtx``).

The numbers are those of the reference's host path, bit for bit:

* the multinomial draws are host NumPy, from one generator per cell
  seeded from the cell's number in the collated file (:func:`resample`,
  the determinism contract, bootstrap.py:40-44);
* each (cell, replicate) row starts from its own legacy NumPy stream,
  ``RandomState(seed_i).random_sample`` plus 1e-5 at the cell's ids
  (bootstrap.py:237-241), drawn on the card by kernel K8
  (``ops/mtrand.py``);
* the replicate EMs run on the card in K6's bootstrap mode
  (``ops/em.py``) over one layout of the cells (``plan_cells``), with
  the order of sums of the route the reference gives each cell: a cell
  of at most 1,024 classes falls on a rung of ``EP_LADDER`` and sums
  its class denominators as NumPy does over rows padded to its rung's
  ``Lp`` (``em_batch_np``); a larger cell sums them in order
  (``em_optimize_cell_np``, bootstrap.py:300-340);
* the mean and the variance are float64 on the card, each replicate
  added in turn, ``mean = f32(s / N)`` and ``var = f32(q / N - m * m)``;
  only the nonzero triplets come back to the host.

The JAX package's device path drew its init from threefry on the chip
and its host path from NumPy (docs/parity.md, divergence 4); the port
follows the host path and keeps no backend switch: every row runs on
the card (or, for tensors on the CPU, on the kernels' twins).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import mtrand
from .crlike import CellEqClasses
from .em import plan_cells, em_run

SEED = 271828
# class-count rungs of the reference's padded EM; larger cells took its
# per-cell route
EP_LADDER = (64, 256, 1024)
# the most values, replicates x (labels + classes), one batch of whole
# cells keeps on the device
BATCH_VALUES = 1 << 25


def _pad_pow2(x: int, lo: int = 1) -> int:
    return max(lo, 1 << (max(x, 1) - 1).bit_length())


def cell_widths(cell_eq_offsets: np.ndarray, label_offsets: np.ndarray) -> np.ndarray:
    """Each cell's denominator width: ``Lp``, the longest class of all
    the cells on its rung padded to a power of two of at least 2, or 0 for
    a cell past the ladder.  Every cell has a class."""
    ne = np.diff(cell_eq_offsets)
    lens = np.diff(label_offsets)
    longest = np.maximum.reduceat(lens, cell_eq_offsets[:-1]) if len(ne) else ne
    rung = np.searchsorted(EP_LADDER, ne)
    width = np.zeros(len(ne), np.int32)
    for i in range(len(EP_LADDER)):
        on = rung == i
        if on.any():
            width[on] = _pad_pow2(int(longest[on].max()), 2)
    return width


def init_seeds(seed: int, global_cells: np.ndarray, n: int) -> np.ndarray:
    """(n, C) int64: the 32-bit seed of each (replicate, cell) row's init
    stream (bootstrap.py:47-52, :166-175)."""
    u64 = np.uint64
    s = (u64(seed ^ 0x51ED2700)
         + u64(0x9E3779B9) * (np.asarray(global_cells).astype(u64)[None, :] + u64(1))
         + u64(7919) * (np.arange(n, dtype=u64)[:, None] + u64(1)))
    return (s & u64(0xFFFFFFFF)).astype(np.int64)


def resample(counts: np.ndarray, cell_eq_offsets: np.ndarray, global_cells: np.ndarray,
             n: int, seed: int = SEED) -> np.ndarray:
    """(n, E) float32: each cell's class counts redrawn n times from the
    multinomial of its observed counts, by the cell's own generator."""
    out = np.empty((n, len(counts)), np.float32)
    for k, gc in enumerate(global_cells):
        s, e = int(cell_eq_offsets[k]), int(cell_eq_offsets[k + 1])
        cts = counts[s:e].astype(np.int64)
        total = int(cts.sum())
        if total <= 0:
            raise AssertionError("Cannot bootstrap from a sample with 0 counts.")
        rng = np.random.RandomState((seed + 0x9E3779B9 * (int(gc) + 1)) & 0xFFFFFFFF)
        out[:, s:e] = rng.multinomial(total, cts / total, size=n)
    return out


def _batches(cell_eq_offsets: np.ndarray, label_offsets: np.ndarray, n: int) -> List[tuple]:
    """Ranges of whole cells, each holding at most BATCH_VALUES values of
    n replicates (one cell at least)."""
    size = n * (label_offsets[cell_eq_offsets] + cell_eq_offsets)
    out, a = [], 0
    C = len(cell_eq_offsets) - 1
    while a < C:
        b = max(a + 1, int(np.searchsorted(size, size[a] + BATCH_VALUES, side="right")) - 1)
        b = min(b, C)
        out.append((a, b))
        a = b
    return out


def _summarize(alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 mean and variance over the replicate rows of ``alpha``
    (N, U), in float64, each replicate added in turn."""
    s = torch.zeros(alpha.shape[1], dtype=torch.float64, device=alpha.device)
    q = torch.zeros_like(s)
    for r in range(alpha.shape[0]):
        x = alpha[r].double()
        s += x
        q += x * x
    # a tensor divisor: a host scalar would be taken as its reciprocal
    n = torch.tensor(float(alpha.shape[0]), dtype=torch.float64, device=alpha.device)
    mean = s / n
    return mean.float(), (q / n - mean * mean).float()


def _nonzero(vals: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    idx = torch.nonzero(vals != 0).flatten()
    return idx.cpu().numpy(), vals[idx].cpu().numpy()


def _coo_sorted(rows: list, cols: list, vals: list) -> tuple:
    """The triplets sorted by (row, column); the batches' come in that
    order when the cells do, and are then left as they are."""
    if not rows:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32)
    r, c, v = np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
    if not ((r[1:] > r[:-1]) | ((r[1:] == r[:-1]) & (c[1:] > c[:-1]))).all():
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
    return r, c, v.astype(np.float32)


def replicate_plan(cell_eq_offsets: np.ndarray, label_offsets: np.ndarray, labels: np.ndarray,
                   num_rows: int, width: np.ndarray, counts: np.ndarray, seeds: np.ndarray,
                   device: torch.device) -> tuple:
    """A batch of cells as K6's bootstrap mode takes it: (its layout, the
    tensors on ``device``) with each cell's width, the (N, E) resampled
    ``counts`` and the (N, U) init that K8 draws from the (N, C) ``seeds``.
    The batch starts at class 0 and label 0."""
    plan = plan_cells(cell_eq_offsets, label_offsets, labels, counts[0], num_rows, None, False,
                      True)
    plan.cell_lp = np.ascontiguousarray(width, np.int32)
    t = plan.to(device)
    ids = torch.from_numpy(plan.dict_id.astype(np.int32)).to(device)
    t.boot_init = mtrand.random_init(torch.from_numpy(np.ascontiguousarray(seeds)).to(device),
                                     t.dict_off, ids)
    t.boot_counts = torch.from_numpy(np.ascontiguousarray(counts, np.float32)).to(device)
    return plan, t


def run_bootstraps(eqc: CellEqClasses, label_offsets: np.ndarray, labels: np.ndarray,
                   num_rows: int, num_bootstraps: int, device: torch.device,
                   cell_offset: int = 0, seed: int = SEED) -> Tuple[tuple, tuple]:
    """((rows, cols, mean), (rows, cols, var)) COO triplets over
    (``eqc.cell_ids``, id), sorted, zeros dropped, of ``num_bootstraps``
    replicates of every cell with a class.  ``label_offsets`` and
    ``labels`` are the classes' (non-USA) labels; ``cell_offset`` is the
    block's first cell number in the file, so a cell's generators do not
    depend on how quant blocks the file."""
    n = int(num_bootstraps)
    ceo_all = np.asarray(eqc.cell_eq_offsets, np.int64)
    has = np.flatnonzero(np.diff(ceo_all) > 0)
    if not len(has) or n <= 0:
        return _coo_sorted([], [], []), _coo_sorted([], [], [])
    # the cells with a class, whose class ranges follow each other
    ceo = np.append(ceo_all[has], ceo_all[-1])
    lo = np.asarray(label_offsets, np.int64)
    cell_ids = np.asarray(eqc.cell_ids, np.int64)[has]
    width = cell_widths(ceo, lo)
    all_counts = np.asarray(eqc.counts)
    out_m, out_v = ([], [], []), ([], [], [])
    for a, b in _batches(ceo, lo, n):
        c0, c1 = int(ceo[a]), int(ceo[b])
        l0, l1 = int(lo[c0]), int(lo[c1])
        ceo_b, cells = ceo[a:b + 1] - c0, cell_ids[a:b] + cell_offset
        plan, t = replicate_plan(ceo_b, lo[c0:c1 + 1] - l0, labels[l0:l1], num_rows, width[a:b],
                                 resample(all_counts[c0:c1], ceo_b, cells, n, seed),
                                 init_seeds(seed, cells, n), device)
        mean, var = _summarize(em_run(t)[0])
        entry_cell = np.repeat(cell_ids[a:b], np.diff(plan.dict_off))
        for vals, out in ((mean, out_m), (var, out_v)):
            idx, v = _nonzero(vals)
            out[0].append(entry_cell[idx])
            out[1].append(plan.dict_id[idx])
            out[2].append(v)
    return _coo_sorted(*out_m), _coo_sorted(*out_v)
