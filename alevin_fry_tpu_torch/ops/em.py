"""Per-cell equivalence-class EM on kernel K6 (port of
``alevin_fry_tpu/ops/em.py``).

Semantics are those of ``em_optimize_cell_np`` (:54) and of the native
host EM ``radc_em_cells`` (``csrc/radc.cpp:2551-2680``), which src/em.rs
defines: informative init ``(seed + 0.5) * 1e-3`` from the single-label
counts (or ``1/R``), rounds of E and M steps, at least 2 and at most
100, convergence when no id has a new value over 1e-2 that moved by
more than 1e-2, optionally one more round after thresholding at 0.01
(``with_last_round``, em.rs:178-299), and a final floor at 0.01.  In USA
mode an id's abundance adds its spliced / unspliced / ambiguous partners
(em.rs:94-114).

The JAX package ran this as an XLA program over cells padded to a shape
ladder (``_get_em_kernel`` :276, ``_get_em_kernel_compact`` :446), with
cells of more than 1,024 classes sent to NumPy.  Here every cell runs on
the card in K6 (``csrc/em.cu``): one CUDA block per cell runs the whole
round loop over the cell's own dictionary of ids, so there is no host
round trip, no padding and no host routing.  The host lays a batch out
once (:func:`plan_cells`):

* each cell's dictionary: the ids its labels touch and, in USA mode,
  their partners, ascending; labels become local ids into it, and each
  touched id keeps the local ids of its partners;
* each local id's occurrence list, the transpose of the labels: first
  its single-label classes, then its (multi-label class, position)
  pairs, in class order.  Summing an id's list in order adds its new
  value in the order the host EM adds it, so K6 and its twin give the
  host's floats bit for bit, with no atomics.

The long-read EM (``em_optimize_weighted_cell_np`` :157, the host path
the JAX package takes for it) gives each label a weight: the plan then
carries the weights in label order and in occurrence order, K6 and the
twin take each class's denominator over ``alpha * w`` in NumPy's
pairwise order at the cell's longest class, and each occurrence adds
``(alpha * w) * scale``; :func:`class_weights_from_prob_rows` makes the
weights from the parsimony path's probability rows.

The bootstrap mode runs the replicate EMs of the reference's host
bootstraps (``ops/bootstrap.py``): one plan serves every replicate, and
each (cell, replicate) row brings its resampled counts and its random
init (:class:`EmTensors`' ``boot_counts`` and ``boot_init``).  Every row
runs its rounds from that init with the last round, and each cell's
``cell_lp`` chooses its denominators: NumPy's pairwise order over rows
padded to its rung's width with ``count / max(denom, 1e-30)``
(``em_batch_np`` :831), or, at 0, sequential sums with ``count / denom``
(``em_optimize_cell_np`` :54).

:func:`em_run` launches K6 for tensors on a CUDA device and takes the
plain PyTorch twin :func:`em_run_twin` for tensors on the CPU.  The twin
keeps the same order of additions: it sums the ragged occurrence lists
column by column.  :func:`launch_plan` chooses each cell's route from
its bytes before the launch: (a) its layout and state in shared memory,
in the bootstrap mode with a tile of up to 32 replicates a block; (b)
its state alone there; (c) its state in global scratch.  ``LAUNCHES``
counts K6's launches (``K6-boot`` those of its bootstrap mode);
``STATS`` counts what :func:`em_cells` laid out (cells, classes, labels,
dictionary sizes), the (cell, replicate) rows on each route and those
whose block ran more than one replicate; the rounds stay on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _kernels, spans
from ..radz import _native
from ..radz.constants import (
    ALPHA_CHECK_CUTOFF, EM_MAX_ITER, EM_MIN_ITER, EM_REL_DIFF_TOLERANCE, MIN_OUTPUT_ALPHA,
)

LAUNCHES = {"K6": 0, "K6-boot": 0}
STATS = {"calls": 0, "cells": 0, "classes": 0, "labels": 0, "max_u": 0, "max_e": 0,
         "staged_cells": 0, "shared_cells": 0, "global_cells": 0, "tiled_rows": 0}

_F32 = torch.float32


@dataclass
class EmPlan:
    """A batch of cells laid out for K6 (C cells, E classes, L labels,
    U dictionary entries over all cells, N = L occurrences).  Class and
    label offsets are the caller's; dictionary and occurrence offsets
    are flat over the batch; local ids and class indices count from each
    cell's first."""

    cell_cls: np.ndarray   # (C+1,) int64: classes of cell c
    lab_off: np.ndarray    # (E+1,) int64: labels of class e
    lab_loc: np.ndarray    # (L,) int32: each label's local id
    countf: np.ndarray     # (E,) float32: class counts
    dict_off: np.ndarray   # (C+1,) int64: dictionary of cell c
    p1: np.ndarray         # (U,) int32: a touched id's first partner (USA), else -1
    p2: np.ndarray         # (U,) int32: an ambiguous id's second partner, else -1
    occ_off: np.ndarray    # (U+1,) int64: occurrence list of each entry
    occ: np.ndarray        # (N,) int32: ~e for single-label class e, e for a multi-label one
    lab_w: Optional[np.ndarray]  # (L,) float32 label weights (weighted EM), else None
    occ_w: Optional[np.ndarray]  # (N,) float32 the same weights in occurrence order
    init_value: float      # the uniform init 1/R, or 0 for the informative init
    with_last_round: bool
    dict_id: np.ndarray    # (U,) int64: each entry's global id (host side only)
    # the bootstrap mode: (C,) int32 row-sum width of each cell, 0: sequential
    cell_lp: Optional[np.ndarray] = None

    def to(self, device) -> "EmTensors":
        arrays = {f.name: None if getattr(self, f.name) is None else
                  torch.from_numpy(np.ascontiguousarray(getattr(self, f.name))).to(device)
                  for f in fields(EmTensors) if f.name in _PLAN_ARRAYS}
        sizes = np.stack([np.diff(self.cell_cls), np.diff(self.lab_off[self.cell_cls]),
                          np.diff(self.dict_off)])
        return EmTensors(**arrays, init_value=self.init_value,
                         with_last_round=self.with_last_round, sizes=sizes,
                         usa=bool((self.p1 >= 0).any()))

    def cells(self, a: int, b: int) -> "EmPlan":
        """Cells [a, b) as a batch of their own: the offsets start at 0;
        local ids, partners and class indices count from each cell's
        first, so they stay as they are."""
        e0, e1 = self.cell_cls[a], self.cell_cls[b]
        l0, l1 = self.lab_off[e0], self.lab_off[e1]
        u0, u1 = self.dict_off[a], self.dict_off[b]
        o0, o1 = self.occ_off[u0], self.occ_off[u1]
        return EmPlan(
            cell_cls=self.cell_cls[a:b + 1] - e0, lab_off=self.lab_off[e0:e1 + 1] - l0,
            lab_loc=self.lab_loc[l0:l1], countf=self.countf[e0:e1],
            dict_off=self.dict_off[a:b + 1] - u0, p1=self.p1[u0:u1], p2=self.p2[u0:u1],
            occ_off=self.occ_off[u0:u1 + 1] - o0, occ=self.occ[o0:o1],
            lab_w=None if self.lab_w is None else self.lab_w[l0:l1],
            occ_w=None if self.occ_w is None else self.occ_w[o0:o1],
            init_value=self.init_value, with_last_round=self.with_last_round,
            dict_id=self.dict_id[u0:u1],
            cell_lp=None if self.cell_lp is None else self.cell_lp[a:b],
        )


@dataclass
class EmTensors:
    """:class:`EmPlan`'s arrays as tensors on one device."""

    cell_cls: torch.Tensor
    lab_off: torch.Tensor
    lab_loc: torch.Tensor
    countf: torch.Tensor
    dict_off: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    occ_off: torch.Tensor
    occ: torch.Tensor
    lab_w: Optional[torch.Tensor]
    occ_w: Optional[torch.Tensor]
    init_value: float
    with_last_round: bool
    # on the host, for K6's launch plan: each cell's classes, labels and
    # dictionary entries (3, C), and whether some entry has a USA partner
    sizes: Optional[np.ndarray] = None
    usa: bool = False
    # the bootstrap mode: each cell's row-sum width, and per replicate
    # (N, E) resampled counts and (N, U) initial values
    cell_lp: Optional[torch.Tensor] = None
    boot_counts: Optional[torch.Tensor] = None
    boot_init: Optional[torch.Tensor] = None


_PLAN_ARRAYS = ("cell_cls", "lab_off", "lab_loc", "countf", "dict_off", "p1", "p2", "occ_off",
                "occ", "lab_w", "occ_w", "cell_lp")


def _sort_segments(keys: np.ndarray, seg_off: np.ndarray) -> np.ndarray:
    """``keys`` (uint64) sorted within each segment of ``seg_off``."""
    return _native.sort_u64_segments(keys, seg_off)


def _partners(ids: np.ndarray, uoff: int, aoff: int) -> Tuple[np.ndarray, np.ndarray]:
    """Global ids of each USA id's partners in the order its abundance
    adds them (em.rs:94-114): ambiguous (id - uoff, id - aoff), unspliced
    (id + uoff), spliced (id + aoff); -1 where there is no second."""
    amb = ids >= aoff
    uns = (ids >= uoff) & ~amb
    return (np.where(amb, ids - uoff, np.where(uns, ids + uoff, ids + aoff)),
            np.where(amb, ids - aoff, -1))


def plan_cells(
    cell_eq_offsets: np.ndarray,
    label_offsets: np.ndarray,
    labels: np.ndarray,
    counts: np.ndarray,
    num_rows: int,
    usa_offsets: Optional[Tuple[int, int]],
    init_uniform: bool,
    with_last_round: bool,
    weights: Optional[np.ndarray] = None,
) -> EmPlan:
    """Lay out every cell of a batch for K6 (module docstring).  The
    batch starts at class 0 and label 0.  ``weights`` (float32, one per
    label) asks for the weighted EM, which has no USA coupling and no
    last round."""
    ceo = np.ascontiguousarray(cell_eq_offsets, np.int64)
    lo = np.ascontiguousarray(label_offsets, np.int64)
    if ceo[0] != 0 or lo[0] != 0:
        raise ValueError("an EM batch starts at class 0 and label 0")
    if weights is not None and (usa_offsets is not None or with_last_round):
        raise ValueError("the weighted EM has no USA coupling and no last round")
    C = len(ceo) - 1
    lens = np.diff(lo)
    cls_cell = np.repeat(np.arange(C, dtype=np.int64), np.diff(ceo))
    cell_lab = lo[ceo]  # (C+1,) each cell's label range
    lab_cls = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    lab_cell = cls_cell[lab_cls]
    ids = np.asarray(labels).astype(np.int64)

    # dictionaries: (cell << 32 | id) keys sorted within each cell, unique
    if usa_offsets is not None:
        q1, q2 = _partners(ids, *usa_offsets)
        cand = np.stack([ids, q1, np.where(q2 >= 0, q2, ids)], 1).ravel()
        cand_cell, cand_off = np.repeat(lab_cell, 3), 3 * cell_lab
    else:
        cand, cand_cell, cand_off = ids, lab_cell, cell_lab
    ckey = _sort_segments((cand_cell.astype(np.uint64) << np.uint64(32)) | cand.astype(np.uint64),
                          cand_off)
    first = np.ones(len(ckey), bool)
    first[1:] = ckey[1:] != ckey[:-1]
    dkey = ckey[first].view(np.int64)
    dict_cell = dkey >> 32
    dict_off = np.zeros(C + 1, np.int64)
    np.cumsum(np.bincount(dict_cell, minlength=C), out=dict_off[1:])

    def local(cell, gid):
        return np.searchsorted(dkey, (cell << 32) | gid)

    lab_g = local(lab_cell, ids)  # each label's flat dictionary index
    lab_loc = (lab_g - dict_off[lab_cell]).astype(np.int32)
    U = len(dkey)
    p1 = np.full(U, -1, np.int32)
    p2 = np.full(U, -1, np.int32)
    if usa_offsets is not None:
        touched = np.zeros(U, bool)
        touched[lab_g] = True
        t = np.flatnonzero(touched)
        tc, tid = dict_cell[t], dkey[t] & 0xFFFFFFFF
        q1, q2 = _partners(tid, *usa_offsets)
        p1[t] = local(tc, q1) - dict_off[tc]
        amb = q2 >= 0
        p2[t[amb]] = local(tc[amb], q2[amb]) - dict_off[tc[amb]]

    # occurrence lists: per cell, labels sorted by (local id, multi, position)
    pos = np.arange(len(ids), dtype=np.int64) - cell_lab[lab_cell]
    multi = (lens > 1)[lab_cls]
    okey = _sort_segments(
        (lab_loc.astype(np.uint64) << np.uint64(33)) | (multi.astype(np.uint64) << np.uint64(32))
        | pos.astype(np.uint64), cell_lab,
    )
    o_lab = cell_lab[lab_cell] + (okey & np.uint64(0xFFFFFFFF)).astype(np.int64)
    o_cls = lab_cls[o_lab] - ceo[lab_cell]
    occ = np.where(multi[o_lab], o_cls, ~o_cls).astype(np.int32)
    occ_off = np.zeros(U + 1, np.int64)
    np.cumsum(np.bincount(lab_g, minlength=U), out=occ_off[1:])
    lab_w = None if weights is None else np.ascontiguousarray(weights, np.float32)
    return EmPlan(
        cell_cls=ceo, lab_off=lo, lab_loc=lab_loc,
        countf=np.asarray(counts).astype(np.float32), dict_off=dict_off, p1=p1, p2=p2,
        occ_off=occ_off, occ=occ, lab_w=lab_w, occ_w=None if lab_w is None else lab_w[o_lab],
        init_value=float(np.float32(1.0) / np.float32(num_rows)) if init_uniform else 0.0,
        with_last_round=with_last_round, dict_id=dkey & 0xFFFFFFFF,
    )


# --- the plain twin ------------------------------------------------------------

def _columns(pos: torch.Tensor, *cols: torch.Tensor) -> list:
    """Entries grouped by ``pos`` (0, 1, ...), each group in entry order:
    one tuple of ``cols`` per position."""
    if not len(pos):
        return []
    order = torch.argsort(pos, stable=True)
    splits = torch.bincount(pos).tolist()
    return list(zip(*(c[order].split(splits) for c in cols)))


def _ragged_pos(off: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(segment, position within segment) of each entry of CSR ``off``."""
    n = off[1:] - off[:-1]
    seg = torch.repeat_interleave(torch.arange(len(n), device=off.device), n)
    return seg, torch.arange(int(off[-1]), device=off.device) - off[:-1][seg]


def np_row_sums(x: torch.Tensor) -> torch.Tensor:
    """Each row of the float32 matrix ``x`` summed in NumPy's order
    (``x.sum(axis=1)`` on a C-contiguous array: its pairwise sum from the
    identity 0): under 8 columns left to right; up to 128, eight strided
    partial sums combined as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then
    the tail column by column; past 128, the halves split at n/2 rounded
    down to a multiple of 8, each summed the same way."""
    n = x.shape[1]
    if n < 8:
        r = torch.zeros(len(x), dtype=x.dtype, device=x.device)
        for i in range(n):
            r = r + x[:, i]
        return r
    if n <= 128:
        body = n - n % 8
        r = x[:, :8].clone()
        for i in range(8, body, 8):
            r = r + x[:, i:i + 8]
        res = (((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3]))
               + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7])))
        for i in range(body, n):
            res = res + x[:, i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return np_row_sums(x[:, :n2]) + np_row_sums(x[:, n2:])


def _row_groups(t: EmTensors, width: torch.Tensor, lab_cls: torch.Tensor,
                lab_pos: torch.Tensor, lab_g: torch.Tensor, lens: torch.Tensor) -> list:
    """The multi-label classes whose denominator NumPy sums over a row
    padded to ``width`` (one per class; 0: a sequential sum): per
    distinct width, (class indices, (M, width) dictionary indices and
    weights, the label's weight or 1, zero past each class's labels)."""
    dev = t.occ.device
    multi = (lens > 1) & (width > 0)
    rows = []
    for wd in torch.unique(width[multi]).tolist():
        cls = torch.nonzero(multi & (width == wd)).flatten()
        slot = torch.full((len(lens),), -1, dtype=torch.int64, device=dev)
        slot[cls] = torch.arange(len(cls), device=dev)
        sel = slot[lab_cls] >= 0
        g = torch.zeros((len(cls), wd), dtype=torch.int64, device=dev)
        w = torch.zeros((len(cls), wd), dtype=_F32, device=dev)
        g[slot[lab_cls[sel]], lab_pos[sel]] = lab_g[sel]
        w[slot[lab_cls[sel]], lab_pos[sel]] = 1.0 if t.lab_w is None else t.lab_w[sel]
        rows.append((cls, g, w))
    return rows


def _tile(off: torch.Tensor, n: int) -> torch.Tensor:
    """CSR offsets ``off`` repeated ``n`` times end to end."""
    step = off[-1:]
    body = off[:-1][None, :] + step * torch.arange(n, device=off.device)[:, None]
    return torch.cat([body.reshape(-1), n * step])


def _replicated(t: EmTensors) -> EmTensors:
    """A bootstrap batch as N copies of its cells, copy r with replicate
    r's counts (the twin's layout of the (cell, replicate) rows)."""
    n = t.boot_counts.shape[0]
    rep = lambda x: x.repeat(n)  # noqa: E731
    return EmTensors(
        cell_cls=_tile(t.cell_cls, n), lab_off=_tile(t.lab_off, n), lab_loc=rep(t.lab_loc),
        countf=t.boot_counts.reshape(-1), dict_off=_tile(t.dict_off, n), p1=rep(t.p1),
        p2=rep(t.p2), occ_off=_tile(t.occ_off, n), occ=rep(t.occ), lab_w=None, occ_w=None,
        init_value=t.init_value, with_last_round=t.with_last_round, cell_lp=rep(t.cell_lp),
    )


def em_run_twin(t: EmTensors) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's plain PyTorch version: every cell's EM, batched, with the
    per-cell round state of ``em_batch_np`` (em.py:831-914) and each sum
    taken in the host's order (the weighted EM's: that of
    ``em_optimize_weighted_cell_np``; the bootstrap rows': that of their
    route).  Returns (final values per dictionary entry, float32; rounds
    per cell, int32), each (N, U) and (N, C) in the bootstrap mode."""
    if t.boot_counts is not None:
        n = t.boot_counts.shape[0]
        alpha, rounds = _twin(_replicated(t), t.boot_init.reshape(-1))
        return alpha.view(n, -1), rounds.view(n, -1)
    return _twin(t, None)


def _twin(t: EmTensors, init: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`em_run_twin` of a plain, weighted or replicated bootstrap
    batch; ``init`` (one value per dictionary entry) starts every cell's
    rounds from it."""
    dev = t.occ.device
    C, U = len(t.dict_off) - 1, len(t.occ_off) - 1
    f32 = lambda x: torch.tensor(x, dtype=_F32, device=dev)  # noqa: E731
    zero = f32(0.0)
    id_cell = torch.repeat_interleave(torch.arange(C, device=dev), t.dict_off[1:] - t.dict_off[:-1])
    lab_cls, lab_pos = _ragged_pos(t.lab_off)
    cls_cell, _ = _ragged_pos(t.cell_cls)
    lab_g = t.dict_off[cls_cell[lab_cls]] + t.lab_loc.long()
    lens = t.lab_off[1:] - t.lab_off[:-1]
    multi = lens > 1
    needs = torch.zeros(C, dtype=torch.bool, device=dev)
    needs[cls_cell[multi]] = True
    weighted = t.lab_w is not None
    if weighted:
        # the weighted EM pads every class to its cell's longest
        lmax = torch.zeros(C, dtype=torch.int64, device=dev)
        lmax.scatter_reduce_(0, cls_cell[multi], lens[multi], reduce="amax")
        width = lmax[cls_cell]
    elif t.cell_lp is not None:
        width = t.cell_lp.long()[cls_cell]
    else:
        width = torch.zeros_like(lens)
    groups = _row_groups(t, width, lab_cls, lab_pos, lab_g, lens)
    seq = (multi & (width == 0))[lab_cls]
    den_cols = _columns(lab_pos[seq], lab_cls[seq], lab_g[seq])
    occ_id, occ_pos = _ragged_pos(t.occ_off)
    occ = t.occ.long()
    single = occ < 0
    occ_cls = torch.where(single, ~occ, occ) + t.cell_cls[id_cell[occ_id]]
    occ_w = t.occ_w if weighted else torch.ones(len(occ), dtype=_F32, device=dev)
    occ_cols = _columns(occ_pos, occ_id, occ_cls, single, occ_w)
    usa = bool((t.p1 >= 0).any())
    g1 = t.dict_off[id_cell] + t.p1.long()
    g2 = t.dict_off[id_cell] + t.p2.long()
    has1, has2 = t.p1 >= 0, t.p2 >= 0

    def m_step(ab, inv):
        o = torch.zeros(U, dtype=_F32, device=dev)
        for ids, cls, sgl, w in occ_cols:
            m = ab[ids] * w if weighted else ab[ids]
            o[ids] = o[ids] + torch.where(sgl, t.countf[cls], m * inv[cls])
        return o

    if init is not None:
        # the bootstrap rows: every cell runs its rounds from its init
        needs[:] = True
        alpha = init.clone()
    else:
        seed = m_step(torch.zeros(U, dtype=_F32, device=dev),
                      torch.zeros(len(t.countf), dtype=_F32, device=dev))
        if t.init_value:
            start = torch.full_like(seed, t.init_value)
        else:
            start = (seed + f32(0.5)) * f32(1e-3)
        alpha = torch.where(needs[id_cell], start, seed)
    active, last = needs.clone(), torch.zeros_like(needs)
    rounds = torch.zeros(C, dtype=torch.int32, device=dev)
    it = 0
    while bool(active.any()):
        if usa:
            a1 = alpha[torch.where(has1, g1, 0)]
            a2 = alpha[torch.where(has2, g2, 0)]
            ab = torch.where(has1, torch.where(has2, (a1 + a2) + alpha, a1 + alpha), alpha)
        else:
            ab = alpha
        denom = torch.zeros(len(t.countf), dtype=_F32, device=dev)
        for cls, g, w in groups:
            denom[cls] = np_row_sums(ab[g] * w)
        for cls, g in den_cols:
            denom[cls] = denom[cls] + ab[g]
        # a padded row's sum divides at least by 1e-30 (em_batch_np)
        inv = torch.where(denom > zero,
                          t.countf / torch.where(width > 0, denom.clamp_min(1e-30), denom), zero)
        out = m_step(ab, inv)
        moved = (out > f32(ALPHA_CHECK_CUTOFF)) & ((alpha - out).abs() > f32(EM_REL_DIFF_TOLERANCE))
        not_conv = torch.zeros(C, dtype=torch.bool, device=dev)
        not_conv[id_cell[moved]] = True
        it += 1
        conv = ~not_conv
        if t.with_last_round:
            enter = active & ~last & conv & (it >= EM_MIN_ITER)
            stop = active & (last | (~enter & (it >= EM_MAX_ITER)))
            out = torch.where(enter[id_cell] & (out < f32(MIN_OUTPUT_ALPHA)), zero, out)
            last = torch.where(active, enter, last)
        else:
            stop = active & ((conv & (it >= EM_MIN_ITER)) | (it >= EM_MAX_ITER))
        alpha = torch.where(active[id_cell], out, alpha)
        rounds = torch.where(active, torch.full_like(rounds, it), rounds)
        active = active & ~stop
    return torch.where(alpha < f32(MIN_OUTPUT_ALPHA), zero, alpha), rounds


# --- the launch plan ---------------------------------------------------------------

# K6's shared-memory layout (csrc/em.cu): a header (the mbarrier, the
# moved masks, the longest class, two counts), the cell's int32 arrays,
# the staged slices (route a) and each replicate's state
HEADER = 32
MAX_TILE = 32  # replicates a block: one bit each of the kernel's round masks
CHUNK = 2  # replicates a bootstrap work item carries
MAX_THREADS = 512
SM_THREADS = 2048  # resident threads an SM holds
SM_BLOCK_RESERVE = 1024  # shared bytes the device keeps back for each block
MAX_STREAMS = 8  # side streams the launches of one call spread over
ROUTES = ("staged", "shared", "global")  # (a), (b), (c)


def _r16(b):
    return (b + 15) // 16 * 16


def _slice(n):
    """Bytes of a slice of n words staged by bulk copy: 16-byte aligned,
    the array at its source's offset within 16 bytes."""
    return _r16(4 * n) + 16


def cell_bytes(ne, nl, nu, usa: bool, weighted: bool, tile=1) -> tuple:
    """Per cell of ``ne`` classes, ``nl`` labels and ``nu`` dictionary
    entries (int64 arrays): (route (a)'s shared bytes with ``tile``
    replicates, route (b)'s shared bytes).  Route (c) keeps route (b)'s
    bytes but its header in global scratch, for each replicate."""
    ne, nl, nu = (np.asarray(x, np.int64) for x in (ne, nl, nu))
    u = int(usa)
    lists = _r16(4 * (2 * nu + ne))  # first multi-label occurrences, multi ids, multi classes
    state = (2 + u) * nu + ne  # alphas, seeds, abundances (USA), inverses
    layout = (_r16(4 * (ne + nu + 2)) + 2 * _slice(nl) + 2 * u * _slice(nu)
              + (2 * _slice(nl) if weighted else 0))
    staged = HEADER + lists + layout + _r16(4 * np.asarray(tile, np.int64) * (state + ne))
    return staged, HEADER + lists + _r16(4 * state)


def _pow2_floor(x):
    x = np.maximum(np.asarray(x, np.int64), 1)
    return np.left_shift(1, np.floor(np.log2(x)).astype(np.int64))


def block_threads(items, smem, limit: int):
    """Threads of each cell's block, 64 to 512 in powers of two: about one
    per four of its first round's ``items`` (chunks of replicates x ids),
    and no fewer than fill the SM's threads with the blocks that its
    shared bytes let an SM hold (at most 32)."""
    per_sm = np.clip((limit + SM_BLOCK_RESERVE) // (np.asarray(smem) + SM_BLOCK_RESERVE), 1, 32)
    fill = _pow2_floor(SM_THREADS // per_sm)
    want = 2 * _pow2_floor(np.maximum(np.asarray(items) // 4, 1) - 1)
    return np.clip(np.maximum(fill, want), 64, MAX_THREADS)


@dataclass
class Launch:
    """One K6 launch: ``cells`` (indices into the batch) on ``route`` (0,
    1, 2: (a), (b), (c)), ``tile`` replicates and ``threads`` threads a
    block, ``smem`` dynamic shared bytes."""

    cells: np.ndarray
    route: int
    tile: int
    threads: int
    smem: int


def launch_plan(ne, nl, nu, n_rep: int, usa: bool, weighted: bool,
                limit: int) -> Tuple[List[Launch], np.ndarray, int]:
    """K6's launches for cells of ``ne`` classes, ``nl`` labels and ``nu``
    dictionary entries under ``limit`` shared bytes a block, with
    ``n_rep`` replicates (1 outside the bootstrap mode).  A cell takes
    route (a) when its layout and one replicate's state fit, with a tile
    of the most replicates (up to ``n_rep`` and 32) that fit, evened out
    over its blocks; else route (b) when its state fits; else (c).  The
    cells of one route and tile go in groups of like shared bytes
    (``_kernels.launch_groups``), with the block size of the group's
    largest; the groups of the largest cells come first.  Returns (the
    launches, each cell's float offset in one replicate's scratch or -1,
    the scratch floats of a replicate)."""
    from .. import _kernels

    ne, nl, nu = (np.asarray(x, np.int64) for x in (ne, nl, nu))
    fixed, shared = cell_bytes(ne, nl, nu, usa, weighted, 0)
    per_rep = 4 * ((2 + int(usa)) * nu + 2 * ne)
    # fixed is a multiple of 16, so tile * per_rep rounded up to 16 fits
    # exactly when tile * per_rep fits in the room rounded down to 16
    room = np.maximum(limit - fixed, 0) // 16 * 16
    fit = np.where(per_rep > 0, room // np.maximum(per_rep, 1), MAX_TILE)
    route = np.where(fit >= 1, 0, np.where(shared <= limit, 1, 2))
    tile = np.ones(len(ne), np.int64)
    if n_rep > 1:
        tiles = -(-n_rep // np.where(route == 0, np.minimum(np.minimum(fit, MAX_TILE), n_rep), 1))
        tile = -(-n_rep // tiles)
    smem = np.where(route == 0, fixed + _r16(tile * per_rep), np.where(route == 1, shared, HEADER))
    items = -(-tile // (CHUNK if n_rep > 1 else 1)) * np.maximum(nu, ne)
    scratch_off = np.full(len(ne), -1, np.int64)
    glob = np.flatnonzero(route == 2)
    words = (shared[glob] - HEADER) // 4
    scratch_off[glob] = np.cumsum(words) - words
    launches = []
    key = route * (MAX_TILE + 1) + tile
    for k in np.unique(key).tolist():
        r, tl = divmod(k, MAX_TILE + 1)
        sel = np.flatnonzero(key == k)
        groups = [(np.arange(len(sel)), HEADER)] if r == 2 else \
            _kernels.launch_groups(smem[sel], limit)
        for cells, size in groups:
            c = sel[cells]
            launches.append(Launch(c, r, tl, int(block_threads(items[c].max(), size, limit)),
                                   size))
    launches.sort(key=lambda ln: (-ln.route, -ln.smem))
    return launches, scratch_off, int(words.sum())


# --- the kernel ------------------------------------------------------------------

def em_run(t: EmTensors) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 on ``t``'s CUDA device, or its twin for tensors on the CPU.
    Returns (final values per dictionary entry, float32; rounds per
    cell, int32), each (N, U) and (N, C) in the bootstrap mode."""
    if t.occ.device.type == "cpu":
        return em_run_twin(t)
    # the shared-memory limit is read, and K6 launched, on the tensors' card
    with _kernels.on(t.occ.device):
        return _em_run_cuda(t)


def _em_run_cuda(t: EmTensors) -> Tuple[torch.Tensor, torch.Tensor]:
    lib = _kernels.load()
    dev = t.occ.device
    boot = t.boot_counts is not None
    names = ["cell_cls", "lab_off", "lab_loc", "countf", "dict_off", "p1", "p2", "occ_off", "occ"]
    names += ["lab_w", "occ_w"] if t.lab_w is not None else []
    names += ["cell_lp", "boot_counts", "boot_init"] if boot else []
    for name in names:
        x = getattr(t, name)
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"K6 takes contiguous tensors on one CUDA device ({name})")
    C, E, U = len(t.dict_off) - 1, len(t.countf), len(t.occ_off) - 1
    n_rep = t.boot_counts.shape[0] if boot else 1
    if boot and (t.boot_counts.shape != (n_rep, E) or t.boot_init.shape != (n_rep, U)
                 or t.cell_lp.shape != (C,) or t.lab_w is not None or n_rep > 65535):
        raise ValueError("K6's bootstrap mode takes (N, E) counts, (N, U) initial values and "
                         "one row-sum width per cell, unweighted, N <= 65535")
    alpha = torch.empty((n_rep, U), dtype=_F32, device=dev)
    rounds = torch.empty((n_rep, C), dtype=torch.int32, device=dev)
    if C == 0 or n_rep == 0:
        return (alpha, rounds) if boot else (alpha[0], rounds[0])
    if t.sizes is None or t.sizes.shape != (3, C):
        raise ValueError("K6 takes EmTensors made by EmPlan.to, which carry the cells' sizes")
    launches, scratch_off, n_scratch = launch_plan(
        *t.sizes, n_rep, t.usa, t.lab_w is not None, int(lib.aft_smem_limit()))
    scratch = torch.empty(n_rep * n_scratch, dtype=_F32, device=dev)
    # pinned uploads: the host plans the next call while the card runs this one
    soff = torch.from_numpy(scratch_off).pin_memory().to(dev, non_blocking=True)
    cells = torch.from_numpy(np.concatenate([ln.cells for ln in launches]).astype(np.int32))
    cells = cells.pin_memory().to(dev, non_blocking=True)
    counts = t.boot_counts if boot else t.countf
    # the groups run side by side, so one group's slowest cells do not
    # hold the next group back
    streams = _kernels.fork(dev, min(len(launches), MAX_STREAMS))
    try:
        first = 0
        for i, ln in enumerate(launches):
            _kernels.check(lib.aft_em_cells(
                t.cell_cls.data_ptr(), t.lab_off.data_ptr(), t.lab_loc.data_ptr(),
                counts.data_ptr(), t.dict_off.data_ptr(), t.p1.data_ptr(), t.p2.data_ptr(),
                t.occ_off.data_ptr(), t.occ.data_ptr(),
                *(0, 0) if t.lab_w is None else (t.lab_w.data_ptr(), t.occ_w.data_ptr()),
                cells.data_ptr() + 4 * first, len(ln.cells), int(ln.route == 0), ln.tile,
                ln.threads, soff.data_ptr(), scratch.data_ptr(), ln.smem, t.init_value,
                int(t.with_last_round), int(t.usa), alpha.data_ptr(), rounds.data_ptr(),
                *(t.cell_lp.data_ptr(), t.boot_init.data_ptr()) if boot else (0, 0),
                n_rep, E, U, C, n_scratch, streams[i % len(streams)].cuda_stream,
            ), "K6 aft_em_cells")
            first += len(ln.cells)
            _kernels.launched(LAUNCHES, "K6-boot" if boot else "K6", dev)
            STATS[f"{ROUTES[ln.route]}_cells"] += len(ln.cells) * n_rep
            if ln.tile > 1:
                STATS["tiled_rows"] += len(ln.cells) * n_rep
    finally:
        _kernels.join(dev, streams)
    return (alpha, rounds) if boot else (alpha[0], rounds[0])


# --- the batch entry point -----------------------------------------------------

def class_weights_from_prob_rows(label_offsets: np.ndarray, prob_rows) -> np.ndarray:
    """Flat per-label EM weights from long-read probability rows
    (em.rs:716-844): for each multi-label class, the per-label weight is
    the mean of the class's molecule rows; a class without usable rows
    (the large-component fallback's) keeps uniform weights 1.0, where the
    reference would panic (docs/parity.md, divergence 6)."""
    lens = np.diff(label_offsets)
    w = np.ones(int(label_offsets[-1]), np.float32)
    for i in np.flatnonzero(lens > 1):
        ll = int(lens[i])
        rows = prob_rows[i] if prob_rows is not None and i < len(prob_rows) else []
        usable = [r[:ll] for r in rows if len(r) >= ll]
        if usable:
            w[label_offsets[i] : label_offsets[i + 1]] = np.mean(
                np.stack(usable), axis=0
            ).astype(np.float32)
    return w


def em_cells(
    cell_eq_offsets: np.ndarray,
    label_offsets: np.ndarray,
    labels: np.ndarray,
    counts: np.ndarray,
    num_rows: int,
    usa_offsets: Optional[Tuple[int, int]],
    init_uniform: bool,
    with_last_round: bool,
    device: torch.device,
    weights: Optional[np.ndarray] = None,
    mesh=None,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The EM of every cell on ``device``: per cell (ids ascending, int64;
    values, float32), the contract of the reference's
    ``em_cells_batched`` (em.py:917), weighted by ``weights`` (one per
    label) when given.  A cell whose classes all have one label takes its
    counts without EM; a class with no label contributes nothing; values
    below 0.01 are dropped.  With ``mesh`` (``parallel/mesh.py``) the
    cells split into contiguous ranges of about equal occurrences, one a
    shard, each run on its shard's device; every cell's EM is its own,
    so the values are those of one device.  The host's plan is an
    ``em_plan`` span."""
    with spans.span("em_plan", "resolution"):
        plan = plan_cells(cell_eq_offsets, label_offsets, labels, counts, num_rows,
                          usa_offsets, init_uniform, with_last_round, weights)
    if mesh is None:
        alpha = em_run(plan.to(device))[0].cpu().numpy()
    else:
        alpha = _em_on_mesh(plan, mesh)
    C = len(plan.dict_off) - 1
    nu, ne = np.diff(plan.dict_off), np.diff(plan.cell_cls)
    STATS["calls"] += 1
    STATS["cells"] += C
    STATS["classes"] += int(ne.sum())
    STATS["labels"] += len(plan.lab_loc)
    STATS["max_u"] = max(STATS["max_u"], int(nu.max()) if C else 0)
    STATS["max_e"] = max(STATS["max_e"], int(ne.max()) if C else 0)
    if C == 0:
        return []
    nz = alpha != 0
    ends = np.cumsum(np.bincount(np.repeat(np.arange(C), nu)[nz], minlength=C))[:-1]
    return list(zip(np.split(plan.dict_id[nz], ends), np.split(alpha[nz], ends)))


def _em_on_mesh(plan: EmPlan, mesh) -> np.ndarray:
    """K6 (or its twin) over ``plan``'s cells split over the mesh's
    shards by occurrences: each shard's range is launched on its device
    before any result is read back; the values in cell order."""
    cuts = _kernels.ranges(plan.lab_off[plan.cell_cls], mesh.size)
    runs = [em_run(plan.cells(a, b).to(dev))[0]
            for dev, a, b in zip(mesh.devices, cuts[:-1], cuts[1:]) if b > a]
    return np.concatenate([r.cpu().numpy() for r in runs] or [np.zeros(0, np.float32)])
