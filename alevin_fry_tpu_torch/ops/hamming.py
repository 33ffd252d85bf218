"""Hamming<=1 barcode neighbour search, kernels K4 and K5.

For every query barcode: how many kept barcodes lie within Hamming
distance 1 over the 2-bit base code, and the smallest of them — the
input of the unfiltered-permit-list rescue.

* K4 :func:`neighbor_counts` returns the smallest kept *index* of a
  sorted kept table, for 2..32-base barcodes — the contract of
  ``alevin_fry_tpu/ops/pallas_hamming.py::find_neighbors_mxu``.  Its
  brute-force twin :func:`neighbor_counts_twin` is the TPU formulation:
  a chunked float32 one-hot matmul, exact because every match count is
  at most 32.
* K5 :func:`neighbor_counts_brute` returns the smallest kept *value* by
  unsigned order, over whole 64-bit words of any length and a kept
  table in any order — the contract of ``find_neighbors_pallas``.  Its
  brute-force twin :func:`neighbor_counts_brute_twin` is chunked int64
  XOR and 2-bit fold, with "at most one bit set" as ``t & (t - 1) == 0``.

Both run one hand-written CUDA kernel (``csrc/hamming.cu``) that probes
each query's 3P + 1 words within distance 1 (the word itself and one
substitution at each of P positions) in the kept table sorted in
unsigned order, with two select policies.  :func:`neighbor_probe_twin`
is the same algorithm in plain PyTorch (``torch.searchsorted``) and
serves both contracts.  A wrapper launches its kernel for CUDA tensors
and runs the probe twin only for CPU tensors; the brute-force twins
define the function and are the oracle of the tests.  ``LAUNCHES``
counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _kernels
from ..interop import barcodes_from_torch, barcodes_to_torch

I32_MAX = (1 << 31) - 1
I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1
# the 2-bit fold's mask: one bit per base, bit 63 clear
_FOLD = 0x5555555555555555
LAUNCHES = {"K4": 0, "K5": 0}

# the twins' (query chunk x kept or probes) blocks stay under this many
# elements, so none ever needs the whole (Q, K) field
_TWIN_BLOCK_ELEMS = 1 << 26
_BRUTE_TWIN_BLOCK_ELEMS = 1 << 24
_PROBE_TWIN_BLOCK_ELEMS = 1 << 22


def _onehot(codes: torch.Tensor, length: int) -> torch.Tensor:
    """(n,) int64 2-bit codes -> (n, 4 * length) float32 one-hot rows.
    The arithmetic shift of a code with bit 63 set is harmless: only
    the two low bits survive the mask."""
    shifts = 2 * torch.arange(length, device=codes.device, dtype=torch.int64)
    base = (codes[:, None] >> shifts[None, :]) & 3
    letters = torch.arange(4, device=codes.device, dtype=torch.int64)
    return (base[:, :, None] == letters).to(torch.float32).reshape(len(codes), 4 * length)


def neighbor_counts_twin(queries: torch.Tensor, kept: torch.Tensor, length: int):
    """Brute-force plain PyTorch K4: (count int32, smallest kept index
    int32 or INT32_MAX) per query, from one-hot match counts m with
    d <= 1  <=>  m > length - 1.5."""
    nq, nk = len(queries), len(kept)
    cnt = torch.zeros(nq, dtype=torch.int32, device=queries.device)
    idx = torch.full((nq,), I32_MAX, dtype=torch.int32, device=queries.device)
    if nq == 0 or nk == 0:
        return cnt, idx
    koh = _onehot(kept, length)
    kidx = torch.arange(nk, dtype=torch.int32, device=kept.device)
    thresh = length - 1.5
    step = max(1, _TWIN_BLOCK_ELEMS // nk)
    for s in range(0, nq, step):
        m = _onehot(queries[s:s + step], length) @ koh.T
        near = m > thresh
        cnt[s:s + step] = near.sum(1, dtype=torch.int32)
        idx[s:s + step] = torch.where(near, kidx, I32_MAX).amin(1)
    return cnt, idx


def neighbor_counts_brute_twin(queries: torch.Tensor, kept: torch.Tensor):
    """Brute-force plain PyTorch K5: (count int32, smallest neighbour by
    unsigned value as int64 bits, all ones where the count is 0) per
    query.  The arithmetic ``>> 1`` of a word with bit 63 set is
    harmless: the fold mask clears bit 63.  The unsigned minimum is a
    signed minimum of the words with bit 63 flipped."""
    nq, nk = len(queries), len(kept)
    cnt = torch.zeros(nq, dtype=torch.int32, device=queries.device)
    rep = torch.full((nq,), -1, dtype=torch.int64, device=queries.device)
    if nq == 0 or nk == 0:
        return cnt, rep
    flipped = kept ^ I64_MIN
    step = max(1, _BRUTE_TWIN_BLOCK_ELEMS // nk)
    for s in range(0, nq, step):
        x = queries[s:s + step, None] ^ kept[None, :]
        t = (x | (x >> 1)) & _FOLD
        near = (t & (t - 1)) == 0
        cnt[s:s + step] = near.sum(1, dtype=torch.int32)
        rep[s:s + step] = torch.where(near, flipped, I64_MAX).amin(1) ^ I64_MIN
    return cnt, rep


def _probe_masks(positions: int, device) -> torch.Tensor:
    """The 3P + 1 XOR masks of the words within distance 1 of a code:
    0 (the code itself), then v << 2p for v = 1..3 and p < P, as int64
    bits."""
    masks = [0] + [v << (2 * p) for p in range(positions) for v in (1, 2, 3)]
    return torch.tensor([m - (1 << 64) if m >> 63 else m for m in masks],
                        dtype=torch.int64, device=device)


def neighbor_probe_twin(queries: torch.Tensor, kept_sorted: torch.Tensor, positions: int,
                        values: bool = False):
    """Plain PyTorch of the kernels' algorithm, for both contracts: each
    query's 3P + 1 words within distance 1 (``positions`` = P) searched
    in ``kept_sorted`` (ascending unsigned order, duplicates allowed)
    with ``torch.searchsorted`` on the left and on the right; the count
    adds each word's equal range.  Returns (count int32, smallest kept
    index int32 or INT32_MAX), K4's outputs, or with ``values`` (count,
    smallest neighbour as int64 bits or all ones), K5's."""
    nq, nk = len(queries), len(kept_sorted)
    cnt = torch.zeros(nq, dtype=torch.int32, device=queries.device)
    idx = torch.full((nq,), I32_MAX, dtype=torch.int32, device=queries.device)
    if nq and nk:
        table = kept_sorted ^ I64_MIN  # ascending as signed words
        masks = _probe_masks(positions, queries.device)
        step = max(1, _PROBE_TWIN_BLOCK_ELEMS // len(masks))
        for s in range(0, nq, step):
            words = (queries[s:s + step, None] ^ masks[None, :]) ^ I64_MIN
            lo = torch.searchsorted(table, words)
            n = torch.searchsorted(table, words, right=True) - lo
            cnt[s:s + step] = n.sum(1, dtype=torch.int32)
            idx[s:s + step] = torch.where(n > 0, lo, I32_MAX).amin(1).to(torch.int32)
    if not values:
        return cnt, idx
    rep = torch.full((nq,), -1, dtype=torch.int64, device=queries.device)
    if nk:
        hit = cnt > 0
        rep[hit] = kept_sorted[idx[hit].long()]
    return cnt, rep


def sort_unsigned(codes: torch.Tensor) -> torch.Tensor:
    """A copy of int64 codes in ascending unsigned order: bit 63
    flipped, a stable signed sort, flipped back."""
    return torch.sort(codes ^ I64_MIN, stable=True).values ^ I64_MIN


def used_positions(queries: torch.Tensor, kept_sorted: torch.Tensor) -> int:
    """The 2-bit positions any code of the two (non-empty) tables uses:
    half the bit length of their OR, which is that of their largest
    unsigned word (32 when any word has bit 63 set).  ``kept_sorted`` is
    in unsigned order, so its last word is its largest."""
    qmin, qmax = torch.aminmax(queries)
    qmin, qmax, kmax = torch.stack([qmin, qmax, kept_sorted[-1]]).tolist()
    if qmin < 0 or kmax < 0:
        return 32
    return (max(qmax, kmax).bit_length() + 1) // 2


def _check_codes(key: str, queries: torch.Tensor, kept: torch.Tensor) -> bool:
    """Validate a kernel's inputs; True when they lie on the CPU (the
    twin's case), False for contiguous CUDA tensors on one device."""
    if queries.dtype != torch.int64 or kept.dtype != torch.int64:
        raise TypeError(f"{key} takes int64 2-bit codes")
    if queries.dim() != 1 or kept.dim() != 1:
        raise ValueError(f"{key} takes 1-D query and kept tensors")
    if queries.device.type == "cpu":
        return True
    if (queries.device.type != "cuda" or kept.device != queries.device
            or not (queries.is_contiguous() and kept.is_contiguous())):
        raise ValueError(f"{key} takes contiguous CUDA tensors on one device")
    if len(kept) >= I32_MAX:
        raise ValueError(f"{key} counts kept codes with int32")
    return False


def _launch(key: str, fn: str, queries: torch.Tensor, kept_sorted: torch.Tensor,
            positions: int, dtype: torch.dtype, none: int):
    """Run the probe kernel ``fn``: (count int32, ``dtype`` key, ``none``
    where the count is 0) per query."""
    nq, nk = len(queries), len(kept_sorted)
    if nq == 0 or nk == 0:
        return (torch.zeros(nq, dtype=torch.int32, device=queries.device),
                torch.full((nq,), none, dtype=dtype, device=queries.device))
    cnt = torch.empty(nq, dtype=torch.int32, device=queries.device)
    best = torch.empty(nq, dtype=dtype, device=queries.device)
    # the entry point plans for, and launches on, the current card
    with _kernels.on(queries.device):
        _kernels.check(getattr(_kernels.load(), fn)(
            queries.data_ptr(), nq, kept_sorted.data_ptr(), nk, positions, cnt.data_ptr(),
            best.data_ptr(), _kernels.stream_of(queries),
        ), f"{key} {fn}")
    _kernels.launched(LAUNCHES, key, queries.device)
    return cnt, best


def neighbor_counts(queries: torch.Tensor, kept: torch.Tensor, length: int):
    """K4 on int64 2-bit codes (``kept`` in ascending unsigned order):
    (count, smallest kept index) per query, both int32."""
    if not 2 <= length <= 32:
        raise ValueError("K4 takes 2..32-base barcodes")
    if _check_codes("K4", queries, kept):
        return neighbor_probe_twin(queries, kept, length)
    return _launch("K4", "aft_hamming1", queries, kept, length, torch.int32, I32_MAX)


def neighbor_counts_brute(queries: torch.Tensor, kept: torch.Tensor):
    """K5 on int64 codes (``kept`` in any order, any barcode length):
    (count int32, smallest neighbour by unsigned value as int64 bits,
    all ones where the count is 0) per query.  The kept table is sorted
    in unsigned order on its device first."""
    cpu = _check_codes("K5", queries, kept)
    kept_sorted = sort_unsigned(kept)
    positions = used_positions(queries, kept_sorted) if len(queries) and len(kept) else 0
    if cpu:
        return neighbor_probe_twin(queries, kept_sorted, positions, values=True)
    return _launch("K5", "aft_hamming1_min", queries, kept_sorted, positions, torch.int64, -1)


def search_plan(nk: int, device="cuda") -> dict:
    """How the kernels search a table of ``nk`` codes on ``device``'s
    card: every ``stride``-th code in shared memory (``smem_bytes`` a
    block), and ``blocks_per_sm`` resident blocks."""
    out = (ctypes.c_longlong * 3)()
    with _kernels.on(device):
        _kernels.check(_kernels.load().aft_hamming1_plan(nk, out), "hamming1 plan")
    return {"stride": out[0], "smem_bytes": out[1], "blocks_per_sm": out[2]}


def find_neighbors_brute(queries: np.ndarray, kept: np.ndarray, device: torch.device):
    """Rescue search on ``device`` through K5: (neighbour counts int64,
    smallest neighbour uint64 where the count is >= 1, else 0)."""
    queries = np.asarray(queries, np.uint64)
    kept = np.asarray(kept, np.uint64)
    nq = len(queries)
    if nq == 0 or len(kept) == 0:
        return np.zeros(nq, np.int64), np.zeros(nq, np.uint64)
    cnt, rep = neighbor_counts_brute(
        barcodes_to_torch(queries).to(device), barcodes_to_torch(kept).to(device)
    )
    cnt = cnt.cpu().numpy().astype(np.int64)
    rep = barcodes_from_torch(rep)
    return cnt, np.where(cnt > 0, rep, np.uint64(0))


def find_neighbors(queries: np.ndarray, kept_sorted: np.ndarray, length: int,
                   device: torch.device):
    """Rescue search on ``device`` through K4: (neighbour counts int64, smallest
    neighbour uint64 where the count is >= 1, else 0)."""
    queries = np.asarray(queries, np.uint64)
    kept_sorted = np.sort(np.asarray(kept_sorted, np.uint64))
    nq, nk = len(queries), len(kept_sorted)
    if nq == 0 or nk == 0:
        return np.zeros(nq, np.int64), np.zeros(nq, np.uint64)
    cnt, idx = neighbor_counts(
        barcodes_to_torch(queries).to(device),
        barcodes_to_torch(kept_sorted).to(device),
        length,
    )
    both = torch.stack([cnt, idx]).cpu().numpy()
    cnt = both[0].astype(np.int64)
    rep = np.where(
        cnt > 0, kept_sorted[np.minimum(both[1], nk - 1)], np.uint64(0)
    )
    return cnt, rep
