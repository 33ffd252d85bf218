"""Hamming<=1 barcode neighbour search, kernels K4 and K5.

For every query barcode: how many kept barcodes lie within Hamming
distance 1 over the 2-bit base code, and the smallest of them — the
input of the unfiltered-permit-list rescue.

* K4 :func:`neighbor_counts` returns the smallest kept *index* of a
  sorted kept table, for 2..32-base barcodes — the contract of
  ``alevin_fry_tpu/ops/pallas_hamming.py::find_neighbors_mxu``.  Its
  twin :func:`neighbor_counts_twin` is the TPU formulation: a chunked
  float32 one-hot matmul, exact because every match count is at most 32.
* K5 :func:`neighbor_counts_brute` returns the smallest kept *value* by
  unsigned order, over whole 64-bit words of any length and a kept
  table in any order — the contract of ``find_neighbors_pallas``.  Its
  twin :func:`neighbor_counts_brute_twin` is chunked int64 XOR and 2-bit
  fold, with "at most one bit set" as ``t & (t - 1) == 0``.

Both are one hand-written CUDA kernel template (``csrc/hamming.cu``:
XOR, 2-bit fold, popcount) with two select policies.  A wrapper launches its kernel for CUDA tensors and
runs its twin only for CPU tensors.  ``LAUNCHES`` counts the kernel
launches.
"""

from __future__ import annotations

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

# the twins' (query chunk x kept) blocks stay under this many elements,
# so neither ever needs the whole (Q, K) field
_TWIN_BLOCK_ELEMS = 1 << 26
_BRUTE_TWIN_BLOCK_ELEMS = 1 << 24


def _onehot(codes: torch.Tensor, length: int) -> torch.Tensor:
    """(n,) int64 2-bit codes -> (n, 4 * length) float32 one-hot rows.
    The arithmetic shift of a code with bit 63 set is harmless: only
    the two low bits survive the mask."""
    shifts = 2 * torch.arange(length, device=codes.device, dtype=torch.int64)
    base = (codes[:, None] >> shifts[None, :]) & 3
    letters = torch.arange(4, device=codes.device, dtype=torch.int64)
    return (base[:, :, None] == letters).to(torch.float32).reshape(len(codes), 4 * length)


def neighbor_counts_twin(queries: torch.Tensor, kept: torch.Tensor, length: int):
    """Plain PyTorch K4: (count int32, smallest kept index int32 or
    INT32_MAX) per query, from one-hot match counts m with
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


def neighbor_counts(queries: torch.Tensor, kept: torch.Tensor, length: int):
    """K4 on int64 2-bit codes (``kept`` in ascending unsigned order):
    (count, smallest kept index) per query, both int32."""
    if not 2 <= length <= 32:
        raise ValueError("K4 takes 2..32-base barcodes")
    if _check_codes("K4", queries, kept):
        return neighbor_counts_twin(queries, kept, length)
    lib = _kernels.load()
    nq, nk = len(queries), len(kept)
    cnt = torch.empty(nq, dtype=torch.int32, device=queries.device)
    idx = torch.empty(nq, dtype=torch.int32, device=queries.device)
    if nq:
        _kernels.check(lib.aft_hamming1(
            queries.data_ptr(), nq, kept.data_ptr(), nk, cnt.data_ptr(),
            idx.data_ptr(), _kernels.stream_of(queries),
        ), "K4 hamming1")
        LAUNCHES["K4"] += 1
    return cnt, idx


def neighbor_counts_brute_twin(queries: torch.Tensor, kept: torch.Tensor):
    """Plain PyTorch K5: (count int32, smallest neighbour by unsigned
    value as int64 bits, all ones where the count is 0) per query.  The
    arithmetic ``>> 1`` of a word with bit 63 set is harmless: the fold
    mask clears bit 63.  The unsigned minimum is a signed minimum of the
    words with bit 63 flipped."""
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


def neighbor_counts_brute(queries: torch.Tensor, kept: torch.Tensor):
    """K5 on int64 codes (``kept`` in any order, any barcode length):
    (count int32, smallest neighbour by unsigned value as int64 bits,
    all ones where the count is 0) per query."""
    if _check_codes("K5", queries, kept):
        return neighbor_counts_brute_twin(queries, kept)
    lib = _kernels.load()
    nq, nk = len(queries), len(kept)
    cnt = torch.empty(nq, dtype=torch.int32, device=queries.device)
    rep = torch.empty(nq, dtype=torch.int64, device=queries.device)
    if nq:
        _kernels.check(lib.aft_hamming1_min(
            queries.data_ptr(), nq, kept.data_ptr(), nk, cnt.data_ptr(),
            rep.data_ptr(), _kernels.stream_of(queries),
        ), "K5 hamming1_min")
        LAUNCHES["K5"] += 1
    return cnt, rep


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
