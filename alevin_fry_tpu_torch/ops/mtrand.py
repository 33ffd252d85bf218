"""The bootstraps' random EM init on kernel K8: NumPy's legacy
``RandomState(seed).random_sample`` stream, drawn on the card.

The reference's host bootstraps start each replicate's EM from
``np.random.RandomState(seed_i).random_sample(R + 1).astype(np.float32)
+ 1e-5`` (``alevin_fry_tpu/ops/bootstrap.py:237-241``, ``:322-324``),
one stream per (cell, replicate) row, and read it only at the ids of
the cell's classes.  The JAX package's device path drew its init from
threefry on the chip instead (``ops/em.py:340-345``, ``:639-650``); the
port keeps the host path's numbers, so its bootstraps are byte-identical
to the reference's host path.

The stream is MT19937 as NumPy seeds it from an int (``init_genrand``):
``mt[0] = seed``, ``mt[i] = 1812433253 * (mt[i-1] ^ (mt[i-1] >> 30)) + i``;
before each 624 words the state is twisted; each word is tempered; and
double ``k`` of ``random_sample`` is ``((a >> 5) * 2**26 + (b >> 6)) /
2**53`` of words ``2k`` and ``2k + 1``, so one twist gives 312 doubles.

:func:`random_init` takes, per row, a 32-bit seed and the row's ids
ascending (the dictionary of its cell), and returns for each (row, id)
``f32(double id) + f32(1e-5)``.  It launches K8 (``csrc/mt19937.cu``)
for tensors on a CUDA device and takes the plain PyTorch twin
:func:`random_init_twin`, the same arithmetic in int64 over many rows
at once, for tensors on the CPU.  ``LAUNCHES`` counts K8's launches.
"""

from __future__ import annotations

import torch

from .. import _kernels

LAUNCHES = {"K8": 0}

_N, _M = 624, 397
_MATRIX_A, _UPPER, _LOWER, _MASK32 = 0x9908B0DF, 0x80000000, 0x7FFFFFFF, 0xFFFFFFFF
DOUBLES_PER_TWIST = _N // 2
MAX_REPLICATES = 65535  # K6's bootstrap grid: a row of blocks per replicate on routes (b), (c)
# the twin's rows per pass (its state is 624 int64 words a row)
_TWIN_ROWS = 16_384


def _check(seeds: torch.Tensor, dict_off: torch.Tensor, ids: torch.Tensor) -> None:
    if seeds.dim() != 2 or seeds.shape[1] != len(dict_off) - 1:
        raise ValueError("seeds are (replicates, cells)")
    if seeds.dtype != torch.int64 or dict_off.dtype != torch.int64 or ids.dtype != torch.int32:
        raise ValueError("K8 takes int64 seeds and offsets and int32 ids")
    if int(dict_off[-1]) != len(ids) or seeds.shape[0] > MAX_REPLICATES:
        raise ValueError(f"the offsets end at the ids' count; at most {MAX_REPLICATES} replicates")


def _seed_state(seeds: torch.Tensor) -> torch.Tensor:
    """(B, 624) int64 MT19937 states of ``seeds`` (init_genrand)."""
    st = torch.empty((len(seeds), _N), dtype=torch.int64, device=seeds.device)
    s = seeds & _MASK32
    st[:, 0] = s
    for i in range(1, _N):
        s = (1812433253 * (s ^ (s >> 30)) + i) & _MASK32
        st[:, i] = s
    return st


def _mix(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x ^ (y >> 1) ^ ((y & 1) * _MATRIX_A)


def _twist(st: torch.Tensor) -> None:
    """One MT19937 twist of every row, in place, in the four runs whose
    words depend only on earlier runs: i < 227, 227 <= i < 454,
    454 <= i < 623, then i = 623 (which reads the new word 0)."""
    k = _N - _M
    y = (st[:, 0:k] & _UPPER) | (st[:, 1:k + 1] & _LOWER)
    st[:, 0:k] = _mix(y, st[:, _M:_N])
    y = (st[:, k:2 * k] & _UPPER) | (st[:, k + 1:2 * k + 1] & _LOWER)
    st[:, k:2 * k] = _mix(y, st[:, 0:k])
    y = (st[:, 2 * k:_N - 1] & _UPPER) | (st[:, 2 * k + 1:_N] & _LOWER)
    st[:, 2 * k:_N - 1] = _mix(y, st[:, k:_M - 1])
    y = (st[:, _N - 1] & _UPPER) | (st[:, 0] & _LOWER)
    st[:, _N - 1] = _mix(y, st[:, _M - 1])


def _doubles_f32(st: torch.Tensor) -> torch.Tensor:
    """The 312 doubles of each row's current words, as float32 + 1e-5."""
    y = st ^ (st >> 11)
    y = y ^ ((y << 7) & 0x9D2C5680)
    y = y ^ ((y << 15) & 0xEFC60000)
    y = y ^ (y >> 18)
    bits = (y[:, 0::2] >> 5) * 67108864 + (y[:, 1::2] >> 6)
    x = (bits.to(torch.float64) * (1.0 / 9007199254740992.0)).to(torch.float32)
    return x + torch.tensor(1e-5, dtype=torch.float32, device=st.device)


def random_init_twin(seeds: torch.Tensor, dict_off: torch.Tensor,
                     ids: torch.Tensor) -> torch.Tensor:
    """K8's plain PyTorch version: ``seeds`` (N, C) int64 holding 32-bit
    seeds, one per (replicate, cell) row; ``dict_off`` (C+1) int64 and
    ``ids`` (U) int32, each cell's ids ascending.  Returns (N, U)
    float32: for row (r, c) and each entry of cell c, its id's element of
    the row's stream plus 1e-5."""
    _check(seeds, dict_off, ids)
    dev = ids.device
    N, C = seeds.shape
    out = torch.zeros((N, len(ids)), dtype=torch.float32, device=dev)
    if not len(ids):
        return out
    cell = torch.repeat_interleave(torch.arange(C, device=dev), dict_off[1:] - dict_off[:-1])
    step = max(1, _TWIN_ROWS // max(N, 1))
    for c0 in range(0, C, step):
        c1 = min(C, c0 + step)
        e0, e1 = int(dict_off[c0]), int(dict_off[c1])
        if e0 == e1:
            continue
        st = _seed_state(seeds[:, c0:c1].reshape(-1))
        e_id = ids[e0:e1].long()
        e_row = cell[e0:e1] - c0
        for t in range(int(e_id.max()) // DOUBLES_PER_TWIST + 1):
            _twist(st)
            sel = torch.nonzero(e_id // DOUBLES_PER_TWIST == t).flatten()
            if len(sel):
                vals = _doubles_f32(st).view(N, c1 - c0, DOUBLES_PER_TWIST)
                out[:, e0 + sel] = vals[:, e_row[sel], e_id[sel] % DOUBLES_PER_TWIST]
    return out


def random_init(seeds: torch.Tensor, dict_off: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K8 on the tensors' CUDA device, or its twin for tensors on the CPU
    (:func:`random_init_twin`'s contract)."""
    if ids.device.type == "cpu":
        return random_init_twin(seeds, dict_off, ids)
    _check(seeds, dict_off, ids)
    for name, x in (("seeds", seeds), ("dict_off", dict_off), ("ids", ids)):
        if x.device != ids.device or not x.is_contiguous():
            raise ValueError(f"K8 takes contiguous tensors on one CUDA device ({name})")
    N, C = seeds.shape
    out = torch.empty((N, len(ids)), dtype=torch.float32, device=ids.device)
    if N == 0 or C == 0 or not len(ids):
        return out
    lib = _kernels.load()
    with _kernels.on(out.device):
        _kernels.check(lib.aft_mt_init(seeds.data_ptr(), dict_off.data_ptr(), ids.data_ptr(),
                                       C, N, len(ids), out.data_ptr(), _kernels.stream_of(out)),
                       "K8 aft_mt_init")
    _kernels.launched(LAUNCHES, "K8", out.device)
    return out
