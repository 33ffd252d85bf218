"""CUDA kernels K1-K5 of alevin_fry_tpu_torch against their plain
PyTorch twins, and the ATAC sort and run-length count and the
multi-word cr-like WTA on the card against their CPU results.

Every test needs a CUDA device and skips without one; whether there is
one is decided inside the ``cuda`` fixture, never at import.  Outputs
are integers, so every comparison is exact equality.  This file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from alevin_fry_tpu_torch.interop import barcodes_to_torch
from alevin_fry_tpu_torch.ops import atac_device, hamming, segscan


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _segments(rng, n):
    start = rng.rand(n) < 0.2
    start[0] = True
    return start


def _eq(a, b):
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, 32769, 1_000_003])
def test_k1_k2_k3_kernels_match_twins(cuda, n):
    rng = np.random.RandomState(n % 1000)
    x = torch.from_numpy(rng.randint(0, 5, n).astype(np.int32)).to(cuda)
    st = torch.from_numpy(_segments(rng, n)).to(cuda)
    for got, want in zip(segscan.scan_fwd(x, st), segscan.scan_fwd_twin(x, st)):
        _eq(got, want)
    e = torch.from_numpy(rng.randint(-1000, 1000, n).astype(np.int32)).to(cuda)
    for rev in (False, True):
        _eq(segscan.scan_min(e, rev), segscan.scan_min_twin(e, rev))
    w = torch.from_numpy(rng.randint(-(1 << 62), 1 << 62, n, dtype=np.int64)).to(cuda)
    for bigger in (False, True):
        for rev in (False, True):
            _eq(segscan.scan_lex(w, bigger, rev), segscan.scan_lex_twin(w, bigger, rev))


# n of the single-pass scan checks, from the kernels' tile (elements)
LOOKBACK_SIZES = {
    "1": lambda tile: 1, "tile-1": lambda tile: tile - 1, "tile": lambda tile: tile,
    "tile+1": lambda tile: tile + 1, "3tile+5": lambda tile: 3 * tile + 5,
    "1000003": lambda tile: 1_000_003, "30000001": lambda tile: 30_000_001,
}
REPEATS = 50  # launches held against one twin result, to catch a look-back race


def _start_pattern(kind, n, tile, rng):
    start = np.zeros(n, dtype=bool)
    if kind == "row 0":
        start[0] = True
    elif kind == "every row":
        start[:] = True
    elif kind == "tile ends":
        start[tile - 1::tile] = True
    else:
        start = rng.rand(n) < 0.2
    return start


def _same_every_time(launch, want):
    for _ in range(REPEATS):
        got = launch()
        got = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want_t):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["row 0", "every row", "tile ends", "random"])
@pytest.mark.parametrize("size", list(LOOKBACK_SIZES))
def test_k1_k3_single_pass_scan_exact(cuda, size, pattern):
    """K1 and K3 (the single-pass look-back scan) equal their twins at
    tile edges and beyond, on views whose pointer sits 4 or 8 bytes off
    the 16-byte grid (and a K1 mask on another grid than its values),
    with K3 in all four directions, each launch repeated."""
    from alevin_fry_tpu_torch import _kernels

    tile = _kernels.load().aft_segscan_tile(1)
    assert _kernels.load().aft_segscan_tile(3) == tile
    n = LOOKBACK_SIZES[size](tile)
    rng = np.random.RandomState(n % 10007 + len(pattern))
    start = _start_pattern(pattern, n + 1, tile, rng)
    x = torch.from_numpy(rng.randint(0, 5, n + 1).astype(np.int32)).to(cuda)
    st = torch.from_numpy(start).to(cuda)
    views = {"aligned": (x[:n], st[:n]), "offset": (x[1:], st[1:]),
             "mask on its own grid": (x[1:], st[1:].clone())}
    for xv, sv in views.values():
        want = segscan.scan_fwd_twin(xv, sv)
        _same_every_time(lambda: segscan.scan_fwd(xv, sv), want)

    grp = torch.from_numpy(np.cumsum(start).astype(np.int32)).to(cuda)
    lo = torch.from_numpy(rng.randint(-(1 << 31), (1 << 31) - 1, n + 1).astype(np.int32)).to(cuda)
    rising, falling = segscan.pack_pair(grp, lo), segscan.pack_pair(-grp, lo)
    for bigger in (False, True):
        for rev in (False, True):
            # words that keep changing the running value in the scan's direction
            w = rising if bigger != rev else falling
            for wv in (w[:n], w[1:]):
                want = segscan.scan_lex_twin(wv, bigger, rev)
                _same_every_time(lambda: segscan.scan_lex(wv, bigger, rev), want)


def _min_values(kind, n, reverse, rng):
    """K2's int32 inputs: constant; strictly falling in the scan's
    direction (every element lowers the running min); seg_sum's
    where(ends, c, I32_MAX); or random over the whole int32 range with
    INT_MIN and INT_MAX among them."""
    if kind == "constant":
        return np.full(n, 7, dtype=np.int32)
    if kind == "falling":
        e = -np.arange(n, dtype=np.int32)
        return e[::-1].copy() if reverse else e
    if kind == "segment ends":
        ends = np.append(_segments(rng, n)[1:], True)
        c = np.cumsum(rng.randint(0, 5, n)).astype(np.int32)
        return np.where(ends, c, segscan.I32_MAX).astype(np.int32)
    e = rng.randint(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    e[rng.randint(0, n, 3)] = segscan.I32_MAX
    e[0 if reverse else n - 1] = -(1 << 31)
    return e


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["constant", "falling", "segment ends", "full range"])
@pytest.mark.parametrize("size", list(LOOKBACK_SIZES))
def test_k2_single_pass_scan_exact(cuda, size, pattern):
    """K2 (the single-pass look-back scan) equals its twin in both
    directions at its tile's edges and beyond, on views whose pointer
    sits 0, 4, 8 and 12 bytes off the 16-byte grid (so off the grid the
    output, a fresh aligned tensor, lies on another grid than its
    input), each launch repeated."""
    from alevin_fry_tpu_torch import _kernels

    tile = _kernels.load().aft_segscan_tile(2)
    n = LOOKBACK_SIZES[size](tile)
    rng = np.random.RandomState(n % 10007 + len(pattern))
    for rev in (False, True):
        e = torch.from_numpy(_min_values(pattern, n + 3, rev, rng)).to(cuda)
        for ev in (e[:n], e[1:], e[2:], e[3:]):
            want = segscan.scan_min_twin(ev, rev)
            _same_every_time(lambda: segscan.scan_min(ev, rev), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 40_000])
def test_segment_toolkit_cuda_matches_cpu(cuda, n):
    rng = np.random.RandomState(n)
    start = _segments(rng, n)
    grp_ord = (np.cumsum(start)).astype(np.int32)
    mark = rng.rand(n) < 0.3
    val = rng.randint(0, 1 << 20, n).astype(np.int32)
    x = rng.randint(0, 4, n).astype(np.int32)
    cpu = [torch.from_numpy(a) for a in (x, start, val, mark, grp_ord)]
    dev = [t.to(cuda) for t in cpu]

    def run(x, start, val, mark, grp_ord):
        return (
            *segscan.seg_sum(x, start, with_rank=True),
            segscan.seg_reduce(val, mark, start, grp_ord),
            segscan.last_marked(val, mark, grp_ord),
            segscan.last_marked(val, mark, grp_ord, strict=True),
        )

    for got, want in zip(run(*dev), run(*cpu)):
        _eq(got, want)


# (bases, kept codes, kind): "unique" is a table without duplicates,
# "duplicates" repeats some codes (one of them 40 times), and 40,000
# codes exceed the kernels' shared-memory sample (8,191 codes), so their
# searches finish in device memory
HAMMING_CASES = [(10, 3000, "unique"), (16, 3000, "unique"), (24, 3000, "unique"),
                 (32, 3000, "unique"), (2, 6, "unique"), (32, 3000, "duplicates"),
                 (16, 1, "unique"), (16, 40_000, "unique"), (32, 40_000, "duplicates")]


def _hamming_case(rng, length, nk, kind):
    """Kept codes in ascending unsigned order (bit 63 set in some at 32
    bases) and queries: kept codes, one-substitution mutants at every
    position and random codes (every code at 2 bases)."""
    mask = np.uint64((1 << (2 * length)) - 1) if length < 32 else np.uint64(2**64 - 1)
    draw = lambda k: rng.randint(0, 1 << 63, k, dtype=np.uint64) * np.uint64(3) & mask  # noqa: E731
    kept = np.unique(draw(nk))[:nk]
    if kind == "duplicates":
        kept = np.sort(np.concatenate([kept, kept[rng.randint(0, len(kept), len(kept) // 4)],
                                       np.repeat(kept[len(kept) // 2], 40)]))
    n = 500 if len(kept) > 1 else 30
    pos = rng.randint(0, length, n).astype(np.uint64)
    sub = rng.randint(1, 4, n).astype(np.uint64)
    q = np.concatenate([
        kept[rng.randint(0, len(kept), n)],
        kept[rng.randint(0, len(kept), n)] ^ (sub << (np.uint64(2) * pos)),
        draw(n), np.zeros(1, np.uint64),
        np.arange(16, dtype=np.uint64) if length == 2 else np.zeros(0, np.uint64),
    ])
    if length == 32:
        assert (kept >> np.uint64(63)).any()
    return q, kept


@pytest.mark.cuda
@pytest.mark.parametrize("length,nk,kind", HAMMING_CASES)
def test_k4_kernel_matches_twin(cuda, length, nk, kind):
    """K4 against its brute-force twin and the probe twin."""
    q, kept = _hamming_case(np.random.RandomState(length + nk), length, nk, kind)
    qt = barcodes_to_torch(q).to(cuda)
    kt = barcodes_to_torch(kept).to(cuda)
    got = hamming.neighbor_counts(qt, kt, length)
    torch.cuda.synchronize()
    for want in (hamming.neighbor_counts_twin(qt, kt, length),
                 hamming.neighbor_probe_twin(qt, kt, length)):
        for g, w in zip(got, want):
            _eq(g, w)
    if len(kept) > 16:
        assert bool((got[0] == 1).any()) and bool((got[0] == 0).any())
    if kind == "duplicates":
        assert bool((got[0] > 1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("length,nk,kind", HAMMING_CASES + [(0, 3000, "mixed lengths")])
def test_k5_kernel_matches_twin(cuda, length, nk, kind):
    """K5 on a shuffled kept table (codes of 8..16 bases in the mixed
    case) against its brute-force twin, the probe twin and K4."""
    rng = np.random.RandomState(100 + length + nk)
    if kind == "mixed lengths":
        parts = [_hamming_case(rng, b, nk // 9, "unique") for b in range(8, 17)]
        q = np.concatenate([p[0] for p in parts])
        kept = np.unique(np.concatenate([p[1] for p in parts]))
    else:
        q, kept = _hamming_case(rng, length, nk, kind)
    qt = barcodes_to_torch(q).to(cuda)
    kt = barcodes_to_torch(kept).to(cuda)
    perm = torch.from_numpy(rng.permutation(len(kept))).to(cuda)
    got = hamming.neighbor_counts_brute(qt, kt[perm])
    torch.cuda.synchronize()
    probe = hamming.neighbor_probe_twin(qt, kt, hamming.used_positions(qt, kt), values=True)
    for want in (hamming.neighbor_counts_brute_twin(qt, kt[perm]), probe):
        for g, w in zip(got, want):
            _eq(g, w)
    if len(kept) > 16:
        assert bool((got[0] == 1).any()) and bool((got[0] == 0).any())
    if length:
        cnt4, idx4 = hamming.neighbor_counts(qt, kt, length)
        hit = cnt4 > 0
        _eq(got[0], cnt4)
        _eq(got[1][hit], kt[idx4[hit].long()])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5000, 300_000])
def test_sort_rle_cuda_matches_cpu(cuda, n):
    rng = np.random.RandomState(n)
    cols = [rng.randint(0, 20, n), rng.randint(0, 1 << 28, n) % 997,
            rng.randint(0, 2000, n),
            rng.randint(0, 1 << 63, n, dtype=np.uint64) % np.uint64(7) << np.uint64(61)]
    got, cnt = atac_device.sort_rle(cols, cuda)
    want, want_cnt = atac_device.sort_rle(cols, torch.device("cpu"))
    np.testing.assert_array_equal(cnt, want_cnt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def wide_key_words(n: int, seed: int):
    """(cell, umi, gene) int64 words of ``n`` read-gene pairs too wide to
    pack: 32-base UMIs, which use bit 63, from a pool small enough that
    (cell, umi) groups hold several genes and ties; 14-bit genes."""
    rng = np.random.RandomState(seed)
    cell = np.sort(rng.randint(0, 20_000, n)).astype(np.int64)
    pool = rng.randint(0, 1 << 63, 16, dtype=np.uint64) | np.uint64(1 << 63)
    umi = pool[rng.randint(0, len(pool), n)].view(np.int64)
    gene = rng.randint(0, 1 << 14, n).astype(np.int64)
    return [torch.from_numpy(w) for w in (cell, umi, gene)]


@pytest.mark.cuda
@pytest.mark.parametrize("usa", [False, True])
def test_wide_key_wta_cuda_matches_cpu(cuda, usa):
    """The multi-word WTA on the card (its sorts, and K1-K3) equals its
    CPU result."""
    from alevin_fry_tpu_torch.ops.crlike_device import resolve_crlike_wta_words

    words = wide_key_words(1_000_003, 5)
    n_rows = 3 * (1 << 13) if usa else 1 << 14
    before = dict(segscan.LAUNCHES)
    got = resolve_crlike_wta_words(*(w.to(cuda) for w in words), 14, n_rows, usa=usa)
    want = resolve_crlike_wta_words(*words, 14, n_rows, usa=usa)
    assert all(segscan.LAUNCHES[k] > before[k] for k in ("K1", "K2", "K3"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 10_000
