"""Kernel K5 of the port (``alevin_fry_tpu_torch/ops/hamming.py``:
:func:`neighbor_counts_brute`, the Hamming<=1 search over whole words
that returns the smallest neighbour by unsigned value) on the CPU, where
the plain PyTorch probe twin runs, against its brute-force twin, the
reference's brute-force Pallas kernel in interpret mode and its host
search; the dispatch of
``AFT_RESCUE_BACKEND``; and the reference's kept-padding fault, which
the port does not copy.

Inputs come from numpy seeds and the outputs are integers, so every
comparison is exact equality.
"""

import numpy as np
import pytest
import torch

from alevin_fry_tpu.ops import barcodes as ref_bc
from alevin_fry_tpu.ops.pallas_hamming import find_neighbors_pallas
from alevin_fry_tpu_torch.interop import barcodes_from_torch, barcodes_to_torch
from alevin_fry_tpu_torch.ops import barcodes, hamming
from hamming_cases import PROBE_CASES, probe_case

CPU = torch.device("cpu")
# the reference pads its kept table to a multiple of 1024 with this
# word, the all-C 32-base barcode: a query within distance 1 of it
# counts the padding as neighbours there
REF_KEPT_PAD = np.uint64(0x5555555555555555)


def _all_c(length: int) -> np.uint64:
    return np.uint64(sum(1 << (2 * i) for i in range(length)))


def _case(length, seed):
    """An unsorted kept table (with bit 63 set at 32 bases) and queries:
    kept barcodes, 1-substitution mutants, mutants within distance 1 of
    two kept barcodes and random codes, none within distance 1 of the
    reference's padding."""
    rng = np.random.RandomState(seed)
    full = np.uint64((1 << (2 * length)) - 1) if length < 32 else np.uint64(2**64 - 1)
    draw = lambda k: rng.randint(0, 1 << 63, k, dtype=np.uint64) * np.uint64(3) & full  # noqa: E731
    base = np.unique(draw(700))
    # base[:20] ^ 0b101 differs from base[:20] in the two lowest bases,
    # so base[:20] ^ 1 lies within distance 1 of both
    kept = rng.permutation(np.unique(np.concatenate([base, base[:20] ^ np.uint64(5)])))
    pos = rng.randint(0, length, 300).astype(np.uint64)
    flip = np.uint64(1) + rng.randint(0, 3, 300).astype(np.uint64)
    queries = np.concatenate([kept[:150], kept[150:450] ^ (flip << (np.uint64(2) * pos)),
                              base[:20] ^ np.uint64(1), draw(150), np.zeros(1, np.uint64)])
    queries = queries[ref_bc.hamming_2bit(queries, np.full(len(queries), REF_KEPT_PAD)) > 1]
    assert not (np.diff(kept.astype(np.float64)) >= 0).all()
    if length == 32:
        assert (kept >> np.uint64(63)).any()
    return queries, kept


@pytest.mark.parametrize("length", [10, 16, 24, 32])
def test_k5_twin_matches_pallas_and_host(length):
    queries, kept = _case(length, length)
    cnt, rep = hamming.find_neighbors_brute(queries, kept, CPU)
    p_cnt, p_rep = find_neighbors_pallas(queries, kept, length, interpret=True)
    h_cnt, h_rep = ref_bc.find_neighbors_batch(queries, np.sort(kept), length)
    np.testing.assert_array_equal(cnt, p_cnt)
    np.testing.assert_array_equal(rep, p_rep)
    np.testing.assert_array_equal(cnt, h_cnt)
    hit = h_cnt > 0
    np.testing.assert_array_equal(rep[hit], h_rep[hit])
    assert (cnt == 1).any() and (cnt > 1).any() and (cnt == 0).any()


def test_k5_twin_outputs_and_chunks(monkeypatch):
    """The wrapper's raw outputs: int32 counts, the smallest neighbour
    as int64 bits (negative where bit 63 is set) and all ones where the
    count is 0; chunked blocks agree with one block."""
    queries, kept = _case(32, 5)
    q, k = barcodes_to_torch(queries), barcodes_to_torch(kept)
    cnt, rep = hamming.neighbor_counts_brute(q, k)
    assert cnt.dtype == torch.int32 and rep.dtype == torch.int64
    assert bool((rep[cnt == 0] == -1).all()) and bool((rep[cnt > 0] < 0).any())
    monkeypatch.setattr(hamming, "_BRUTE_TWIN_BLOCK_ELEMS", 7 * len(kept))
    monkeypatch.setattr(hamming, "_PROBE_TWIN_BLOCK_ELEMS", 7 * 97)
    for got in (hamming.neighbor_counts_brute(q, k), hamming.neighbor_counts_brute_twin(q, k)):
        for a, b in zip((cnt, rep), got):
            assert torch.equal(a, b)


K5_CASES = PROBE_CASES + ["mixed_lengths", "top_position_from_queries"]


def _k5_case(kind):
    """(queries, kept in shuffled order, bases) for K5: the probe cases,
    codes of 8 to 16 bases in one table, and 10-base codes with one
    query whose 14th base is set, so that the positions the probes
    cover come from the queries (its one neighbour, ``anchor``, differs
    from it there); no query within distance 1 of the reference's
    padding."""
    rng = np.random.RandomState(sum(map(ord, kind)))
    anchor = None
    if kind == "mixed_lengths":
        length = 16
        kept = np.unique(np.concatenate([
            rng.randint(0, 1 << 63, 40, dtype=np.uint64) & np.uint64((1 << (2 * b)) - 1)
            for b in range(8, 17)]))
        pos = rng.randint(0, length, 150).astype(np.uint64)
        queries = np.concatenate([kept[:100], kept[100:250] ^ (np.uint64(2) << (np.uint64(2) * pos)),
                                  rng.randint(0, 1 << 32, 60, dtype=np.uint64)])
    elif kind == "top_position_from_queries":
        length = 14
        kept = np.unique(rng.randint(0, 1 << 20, 300).astype(np.uint64))
        anchor = kept[17]
        pos = rng.randint(0, 10, 100).astype(np.uint64)
        queries = np.concatenate([kept[:100], kept[100:200] ^ (np.uint64(3) << (np.uint64(2) * pos)),
                                  rng.randint(0, 1 << 20, 60).astype(np.uint64),
                                  [anchor ^ np.uint64(2 << 26)]])
    else:
        queries, kept, length = probe_case(kind)
    queries = queries[ref_bc.hamming_2bit(queries, np.full(len(queries), REF_KEPT_PAD)) > 1]
    return queries, rng.permutation(kept), length, anchor


@pytest.mark.parametrize("kind", K5_CASES)
def test_k5_probe_twin_matches_brute_twin_and_reference(kind):
    """K5's wrapper on the CPU (the probe twin over the kept table sorted
    in unsigned order, at the positions the codes use) equals its
    brute-force twin, the reference's brute-force kernel in interpret
    mode and its host search (which counts a duplicated kept code once:
    held to the hits and their codes there)."""
    queries, kept, length, anchor = _k5_case(kind)
    q, k = barcodes_to_torch(queries), barcodes_to_torch(kept)
    cnt, rep = hamming.neighbor_counts_brute(q, k)
    ks = hamming.sort_unsigned(k)
    positions = hamming.used_positions(q, ks)
    for want in (hamming.neighbor_probe_twin(q, ks, positions, values=True),
                 hamming.neighbor_counts_brute_twin(q, k)):
        assert torch.equal(cnt, want[0]) and torch.equal(rep, want[1])
    hit = cnt.numpy() > 0
    rep = np.where(hit, barcodes_from_torch(rep), np.uint64(0))
    p_cnt, p_rep = find_neighbors_pallas(queries, kept, length, interpret=True)
    np.testing.assert_array_equal(cnt.numpy(), p_cnt)
    np.testing.assert_array_equal(rep, p_rep)
    h_cnt, h_rep = ref_bc.find_neighbors_batch(queries, np.unique(kept), length)
    np.testing.assert_array_equal(hit, h_cnt > 0)
    np.testing.assert_array_equal(rep[hit], h_rep[hit])
    if kind != "duplicates":
        np.testing.assert_array_equal(cnt.numpy(), h_cnt)
    assert hit.any()
    if anchor is not None:
        assert (positions, hamming.used_positions(k, ks)) == (14, 10)
        assert (int(cnt[-1]), int(rep[-1])) == (1, int(anchor))


@pytest.mark.parametrize("length", [31, 32])
def test_k5_has_no_kept_padding_fault(length):
    """The reference pads the kept table with the all-C 32-base code,
    which lies within distance 1 of the all-C 31- and 32-base queries:
    in interpret mode it counts 1021 padding neighbours for them.  The
    port's K5 reads no padding and finds none."""
    kept = np.array([0, 12345, 99999], np.uint64)
    query = np.array([_all_c(length)], np.uint64)
    p_cnt, p_rep = find_neighbors_pallas(query, kept, length, interpret=True)
    assert (int(p_cnt[0]), int(p_rep[0])) == (1021, int(REF_KEPT_PAD))
    cnt, rep = hamming.find_neighbors_brute(query, kept, CPU)
    assert (int(cnt[0]), int(rep[0])) == (0, 0)
    h_cnt, _ = ref_bc.find_neighbors_batch(query, kept, length)
    assert int(h_cnt[0]) == 0


@pytest.mark.parametrize("nq,nk", [(0, 5), (5, 0), (0, 0)])
def test_k5_empty_inputs(nq, nk):
    cnt, rep = hamming.find_neighbors_brute(np.arange(nq, dtype=np.uint64),
                                            np.arange(nk, dtype=np.uint64), CPU)
    assert cnt.dtype == np.int64 and rep.dtype == np.uint64
    assert len(cnt) == len(rep) == nq and not cnt.any() and not rep.any()


@pytest.mark.parametrize("mode,kernel", [
    (None, "K4"), ("auto", "K4"), ("mxu", "K4"), ("pallas", "K5"),
])
def test_rescue_backend_dispatch(mode, kernel, monkeypatch):
    """AFT_RESCUE_BACKEND picks K4 or K5 as the reference's dispatcher
    does; both give the same answer."""
    if mode is None:
        monkeypatch.delenv("AFT_RESCUE_BACKEND", raising=False)
    else:
        monkeypatch.setenv("AFT_RESCUE_BACKEND", mode)
    queries, kept = _case(16, 3)
    calls = []
    for key, name in (("K4", "neighbor_counts"), ("K5", "neighbor_counts_brute")):
        real = getattr(hamming, name)
        monkeypatch.setattr(hamming, name,
                            lambda *a, _k=key, _r=real: calls.append(_k) or _r(*a))
    cnt, rep = barcodes.find_neighbors(queries, np.sort(kept), 16, CPU)
    assert calls == [kernel]
    h_cnt, h_rep = ref_bc.find_neighbors_batch(queries, np.sort(kept), 16)
    np.testing.assert_array_equal(cnt, h_cnt)
    np.testing.assert_array_equal(rep[h_cnt > 0], h_rep[h_cnt > 0])


@pytest.mark.parametrize("mode", ["host", "jax"])
def test_rescue_backend_host_engines_raise(mode, monkeypatch):
    monkeypatch.setenv("AFT_RESCUE_BACKEND", mode)
    with pytest.raises(ValueError, match="--device cpu"):
        barcodes.find_neighbors(np.ones(2, np.uint64), np.ones(2, np.uint64), 16, CPU)


def test_revcomp_matches_reference():
    rng = np.random.RandomState(2)
    for length in (8, 16, 32):
        bcs = rng.randint(0, 1 << 63, 100, dtype=np.uint64) * np.uint64(3)
        bcs &= np.uint64((1 << (2 * length)) - 1) if length < 32 else np.uint64(2**64 - 1)
        np.testing.assert_array_equal(barcodes.revcomp_packed(bcs, length),
                                      ref_bc.revcomp_packed(bcs, length))
