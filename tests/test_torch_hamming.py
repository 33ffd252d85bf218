"""The port's Hamming<=1 rescue search (alevin_fry_tpu_torch/ops/hamming.py,
the wrapper of kernel K4) on the CPU, where it runs the plain PyTorch
probe twin, against the one-hot and brute-force twins, the reference's
MXU kernel in interpret mode and its host search; and the lengths K4
does not take, which go to K5 (tests/test_torch_hamming_brute.py has K5
itself).

Inputs come from numpy seeds and the outputs are integers, so every
comparison is exact equality.
"""

import numpy as np
import pytest
import torch

from alevin_fry_tpu.ops import barcodes as ref_bc
from alevin_fry_tpu.ops.pallas_hamming import find_neighbors_mxu, find_neighbors_pallas
from alevin_fry_tpu_torch.interop import barcodes_to_torch
from alevin_fry_tpu_torch.ops import barcodes, hamming
from hamming_cases import PROBE_CASES, probe_case

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _port_rescue_env(monkeypatch):
    """The port reads AFT_RESCUE_BACKEND, where ``host`` raises.  A
    reference test module imported into the same process may have set
    it for the reference's goldens, so each test starts without it."""
    monkeypatch.delenv("AFT_RESCUE_BACKEND", raising=False)


def _case(length, seed):
    rng = np.random.RandomState(seed)
    full = np.uint64((1 << (2 * length)) - 1) if length < 32 else np.uint64(0xFFFFFFFFFFFFFFFF)
    draw = lambda k: rng.randint(0, 1 << 63, k, dtype=np.uint64) * np.uint64(3) & full
    kept = np.unique(np.concatenate([draw(400), np.zeros(1, np.uint64)]))
    pos = rng.randint(0, length, 200).astype(np.uint64)
    flip = np.uint64(1) + rng.randint(0, 3, 200).astype(np.uint64)
    mutants = kept[rng.randint(0, len(kept), 200)] ^ (flip << (np.uint64(2) * pos))
    queries = np.concatenate([
        kept[rng.randint(0, len(kept), 100)], mutants, draw(100),
        np.zeros(1, np.uint64),  # the all-A barcode
    ])
    if length == 32:
        assert (queries >> np.uint64(63)).any() and (kept >> np.uint64(63)).any()
    return queries, kept


@pytest.mark.parametrize("length", [10, 16, 24, 32])
def test_rescue_search_matches_mxu_and_host(length):
    queries, kept = _case(length, length)
    cnt, rep = barcodes.find_neighbors(queries, kept, length, CPU)
    m_cnt, m_rep = find_neighbors_mxu(queries, kept, length, interpret=True)
    h_cnt, h_rep = ref_bc.find_neighbors_batch(queries, kept, length)
    np.testing.assert_array_equal(cnt, m_cnt)
    np.testing.assert_array_equal(rep, m_rep)
    np.testing.assert_array_equal(cnt, h_cnt)
    hit = h_cnt > 0
    np.testing.assert_array_equal(rep[hit], h_rep[hit])
    assert (cnt == 1).any() and (cnt == 0).any()


@pytest.mark.parametrize("nq,nk", [(0, 5), (5, 0), (0, 0)])
def test_rescue_search_empty_inputs(nq, nk):
    q = np.arange(nq, dtype=np.uint64)
    k = np.arange(nk, dtype=np.uint64)
    cnt, rep = barcodes.find_neighbors(q, k, 16, CPU)
    assert cnt.dtype == np.int64 and rep.dtype == np.uint64
    assert len(cnt) == len(rep) == nq and not cnt.any() and not rep.any()


@pytest.mark.parametrize("kind", PROBE_CASES)
def test_probe_twin_matches_brute_twins_and_reference(kind):
    """The probe twin (the kernels' algorithm in plain PyTorch, which the
    K4 wrapper runs for CPU tensors) equals the one-hot twin, K5's brute
    twin, the reference's MXU kernel in interpret mode and its host
    search.  The host search counts a duplicated kept code once, so it
    is held to the hits and their codes there."""
    queries, kept, length = probe_case(kind)
    q, k = barcodes_to_torch(queries), barcodes_to_torch(kept)
    cnt, idx = hamming.neighbor_counts(q, k, length)
    for want in (hamming.neighbor_probe_twin(q, k, length),
                 hamming.neighbor_counts_twin(q, k, length)):
        assert torch.equal(cnt, want[0]) and torch.equal(idx, want[1])
    b_cnt, b_rep = hamming.neighbor_counts_brute_twin(q, k)
    hit = cnt > 0
    assert torch.equal(cnt, b_cnt) and torch.equal(b_rep[hit], k[idx[hit].long()])
    assert bool((b_rep[~hit] == -1).all()) and bool((idx[~hit] == hamming.I32_MAX).all())
    rep = np.where(hit.numpy(), kept[np.minimum(idx.numpy(), len(kept) - 1)], np.uint64(0))
    m_cnt, m_rep = find_neighbors_mxu(queries, kept, length, interpret=True)
    np.testing.assert_array_equal(cnt.numpy(), m_cnt)
    np.testing.assert_array_equal(rep, m_rep)
    h_cnt, h_rep = ref_bc.find_neighbors_batch(queries, np.unique(kept), length)
    np.testing.assert_array_equal(hit.numpy(), h_cnt > 0)
    np.testing.assert_array_equal(rep[h_cnt > 0], h_rep[h_cnt > 0])
    if kind != "duplicates":
        np.testing.assert_array_equal(cnt.numpy(), h_cnt)
    else:
        assert (cnt.numpy() > h_cnt).any()
    assert bool((cnt == 1).any()) and (kind == "query_is_kept" or bool((cnt == 0).any()))
    if kind == "query_is_kept":
        assert bool((cnt > 1).any()) and bool((cnt >= 1).all())


def test_twin_chunks_agree_with_one_block(monkeypatch):
    queries, kept = _case(12, 3)
    q = torch.from_numpy(queries.view(np.int64))
    k = torch.from_numpy(kept.view(np.int64))
    whole = hamming.neighbor_counts_twin(q, k, 12), hamming.neighbor_probe_twin(q, k, 12)
    monkeypatch.setattr(hamming, "_TWIN_BLOCK_ELEMS", 7 * len(kept))
    monkeypatch.setattr(hamming, "_PROBE_TWIN_BLOCK_ELEMS", 7 * 37)
    chunked = hamming.neighbor_counts_twin(q, k, 12), hamming.neighbor_probe_twin(q, k, 12)
    for w, c in zip(whole, chunked):
        for a, b in zip(w, c):
            assert torch.equal(a, b)


@pytest.mark.parametrize("length", [1, 33])
def test_rescue_lengths_outside_k4_raise(length, monkeypatch):
    """Lengths outside K4's 2..32 no longer raise: they reach K5 and
    equal the reference's brute-force kernel in interpret mode.  A
    33-base barcode does not fit a 64-bit 2-bit code; both packages
    compare the words they are given."""
    rng = np.random.RandomState(length)
    if length == 1:
        kept = np.array([2, 1 << 10], np.uint64)
        queries = np.arange(4, dtype=np.uint64)
    else:
        kept = rng.randint(0, 1 << 63, 300, dtype=np.uint64) * np.uint64(3)
        flips = np.uint64(1) << (np.uint64(2) * rng.randint(0, 32, 100).astype(np.uint64))
        queries = np.concatenate([kept[:50], kept[50:150] ^ flips,
                                  rng.randint(0, 1 << 63, 50, dtype=np.uint64)])
    # no query lies within distance 1 of the reference's kept padding
    pad = np.uint64(0x5555555555555555)
    assert (ref_bc.hamming_2bit(queries, np.full(len(queries), pad)) > 1).all()
    calls = []
    monkeypatch.setattr(hamming, "neighbor_counts", lambda *a: calls.append("K4"))
    cnt, rep = barcodes.find_neighbors(queries, kept, length, CPU)
    assert calls == []
    p_cnt, p_rep = find_neighbors_pallas(queries, kept, length, interpret=True)
    np.testing.assert_array_equal(cnt, p_cnt)
    np.testing.assert_array_equal(rep, p_rep)
    assert (cnt == 1).any()


def test_pack_unpack_match_reference():
    rng = np.random.RandomState(0)
    seqs = ["".join(rng.choice(list("ACGTN"), 16)) for _ in range(50)]
    np.testing.assert_array_equal(barcodes.pack_seqs(seqs), ref_bc.pack_seqs(seqs))
    packed = ref_bc.pack_seqs(seqs)
    assert barcodes.unpack_seqs_to_strings(packed, 16) == ref_bc.unpack_seqs_to_strings(packed, 16)
    assert [barcodes.pack_seq(s) for s in seqs] == [ref_bc.pack_seq(s) for s in seqs]
    assert barcodes.unpack_seq(int(packed[0]), 16) == ref_bc.unpack_seq(int(packed[0]), 16)
