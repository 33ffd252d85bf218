"""The port's cr-like WTA resolver (alevin_fry_tpu_torch/ops/crlike_device.py)
on the CPU against the reference's ``resolve_crlike_wta_device`` and its
host resolver, in plain and USA mode; the key converters of
alevin_fry_tpu_torch/interop.py; and keys past the 62 bits of one packed word.

Keys come from numpy seeds (UMIs from ``synth.make_packed_bc``); the
outputs are integer counts, so every comparison is exact equality.
"""

import numpy as np
import pytest
import torch

from alevin_fry_tpu.ops import crlike as ref_crlike
from alevin_fry_tpu.ops.crlike_device import PAD, resolve_crlike_wta_device as ref_wta
from alevin_fry_tpu_torch import interop
from alevin_fry_tpu_torch.ops import crlike
from alevin_fry_tpu_torch.ops.crlike_device import resolve_crlike_wta_device
from synth import make_packed_bc


def _keys(seed, n_cells, n_genes, n_umis, n_pairs, usa):
    rng = np.random.RandomState(seed)
    c = np.sort(rng.randint(0, n_cells, n_pairs)).astype(np.uint64)
    u = np.asarray(
        [make_packed_bc(int(i), 6) for i in rng.randint(0, n_umis, n_pairs)], np.uint64
    )
    g = rng.randint(0, (2 if usa else 1) * n_genes, n_pairs).astype(np.uint64)
    ubits = crlike._bits_for(int(u.max()) + 1)
    gbits = crlike._bits_for(int(g.max()) + 1)
    key = (c << np.uint64(ubits + gbits)) | (u << np.uint64(gbits)) | g
    return c, u, g, key, ubits, gbits


def _host_counts(c, u, g, n_cells, num_rows, usa):
    groups = ref_crlike.resolve_crlike(
        c, u, g.astype(np.uint32), np.arange(len(c) + 1, dtype=np.int64),
        np.arange(int(g.max()) + 1, dtype=np.uint32),
    )
    slots = (
        ref_crlike.usa_slots_for_groups(groups, num_rows) if usa
        else ref_crlike.nonusa_unique_slots(groups)
    )
    return ref_crlike.counts_from_slots(groups.cell, *slots, n_cells, num_rows)


@pytest.mark.parametrize("usa", [False, True])
@pytest.mark.parametrize("seed,n_umis", [(0, 1 << 10), (1, 64), (2, 16), (3, 4)])
def test_wta_matches_reference(usa, seed, n_umis):
    n_cells, n_genes = 25, 9
    num_rows = 3 * (n_genes + 1) if usa else n_genes
    num_rows -= num_rows % 3 if usa else 0
    c, u, g, key, ubits, gbits = _keys(seed, n_cells, n_genes, n_umis, 3000, usa)
    got = resolve_crlike_wta_device(
        interop.keys_to_torch(key), ubits, gbits, num_rows, usa=usa
    )
    want = ref_wta(key, ubits, gbits, num_rows, usa=usa)
    host = _host_counts(c, u, g, n_cells, num_rows, usa)
    for a, b, h in zip(got, want, host):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, h)
    assert got[2].dtype == np.float32 and len(got[0]) > 0


def test_wta_empty_keys():
    r, c, v = resolve_crlike_wta_device(torch.zeros(0, dtype=torch.int64), 4, 4, 10)
    assert len(r) == len(c) == len(v) == 0 and v.dtype == np.float32


def test_wta_counts_device_matches_reference_from_reads():
    """From reads: per-read gene dedup, key packing and resolution."""
    rng = np.random.RandomState(9)
    n_reads, n_txps = 2000, 40
    nal = rng.randint(1, 4, n_reads)
    offs = np.concatenate([[0], np.cumsum(nal)]).astype(np.int64)
    refs = rng.randint(0, n_txps, int(offs[-1])).astype(np.uint32)
    cell = np.sort(rng.randint(0, 30, n_reads)).astype(np.int64)
    umi = rng.randint(0, 50, n_reads).astype(np.uint64)
    t2g = (np.arange(n_txps) // 2).astype(np.uint32)
    got = crlike.wta_counts_device(cell, umi, refs, offs, t2g, 20, torch.device("cpu"))
    want = ref_crlike.wta_counts_device(cell, umi, refs, offs, t2g, 20)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _host_from_reads(cell, umi, refs, offs, t2g, n_rows, usa=False):
    """The reference's host resolution (``resolve_crlike`` and its
    slotting), which takes keys of any width."""
    groups = ref_crlike.resolve_crlike(cell, umi, refs, offs, t2g)
    slots = (ref_crlike.usa_slots_for_groups(groups, n_rows) if usa
             else ref_crlike.nonusa_unique_slots(groups))
    return ref_crlike.counts_from_slots(groups.cell, *slots, int(cell.max()) + 1, n_rows)


def _count_word_path(monkeypatch) -> list:
    calls = []
    real = crlike.resolve_crlike_wta_words
    monkeypatch.setattr(crlike, "resolve_crlike_wta_words",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_keys_over_63_bits_raise(monkeypatch):
    """Keys past 62 bits (here 41 + 21 + 21) resolve on the word path,
    as the reference's host path resolves them; only the packed keys'
    converter refuses keys from INT64_MAX up."""
    words = _count_word_path(monkeypatch)
    cell = np.asarray([0, 1 << 40], np.int64)
    umi = np.asarray([1 << 20, 3], np.uint64)
    offs = np.arange(3, dtype=np.int64)
    refs = np.asarray([0, 1], np.uint32)
    t2g = np.asarray([0, (1 << 20) + 5], np.uint32)
    n_rows = (1 << 20) + 6
    got = crlike.wta_counts_device(cell, umi, refs, offs, t2g, n_rows, torch.device("cpu"))
    for a, b in zip(got, _host_from_reads(cell, umi, refs, offs, t2g, n_rows)):
        np.testing.assert_array_equal(a, b)
    assert got[0].tolist() == [0, 1 << 40] and len(words) == 1
    for key in (1 << 63, (1 << 63) - 1):
        with pytest.raises(ValueError, match="INT64_MAX"):
            interop.keys_to_torch(np.asarray([key], np.uint64))


@pytest.mark.parametrize("gene_bits", [20, 21])
def test_key_budget_edge(gene_bits, monkeypatch):
    """Cell, UMI and gene fields all at their maximum: at 21 + 21 + 20
    bits the key packs into one word below the padding, at 63 bits it
    goes as three words; both match the reference."""
    words = _count_word_path(monkeypatch)
    top = (1 << 21) - 1
    cell = np.asarray([0, top], np.int64)
    umi = np.asarray([5, top], np.uint64)
    offs = np.arange(3, dtype=np.int64)
    refs = np.asarray([0, 1], np.uint32)
    t2g = np.asarray([0, (1 << gene_bits) - 1], np.uint32)
    n_rows = 1 << gene_bits
    args = (cell, umi, refs, offs, t2g, n_rows)
    got = crlike.wta_counts_device(*args, torch.device("cpu"))
    wants = [_host_from_reads(*args)]
    if gene_bits == 20:
        wants.append(ref_crlike.wta_counts_device(*args))
    for want in wants:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert got[0].tolist() == [0, top] and got[1].tolist() == [0, n_rows - 1]
    assert len(words) == (gene_bits == 21)


# (cell, UMI, gene) bits; "umi bit 63" has 32-base UMIs, which use bit 63
WIDE_KEYS = {"62": (10, 40, 12), "63": (10, 41, 12), "64": (8, 44, 12),
             "70": (3, 64, 3), "umi bit 63": (10, 64, 12)}


def _wide_reads(seed, cbits, ubits, gbits, n=3000):
    """Reads of one alignment each, every field reaching its top bit; a
    pool of 24 UMIs per run of cells, so (cell, UMI) groups hold several
    genes and ties."""
    rng = np.random.RandomState(seed)
    cell = np.sort(rng.randint(0, 1 << cbits, n)).astype(np.int64)
    cell[-1] = (1 << cbits) - 1
    hi = np.uint64(1 << (ubits - 1))
    pool = rng.randint(0, 1 << 62, 24, dtype=np.uint64) % hi | hi
    umi = pool[rng.randint(0, len(pool), n)]
    gene = rng.randint(0, 1 << gbits, n).astype(np.uint32)
    gene[rng.randint(0, n, 5)] = (1 << gbits) - 1
    return cell, umi, gene


@pytest.mark.parametrize("usa", [False, True])
@pytest.mark.parametrize("case", list(WIDE_KEYS))
def test_wide_keys_match_reference_host(case, usa, monkeypatch):
    """At 62 bits and past it, with UMIs up to 64 bits: the port's counts
    equal the reference's host resolution; 62 bits packs, more goes as
    three words."""
    words = _count_word_path(monkeypatch)
    cbits, ubits, gbits = WIDE_KEYS[case]
    cell, umi, gene = _wide_reads(cbits + ubits + gbits, cbits, ubits, gbits)
    assert crlike._bits_for(int(umi.max()) + 1) == ubits
    gmax = int(gene.max())
    n_rows = 3 * (gmax // 2 + 1) if usa else gmax + 1
    args = (cell, umi, gene, np.arange(len(cell) + 1, dtype=np.int64),
            np.arange(gmax + 1, dtype=np.uint32), n_rows)
    got = crlike.wta_counts_device(*args, torch.device("cpu"), usa=usa)
    want = _host_from_reads(*args, usa=usa)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > 40 and len(words) == (case != "62")


def test_key_converters_round_trip():
    keys = np.asarray([0, 5, (1 << 63) - 2, PAD, 7, PAD], np.uint64)
    t = interop.keys_to_torch(keys)
    assert t.dtype == torch.int64
    assert t.tolist()[3] == t.tolist()[5] == interop.I64_PAD
    # PAD sorts last under the signed sort, as it does unsigned
    assert torch.sort(t).values.tolist()[-2:] == [interop.I64_PAD] * 2
    np.testing.assert_array_equal(interop.keys_from_torch(t), keys)


def test_barcode_converters_round_trip():
    bcs = np.asarray([0, 1, 0xFFFFFFFFFFFFFFFF, 1 << 63, 0x5555], np.uint64)
    t = interop.barcodes_to_torch(bcs)
    assert t.dtype == torch.int64 and t.tolist()[3] < 0
    np.testing.assert_array_equal(interop.barcodes_from_torch(t), bcs)
