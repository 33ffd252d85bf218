"""The port's EM (alevin_fry_tpu_torch/ops/em.py: the layout of kernel K6
and its plain twin, which runs here on the CPU), its host resolutions
(ops/crlike.py), the prefer-ambig device WTA (ops/crlike_device.py), the
codec bindings the dump uses and the fractional MTX writer, each against
the JAX package's function on the same inputs.

The EM twin must equal the native host EM (``em_cells_batched(...,
use_jax=False)``, which equals the per-cell NumPy EM bit for bit) in
every bit of every value: it adds in the same order.  Against the JAX
package's own device program (the compact kernel on JAX-CPU, which sums
in another order) the values agree within rtol = atol = 2e-4, that
package's own tolerance between its device EM and NumPy
(tests/test_em.py).  Everything else is integers and bytes: exact.
"""

import numpy as np
import pytest
import torch

from alevin_fry_tpu.ops import crlike as ref_crlike
from alevin_fry_tpu.ops.em import em_cells_batched
from alevin_fry_tpu.radz import _native as ref_native
from alevin_fry_tpu.radz import mtx as ref_mtx
from alevin_fry_tpu_torch import interop
from alevin_fry_tpu_torch.ops import crlike, em
from alevin_fry_tpu_torch.ops.crlike_device import (
    resolve_crlike_wta_device, resolve_crlike_wta_words,
)
from alevin_fry_tpu_torch.radz import _native, mtx
from em_cases import em_batch, em_case, usa_offsets

CPU = torch.device("cpu")
R_PLAIN, USA = 12, (4, 8)


def assert_bit_equal(got, want):
    assert len(got) == len(want)
    for ci, ((gi, gv), (wi, wv)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gi, wi, err_msg=f"cell {ci} support")
        np.testing.assert_array_equal(np.asarray(gv, np.float32).view(np.int32),
                                      np.asarray(wv, np.float32).view(np.int32),
                                      err_msg=f"cell {ci} values")


@pytest.mark.parametrize("zero_len", [False, True])
@pytest.mark.parametrize("init_uniform", [False, True])
@pytest.mark.parametrize("with_last_round", [True, False])
@pytest.mark.parametrize("usa", [None, USA])
def test_em_twin_bit_identical_to_native_host_em(usa, with_last_round, init_uniform, zero_len):
    batch = em_batch(11 + zero_len, zero_len=zero_len)
    got = em.em_cells(*batch, R_PLAIN, usa, init_uniform, with_last_round, CPU)
    want = em_cells_batched(*batch, R_PLAIN, usa, init_uniform, with_last_round, use_jax=False)
    assert_bit_equal(got, want)
    assert got[-2][0].size == 0 and list(got[-3][0]) == [0, 2]
    plan = em.plan_cells(*batch, R_PLAIN, usa, init_uniform, with_last_round)
    assert int(em.em_run_twin(plan.to(CPU))[1][-1]) == 100  # the last cell runs to the cap


@pytest.mark.parametrize("usa", [False, True])
def test_em_twin_on_a_cell_past_shared_memory(usa):
    """The card tests' global-route case (one cell of 30,000 classes over
    60,000 ids): the twin still equals the native host EM."""
    batch, n_rows = em_case("global-route")
    offs = usa_offsets(n_rows) if usa else None
    assert_bit_equal(em.em_cells(*batch, n_rows, offs, False, usa, CPU),
                     em_cells_batched(*batch, n_rows, offs, False, usa, use_jax=False))


@pytest.mark.parametrize("usa", [None, USA])
def test_em_twin_without_native_codec(usa, monkeypatch):
    """The reference's host EM without its native codec (its pure-NumPy
    path): the twin's floats, bit for bit."""
    batch = em_batch(5, zero_len=True)
    got = em.em_cells(*batch, R_PLAIN, usa, False, True, CPU)
    monkeypatch.setattr(ref_native, "_LIB", None)
    monkeypatch.setattr(ref_native, "_TRIED", True)
    assert not ref_native.available()
    assert_bit_equal(got, em_cells_batched(*batch, R_PLAIN, usa, False, True, use_jax=False))


@pytest.mark.parametrize("with_last_round", [True, False])
@pytest.mark.parametrize("usa", [None, USA])
def test_em_twin_matches_jax_device_program(usa, with_last_round):
    batch = em_batch(42, n_cells=17)
    got = em.em_cells(*batch, R_PLAIN, usa, False, with_last_round, CPU)
    want = em_cells_batched(*batch, R_PLAIN, usa, False, with_last_round, use_jax=True)
    for ci, ((gi, gv), (wi, wv)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gi, wi, err_msg=f"cell {ci} support")
        np.testing.assert_allclose(gv, wv, rtol=2e-4, atol=2e-4, err_msg=f"cell {ci} values")


def test_em_plan_layout():
    """Dictionaries hold the touched ids and their USA partners; each
    id's occurrence list holds its single-label classes, then its
    multi-label ones, in class order."""
    ceo, lo = np.array([0, 3]), np.array([0, 2, 3, 5])
    labels = np.array([1, 8, 1, 5, 9], np.uint32)  # classes {1, 8}, {1}, {5, 9}
    plan = em.plan_cells(ceo, lo, labels, np.array([4, 2, 7], np.uint32), 12, USA, False, True)
    # 1 (spliced) pairs with 9, 5 (unspliced) with 9; 8 and 9 (ambiguous)
    # with 4, 0 and 5, 1
    np.testing.assert_array_equal(plan.dict_id, [0, 1, 4, 5, 8, 9])
    np.testing.assert_array_equal(plan.lab_loc, [1, 4, 1, 3, 5])
    np.testing.assert_array_equal(plan.p1, [-1, 5, -1, 5, 2, 3])
    np.testing.assert_array_equal(plan.p2, [-1, -1, -1, -1, 0, 1])
    np.testing.assert_array_equal(plan.occ_off, [0, 0, 2, 2, 3, 4, 5])
    np.testing.assert_array_equal(plan.occ, [~1, 0, 2, 0, 2])


def _reads(seed, n_cells=30, n_reads=3000, n_txp=40, usa=False):
    """Cell-grouped reads of 1-3 alignments over transcripts whose gene
    map puts 4 transcripts on a gene (USA: interleaved ids)."""
    rng = np.random.RandomState(seed)
    cell = np.sort(rng.randint(0, n_cells, n_reads)).astype(np.int64)
    umi = rng.randint(0, 12, n_reads).astype(np.uint64)
    nal = rng.randint(1, 4, n_reads)
    offs = np.concatenate(([0], np.cumsum(nal))).astype(np.int64)
    refs = rng.randint(0, n_txp, int(offs[-1])).astype(np.uint32)
    t2g = (np.arange(n_txp) // (2 if usa else 4)).astype(np.uint32)
    return cell, umi, refs, offs, t2g


def _same_groups(a, b):
    for f in ("cell", "umi", "label_offsets", "labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("prefer_ambig", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_resolutions_match_reference(seed, prefer_ambig):
    """resolve_crlike (both tie rules), group_eqclasses,
    usa_transform_labels and the USA slots."""
    reads = _reads(seed, usa=True)
    got = crlike.resolve_crlike(*reads, prefer_ambig=prefer_ambig)
    want = ref_crlike.resolve_crlike(*reads, prefer_ambig=prefer_ambig)
    _same_groups(got, want)
    geq, weq = crlike.group_eqclasses(got), ref_crlike.group_eqclasses(want)
    for f in ("cell_ids", "cell_eq_offsets", "label_offsets", "labels", "counts"):
        np.testing.assert_array_equal(getattr(geq, f), getattr(weq, f), err_msg=f)
    num_rows = 30
    for a, b in zip(crlike.usa_transform_labels(geq.label_offsets, geq.labels, num_rows),
                    ref_crlike.usa_transform_labels(weq, num_rows)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(crlike.usa_slots_for_groups(got, num_rows),
                    ref_crlike.usa_slots_for_groups(want, num_rows)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_resolve_trivial_matches_reference(seed):
    reads = _reads(seed, n_reads=5000)
    got = crlike.resolve_trivial(*reads, 30, 10)
    want = ref_crlike.resolve_trivial(*reads, 30, 10)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert 0 < float(got[3].max()) < 1  # some UMIs reach several genes


@pytest.mark.parametrize("words", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prefer_ambig_device_wta_matches_reference_host(seed, words):
    """The gene-pair WTA on the CPU device, packed and three-word keys,
    against the reference's host tie sets -> USA slot counts."""
    rng = np.random.RandomState(seed)
    n, n_cells, n_genes, num_rows = 4000, 20, 14, 21
    c = np.sort(rng.randint(0, n_cells, n)).astype(np.uint64)
    u = rng.randint(0, 1 << (seed + 2), n).astype(np.uint64)
    g = rng.randint(0, n_genes, n).astype(np.uint64)
    groups = ref_crlike.resolve_crlike(
        c.astype(np.int64), u, g.astype(np.uint32), np.arange(n + 1, dtype=np.int64),
        np.arange(n_genes, dtype=np.uint32), prefer_ambig=True,
    )
    want = ref_crlike.counts_from_slots(
        groups.cell, *ref_crlike.usa_slots_for_groups(groups, num_rows), n_cells, num_rows)
    ubits = crlike._bits_for(int(u.max()) + 1)
    gbits = crlike._bits_for(int(g.max()) + 1)
    if words:
        got = resolve_crlike_wta_words(
            *(torch.from_numpy(x.astype(np.int64)) for x in (c, u, g)), gbits, num_rows,
            usa=True, prefer_ambig=True)
    else:
        key = (c << np.uint64(ubits + gbits)) | (u << np.uint64(gbits)) | g
        got = resolve_crlike_wta_device(interop.keys_to_torch(key), ubits, gbits, num_rows,
                                        usa=True, prefer_ambig=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    plain = resolve_crlike_wta_device(
        interop.keys_to_torch((c << np.uint64(ubits + gbits)) | (u << np.uint64(gbits)) | g),
        ubits, gbits, num_rows, usa=True)
    assert not all(np.array_equal(a, b) for a, b in zip(plain, want))


FRACTIONS = np.array([0.5, 1 / 3, 1e-7, 123456.79, 0.0099999, 0.01, 0.0100001, 3.0, 0.0,
                      2.5e6, 16777217.0, 7.0], np.float32)


@pytest.mark.parametrize("native", [True, False])
def test_fractional_mtx_matches_reference(tmp_path, monkeypatch, native):
    """The fractional MTX writer (the EM's output): the reference's bytes,
    the reference writing through its native codec and through its NumPy
    path."""
    rows = np.arange(len(FRACTIONS)) // 3
    cols = np.arange(len(FRACTIONS)) * 7 % 11
    if not native:
        monkeypatch.setattr(ref_native, "_LIB", None)
        monkeypatch.setattr(ref_native, "_TRIED", True)
    body = mtx.format_mtx_body(rows, cols, FRACTIONS)
    assert body == ref_mtx.format_mtx_body(rows, cols, FRACTIONS)
    assert body.startswith(b"1 1 0.5\n1 8 0.33333334\n1 4 0.0000001\n")
    mtx.write_matrix_market(tmp_path / "a.mtx", rows, cols, FRACTIONS, (4, 11))
    ref_mtx.write_matrix_market(tmp_path / "b.mtx", rows, cols, FRACTIONS, (4, 11))
    assert (tmp_path / "a.mtx").read_bytes() == (tmp_path / "b.mtx").read_bytes()
    r, c, v, shape = mtx.read_matrix_market(tmp_path / "a.mtx")
    for a, b in zip((r, c, v, shape), ref_mtx.read_matrix_market(tmp_path / "b.mtx")):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(v.astype(np.float32), FRACTIONS)


def test_dump_bindings_match_reference():
    """intern_label_sets, format_eqc_rows and sort_u64_segments: the
    reference's bindings of the same library."""
    rng = np.random.RandomState(4)
    offs = np.concatenate(([0], np.cumsum(rng.randint(1, 4, 500)))).astype(np.int64)
    labels = rng.randint(0, 6, int(offs[-1])).astype(np.uint64)
    for a, b in zip(_native.intern_label_sets(labels, offs),
                    ref_native.intern_label_sets(labels, offs)):
        np.testing.assert_array_equal(a, b)
    body = _native.format_eqc_rows(labels, offs)
    assert body == ref_native.format_eqc_rows(labels, offs)
    assert body.split(b"\n")[0] == b"\t".join(b"%d" % x for x in labels[:offs[1]]) + b"\t0"
    keys = rng.randint(0, 1 << 62, 10_000).astype(np.uint64)
    seg = np.array([0, 10, 5000, 10_000], np.int64)
    got = _native.sort_u64_segments(keys.copy(), seg)
    np.testing.assert_array_equal(got, ref_native.sort_u64_segments(keys.copy(), seg))
    np.testing.assert_array_equal(got[10:5000], np.sort(keys[10:5000]))
