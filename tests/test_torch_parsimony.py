"""The port's parsimony resolutions (``-r parsimony``, ``parsimony-em``,
``parsimony-gene``, ``parsimony-gene-em``) through its CLI with
``--device cpu``, against the reference package's host path
(tests/reference_host_path.py, which resolves the graphs with the native
monolithic resolver) on the same collated data, and the pieces under
them against their JAX-package counterparts.

* quant on ``synth_hard`` data (5% of reads with a one-base UMI error)
  in USA and plain mode, with ``--umi-edit-dist`` 0 and 1, a small
  ``--large-graph-thresh`` (so some cells take the cr-like fallback and
  quant.json lists them) and ``-d``, in one block and in many; without
  the native codec the port refuses (it never resolves a short-read
  graph on the host);
* long-read records (alignment scores and 3' distances), through gpl,
  collate and quant ``-r parsimony`` / ``parsimony-em`` (the weighted
  EM): the dataset of tests/test_longread.py and a seeded larger one,
  and the collate's bytes against the reference with and without its
  native codec;
* K7's twin against ``connected_components_batched`` (dense and gather),
  ``_host_cc_labels`` and a union-find, on random graphs and on the
  graphs the native graph build exports;
* the weighted EM's twin against the reference's host EM, and its
  denominators' order against NumPy's own row sums.

Every artifact is compared byte for byte (the EM values are
bit-identical) and quant.json field for field without its directory
fields.  Data comes from numpy seeds.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from alevin_fry_tpu.ops import pug as ref_pug
from alevin_fry_tpu.ops.em import class_weights_from_prob_rows as ref_class_weights
from alevin_fry_tpu.ops.em import em_cells_batched, em_optimize_weighted_cell_np
from alevin_fry_tpu.ops.pug_device import connected_components_batched, pack_adjacency
from alevin_fry_tpu.pipeline.collate import collate as ref_collate
from alevin_fry_tpu.pipeline.gpl import CellFilterMethod, GenPermitListOpts
from alevin_fry_tpu.pipeline.gpl import generate_permit_list as ref_gpl
from alevin_fry_tpu.radz import _native as ref_native
from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.ops import em, pug, pug_device
from alevin_fry_tpu_torch.pipeline import quant
from alevin_fry_tpu_torch.radz import _native
from alevin_fry_tpu_torch.radz.chunkio import iter_decoded_blocks
from alevin_fry_tpu_torch.pipeline.collate import open_collated
from alevin_fry_tpu_torch.radz.records import RecordSchema
from em_cases import weighted_case
from pug_cases import PUG_CASES, csr_from_edges, pug_case, union_find_labels
from reference_host_path import (
    DUMP_ARTIFACTS, QUANT_ARTIFACTS, comparable_json, host_policies, make_longread_dataset,
    run_reference_quant,
)
from synth_hard import make_hard_dataset
from test_longread import _dataset as longread_dataset
from test_torch_native import make_native_unloadable

DEV = ["-t", "2", "--device", "cpu"]

# name -> (the port's quant flags, the reference's quant options)
CASES = {
    "parsimony-d": (["-r", "parsimony", "-d"], {"resolution": "parsimony", "dump_eq": True}),
    "parsimony-em-d": (["-r", "parsimony-em", "-d"],
                       {"resolution": "parsimony-em", "dump_eq": True}),
    "gene": (["-r", "parsimony-gene"], {"resolution": "parsimony-gene"}),
    "gene-em-d": (["-r", "parsimony-gene-em", "-d"],
                  {"resolution": "parsimony-gene-em", "dump_eq": True}),
    "edit-0": (["-r", "parsimony", "--umi-edit-dist", "0"],
               {"resolution": "parsimony", "umi_edit_dist": 0}),
    "em-thresh-d": (["-r", "parsimony-em", "--large-graph-thresh", "2", "-d"],
                    {"resolution": "parsimony-em", "large_graph_thresh": 2, "dump_eq": True}),
}


@pytest.fixture(autouse=True)
def _port_rescue_env(monkeypatch):
    monkeypatch.delenv("AFT_RESCUE_BACKEND", raising=False)


@pytest.fixture
def cc_calls(monkeypatch):
    """The node counts of each call quant makes to K7's wrapper."""
    calls = []
    orig = pug_device.connected_components

    def spy(n_nodes, n_entries, deg, nbrs):
        calls.append(len(n_nodes))
        return orig(n_nodes, n_entries, deg, nbrs)

    monkeypatch.setattr(pug_device, "connected_components", spy)
    return calls


def _gpl_collate(d: Path, gpl: Path) -> None:
    assert port_main(["generate-permit-list", "-i", str(d / "rad"), "-d", "fw", "-o", str(gpl),
                      "-u", str(d / "permit.txt"), "-m", "10", *DEV]) == 0
    assert port_main(["collate", "-i", str(gpl), "-r", str(d / "rad"), *DEV]) == 0


@pytest.fixture(scope="module")
def collated(tmp_path_factory):
    """synth_hard data (300 cells, 60,000 reads, 5% UMI errors) collated
    by the port."""
    d = tmp_path_factory.mktemp("pars")
    make_hard_dataset(d, np.random.RandomState(29), n_cells=300, n_reads=60_000, n_genes=500,
                      umi_error_rate=0.05)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("AFT_RESCUE_BACKEND", raising=False)
        _gpl_collate(d, d / "gpl")
    return d, d / "gpl"


def _quant_both(gpl: Path, t2g: Path, tmp: Path, flags: list, ref_opts: dict) -> list:
    """The port's and the reference's quant on ``gpl``; returns the names
    of the artifacts that differ."""
    argv = ["quant", "-i", str(gpl), "-m", str(t2g), "-o", str(tmp / "port" / "quant"),
            *flags, *DEV]
    assert port_main(argv) == 0
    run_reference_quant(gpl, tmp / "ref" / "quant", t2g, "alevin-fry-tpu " + " ".join(argv), 2,
                        **ref_opts)
    names = QUANT_ARTIFACTS + (DUMP_ARTIFACTS if ref_opts.get("dump_eq") else ())
    bad = [n for n in names
           if (tmp / "port" / n).read_bytes() != (tmp / "ref" / n).read_bytes()]
    if comparable_json(tmp / "port/quant/quant.json") != comparable_json(
            tmp / "ref/quant/quant.json"):
        bad.append("quant/quant.json")
    return bad


def _quant_json(tmp: Path) -> dict:
    return comparable_json(tmp / "port" / "quant" / "quant.json")


@pytest.mark.parametrize("usa", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_parsimony_matches_reference(collated, tmp_path, cc_calls, name, usa):
    d, gpl = collated
    flags, ref_opts = CASES[name]
    assert _quant_both(gpl, d / ("t2g_3col.tsv" if usa else "t2g.tsv"), tmp_path, flags,
                       ref_opts) == []
    assert len(cc_calls) == 1  # one block: the split path ran once
    qj = _quant_json(tmp_path)
    assert qj["usa_mode"] == usa
    assert bool(qj["alt_resolved_cell_numbers"]) == (name == "em-thresh-d")
    if name == "parsimony-em-d":
        body = (tmp_path / "port/quant/alevin/quants_mat.mtx").read_text().splitlines()[3:]
        assert any("." in line.split()[2] for line in body)  # EM fractions


def test_parsimony_in_small_blocks(collated, tmp_path, monkeypatch, cc_calls):
    """Many streamed blocks: the fallback cells are numbered over the
    whole file, and the merged artifacts are the reference's."""
    d, gpl = collated
    monkeypatch.setattr(quant, "QUANT_BLOCK_RECORDS", 8_000)
    assert _quant_both(gpl, d / "t2g_3col.tsv", tmp_path, *CASES["em-thresh-d"]) == []
    assert len(cc_calls) > 2
    assert max(_quant_json(tmp_path)["alt_resolved_cell_numbers"]) > 100


def test_parsimony_without_native_codec(collated, tmp_path, monkeypatch, cc_calls):
    """Without the native codec the port refuses short-read parsimony,
    on the CPU and on the card alike, rather than resolve the graphs on
    the host; no component labels are computed."""
    d, gpl = collated
    make_native_unloadable(monkeypatch, tmp_path)
    argv = ["quant", "-i", str(gpl), "-m", str(d / "t2g.tsv"), "-o", str(tmp_path / "quant"),
            *CASES["gene-em-d"][0], *DEV]
    with pytest.raises(RuntimeError, match="libradc.so"):
        port_main(argv)
    sub = {"cell": np.zeros(2, np.int64), "umi": np.arange(2, dtype=np.uint64),
           "refs": np.zeros(2, np.uint32), "offs": np.arange(3, dtype=np.int64)}
    with pytest.raises(RuntimeError, match="libradc.so"):
        pug.resolve_parsimony_cells(sub, np.zeros(1, np.uint32), False, 1000, False,
                                    torch.device("cuda"))
    assert cc_calls == []


# --- long reads --------------------------------------------------------------------

def _longread_pair(kind: str, tmp: Path):
    """(data dir, the port's gpl dir, the reference's gpl dir): the
    dataset of tests/test_longread.py (``small``, its own gpl and collate
    ran the reference) or a seeded larger one, through both packages'
    gpl and collate."""
    d = tmp / "d"
    d.mkdir()
    if kind == "small":
        ref_gpl_dir, _ = longread_dataset(d)
        permit, t2g = d / "wl.txt", d / "t2g.tsv"
        min_reads = 1
    else:
        make_longread_dataset(d, np.random.RandomState(5), n_cells=40, n_reads=20_000,
                              n_genes=150)
        permit, t2g, min_reads = d / "permit.txt", d / "t2g.tsv", 10
        ref_gpl_dir = d / "ref_gpl"
        with host_policies():
            ref_gpl(GenPermitListOpts(
                input_dir=d / "rad", output_dir=ref_gpl_dir,
                fmeth=CellFilterMethod("unfiltered", path=permit, min_reads=min_reads),
                expected_ori="fw", cmdline="t"))
            ref_collate(ref_gpl_dir, d / "rad", 2, cmdline="t")
    gpl = d / "port_gpl"
    assert port_main(["generate-permit-list", "-i", str(d / "rad"), "-d", "fw", "-o", str(gpl),
                      "-u", str(permit), "-m", str(min_reads), *DEV]) == 0
    assert port_main(["collate", "-i", str(gpl), "-r", str(d / "rad"), *DEV]) == 0
    return t2g, gpl, ref_gpl_dir


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind", ["small", "seeded"])
def test_longread_collate_carries_alignment_fields(tmp_path, monkeypatch, kind, native):
    """The port's collate writes the reference's bytes for long-read
    records (the reference with or without its native codec), and the
    collated records keep their as / start / end / tlen fields."""
    if not native:
        monkeypatch.setattr(ref_native, "_LIB", None)
        monkeypatch.setattr(ref_native, "_TRIED", True)
    _t2g, gpl, ref_gpl_dir = _longread_pair(kind, tmp_path)
    for f in ("map.collated.rad", "permit_freq.bin", "permit_map.bin"):
        assert (gpl / f).read_bytes() == (ref_gpl_dir / f).read_bytes(), f
    with open_collated(gpl) as (br, prelude, _ftm):
        schema = RecordSchema.from_prelude(prelude)
        batch = next(iter_decoded_blocks(br, schema, prelude.hdr.num_chunks, 10**9))
    assert {"as", "start", "end", "tlen"} <= set(batch.aln_cols)
    assert len(batch.aln_cols["as"]) == batch.n_aln > batch.n_reads


@pytest.mark.parametrize("resolution", ["parsimony", "parsimony-em"])
@pytest.mark.parametrize("kind", ["small", "seeded"])
def test_longread_quant_matches_reference(tmp_path, kind, resolution):
    """Long-read quant: the probability-weighted parsimony cover and,
    for parsimony-em, the weighted EM, byte for byte."""
    t2g, gpl, ref_gpl_dir = _longread_pair(kind, tmp_path)
    argv = ["quant", "-i", str(gpl), "-m", str(t2g), "-o", str(tmp_path / "port" / "quant"),
            "-r", resolution, *DEV]
    em_calls = em.STATS["calls"]
    assert port_main(argv) == 0
    run_reference_quant(ref_gpl_dir, tmp_path / "ref" / "quant", t2g,
                        "alevin-fry-tpu " + " ".join(argv), 2, resolution=resolution)
    bad = [n for n in QUANT_ARTIFACTS
           if (tmp_path / "port" / n).read_bytes() != (tmp_path / "ref" / n).read_bytes()]
    assert bad == [] and _quant_json(tmp_path) == comparable_json(
        tmp_path / "ref" / "quant" / "quant.json")
    assert em.STATS["calls"] == em_calls + (resolution == "parsimony-em")
    if kind == "seeded":  # the small set's EM ends on whole numbers
        body = (tmp_path / "port/quant/alevin/quants_mat.mtx").read_text().splitlines()[3:]
        assert any("." in line.split()[2] for line in body) == (resolution == "parsimony-em")


# --- K7's twin ---------------------------------------------------------------------

def _small_graphs(seed: int):
    """64 random cells of up to 120 nodes (sparse and dense ones) and a
    120-node path in random order."""
    rng = np.random.RandomState(seed)
    n_nodes = np.append(rng.randint(0, 121, 64), 120)
    n_edges = rng.poisson(rng.choice([0.5, 1.5, 4.0], 64) * n_nodes[:64] / 2)
    cell = np.repeat(np.arange(64), n_edges)
    top = np.maximum(n_nodes[cell], 1)
    order = rng.permutation(120)
    u = np.concatenate([rng.randint(0, 1 << 30, len(cell)) % top, order[:-1]])
    v = np.concatenate([rng.randint(0, 1 << 30, len(cell)) % top, order[1:]])
    return csr_from_edges(n_nodes, np.concatenate([cell, np.full(119, 64)]), u, v)


def _per_cell(n_nodes, deg, nbr):
    """Each cell's (n, degrees, neighbours) slices."""
    node_off = np.concatenate(([0], np.cumsum(n_nodes)))
    adj_off = np.concatenate(([0], np.cumsum(deg)))
    for c in range(len(n_nodes)):
        s, e = node_off[c], node_off[c + 1]
        yield int(e - s), deg[s:e], nbr[adj_off[s]:adj_off[e]]


def _twin(graph) -> np.ndarray:
    n_nodes, _entries, deg, nbrs = pug_device.upload_csr(*graph, torch.device("cpu"))
    labels, _rounds = pug_device.connected_components_twin(n_nodes, deg, nbrs)
    return labels.numpy()


@pytest.mark.parametrize("seed", [1, 2])
def test_k7_twin_matches_reference_cc(seed):
    """The twin's labels equal the JAX package's batched device CC (the
    dense squaring and the gather propagation), its host loop and a
    union-find."""
    graph = _small_graphs(seed)
    got = _twin(graph)
    np.testing.assert_array_equal(got, union_find_labels(*graph))
    cells = list(_per_cell(*graph))
    host = np.concatenate([ref_pug._host_cc_labels(n, dg, nb) for n, dg, nb in cells])
    np.testing.assert_array_equal(got, host)
    adjs = [[list(nb[o:o + k]) for o, k in zip(np.cumsum(np.r_[0, dg[:-1]]), dg)]
            for n, dg, nb in cells]
    nbrs, valid = pack_adjacency(adjs, [n for n, _, _ in cells])
    node_off = np.concatenate(([0], np.cumsum(graph[0])))
    for dense in (True, False):
        lab = connected_components_batched(nbrs, valid, dense=dense)
        want = np.concatenate([lab[b, :n] for b, (n, _, _) in enumerate(cells)])
        np.testing.assert_array_equal(got, want.astype(np.int32))
    assert len(np.unique(got + np.repeat(node_off[:-1], graph[0]))) < len(got)  # components join


@pytest.mark.parametrize("kind", [k for k in PUG_CASES if k != "chains"])
def test_k7_twin_on_graph_cases(kind):
    """The card tests' graphs (all but the long chains, whose thousands
    of synchronous rounds are slow on the CPU): the twin equals the
    union-find."""
    graph = pug_case(kind)
    np.testing.assert_array_equal(_twin(graph), union_find_labels(*graph))


def test_k7_twin_on_exported_graphs(collated):
    """The graphs the native graph build exports for the large cells of the
    synth_hard data: the twin equals the JAX package's host loop per cell
    and its cover then gives the monolithic resolver's classes."""
    _d, gpl = collated
    with open_collated(gpl) as (br, prelude, _ftm):
        schema = RecordSchema.from_prelude(prelude)
        batch = next(iter_decoded_blocks(br, schema, prelude.hdr.num_chunks, 10**9))
    nrec = np.diff(batch.chunk_offsets)
    cells = np.flatnonzero(nrec >= 100)
    sel = np.isin(batch.chunk_id, cells)
    cell, umi, refs, offs = quant._reads(batch, batch.chunk_id, sel)
    t2g = np.arange(int(refs.max()) + 1, dtype=np.uint32) // 4
    cro = np.append(np.searchsorted(cell, cells), len(cell)).astype(np.int64)
    handle, n_nodes, deg, nbr = _native.pug_graph_build(cro, umi, refs, offs, t2g, False, False)
    try:
        labels = _twin((n_nodes, deg, nbr))
        host = np.concatenate([ref_pug._host_cc_labels(n, dg, nb)
                               for n, dg, nb in _per_cell(n_nodes, deg, nbr)])
        np.testing.assert_array_equal(labels, host)
        got = _native.pug_cover(handle, cro, offs, t2g, False, 1000, labels)
    finally:
        _native.pug_free(handle)
    want = ref_native.pug_resolve(cro, umi, refs, offs, t2g, False, False, 1000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(cells) > 50 and int(deg.sum()) > 0


# --- the weighted EM ---------------------------------------------------------------

@pytest.mark.parametrize("lengths", [range(2, 8), range(8, 129), range(129, 301)])
def test_np_row_sums_follow_numpy_order(lengths):
    """np_row_sums adds a float32 row in NumPy's order, bit for bit, for
    every row length from 2 to 300, on 1 and on 200 rows (spread
    magnitudes make every change of order show)."""
    for n in lengths:
        rng = np.random.RandomState(n)
        x = (rng.rand(200, n) * rng.choice([1e-4, 1.0, 1e4], (200, n))).astype(np.float32)
        for rows in (x, x[:1]):
            got = em.np_row_sums(torch.from_numpy(rows)).numpy()
            np.testing.assert_array_equal(got.view(np.int32), rows.sum(axis=1).view(np.int32))


@pytest.mark.parametrize("init_uniform", [False, True])
def test_weighted_twin_matches_host_em(init_uniform):
    """The weighted twin equals the reference's host path of the
    long-read EM (em_cells_batched with class weights, which runs
    em_optimize_weighted_cell_np per cell) bit for bit, on cells whose
    Lmax lies on either side of 8 and 128."""
    batch, n_rows, w = weighted_case()
    got = em.em_cells(*batch, n_rows, None, init_uniform, False, torch.device("cpu"), w)
    want = em_cells_batched(*batch, n_rows, None, init_uniform, False, use_jax=False,
                            class_weights=w)
    for (gi, gv), (wi, wv) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv.view(np.int32), np.asarray(wv, np.float32).view(np.int32))
    assert sum(len(v) for _, v in got) > 500


def test_weighted_cell_order_crosses_8_and_128():
    """One cell at a time against em_optimize_weighted_cell_np itself: a
    class of 4 labels sums in another order once the cell's longest
    class reaches 8 or passes 128, and the twin follows."""
    rng = np.random.RandomState(12)
    n_rows = 400
    for lmax in (5, 8, 9, 128, 130, 200):
        lens = np.array([1, 4, 4, 6, lmax, 3, 2])
        labels = np.concatenate([np.sort(rng.choice(n_rows, k, replace=False))
                                 for k in lens]).astype(np.uint32)
        lo = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
        counts = rng.randint(1, 50, len(lens)).astype(np.uint32)
        w = (rng.rand(len(labels)) * 10 ** rng.uniform(-3, 3, len(labels))).astype(np.float32)
        want = em_optimize_weighted_cell_np(lo, labels, counts, w, n_rows)
        (ids, vals), = em.em_cells(np.array([0, len(lens)]), lo, labels, counts, n_rows, None,
                                   False, False, torch.device("cpu"), w)
        np.testing.assert_array_equal(ids, np.flatnonzero(want))
        np.testing.assert_array_equal(vals.view(np.int32), want[ids].view(np.int32))


def test_class_weights_match_reference():
    """Per-label weights from probability rows, with classes whose rows
    are missing, short or absent (the fallback's), as the reference."""
    rng = np.random.RandomState(8)
    lens = rng.randint(1, 6, 300)
    lo = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
    rows = [[rng.rand(int(k) + rng.randint(-1, 3)) for _ in range(rng.randint(0, 4))]
            for k in lens[:250]]
    got = em.class_weights_from_prob_rows(lo, rows)
    want = ref_class_weights(lo, rows)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.dtype == np.float32 and (got[lo[250]:] == 1).all()
