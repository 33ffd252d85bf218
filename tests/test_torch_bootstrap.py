"""The port's bootstraps (``quant -b N``) against the reference package's
host path, and the pieces under them.

* the init stream's twin (kernel K8's, ``ops/mtrand.py``) against
  ``np.random.RandomState(s).random_sample(n)`` cast to float32 plus
  1e-5, for seeds 0 to 2**32 - 1 and streams across one, two and several
  624-word twists;
* the port's ``run_bootstraps`` (K8's and K6's twins on the CPU) against
  the reference's ``run_bootstraps`` with ``AFT_BOOT_BACKEND=host`` (the
  NumPy EMs), on tests/em_cases.py's bootstrap cells: the rungs at width
  4 (4-label classes) and 16, an all-singleton cell, a cell of 1,100
  classes past the ladder, one and four replicates, resamples with zero
  counts;
* quant ``-b`` through the port's CLI with ``--device cpu`` against
  tests/reference_host_path.py on the same collated data: cr-like-em,
  parsimony-em and parsimony-gene-em, one replicate with
  ``--summary-stat`` and ``--quant-subset``, many streamed blocks, both
  packages' ladders cut to (8, 16, 32) so that cells take the route past
  it, and long-read records under parsimony-em.

The EM values are bit-identical, so every artifact is compared byte for
byte and quant.json field for field without its directory fields.  Data
comes from numpy seeds.
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from alevin_fry_tpu.ops import bootstrap as ref_bootstrap
from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.ops import bootstrap, em, mtrand
from alevin_fry_tpu_torch.pipeline import quant
from em_cases import boot_case
from reference_host_path import (
    BOOT_ARTIFACTS, DUMP_ARTIFACTS, QUANT_ARTIFACTS, comparable_json, make_longread_dataset,
    run_reference_quant,
)
from synth_hard import make_hard_dataset

CPU = torch.device("cpu")
DEV = ["-t", "2", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _port_rescue_env(monkeypatch):
    monkeypatch.delenv("AFT_RESCUE_BACKEND", raising=False)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


# --- K8's twin -----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 271828, 2**32 - 1])
def test_k8_twin_equals_numpy_stream(seed):
    """Whole streams of 1 to 1,300 doubles (the 624-word twist holds 312)
    and ids picked from a 2,000-double stream, three replicates of four
    cells."""
    for n in (1, 311, 312, 313, 624, 625, 700, 1248, 1300):
        want = np.random.RandomState(seed).random_sample(n).astype(np.float32) + 1e-5
        got = mtrand.random_init_twin(torch.tensor([[seed]]), torch.tensor([0, n]),
                                      torch.arange(n, dtype=torch.int32))
        np.testing.assert_array_equal(_bits(got[0]), _bits(want), err_msg=f"{n} doubles")
    rng = np.random.RandomState(seed % 1000)
    ids = [np.sort(rng.choice(2000, rng.randint(1, 60), replace=False)) for _ in range(4)]
    off = np.concatenate(([0], np.cumsum([len(i) for i in ids])))
    seeds = (rng.randint(0, 2**32, (3, 4), dtype=np.int64) ^ seed) & 0xFFFFFFFF
    got = mtrand.random_init_twin(torch.from_numpy(seeds), torch.from_numpy(off),
                                  torch.from_numpy(np.concatenate(ids).astype(np.int32)))
    for r in range(3):
        for c in range(4):
            want = np.random.RandomState(int(seeds[r, c])).random_sample(2000)
            np.testing.assert_array_equal(_bits(got[r, off[c]:off[c + 1]]),
                                          _bits(want.astype(np.float32)[ids[c]] + 1e-5))


def test_k8_twin_refuses_bad_inputs():
    with pytest.raises(ValueError):
        mtrand.random_init_twin(torch.zeros(3, dtype=torch.int64), torch.tensor([0, 1]),
                                torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        mtrand.random_init_twin(torch.zeros((1, 1), dtype=torch.int64), torch.tensor([0, 1]),
                                torch.zeros(1, dtype=torch.int64))


# --- the bootstraps on the twins against the reference's host path ------------------

def _eqc(batch, cell_ids):
    ceo, _, _, counts = batch
    return types.SimpleNamespace(cell_ids=cell_ids, cell_eq_offsets=ceo, counts=counts)


def _assert_triplets_equal(got, want):
    for g, w in zip(got, want):  # the mean's triplets, then the variance's
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(_bits(g[2]), _bits(w[2]))


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("kind", ["rungs", "past-ladder"])
def test_bootstraps_equal_reference_host_path(kind, n, monkeypatch):
    monkeypatch.setenv("AFT_BOOT_BACKEND", "host")
    batch, n_rows = boot_case(kind)
    ceo, lo, labels, counts = batch
    cell_ids = np.arange(len(ceo) - 1, dtype=np.int64) * 3 + 1
    want = ref_bootstrap.run_bootstraps(_eqc(batch, cell_ids), lo, labels, n_rows, n, False,
                                        False, cell_offset=11)
    got = bootstrap.run_bootstraps(_eqc(batch, cell_ids), lo, labels, n_rows, n, CPU,
                                   cell_offset=11)
    _assert_triplets_equal(got, want)
    assert len(got[0][0]) > 0 and (len(got[1][0]) > 0) == (n > 1)
    widths = bootstrap.cell_widths(ceo, lo)
    resampled = bootstrap.resample(counts, ceo, cell_ids + 11, n)
    if kind == "rungs":
        assert {4, 16} <= set(widths.tolist())
        assert (resampled == 0).any()
    else:
        assert 0 in widths and int(np.diff(ceo).max()) > 1024


def test_bootstrap_rows_cross_batches(monkeypatch):
    """Batches of whole cells (here one cell each) give the same triplets."""
    batch, n_rows = boot_case("rungs")
    _, lo, labels, _ = batch
    cell_ids = np.arange(len(batch[0]) - 1, dtype=np.int64)
    want = bootstrap.run_bootstraps(_eqc(batch, cell_ids), lo, labels, n_rows, 3, CPU)
    monkeypatch.setattr(bootstrap, "BATCH_VALUES", 1)
    _assert_triplets_equal(bootstrap.run_bootstraps(_eqc(batch, cell_ids), lo, labels, n_rows,
                                                    3, CPU), want)


def test_bootstrap_twin_rows_follow_their_route():
    """K6's twin in its bootstrap mode: N replicates of one layout, each
    row from its own init and counts, equal the rows run one replicate at
    a time."""
    batch, n_rows = boot_case("past-ladder")
    ceo, lo, labels, counts = batch
    cells = np.arange(len(ceo) - 1)
    width = bootstrap.cell_widths(ceo, lo)
    counts3 = bootstrap.resample(counts, ceo, cells, 3)
    seeds = bootstrap.init_seeds(bootstrap.SEED, cells, 3)
    _, t = bootstrap.replicate_plan(ceo, lo, labels, n_rows, width, counts3, seeds, CPU)
    alpha, rounds = em.em_run_twin(t)
    assert alpha.shape == (3, len(t.occ_off) - 1) and bool((rounds >= 3).all())
    for r in range(3):
        _, one = bootstrap.replicate_plan(ceo, lo, labels, n_rows, width, counts3[r:r + 1],
                                          seeds[r:r + 1], CPU)
        a1, r1 = em.em_run_twin(one)
        np.testing.assert_array_equal(_bits(alpha[r]), _bits(a1[0]))
        np.testing.assert_array_equal(rounds[r].numpy(), r1[0].numpy())


# --- quant -b against the reference's host path --------------------------------------

@pytest.fixture(scope="module")
def collated(tmp_path_factory):
    """synth_hard data (300 genes) collated by the port, and a
    --quant-subset list of every third permitted barcode."""
    d = tmp_path_factory.mktemp("qboot")
    make_hard_dataset(d, np.random.RandomState(23), n_cells=120, n_reads=80_000, n_genes=300)
    gpl = d / "gpl"
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("AFT_RESCUE_BACKEND", raising=False)
        assert port_main(["generate-permit-list", "-i", str(d / "rad"), "-d", "fw",
                          "-o", str(gpl), "-u", str(d / "permit.txt"), "-m", "10", *DEV]) == 0
        assert port_main(["collate", "-i", str(gpl), "-r", str(d / "rad"), *DEV]) == 0
    subset = d / "subset.txt"
    subset.write_text("".join((d / "permit.txt").read_text().splitlines(True)[::3]))
    return d, gpl, subset


# name -> (the port's quant flags, the reference's quant options)
QUANTS = {
    "cr-like-em": (["-r", "cr-like-em", "-b", "3"],
                   {"resolution": "cr-like-em", "num_bootstraps": 3}),
    "cr-like-em-1-summary-subset": (
        ["-r", "cr-like-em", "-b", "1", "--summary-stat"],
        {"resolution": "cr-like-em", "num_bootstraps": 1, "summary_stat": True}),
    "parsimony-em": (["-r", "parsimony-em", "-b", "3"],
                     {"resolution": "parsimony-em", "num_bootstraps": 3}),
    "parsimony-gene-em-d": (["-r", "parsimony-gene-em", "-b", "3", "-d"],
                            {"resolution": "parsimony-gene-em", "num_bootstraps": 3,
                             "dump_eq": True}),
}


def _quant_both(gpl: Path, t2g: Path, tmp: Path, flags: list, ref_opts: dict,
                subset=None) -> list:
    """Run the port's quant and the reference's on ``gpl``; the names of
    the artifacts that differ."""
    extra = ["--quant-subset", str(subset)] if subset else []
    argv = ["quant", "-i", str(gpl), "-m", str(t2g), "-o", str(tmp / "port" / "quant"),
            *flags, *extra, *DEV]
    assert port_main(argv) == 0
    run_reference_quant(gpl, tmp / "ref" / "quant", t2g, "alevin-fry-tpu " + " ".join(argv), 2,
                        quant_subset=subset, **ref_opts)
    names = QUANT_ARTIFACTS + BOOT_ARTIFACTS + (DUMP_ARTIFACTS if ref_opts.get("dump_eq") else ())
    bad = [n for n in names if (tmp / "port" / n).read_bytes() != (tmp / "ref" / n).read_bytes()]
    if comparable_json(tmp / "port/quant/quant.json") != comparable_json(
            tmp / "ref/quant/quant.json"):
        bad.append("quant/quant.json")
    return bad


def _fractions(path: Path) -> bool:
    return any("." in line.split()[2] for line in path.read_text().splitlines()[3:])


@pytest.mark.parametrize("name", list(QUANTS))
def test_quant_bootstraps_match_reference(collated, tmp_path, name):
    d, gpl, subset = collated
    flags, ref_opts = QUANTS[name]
    launches = em.LAUNCHES["K6-boot"], mtrand.LAUNCHES["K8"]
    bad = _quant_both(gpl, d / "t2g.tsv", tmp_path, flags, ref_opts,
                      subset if "subset" in name else None)
    assert bad == []
    alevin = tmp_path / "port" / "quant" / "alevin"
    assert _fractions(alevin / "bootstraps_mean.mtx")
    assert _fractions(alevin / "bootstraps_var.mtx") == (ref_opts["num_bootstraps"] > 1)
    # the CPU runs the twins: no kernel launched
    assert (em.LAUNCHES["K6-boot"], mtrand.LAUNCHES["K8"]) == launches


@pytest.mark.parametrize("setup", ["small blocks", "small ladder"])
def test_quant_bootstraps_match_reference_across_routes(collated, tmp_path, monkeypatch, setup):
    """The port's quant in many streamed blocks against the reference's
    one (each block's cells keep the generators of their numbers in the
    file), and both packages' ladders cut to (8, 16, 32) so that most
    cells take the route past the ladder."""
    d, gpl, _ = collated
    if setup == "small blocks":
        monkeypatch.setattr(quant, "QUANT_BLOCK_RECORDS", 20_000)
    else:
        monkeypatch.setattr(bootstrap, "EP_LADDER", (8, 16, 32))
        monkeypatch.setattr(ref_bootstrap, "_EP_LADDER", (8, 16, 32))
    widths, calls = [], em.STATS["calls"]
    cell_widths = bootstrap.cell_widths
    monkeypatch.setattr(bootstrap, "cell_widths",
                        lambda *a: widths.append(cell_widths(*a)) or widths[-1])
    bad = _quant_both(gpl, d / "t2g.tsv", tmp_path, ["-r", "cr-like-em", "-b", "2"],
                      {"resolution": "cr-like-em", "num_bootstraps": 2})
    assert bad == []
    if setup == "small blocks":
        assert em.STATS["calls"] - calls > 2 and len(widths) > 2
    else:
        assert (np.concatenate(widths) == 0).any()


def test_quant_bootstraps_long_reads(tmp_path):
    """Long-read records under parsimony-em -b 2: the point estimate is
    the weighted EM, the replicates take no weights."""
    d = tmp_path / "d"
    d.mkdir()
    make_longread_dataset(d, np.random.RandomState(5), n_cells=40, n_reads=20_000, n_genes=150)
    gpl = d / "gpl"
    assert port_main(["generate-permit-list", "-i", str(d / "rad"), "-d", "fw", "-o", str(gpl),
                      "-u", str(d / "permit.txt"), "-m", "10", *DEV]) == 0
    assert port_main(["collate", "-i", str(gpl), "-r", str(d / "rad"), *DEV]) == 0
    bad = _quant_both(gpl, d / "t2g.tsv", tmp_path, ["-r", "parsimony-em", "-b", "2"],
                      {"resolution": "parsimony-em", "num_bootstraps": 2})
    assert bad == []
    assert _fractions(tmp_path / "port/quant/alevin/bootstraps_mean.mtx")


def test_replicate_summary_equals_numpy():
    """The mean and variance over the replicate rows, float64 in turn,
    equal the reference's NumPy expressions bit for bit (zeros, equal
    rows and rows of mixed magnitude included)."""
    rng = np.random.RandomState(9)
    for n in (1, 3, 20, 33):
        alpha = (rng.rand(n, 500) * 10.0 ** rng.randint(-2, 4, (n, 500))).astype(np.float32)
        alpha[:, :50] = 0
        alpha[:, 50:100] = alpha[0, 50:100]
        mean, var = bootstrap._summarize(torch.from_numpy(alpha))
        x = alpha.astype(np.float64)
        s = x.sum(axis=0)
        np.testing.assert_array_equal(_bits(mean), _bits((s / n).astype(np.float32)))
        np.testing.assert_array_equal(
            _bits(var), _bits(((x ** 2).sum(axis=0) / n - (s / n) ** 2).astype(np.float32)))
