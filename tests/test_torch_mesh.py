"""The port's device mesh (``alevin_fry_tpu_torch/parallel/mesh.py``) on the
CPU: the programs the stages call, on an 8-shard mesh, against the
reference's on its 8-device virtual mesh (``tests/conftest.py``) or its
host path, on the same inputs made with numpy seeds, and the stages run
with ``AFT_GPL_MESH`` / ``AFT_EM_MESH`` against the port's run without a
mesh and the reference.

The histograms must be equal.  The per-cell EM of ``em_cells`` adds in
the host EM's order, so it must equal the reference's host path bit for
bit (the reference's mesh EM runs its JAX program, which is not that
path).  Every stage's artifacts must be byte-identical with a mesh and
without.
"""

import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from alevin_fry_tpu.ops.em import em_cells_batched
from alevin_fry_tpu.parallel import mesh as ref_mesh
from alevin_fry_tpu_torch import _kernels
from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.ops import em
from alevin_fry_tpu_torch.parallel import dist, mesh
from alevin_fry_tpu_torch.pipeline import gpl
from alevin_fry_tpu_torch.atac import gpl as atac_gpl
from em_cases import em_batch, usa_offsets, weighted_case
from reference_host_path import (
    ATAC_STAGE_JSONS, DUMP_ARTIFACTS, INFER_ARTIFACTS, QUANT_ARTIFACTS, artifact_mismatches,
    cell_filter, comparable_json, host_policies, run_reference_infer, run_reference_quant,
)
from synth_hard import make_hard_atac_dataset, make_hard_dataset

CPU = torch.device("cpu")
S = 8
DEV = ["-t", "2", "--device", "cpu"]
GPL_FILES = ("gpl/permit_freq.bin", "gpl/permit_map.bin")
ATAC_GPL_FILES = GPL_FILES + ("gpl/bin_recs.bin", "gpl/bin_lens.bin")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """Each test starts without the mesh variables and the reference's
    rescue policy (the port refuses ``host``)."""
    for var in ("AFT_GPL_MESH", "AFT_EM_MESH", "AFT_RESCUE_BACKEND"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def rmesh():
    assert len(jax.devices()) == S
    return ref_mesh.make_mesh()


@pytest.fixture(scope="module")
def pmesh():
    return mesh.make_mesh(S, CPU)


# --- the programs ----------------------------------------------------------------

@pytest.mark.parametrize("cut", [0, 3])
def test_sharded_histogram_matches_reference(rmesh, pmesh, cut):
    """Barcodes of 40 bits and 32-base codes with bit 63 set (unsigned
    order), a length 8 divides and one it does not."""
    rng = np.random.RandomState(1)
    wl = np.sort(np.concatenate([
        rng.choice(1 << 20, size=126, replace=False).astype(np.uint64) << np.uint64(20),
        np.asarray([0xC000000000000000, 0xFFFFFFFFFFFFFFF0], np.uint64)]))
    n = 16 * S
    bcs = wl[rng.choice(len(wl), size=n)]
    bcs[: n // 4] = rng.choice(1 << 20, size=n // 4).astype(np.uint64)
    bcs[1] = np.uint64(0xC000000000000001)
    bcs = bcs[: n - cut]
    cnt, unm, hit = mesh.sharded_histogram(pmesh, bcs, wl)
    rc, ru, rh = ref_mesh.sharded_histogram(rmesh, bcs, wl)
    np.testing.assert_array_equal(cnt, np.asarray(rc, np.int64))
    assert unm == int(ru)
    np.testing.assert_array_equal(hit, rh)
    idx = np.minimum(np.searchsorted(wl, bcs), len(wl) - 1)
    host = wl[idx] == bcs
    np.testing.assert_array_equal(hit, host)
    assert cnt.sum() == host.sum() > 0 and unm == (~host).sum() > 0


def test_sharded_bin_histogram_matches_reference(rmesh, pmesh):
    rng = np.random.RandomState(2)
    idx = rng.randint(0, 300, size=8 * 125 + 5)
    got = mesh.sharded_bin_histogram(pmesh, idx, 300)
    np.testing.assert_array_equal(got, ref_mesh.sharded_bin_histogram(rmesh, idx, 300))
    np.testing.assert_array_equal(got, np.bincount(idx, minlength=300))
    with pytest.raises(ValueError, match="past the 300 bins"):
        mesh.sharded_bin_histogram(pmesh, np.append(idx, 300), 300)


@pytest.mark.parametrize("weights,parts", [
    ([1] * 16, 8),                 # even: two items a part
    ([1000] + [1] * 99, 4),        # one heavy item: the rest split after it
    ([5, 7, 2], 8),                # fewer items than parts: empty ranges
])
def test_ranges_split_cells_by_weight(weights, parts):
    """The cut points a mesh's shards take their cells by: from 0 to the
    item count, never decreasing, each range within one item of the
    even share of the weight."""
    cum = np.concatenate([[0], np.cumsum(weights)])
    cuts = _kernels.ranges(cum, parts)
    assert len(cuts) == parts + 1 and cuts[0] == 0 and cuts[-1] == len(weights)
    assert all(a <= b for a, b in zip(cuts, cuts[1:]))
    share = -(-cum[-1] // parts)
    for a, b in zip(cuts, cuts[1:]):
        assert cum[b] - cum[a] <= share + max(weights)
    if weights == [1] * 16:
        assert cuts == list(range(0, 17, 2))


def _em_equal(got, want):
    assert len(got) == len(want)
    for (gi, gv), (wi, wv) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv.view(np.int32), np.asarray(wv, np.float32).view(np.int32))


@pytest.mark.parametrize("kind", ["plain", "usa", "weighted"])
def test_em_cells_on_a_mesh_equal_the_host_em(pmesh, kind, monkeypatch):
    """Cells split by occurrences over 8 shards, one K6 twin a shard:
    bit for bit the reference's host EM."""
    runs = []
    real = em.em_run
    monkeypatch.setattr(em, "em_run", lambda t: runs.append(len(t.dict_off) - 1) or real(t))
    if kind == "weighted":
        batch, n_rows, w = weighted_case()
        args, kw = (*batch, n_rows, None, False, False), {"class_weights": w}
    else:
        batch = em_batch(11, n_cells=200)
        offs = usa_offsets(12) if kind == "usa" else None
        args, kw = (*batch, 12, offs, False, True), {}
    got = em.em_cells(*args, CPU, kw.get("class_weights"), mesh=pmesh)
    assert len(runs) == S and sum(runs) == len(batch[0]) - 1
    _em_equal(got, em_cells_batched(*args, use_jax=False, **kw))
    _em_equal(got, em.em_cells(*args, CPU, kw.get("class_weights")))


# --- the reading of the variables ---------------------------------------------------

@pytest.mark.parametrize("var,spec,device,want", [
    ("AFT_GPL_MESH", None, "cpu", None),
    ("AFT_EM_MESH", None, "cpu", None),
    ("AFT_GPL_MESH", "0", "cpu", None),
    ("AFT_EM_MESH", "off", "cpu", None),
    ("AFT_GPL_MESH", "auto", "cpu", None),
    ("AFT_GPL_MESH", "1", "cpu", None),
    ("AFT_GPL_MESH", "3", "cpu", 3),
    ("AFT_GPL_MESH", "8", "cpu", 8),
    ("AFT_EM_MESH", "3", "cpu", 2),
    ("AFT_EM_MESH", "12", "cpu", 8),
    ("AFT_EM_MESH", "100", "cpu", 64),
])
def test_mesh_from_env(monkeypatch, var, spec, device, want):
    if spec is not None:
        monkeypatch.setenv(var, spec)
    got = mesh.mesh_from_env(var, device)
    if want is None:
        assert got is None
    else:
        assert got.size == want and set(got.devices) == {CPU}


def test_mesh_from_env_on_the_card_and_in_a_multi_process_run(monkeypatch):
    """Unset on the card means one shard a card, and without a card a
    mesh on cuda raises (no mesh falls back to the CPU); a multi-process
    run never takes a mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("AFT_GPL_MESH", "AFT_EM_MESH"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.mesh_from_env(var, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(2, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = mesh.mesh_from_env("AFT_GPL_MESH", "cuda")
    assert m.devices == tuple(torch.device("cuda", s) for s in range(3))
    assert mesh.mesh_from_env("AFT_EM_MESH", "cuda").size == 2
    monkeypatch.setenv("AFT_GPL_MESH", "5")
    assert [d.index for d in mesh.mesh_from_env("AFT_GPL_MESH", "cuda").devices] == \
        [0, 1, 2, 0, 1]
    monkeypatch.setattr(dist, "_INITIALIZED", True)
    monkeypatch.setattr(dist, "_WORLD", 2)
    monkeypatch.setenv("AFT_EM_MESH", "8")
    assert mesh.mesh_from_env("AFT_GPL_MESH", "cpu") is None
    assert mesh.mesh_from_env("AFT_EM_MESH", "cpu") is None


# --- the stages -------------------------------------------------------------------

@pytest.fixture(scope="module")
def rna(tmp_path_factory):
    """synth_hard data, and the port's gpl and collate without a mesh."""
    d = tmp_path_factory.mktemp("mesh_rna")
    make_hard_dataset(d, np.random.RandomState(23), n_cells=120, n_reads=60_000, n_genes=300)
    base = d / "base"
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("AFT_RESCUE_BACKEND", raising=False)
        assert port_main(_gpl_argv(d, base)) == 0
        assert port_main(["collate", "-i", str(base / "gpl"), "-r", str(d / "rad"), *DEV]) == 0
    return d, base


def _gpl_argv(d: Path, out: Path) -> list:
    return ["generate-permit-list", "-i", str(d / "rad"), "-d", "fw", "-o", str(out / "gpl"),
            "-u", str(d / "permit.txt"), "-m", "10", *DEV]


def _json_without_cmd(path: Path) -> dict:
    """A stage JSON without the fields naming its directories and its
    command line (two runs into two directories)."""
    d = comparable_json(path)
    d.pop("cmd", None)
    for key in ("gpl_options", "quant_options"):
        d.get(key, {}).pop("cmdline", None)
    return d


def _calls(monkeypatch, module, name) -> list:
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_rna_gpl_with_a_mesh_matches_the_reference_mesh_run(rna, tmp_path, monkeypatch):
    """AFT_GPL_MESH=8: the whitelisted reads counted on the mesh, the rest
    on the host; the same bytes as the run without a mesh and as the
    reference's own run on its 8-device mesh."""
    d, base = rna
    calls = _calls(monkeypatch, gpl, "sharded_histogram")
    monkeypatch.setenv("AFT_GPL_MESH", str(S))
    argv = _gpl_argv(d, tmp_path / "port")
    assert port_main(argv) == 0
    assert calls
    from alevin_fry_tpu.pipeline.gpl import GenPermitListOpts, generate_permit_list

    ref_calls = _calls(monkeypatch, ref_mesh, "sharded_histogram")
    with host_policies():
        os.environ["AFT_GPL_MESH"] = str(S)
        generate_permit_list(GenPermitListOpts(
            input_dir=d / "rad", output_dir=tmp_path / "ref" / "gpl",
            fmeth=cell_filter(None, d, 10), expected_ori="fw", threads=2,
            cmdline="alevin-fry-tpu " + " ".join(_gpl_argv(d, base))))
    assert ref_calls
    jsons = ("gpl/generate_permit_list.json",)
    assert artifact_mismatches(tmp_path / "port", base, GPL_FILES, ()) == []
    assert artifact_mismatches(base, tmp_path / "ref", GPL_FILES, jsons) == []


def test_quant_em_and_infer_with_a_mesh_match_the_reference(rna, tmp_path, monkeypatch):
    """quant -r cr-like-em -d and infer --usa with AFT_EM_MESH=8 (the EM
    cells of each call split over 8 shards) write the bytes of the runs
    without a mesh and of the reference's host path."""
    d, base = rna
    runs = _calls(monkeypatch, em, "em_run")
    outs = {}
    for tag, spec in (("mesh", str(S)), ("one", "0")):
        monkeypatch.setenv("AFT_EM_MESH", spec)
        q = tmp_path / tag
        argv = ["quant", "-i", str(base / "gpl"), "-m", str(d / "t2g_3col.tsv"), "-o",
                str(q / "quant"), "-r", "cr-like-em", "-d", *DEV]
        assert port_main(argv) == 0
        a = q / "quant" / "alevin"
        assert port_main(["infer", "-c", str(a / "geqc_counts.mtx"), "-e",
                          str(a / "gene_eqclass.txt.gz"), "-o", str(q / "infer"), "--usa",
                          *DEV]) == 0
        outs[tag] = len(runs)
    assert outs["mesh"] == 2 * S and outs["one"] == outs["mesh"] + 2
    monkeypatch.delenv("AFT_EM_MESH")
    ref = tmp_path / "ref"
    run_reference_quant(base / "gpl", ref / "quant", d / "t2g_3col.tsv",
                        "alevin-fry-tpu " + " ".join(argv), 2, resolution="cr-like-em",
                        dump_eq=True)
    a = ref / "quant" / "alevin"
    run_reference_infer(a / "geqc_counts.mtx", a / "gene_eqclass.txt.gz", ref / "infer", True)
    names = QUANT_ARTIFACTS + DUMP_ARTIFACTS + INFER_ARTIFACTS
    assert artifact_mismatches(tmp_path / "mesh", tmp_path / "one", names, ()) == []
    assert _json_without_cmd(tmp_path / "mesh" / "quant" / "quant.json") == _json_without_cmd(
        tmp_path / "one" / "quant" / "quant.json")
    assert artifact_mismatches(tmp_path / "one", ref, names, ("quant/quant.json",)) == []


def test_atac_gpl_with_a_mesh_matches_the_reference_mesh_run(tmp_path, monkeypatch):
    """ATAC gpl with AFT_GPL_MESH=8: the bins and the whitelisted
    barcodes counted on the mesh; the bytes of the run without a mesh and
    of the reference's own run on its 8-device mesh."""
    d = tmp_path / "data"
    d.mkdir()
    make_hard_atac_dataset(d, np.random.RandomState(11), n_cells=60, n_frags=12_000, n_chrs=3,
                           chr_len=2_000_000, ambient_factor=8)
    bins = _calls(monkeypatch, atac_gpl, "sharded_bin_histogram")
    hist = _calls(monkeypatch, atac_gpl, "sharded_histogram")

    def argv(out):
        return ["atac", "generate-permit-list", "-i", str(d / "rad"), "-o", str(out / "gpl"),
                "-u", str(d / "wl.txt"), "-m", "10", *DEV]

    assert port_main(argv(tmp_path / "one")) == 0
    assert not bins
    monkeypatch.setenv("AFT_GPL_MESH", str(S))
    assert port_main(argv(tmp_path / "mesh")) == 0
    assert bins and hist
    from alevin_fry_tpu.atac.gpl import AtacGplOpts, generate_permit_list

    ref_bins = _calls(monkeypatch, ref_mesh, "sharded_bin_histogram")
    with host_policies():
        os.environ["AFT_GPL_MESH"] = str(S)
        generate_permit_list(AtacGplOpts(
            input_dir=d / "rad", output_dir=tmp_path / "ref" / "gpl", unfiltered_pl=d / "wl.txt",
            min_reads=10, rc=True, threads=2,
            cmdline="alevin-fry-tpu " + " ".join(argv(tmp_path / "one"))))
    assert ref_bins
    jsons = ATAC_STAGE_JSONS[:1]
    assert artifact_mismatches(tmp_path / "mesh", tmp_path / "one", ATAC_GPL_FILES, ()) == []
    assert artifact_mismatches(tmp_path / "one", tmp_path / "ref", ATAC_GPL_FILES, jsons) == []
