"""The port's quant with the resolutions and options of this slice, and
its infer, through its CLI with ``--device cpu``, against the reference
package's host path (tests/reference_host_path.py) on the same collated
data.

Cases: ``-r cr-like-em`` (USA with ``-d``, plain, plain with ``-d`` and
``--init-uniform``), ``-r trivial``, ``-r cr-like --sa-model
prefer-ambig`` and ``-r cr-like -d`` (USA and plain), each with and
without ``--quant-subset``; infer on the dumps with and without
``--usa``.  The EM's twin adds in the host EM's order, so the EM values
are bit-identical: every artifact is compared byte for byte
(``gene_eqclass.txt.gz`` too, as both write it with gzip's MTIME 0) and
quant.json field for field without its directory fields.  Data comes from
``synth_hard`` with a numpy seed.
"""

from pathlib import Path

import numpy as np
import pytest

from alevin_fry_tpu.radz import _native as ref_native
from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.ops import em
from alevin_fry_tpu_torch.pipeline import quant
from reference_host_path import (
    DUMP_ARTIFACTS, INFER_ARTIFACTS, QUANT_ARTIFACTS, comparable_json, run_reference_infer,
    run_reference_quant,
)
from synth_hard import make_hard_dataset

DEV = ["-t", "2", "--device", "cpu"]

# name -> (t2g, the port's quant flags, the reference's quant options)
CASES = {
    "em-usa-d": ("t2g_3col.tsv", ["-r", "cr-like-em", "-d"],
                 {"resolution": "cr-like-em", "dump_eq": True}),
    "em-plain": ("t2g.tsv", ["-r", "cr-like-em"], {"resolution": "cr-like-em"}),
    "em-plain-d-uniform": ("t2g.tsv", ["-r", "cr-like-em", "-d", "--init-uniform"],
                           {"resolution": "cr-like-em", "dump_eq": True, "init_uniform": True}),
    "trivial": ("t2g.tsv", ["-r", "trivial"], {"resolution": "trivial"}),
    "prefer-ambig": ("t2g_3col.tsv", ["-r", "cr-like", "--sa-model", "prefer-ambig"],
                     {"resolution": "cr-like", "sa_model": "prefer-ambig"}),
    "crlike-usa-d": ("t2g_3col.tsv", ["-r", "cr-like", "-d"],
                     {"resolution": "cr-like", "dump_eq": True}),
    "crlike-plain-d": ("t2g.tsv", ["-r", "cr-like", "-d"],
                       {"resolution": "cr-like", "dump_eq": True}),
}


@pytest.fixture(autouse=True)
def _port_rescue_env(monkeypatch):
    monkeypatch.delenv("AFT_RESCUE_BACKEND", raising=False)


@pytest.fixture(scope="module")
def collated(tmp_path_factory):
    """synth_hard data collated by the port, and a --quant-subset list of
    every third permitted barcode."""
    d = tmp_path_factory.mktemp("qem")
    make_hard_dataset(d, np.random.RandomState(17), n_cells=300, n_reads=200_000, n_genes=500)
    gpl = d / "gpl"
    with pytest.MonkeyPatch.context() as mp:
        # set up before the per-test fixture: clear the variable here too
        mp.delenv("AFT_RESCUE_BACKEND", raising=False)
        assert port_main(["generate-permit-list", "-i", str(d / "rad"), "-d", "fw",
                          "-o", str(gpl), "-u", str(d / "permit.txt"), "-m", "10", *DEV]) == 0
        assert port_main(["collate", "-i", str(gpl), "-r", str(d / "rad"), *DEV]) == 0
    subset = d / "subset.txt"
    subset.write_text("".join((d / "permit.txt").read_text().splitlines(True)[::3]))
    return d, gpl, subset


def _mismatches(port: Path, ref: Path, names) -> list:
    bad = [n for n in names if (port / n).read_bytes() != (ref / n).read_bytes()]
    if comparable_json(port / "quant/quant.json") != comparable_json(ref / "quant/quant.json"):
        bad.append("quant/quant.json")
    return bad


def _run_both(collated, tmp: Path, name: str, subset: bool) -> tuple:
    d, gpl, subset_file = collated
    t2g, flags, ref_opts = CASES[name]
    extra = ["--quant-subset", str(subset_file)] if subset else []
    argv = ["quant", "-i", str(gpl), "-m", str(d / t2g), "-o", str(tmp / "port" / "quant"),
            *flags, *extra, *DEV]
    assert port_main(argv) == 0
    run_reference_quant(gpl, tmp / "ref" / "quant", d / t2g, "alevin-fry-tpu " + " ".join(argv),
                        2, quant_subset=subset_file if subset else None, **ref_opts)
    names = QUANT_ARTIFACTS + (DUMP_ARTIFACTS if ref_opts.get("dump_eq") else ())
    return names, _mismatches(tmp / "port", tmp / "ref", names)


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_quant_matches_reference(collated, tmp_path, name, subset):
    em.STATS["calls"] = 0
    _, bad = _run_both(collated, tmp_path, name, subset)
    assert bad == []
    n_rows = len((tmp_path / "port/quant/alevin/quants_mat_rows.txt").read_text().split())
    n_listed = len(collated[2].read_text().split())
    assert 0 < n_rows <= (n_listed if subset else n_rows)
    assert em.STATS["calls"] == (1 if "em" in name else 0)  # one block, one EM batch


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("name,usa", [("em-usa-d", True), ("em-plain-d-uniform", False)])
def test_infer_matches_reference(collated, tmp_path, name, usa, subset):
    """infer on each package's dump: the dumps are equal, and so are the
    matrices infer writes from them."""
    _run_both(collated, tmp_path, name, False)
    flags = (["--usa"] if usa else []) + (["--quant-subset", str(collated[2])] if subset else [])
    outs = {}
    for side in ("port", "ref"):
        q = tmp_path / side / "quant" / "alevin"
        outs[side] = (q / "geqc_counts.mtx", q / "gene_eqclass.txt.gz", tmp_path / side / "infer")
    assert port_main(["infer", "-c", str(outs["port"][0]), "-e", str(outs["port"][1]),
                      "-o", str(outs["port"][2]), *flags, *DEV]) == 0
    run_reference_infer(*outs["ref"], usa, collated[2] if subset else None)
    assert [n for n in INFER_ARTIFACTS
            if (tmp_path / "port" / n).read_bytes() != (tmp_path / "ref" / n).read_bytes()] == []
    body = (tmp_path / "port" / "infer" / "quants_mat.mtx").read_text().splitlines()
    assert any("." in line.split()[2] for line in body[3:])  # EM fractions were written


def test_quant_dump_in_small_blocks(collated, tmp_path, monkeypatch):
    """Many streamed blocks: per-block EM batches and dumps merge to the
    reference's bytes."""
    monkeypatch.setattr(quant, "QUANT_BLOCK_RECORDS", 30_000)
    em.STATS["calls"] = 0
    _, bad = _run_both(collated, tmp_path, "em-usa-d", False)
    assert bad == [] and em.STATS["calls"] > 2


@pytest.mark.parametrize("name", ["em-usa-d", "crlike-plain-d"])
def test_quant_dump_without_native_codec(collated, tmp_path, monkeypatch, name):
    """The reference's NumPy paths (interning, eqc rows, fractional MTX)
    write the port's bytes."""
    monkeypatch.setattr(ref_native, "_LIB", None)
    monkeypatch.setattr(ref_native, "_TRIED", True)
    _, bad = _run_both(collated, tmp_path, name, False)
    assert bad == []
