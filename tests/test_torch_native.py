"""The port's native codec (``csrc/libradc.so``, bound in
``alevin_fry_tpu_torch/radz/_native.py``) is required: every subcommand
of the port's CLI loads it first, and where it does not load the
subcommand raises one ``RuntimeError`` naming the library before it
reads or writes any file.  The inputs are real (made with the library
loaded), so each subcommand would otherwise run on them.
"""

from pathlib import Path

import pytest

from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.radz import _native
from bam_cases import make_bam_dataset
from test_torch_atac import _atac_synth_data
from test_torch_pipeline import _synth_data

DEV = ["-t", "2", "--device", "cpu"]


def make_native_unloadable(monkeypatch, tmp_path: Path) -> None:
    """The port's library search finds a file that is no shared library,
    nothing is loaded yet, and the failed open is not retried."""
    bad = tmp_path / "not_a_library" / "libradc.so"
    bad.parent.mkdir(exist_ok=True)
    bad.write_bytes(b"not a shared library")
    monkeypatch.setattr(_native, "_find_lib", lambda: str(bad))
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_OPEN_ATTEMPTS", 1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Inputs for every subcommand: RNA data with its gpl, collate and a
    ``-d`` EM quant (infer's inputs), ATAC data with its gpl and collate,
    and a BAM."""
    root = tmp_path_factory.mktemp("native_inputs")
    d = _synth_data(root / "rna")
    gpl = root / "rna_gpl"
    a = _atac_synth_data(root / "atac")
    agpl = root / "atac_gpl"
    for argv in (
        ["generate-permit-list", "-i", str(d / "rad"), "-d", "fw", "-o", str(gpl),
         "-u", str(d / "permit.txt"), "-m", "1", *DEV],
        ["collate", "-i", str(gpl), "-r", str(d / "rad"), *DEV],
        ["quant", "-i", str(gpl), "-m", str(d / "t2g_3col.tsv"), "-o", str(root / "quant"),
         "-r", "cr-like-em", "-d", *DEV],
        ["atac", "generate-permit-list", "-i", str(a / "rad"), "-o", str(agpl),
         "-u", str(a / "wl.txt"), "-m", "1", *DEV],
        ["atac", "collate", "-i", str(agpl), "-r", str(a / "rad"), *DEV],
    ):
        assert port_main(argv) == 0
    bam = make_bam_dataset(root / "bam", 1, 500, n_cells=5, n_genes=10, threads=2)["path"]
    return {"root": root, "d": d, "gpl": gpl, "a": a, "agpl": agpl, "bam": Path(bam)}


def _argv(name: str, i: dict, out: Path) -> list:
    d, gpl, a, agpl, q = i["d"], i["gpl"], i["a"], i["agpl"], i["root"] / "quant" / "alevin"
    return {
        "generate-permit-list": ["generate-permit-list", "-i", str(d / "rad"), "-d", "fw",
                                 "-o", str(out), "-u", str(d / "permit.txt"), "-m", "1", *DEV],
        "collate": ["collate", "-i", str(gpl), "-r", str(d / "rad"), *DEV],
        "quant": ["quant", "-i", str(gpl), "-m", str(d / "t2g.tsv"), "-o", str(out),
                  "-r", "cr-like", *DEV],
        "infer": ["infer", "-c", str(q / "geqc_counts.mtx"),
                  "-e", str(q / "gene_eqclass.txt.gz"), "-o", str(out), "--usa", *DEV],
        "convert": ["convert", "-b", str(i["bam"]), "-o", str(out / "map.rad"), "-t", "2"],
        "view": ["view", "-r", str(d / "rad" / "map.rad"), "-H"],
        "atac generate-permit-list": ["atac", "generate-permit-list", "-i", str(a / "rad"),
                                      "-o", str(out), "-u", str(a / "wl.txt"), "-m", "1", *DEV],
        "atac collate": ["atac", "collate", "-i", str(agpl), "-r", str(a / "rad"), *DEV],
        "atac sort": ["atac", "sort", "-i", str(agpl), "-r", str(a / "rad"), *DEV],
        "atac deduplicate": ["atac", "deduplicate", "-i", str(agpl), *DEV],
    }[name]


def _files(root: Path) -> dict:
    return {p: p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("name", [
    "generate-permit-list", "collate", "quant", "infer", "convert", "view",
    "atac generate-permit-list", "atac collate", "atac sort", "atac deduplicate",
])
def test_every_subcommand_refuses_to_run_without_the_native_codec(name, inputs, tmp_path,
                                                                  monkeypatch, capsys):
    """With the library unloadable the subcommand raises RuntimeError
    naming ``libradc.so``: it writes no output (its output directory is
    not made; a stage that writes into its input directory leaves every
    file there as it was) and prints nothing."""
    before = _files(inputs["root"])
    out = tmp_path / "out"
    make_native_unloadable(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="libradc.so"):
        port_main(_argv(name, inputs, out))
    assert not out.exists()
    assert _files(inputs["root"]) == before
    assert capsys.readouterr().out == ""
