"""The port's whole slice — generate-permit-list (unfiltered, with the
1-edit rescue) -> collate -> quant (cr-like) through its CLI with
``--device cpu`` — against the reference package's host path on the
same data, the out-of-core collate against the in-memory one, plus the
boundary of the port: none of its stages (RNA, ATAC, Flex, convert and
view) imports JAX or any part of the reference package.

Eight data artifacts must match byte for byte and the three stage JSONs
field for field once the fields naming each run's directories are
dropped (tests/reference_host_path.py); the outputs are integers and
bytes, so every comparison is exact.  Inputs come from numpy seeds
(synth_hard) and from the deterministic RAD writers of synth.py.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from alevin_fry_tpu.pipeline.collate import collate as ref_collate
from alevin_fry_tpu.radz import _native as ref_native
from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.device import resolve_device
from alevin_fry_tpu_torch.ops.barcodes import pack_seq, unpack_seq
from alevin_fry_tpu_torch.pipeline import collate, gpl, quant
from alevin_fry_tpu_torch.radz import bincodeio
from reference_host_path import artifact_mismatches, host_policies, run_reference
from bam_cases import make_bam_dataset
from synth import make_packed_bc, write_multi_bc_rad, write_rna_rad
from synth_hard import make_hard_dataset
from test_torch_atac import _atac_synth_data

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _port_rescue_env(monkeypatch):
    """The port reads AFT_RESCUE_BACKEND, where ``host`` raises.  A
    reference test module imported into the same process may have set
    it for the reference's goldens, so each test starts without it."""
    monkeypatch.delenv("AFT_RESCUE_BACKEND", raising=False)


@pytest.fixture(scope="module")
def hard_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("hard")
    make_hard_dataset(d, np.random.RandomState(7), n_cells=300, n_reads=200_000, n_genes=500)
    return d


def _synth_data(d: Path) -> Path:
    """Two cells with 8-base barcodes; one read barcode is a 1-edit
    variant of a permitted one (rescued), one is 2 edits away (dropped),
    and some alignments are reverse-strand (filtered by -d fw)."""
    rng = np.random.RandomState(3)
    cells = {"AAAAAAAA": 40, "CCCCCCCC": 30, "AAAAAAAT": 5, "GGGGAAAA": 4}
    reads = []
    for bc, n in cells.items():
        for _ in range(n):
            alns = [(int(rng.randint(6)), bool(rng.rand() < 0.9))
                    for _ in range(rng.randint(1, 3))]
            reads.append((pack_seq(bc), int(rng.randint(16)), alns))
    order = rng.permutation(len(reads))
    reads = [reads[i] for i in order]
    (d / "rad").mkdir(parents=True)
    write_rna_rad(d / "rad" / "map.rad", [f"tx_{i}" for i in range(6)],
                  [reads[:60], reads[60:]], bc_len=8, umi_len=6)
    (d / "permit.txt").write_text("AAAAAAAA\nCCCCCCCC\nTTTTTTTT\n")
    (d / "t2g.tsv").write_text("".join(f"tx_{i}\tg_{i // 2}\n" for i in range(6)))
    (d / "t2g_3col.tsv").write_text(
        "".join(f"tx_{i}\tg_{i // 2}\t{'SU'[i % 2]}\n" for i in range(6))
    )
    return d


def _run_port(d: Path, out: Path, usa: bool, min_reads: int, device: str = "cpu") -> dict:
    """The three stages through the port's CLI; returns the command
    line each stage recorded."""
    dev = ["-t", "2", "--device", device]
    stages = {
        "gpl": ["generate-permit-list", "-i", str(d / "rad"), "-d", "fw",
                "-o", str(out / "gpl"), "-u", str(d / "permit.txt"),
                "-m", str(min_reads), *dev],
        "collate": ["collate", "-i", str(out / "gpl"), "-r", str(d / "rad"), *dev],
        "quant": ["quant", "-i", str(out / "gpl"),
                  "-m", str(d / ("t2g_3col.tsv" if usa else "t2g.tsv")),
                  "-o", str(out / "quant"), "-r", "cr-like", *dev],
    }
    for argv in stages.values():
        assert port_main(argv) == 0
    return {k: "alevin-fry-tpu " + " ".join(v) for k, v in stages.items()}


def _check_against_reference(d: Path, tmp: Path, usa: bool, min_reads: int) -> None:
    cmdlines = _run_port(d, tmp / "port", usa, min_reads)
    run_reference(d, tmp / "ref", cmdlines, usa, min_reads=min_reads, threads=2)
    assert artifact_mismatches(tmp / "port", tmp / "ref") == []
    # the rescue corrected at least one barcode: the correction map holds
    # more than the kept barcodes' identity entries
    keys, _ = bincodeio.read_u64_map_file(tmp / "port" / "gpl" / "permit_map.bin")
    _, kept, _ = bincodeio.read_permit_freq(tmp / "port" / "gpl" / "permit_freq.bin")
    assert len(keys) > len(kept)


@pytest.mark.parametrize("usa", [True, False])
def test_slice_matches_reference_on_synth_hard(hard_data, tmp_path, usa):
    _check_against_reference(hard_data, tmp_path, usa, min_reads=10)


def test_slice_matches_reference_in_small_blocks(hard_data, tmp_path, monkeypatch):
    """Streaming the RAD files in many blocks (histograms merged in gpl,
    per-block results merged in quant) changes no byte."""
    monkeypatch.setattr(gpl, "GPL_BLOCK_RECORDS", 30_000)
    monkeypatch.setattr(quant, "QUANT_BLOCK_RECORDS", 30_000)
    _check_against_reference(hard_data, tmp_path, True, min_reads=10)


@pytest.mark.parametrize("usa", [True, False])
def test_slice_matches_reference_on_synth(tmp_path, usa):
    _check_against_reference(_synth_data(tmp_path / "d"), tmp_path, usa, min_reads=1)


def test_slice_matches_reference_without_native_codec(tmp_path, monkeypatch):
    """The reference without its native codec (its NumPy record walk,
    columnar collate and writers) writes the port's bytes."""
    monkeypatch.setattr(ref_native, "_LIB", None)
    monkeypatch.setattr(ref_native, "_TRIED", True)
    assert not ref_native.available()
    _check_against_reference(_synth_data(tmp_path / "d"), tmp_path, True, min_reads=1)


def test_port_never_imports_jax_or_reference_logic(tmp_path):
    d = _synth_data(tmp_path / "d")
    a = _atac_synth_data(tmp_path / "a")
    f = _flex_synth_data(tmp_path / "f")
    b = make_bam_dataset(tmp_path / "b", 1, 2000, n_cells=5, n_genes=10, threads=2)["path"]
    out = tmp_path / "out"
    code = f"""
import json, sys
sys.modules["jax"] = None
from alevin_fry_tpu_torch.cli import main
d, a, f, o, b = {str(d)!r}, {str(a)!r}, {str(f)!r}, {str(out)!r}, {b!r}
dev = ["-t", "2", "--device", "cpu"]
assert main(["generate-permit-list", "-i", d + "/rad", "-d", "fw", "-o", o + "/gpl",
             "-u", d + "/permit.txt", "-m", "1", *dev]) == 0
assert main(["collate", "-i", o + "/gpl", "-r", d + "/rad", *dev]) == 0
assert main(["quant", "-i", o + "/gpl", "-m", d + "/t2g_3col.tsv", "-o", o + "/quant",
             "-r", "cr-like", *dev]) == 0
assert main(["generate-permit-list", "-i", d + "/rad", "-d", "fw", "-o", o + "/kgpl",
             "-k", *dev]) == 0
assert main(["collate", "-i", o + "/kgpl", "-r", d + "/rad", "-c", *dev]) == 0
assert main(["quant", "-i", o + "/kgpl", "-m", d + "/t2g_3col.tsv", "-o", o + "/kquant",
             "-r", "cr-like", *dev]) == 0
assert main(["quant", "-i", o + "/gpl", "-m", d + "/t2g_3col.tsv", "-o", o + "/equant",
             "-r", "cr-like-em", "-d", *dev]) == 0
assert main(["infer", "-c", o + "/equant/alevin/geqc_counts.mtx", "-e",
             o + "/equant/alevin/gene_eqclass.txt.gz", "-o", o + "/infer", "--usa", *dev]) == 0
assert main(["quant", "-i", o + "/gpl", "-m", d + "/t2g.tsv", "-o", o + "/pquant",
             "-r", "parsimony-em", "-d", *dev]) == 0
g = o + "/agpl"
assert main(["atac", "generate-permit-list", "-i", a + "/rad", "-o", g,
             "-u", a + "/wl.txt", "-m", "1", *dev]) == 0
assert main(["atac", "sort", "-i", g, "-r", a + "/rad", "-m", "20", *dev]) == 0
assert main(["atac", "collate", "-i", g, "-r", a + "/rad", "-m", "20", *dev]) == 0
assert main(["atac", "deduplicate", "-i", g, *dev]) == 0
assert main(["generate-permit-list", "-i", f + "/rad", "-d", "both", "-o", o + "/fgpl",
             "--sample-bc-list", f + "/samples.tsv", "-f", "3", *dev]) == 0
assert main(["collate", "-i", o + "/fgpl", "-r", f + "/rad", *dev]) == 0
assert main(["quant", "-i", o + "/fgpl", "-m", f + "/t2g.tsv", "-o", o + "/fquant",
             "-r", "cr-like", *dev]) == 0
assert main(["convert", "-b", b, "-o", o + "/crad/map.rad", "-t", "2", "-f"]) == 0
assert main(["view", "-r", o + "/crad/map.rad", "-H"]) == 0
print(json.dumps(sorted(m for m in sys.modules if m.startswith("alevin_fry_tpu"))))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (out / "quant" / "alevin" / "quants_mat.mtx").exists()
    assert (out / "agpl" / "map.bed").stat().st_size > 0
    assert any(m.startswith("alevin_fry_tpu_torch.atac") for m in loaded)
    assert any(m.startswith("alevin_fry_tpu_torch.pipeline") for m in loaded)
    assert any(m.startswith("alevin_fry_tpu_torch.radz") for m in loaded)
    assert {"alevin_fry_tpu_torch.ops.knee", "alevin_fry_tpu_torch.radz.snappyz",
            "alevin_fry_tpu_torch.ops.em", "alevin_fry_tpu_torch.pipeline.infer",
            "alevin_fry_tpu_torch.ops.pug", "alevin_fry_tpu_torch.ops.pug_device"} <= set(loaded)
    assert (out / "pquant" / "alevin" / "quants_mat.mtx").exists()
    assert (out / "infer" / "quants_mat.mtx").exists()
    assert (out / "kquant" / "alevin" / "quants_mat.mtx").exists()
    assert (out / "fquant" / "featureDump.txt").read_text().startswith("CB\tsample_name\t")
    assert {"alevin_fry_tpu_torch.pipeline.gpl_multi", "alevin_fry_tpu_torch.pipeline.collate_multi",
            "alevin_fry_tpu_torch.radz.collation"} <= set(loaded)
    assert {"alevin_fry_tpu_torch.pipeline.convert", "alevin_fry_tpu_torch.pipeline.view",
            "alevin_fry_tpu_torch.radz.writers"} <= set(loaded)
    assert proc.stdout.count("\tDIR:") > 100  # view's lines
    assert [m for m in loaded if m.split(".")[0] == "alevin_fry_tpu"] == []
    # every stage asked the multi-process layer, which joined no run
    assert "alevin_fry_tpu_torch.parallel.dist" in loaded


def _flex_synth_data(d: Path) -> Path:
    """Two Flex samples of three cells sharing their cell barcodes, a
    two-column sample list and a plain t2g."""
    samples = [make_packed_bc(100, 8), make_packed_bc(200, 8)]
    (d / "rad").mkdir(parents=True)
    write_multi_bc_rad(d / "rad" / "map.rad", [f"gene_{i}" for i in range(6)], 2, 3, 6,
                       samples, share_cell_barcodes=True)
    (d / "samples.tsv").write_text("".join(f"{unpack_seq(bc, 8)}\ts{i}\n"
                                           for i, bc in enumerate(samples)))
    (d / "t2g.tsv").write_text("".join(f"gene_{i}\tgene_{i}\n" for i in range(6)))
    return d


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")


def test_unported_options_raise(tmp_path, monkeypatch):
    d = _synth_data(tmp_path / "d")
    out = tmp_path / "out"
    # the knee filter (-k) and -c are ported: they run
    assert port_main(["generate-permit-list", "-i", str(d / "rad"), "-d", "fw",
                      "-o", str(tmp_path / "knee"), "-k", "--device", "cpu"]) == 0
    _run_port(d, out, True, min_reads=1)
    # bootstraps are ported; USA mode refuses them, as the reference does
    for extra, what in ((["-r", "cr-like-em", "-b", "2"], "USA-mode analysis cannot be used "
                                                          "with bootstrapping"),):
        with pytest.raises(AssertionError, match=what):
            port_main(["quant", "-i", str(out / "gpl"), "-m", str(d / "t2g_3col.tsv"),
                       "-o", str(out / "q2"), *extra, "--device", "cpu"])
    assert port_main(["collate", "-i", str(out / "gpl"), "-r", str(d / "rad"), "-c",
                      "--device", "cpu"]) == 0
    assert (out / "gpl" / "map.collated.rad.sz").exists()
    # Flex is ported: its three stages run
    f = _flex_synth_data(tmp_path / "f")
    assert port_main(["generate-permit-list", "-i", str(f / "rad"), "-d", "both",
                      "-o", str(tmp_path / "fgpl"), "--sample-bc-list", str(f / "samples.tsv"),
                      "-f", "3", "--device", "cpu"]) == 0
    assert port_main(["collate", "-i", str(tmp_path / "fgpl"), "-r", str(f / "rad"),
                      "--collation-mode", "two-round", "--device", "cpu"]) == 0
    assert port_main(["quant", "-i", str(tmp_path / "fgpl"), "-m", str(f / "t2g.tsv"),
                      "-o", str(tmp_path / "fquant"), "-r", "cr-like", "--device", "cpu"]) == 0
    # multi-process runs are ported (tests/test_torch_multihost*.py): a
    # coordinator without AFT_NUM_PROCESSES and AFT_PROCESS_ID raises
    # before any connection
    monkeypatch.setenv("AFT_COORDINATOR", "localhost:1234")
    with pytest.raises(ValueError, match="AFT_NUM_PROCESSES"):
        port_main(["collate", "-i", str(out / "gpl"), "-r", str(d / "rad"),
                   "--device", "cpu"])
    with pytest.raises(ValueError, match="AFT_NUM_PROCESSES"):
        port_main(["generate-permit-list", "-i", str(f / "rad"), "-d", "both",
                   "-o", str(tmp_path / "fgpl2"), "--sample-bc-list", str(f / "samples.tsv"),
                   "-f", "3", "--device", "cpu"])
    # infer never joins a multi-process run: it runs under a coordinator
    monkeypatch.delenv("AFT_COORDINATOR")
    equant = ["quant", "-i", str(out / "gpl"), "-m", str(d / "t2g_3col.tsv"),
              "-o", str(out / "eq"), "-r", "cr-like-em", "-d", "--device", "cpu"]
    assert port_main(equant) == 0
    infer = ["infer", "-c", str(out / "eq" / "alevin" / "geqc_counts.mtx"),
             "-e", str(out / "eq" / "alevin" / "gene_eqclass.txt.gz"),
             "-o", str(tmp_path / "infer"), "--usa", "--device", "cpu"]
    monkeypatch.setenv("AFT_COORDINATOR", "localhost:1234")
    assert port_main(infer) == 0
    assert (tmp_path / "infer" / "quants_mat.mtx").exists()
    monkeypatch.delenv("AFT_COORDINATOR")
    # device meshes are ported (tests/test_torch_mesh.py): gpl's, and the
    # EM's in quant and infer, run and write the bytes of a run without
    gpl_argv = ["generate-permit-list", "-i", str(d / "rad"), "-d", "fw", "-o",
                str(tmp_path / "mgpl"), "-u", str(d / "permit.txt"), "-m", "1",
                "--device", "cpu"]
    monkeypatch.setenv("AFT_GPL_MESH", "3")
    assert port_main(gpl_argv) == 0
    monkeypatch.delenv("AFT_GPL_MESH")
    for name in ("permit_freq.bin", "permit_map.bin"):
        assert (tmp_path / "mgpl" / name).read_bytes() == (out / "gpl" / name).read_bytes()
    monkeypatch.setenv("AFT_EM_MESH", "2")
    mesh_out = {"quant": out / "meq", "infer": tmp_path / "minfer"}
    assert port_main([*equant[:6], str(mesh_out["quant"]), *equant[7:]]) == 0
    assert port_main([*infer[:6], str(mesh_out["infer"]), *infer[7:]]) == 0
    monkeypatch.delenv("AFT_EM_MESH")
    for name in ("alevin/quants_mat.mtx", "alevin/geqc_counts.mtx"):
        assert (mesh_out["quant"] / name).read_bytes() == (out / "eq" / name).read_bytes()
    assert (mesh_out["infer"] / "quants_mat.mtx").read_bytes() == \
        (tmp_path / "infer" / "quants_mat.mtx").read_bytes()
    # velocity mode is ported (tests/test_torch_velocity.py): collate
    # writes velo.map.collated.rad; quant raises, as in the reference
    velo = tmp_path / "velo"
    shutil.copytree(out / "gpl", velo)
    meta = json.loads((velo / "generate_permit_list.json").read_text())
    (velo / "generate_permit_list.json").write_text(json.dumps({**meta, "velo_mode": True}))
    assert port_main(["collate", "-i", str(velo), "-r", str(d / "rad"), "--device", "cpu"]) == 0
    assert (velo / "velo.map.collated.rad").read_bytes() == \
        (out / "gpl" / "map.collated.rad").read_bytes()
    with pytest.raises(NotImplementedError, match="velocity mode is not implemented on this "
                                                  "branch"):
        port_main(["quant", "-i", str(velo), "-m", str(d / "t2g.tsv"), "-o",
                   str(tmp_path / "vq"), "-r", "cr-like", "--device", "cpu"])


@pytest.mark.parametrize("max_records", [40, 700, 20_000])
def test_out_of_core_collate_matches_in_memory_and_reference(hard_data, tmp_path,
                                                             max_records, monkeypatch):
    """``--max-records`` below the record count spills to buckets of
    consecutive cell ranks and writes the in-memory
    path's bytes, which are the reference's; small scatter blocks change
    no byte either."""
    monkeypatch.setattr(collate, "COLLATE_BLOCK_RECORDS", 30_000)
    cmdlines = _run_port(hard_data, tmp_path / "port", True, min_reads=10)
    gpl_dir = tmp_path / "port" / "gpl"
    in_mem = (gpl_dir / "map.collated.rad").read_bytes()
    assert port_main(["collate", "-i", str(gpl_dir), "-r", str(hard_data / "rad"),
                      "-m", str(max_records), "-t", "2", "--device", "cpu"]) == 0
    assert (gpl_dir / "map.collated.rad").read_bytes() == in_mem
    assert not (gpl_dir / "_collate_tmp").exists()
    run_reference(hard_data, tmp_path / "ref", cmdlines, True, min_reads=10, threads=2)
    assert (tmp_path / "ref" / "gpl" / "map.collated.rad").read_bytes() == in_mem
    with host_policies():
        ref_collate(tmp_path / "ref" / "gpl", hard_data / "rad", 2, max_records,
                    cmdline=cmdlines["collate"])
    assert (tmp_path / "ref" / "gpl" / "map.collated.rad").read_bytes() == in_mem


def test_out_of_core_collate_without_native_codec(tmp_path, monkeypatch):
    """The port's out-of-core collate writes its in-memory bytes, and the
    reference's out-of-core collate without its native codec (its NumPy
    record walk and gather) writes them too."""
    d = _synth_data(tmp_path / "d")
    cmdlines = _run_port(d, tmp_path / "out", True, min_reads=1)
    gpl_dir = tmp_path / "out" / "gpl"
    in_mem = (gpl_dir / "map.collated.rad").read_bytes()
    ref_dir = tmp_path / "ref_gpl"
    shutil.copytree(gpl_dir, ref_dir)
    assert port_main(["collate", "-i", str(gpl_dir), "-r", str(d / "rad"), "-m", "7",
                      "--device", "cpu"]) == 0
    assert (gpl_dir / "map.collated.rad").read_bytes() == in_mem
    monkeypatch.setattr(ref_native, "_LIB", None)
    monkeypatch.setattr(ref_native, "_TRIED", True)
    with host_policies():
        ref_collate(ref_dir, d / "rad", 2, 7, cmdline=cmdlines["collate"])
    assert (ref_dir / "map.collated.rad").read_bytes() == in_mem


def test_gpl_records_sample_flags_on_plain_rna(tmp_path):
    """The multi-barcode (Flex) flags on a plain RNA input are recorded
    in generate_permit_list.json and change nothing else, as in the
    reference."""
    d = _synth_data(tmp_path / "d")
    (d / "samples.txt").write_text("ACGTACGT\n")
    (d / "names.txt").write_text("ACGTACGT\tsample_1\n")
    flex = {"sample_bc_list": d / "samples.txt", "sample_names": d / "names.txt",
            "sample_correction_mode": "1-edit", "sample_bc_ori": "reverse"}
    cmdlines = _run_port(d, tmp_path / "port", True, min_reads=1)
    argv = ["generate-permit-list", "-i", str(d / "rad"), "-d", "fw",
            "-o", str(tmp_path / "port" / "gpl"), "-u", str(d / "permit.txt"), "-m", "1",
            "--sample-bc-list", str(d / "samples.txt"), "--sample-names",
            str(d / "names.txt"), "--sample-correction-mode", "1-edit",
            "--sample-bc-ori", "reverse", "-t", "2", "--device", "cpu"]
    assert port_main(argv) == 0
    cmdlines["gpl"] = "alevin-fry-tpu " + " ".join(argv)
    run_reference(d, tmp_path / "ref", cmdlines, True, min_reads=1, threads=2,
                  gpl_opts=flex)
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref") == []
    opts = json.loads((tmp_path / "port" / "gpl" / "generate_permit_list.json").read_text())
    assert opts["gpl_options"]["sample_bc_ori"] == "reverse"
    assert opts["gpl_options"]["sample_bc_list"] == str(d / "samples.txt")


@pytest.mark.parametrize("extra", [["-r", "trivial", "-d"], ["-r", "cr-like", "-b", "5"]])
def test_quant_refusals_match_reference(tmp_path, capsys, extra):
    """-d with trivial and bootstraps with a non-EM resolution: the
    reference's message on stderr and exit code 1."""
    from alevin_fry_tpu.cli import main as ref_main

    d = _synth_data(tmp_path / "d")
    _run_port(d, tmp_path / "out", True, min_reads=1)
    argv = ["quant", "-i", str(tmp_path / "out" / "gpl"), "-m", str(d / "t2g_3col.tsv"),
            "-o", str(tmp_path / "q"), *extra]
    capsys.readouterr()
    got = (port_main(argv + ["--device", "cpu"]), capsys.readouterr().err)
    want = (ref_main(argv), capsys.readouterr().err)
    assert got == want and got[0] == 1 and got[1].strip()
    assert not (tmp_path / "q").exists()


def test_slice_matches_reference_with_28_base_umis(tmp_path, monkeypatch):
    """28-base UMIs are 56 bits, so the (cell, UMI, gene) keys pass 62
    bits and quant resolves them as three words on the device path."""
    from alevin_fry_tpu_torch.ops import crlike

    calls = []
    real = crlike.resolve_crlike_wta_words
    monkeypatch.setattr(crlike, "resolve_crlike_wta_words",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    d = tmp_path / "d"
    d.mkdir()
    make_hard_dataset(d, np.random.RandomState(13), n_cells=200, n_reads=60_000,
                      n_genes=300, umi_len=28)
    _check_against_reference(d, tmp_path, True, min_reads=10)
    assert calls
