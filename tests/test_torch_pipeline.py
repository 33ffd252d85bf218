"""The port's whole slice — generate-permit-list (unfiltered, with the
1-edit rescue) -> collate -> quant (cr-like) through its CLI with
``--device cpu`` — against the reference package's host path on the
same data, the out-of-core collate against the in-memory one, plus the
boundary of the port: neither its RNA nor its ATAC stages import JAX or
any part of the reference package.

Eight data artifacts must match byte for byte and the three stage JSONs
field for field once the fields naming each run's directories are
dropped (tests/reference_host_path.py); the outputs are integers and
bytes, so every comparison is exact.  Inputs come from numpy seeds
(synth_hard) and from the deterministic RAD writers of synth.py.
"""

import json
import os
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
from alevin_fry_tpu_torch.ops.barcodes import pack_seq
from alevin_fry_tpu_torch.pipeline import collate, gpl, quant
from alevin_fry_tpu_torch.radz import _native, bincodeio
from reference_host_path import artifact_mismatches, host_policies, run_reference
from synth import write_rna_rad
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
    """With the native codec unavailable both packages take their NumPy
    paths (the port's columnar collate among them)."""
    for native in (_native, ref_native):
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_TRIED", True)
        assert not native.available()
    _check_against_reference(_synth_data(tmp_path / "d"), tmp_path, True, min_reads=1)


def test_port_never_imports_jax_or_reference_logic(tmp_path):
    d = _synth_data(tmp_path / "d")
    a = _atac_synth_data(tmp_path / "a")
    out = tmp_path / "out"
    code = f"""
import json, sys
sys.modules["jax"] = None
from alevin_fry_tpu_torch.cli import main
d, a, o = {str(d)!r}, {str(a)!r}, {str(out)!r}
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
g = o + "/agpl"
assert main(["atac", "generate-permit-list", "-i", a + "/rad", "-o", g,
             "-u", a + "/wl.txt", "-m", "1", *dev]) == 0
assert main(["atac", "sort", "-i", g, "-r", a + "/rad", "-m", "20", *dev]) == 0
assert main(["atac", "collate", "-i", g, "-r", a + "/rad", "-m", "20", *dev]) == 0
assert main(["atac", "deduplicate", "-i", g, *dev]) == 0
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
    assert {"alevin_fry_tpu_torch.ops.knee", "alevin_fry_tpu_torch.radz.snappyz"} <= set(loaded)
    assert (out / "kquant" / "alevin" / "quants_mat.mtx").exists()
    assert [m for m in loaded if m.split(".")[0] == "alevin_fry_tpu"] == []


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
    for extra, what in ((["-r", "cr-like-em"], "cr-like-em"),
                        (["-r", "cr-like", "--dump-eqclasses"], "dump-eqclasses"),
                        (["-r", "cr-like", "--sa-model", "prefer-ambig"], "prefer-ambig")):
        with pytest.raises(NotImplementedError, match=what):
            port_main(["quant", "-i", str(out / "gpl"), "-m", str(d / "t2g_3col.tsv"),
                       "-o", str(out / "q2"), *extra, "--device", "cpu"])
    assert port_main(["collate", "-i", str(out / "gpl"), "-r", str(d / "rad"), "-c",
                      "--device", "cpu"]) == 0
    assert (out / "gpl" / "map.collated.rad.sz").exists()
    monkeypatch.setenv("AFT_COORDINATOR", "localhost:1234")
    with pytest.raises(NotImplementedError, match="multi-host"):
        port_main(["collate", "-i", str(out / "gpl"), "-r", str(d / "rad"),
                   "--device", "cpu"])


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
    """The NumPy record walk and gather of the out-of-core path write
    the native path's bytes."""
    d = _synth_data(tmp_path / "d")
    _run_port(d, tmp_path / "out", True, min_reads=1)
    gpl_dir = tmp_path / "out" / "gpl"
    in_mem = (gpl_dir / "map.collated.rad").read_bytes()
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_TRIED", True)
    assert port_main(["collate", "-i", str(gpl_dir), "-r", str(d / "rad"), "-m", "7",
                      "--device", "cpu"]) == 0
    assert (gpl_dir / "map.collated.rad").read_bytes() == in_mem


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
