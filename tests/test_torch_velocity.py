"""Velocity mode in the port against the reference package's host path:
generate-permit-list's ``velo_mode`` option (the library API: neither
CLI has a flag) recorded in ``generate_permit_list.json`` on the
unfiltered, knee and Flex paths; collate of a velocity-mode directory
writing ``velo.map.collated.rad`` (the snappy stream under that name
with ``-c``) from the byte-level, columnar and out-of-core writers and
from two processes; Flex and ATAC directories keeping
``map.collated.rad`` with the flag set.

Every comparison is exact: the artifacts are bytes, the stage JSONs
equal field for field (and key for key, in order) without the fields
that name a run's directories (tests/reference_host_path.py).  Inputs
come from numpy seeds (synth_hard) and the deterministic RAD writers of
synth.py.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.ops.barcodes import unpack_seq
from alevin_fry_tpu_torch.pipeline import collate
from alevin_fry_tpu_torch.pipeline.gpl import (
    CellFilterMethod, GenPermitListOpts, generate_permit_list,
)
from alevin_fry_tpu_torch.radz.snappyz import SnappyFrameReader
from reference_host_path import (
    artifact_mismatches, flex_artifacts, run_reference_collate,
    run_reference_gpl,
)
from synth import make_packed_bc, write_multi_bc_rad
from synth_hard import make_hard_dataset
from test_torch_atac import _atac_synth_data
from test_torch_multihost import FIVE, _rna
from two_process import cmdline, run_two

CPU = ["-t", "2", "--device", "cpu"]
VELO = "velo.map.collated.rad"
SIDECARS = ("gpl/unmapped_bc_count_collated.bin",)
SNAPPY_MAGIC = b"\xff\x06\x00\x00sNaPpY"


@pytest.fixture(autouse=True)
def _no_policy_env(monkeypatch):
    """The port reads AFT_RESCUE_BACKEND, where ``host`` raises, and a
    coordinator; a reference test module in the same process may have
    set them."""
    for var in ("AFT_RESCUE_BACKEND", "AFT_COORDINATOR", "AFT_NUM_PROCESSES",
                "AFT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def hard_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("hard_velo")
    make_hard_dataset(d, np.random.RandomState(23), n_cells=300, n_reads=120_000,
                      n_genes=400)
    return d


def _flex_data(d: Path) -> Path:
    """Two Flex samples of four cells sharing their cell barcodes, with a
    two-column sample list."""
    samples = [make_packed_bc(100, 8), make_packed_bc(200, 8)]
    (d / "rad").mkdir(parents=True)
    write_multi_bc_rad(d / "rad" / "map.rad", [f"gene_{i}" for i in range(6)], 2, 4, 7,
                       samples, share_cell_barcodes=True)
    (d / "samples.tsv").write_text("".join(f"{unpack_seq(bc, 8)}\ts{i}\n"
                                           for i, bc in enumerate(samples)))
    return d


# path -> (the port's cell filter, the reference's spec, -d, the sample list)
GPL_PATHS = {
    "unfiltered": (lambda d: CellFilterMethod("unfiltered", path=d / "permit.txt",
                                              min_reads=10), None, "fw", False),
    "knee": (lambda d: CellFilterMethod("knee"), "knee", "fw", False),
    "flex": (lambda d: CellFilterMethod("force", count=4), "force:4", "both", True),
}


def port_gpl(d: Path, gpl: Path, path: str, velo_mode: bool, cmd: str) -> None:
    """The port's generate-permit-list through its library API."""
    fmeth, _spec, ori, flex = GPL_PATHS[path]
    generate_permit_list(GenPermitListOpts(
        input_dir=d / "rad", output_dir=gpl, fmeth=fmeth(d), expected_ori=ori,
        device=torch.device("cpu"), threads=2, velo_mode=velo_mode, cmdline=cmd,
        sample_bc_list=d / "samples.tsv" if flex else None,
    ))


def ref_gpl(d: Path, gpl: Path, path: str, velo_mode: bool, cmd: str) -> None:
    _fmeth, spec, ori, flex = GPL_PATHS[path]
    run_reference_gpl(d, gpl, cmd, spec, threads=2, expected_ori=ori, velo_mode=velo_mode,
                      gpl_opts={"sample_bc_list": d / "samples.tsv"} if flex else None)


def _gpl_files(run: Path, path: str) -> tuple:
    if path == "flex":
        return tuple(a for a in flex_artifacts(run) if a.startswith("gpl/sample_"))
    return ("gpl/permit_freq.bin", "gpl/permit_map.bin") + (
        ("gpl/all_freq.bin",) if path == "knee" else ())


def _key_order(p: Path) -> list:
    js = json.loads(p.read_text())
    return [list(js), list(js.get("gpl_options", {}))]


@pytest.mark.parametrize("velo_mode", [True, False])
@pytest.mark.parametrize("path", list(GPL_PATHS))
def test_gpl_velo_mode_json_matches_reference(hard_data, tmp_path, path, velo_mode):
    """The gpl JSON records ``velo_mode`` where the reference does (top
    level and ``gpl_options``; the Flex JSON has no options record), field
    for field and key for key, with the permit files byte for byte."""
    d = _flex_data(tmp_path / "f") if path == "flex" else hard_data
    cmd = f"alevin-fry-tpu generate-permit-list {path}"
    port_gpl(d, tmp_path / "port" / "gpl", path, velo_mode, cmd)
    ref_gpl(d, tmp_path / "ref" / "gpl", path, velo_mode, cmd)
    names = _gpl_files(tmp_path / "port", path)
    assert names == _gpl_files(tmp_path / "ref", path) and len(names) >= 2
    js = "gpl/generate_permit_list.json"
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref", names, (js,)) == []
    assert _key_order(tmp_path / "port" / js) == _key_order(tmp_path / "ref" / js)
    got = json.loads((tmp_path / "port" / js).read_text())
    assert got["velo_mode"] is velo_mode
    assert ("gpl_options" not in got) if path == "flex" else \
        got["gpl_options"]["velo_mode"] is velo_mode


@pytest.fixture(scope="module")
def velo_gpl(hard_data, tmp_path_factory):
    """The port's velocity-mode gpl -u of hard_data, and the bytes a plain
    in-memory collate writes from the same permit files without the flag."""
    tmp = tmp_path_factory.mktemp("velo_gpl")
    port_gpl(hard_data, tmp / "velo", "unfiltered", True, "alevin-fry-tpu gpl")
    shutil.copytree(tmp / "velo", tmp / "plain")
    js = tmp / "plain" / "generate_permit_list.json"
    js.write_text(json.dumps({**json.loads(js.read_text()), "velo_mode": False}))
    assert port_main(["collate", "-i", str(tmp / "plain"), "-r", str(hard_data / "rad"),
                      *CPU]) == 0
    return tmp / "velo", (tmp / "plain" / "map.collated.rad").read_bytes()


def _decompressed(p: Path) -> bytes:
    with SnappyFrameReader(open(p, "rb")) as fh:
        return fh.read()


# case -> (collate -m, -c, the port's byte-level path off)
COLLATE_CASES = {
    "in memory": (30_000_000, False, False),
    "columnar": (30_000_000, False, True),
    "out of core": (20_000, False, False),
    "-c in memory": (30_000_000, True, False),
    "-c out of core": (20_000, True, False),
}


@pytest.mark.parametrize("case", list(COLLATE_CASES))
def test_velo_collate_matches_reference(hard_data, velo_gpl, tmp_path, case, monkeypatch):
    """Each collate writer names the collated file velo.map.collated.rad,
    with -c too (the snappy stream of the plain bytes), byte-identical to
    the reference's collate of the same directory; collate.json and the
    unmapped sidecar as usual, and no map.collated.rad*."""
    max_records, compress, columnar = COLLATE_CASES[case]
    gpl_dir, plain = velo_gpl
    monkeypatch.setattr(collate, "COLLATE_BLOCK_RECORDS", 30_000)
    calls = []
    if columnar:
        monkeypatch.setattr(collate, "_collate_in_memory_native", lambda *a, **k: False)
        real = collate._collate_columnar
        monkeypatch.setattr(collate, "_collate_columnar",
                            lambda *a, **k: calls.append(a) or real(*a, **k))
    for run in ("port", "ref"):
        shutil.copytree(gpl_dir, tmp_path / run / "gpl")
    argv = ["collate", "-i", str(tmp_path / "port" / "gpl"), "-r", str(hard_data / "rad"),
            "-m", str(max_records), *(["-c"] if compress else []), *CPU]
    assert port_main(argv) == 0
    run_reference_collate(tmp_path / "ref" / "gpl", hard_data / "rad", cmdline(argv),
                          compress, max_records, threads=2)
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref", ("gpl/" + VELO,) + SIDECARS,
                               ("gpl/collate.json",)) == []
    for run in ("port", "ref"):
        assert not list((tmp_path / run / "gpl").glob("map.collated.rad*"))
        assert not list((tmp_path / run / "gpl").glob("_collate_tmp*"))
    port = tmp_path / "port" / "gpl"
    assert json.loads((port / "collate.json").read_text())["compressed_output"] is compress
    got = (port / VELO).read_bytes()
    assert got.startswith(SNAPPY_MAGIC) is compress
    assert (_decompressed(port / VELO) if compress else got) == plain
    assert bool(calls) is columnar


@pytest.mark.parametrize("kind", ["flex", "atac"])
def test_flex_and_atac_keep_collated_name(tmp_path, kind, monkeypatch):
    """A Flex directory goes to the multi-barcode collate before the flag
    is read, and atac collate never reads it: both write map.collated.rad
    (map.collated.rad.sz with -c).  Flex against the reference's run with
    the flag; ATAC's gpl records no flag, so it is set by hand, and the
    collated bytes equal those of the directory without it."""
    if kind == "flex":
        d = _flex_data(tmp_path / "f")
        port_gpl(d, tmp_path / "port" / "gpl", "flex", True, "alevin-fry-tpu gpl")
        ref_gpl(d, tmp_path / "ref" / "gpl", "flex", True, "alevin-fry-tpu gpl")
        sub = []
    else:
        d = _atac_synth_data(tmp_path / "a")
        assert port_main(["atac", "generate-permit-list", "-i", str(d / "rad"), "-o",
                          str(tmp_path / "ref" / "gpl"), "-u", str(d / "wl.txt"), "-m", "1",
                          *CPU]) == 0
        shutil.copytree(tmp_path / "ref" / "gpl", tmp_path / "port" / "gpl")
        js = tmp_path / "port" / "gpl" / "generate_permit_list.json"
        assert "velo_mode" not in json.loads(js.read_text())
        js.write_text(json.dumps({**json.loads(js.read_text()), "velo_mode": True}))
        sub = ["atac"]
    shutil.copytree(tmp_path / "port" / "gpl", tmp_path / "port_sz" / "gpl")
    for run, extra in (("port", []), ("port_sz", ["-c"])):
        assert port_main([*sub, "collate", "-i", str(tmp_path / run / "gpl"), "-r",
                          str(d / "rad"), *extra, *CPU]) == 0
    if kind == "flex":
        run_reference_collate(tmp_path / "ref" / "gpl", d / "rad", "alevin-fry-tpu collate",
                              threads=2)
        names = tuple(a for a in flex_artifacts(tmp_path / "port") if a.startswith("gpl/"))
        jsons = ("gpl/generate_permit_list.json", "gpl/sample_info.json")
        assert json.loads((tmp_path / "port" / jsons[0]).read_text())["velo_mode"] is True
    else:
        assert port_main(["atac", "collate", "-i", str(tmp_path / "ref" / "gpl"), "-r",
                          str(d / "rad"), *CPU]) == 0
        names, jsons = ("gpl/map.collated.rad",) + SIDECARS, ()
    assert "gpl/map.collated.rad" in names
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref", names, jsons) == []
    sz = tmp_path / "port_sz" / "gpl"
    assert _decompressed(sz / "map.collated.rad.sz") == \
        (tmp_path / "port" / "gpl" / "map.collated.rad").read_bytes()
    for run in ("port", "port_sz"):
        assert not list((tmp_path / run / "gpl").glob("velo.*"))


@pytest.mark.parametrize("compress", [False, True])
def test_two_process_velo_collate_matches_reference(tmp_path, compress):
    """A two-rank collate of a velocity-mode directory (out of core over
    gloo) writes at rank 0 the reference's one-process
    velo.map.collated.rad."""
    d = _rna(tmp_path / "d", 43, 1500, 111, FIVE[:4] + ["ACGTACGT"], n_refs=12, noise=0.08)
    run_reference_gpl(d, tmp_path / "ref" / "gpl", "alevin-fry-tpu gpl", min_reads=1,
                      threads=2, velo_mode=True)
    shutil.copytree(tmp_path / "ref" / "gpl", tmp_path / "port" / "gpl")
    argv = ["collate", "-i", str(tmp_path / "port" / "gpl"), "-r", str(d / "rad"), "-m", "257",
            *(["-c"] if compress else []), *CPU]
    _summaries, logs = run_two([["collate", argv]], tmp_path / "logs")
    run_reference_collate(tmp_path / "ref" / "gpl", d / "rad", cmdline(argv), compress, 257,
                          threads=2)
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref", ("gpl/" + VELO,) + SIDECARS,
                               ("gpl/collate.json",)) == []
    assert any("multi-host collate" in lg for lg in logs)
    assert not list((tmp_path / "port" / "gpl").glob("map.collated.rad*"))
    assert not list((tmp_path / "port" / "gpl").glob("_collate_tmp*"))
