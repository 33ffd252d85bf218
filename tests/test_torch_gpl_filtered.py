"""The port's filtered permit lists (generate-permit-list -k / -f / -e /
-b, alevin_fry_tpu_torch/pipeline/gpl.py::_process_filtered) against the
reference package's host path, on synth_hard data and through collate
and quant; the rule for a 1-edit neighbour of several permitted
barcodes; and the knee finder (alevin_fry_tpu_torch/ops/knee.py)
against ``alevin_fry_tpu.ops.knee.get_knee``.

Artifacts must match byte for byte and the stage JSONs field for field
without the fields naming each run's directories
(tests/reference_host_path.py); knees are integers, compared exactly.
Inputs come from numpy seeds (synth_hard, RandomState) and the
deterministic RAD writer of synth.py.
"""

import numpy as np
import pytest

from alevin_fry_tpu.ops.knee import get_knee as ref_get_knee
from alevin_fry_tpu.radz import _native as ref_native
from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.ops import barcodes, knee
from alevin_fry_tpu_torch.ops.barcodes import pack_seq
from alevin_fry_tpu_torch.radz import bincodeio
from reference_host_path import STAGE_JSONS, artifact_mismatches, rna_artifacts, run_reference
from synth import write_rna_rad
from synth_hard import make_hard_dataset


@pytest.fixture(scope="module")
def hard_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("hard_filtered")
    make_hard_dataset(d, np.random.RandomState(5), n_cells=300, n_reads=150_000,
                      n_genes=400)
    # an explicit list: a shuffled third of the permit list, in file order
    lines = (d / "permit.txt").read_text().split()
    pick = np.random.RandomState(6).permutation(len(lines))[: len(lines) // 3]
    (d / "explicit.txt").write_text("".join(lines[i] + "\n" for i in pick))
    return d


def _filter_args(spec: str, d) -> list:
    kind, _, arg = spec.partition(":")
    return {"knee": ["-k"], "force": ["-f", arg], "expect": ["-e", arg],
            "explicit": ["-b", str(d / arg)]}[kind]


def _ref_spec(spec: str, d) -> str:
    kind, _, arg = spec.partition(":")
    return f"explicit:{d / arg}" if kind == "explicit" else spec


def run_filtered(d, out, spec: str, extra_collate=(), stages=("gpl", "collate", "quant")):
    """The port's stages through its CLI with a filtered gpl; returns
    the command line each recorded."""
    dev = ["-t", "2", "--device", "cpu"]
    argv = {
        "gpl": ["generate-permit-list", "-i", str(d / "rad"), "-d", "fw",
                "-o", str(out / "gpl"), *_filter_args(spec, d), *dev],
        "collate": ["collate", "-i", str(out / "gpl"), "-r", str(d / "rad"),
                    *extra_collate, *dev],
        "quant": ["quant", "-i", str(out / "gpl"), "-m", str(d / "t2g_3col.tsv"),
                  "-o", str(out / "quant"), "-r", "cr-like", *dev],
    }
    for name in stages:
        assert port_main(argv[name]) == 0
    return {k: "alevin-fry-tpu " + " ".join(v) for k, v in argv.items()}


@pytest.mark.parametrize("spec", ["knee", "force:250", "expect:300", "explicit:explicit.txt"])
def test_filtered_gpl_matches_reference(hard_data, tmp_path, spec, monkeypatch):
    """Each filtered method's permit_freq.bin, all_freq.bin,
    permit_map.bin and JSON, then collate and quant over its map, equal
    the reference's.  The explicit list names barcodes no read carries,
    which the reference's byte-level collate refuses (ROADMAP.md §3), so
    there the reference runs without its native codec, on its columnar
    path; the port keeps its byte-level path."""
    if spec.startswith("explicit"):
        monkeypatch.setattr(ref_native, "_LIB", None)
        monkeypatch.setattr(ref_native, "_TRIED", True)
    cmdlines = run_filtered(hard_data, tmp_path / "port", spec)
    run_reference(hard_data, tmp_path / "ref", cmdlines, True, threads=2,
                  cell_filter_spec=_ref_spec(spec, hard_data))
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref",
                               rna_artifacts(filtered=True), STAGE_JSONS) == []
    _, kept, counts = bincodeio.read_permit_freq(tmp_path / "port" / "gpl" / "permit_freq.bin")
    _, seen, _ = bincodeio.read_permit_freq(tmp_path / "port" / "gpl" / "all_freq.bin")
    keys, _ = bincodeio.read_u64_map_file(tmp_path / "port" / "gpl" / "permit_map.bin")
    # the map holds every kept barcode's 1-edit neighbours, and the
    # filter kept a real subset of the observed barcodes
    assert 0 < len(kept) < len(seen) and len(keys) > 20 * len(kept)
    assert (tmp_path / "port" / "gpl" / "generate_permit_list.json").read_text().count(
        '"permit-list-type": "filtered"') == 1


def _contested_data(d):
    """Six cells of 8 bases.  AAAAAAAC is one substitution from both
    AAAAAAAA (60 reads) and AAAAAACC (40); CCCCCCCA from both CCCCCCCC
    and CCCCCCAA (30 each); GGGGGGGT is one indel from GGGGGGTA (35)
    and one substitution from GGGGGGGG (50); each neighbour has reads."""
    cells = {"AAAAAAAA": 60, "AAAAAACC": 40, "CCCCCCCC": 30, "CCCCCCAA": 30,
             "GGGGGGGG": 50, "GGGGGGTA": 35, "AAAAAAAC": 3, "CCCCCCCA": 4,
             "GGGGGGGT": 2}
    rng = np.random.RandomState(8)
    reads = [(pack_seq(bc), int(rng.randint(64)), [(int(rng.randint(6)), True)])
             for bc, n in cells.items() for _ in range(n)]
    reads = [reads[i] for i in rng.permutation(len(reads))]
    (d / "rad").mkdir(parents=True)
    write_rna_rad(d / "rad" / "map.rad", [f"tx_{i}" for i in range(6)],
                  [reads[:100], reads[100:]], bc_len=8, umi_len=6)
    (d / "t2g_3col.tsv").write_text(
        "".join(f"tx_{i}\tg_{i // 2}\t{'SU'[i % 2]}\n" for i in range(6)))
    (d / "explicit.txt").write_text(
        "CCCCCCAA\nAAAAAACC\nGGGGGGTA\nCCCCCCCC\nAAAAAAAA\nGGGGGGGG\n")
    return d


@pytest.mark.parametrize("spec,winners", [
    # by read count, then the smaller barcode
    ("force:6", {"AAAAAAAC": "AAAAAAAA", "CCCCCCCA": "CCCCCCAA", "GGGGGGGT": "GGGGGGGG"}),
    # an explicit list: the first in the file
    ("explicit:explicit.txt",
     {"AAAAAAAC": "AAAAAACC", "CCCCCCCA": "CCCCCCAA", "GGGGGGGT": "GGGGGGTA"}),
])
def test_contested_neighbour_rule(tmp_path, spec, winners):
    """A barcode within one edit of two permitted barcodes maps to the
    one the JAX package's rule picks (docs/parity.md:48-53), in both
    packages, through collate and quant."""
    d = _contested_data(tmp_path / "d")
    cmdlines = run_filtered(d, tmp_path / "port", spec)
    run_reference(d, tmp_path / "ref", cmdlines, True, threads=2,
                  cell_filter_spec=_ref_spec(spec, d))
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref",
                               rna_artifacts(filtered=True), STAGE_JSONS) == []
    keys, vals = bincodeio.read_u64_map_file(tmp_path / "port" / "gpl" / "permit_map.bin")
    mapped = dict(zip(keys.tolist(), vals.tolist()))
    for nb, win in winners.items():
        assert mapped[pack_seq(nb)] == pack_seq(win), nb


def test_permitlist_map_neighbours():
    """The map of one barcode: itself, its 3L substitutions and its
    distinct interior indels, each to it."""
    bc = np.asarray([pack_seq("ACGTTGCA")], np.uint64)
    keys, vals = barcodes.generate_permitlist_map(bc, 8)
    assert (vals == bc[0]).all() and np.array_equal(keys, np.unique(keys))
    snps = barcodes.snp_neighbors(bc, 8)[0]
    indels = barcodes.indel_neighbors(bc, 8)[0]
    assert np.array_equal(keys, np.unique(np.concatenate([bc, snps, indels])))
    assert len(np.setdiff1d(snps, bc)) == 3 * 8


def _knee_cases():
    rng = np.random.RandomState(12)
    cells = np.sort(rng.lognormal(6, 0.6, 400).astype(np.uint64))[::-1]
    ambient = np.sort(rng.geometric(0.3, 5000).astype(np.uint64))[::-1]
    return {
        "cells and ambient": np.concatenate([cells, ambient]),
        "plateaus (ties)": np.repeat(np.asarray([900, 900, 500, 20, 20, 3, 1], np.uint64),
                                     [40, 40, 30, 200, 200, 300, 500]),
        "all equal": np.full(50, 7, np.uint64),
        "two": np.asarray([10, 1], np.uint64),
        "three": np.asarray([30, 29, 1], np.uint64),
        "geometric": np.sort(rng.geometric(0.01, 3000).astype(np.uint64))[::-1],
        "large counts": np.sort(rng.randint(1, 1 << 40, 2000, dtype=np.uint64))[::-1],
    }


@pytest.mark.parametrize("case", list(_knee_cases()))
def test_knee_matches_reference(case):
    freq = _knee_cases()[case]
    """The same knee, or the same refusal: the reference asserts on a
    knee at 0 where the port raises ValueError."""
    for iters in (100, 1, 0):
        try:
            want = ref_get_knee(freq, iters)
        except (AssertionError, ValueError) as exc:
            msg = "knee index of 0" if isinstance(exc, AssertionError) else str(exc)
            with pytest.raises(ValueError, match=msg):
                knee.get_knee(freq, iters)
            continue
        assert knee.get_knee(freq, iters) == want


def test_knee_needs_two_barcodes():
    for freq in (np.zeros(0, np.uint64), np.asarray([5], np.uint64)):
        with pytest.raises(ValueError, match="at least 2"):
            knee.get_knee(freq)
