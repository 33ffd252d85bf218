"""The port's spans (``alevin_fry_tpu_torch/spans.py``): gpl -> collate
-> quant and atac gpl -> atac sort through the CLI with ``--device cpu``
on small synth_hard data, each pipeline run once to warm up (imports,
first calls) and once measured, as the benchmark does.

Each stage must give one root span; every span of its tree must lie
inside the root, the prefetch producer's ``read`` spans with the root as
their parent; the main thread's spans must cover at least 95% of the
root; the root must count the RAD records decoded and the bytes of the
files the stage wrote.  Past ``CAP`` spans are counted, not kept.
"""

import struct
from pathlib import Path

import numpy as np
import pytest

from alevin_fry_tpu_torch import spans
from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.radz import read_prelude
from synth_hard import make_hard_atac_dataset, make_hard_dataset

CPU = ["-t", "2", "--device", "cpu"]
# stage -> (argv, the RAD file it decodes, the directory it writes into)
STAGES = {
    "generate-permit-list": (
        "generate-permit-list -i {r}/rad -d fw -o {o}/gpl -u {r}/permit.txt -m 10",
        "{r}/rad/map.rad", "{o}/gpl"),
    "collate": ("collate -i {o}/gpl -r {r}/rad", "{r}/rad/map.rad", "{o}/gpl"),
    "quant": ("quant -i {o}/gpl -m {r}/t2g_3col.tsv -o {o}/quant -r cr-like",
              "{o}/gpl/map.collated.rad", "{o}/quant"),
    "atac generate-permit-list": (
        "atac generate-permit-list -i {a}/rad -o {o}/agpl -u {a}/wl.txt -m 10",
        "{a}/rad/map.rad", "{o}/agpl"),
    "atac sort": ("atac sort -i {o}/agpl -r {a}/rad -m 40000", "{a}/rad/map.rad",
                  "{o}/agpl"),
}
# the producer thread's reads: stages that read their input prefetched
PREFETCHED = {"generate-permit-list", "quant", "atac generate-permit-list", "atac sort"}


def _rad_records(path: Path) -> tuple:
    """The records of a RAD file, from its chunk headers, and the bytes
    of its chunks."""
    n = 0
    with open(path, "rb") as fh:
        start = read_prelude(fh)[2]
        while len(hdr := fh.read(8)) == 8:
            nbytes, nrec = struct.unpack("<II", hdr)
            fh.seek(nbytes - 8, 1)
            n += nrec
    return n, path.stat().st_size - start


def _sizes(d: Path) -> dict:
    return {p: (p.stat().st_size, p.stat().st_mtime_ns) for p in d.rglob("*") if p.is_file()}


def _tree(root, new) -> list:
    """The spans of ``new`` whose parents lead to ``root``."""
    def top(sp):
        while sp.parent is not None:
            sp = sp.parent
        return sp
    return [sp for sp in new if sp is not root and top(sp) is root]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Each stage's new spans, its root, and the records and bytes it
    should have counted, from the measured pass."""
    base = tmp_path_factory.mktemp("trace")
    r, a = base / "rna", base / "atac"
    r.mkdir()
    a.mkdir()
    make_hard_dataset(r, np.random.RandomState(5), n_cells=200, n_reads=400_000, n_genes=300)
    make_hard_atac_dataset(a, np.random.RandomState(11), n_cells=200, n_frags=200_000,
                           n_chrs=4, chr_len=2_000_000, ambient_factor=8)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for var in ("AFT_RESCUE_BACKEND", "AFT_COORDINATOR", "AFT_NUM_PROCESSES",
                    "AFT_PROCESS_ID", "AFT_PREFETCH", "AFT_GPL_MESH"):
            mp.delenv(var, raising=False)
        for run in ("warm", "measured"):
            o = base / run
            for name, (argv, rad, wdir) in STAGES.items():
                fmt = dict(r=r, a=a, o=o)
                wdir = Path(wdir.format(**fmt))
                before = _sizes(wdir) if wdir.exists() else {}
                n0 = len(spans.SPANS)
                assert port_main(argv.format(**fmt).split() + CPU) == 0
                new = spans.SPANS[n0:]
                after = _sizes(wdir)
                written = sum(s for p, (s, t) in after.items() if before.get(p) != (s, t))
                out[name] = (new, _rad_records(Path(rad.format(**fmt))), written)
    return out


@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_has_one_root_holding_its_tree(traced, stage):
    """One root a stage, named by the subcommand; every span of its tree
    inside it; the producer's reads parented to the root."""
    new, _records, _written = traced[stage]
    roots = [sp for sp in new if sp.parent is None]
    assert [(sp.name, sp.layer) for sp in roots] == [(stage, "stage")]
    root = roots[0]
    tree = _tree(root, new)
    assert len(tree) == len(new) - 1 and tree
    for sp in tree:
        assert root.start_ns <= sp.start_ns <= sp.end_ns <= root.end_ns, sp
        assert sp.layer in spans.LAYERS[1:], sp
    producer = [sp for sp in tree if sp.thread != root.thread]
    assert all(sp.name == "read" and sp.parent is root for sp in producer)
    assert bool(producer) == (stage in PREFETCHED)
    waits = [sp for sp in tree if sp.layer == "wait"]
    assert all(sp.thread == root.thread for sp in waits)


@pytest.mark.parametrize("stage", list(STAGES))
def test_main_thread_spans_cover_the_root(traced, stage):
    """The root's own time (no phase span open on the main thread) is
    under 5% of it, and the summary line's phases add up to the root."""
    new, _records, _written = traced[stage]
    root = new[-1]
    assert root.parent is None
    assert root.self_ns <= 0.05 * (root.end_ns - root.start_ns), spans.summary(root)
    selfs = spans.self_seconds(root)
    assert sum(selfs.values()) == pytest.approx(root.seconds, rel=1e-6)
    line = spans.summary(root)
    assert line.startswith(f"{stage}: ") and "unspanned" in line and " MB, wrote " in line


@pytest.mark.parametrize("stage", list(STAGES))
def test_root_counts_records_and_bytes(traced, stage):
    """``records``: the records of the RAD file the stage decodes;
    ``bytes_read``: the bytes of its chunks; ``bytes_written``: the
    bytes of the files the stage wrote."""
    new, (records, chunk_bytes), written = traced[stage]
    attrs = new[-1].attrs
    assert attrs["records"] == records > 0
    assert attrs["bytes_read"] == chunk_bytes
    assert attrs["bytes_written"] == written > 0


def test_cap_counts_spans_dropped(monkeypatch):
    """Past CAP a closed span is counted in ``dropped``, not kept, and
    still rolls its counts into its parent."""
    monkeypatch.setattr(spans, "CAP", len(spans.SPANS) + 2)
    dropped = spans.dropped
    with spans.span("outer", "stage") as outer:
        for _ in range(4):
            with spans.span("inner", "codec"):
                spans.add("records", 3)
    assert len(spans.SPANS) == spans.CAP
    assert spans.dropped == dropped + 3
    assert outer.attrs == {"records": 12}
    with pytest.raises(ValueError):
        with spans.span("x", "other"):
            pass
