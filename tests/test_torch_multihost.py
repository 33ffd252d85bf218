"""Multi-process runs of the port (RNA): two ranks over gloo on the CPU
(``tools/stage_worker.py`` through ``tests/two_process.py``), each taking
its chunk range, must write the reference's one-process host path bytes
(``tests/reference_host_path.py``) on the same seeded data: quant;
quant ``-d -b 2 --summary-stat``; generate-permit-list; the whole chain
with ``collate -m 257`` (and with ``-c``); quant with the triplet spill
bound at 7 and the merge rounds at 13.  Also: a parsimony-em quant on two
ranks against the port's one-process run, with the K7 and K6 twins run
on both ranks; ``parallel/dist.py``'s gathers (unsigned keys with bit 63
set, unequal and empty parts), its bounded file concatenation and its
refusals; and the one-process spill against the reference's bytes.

Every comparison is exact: the artifacts are bytes, the stage JSONs
equal field for field without the fields that name a run's directories.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from alevin_fry_tpu.ops.barcodes import pack_seq
from alevin_fry_tpu_torch.cli import main as port_main
from alevin_fry_tpu_torch.pipeline import quant as port_quant
from reference_host_path import (
    BOOT_ARTIFACTS, DATA_ARTIFACTS, DUMP_ARTIFACTS, QUANT_ARTIFACTS, STAGE_JSONS,
    artifact_mismatches, comparable_json, run_reference, run_reference_quant,
)
from synth import write_rna_rad
from two_process import REPO, clean_env, cmdline, run_two, spawn

CPU = ["-t", "2", "--device", "cpu"]
QUANT = ("quant/alevin/quants_mat.mtx", "quant/alevin/quants_mat_rows.txt",
         "quant/alevin/quants_mat_cols.txt", "quant/featureDump.txt")


@pytest.fixture(autouse=True)
def _no_policy_env(monkeypatch):
    """Each test starts without the reference's device policies (the
    port reads AFT_RESCUE_BACKEND) or a coordinator."""
    for var in ("AFT_RESCUE_BACKEND", "AFT_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
                "AFT_NUM_PROCESSES", "AFT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)


def _rna(d: Path, seed: int, n_reads: int, chunk: int, bcs, n_refs: int = 10,
         noise: float = 0.0, per_cell=None) -> Path:
    """``d/rad/map.rad`` of 8-base barcodes ``bcs`` (1-edit variants at
    rate ``noise``; with ``per_cell``, that many reads of each barcode,
    shuffled), ``chunk`` reads a chunk; ``d/permit.txt`` lists ``bcs``;
    ``d/t2g.tsv`` maps two transcripts to a gene."""
    rng = np.random.RandomState(seed)
    refs = [f"t{i}" for i in range(n_refs)]
    reads = []
    order = ([b for b, n in zip(bcs, per_cell) for _ in range(n)] if per_cell
             else [bcs[rng.randint(len(bcs))] for _ in range(n_reads)])
    for bc in order:
        if rng.rand() < noise:
            bc = bc[:-1] + ("T" if bc[-1] == "A" else "A")
        tids = sorted(set(rng.randint(0, n_refs, rng.randint(1, 3)).tolist()))
        umi = int(rng.randint(1 << 12)) * 4 if per_cell else int(rng.randint(1 << 18))
        reads.append((pack_seq(bc), umi, [(t, True) for t in tids]))
    if per_cell:
        rng.shuffle(reads)
    (d / "rad").mkdir(parents=True)
    write_rna_rad(d / "rad" / "map.rad", refs, [reads[i:i + chunk]
                                                for i in range(0, len(reads), chunk)],
                  bc_len=8, umi_len=10)
    (d / "permit.txt").write_text("".join(b + "\n" for b in bcs))
    (d / "t2g.tsv").write_text("".join(f"t{i}\tg{i // 2}\n" for i in range(n_refs)))
    return d


FIVE = ["AAAAAAAA", "CCCCCCCC", "GGGGGGGG", "TTTTTTTT", "ACACACAC"]


def _collated(tmp: Path, d: Path) -> Path:
    """The reference's gpl and collate of ``d`` into ``tmp/pre/gpl``."""
    cmds = {"gpl": "t", "collate": "t", "quant": "t"}
    run_reference(d, tmp / "pre", cmds, False, min_reads=1, threads=2)
    return tmp / "pre" / "gpl"


def _quant_argv(gpl: Path, t2g: Path, out: Path, *flags) -> list:
    return ["quant", "-i", str(gpl), "-m", str(t2g), "-o", str(out), *flags, *CPU]


def _check_quant(tmp, d, flags, ref_opts, names, set_=()):
    """Quant ``flags`` on two ranks against the reference's one process
    on the reference's collated data; returns the ranks' summaries and
    logs."""
    gpl = _collated(tmp, d)
    argv = _quant_argv(gpl, d / "t2g.tsv", tmp / "port" / "quant", *flags)
    summaries, logs = run_two([["quant", argv]], tmp / "logs", set_)
    run_reference_quant(gpl, tmp / "ref" / "quant", d / "t2g.tsv", cmdline(argv), 2, **ref_opts)
    assert artifact_mismatches(tmp / "port", tmp / "ref", names, ("quant/quant.json",)) == []
    assert any("owns cell chunks" in lg for lg in logs)
    return summaries, logs


def test_two_process_quant_matches_single(tmp_path):
    d = _rna(tmp_path / "d", 21, 1200, 1200, FIVE)
    summaries, _ = _check_quant(tmp_path, d, ["-r", "cr-like"], {}, QUANT)
    # K1-K3's twins ran on both ranks
    for s in summaries:
        assert all(s["stages"]["quant"]["twin_calls"][k] > 0 for k in ("K1", "K2", "K3"))
        assert s["stages"]["quant"]["gloo_bytes"] > 0


def test_two_process_quant_dump_eq_bootstraps(tmp_path):
    """The gathered class dump and bootstrap matrices: interning follows
    the cells' global order, and each cell's bootstrap stream is seeded
    from its number in the file."""
    d = _rna(tmp_path / "d", 23, 0, 67, FIVE[:4], per_cell=[130, 137, 144, 151])
    summaries, _ = _check_quant(
        tmp_path, d, ["-r", "cr-like-em", "-d", "-b", "2", "--summary-stat"],
        {"resolution": "cr-like-em", "dump_eq": True, "num_bootstraps": 2,
         "summary_stat": True}, QUANT + DUMP_ARTIFACTS + BOOT_ARTIFACTS,
    )
    for s in summaries:
        assert s["stages"]["quant"]["twin_calls"]["K6"] > 0
        assert s["stages"]["quant"]["twin_calls"]["K8"] > 0


@pytest.mark.parametrize("method", ["unfiltered", "force"])
def test_two_process_gpl_matches_single(tmp_path, method):
    """Per-rank chunk-range histograms merged over gloo; every rank
    filters the merged histogram (the unfiltered list's rescue on K4's
    twin; -f 3 on the host)."""
    d = _rna(tmp_path / "d", 31, 900, 75, FIVE[:4], n_refs=6, noise=0.1)
    flags, spec = ((["-u", str(d / "permit.txt"), "-m", "1"], None) if method == "unfiltered"
                   else (["-f", "3"], "force:3"))
    argv = ["generate-permit-list", "-i", str(d / "rad"), "-d", "fw", "-o",
            str(tmp_path / "port" / "gpl"), *flags, *CPU]
    summaries, logs = run_two([["gpl", argv]], tmp_path / "logs")
    run_reference(d, tmp_path / "ref", {"gpl": cmdline(argv), "collate": "t", "quant": "t"},
                  False, min_reads=1, threads=2, cell_filter_spec=spec)
    names = ("gpl/permit_freq.bin", "gpl/permit_map.bin") + (
        ("gpl/all_freq.bin",) if spec else ())
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref", names,
                               ("gpl/generate_permit_list.json",)) == []
    assert sum("multi-host gpl: process" in lg for lg in logs) == 2
    if method == "unfiltered":
        assert all(s["stages"]["gpl"]["twin_calls"]["K4/K5"] > 0 for s in summaries)


def test_rank_with_no_chunks_enters_every_collective(tmp_path):
    """One raw chunk and one cell: rank 1 owns no chunk in any stage, yet
    enters every collective of gpl, collate and quant -r cr-like-em -d -b
    2 (the dump's and the bootstraps' gathers too); the artifacts equal
    one process's."""
    d = _rna(tmp_path / "d", 37, 0, 1000, FIVE[:1], per_cell=[160])
    stages = lambda out: [
        ["gpl", ["generate-permit-list", "-i", str(d / "rad"), "-d", "fw", "-o",
                 str(out / "gpl"), "-u", str(d / "permit.txt"), "-m", "1", *CPU]],
        ["collate", ["collate", "-i", str(out / "gpl"), "-r", str(d / "rad"), *CPU]],
        ["quant", _quant_argv(out / "gpl", d / "t2g.tsv", out / "quant", "-r", "cr-like-em",
                              "-d", "-b", "2")],
    ]
    _summaries, logs = run_two(stages(tmp_path / "two"), tmp_path / "logs")
    for _name, argv in stages(tmp_path / "one"):
        assert port_main(argv) == 0
    assert artifact_mismatches(tmp_path / "two", tmp_path / "one",
                               DATA_ARTIFACTS + DUMP_ARTIFACTS + BOOT_ARTIFACTS, ()) == []
    assert "owns cell chunks [1, 1)" in logs[1]


@pytest.mark.parametrize("compress", [False, True])
def test_two_process_full_chain_matches_single(tmp_path, compress):
    """gpl -> collate -m 257 (-c) -> quant on two ranks: the collate's
    buckets gather over gloo in rank order, the chunk order."""
    d = _rna(tmp_path / "d", 41, 1500, 111, FIVE[:4] + ["ACGTACGT"], n_refs=12, noise=0.08)
    (d / "t2g.tsv").write_text("".join(f"t{i}\tg{i // 3}\n" for i in range(12)))
    out = tmp_path / "port"
    stages = [
        ["gpl", ["generate-permit-list", "-i", str(d / "rad"), "-d", "fw", "-o",
                 str(out / "gpl"), "-u", str(d / "permit.txt"), "-m", "1", *CPU]],
        ["collate", ["collate", "-i", str(out / "gpl"), "-r", str(d / "rad"), "-m", "257",
                     *(["-c"] if compress else []), *CPU]],
        ["quant", _quant_argv(out / "gpl", d / "t2g.tsv", out / "quant", "-r", "cr-like")],
    ]
    _summaries, logs = run_two(stages, tmp_path / "logs")
    run_reference(d, tmp_path / "ref", {k: cmdline(a) for k, a in stages}, False,
                  min_reads=1, threads=2, compress=compress, max_records=257)
    names = tuple(n.replace("map.collated.rad", "map.collated.rad.sz") if compress else n
                  for n in DATA_ARTIFACTS)
    assert artifact_mismatches(out, tmp_path / "ref", names, STAGE_JSONS) == []
    assert any("multi-host collate" in lg for lg in logs)
    assert not list((out / "gpl").glob("_collate_tmp*"))


def test_two_process_quant_spill_bounded(tmp_path):
    """Both ranks spill past a bound of 7 triplets to their binary
    sidecars; rank 0 merges the body in rounds of 13 triplets."""
    d = _rna(tmp_path / "d", 53, 1100, 1100, FIVE)
    _, logs = _check_quant(
        tmp_path, d, ["-r", "cr-like"], {}, QUANT,
        set_=[("alevin_fry_tpu_torch.pipeline.quant", "QUANT_SPILL_TRIPLETS", 7),
              ("alevin_fry_tpu_torch.pipeline.quant", "QUANT_MERGE_TRIPLETS", 13)],
    )
    assert sum("spilled to the rank-local binary" in lg for lg in logs) == 2
    assert not list((tmp_path / "port" / "quant" / "alevin").glob(".quants_coo_r*"))


def test_two_process_parsimony_em_matches_one_process(tmp_path):
    """parsimony-em -d on two ranks (K7's and K6's twins on each) writes
    the one-process run's bytes."""
    d = _rna(tmp_path / "d", 29, 0, 67, FIVE[:4], per_cell=[130, 137, 144, 151])
    gpl = _collated(tmp_path, d)
    flags = ["-r", "parsimony-em", "-d", "--umi-edit-dist", "0", "--large-graph-thresh", "2"]
    argv = _quant_argv(gpl, d / "t2g.tsv", tmp_path / "two" / "quant", *flags)
    summaries, _ = run_two([["quant", argv]], tmp_path / "logs")
    assert port_main(_quant_argv(gpl, d / "t2g.tsv", tmp_path / "one" / "quant", *flags)) == 0
    assert artifact_mismatches(tmp_path / "two", tmp_path / "one", QUANT + DUMP_ARTIFACTS,
                               ()) == []
    one, two = (comparable_json(tmp_path / run / "quant" / "quant.json") for run in ("one", "two"))
    for js in (one, two):  # the command lines name the output directories
        del js["cmd"], js["quant_options"]["cmdline"]
    assert one == two
    for s in summaries:
        calls = s["stages"]["quant"]["twin_calls"]
        assert calls["K7"] > 0 and calls["K6"] > 0, calls


_DIST = r"""
import io, json, os, sys
import numpy as np
from alevin_fry_tpu_torch.parallel import dist
rank, world = dist.rank_world()
out = {}
key = np.array([(1 << 63) | (7 << 40) | rank, (1 << 64) - 1 - rank], np.uint64)[: 1 + rank]
out["u64"] = [p.tolist() for p in dist.allgather_ragged(key)]
out["u32"] = [p.tolist() for p in dist.allgather_ragged(
    np.array([0xFFFFFFFF, 0x80000000 + rank, 5], np.uint32)[: 3 * rank])]
out["empty"] = [p.dtype.str + str(len(p)) for p in dist.allgather_ragged(np.zeros(0, np.uint64))]
out["f64"] = [p.tolist() for p in dist.allgather_ragged(np.full(rank + 1, 0.1 * (rank + 1)))]
before = dist.SENT_BYTES
out["root"] = [p.tolist() for p in dist.gather_to_root(key)]
out["root_u32"] = [p.tolist() for p in dist.gather_to_root(np.arange(3 * rank, dtype=np.uint32))]
out["root_sent"] = dist.SENT_BYTES - before
path = sys.argv[1] + f"/part{rank}.bin"
data = bytes((rank * 7 + i) % 251 for i in range(1000 + 37 * rank))
open(path, "wb").write(data)
sink = io.BytesIO() if rank == 0 else None
out["concat_n"] = dist.stream_concat_files(path, sink, chunk_bytes=64)
if rank == 0:
    open(sys.argv[1] + "/concat.bin", "wb").write(sink.getvalue())
out["sent"] = dist.SENT_BYTES
dist.finalize()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """One two-rank run of the snippet above."""
    tmp = tmp_path_factory.mktemp("dist")
    env = clean_env(AFT_COORDINATOR=f"127.0.0.1:{__import__('two_process').free_port()}")
    argv = [sys.executable, "-c", _DIST, str(tmp)]
    res = spawn([argv, argv], tmp / "logs", env, 60)
    assert all(rc == 0 for rc, _o, _e in res), res[0][2][-3000:] + res[1][2][-3000:]
    return tmp, [json.loads(o.strip().splitlines()[-1]) for _rc, o, _e in res]


def test_allgather_ragged_keeps_unsigned_bits(dist_run):
    _tmp, outs = dist_run
    want_u64 = [[(1 << 63) | (7 << 40)], [(1 << 63) | (7 << 40) | 1, (1 << 64) - 2]]
    want_u32 = [[], [0xFFFFFFFF, 0x80000001, 5]]
    for out in outs:
        assert out["u64"] == want_u64
        assert out["u32"] == want_u32
        assert out["empty"] == ["<u80", "<u80"]
        assert out["f64"] == [[0.1], [0.2, 0.2]]


def test_gather_to_root_reaches_rank_0_alone(dist_run):
    """Rank 0 gets every rank's array bit for bit, the other rank empty
    arrays; rank 0 sends nothing, rank 1 its arrays and their lengths."""
    _tmp, outs = dist_run
    want_u64 = [[(1 << 63) | (7 << 40)], [(1 << 63) | (7 << 40) | 1, (1 << 64) - 2]]
    assert outs[0]["root"] == want_u64
    assert outs[0]["root_u32"] == [[], [0, 1, 2]]
    assert outs[1]["root"] == [[], []] and outs[1]["root_u32"] == [[], []]
    assert outs[0]["root_sent"] == 0
    assert outs[1]["root_sent"] == 8 + 16 + 8 + 12


def test_stream_concat_files_in_rounds_smaller_than_a_file(dist_run):
    tmp, outs = dist_run
    want = b"".join(bytes((r * 7 + i) % 251 for i in range(1000 + 37 * r)) for r in (0, 1))
    assert (tmp / "concat.bin").read_bytes() == want
    assert [o["concat_n"] for o in outs] == [len(want)] * 2
    # rank 1 sent its file once, in rounds, besides the gathers
    assert outs[1]["sent"] >= 1037


def test_unreachable_coordinator_raises(tmp_path):
    """A rank whose peers never come raises after the rendezvous timeout,
    and a coordinator without the other two variables raises at once."""
    code = ("import sys; from alevin_fry_tpu_torch.parallel import dist; dist.TIMEOUT_S = 3; "
            "dist.initialize()")
    env = clean_env(AFT_COORDINATOR=f"127.0.0.1:{__import__('two_process').free_port()}",
                    AFT_NUM_PROCESSES="2", AFT_PROCESS_ID="1")
    import subprocess

    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode != 0 and "Error" in proc.stderr
    del env["AFT_NUM_PROCESSES"]
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode != 0 and "ValueError" in proc.stderr
    assert "AFT_NUM_PROCESSES" in proc.stderr


@pytest.mark.parametrize("bound", [7, 10**9])
def test_one_process_spill_matches_reference(tmp_path, monkeypatch, bound):
    """One process past its spill bound streams the same bytes as one
    that keeps every triplet in memory, the reference's."""
    d = _rna(tmp_path / "d", 21, 1200, 300, FIVE)
    gpl = _collated(tmp_path, d)
    monkeypatch.setattr(port_quant, "QUANT_SPILL_TRIPLETS", bound)
    argv = _quant_argv(gpl, d / "t2g.tsv", tmp_path / "port" / "quant", "-r", "cr-like")
    assert port_main(argv) == 0
    run_reference_quant(gpl, tmp_path / "ref" / "quant", d / "t2g.tsv", cmdline(argv), 2)
    assert artifact_mismatches(tmp_path / "port", tmp_path / "ref", QUANT_ARTIFACTS,
                               ("quant/quant.json",)) == []
    assert not list((tmp_path / "port" / "quant" / "alevin").glob("*.tmp"))


def test_stages_join_under_a_coordinator_and_never_init_without(tmp_path):
    """Without a coordinator no stage initializes torch.distributed; the
    boundary test (test_torch_pipeline.py) loads parallel.dist."""
    d = _rna(tmp_path / "d", 21, 300, 100, FIVE)
    code = f"""
import json, sys
sys.modules["jax"] = None
import torch.distributed as td
from alevin_fry_tpu_torch.cli import main
d, o = {str(d)!r}, {str(tmp_path / 'o')!r}
assert main(["generate-permit-list", "-i", d + "/rad", "-d", "fw", "-o", o + "/gpl",
             "-u", d + "/permit.txt", "-m", "1", "--device", "cpu"]) == 0
assert main(["collate", "-i", o + "/gpl", "-r", d + "/rad", "--device", "cpu"]) == 0
assert main(["quant", "-i", o + "/gpl", "-m", d + "/t2g.tsv", "-o", o + "/q", "-r", "trivial",
             "--device", "cpu"]) == 0
print(json.dumps([td.is_initialized(), "alevin_fry_tpu_torch.parallel.dist" in sys.modules]))
"""
    import subprocess

    proc = subprocess.run([sys.executable, "-c", code], env=clean_env(), capture_output=True,
                          text=True, timeout=100, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [False, True]
