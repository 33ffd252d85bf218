#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (alevin_fry_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, one line each:

0. the card (nvidia-smi name and power limit), torch and CUDA versions,
   whether the port's native RAD codec (csrc/libradc.so) loaded and
   whether its glibc malloc tuning is on;
1. builds the CUDA kernels (csrc/*.cu, one nvcc per source, in
   parallel) and prints the build seconds and each kernel's registers
   and shared memory;
2. runs kernels K1-K5 on the card against their plain PyTorch twins at
   fixed shapes (exact integer equality): K1-K3, each one launch of the
   single-pass look-back scan, in every direction up to 134,217,731 rows
   (tens of thousands of tiles of look-back), and the segment
   toolkit built on them against its CPU result; K4 and K5 against their
   brute-force twins and the probe twin, with duplicated kept codes, 32-base
   codes that use bit 63, a one-code table, tables larger than the
   kernels' shared-memory sample, and the shape of a 50M-read run (1.7M
   queries x 1.1M kept, brute-force twins on its first 20,000 queries);
   K5 against K4 on the same inputs; CUDA-event times;
3. generates a 10x-v3-shaped synthetic dataset (tests/synth_hard.py:
   10,000 cells, 20M reads, 20,000 genes, 3-column t2g) and runs the
   port's generate-permit-list -> collate -> quant -r cr-like on the
   card through its CLI, asserting that K1-K4 each launched;
4. runs the reference package's host path on the same data (in a
   subprocess, tests/reference_host_path.py) and asserts that the eight
   data artifacts match byte for byte and the three stage JSONs field
   for field; then replays each kernel and its twin on the inputs the
   main path gave it (exact equality, CUDA-event times, the bound from
   the bytes each kernel must move, and the time of the one PyTorch
   call that computes the same function where there is one; beside K1
   and K2, torch.cumsum's time on their input as a yardstick of one
   pass);
5. generates a 10x-scATAC-shaped synthetic dataset
   (tests/synth_hard.py::make_hard_atac_dataset: 10,000 cells, 20M
   fragments, 24 chromosomes of 130 Mb, 16-base barcodes, a 744k
   reverse-complement whitelist) and runs the port's atac
   generate-permit-list (rescue on K5: AFT_RESCUE_BACKEND=pallas for
   this phase only) -> sort -> collate -> deduplicate on the card
   through its CLI, sort and collate out of core (-m 6000000),
   asserting that K1, K2 and K5 each launched; then the reference's
   host path on the same data, the eight data artifacts byte for byte,
   the three stage JSONs and deduplicate's four counters; then K1, K2
   and K5 each replayed against its twin on the largest input this path
   gave it.

With --profile, phases 3 and 5 also run each stage under torch.profiler
and cProfile and print the device's busy time (the union of its kernel
and copy intervals), its idle share and the host's largest self times.

The last lines are the kernels' JSON summary (one row per kernel and
path, each with that path's launches and shapes), the card's name and power
limit, and {"ok": true, "device": {...}}.  Any failure raises and exits
non-zero; without a CUDA device it exits non-zero before printing a
result.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
N_CELLS, N_READS, N_GENES, THREADS = 10_000, 20_000_000, 20_000, 8
# the ATAC data: 10x scATAC widths (16-base barcodes, a whitelist the
# size of 10x's 737K list, about the human genome's 3.1 Gb); only the
# depth is cut, and -m sends sort and collate out of core as a run of
# 10^8 fragments does under the default 30M
ATAC_SEED, ATAC_CELLS, ATAC_FRAGS, ATAC_CHRS, ATAC_CHR_LEN, ATAC_AMBIENT = (
    11, 10_000, 20_000_000, 24, 130_000_000, 30)
ATAC_MAX_RECORDS = 6_000_000
# the last is some 33k tiles of the single-pass scan, so its look-back
# crosses tens of thousands of tiles; the CPU toolkit comparison stops at
# SEGSCAN_TOOLKIT_MAX_N
SEGSCAN_SIZES = (1, 4097, 32769, 4_194_304, 12_000_001, 134_217_731)
SEGSCAN_TOOLKIT_MAX_N = 12_000_001
SEGSCAN_TIMED_N = 4_194_304
# (queries, kept, bases, duplicated kept codes) of the K4 and K5 checks;
# the first is also timed.  30,000 and more kept codes exceed the
# kernels' shared-memory sample (8,191 codes).
HAMMING_SHAPES = ((65_536, 131_072, 16, False), (20_000, 30_000, 10, False),
                  (20_000, 30_000, 24, False), (20_000, 30_000, 32, False),
                  (20_000, 30_000, 32, True), (20_000, 1, 16, False))
# a 50M-read run's rescue (1.7M queries x 1.1M kept); the brute-force
# twins run on its first BRUTE_QUERIES queries
HAMMING_50M, BRUTE_QUERIES = (1_700_000, 1_100_000, 16, False), 20_000
# H100 SXM device memory rate (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
RNA_KERNELS = ("K1", "K2", "K3", "K4")  # the RNA path's kernels
ATAC_KERNELS = ("K1", "K2", "K5")     # the ATAC path's kernels
SOURCES = {
    "K1": ("alevin_fry_tpu_torch/csrc/segscan.cu", "alevin_fry_tpu/ops/pallas_segscan.py:82"),
    "K2": ("alevin_fry_tpu_torch/csrc/segscan.cu", "alevin_fry_tpu/ops/pallas_segscan.py:135"),
    "K3": ("alevin_fry_tpu_torch/csrc/segscan.cu", "alevin_fry_tpu/ops/pallas_segscan.py:226"),
    "K4": ("alevin_fry_tpu_torch/csrc/hamming.cu", "alevin_fry_tpu/ops/pallas_hamming.py:145"),
    "K5": ("alevin_fry_tpu_torch/csrc/hamming.cu", "alevin_fry_tpu/ops/pallas_hamming.py:39"),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card, after one warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest |kernel - twin| over the outputs (a tensor or a tuple of
    them); raises unless 0."""
    if hasattr(got, "cpu"):
        got, want = (got,), (want,)
    err = max(int((g.cpu().long() - w.cpu().long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if err:
        raise AssertionError(f"kernel differs from its twin by {err}")
    return err


def ptxas_summary(text: str) -> list:
    """Registers, static shared memory and spills per kernel from
    ptxas -v (the probe kernels' sample is dynamic shared memory: phase 1
    prints it from the search plan)."""
    out, name, spill = [], None, "0"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            op = re.search(r"(FwdOp|MinOp|LexOp|FirstIndex|MinValue)", m.group(1))
            kern = re.search(r"(lookback_scan|hamming1_probe)_kernel", m.group(1))
            name = (kern.group(1) if kern else m.group(1)) + (f"<{op.group(1)}>" if op else "")
            spill = "0"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs, {m.group(2) or 0} B static smem, "
                       f"{spill} B spilled")
            name = None
    return out


def helper(argv: list) -> dict:
    """Run tests/reference_host_path.py in a subprocess (it imports the
    reference package, this script does not); returns its JSON line."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "reference_host_path.py"), *argv],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"reference_host_path.py {argv[0]} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


# --- phase 2 ----------------------------------------------------------------

def segscan_case(n: int, seed: int):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    start = rng.rand(n) < 0.2
    start[0] = True
    arrays = (
        rng.randint(0, 5, n).astype(np.int32), start,
        rng.randint(0, 1 << 20, n).astype(np.int32), rng.rand(n) < 0.3,
        np.cumsum(start).astype(np.int32),
    )
    return [torch.from_numpy(a) for a in arrays]


def segscan_outputs(x, start, val, mark, grp_ord):
    from alevin_fry_tpu_torch.ops import segscan

    return (
        *segscan.seg_sum(x, start, with_rank=True),
        segscan.seg_reduce(val, mark, start, grp_ord),
        segscan.last_marked(val, mark, grp_ord),
        segscan.last_marked(val, mark, grp_ord, strict=True),
    )


def hamming_case(nq: int, nk: int, length: int, seed: int, dups: bool = False):
    """Kept codes in ascending unsigned order (with ``dups``, a quarter of
    them again and one 40 times more) and queries: kept codes,
    one-substitution mutants and random codes."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    full = (1 << (2 * length)) - 1
    draw = lambda k: rng.randint(0, 1 << 63, k, dtype=np.uint64) * np.uint64(3) & np.uint64(full)
    kept = np.unique(draw(nk))
    if dups:
        kept = np.sort(np.concatenate([kept, kept[rng.randint(0, len(kept), len(kept) // 4)],
                                       np.repeat(kept[len(kept) // 2], 40)]))
    pos = rng.randint(0, length, nq // 3).astype(np.uint64)
    mut = kept[rng.randint(0, len(kept), nq // 3)] ^ (np.uint64(1) << (np.uint64(2) * pos))
    q = np.concatenate([
        kept[rng.randint(0, len(kept), nq // 3)], mut, draw(nq - 2 * (nq // 3)),
    ])
    return torch.from_numpy(q.view(np.int64)), torch.from_numpy(kept.view(np.int64))


def scan_kernels_check(x, start, val, grp_ord) -> None:
    """K1, K2 (both directions) and K3 (all four) against their twins on
    the card; raises on any difference."""
    from alevin_fry_tpu_torch.ops import segscan

    max_abs_err(segscan.scan_fwd(x, start), segscan.scan_fwd_twin(x, start))
    for rev in (False, True):
        max_abs_err(segscan.scan_min(val, rev), segscan.scan_min_twin(val, rev))
    w = segscan.pack_pair(grp_ord, val)
    for bigger in (False, True):
        for rev in (False, True):
            max_abs_err(segscan.scan_lex(w, bigger, rev), segscan.scan_lex_twin(w, bigger, rev))


def phase2(dev, card: str) -> None:
    import torch

    from alevin_fry_tpu_torch.ops import hamming, segscan

    for n in SEGSCAN_SIZES:
        cpu = segscan_case(n, n % 9973)
        cuda = [t.to(dev) for t in cpu]
        x, st, val, _, grp = cuda
        scan_kernels_check(x, st, val, grp)
        if n <= SEGSCAN_TOOLKIT_MAX_N:
            max_abs_err(segscan_outputs(*cuda), segscan_outputs(*cpu))
    n = SEGSCAN_TIMED_N
    x, st, val, mark, grp = [t.to(dev) for t in segscan_case(n, 1)]
    w = segscan.pack_pair(grp, val)
    times = {
        "K1": (lambda: segscan.scan_fwd(x, st), lambda: segscan.scan_fwd_twin(x, st)),
        "K2": (lambda: segscan.scan_min(x, True), lambda: segscan.scan_min_twin(x, True)),
        "K3": (lambda: segscan.scan_lex(w, True), lambda: segscan.scan_lex_twin(w, True)),
    }
    ms = {k: (event_ms(a, 20), event_ms(b, 20)) for k, (a, b) in times.items()}
    print(f"phase 2: K1-K3 equal their twins at n={list(SEGSCAN_SIZES)}, the segment "
          f"toolkit its CPU result up to n={SEGSCAN_TOOLKIT_MAX_N}; at n={n} "
          + ", ".join(f"{k} {a:.4f} ms (twin {b:.4f} ms)" for k, (a, b) in ms.items())
          + f" [{card}]", flush=True)

    times = {}
    for nq, nk, length, dups in HAMMING_SHAPES + (HAMMING_50M,):
        big = (nq, nk, length, dups) == HAMMING_50M
        q, k = (t.to(dev) for t in hamming_case(nq, nk, length, length, dups))
        if length == 32 and not bool((k < 0).any()):
            raise AssertionError("no 32-base kept barcode uses bit 63")
        perm = torch.randperm(len(k), generator=torch.Generator().manual_seed(length)).to(dev)
        hamming_check(q, k, length, perm, BRUTE_QUERIES if big else None)
        if big or (nq, nk) == HAMMING_SHAPES[0][:2]:
            # the rescue passes its queries sorted (pipeline/gpl.py); time
            # that order and the shuffled one hamming_case builds
            ku, qs = k[perm], hamming.sort_unsigned(q)
            times[(nq, nk, length)] = (
                event_ms(lambda: hamming.neighbor_counts(qs, k, length), 10),
                event_ms(lambda: hamming.neighbor_counts_brute(qs, ku), 10),
                event_ms(lambda: hamming.neighbor_counts(q, k, length), 10),
                event_ms(lambda: hamming.neighbor_counts_brute(q, ku), 10),
                event_ms(lambda: hamming.neighbor_probe_twin(qs, k, length), 3),
                None if big else event_ms(lambda: hamming.neighbor_counts_twin(q, k, length), 2),
                None if big else event_ms(lambda: hamming.neighbor_counts_brute_twin(q, ku), 2),
            )
    torch.cuda.synchronize()
    print(f"phase 2: K4 and K5 (kept shuffled) equal their brute-force twins, the probe "
          f"twin and each other at (Q, K, L, duplicates) = {HAMMING_SHAPES}, and at "
          f"{HAMMING_50M} (brute-force twins on the first {BRUTE_QUERIES} queries); "
          + "; ".join(f"at {shape} sorted queries K4 {t[0]:.4f} ms, K5 {t[1]:.4f} ms, "
                      f"shuffled K4 {t[2]:.4f} ms, K5 {t[3]:.4f} ms, probe twin {t[4]:.4f} ms"
                      + (f", brute-force twins {t[5]:.3f} / {t[6]:.3f} ms" if t[5] else "")
                      for shape, t in times.items()) + f" [{card}]", flush=True)


def hamming_check(q, k, length: int, perm, brute=None) -> None:
    """K4 (``k`` in ascending unsigned order) and K5 (on ``k[perm]``)
    against the probe twin, their brute-force twins (on the first
    ``brute`` queries, all by default) and each other: K5's value is the
    kept code at K4's index.  Raises on any difference."""
    import torch

    from alevin_fry_tpu_torch.ops import hamming

    got4 = hamming.neighbor_counts(q, k, length)
    max_abs_err(got4, hamming.neighbor_probe_twin(q, k, length))
    max_abs_err([g[:brute] for g in got4], hamming.neighbor_counts_twin(q[:brute], k, length))
    ku = k[perm]
    got5 = hamming.neighbor_counts_brute(q, ku)
    max_abs_err(got5, k5_probe_twin(q, ku))
    max_abs_err([g[:brute] for g in got5], hamming.neighbor_counts_brute_twin(q[:brute], ku))
    cnt4, idx4 = got4
    hit = cnt4 > 0
    if not (torch.equal(got5[0], cnt4) and torch.equal(got5[1][hit], k[idx4[hit].long()])
            and bool((got5[1][~hit] == -1).all())):
        raise AssertionError(f"K5 and K4 disagree at {(len(q), len(k), length)}")
    if not bool((cnt4 == 1).any()):
        raise AssertionError(f"no query has a unique neighbour at {(len(q), len(k), length)}")


# --- phase 3 ----------------------------------------------------------------

class Capture:
    """Records, for each kernel wrapper, the largest input the main path
    gave it, so phase 4 can replay the kernel and its twin on it."""

    def __init__(self):
        from alevin_fry_tpu_torch.ops import hamming, segscan

        self.inputs = {}
        self._patches = [
            (segscan, "scan_fwd", "K1", lambda a: a[0].numel()),
            (segscan, "scan_min", "K2", lambda a: a[0].numel()),
            (segscan, "scan_lex", "K3", lambda a: a[0].numel()),
            (hamming, "neighbor_counts", "K4", lambda a: a[0].numel() * a[1].numel()),
            (hamming, "neighbor_counts_brute", "K5", lambda a: a[0].numel() * a[1].numel()),
        ]
        self._orig = []

    def __enter__(self):
        for mod, name, key, size in self._patches:
            orig = getattr(mod, name)
            self._orig.append((mod, name, orig))
            setattr(mod, name, self._spy(orig, key, size))
        return self

    def _spy(self, orig, key, size):
        def spy(*args, **kwargs):
            if size(args) > self.inputs.get(key, (-1,))[0]:
                kept = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
                self.inputs[key] = (size(args), kept, dict(kwargs))
            return orig(*args, **kwargs)

        return spy

    def __exit__(self, *exc):
        for mod, name, orig in self._orig:
            setattr(mod, name, orig)


def device_busy(prof) -> tuple:
    """Busy milliseconds of the card in a torch.profiler run: the union of
    its device-side intervals (kernels, copies, memsets), so overlapping
    events count once and CPU-side aggregates never; CUPTI's own buffer
    events are left out.  Also returns the busy time by kind."""
    import torch

    spans, kinds = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name == "Activity Buffer Request":
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        name = e.name
        kind = (" ".join(name.split()[:2]) if name.startswith(("Memcpy", "Memset"))
                else "K1-K3" if "lookback_scan" in name
                else "K5" if "MinValue" in name
                else "K4" if "hamming1" in name
                else "torch sort" if re.search(r"[Ss]ort", name) else "other torch kernels")
        kinds[kind] = kinds.get(kind, 0.0) + (end - start) / 1e3
    busy, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
    return busy / 1e3, kinds


def host_self_times(cprof, top: int = 5) -> str:
    import pstats

    stats = pstats.Stats(cprof).stats
    rows = sorted(((v[2], f"{Path(k[0]).name}:{k[1]}({k[2]})") for k, v in stats.items()),
                  reverse=True)[:top]
    return ", ".join(f"{name} {secs:.2f} s" for secs, name in rows)


def run_stages(stages: dict, label: str, profile: bool = False, after=None) -> dict:
    """Run the port's CLI once per stage (name -> argv) on the card;
    returns each stage's seconds.  ``after(name)`` runs after a stage,
    outside its time."""
    import cProfile
    import contextlib

    import torch

    from alevin_fry_tpu_torch.cli import main as port_main

    secs = {}
    for stage, argv in stages.items():
        tprof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA])
                 if profile else contextlib.nullcontext())
        cprof = cProfile.Profile() if profile else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tprof:
            if cprof:
                cprof.enable()
            rc = port_main(argv)
            torch.cuda.synchronize()
            if cprof:
                cprof.disable()
        secs[stage] = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"port {stage} failed")
        if profile:
            busy, kinds = device_busy(tprof)
            table_total = sum(e.self_device_time_total for e in tprof.key_averages()) / 1e3
            print(f"{label} profile: {stage} {secs[stage]:.2f} s; device busy {busy:.1f} ms "
                  f"(idle {100 * (1 - busy / 1e3 / secs[stage]):.1f}%): "
                  + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(kinds.items()))
                  + f"; profiler table's Self CUDA total {table_total:.1f} ms; host self "
                  f"time: {host_self_times(cprof)}", flush=True)
        if after:
            after(stage)
    return secs


def run_port(data: Path, out: Path, profile: bool = False) -> tuple:
    common = ["-t", str(THREADS), "--device", "cuda"]
    stages = {
        "gpl": ["generate-permit-list", "-i", str(data / "rad"), "-d", "fw",
                "-o", str(out / "gpl"), "-u", str(data / "permit.txt"), "-m", "10",
                *common],
        "collate": ["collate", "-i", str(out / "gpl"), "-r", str(data / "rad"), *common],
        "quant": ["quant", "-i", str(out / "gpl"), "-m", str(data / "t2g_3col.tsv"),
                  "-o", str(out / "quant"), "-r", "cr-like", *common],
    }
    secs = run_stages(stages, "phase 3", profile)
    return secs, {k: "alevin-fry-tpu " + " ".join(v) for k, v in stages.items()}


def check_outputs(out: Path, n_rows_expected: int) -> int:
    """The quantified matrix: a MatrixMarket header with the expected
    shape and positive finite counts."""
    with open(out / "quant" / "alevin" / "quants_mat.mtx") as fh:
        next(fh), next(fh)
        n_cells, n_cols, nnz = map(int, next(fh).split())
        vals = [float(next(fh).split()[2]) for _ in range(min(nnz, 100_000))]
    qj = json.loads((out / "quant" / "quant.json").read_text())
    if not (n_cells == qj["num_quantified_cells"] > 0 and n_cols == n_rows_expected
            and nnz > 0 and all(v > 0 and v == v and v != float("inf") for v in vals)):
        raise AssertionError(f"unexpected matrix {n_cells} x {n_cols}, nnz {nnz}")
    return nnz


# --- phase 4 ----------------------------------------------------------------

# bytes each segmented-scan kernel moves per row: its inputs read once,
# its outputs written once (K1: int32 x and bool start in, two int32 out)
SCAN_BYTES_PER_ROW = {"K1": 13, "K2": 8, "K3": 16}


def bound_ms(key: str, args: tuple) -> float:
    """The least time the card could take for a kernel's work on ``args``:
    the bytes it must move over the device memory rate.  K4 and K5 read
    the queries and the kept table and write a count and an index (K4,
    4 bytes) or a code (K5, 8 bytes) per query; their integer work is no
    match for that on any pipe, so bytes set the bound."""
    if key in SCAN_BYTES_PER_ROW:
        nbytes = args[0].numel() * SCAN_BYTES_PER_ROW[key]
    else:
        nbytes = (16 if key == "K4" else 20) * len(args[0]) + 8 * len(args[1])
    return nbytes / HBM_BYTES_PER_S * 1e3


def library_call(key: str, args: tuple):
    """The one PyTorch call that computes a kernel's scan on ``args``
    (forward; a reverse scan adds two flips to it), or None: K1's pair of
    scans, K4 and K5 have none."""
    import torch

    if key == "K2":
        return lambda: torch.cummin(args[0], 0)
    if key == "K3":
        return lambda: (torch.cummax if args[1] else torch.cummin)(args[0], 0)
    return None


def k5_probe_twin(queries, kept):
    """K5's contract through the probe twin: the kept table sorted in
    unsigned order, probed at the positions the codes use."""
    from alevin_fry_tpu_torch.ops import hamming

    kept_sorted = hamming.sort_unsigned(kept)
    return hamming.neighbor_probe_twin(queries, kept_sorted,
                                       hamming.used_positions(queries, kept_sorted), values=True)


def replay(captured: dict, keys: tuple, launches: dict, path: str, label: str,
           card: str) -> list:
    """Each kernel of ``keys`` and its plain version on the largest input
    the path gave it (K4 and K5 also against their brute-force twins):
    exact equality, CUDA-event times, the bound and the library call's
    time; one row of the kernels' JSON line each, with the path's launch
    count."""
    import torch

    from alevin_fry_tpu_torch.ops import hamming, segscan

    pairs = {
        "K1": (segscan.scan_fwd, segscan.scan_fwd_twin),
        "K2": (segscan.scan_min, segscan.scan_min_twin),
        "K3": (segscan.scan_lex, segscan.scan_lex_twin),
        "K4": (hamming.neighbor_counts, hamming.neighbor_probe_twin),
        "K5": (hamming.neighbor_counts_brute, k5_probe_twin),
    }
    brute_twins = {"K4": hamming.neighbor_counts_twin, "K5": hamming.neighbor_counts_brute_twin}
    rows = []
    for key in keys:
        kern, twin = pairs[key]
        _, args, kw = captured[key]
        got, want = kern(*args, **kw), twin(*args, **kw)
        err = max_abs_err(got, want)
        shape = ([len(args[0]), len(args[1])] + list(args[2:])
                 if key in ("K4", "K5") else [args[0].numel()])
        lib = library_call(key, args)
        row = {
            "name": key, "path": path, "route": "cuda", "source": SOURCES[key][0],
            "replaces": SOURCES[key][1], "launches": launches[key], "shape": shape,
            "max_abs_err": err,
            "ms": event_ms(lambda: kern(*args, **kw), 10),
            "plain_ms": event_ms(lambda: twin(*args, **kw), 10),
            "bound_ms": bound_ms(key, args), "bound_by": "bytes",
            "library_ms": event_ms(lib, 10) if lib else None,
        }
        if key in ("K1", "K2"):
            # one CUB single-pass scan over 8 B/row: what one pass reaches on
            # this card; it computes neither kernel's function
            row["cumsum_ms"] = event_ms(lambda: torch.cumsum(args[0], 0, dtype=torch.int32), 10)
        if key in brute_twins:
            brute = brute_twins[key]
            max_abs_err(got, brute(*args, **kw))
            row["brute_ms"] = event_ms(lambda: brute(*args, **kw), 1)
        rows.append(row)
    print(f"{label}: replay at main-path shapes: " + ", ".join(
        f"{r['name']} {r['shape']} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms"
        + (f", brute-force twin {r['brute_ms']:.4f} ms" if "brute_ms" in r else "")
        + f", bound {r['bound_ms']:.5f} ms"
        + (f", library {r['library_ms']:.4f} ms" if r["library_ms"] is not None else "")
        + (f", torch.cumsum {r['cumsum_ms']:.4f} ms" if "cumsum_ms" in r else "") + ")"
        for r in rows) + f" [{card}]", flush=True)
    return rows


# --- phase 5 ----------------------------------------------------------------

def atac_phase(work: Path, card: str, profile: bool) -> list:
    """The port's ATAC path on the card against the reference's host
    path; returns the replay rows of K1, K2 and K5 on this path's inputs."""
    import os

    import torch

    from alevin_fry_tpu_torch.atac import dedup
    from alevin_fry_tpu_torch.ops import hamming, segscan
    from reference_host_path import (
        ATAC_DATA_ARTIFACTS, ATAC_STAGE_JSONS, artifact_mismatches, move_sorted_bed,
    )

    data, out = work / "atac_data", work / "atac_port"
    t0 = time.perf_counter()
    made = helper(["make-atac", str(data), "--seed", str(ATAC_SEED),
                   "--n-cells", str(ATAC_CELLS), "--n-frags", str(ATAC_FRAGS),
                   "--n-chrs", str(ATAC_CHRS), "--chr-len", str(ATAC_CHR_LEN),
                   "--ambient-factor", str(ATAC_AMBIENT)])
    print(f"phase 5: data {made['n_fragments']} fragments / {ATAC_CELLS} cells, whitelist "
          f"{sum(1 for _ in open(data / 'wl.txt'))} generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    gpl = str(out / "gpl")
    common = ["-t", str(THREADS), "--device", "cuda"]
    m = ["-m", str(ATAC_MAX_RECORDS)]
    stages = {
        "gpl": ["atac", "generate-permit-list", "-i", str(data / "rad"), "-o", gpl,
                "-u", str(data / "wl.txt"), "-m", "10", *common],
        "sort": ["atac", "sort", "-i", gpl, "-r", str(data / "rad"), *m, *common],
        "collate": ["atac", "collate", "-i", gpl, "-r", str(data / "rad"), *m, *common],
        "deduplicate": ["atac", "deduplicate", "-i", gpl, *common],
    }
    stats, peaks = {}, {}
    real_dedup = dedup.deduplicate
    dedup.deduplicate = lambda *a, **k: stats.update(real_dedup(*a, **k)) or stats

    def after(stage):
        peaks[stage] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if stage == "sort":
            move_sorted_bed(out)

    saved = os.environ.get("AFT_RESCUE_BACKEND")
    os.environ["AFT_RESCUE_BACKEND"] = "pallas"
    for counts in (segscan.LAUNCHES, hamming.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    torch.cuda.reset_peak_memory_stats()
    try:
        with Capture() as cap:
            secs = run_stages(stages, "phase 5", profile, after)
    finally:
        dedup.deduplicate = real_dedup
        if saved is None:
            os.environ.pop("AFT_RESCUE_BACKEND")
        else:
            os.environ["AFT_RESCUE_BACKEND"] = saved
    launches = {**segscan.LAUNCHES, **hamming.LAUNCHES}
    if not all(launches[k] > 0 for k in ATAC_KERNELS):
        raise AssertionError(f"a kernel of the ATAC path never launched: {launches}")
    for stage in stages:
        print(f"phase 5: port atac {stage} on cuda {secs[stage]:.2f} s; peak device memory "
              f"{peaks[stage] / 2**20:.0f} MiB [{card}]", flush=True)
    print(f"phase 5: launches {launches}; deduplicate counters {stats}", flush=True)

    (work / "atac_cmdlines.json").write_text(json.dumps(
        {k: "alevin-fry-tpu " + " ".join(v) for k, v in stages.items()}))
    ref = helper(["run-atac", str(data), str(work / "atac_ref"),
                  str(work / "atac_cmdlines.json"), "--max-records", str(ATAC_MAX_RECORDS),
                  "--threads", str(THREADS)])
    bad = artifact_mismatches(out, work / "atac_ref", ATAC_DATA_ARTIFACTS, ATAC_STAGE_JSONS)
    if bad or ref["dedup"] != stats:
        raise AssertionError(f"port and reference differ in {bad}, counters {stats} vs "
                             f"{ref['dedup']}")
    bed_rows = sum(1 for _ in open(out / "gpl" / "map.bed"))
    print(f"phase 5: 8 data artifacts byte-identical ({bed_rows} deduplicated BED rows), "
          "3 stage JSONs and the 4 deduplicate counters equal to the reference host path "
          "(host CPU: " + ", ".join(f"{k} {v:.2f} s" for k, v in ref["seconds"].items())
          + ")", flush=True)
    return replay(cap.inputs, ATAC_KERNELS, launches, "atac", "phase 5", card)


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the port on one GPU.")
    ap.add_argument("--profile", action="store_true",
                    help="profile each main-path stage (device busy time, host self time)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this smoke test needs a GPU")
    card = card_line()
    print(f"phase 0: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    from alevin_fry_tpu_torch import _host_tuning, _kernels
    from alevin_fry_tpu_torch.ops import hamming, segscan
    from alevin_fry_tpu_torch.radz import _native
    from reference_host_path import artifact_mismatches

    print(f"phase 0: native RAD codec loaded: {_native.available()}; glibc malloc "
          f"tuning applied: {_host_tuning._applied}", flush=True)
    dev = torch.device("cuda")

    _kernels.build()
    print(f"phase 1: nvcc build {_kernels.BuildInfo.seconds:.2f} s "
          f"(rebuilt: {_kernels.BuildInfo.rebuilt}); "
          + "; ".join(ptxas_summary(_kernels.BuildInfo.ptxas)), flush=True)
    plans = {nk: hamming.search_plan(nk) for nk in (1, 55_471, 131_072, HAMMING_50M[1])}
    print("phase 1: hamming1_probe search plans (kept codes: every S-th code in shared "
          "memory, dynamic shared memory per block, resident blocks per SM): " + ", ".join(
              f"{nk}: S {p['stride']}, {p['smem_bytes']} B, {p['blocks_per_sm']}"
              for nk, p in plans.items()), flush=True)

    phase2(dev, card)

    work = REPO / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    data = work / "data"
    t0 = time.perf_counter()
    helper(["make", str(data), "--n-cells", str(N_CELLS), "--n-reads", str(N_READS),
            "--n-genes", str(N_GENES)])
    gen_s = time.perf_counter() - t0
    for counts in (segscan.LAUNCHES, hamming.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    torch.cuda.reset_peak_memory_stats()
    with Capture() as cap:
        secs, cmdlines = run_port(data, work / "port", args.profile)
    launches = {**segscan.LAUNCHES, **hamming.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    if not all(launches[k] > 0 for k in RNA_KERNELS):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    # USA mode: spliced, unspliced and ambiguous columns per gene
    nnz = check_outputs(work / "port", 3 * N_GENES)
    print(f"phase 3: data {N_READS} reads / {N_CELLS} cells generated in {gen_s:.1f} s; "
          f"port on cuda: gpl {secs['gpl']:.2f} s, collate {secs['collate']:.2f} s, "
          f"quant {secs['quant']:.2f} s; nnz {nnz}; launches {launches}; "
          f"peak device memory {peak / 2**20:.0f} MiB [{card}]", flush=True)

    (work / "cmdlines.json").write_text(json.dumps(cmdlines))
    ref_secs = helper(["run", str(data), str(work / "ref"), str(work / "cmdlines.json"),
                       "--usa", "--threads", str(THREADS)])
    bad = artifact_mismatches(work / "port", work / "ref")
    if bad:
        raise AssertionError(f"port and reference differ in {bad}")
    print("phase 4: 8 data artifacts byte-identical and 3 stage JSONs equal to the "
          "reference host path (host CPU: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in ref_secs.items()) + ")", flush=True)
    rows = replay(cap.inputs, RNA_KERNELS, launches, "rna", "phase 4", card)
    shutil.rmtree(data, ignore_errors=True)

    rows += atac_phase(work, card, args.profile)
    shutil.rmtree(work, ignore_errors=True)
    # the reference package ran only in helper subprocesses
    foreign = [m for m in sys.modules if m.split(".")[0] in ("jax", "alevin_fry_tpu")]
    if foreign:
        raise AssertionError(f"this process imported {foreign[:5]}")

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
