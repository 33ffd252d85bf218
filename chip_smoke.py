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
   K5 against K4 on the same inputs; CUDA-event times; K6 (the per-cell
   EM) against its twin bit for bit (tests/em_cases.py: USA and plain, with
   and without the last round, informative and uniform init, an
   all-singleton cell, zero-length classes, a 100-round cell, a cell past
   the shared-memory limit, 10,000 random cells), and its weighted mode
   (the long-read EM) on the same batches with label weights and on cells
   whose longest class crosses 8 and 128 labels; K7 (the UMI graphs'
   connected components) against its twin and a union-find on
   tests/pug_cases.py's graphs (random cells, isolated nodes, chains of
   thousands of nodes, a giant component, a cell past the shared-memory
   limit, a sparse cell as large, a cell whose adjacency does not fit),
   50 launches each, raising unless K7's routes (w) one warp, (a) staged,
   (b) shared and (c) global were each taken; K8 (the bootstraps' MT19937 init) against
   NumPy's RandomState stream for the seeds 0, 271828 and 2**32 - 1 over
   ten twists and against its twin on 33 replicates of 200 cells; K6's
   bootstrap mode against its twin bit for bit on tests/em_cases.py's
   bootstrap cells (rungs at width 4 and 16, a cell past the ladder,
   cells past the shared-memory limit) with 1 and 33 replicates; each
   K6 check raises unless K6's routes (a) staged, (b) shared and (c)
   global were each taken, the bootstrap one also unless a block ran a
   tile of more than one replicate;
3. generates a 10x-v3-shaped synthetic dataset (tests/synth_hard.py:
   10,000 cells, 20M reads, 20,000 genes, 3-column t2g) and runs the
   port's generate-permit-list -> collate -> quant -r cr-like on the
   card through its CLI, asserting that K1-K4 each launched; then (v)
   velocity mode on the same data: generate-permit-list through the
   port's library API with velo_mode=True (K4 required), its permit files
   byte for byte and its JSON field for field (but velo_mode) against
   phase 3's, collate and collate -c (in a copy) from the CLI, each
   velo.map.collated.rad equal to phase 3's map.collated.rad (the -c
   one decompressed), and quant refusing the directory with the
   reference's NotImplementedError, with each stage's seconds and peak
   device memory;
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
   gave it;
6. the filtered and compressed paths, each against the reference's host
   path with the same command lines: on phase 3's data, generate-permit-list
   -k (the knee), collate -c -m 6000000 (the out-of-core gather writing
   map.collated.rad.sz) and quant -r cr-like from the .sz, asserting
   that K1-K3 launched, with the eleven data artifacts byte for byte and
   the three stage JSONs field for field; the same collate without -c
   and quant from its .rad for their seconds (the quant artifacts must
   match); on a dataset of phase 5's widths cut to 10M fragments, atac
   generate-permit-list, sort -c, collate -c and deduplicate from the .sz
   (the reference's run of the same stages goes on beside them), with
   map.bed.gz equal in its
   decompressed bytes and its header apart from the MTIME, the .sz and
   the deduplicated BED byte for byte, the stage JSONs and the four
   counters; and the multi-word WTA (keys past 62 bits, 32-base UMIs
   that use bit 63) on a synthetic block of 4M pairs, equal to its CPU
   result.  K1-K3 of each path are replayed as in phase 4; the sizes of
   the .sz and .gz files and of what they hold are printed;
7. the EM path on phase 3's collated data, each run against the
   reference's host path with the same command line (which runs in a
   thread from phase 5 on, beside the port's phases): quant -r cr-like-em
   -d (USA), infer --usa on its dump, quant -r cr-like-em (plain), quant
   -r trivial (plain) and quant -r cr-like --sa-model prefer-ambig (USA);
   every data artifact byte for byte (the dump's two files too) and the
   stage JSONs field for field; K6 launched in the EM runs and K1-K3 in
   every quant; the USA EM's cells, classes, labels, dictionary sizes,
   global-memory cells and rounds, and K6 and K1-K3 replayed on this
   path's largest inputs (K6: CUDA-event time, its bound from the bytes
   and the float operations its rounds took, its twin's time);
8. the parsimony family on phase 3's collated data, each against the
   reference's host path with the same command line (in a thread beside
   the port's runs): quant -r parsimony (USA), -r parsimony-em -d (USA),
   -r parsimony-gene and -r parsimony-gene-em (plain t2g); every data
   artifact byte for byte (the dump too) and quant.json field for field;
   K7 launched in every run, K6 in the EM ones and K1-K3 (the small
   cells' WTA); the graphs' nodes, edges and largest cell, the cells on
   the large-component fallback; then a seeded long-read
   dataset (tests/reference_host_path.py make-longread) through gpl,
   collate and quant -r parsimony-em (plain t2g: the weighted EM on K6)
   against the reference's host path; K7's cells by route; K7, K6
   (plain and weighted) and K1-K3 replayed on this phase's largest
   inputs (K7: the whole call by CUDA events and its launches alone by
   the profiler);
9. bootstraps on phase 3's collated data (plain t2g): (b) right after
   phase 4, the port alone, quant -r cr-like-em -b 20 at full width,
   asserting that K1-K3, K6, K6's bootstrap mode and K8 launched, with
   its seconds, peak device memory, replicate rows, rounds and routes,
   then K6-boot and K8 replayed on its largest inputs; from its cells a
   --quant-subset of the cells past the ladder (more than 1,024
   classes) and others, on which the reference's runs of (c) start in a
   thread beside phases 5-8; (c) after phase 8, quant -r cr-like-em -b
   20 --summary-stat and quant -r parsimony-em -b 20 with that subset,
   every data artifact (the two bootstrap matrices too) byte for byte
   and quant.json field for field;
10. a 10x Flex 16-plex run (tests/reference_host_path.py make-flex:
   tests/synth_hard.py::make_hard_flex_dataset with 16 samples of 3
   rotations, one pool of 625 cell barcodes shared by all, 20M reads,
   18,000 genes, and a 737,280-entry unfiltered list), made in a thread
   beside phases 5-9 where the reference's host path then runs (a) and
   (c) with the port's command lines: (a) generate-permit-list -u -m 10
   --sample-correction-mode 1-edit (K4's rescue once per sample with
   reads), collate (fast, in memory: K4's 1-edit tier) and quant -r
   cr-like (K1-K3); (b) collate -m 6000000 (out of core) in a copy of
   (a)'s gpl directory, its collated file and manifest equal to (a)'s;
   (c) collate --collation-mode two-round in another copy and quant;
   every data artifact of (a) and (c) byte for byte (each sample's
   permit files, the collated file, the manifest, the unmapped sidecar,
   quant's four files) and the four stage JSONs field for field; the
   stages' seconds and peak device memory, the samples, composite cells,
   matched and unmatched reads and K4's launches; K4 and K1-K3 replayed
   on this path's largest inputs;
11. convert and view (tests/bam_cases.py through tests/reference_host_path.py
   make-bam, in a thread beside phases 5-9): (a) a seeded BGZF BAM of 20M
   alignments in transcriptomic coordinates at 10x v3 widths (10,000
   cells and ambient barcodes, barcode substitutions, 1-4 alignments a
   read, about 3% unmapped or supplementary records, reverse strands, AS
   ties and missing AS tags, reads with one or two Ns); (b) the port's
   convert -t 8 and the reference's beside it, the RAD byte for byte;
   (c) generate-permit-list -u (K4's rescue), collate and quant -r
   cr-like (K1-K3) on that RAD on the card, the reference's host path on
   its own RAD beside them, the eight data artifacts byte for byte and the three
   stage JSONs field for field, the stages' seconds, peak device memory
   and launches; (d) convert -f and view -H of a second BAM of 1M
   alignments in both packages, the RAD byte for byte and the text by
   sha256; K4 and K1-K3 replayed on this path's largest inputs;
12. multi-process runs: the port's CLI stages as two processes sharing
   the card (a pair of tools/stage_worker.py ranks over gloo a run, each
   stage joining at a free local port of its own), each against an earlier
   phase's one-process run on the same data: (a) phase 3's gpl -u,
   collate and quant -r cr-like, the eight data artifacts byte for byte
   and the stage JSONs field for field (K4 in gpl and K1-K3 in quant on
   both ranks); (b) on (a)'s collated data quant -r cr-like-em -d against
   phase 7 and -r cr-like-em -b 20 --summary-stat on phase 9 (c)'s
   subset against 9 (c) (K6, K6's bootstrap mode and K8 on both ranks);
   (c) quant -r cr-like with the spill bound at 1,000,000 triplets and
   the merge round at 250,000, as one process and as two, against phase
   3; (d) phase 5's ATAC stages (K5 on both ranks in gpl, K1 and K2 in
   deduplicate), the counters too; (e) phase 10 (a)'s Flex stages (K4 on
   both ranks in gpl and collate); every stage's seconds, peak device
   memory and gloo bytes per rank, and the phase's seconds;
13. the device mesh of one process (parallel/mesh.py) with 2 shards on
   the card: (b) gpl -u with AFT_GPL_MESH=2, collate (its stable sort,
   which takes no mesh), quant -r cr-like-em -d and infer --usa with
   AFT_EM_MESH=2 and atac gpl with AFT_GPL_MESH=2, each byte for byte
   against its one-card run of phases 3, 5 and 7; (a) each mesh program
   the stages call on the inputs that path gave it (the barcode and bin
   histograms and the EM's cells) against its one-card result, with its
   seconds, the bytes its collectives moved and its launches per card; (c) where there are two cards or more,
   (b) with the variables unset (one shard a card), K6 required on each
   card.

With --profile, phases 3, 5, 6, 7, 10 and 11 also run each stage under torch.profiler
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
import tempfile
import threading
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
# phase 6: the fragments of the ATAC -c path's data (phase 5's widths and
# seed), cut from phase 5's 20M so the script keeps to its time: its
# sort's one-thread gzip at level 9 took 161-215 s at 20M, in both packages
ATAC_SZ_FRAGS = 10_000_000
# phase 6: collate -m for the RNA path (20M reads, so the out-of-core
# gather writes the .sz), and the multi-word WTA block
RNA_SZ_MAX_RECORDS = 6_000_000
WIDE_WTA_PAIRS, WIDE_WTA_GENE_BITS = 4_000_000, 14
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
# H100 SXM device memory rate and float32 rate outside the tensor cores
# (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# int32 instructions a second, one a lane a cycle: 64 INT32 lanes per SM
# (Hopper white paper),
# 132 SMs, at the clock that gives the 67 TFLOP/s fp32 rate (1.98 GHz)
INT32_OPS_PER_S = 64 * 132 * 1.98e9
RNA_KERNELS = ("K1", "K2", "K3", "K4")  # the RNA path's kernels
VELO_COLLATED = "velo.map.collated.rad"  # collate's file in velocity mode
ATAC_KERNELS = ("K1", "K2", "K5")     # the ATAC path's kernels
SCAN_KERNELS = ("K1", "K2", "K3")     # quant's, the multi-word WTA's
ATAC_SZ_KERNELS = ("K1", "K2")        # atac sort and deduplicate's
SOURCES = {
    "K1": ("alevin_fry_tpu_torch/csrc/segscan.cu", "alevin_fry_tpu/ops/pallas_segscan.py:82"),
    "K2": ("alevin_fry_tpu_torch/csrc/segscan.cu", "alevin_fry_tpu/ops/pallas_segscan.py:135"),
    "K3": ("alevin_fry_tpu_torch/csrc/segscan.cu", "alevin_fry_tpu/ops/pallas_segscan.py:226"),
    "K4": ("alevin_fry_tpu_torch/csrc/hamming.cu", "alevin_fry_tpu/ops/pallas_hamming.py:145"),
    "K5": ("alevin_fry_tpu_torch/csrc/hamming.cu", "alevin_fry_tpu/ops/pallas_hamming.py:39"),
    "K6": ("alevin_fry_tpu_torch/csrc/em.cu", "alevin_fry_tpu/ops/em.py:446"),
    "K7": ("alevin_fry_tpu_torch/csrc/pug_cc.cu", "alevin_fry_tpu/ops/pug_device.py:122"),
    # the bootstraps' device EM (bootstrap.py:220 runs the compact program
    # with its random init) and that init (init_random, em.py:340)
    "K6-boot": ("alevin_fry_tpu_torch/csrc/em.cu", "alevin_fry_tpu/ops/em.py:446"),
    "K8": ("alevin_fry_tpu_torch/csrc/mt19937.cu", "alevin_fry_tpu/ops/em.py:340"),
}
# phase 7: (name, t2g, the port's quant flags, the reference's quant
# flags); infer --usa runs on the first one's dump
EM_QUANTS = (
    ("em-usa", "t2g_3col.tsv", ["-r", "cr-like-em", "-d"],
     ["--resolution", "cr-like-em", "--dump-eq"]),
    ("em-plain", "t2g.tsv", ["-r", "cr-like-em"], ["--resolution", "cr-like-em"]),
    ("trivial", "t2g.tsv", ["-r", "trivial"], ["--resolution", "trivial"]),
    ("prefer-ambig", "t2g_3col.tsv", ["-r", "cr-like", "--sa-model", "prefer-ambig"],
     ["--resolution", "cr-like", "--sa-model", "prefer-ambig"]),
)
# phase 2's K6 cases: every combination of USA, last round and uniform
# init on the small ones, two on the large one
K6_COMBOS = [(u, w, i) for u in (False, True) for w in (True, False) for i in (False, True)]
K6_LARGE_COMBOS = [(True, True, False), (False, False, True)]
# phase 8: (name, t2g, the port's quant flags, the reference's quant flags)
PARSIMONY_QUANTS = (
    ("parsimony", "t2g_3col.tsv", ["-r", "parsimony"], ["--resolution", "parsimony"]),
    ("parsimony-em", "t2g_3col.tsv", ["-r", "parsimony-em", "-d"],
     ["--resolution", "parsimony-em", "--dump-eq"]),
    ("parsimony-gene", "t2g.tsv", ["-r", "parsimony-gene"], ["--resolution", "parsimony-gene"]),
    ("parsimony-gene-em", "t2g.tsv", ["-r", "parsimony-gene-em"],
     ["--resolution", "parsimony-gene-em"]),
)
# phase 8's long-read data: the size at which the reference's per-cell
# Python resolution takes about a minute on a host core (PERF.md)
LONGREAD_SEED, LONGREAD_CELLS, LONGREAD_READS, LONGREAD_GENES = 5, 2_000, 1_000_000, 20_000
REPEATS = 50  # launches of each K7 case held against one result
# phase 9: the full-width run, and the parity runs on a --quant-subset
# (name, the port's quant flags, the reference's quant flags), plain t2g
BOOT_N = 20
BOOT_FULL = ["-r", "cr-like-em", "-b", str(BOOT_N)]
BOOT_QUANTS = (
    ("cr-like-em", ["-r", "cr-like-em", "-b", str(BOOT_N), "--summary-stat"],
     ["--resolution", "cr-like-em", "--num-bootstraps", str(BOOT_N), "--summary-stat"]),
    ("parsimony-em", ["-r", "parsimony-em", "-b", str(BOOT_N)],
     ["--resolution", "parsimony-em", "--num-bootstraps", str(BOOT_N)]),
)
# the subset: at most this many cells past the ladder and this many others,
# which the reference's host bootstraps take minutes to run (PERF.md)
BOOT_SUBSET_PAST, BOOT_SUBSET_RUNG = 300, 300
K8_CASE = (33, 200, 20_000)  # replicates, cells, ids below
# phase 10: a 10x Flex 16-plex run (16 probe barcodes of 8 bases with 3
# rotations each, 16-base cells, 12-base UMIs, about the genes of 10x's
# human Flex probe set; 10x's 737,280-entry Flex barcode list); only the
# depth is cut
FLEX_SEED, FLEX_SAMPLES, FLEX_CELLS, FLEX_READS, FLEX_GENES = 13, 16, 625, 20_000_000, 18_000
FLEX_PERMIT, FLEX_MAX_RECORDS = 737_280, 6_000_000
FLEX_KERNELS = ("K1", "K2", "K3", "K4")  # quant's WTA, gpl's rescue and collate's tier
# phase 11: a 10x v3 BAM in transcriptomic coordinates (16-base CR, 12-base
# UR, 20,000 genes of 4 transcripts, 10,000 cells; tests/bam_cases.py), and
# a second one for convert -f and view; only the depth is cut
BAM_SEED, BAM_ALIGNMENTS = 17, 20_000_000
BAM_F_SEED, BAM_F_ALIGNMENTS = 19, 1_000_000
# phase 12: two processes of the port on the card (a pair of
# tools/stage_worker.py ranks over gloo a run); the seconds a run's pair
# may take before both are killed, and quant's spill bound and merge
# round for run (c)
MH_TIMEOUT = 300
MH_SPILL, MH_MERGE = 1_000_000, 250_000
# phase 13: the shards of the device mesh on the one card the script
# needs (they share it)
MESH_SHARDS = 2


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
            op = re.search(r"(FwdOp|MinOp|LexOp|FirstIndex|MinValue|ILi[012]ELb[01]ELb[01]E)",
                           m.group(1))
            kern = re.search(
                r"(lookback_scan|hamming1_probe|em_cell|pug_cc_warp|pug_cc_block|mt_init)_kernel",
                m.group(1))
            if kern and kern.group(1).startswith("pug_cc"):
                # K7's route: (w) a warp a cell, or a block's (a) staged, (b) shared, (c) global
                route = re.search(r"ILi([123])E", m.group(1))
                op = K7_ROUTES[int(route.group(1)) if route else 0].removesuffix("_cells")
            elif op and op.group(1).startswith("ILi"):
                # K6's mode, route (a) or (b)/(c), USA partners
                mode, stage, usa = re.findall(r"\d", op.group(1))
                op = (("plain", "weighted", "bootstrap")[int(mode)]
                      + (", staged" if stage == "1" else ", unstaged")
                      + (", USA" if usa == "1" else ""))
            else:
                op = op and op.group(1)
            name = (kern.group(1) if kern else m.group(1)) + (f"<{op}>" if op else "")
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


def helper_start(argv: list, logs: Path):
    """Start tests/reference_host_path.py in a subprocess (it imports the
    reference package, this script does not), its stdout and stderr to
    ``logs`` + ``.out`` / ``.err``."""
    with open(f"{logs}.out", "w") as out, open(f"{logs}.err", "w") as err:
        return subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "reference_host_path.py"), *argv],
            stdout=out, stderr=err,
        )


def helper_wait(proc, logs: Path) -> dict:
    """Wait for a helper_start subprocess; returns its JSON line."""
    if proc.wait() != 0:
        raise RuntimeError(f"reference_host_path.py failed:\n"
                           f"{Path(f'{logs}.err').read_text()[-4000:]}")
    return json.loads(Path(f"{logs}.out").read_text().strip().splitlines()[-1])


def helper(argv: list) -> dict:
    """Run tests/reference_host_path.py to its end; returns its JSON line."""
    with tempfile.TemporaryDirectory() as tmp:
        logs = Path(tmp) / "reference"
        return helper_wait(helper_start(argv, logs), logs)


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
    k6_check(dev, card)
    k6_weighted_check(dev, card)
    k7_check(dev, card)
    k8_check(dev, card)
    k6_boot_check(dev, card)


def float_err(got, want) -> float:
    """Largest |kernel - twin| over float32 / int32 outputs; raises
    unless every bit is equal."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        if g.dtype == torch.float32:
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                err = max(err, float((g - w).abs().max()))
                raise AssertionError(f"K6 differs from its twin by {err}")
        elif not torch.equal(g, w):
            raise AssertionError("K6's rounds differ from its twin's")
    return err


# K6's route counters (ops/em.py STATS): (cell, replicate) rows on routes
# (a) staged, (b) shared and (c) global, and rows whose block ran a tile of
# more than one replicate
K6_ROUTES = ("staged_cells", "shared_cells", "global_cells", "tiled_rows")


# K7's route counters (ops/pug_device.py STATS): cells on routes (w) one
# warp, (a) staged, (b) shared and (c) global
K7_ROUTES = ("warp_cells", "staged_cells", "shared_cells", "global_cells")


def k6_routes(since: dict, need=K6_ROUTES[:3]) -> dict:
    """K6's route counters since the snapshot ``since``; raises unless
    each of ``need`` grew."""
    from alevin_fry_tpu_torch.ops import em

    got = {k: em.STATS[k] - since[k] for k in K6_ROUTES}
    missing = [k for k in need if not got[k]]
    if missing:
        raise AssertionError(f"K6 took no {missing}: {got}")
    return got


def k6_check(dev, card: str) -> None:
    """K6 against its twin (on the CPU) on tests/em_cases.py's batches;
    raises on any differing bit, or unless routes (a), (b) and (c) were
    each taken."""
    from alevin_fry_tpu_torch.ops import em
    from em_cases import EM_CASES, em_case, usa_offsets

    since = dict(em.STATS)
    timed = {}
    for kind in EM_CASES:
        batch, n_rows = em_case(kind)
        combos = K6_LARGE_COMBOS if kind == "10k-cells" else K6_COMBOS
        for usa, last, uniform in combos:
            plan = em.plan_cells(*batch, n_rows, usa_offsets(n_rows) if usa else None,
                                 uniform, last)
            t = plan.to(dev)
            want = em.em_run_twin(plan.to("cpu"))
            float_err(em.em_run(t), want)
            if kind == "10k-cells":
                timed[(usa, last, uniform)] = (event_ms(lambda: em.em_run(t), 5),
                                               int(want[1].max()), float(want[1][want[1] > 0]
                                                                         .float().median()))
    routes = k6_routes(since)
    print(f"phase 2: K6 equals its twin bit for bit (values and rounds) on {list(EM_CASES)} "
          f"in {len(K6_COMBOS)} combinations of USA, last round and uniform init "
          f"({len(K6_LARGE_COMBOS)} on 10k-cells); cell launches by route {routes}; "
          "10k-cells (USA, last round, uniform): " + ", ".join(
              f"{k} {ms:.3f} ms, rounds max {mx}, median {med}"
              for k, (ms, mx, med) in timed.items()) + f" [{card}]", flush=True)


def k6_weighted_check(dev, card: str) -> None:
    """The weighted K6 (the long-read EM) against its twin (on the CPU)
    on tests/em_cases.py's batches with label weights and on cells whose
    longest class crosses 8 and 128 labels; raises on any differing bit,
    or unless routes (a), (b) and (c) were each taken."""
    from alevin_fry_tpu_torch.ops import em
    from em_cases import EM_CASES, em_case, label_weights, weighted_case

    since = dict(em.STATS)
    timed = {}
    for kind in list(EM_CASES) + ["long-classes"]:
        if kind == "long-classes":
            batch, n_rows, w = weighted_case()
        else:
            batch, n_rows = em_case(kind)
            w = label_weights(len(batch[2]))
        for uniform in (False, True):
            plan = em.plan_cells(*batch, n_rows, None, uniform, False, w)
            t = plan.to(dev)
            want = em.em_run_twin(plan.to("cpu"))
            float_err(em.em_run(t), want)
            if kind == "10k-cells":
                timed[uniform] = (event_ms(lambda: em.em_run(t), 5), int(want[1].max()))
    routes = k6_routes(since)
    print(f"phase 2: weighted K6 equals its twin bit for bit on {list(EM_CASES)} and "
          "long-classes (longest class 7-300 labels), informative and uniform init; cell "
          f"launches by route {routes}; 10k-cells: " + ", ".join(
              f"uniform={u} {ms:.3f} ms, rounds max {mx}" for u, (ms, mx) in timed.items())
          + f" [{card}]", flush=True)


def k7_check(dev, card: str) -> None:
    """K7 against its twin (on the card) and a union-find on
    tests/pug_cases.py's graphs, each case launched REPEATS times; raises
    on any difference, or unless routes (w), (a), (b) and (c) were each
    taken."""
    import torch

    from alevin_fry_tpu_torch.ops import pug_device
    from pug_cases import PUG_CASES, pug_case, union_find_labels

    since = dict(pug_device.STATS)
    out = {}
    for kind in PUG_CASES:
        graph = pug_case(kind)
        want = torch.from_numpy(union_find_labels(*graph))
        t = pug_device.upload_csr(*graph, dev)
        max_abs_err(pug_device.connected_components_twin(t[0], t[2], t[3])[0], want)
        for _ in range(REPEATS):
            labels, rounds = pug_device.connected_components(*t)
            max_abs_err(labels, want)
        out[kind] = (len(graph[1]), len(graph[2]),
                     event_ms(lambda: pug_device.connected_components(*t), 10))
    routes = {k: pug_device.STATS[k] - since[k] for k in K7_ROUTES}
    missing = [k for k, v in routes.items() if not v]
    if missing:
        raise AssertionError(f"K7 took no {missing}: {routes}")
    print(f"phase 2: K7 equals its twin and a union-find on {list(PUG_CASES)}, {REPEATS} "
          f"launches each; cell launches by route {routes}: " + ", ".join(
              f"{k} ({n} nodes, {e} entries) {ms:.4f} ms" for k, (n, e, ms) in out.items())
          + f" [{card}]", flush=True)


def k8_check(dev, card: str) -> None:
    """K8 against NumPy's stream (seeds 0, 271828, 2**32 - 1; 3,000
    doubles, ten twists) and against its twin (on the CPU) on K8_CASE;
    raises on any differing bit."""
    import numpy as np
    import torch

    from alevin_fry_tpu_torch.ops import mtrand

    n = 3000
    for seed in (0, 271828, 2**32 - 1):
        want = np.random.RandomState(seed).random_sample(n).astype(np.float32) + 1e-5
        got = mtrand.random_init(torch.tensor([[seed]], device=dev),
                                 torch.tensor([0, n], device=dev),
                                 torch.arange(n, dtype=torch.int32, device=dev))
        if not np.array_equal(got.cpu().numpy()[0].view(np.int32), want.view(np.int32)):
            raise AssertionError(f"K8 differs from NumPy's stream for seed {seed}")
    n_rep, n_cells, top = K8_CASE
    rng = np.random.RandomState(8)
    ids = [np.sort(rng.choice(top, rng.randint(1, 600), replace=False)) for _ in range(n_cells)]
    off = torch.from_numpy(np.concatenate(([0], np.cumsum([len(i) for i in ids]))))
    seeds = torch.from_numpy(rng.randint(0, 2**32, (n_rep, n_cells), dtype=np.int64))
    ids = torch.from_numpy(np.concatenate(ids).astype(np.int32))
    want = mtrand.random_init_twin(seeds, off, ids)
    args = (seeds.to(dev), off.to(dev), ids.to(dev))
    float_err([mtrand.random_init(*args)], [want])
    ms = event_ms(lambda: mtrand.random_init(*args), 10)
    print(f"phase 2: K8 equals NumPy's RandomState stream (float32 + 1e-5) for the seeds 0, "
          f"271828 and 2**32 - 1 over {n} doubles, and its twin on {n_rep} replicates of "
          f"{n_cells} cells ({len(ids)} ids below {top}): {ms:.4f} ms [{card}]", flush=True)


def k6_boot_check(dev, card: str) -> None:
    """K6's bootstrap mode against its twin (on the card) on
    tests/em_cases.py's bootstrap cells with 1 and 33 replicates, its init
    from K8 against K8's twin (on the CPU); raises on any differing bit,
    or unless routes (a), (b) and (c) and a tile of more than one
    replicate were each taken."""
    from alevin_fry_tpu_torch.ops import bootstrap, em
    from em_cases import BOOT_CASES, boot_case

    since = dict(em.STATS)
    timed = {}
    for kind in BOOT_CASES:
        batch, n_rows = boot_case(kind)
        ceo, lo, labels, counts = batch
        cells = list(range(len(ceo) - 1))
        width = bootstrap.cell_widths(ceo, lo)
        for n in (1, 33):
            args = (ceo, lo, labels, n_rows, width, bootstrap.resample(counts, ceo, cells, n),
                    bootstrap.init_seeds(bootstrap.SEED, cells, n))
            t = bootstrap.replicate_plan(*args, dev)[1]
            if kind != "global-route":
                float_err([t.boot_init], [bootstrap.replicate_plan(*args, "cpu")[1].boot_init])
            want = em.em_run_twin(t)
            float_err(em.em_run(t), want)
            timed[(kind, n)] = (event_ms(lambda: em.em_run(t), 3), int(want[1].max()))
    routes = k6_routes(since, K6_ROUTES)
    print(f"phase 2: K6's bootstrap mode equals its twin bit for bit (values and rounds) on "
          f"{list(BOOT_CASES)} with 1 and 33 replicates, K8's init its twin's; rows by route "
          f"{routes}: " + ", ".join(
              f"{k} N={n} {ms:.3f} ms, rounds max {mx}" for (k, n), (ms, mx) in timed.items())
          + f" [{card}]", flush=True)


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


def reset_launches() -> None:
    from alevin_fry_tpu_torch.ops import em, hamming, mtrand, pug_device, segscan

    for counts in (segscan.LAUNCHES, hamming.LAUNCHES, em.LAUNCHES, pug_device.LAUNCHES,
                   mtrand.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))


def launch_counts() -> dict:
    from alevin_fry_tpu_torch.ops import em, hamming, mtrand, pug_device, segscan

    return {**segscan.LAUNCHES, **hamming.LAUNCHES, **em.LAUNCHES, **pug_device.LAUNCHES,
            **mtrand.LAUNCHES}


def peaks_after(peaks: dict, then=None):
    """An ``after`` hook for run_stages: each stage's peak device memory."""
    import torch

    def after(stage):
        peaks[stage] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if then:
            then(stage)

    return after


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
                else "K6-boot" if "em_cell_kernel<2>" in name
                else "K6" if "em_cell" in name
                else "K8" if "mt_init" in name
                else "K7" if "pug_cc" in name
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


def same_stream(a, b, chunk: int = 1 << 26) -> bool:
    """Whether two readable streams hold the same bytes."""
    while True:
        x, y = a.read(chunk), b.read(chunk)
        if x != y:
            return False
        if not x:
            return True


def velo_check(work: Path, data: Path, cmdlines: dict, card: str) -> None:
    """Phase 3 (v): velocity mode on phase 3's data.  The port's
    generate-permit-list through its library API (no CLI flag sets the
    mode) with phase 3's unfiltered list and velo_mode=True on the card,
    K4 required; its permit files byte for byte and its JSON field for
    field against phase 3's, but for velo_mode; collate from the CLI, and
    with -c in a copy, each velo.map.collated.rad against phase 3's
    map.collated.rad (the -c file decompressed); quant refusing the
    directory with the reference's NotImplementedError."""
    import torch

    from alevin_fry_tpu_torch.cli import main as port_main
    from alevin_fry_tpu_torch.pipeline.gpl import (
        CellFilterMethod, GenPermitListOpts, generate_permit_list,
    )
    from alevin_fry_tpu_torch.radz.snappyz import SnappyFrameReader
    from reference_host_path import comparable_json

    base = work / "port" / "gpl"
    velo, velo_sz = work / "velo" / "gpl", work / "velo_sz" / "gpl"
    common = ["-t", str(THREADS), "--device", "cuda"]
    secs, peaks = {}, {}
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    # phase 3's captured replay inputs stay on the card until phase 4:
    # every peak below includes them
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    generate_permit_list(GenPermitListOpts(
        input_dir=data / "rad", output_dir=velo,
        fmeth=CellFilterMethod("unfiltered", path=data / "permit.txt", min_reads=10),
        expected_ori="fw", device=torch.device("cuda"), threads=THREADS, velo_mode=True,
        cmdline=cmdlines["gpl"],
    ))
    torch.cuda.synchronize()
    secs["gpl"] = time.perf_counter() - t0
    peaks_after(peaks)("gpl")
    launches = launch_counts()
    if not launches["K4"]:
        raise AssertionError(f"phase 3 (v): K4 never launched in gpl: {launches}")
    for name in ("permit_freq.bin", "permit_map.bin"):
        if (velo / name).read_bytes() != (base / name).read_bytes():
            raise AssertionError(f"phase 3 (v): {name} differs from phase 3's")
    want, got = (comparable_json(p / "generate_permit_list.json") for p in (base, velo))
    if not (got["velo_mode"] is True and got["gpl_options"]["velo_mode"] is True):
        raise AssertionError(f"phase 3 (v): the gpl JSON does not record velocity mode: {got}")
    for js in (want, got):
        js["velo_mode"] = js["gpl_options"]["velo_mode"] = None
    if got != want:
        raise AssertionError(f"phase 3 (v): the gpl JSON {got} differs from phase 3's {want}")
    shutil.copytree(velo, velo_sz)
    stages = {
        "collate": ["collate", "-i", str(velo), "-r", str(data / "rad"), *common],
        "collate -c": ["collate", "-i", str(velo_sz), "-r", str(data / "rad"), "-c", *common],
    }
    secs.update(run_stages(stages, "phase 3 (v)", after=peaks_after(peaks)))
    for d, compressed in ((velo, False), (velo_sz, True)):
        if list(d.glob("map.collated.rad*")) or json.loads(
                (d / "collate.json").read_text())["compressed_output"] is not compressed:
            raise AssertionError(f"phase 3 (v): {d} holds map.collated.rad* or the wrong "
                                 "collate.json")
    with open(base / "map.collated.rad", "rb") as a, open(velo / VELO_COLLATED, "rb") as b:
        if not same_stream(a, b):
            raise AssertionError("phase 3 (v): velo.map.collated.rad differs from phase 3's "
                                 "map.collated.rad")
    with open(base / "map.collated.rad", "rb") as a, \
            SnappyFrameReader(open(velo_sz / VELO_COLLATED, "rb")) as b:
        b.drop_history()
        if not same_stream(a, b):
            raise AssertionError("phase 3 (v): the -c velo.map.collated.rad does not "
                                 "decompress to phase 3's map.collated.rad")
    try:
        port_main(["quant", "-i", str(velo), "-m", str(data / "t2g_3col.tsv"),
                   "-o", str(work / "velo" / "quant"), "-r", "cr-like", *common])
    except NotImplementedError as exc:
        if str(exc) != "velocity mode is not implemented on this branch":
            raise AssertionError(f"phase 3 (v): quant raised {exc!r}") from exc
    else:
        raise AssertionError("phase 3 (v): quant ran on a velocity-mode directory")
    sizes = [(d / VELO_COLLATED).stat().st_size for d in (velo, velo_sz)]
    print("phase 3 (v): velocity mode on phase 3's data, port on cuda: "
          + ", ".join(f"{k} {v:.2f} s (peak device memory {peaks[k] / 2**20:.0f} MiB)"
                      for k, v in secs.items())
          + f", each peak including the {held / 2**20:.0f} MiB held from phase 3 at the start"
          + f"; gpl (library API, velo_mode=True) K4 launches {launches['K4']}, permit files "
          f"byte-identical and JSON equal to phase 3's but for velo_mode; "
          f"velo.map.collated.rad ({sizes[0]} bytes) byte-identical to phase 3's "
          f"map.collated.rad, the -c one ({sizes[1]} bytes) decompresses to it; quant raises "
          f"the reference's NotImplementedError [{card}]", flush=True)
    shutil.rmtree(work / "velo")
    shutil.rmtree(work / "velo_sz")


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
    after = peaks_after(peaks, lambda stage: stage == "sort" and move_sorted_bed(out))
    saved = os.environ.get("AFT_RESCUE_BACKEND")
    os.environ["AFT_RESCUE_BACKEND"] = "pallas"
    reset_launches()
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
    launches = launch_counts()
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
    (work / "atac_counters.json").write_text(json.dumps(stats))  # phase 12 (d)'s
    bed_rows = sum(1 for _ in open(out / "gpl" / "map.bed"))
    print(f"phase 5: 8 data artifacts byte-identical ({bed_rows} deduplicated BED rows), "
          "3 stage JSONs and the 4 deduplicate counters equal to the reference host path "
          "(host CPU: " + ", ".join(f"{k} {v:.2f} s" for k, v in ref["seconds"].items())
          + ")", flush=True)
    return replay(cap.inputs, ATAC_KERNELS, launches, "atac", "phase 5", card)


# --- phase 6 ----------------------------------------------------------------

def sz_uncompressed_bytes(path: Path) -> int:
    """Bytes a snappy framing stream holds, from its chunk headers and
    each block's length prefix (no decompression)."""
    import struct

    total = 0
    with open(path, "rb") as fh:
        while len(hdr := fh.read(4)) == 4:
            word = struct.unpack("<I", hdr)[0]
            body = fh.read(word >> 8)
            if word & 0xFF == 0x01:
                total += len(body) - 4
            elif word & 0xFF == 0x00:
                shift = 0
                for b in body[4:9]:
                    total += (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
    return total


def stage_lines(label: str, secs: dict, peaks: dict, card: str) -> None:
    print(f"{label}: " + ", ".join(
        f"{k} {v:.2f} s (peak device memory {peaks[k] / 2**20:.0f} MiB)"
        for k, v in secs.items()) + f" [{card}]", flush=True)


def rna_sz_phase(work: Path, data: Path, card: str, profile: bool) -> list:
    """Knee-filtered gpl, the out-of-core collate writing .sz, quant from
    it, against the reference; the same collate and quant without -c for
    their seconds.  Returns the replay rows of K1-K3 on this path."""
    import torch

    from reference_host_path import STAGE_JSONS, artifact_mismatches, rna_artifacts

    out, plain = work / "p6_port", work / "p6_plain"
    common = ["-t", str(THREADS), "--device", "cuda"]
    m = ["-m", str(RNA_SZ_MAX_RECORDS)]

    def stages(o: Path, compress: bool) -> dict:
        return {
            "collate": ["collate", "-i", str(o / "gpl"), "-r", str(data / "rad"), *m,
                        *(["-c"] if compress else []), *common],
            "quant": ["quant", "-i", str(o / "gpl"), "-m", str(data / "t2g_3col.tsv"),
                      "-o", str(o / "quant"), "-r", "cr-like", *common],
        }

    sz = {"gpl": ["generate-permit-list", "-i", str(data / "rad"), "-d", "fw",
                  "-o", str(out / "gpl"), "-k", *common], **stages(out, True)}
    peaks = {}
    reset_launches()
    torch.cuda.reset_peak_memory_stats()

    def copy_gpl(stage):
        if stage == "gpl":
            shutil.copytree(out / "gpl", plain / "gpl")

    with Capture() as cap:
        secs = run_stages(sz, "phase 6 rna", profile, peaks_after(peaks, copy_gpl))
    launches = launch_counts()
    if not all(launches[k] > 0 for k in SCAN_KERNELS):
        raise AssertionError(f"a kernel of the filtered .sz path never launched: {launches}")
    plain_peaks = {}
    plain_secs = run_stages(stages(plain, False), "phase 6 rna plain", profile,
                            peaks_after(plain_peaks))
    stage_lines("phase 6: port rna -k, collate -c, quant from .sz on cuda", secs, peaks, card)
    stage_lines("phase 6: port rna, the same collate without -c, quant from .rad",
                plain_secs, plain_peaks, card)
    quant_files = [n for n in rna_artifacts() if n.startswith("quant/")]
    for n in quant_files:
        if (out / n).read_bytes() != (plain / n).read_bytes():
            raise AssertionError(f"quant from .sz and from .rad differ in {n}")
    sz_path = out / "gpl" / "map.collated.rad.sz"
    rad_bytes = (plain / "gpl" / "map.collated.rad").stat().st_size
    if sz_uncompressed_bytes(sz_path) != rad_bytes:
        raise AssertionError("the .sz does not hold the plain collate's bytes")
    print(f"phase 6: map.collated.rad.sz {sz_path.stat().st_size} B holding {rad_bytes} B "
          f"(map.collated.rad), ratio {sz_path.stat().st_size / rad_bytes:.4f}; "
          f"quant from .sz equal to quant from .rad; launches {launches}", flush=True)

    (work / "p6_cmdlines.json").write_text(json.dumps(
        {k: "alevin-fry-tpu " + " ".join(v) for k, v in sz.items()}))
    ref_secs = helper(["run", str(data), str(work / "p6_ref"), str(work / "p6_cmdlines.json"),
                       "--usa", "--threads", str(THREADS), "--filter", "knee", "--compress",
                       "--max-records", str(RNA_SZ_MAX_RECORDS)])
    names = rna_artifacts(filtered=True, compressed=True)
    bad = artifact_mismatches(out, work / "p6_ref", names, STAGE_JSONS)
    if bad:
        raise AssertionError(f"port and reference differ in {bad}")
    n_cells = json.loads((out / "quant" / "quant.json").read_text())["num_quantified_cells"]
    print(f"phase 6: rna -k / -c: {len(names)} data artifacts byte-identical and 3 stage JSONs "
          f"equal to the reference host path ({n_cells} knee-filtered cells quantified; host "
          "CPU: " + ", ".join(f"{k} {v:.2f} s" for k, v in ref_secs.items()) + ")", flush=True)
    return replay(cap.inputs, SCAN_KERNELS, launches, "rna-knee-sz", "phase 6 rna", card)


def atac_sz_phase(work: Path, card: str, profile: bool) -> list:
    """atac generate-permit-list, sort -c, collate -c and deduplicate from
    the .sz on a dataset of phase 5's widths cut to ATAC_SZ_FRAGS
    fragments, against the reference.  The reference's run goes on at
    the same time, on other cores: each side's sort spends minutes in
    single-threaded gzip at level 9, and in turn they would take most of
    the script's time.  Returns the replay rows of K1 and K2 on this
    path."""
    import torch

    from alevin_fry_tpu_torch.atac import dedup
    from reference_host_path import (
        ATAC_STAGE_JSONS, artifact_mismatches, atac_artifacts, move_sorted_bed,
    )

    data, out, ref = work / "p6_atac_data", work / "p6_atac_port", work / "p6_atac_ref"
    t0 = time.perf_counter()
    made = helper(["make-atac", str(data), "--seed", str(ATAC_SEED), "--n-cells",
                   str(ATAC_CELLS), "--n-frags", str(ATAC_SZ_FRAGS), "--n-chrs", str(ATAC_CHRS),
                   "--chr-len", str(ATAC_CHR_LEN), "--ambient-factor", str(ATAC_AMBIENT)])
    print(f"phase 6: atac -c data {made['n_fragments']} fragments generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gpl = str(out / "gpl")
    common = ["-t", str(THREADS), "--device", "cuda"]
    m = ["-m", str(ATAC_MAX_RECORDS), "-c"]
    stages = {
        "gpl": ["atac", "generate-permit-list", "-i", str(data / "rad"), "-o", gpl,
                "-u", str(data / "wl.txt"), "-m", "10", *common],
        "sort": ["atac", "sort", "-i", gpl, "-r", str(data / "rad"), *m, *common],
        "collate": ["atac", "collate", "-i", gpl, "-r", str(data / "rad"), *m, *common],
        "deduplicate": ["atac", "deduplicate", "-i", gpl, *common],
    }
    (work / "p6_atac_cmdlines.json").write_text(json.dumps(
        {k: "alevin-fry-tpu " + " ".join(v) for k, v in stages.items()}))
    ref_logs = work / "p6_atac_ref_log"
    ref_proc = helper_start(["run-atac", str(data), str(ref), str(work / "p6_atac_cmdlines.json"),
                             "--max-records", str(ATAC_MAX_RECORDS), "--threads", str(THREADS),
                             "--compress"], ref_logs)
    stats, peaks = {}, {}
    real_dedup = dedup.deduplicate
    dedup.deduplicate = lambda *a, **k: stats.update(real_dedup(*a, **k)) or stats
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        with Capture() as cap:
            secs = run_stages(stages, "phase 6 atac", profile, peaks_after(
                peaks, lambda stage: stage == "sort" and move_sorted_bed(out)))
    except BaseException:
        ref_proc.kill()
        ref_proc.wait()
        raise
    finally:
        dedup.deduplicate = real_dedup
    ref_run = helper_wait(ref_proc, ref_logs)
    launches = launch_counts()
    if not all(launches[k] > 0 for k in ATAC_SZ_KERNELS):
        raise AssertionError(f"a kernel of the ATAC .sz path never launched: {launches}")
    stage_lines("phase 6: port atac gpl, sort -c, collate -c, deduplicate from .sz on cuda "
                "(the reference's run beside it)", secs, peaks, card)
    names = atac_artifacts(compressed=True)
    bad = artifact_mismatches(out, ref, names, ATAC_STAGE_JSONS)
    if bad or ref_run["dedup"] != stats:
        raise AssertionError(f"port and reference differ in {bad}, counters {stats} vs "
                             f"{ref_run['dedup']}")
    sizes = {
        "map.bed.gz": (out / "sort" / "map.bed.gz").stat().st_size,
        "map.collated.rad.sz": (out / "gpl" / "map.collated.rad.sz").stat().st_size,
        "map.collated.rad it holds": sz_uncompressed_bytes(out / "gpl" / "map.collated.rad.sz"),
    }
    ref_holds = sz_uncompressed_bytes(ref / "gpl" / "map.collated.rad.sz")
    if not sizes["map.collated.rad it holds"] == ref_holds > sizes["map.collated.rad.sz"]:
        raise AssertionError(f"the ATAC .sz holds {sizes['map.collated.rad it holds']} B, "
                             f"the reference's {ref_holds} B")
    print(f"phase 6: atac -c: {len(names)} data artifacts equal (map.bed.gz up to its MTIME), "
          f"3 stage JSONs and the 4 counters equal to the reference host path (host CPU: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in ref_run["seconds"].items())
          + f"); sizes {sizes}; launches {launches}", flush=True)
    return replay(cap.inputs, ATAC_SZ_KERNELS, launches, "atac-sz", "phase 6 atac", card)

def wide_wta_phase(dev, card: str) -> list:
    """The multi-word WTA (cell, UMI, gene words; 32-base UMIs use bit
    63) on the card against its CPU result, plain and USA.  Returns the
    replay rows of K1-K3 on its inputs."""
    import numpy as np
    import torch

    from alevin_fry_tpu_torch.ops.crlike_device import resolve_crlike_wta_words

    rng = np.random.RandomState(23)
    n, gb = WIDE_WTA_PAIRS, WIDE_WTA_GENE_BITS
    cell = np.sort(rng.randint(0, 40_000, n)).astype(np.int64)
    pool = rng.randint(0, 1 << 63, 16, dtype=np.uint64) | np.uint64(1 << 63)
    umi = pool[rng.randint(0, len(pool), n)].view(np.int64)
    gene = rng.randint(0, 1 << gb, n).astype(np.int64)
    words = [torch.from_numpy(w) for w in (cell, umi, gene)]
    n_rows = {False: 1 << gb, True: 3 * (1 << (gb - 1))}
    want = {usa: resolve_crlike_wta_words(*words, gb, n_rows[usa], usa=usa)
            for usa in (False, True)}
    rows = {}
    reset_launches()
    with Capture() as cap:
        for usa in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = resolve_crlike_wta_words(*(w.to(dev) for w in words), gb, n_rows[usa],
                                           usa=usa)
            rows[usa] = (time.perf_counter() - t0, len(got[0]))
            if not all(np.array_equal(g, w) for g, w in zip(got, want[usa])):
                raise AssertionError(f"the multi-word WTA (usa={usa}) differs from its CPU result")
    launches = launch_counts()
    if not all(launches[k] > 0 for k in SCAN_KERNELS):
        raise AssertionError(f"a kernel of the multi-word WTA never launched: {launches}")
    print(f"phase 6: multi-word WTA on {n} pairs (UMIs with bit 63) equal to its CPU result: "
          + ", ".join(f"{'USA' if u else 'plain'} {s:.3f} s, {k} triplets"
                      for u, (s, k) in rows.items())
          + f"; launches {launches} [{card}]", flush=True)
    return replay(cap.inputs, SCAN_KERNELS, launches, "wide-wta", "phase 6 wta", card)


# --- phase 7 ----------------------------------------------------------------

def ref_chain_start(cmds: list, logs: Path) -> dict:
    """Run tests/reference_host_path.py commands one after another in a
    thread; :func:`ref_chain_wait` collects their JSON lines."""
    state = {"proc": None, "results": [], "error": None, "stop": False}

    def run():
        try:
            for i, argv in enumerate(cmds):
                if state["stop"]:
                    return
                state["proc"] = helper_start(argv, Path(f"{logs}{i}"))
                state["results"].append(helper_wait(state["proc"], Path(f"{logs}{i}")))
        except BaseException as exc:  # noqa: BLE001 - reraised by ref_chain_wait
            state["error"] = exc

    state["thread"] = threading.Thread(target=run, daemon=True)
    state["thread"].start()
    return state


def ref_chain_wait(state: dict) -> list:
    state["thread"].join()
    if state["error"] is not None:
        raise state["error"]
    return state["results"]


def ref_chain_stop(state: dict) -> None:
    """Stop the chain and the process it runs."""
    state["stop"] = True
    proc = state["proc"]
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()
    state["thread"].join()


def em_port_argv(work: Path, data: Path) -> dict:
    """Phase 7's runs of the port: name -> argv."""
    common = ["-t", str(THREADS), "--device", "cuda"]
    out = work / "p7_port"
    runs = {}
    for name, t2g, flags, _ in EM_QUANTS:
        runs[name] = ["quant", "-i", str(work / "port" / "gpl"), "-m", str(data / t2g),
                      "-o", str(out / name / "quant"), *flags, *common]
        if name == "em-usa":
            dump = out / name / "quant" / "alevin"
            runs["infer-usa"] = ["infer", "-c", str(dump / "geqc_counts.mtx"),
                                 "-e", str(dump / "gene_eqclass.txt.gz"),
                                 "-o", str(out / "infer-usa" / "infer"), "--usa", *common]
    return runs


def em_ref_chain(work: Path, data: Path) -> dict:
    """Start the reference's runs of phase 7 (the same command lines) on
    phase 4's collated directory."""
    ref = work / "p7_ref"
    cmds = []
    port = em_port_argv(work, data)
    for name, t2g, _, ref_flags in EM_QUANTS:
        cmds.append(["quant", str(work / "ref" / "gpl"), str(ref / name / "quant"),
                     "alevin-fry-tpu " + " ".join(port[name]), "--t2g", str(data / t2g),
                     "--threads", str(THREADS), *ref_flags])
        if name == "em-usa":
            dump = ref / name / "quant" / "alevin"
            cmds.append(["infer", str(dump / "geqc_counts.mtx"),
                         str(dump / "gene_eqclass.txt.gz"), str(ref / "infer-usa" / "infer"),
                         "--usa"])
    return ref_chain_start(cmds, work / "p7_ref_log")


class K6Capture:
    """Keeps the largest K6 input (by occurrences) the path gave em_run,
    and each call's rounds per cell (0: no EM)."""

    def __init__(self):
        self.largest = None
        self.rounds = []

    def __enter__(self):
        import dataclasses

        from alevin_fry_tpu_torch.ops import em

        self._orig = em.em_run

        def spy(t):
            if self.largest is None or t.occ.numel() > self.largest.occ.numel():
                self.largest = clone_tensors(t)
            out = self._orig(t)
            self.rounds.append(out[1].cpu().numpy())
            return out

        em.em_run = spy
        return self

    def __exit__(self, *exc):
        from alevin_fry_tpu_torch.ops import em

        em.em_run = self._orig


def clone_tensors(t):
    """A copy of EmTensors ``t`` with its own tensors."""
    import dataclasses

    return dataclasses.replace(t, **{f.name: getattr(t, f.name).clone()
                                     for f in dataclasses.fields(t)
                                     if hasattr(getattr(t, f.name), "clone")})


def k6_work(t, rounds, alpha) -> tuple:
    """(bytes, float operations) of K6's work on ``t``: the labels, the
    occurrence lists and the counts (and the weights, in both orders) read
    once and each nonzero value written with its id; per round of each
    cell, the abundances and the convergence test (5 per id), the
    denominators (one add per label of a multi-label class, one division
    per class) and the new values (a multiply and an add per occurrence),
    plus the weighted mode's two multiplies per label, times the rounds it
    took (the bootstrap mode: its counts and initial values read and all
    its values written, per replicate, and each replicate's rounds)."""
    import torch

    ne = (t.cell_cls[1:] - t.cell_cls[:-1])
    nu = (t.dict_off[1:] - t.dict_off[:-1])
    lens = t.lab_off[1:] - t.lab_off[:-1]
    cls_cell = torch.repeat_interleave(torch.arange(len(ne), device=ne.device), ne)
    multi = (lens > 1).to(torch.float64)
    C = len(ne)
    per_round = (5 * nu.double() + torch.bincount(cls_cell, lens * multi, C)
                 + torch.bincount(cls_cell, multi, C) + 2 * torch.bincount(cls_cell, lens.double(), C))
    nbytes = 4 * (2 * t.lab_loc.numel() + t.countf.numel()) + 8 * int((alpha != 0).sum())
    if t.boot_counts is not None:
        nbytes = 4 * (2 * t.lab_loc.numel() + t.boot_counts.numel() + 2 * alpha.numel())
    if t.lab_w is not None:
        # the weighted mode multiplies each label by its weight twice (the
        # denominator and the new value) and reads the weights in both orders
        per_round = per_round + 2 * torch.bincount(cls_cell, lens * multi, C)
        nbytes += 8 * t.lab_w.numel()
    ops = float((rounds.double() * per_round).sum())
    return nbytes, ops


def k6_replay(t, launches: int, path: str, label: str, card: str) -> dict:
    """K6 (or its bootstrap mode) and its twin (both on the card) on the
    captured input: equal bits, CUDA-event times, the bound."""
    from alevin_fry_tpu_torch.ops import em

    got = em.em_run(t)
    err = float_err(got, em.em_run_twin(t))
    nbytes, ops = k6_work(t, got[1], got[0])
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    shape = [len(t.dict_off) - 1, t.countf.numel(), t.lab_loc.numel(), t.occ_off.numel() - 1]
    name = "K6"
    if t.boot_counts is not None:
        name = "K6-boot"
        shape.append(t.boot_counts.shape[0])
    row = {
        "name": name, "path": path, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": launches, "shape": shape,
        "max_abs_err": err, "ms": event_ms(lambda: em.em_run(t), 5),
        "plain_ms": event_ms(lambda: em.em_run_twin(t), 1),
        "bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "library_ms": None,
    }
    print(f"{label}: replay of {name} at the main path's shape (cells, classes, labels, "
          f"dictionary entries{', replicates' if name == 'K6-boot' else ''}) {shape}: "
          f"{row['ms']:.4f} ms (twin on the card {row['plain_ms']:.2f} ms), "
          f"bound {row['bound_ms']:.5f} ms by {row['bound_by']} ({nbytes} B, {ops:.4g} float "
          f"operations over the rounds taken) [{card}]", flush=True)
    return row


def em_phase(work: Path, data: Path, chain: dict, card: str, profile: bool) -> list:
    """Phase 7: the EM path on the card against the reference's runs in
    ``chain``.  Returns the replay rows of K6 and K1-K3."""
    import numpy as np
    import torch

    from alevin_fry_tpu_torch.ops import em
    from reference_host_path import DUMP_ARTIFACTS, INFER_ARTIFACTS, QUANT_ARTIFACTS, \
        artifact_mismatches

    runs = em_port_argv(work, data)
    peaks, secs, launches = {}, {}, {}
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    em.STATS.update(calls=0, cells=0, classes=0, labels=0, max_u=0, max_e=0,
                    **dict.fromkeys(K6_ROUTES, 0))
    usa_stats = None
    with Capture() as cap, K6Capture() as k6cap:
        for name, argv in runs.items():
            before = launch_counts()
            secs.update(run_stages({name: argv}, "phase 7", profile, peaks_after(peaks)))
            launches[name] = {k: v - before[k] for k, v in launch_counts().items()}
            if name == "em-usa":
                usa_stats = dict(em.STATS, rounds=np.concatenate(k6cap.rounds))
    total = launch_counts()
    for name in runs:
        want = ("K6",) if name.startswith(("em", "infer")) else ()
        want += SCAN_KERNELS if name != "infer-usa" else ()
        if not all(launches[name][k] > 0 for k in want):
            raise AssertionError(f"phase 7 {name}: a kernel never launched: {launches[name]}")
    stage_lines("phase 7: port on cuda", secs, peaks, card)
    rounds = usa_stats["rounds"][usa_stats["rounds"] > 0]
    print(f"phase 7: USA cr-like-em EM: {len(rounds)} EM cells of "
          f"{usa_stats['cells']} with classes, {usa_stats['classes']} classes, "
          f"{usa_stats['labels']} labels, largest dictionary U {usa_stats['max_u']} and class "
          f"count E {usa_stats['max_e']}, cells by K6 route "
          f"{ {k: usa_stats[k] for k in K6_ROUTES[:3]} }, rounds median "
          f"{float(np.median(rounds))} max "
          f"{int(rounds.max())}; launches per run {launches}", flush=True)

    ref_runs = ref_chain_wait(chain)
    bad = []
    for name in runs:
        if name == "infer-usa":
            bad += [f"{name}/{n}" for n in artifact_mismatches(
                work / "p7_port" / name, work / "p7_ref" / name, INFER_ARTIFACTS, ())]
        else:
            names = QUANT_ARTIFACTS + (DUMP_ARTIFACTS if name == "em-usa" else ())
            port_dir, ref_dir = work / "p7_port" / name, work / "p7_ref" / name
            bad += [f"{name}/{n}" for n in artifact_mismatches(
                port_dir, ref_dir, names, ("quant/quant.json",))]
            bad += [f"{name}/{n} (bytes)" for n in names
                    if (port_dir / n).read_bytes() != (ref_dir / n).read_bytes()]
    if bad:
        raise AssertionError(f"phase 7: port and reference differ in {bad}")
    print("phase 7: every data artifact of the 5 runs byte-identical (geqc_counts.mtx and "
          "gene_eqclass.txt.gz too) and the quant JSONs equal to the reference host path "
          "(host CPU, beside the port's phases 5-7: " + ", ".join(
              f"{name} {list(r.values())[0]:.2f} s" for name, r in zip(runs, ref_runs)) + ")",
          flush=True)
    rows = [k6_replay(k6cap.largest, total["K6"], "rna-em", "phase 7", card)]
    return rows + replay(cap.inputs, SCAN_KERNELS, total, "rna-em", "phase 7", card)


# --- phase 8 ----------------------------------------------------------------

class K7Capture:
    """Spies on connected_components: keeps the largest K7 input (by
    adjacency entries) the path gave it, and what it solved (cell graphs,
    nodes, entries, the largest cell, each live cell's rounds)."""

    def __init__(self):
        self.largest = None
        self.stats = {"cells": 0, "nodes": 0, "entries": 0, "max_nodes": 0}
        self.rounds = []

    def __enter__(self):
        from alevin_fry_tpu_torch.ops import pug_device

        self._orig = pug_device.connected_components

        def spy(n_nodes, n_entries, deg, nbrs):
            if self.largest is None or nbrs.numel() > self.largest[3].numel():
                self.largest = (n_nodes.copy(), n_entries.copy(), deg.clone(), nbrs.clone())
            labels, rounds = self._orig(n_nodes, n_entries, deg, nbrs)
            st = self.stats
            st["cells"] += len(n_nodes)
            st["nodes"] += len(deg)
            st["entries"] += nbrs.numel()
            st["max_nodes"] = max(st["max_nodes"], int(n_nodes.max()) if len(n_nodes) else 0)
            self.rounds.append(rounds.cpu().numpy()[n_nodes > 0])
            return labels, rounds

        pug_device.connected_components = spy
        return self

    def __exit__(self, *exc):
        from alevin_fry_tpu_torch.ops import pug_device

        pug_device.connected_components = self._orig


def kernel_device_ms(fn, reps: int, pattern: str) -> float:
    """Mean device milliseconds a call of ``fn`` runs kernels whose names
    hold ``pattern`` (the union of their intervals: launches on side
    streams overlap), from a torch.profiler trace of ``reps`` calls after
    a warm-up one."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and pattern in e.name)
    if not spans:
        raise AssertionError(f"the profiler saw no {pattern} kernel on the device")
    busy, last = 0.0, float("-inf")
    for start, end in spans:
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
    return busy / 1e3 / reps


def k7_replay(graph, launches: int, path: str, label: str, card: str) -> dict:
    """K7 and its twin (both on the card) on the captured graphs: equal
    labels, CUDA-event times of the whole call (``ms``) and the
    profiler's device time of K7's launches alone (``kernel_ms``), the
    bound (degrees and neighbours read once, one label written per node,
    at the device memory rate)."""
    import numpy as np

    from alevin_fry_tpu_torch.ops import pug_device

    labels, _ = pug_device.connected_components(*graph)
    plain = (graph[0], graph[2], graph[3])
    twin, rounds = pug_device.connected_components_twin(*plain)
    err = max_abs_err(labels, twin)
    n_nodes, n_entries = graph[2].numel(), graph[3].numel()
    nbytes = 12 * n_nodes + 4 * n_entries
    row = {
        "name": "K7", "path": path, "route": "cuda", "source": SOURCES["K7"][0],
        "replaces": SOURCES["K7"][1], "launches": launches,
        "shape": [len(graph[0]), n_nodes, n_entries], "max_abs_err": err,
        "ms": event_ms(lambda: pug_device.connected_components(*graph), 10),
        "kernel_ms": kernel_device_ms(lambda: pug_device.connected_components(*graph), 10,
                                      "pug_cc"),
        "plain_ms": event_ms(lambda: pug_device.connected_components_twin(*plain), 3),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
    }
    r = rounds.cpu().numpy()[graph[0] > 0]
    print(f"{label}: replay of K7 at the main path's shape (cells, nodes, adjacency entries) "
          f"{row['shape']}: {row['ms']:.4f} ms a call, its launches alone "
          f"{row['kernel_ms']:.4f} ms (twin on the card {row['plain_ms']:.2f} ms), bound "
          f"{row['bound_ms']:.5f} ms by bytes ({nbytes} B); the twin's rounds median "
          f"{float(np.median(r)):.0f}, max {int(r.max())} [{card}]", flush=True)
    return row


def parsimony_argv(work: Path, data: Path) -> dict:
    """Phase 8's quant runs of the port on phase 3's collated data:
    name -> argv."""
    common = ["-t", str(THREADS), "--device", "cuda"]
    return {name: ["quant", "-i", str(work / "port" / "gpl"), "-m", str(data / t2g),
                   "-o", str(work / "p8_port" / name / "quant"), *flags, *common]
            for name, t2g, flags, _ in PARSIMONY_QUANTS}


def longread_stages(lr: Path, out: Path) -> dict:
    """The long-read run of the port: gpl -> collate -> quant -r
    parsimony-em (plain t2g)."""
    common = ["-t", str(THREADS), "--device", "cuda"]
    return {
        "gpl": ["generate-permit-list", "-i", str(lr / "rad"), "-d", "fw",
                "-o", str(out / "gpl"), "-u", str(lr / "permit.txt"), "-m", "10", *common],
        "collate": ["collate", "-i", str(out / "gpl"), "-r", str(lr / "rad"), *common],
        "quant": ["quant", "-i", str(out / "gpl"), "-m", str(lr / "t2g.tsv"),
                  "-o", str(out / "quant"), "-r", "parsimony-em", *common],
    }


def parsimony_phase(work: Path, data: Path, card: str, profile: bool) -> list:
    """Phase 8: the parsimony family on the card against the reference's
    runs of the same command lines (started here, in a thread beside the
    port's runs), then the long-read run.  Returns the replay rows of K7,
    K6 (plain and weighted) and K1-K3."""
    lr = work / "longread"
    t0 = time.perf_counter()
    made = helper(["make-longread", str(lr), "--seed", str(LONGREAD_SEED),
                   "--n-cells", str(LONGREAD_CELLS), "--n-reads", str(LONGREAD_READS),
                   "--n-genes", str(LONGREAD_GENES)])
    print(f"phase 8: long-read data {made['n_reads']} reads, {made['n_alignments']} "
          f"alignments, {made['n_cells']} cells generated in {time.perf_counter() - t0:.1f} s",
          flush=True)
    runs = parsimony_argv(work, data)
    lr_stages = longread_stages(lr, work / "p8_lr_port")
    (work / "p8_lr_cmdlines.json").write_text(json.dumps(
        {k: "alevin-fry-tpu " + " ".join(v) for k, v in lr_stages.items()}))
    cmds = [["quant", str(work / "ref" / "gpl"), str(work / "p8_ref" / name / "quant"),
             "alevin-fry-tpu " + " ".join(runs[name]), "--t2g", str(data / t2g),
             "--threads", str(THREADS), *ref_flags]
            for name, t2g, _, ref_flags in PARSIMONY_QUANTS]
    cmds.append(["run", str(lr), str(work / "p8_lr_ref"), str(work / "p8_lr_cmdlines.json"),
                 "--threads", str(THREADS), "--resolution", "parsimony-em"])
    chain = ref_chain_start(cmds, work / "p8_ref_log")
    try:
        return _parsimony_runs(work, runs, lr_stages, chain, card, profile)
    finally:
        ref_chain_stop(chain)


def _parsimony_runs(work: Path, runs: dict, lr_stages: dict, chain: dict, card: str,
                    profile: bool) -> list:
    import numpy as np
    import torch

    from alevin_fry_tpu_torch.ops import pug_device
    from reference_host_path import (
        DUMP_ARTIFACTS, QUANT_ARTIFACTS, STAGE_JSONS, artifact_mismatches, rna_artifacts,
    )

    peaks, secs, launches = {}, {}, {}
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    pug_device.STATS.update(dict.fromkeys(pug_device.STATS, 0))
    with Capture() as cap, K6Capture() as k6cap, K7Capture() as k7cap:
        for name, argv in runs.items():
            before = launch_counts()
            secs.update(run_stages({name: argv}, "phase 8", profile, peaks_after(peaks)))
            launches[name] = {k: v - before[k] for k, v in launch_counts().items()}
    total = launch_counts()
    for name in runs:
        want = ("K7", *SCAN_KERNELS) + (("K6",) if name.endswith("-em") else ())
        if not all(launches[name][k] > 0 for k in want):
            raise AssertionError(f"phase 8 {name}: a kernel never launched: {launches[name]}")
    stage_lines("phase 8: port on cuda", secs, peaks, card)
    st = k7cap.stats
    rounds = np.concatenate(k7cap.rounds)
    if not (rounds >= 1).all():
        raise AssertionError("phase 8: K7 reported a live cell with no round")
    alt = {name: len(json.loads((work / "p8_port" / name / "quant" / "quant.json").read_text())
                     ["alt_resolved_cell_numbers"]) for name in runs}
    print(f"phase 8: PUGs over the 4 runs: {st['cells']} cell graphs, {st['nodes']} nodes, "
          f"{st['entries'] // 2} edges, largest cell {st['max_nodes']} nodes; K7's cells by "
          f"route {dict(pug_device.STATS)}; cells on the "
          f"large-component fallback {alt}; launches per run {launches}", flush=True)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    lr_peaks = {}
    with K6Capture() as lr_k6:
        lr_secs = run_stages(lr_stages, "phase 8 long-read", profile, peaks_after(lr_peaks))
    lr_launches = launch_counts()
    if lr_launches["K6"] == 0 or lr_k6.largest is None or lr_k6.largest.lab_w is None:
        raise AssertionError(f"phase 8: the weighted K6 never launched: {lr_launches}")
    stage_lines("phase 8: port long-read gpl, collate, quant -r parsimony-em on cuda", lr_secs,
                lr_peaks, card)

    ref_runs = ref_chain_wait(chain)
    bad = []
    for name in runs:
        names = QUANT_ARTIFACTS + (DUMP_ARTIFACTS if name == "parsimony-em" else ())
        port_dir, ref_dir = work / "p8_port" / name, work / "p8_ref" / name
        bad += [f"{name}/{n}" for n in artifact_mismatches(
            port_dir, ref_dir, names, ("quant/quant.json",))]
        bad += [f"{name}/{n} (bytes)" for n in names
                if (port_dir / n).read_bytes() != (ref_dir / n).read_bytes()]
    bad += [f"long-read/{n}" for n in artifact_mismatches(
        work / "p8_lr_port", work / "p8_lr_ref", rna_artifacts(), STAGE_JSONS)]
    if bad:
        raise AssertionError(f"phase 8: port and reference differ in {bad}")
    print("phase 8: every data artifact of the 4 parsimony runs (the dump too) and of the "
          "long-read run byte-identical, the stage JSONs equal to the reference host path "
          "(host CPU, beside the port: " + ", ".join(
              f"{name} {list(r.values())[0]:.2f} s" for name, r in zip(runs, ref_runs))
          + "; long-read " + ", ".join(f"{k} {v:.2f} s" for k, v in ref_runs[-1].items())
          + ")", flush=True)
    rows = [k7_replay(k7cap.largest, total["K7"], "rna-parsimony", "phase 8", card),
            k6_replay(k6cap.largest, total["K6"], "rna-parsimony-em", "phase 8", card),
            k6_replay(lr_k6.largest, lr_launches["K6"], "longread-em", "phase 8 long-read",
                      card)]
    return rows + replay(cap.inputs, SCAN_KERNELS, total, "rna-parsimony", "phase 8", card)


# --- phase 9 ----------------------------------------------------------------

class BootCapture:
    """Spies on the bootstraps without copying on the card or waiting for
    it: each K6-boot call's rounds (left on the card until the run ends);
    the host inputs of the batch with the most replicate occurrences
    (K6-boot's) and of the one with the most rows x ids (K8's), to rebuild
    them for the replays once the timed run is over; each quant block's
    classes and cell numbers; the file numbers of its cells in row order."""

    def __init__(self):
        self.largest = {"K6-boot": (0, None), "K8": (0, None)}
        self.rounds, self.blocks, self.row_cells = [], [], []

    def __enter__(self):
        from alevin_fry_tpu_torch.ops import bootstrap
        from alevin_fry_tpu_torch.pipeline import quant

        orig = {"em_run": bootstrap.em_run, "replicate_plan": bootstrap.replicate_plan,
                "run_bootstraps": quant.run_bootstraps, "resolve": quant._resolve_cells}

        def em_run(t):
            out = orig["em_run"](t)
            self.rounds.append(out[1])
            return out

        def replicate_plan(*args):
            plan, t = orig["replicate_plan"](*args)
            n = args[5].shape[0]
            for name, size in (("K6-boot", n * len(plan.occ)), ("K8", n * len(plan.dict_id))):
                if size > self.largest[name][0]:
                    self.largest[name] = (size, args)
            return plan, t

        def run_bootstraps(eqc, label_offsets, *args, cell_offset=0, **kwargs):
            self.blocks.append((eqc, label_offsets, cell_offset))
            return orig["run_bootstraps"](eqc, label_offsets, *args, cell_offset=cell_offset,
                                          **kwargs)

        def resolve(*args, **kwargs):
            res = orig["resolve"](*args, **kwargs)
            self.row_cells.append(res.cells)
            return res

        self._saved = [(bootstrap, "em_run", orig["em_run"]),
                       (bootstrap, "replicate_plan", orig["replicate_plan"]),
                       (quant, "run_bootstraps", orig["run_bootstraps"]),
                       (quant, "_resolve_cells", orig["resolve"])]
        bootstrap.em_run, bootstrap.replicate_plan = em_run, replicate_plan
        quant.run_bootstraps, quant._resolve_cells = run_bootstraps, resolve
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def cells(self) -> tuple:
        """(file numbers, class counts, denominator widths) of the cells
        with classes, over the blocks in order (width 0: past the ladder)."""
        import numpy as np

        from alevin_fry_tpu_torch.ops import bootstrap

        parts = []
        for eqc, lo, first in self.blocks:
            ceo = np.asarray(eqc.cell_eq_offsets, np.int64)
            ne = np.diff(ceo)
            has = ne > 0
            width = bootstrap.cell_widths(np.append(ceo[:-1][has], ceo[-1]),
                                          np.asarray(lo, np.int64))
            parts.append((np.asarray(eqc.cell_ids, np.int64)[has] + first, ne[has], width))
        return tuple(np.concatenate(x) for x in zip(*parts))

    def replay_inputs(self) -> tuple:
        """The largest batches rebuilt from their host inputs: (K6-boot's
        tensors, K8's seeds, offsets and ids)."""
        import numpy as np
        import torch

        from alevin_fry_tpu_torch.ops import bootstrap

        t = bootstrap.replicate_plan(*self.largest["K6-boot"][1])[1]
        args = self.largest["K8"][1]
        plan, t8 = bootstrap.replicate_plan(*args)
        dev = t8.occ.device
        return t, (torch.from_numpy(np.ascontiguousarray(args[6])).to(dev), t8.dict_off,
                   torch.from_numpy(plan.dict_id.astype(np.int32)).to(dev))


def k8_work(seeds, dict_off, ids) -> tuple:
    """(bytes, int32 instructions) of the work K8's function needs: the
    seeds, offsets and ids read once and one float written per (row,
    entry); per row the 623 seeding steps (a shift, a xor and a multiply-add
    each) and each twist up to the row's largest id (5 a word: a LOP3 to
    join the bits, a shift, two for the matrix select, a LOP3 to xor); per
    (row, entry) its two words tempered (a shift and a LOP3 a step, four
    steps) and the two shifts that pair them: 18."""
    import numpy as np

    n_rep = seeds.shape[0]
    off, idv = dict_off.cpu().numpy(), ids.cpu().numpy().astype(np.int64)
    has = np.diff(off) > 0
    twists = int((idv[off[1:][has] - 1] // 312 + 1).sum())
    ops = n_rep * (int(has.sum()) * 623 * 3 + twists * 624 * 5 + len(idv) * 18)
    nbytes = 8 * seeds.numel() + 8 * dict_off.numel() + 4 * ids.numel() * (1 + n_rep)
    return nbytes, ops


def k8_replay(args, launches: int, path: str, label: str, card: str) -> dict:
    """K8 and its twin (both on the card) on the captured input: equal
    bits, CUDA-event times, the bound."""
    from alevin_fry_tpu_torch.ops import mtrand

    err = float_err([mtrand.random_init(*args)], [mtrand.random_init_twin(*args)])
    nbytes, ops = k8_work(*args)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    shape = [*args[0].shape, args[2].numel()]
    row = {
        "name": "K8", "path": path, "route": "cuda", "source": SOURCES["K8"][0],
        "replaces": SOURCES["K8"][1], "launches": launches, "shape": shape, "max_abs_err": err,
        "ms": event_ms(lambda: mtrand.random_init(*args), 10),
        "plain_ms": event_ms(lambda: mtrand.random_init_twin(*args), 2),
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations", "library_ms": None,
    }
    print(f"{label}: replay of K8 at the main path's shape (replicates, cells, ids) {shape}: "
          f"{row['ms']:.4f} ms (twin on the card {row['plain_ms']:.2f} ms), bound "
          f"{row['bound_ms']:.5f} ms by {row['bound_by']} ({nbytes} B, {ops:.4g} int32 "
          f"instructions) [{card}]", flush=True)
    return row


def mtx_values(path: Path) -> tuple:
    """((rows, columns, entries) of a MatrixMarket file's header line, its values)."""
    import numpy as np

    lines = path.read_text().splitlines()
    body = [ln for ln in lines if not ln.startswith("%")]
    dims = tuple(map(int, body[0].split()))
    return dims, np.array([float(ln.split()[2]) for ln in body[1:]])


def boot_full_width(work: Path, data: Path, card: str, profile: bool) -> tuple:
    """Phase 9 (b): quant -r cr-like-em -b 20 on phase 3's collated data,
    the port alone.  Returns (the replay inputs of K6-boot and K8, the
    launches, the --quant-subset file of phase 9 (c))."""
    import numpy as np
    import torch

    from alevin_fry_tpu_torch.ops import em

    out = work / "p9_full"
    argv = ["quant", "-i", str(work / "port" / "gpl"), "-m", str(data / "t2g.tsv"),
            "-o", str(out / "quant"), *BOOT_FULL, "-t", str(THREADS), "--device", "cuda"]
    peaks = {}
    em.STATS.update(dict.fromkeys(K6_ROUTES, 0))
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with BootCapture() as cap:
        secs = run_stages({"quant -b": argv}, "phase 9 (b)", profile, peaks_after(peaks))
    launches = launch_counts()
    if not all(launches[k] > 0 for k in ("K6", "K6-boot", "K8", *SCAN_KERNELS)):
        raise AssertionError(f"phase 9 (b): a kernel never launched: {launches}")
    alevin = out / "quant" / "alevin"
    dims, _ = mtx_values(alevin / "quants_mat.mtx")
    for name in ("bootstraps_mean.mtx", "bootstraps_var.mtx"):
        bdims, vals = mtx_values(alevin / name)
        if bdims[:2] != dims[:2] or not bdims[2] or not np.isfinite(vals).all() or (
                name == "bootstraps_mean.mtx" and not (vals > 0).all()):
            raise AssertionError(f"phase 9 (b): unexpected {name} {bdims}")
    rounds = np.concatenate([r.cpu().numpy().ravel() for r in cap.rounds])
    cells, classes, widths = cap.cells()
    print(f"phase 9 (b): port quant -r cr-like-em -b {BOOT_N} on cuda {secs['quant -b']:.2f} s; "
          f"peak device memory {peaks['quant -b'] / 2**20:.0f} MiB; {len(classes)} cells with "
          f"classes x {BOOT_N} replicates = {len(rounds)} rows, {int((widths == 0).sum())} cells "
          f"past the ladder (largest {int(classes.max())} classes), widths "
          f"{dict(zip(*map(np.ndarray.tolist, np.unique(widths, return_counts=True))))}; rounds "
          f"median {float(np.median(rounds))} max {int(rounds.max())}; "
          f"rows by K6 route { {k: em.STATS[k] for k in K6_ROUTES} }; launches {launches} "
          f"[{card}]", flush=True)

    # the subset: cells past the ladder and others, spread over the file
    past, rung = cells[widths == 0], cells[widths > 0]
    if not len(past):
        raise AssertionError("phase 9 (b): no cell past the ladder")
    past = past[::max(1, len(past) // BOOT_SUBSET_PAST)][:BOOT_SUBSET_PAST]
    rung = rung[::max(1, len(rung) // BOOT_SUBSET_RUNG)][:BOOT_SUBSET_RUNG]
    chosen = np.sort(np.concatenate([past, rung]))
    row_cells = np.concatenate(cap.row_cells)
    barcodes = (alevin / "quants_mat_rows.txt").read_text().split()
    pos = np.searchsorted(row_cells, chosen)
    if len(barcodes) != len(row_cells) or not np.array_equal(row_cells[pos], chosen):
        raise AssertionError("phase 9 (b): the rows do not follow the cells")
    subset = work / "p9_subset.txt"
    subset.write_text("".join(f"{barcodes[i]}\n" for i in pos))
    print(f"phase 9 (b): --quant-subset of {len(past)} cells past the ladder and {len(rung)} "
          "others for (c)", flush=True)
    return cap.replay_inputs(), launches, subset


def boot_port_argv(work: Path, data: Path, subset: Path) -> dict:
    """Phase 9 (c)'s quant runs of the port: name -> argv."""
    return {name: ["quant", "-i", str(work / "port" / "gpl"), "-m", str(data / "t2g.tsv"),
                   "-o", str(work / "p9_port" / name / "quant"), *flags,
                   "--quant-subset", str(subset), "-t", str(THREADS), "--device", "cuda"]
            for name, flags, _ in BOOT_QUANTS}


def boot_ref_chain(work: Path, data: Path, subset: Path) -> dict:
    """Start the reference's runs of phase 9 (c) on phase 4's collated
    directory, in a thread."""
    port = boot_port_argv(work, data, subset)
    cmds = [["quant", str(work / "ref" / "gpl"), str(work / "p9_ref" / name / "quant"),
             "alevin-fry-tpu " + " ".join(port[name]), "--t2g", str(data / "t2g.tsv"),
             "--threads", str(THREADS), "--quant-subset", str(subset), *ref_flags]
            for name, _, ref_flags in BOOT_QUANTS]
    return ref_chain_start(cmds, work / "p9_ref_log")


def boot_parity(work: Path, data: Path, subset: Path, chain: dict, card: str,
                profile: bool) -> None:
    """Phase 9 (c): the port's runs against the reference's in ``chain``."""
    import numpy as np
    import torch

    from alevin_fry_tpu_torch.ops import bootstrap
    from reference_host_path import BOOT_ARTIFACTS, QUANT_ARTIFACTS, artifact_mismatches

    runs = boot_port_argv(work, data, subset)
    peaks, secs, launches, past = {}, {}, {}, {}
    for name, argv in runs.items():
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with BootCapture() as cap:
            secs.update(run_stages({name: argv}, "phase 9 (c)", profile, peaks_after(peaks)))
        launches[name] = launch_counts()
        if not all(launches[name][k] > 0 for k in ("K6", "K6-boot", "K8")):
            raise AssertionError(f"phase 9 (c) {name}: a kernel never launched: "
                                 f"{launches[name]}")
        past[name] = int((cap.cells()[1] > bootstrap.EP_LADDER[-1]).sum())
    if not past["cr-like-em"]:
        raise AssertionError("phase 9 (c): no cell of the subset took the route past the ladder")
    stage_lines("phase 9 (c): port on cuda", secs, peaks, card)
    ref_runs = ref_chain_wait(chain)
    bad = []
    names = QUANT_ARTIFACTS + BOOT_ARTIFACTS
    for name in runs:
        port_dir, ref_dir = work / "p9_port" / name, work / "p9_ref" / name
        bad += [f"{name}/{n}" for n in artifact_mismatches(
            port_dir, ref_dir, names, ("quant/quant.json",))]
    if bad:
        raise AssertionError(f"phase 9 (c): port and reference differ in {bad}")
    print(f"phase 9 (c): every data artifact of the {len(runs)} runs (bootstraps_mean.mtx and "
          "bootstraps_var.mtx too) byte-identical and quant.json equal to the reference host "
          f"path; cells past the ladder {past}; launches {launches} (reference on the host CPU, "
          "beside phases 5-8: " + ", ".join(
              f"{name} {list(r.values())[0]:.2f} s" for name, r in zip(runs, ref_runs)) + ")",
          flush=True)


# --- phase 10 ---------------------------------------------------------------

def flex_argv(work: Path) -> dict:
    """Phase 10's runs of the port: (a) the unfiltered gpl with the
    1-edit sample correction, the fast in-memory collate and quant -r
    cr-like; (b) the out-of-core collate in a copy of (a)'s gpl
    directory; (c) the two-round collate in another copy and quant."""
    data, common = work / "flex", ["-t", str(THREADS), "--device", "cuda"]
    a, b, c = (work / name / "gpl" for name in ("flex_port", "flex_port_ooc", "flex_port_tr"))
    return {
        "gpl": ["generate-permit-list", "-i", str(data / "rad"), "-d", "fw", "-o", str(a),
                "-u", str(data / "permit.txt"), "-m", "10", "--sample-bc-list",
                str(data / "samples.tsv"), "--sample-correction-mode", "1-edit", *common],
        "collate": ["collate", "-i", str(a), "-r", str(data / "rad"), *common],
        "quant": ["quant", "-i", str(a), "-m", str(data / "t2g.tsv"),
                  "-o", str(a.parent / "quant"), "-r", "cr-like", *common],
        "collate (b)": ["collate", "-i", str(b), "-r", str(data / "rad"),
                        "-m", str(FLEX_MAX_RECORDS), *common],
        "collate (c)": ["collate", "-i", str(c), "-r", str(data / "rad"),
                        "--collation-mode", "two-round", *common],
        "quant (c)": ["quant", "-i", str(c), "-m", str(data / "t2g.tsv"),
                      "-o", str(c.parent / "quant"), "-r", "cr-like", *common],
    }


def flex_ref_chain(work: Path) -> dict:
    """Start the Flex data's generation, then the reference's runs of
    phase 10's (a) and (c) with the port's command lines, in a thread."""
    data, argv = work / "flex", flex_argv(work)
    cmd = {k: "alevin-fry-tpu " + " ".join(v) for k, v in argv.items()}
    (work / "flex_cmds_a.json").write_text(json.dumps(
        {k: cmd[k] for k in ("gpl", "collate", "quant")}))
    (work / "flex_cmds_c.json").write_text(json.dumps(
        {"collate": cmd["collate (c)"], "quant": cmd["quant (c)"]}))
    common = ["--threads", str(THREADS)]
    return ref_chain_start([
        ["make-flex", str(data), "--n-samples", str(FLEX_SAMPLES), "--n-cells-per-sample",
         str(FLEX_CELLS), "--n-reads", str(FLEX_READS), "--n-genes", str(FLEX_GENES),
         "--seed", str(FLEX_SEED), "--permit-size", str(FLEX_PERMIT)],
        ["run-flex", str(data), str(work / "flex_ref"), str(work / "flex_cmds_a.json"),
         "--sample-correction-mode", "1-edit", *common],
        ["run-flex", str(data), str(work / "flex_ref_tr"), str(work / "flex_cmds_c.json"),
         "--gpl-from", str(work / "flex_ref" / "gpl"), "--collation-mode", "two-round",
         *common],
    ], work / "flex_ref_log")


def flex_phase(work: Path, chain: dict, card: str, profile: bool) -> list:
    """Phase 10: the port's Flex path on the card against the reference's
    runs in ``chain``.  Returns the replay rows of K4 and K1-K3."""
    import torch

    from reference_host_path import FLEX_STAGE_JSONS, artifact_mismatches, flex_artifacts

    while not chain["results"]:  # the data
        if not chain["thread"].is_alive():
            ref_chain_wait(chain)
            raise RuntimeError("the Flex data was not made")
        time.sleep(1)
    made = chain["results"][0]
    argv = flex_argv(work)
    peaks, secs, launches = {}, {}, {}

    def after(stage):
        launches[stage] = launch_counts()
        if stage == "gpl":
            # fresh copies of the gpl directory for (b) and (c)
            for name in ("flex_port_ooc", "flex_port_tr"):
                shutil.copytree(work / "flex_port" / "gpl", work / name / "gpl")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with Capture() as cap:
        secs = run_stages(argv, "phase 10", profile, peaks_after(peaks, after))
    total = launch_counts()
    gpl_k4 = launches["gpl"]["K4"]
    info = json.loads((work / "flex_port" / "gpl" / "sample_info.json").read_text())
    with_reads = sum(1 for e in info["samples"] if e["num_reads"] > 0)
    collate_k4 = launches["collate"]["K4"] - gpl_k4
    if gpl_k4 < with_reads or collate_k4 < 1 or not all(total[k] > 0 for k in FLEX_KERNELS):
        raise AssertionError(f"phase 10: K4 launched {gpl_k4} times in gpl for {with_reads} "
                             f"samples with reads, {collate_k4} in collate; launches {total}")
    stage_lines("phase 10: port flex on cuda", secs, peaks, card)
    q, k = cap.inputs["K4"][1][:2]
    print(f"phase 10: data {FLEX_READS} reads, {info['num_samples']} samples x {FLEX_CELLS} "
          f"pool cells made in {made['seconds']:.1f} s (sample-barcode 1-sub reads "
          f"{made['sample_bc_1sub']}, 2-sub {made['sample_bc_2sub']}, cell-barcode errors "
          f"{made['cell_bc_1sub']}; permit list {made['permit_entries']} entries, the least-read "
          f"listed cell {made['least_listed_reads']} reads, the most-read other code "
          f"{made['most_other_reads']}); {info['total_cells']} composite cells, matched reads "
          f"{info['matched_reads']}, unmatched {info['unmatched_reads']}; K4 launches: gpl "
          f"{gpl_k4}, collate {collate_k4}, largest Q = {len(q)} x K = {len(k)}; "
          f"launches {total}", flush=True)

    a, b, c = (work / name for name in ("flex_port", "flex_port_ooc", "flex_port_tr"))
    for name in ("map.collated.rad", "collation_manifest.bin"):
        if (b / "gpl" / name).read_bytes() != (a / "gpl" / name).read_bytes():
            raise AssertionError(f"phase 10 (b): the out-of-core {name} differs from (a)'s")
    _made, ref_a, ref_c = ref_chain_wait(chain)
    names = flex_artifacts(a)
    bad = [f"(a) {n}" for n in artifact_mismatches(a, work / "flex_ref", names, FLEX_STAGE_JSONS)]
    bad += [f"(c) {n}" for n in artifact_mismatches(c, work / "flex_ref_tr", names,
                                                    FLEX_STAGE_JSONS)]
    if names != flex_artifacts(work / "flex_ref") or bad:
        raise AssertionError(f"phase 10: port and reference differ in {bad}")
    print(f"phase 10: (a) and (c) {len(names)} data artifacts each byte-identical and 4 stage "
          f"JSONs equal to the reference host path, (b)'s collated file and manifest equal "
          f"(a)'s (host CPU, beside phases 5-9: (a) " + ", ".join(
              f"{k} {v:.2f} s" for k, v in ref_a.items()) + "; (c) " + ", ".join(
              f"{k} {v:.2f} s" for k, v in ref_c.items()) + ")", flush=True)
    return replay(cap.inputs, FLEX_KERNELS, total, "flex", "phase 10", card)


# --- phase 11 ---------------------------------------------------------------

def bam_data_chain(work: Path, threads: int = THREADS) -> dict:
    """Start the two BAMs' generation, on ``threads`` threads, in a thread."""
    return ref_chain_start([
        ["make-bam", str(work / "bam"), "--n-alignments", str(BAM_ALIGNMENTS), "--seed",
         str(BAM_SEED), "--threads", str(threads)],
        ["make-bam", str(work / "bam_f"), "--n-alignments", str(BAM_F_ALIGNMENTS), "--seed",
         str(BAM_F_SEED), "--threads", str(threads)],
    ], work / "bam_data_log")


def sha256(path: Path) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def bam_phase(work: Path, chain: dict, card: str, profile: bool) -> list:
    """Phase 11: (b) the port's convert of phase 11's BAM, the reference's
    beside it; (c) generate-permit-list -u, collate and quant -r cr-like
    on the converted RAD on the card, the reference's host path on its
    own RAD beside them; (d) convert -f and view -H of the second BAM in
    both packages.  Returns the replay rows of K4 and K1-K3."""
    import contextlib

    import torch

    from alevin_fry_tpu_torch.cli import main as port_main
    from reference_host_path import artifact_mismatches

    made, made_f = ref_chain_wait(chain)
    data, data_f = work / "bam", work / "bam_f"
    print(f"phase 11 (a): BAM of {made['records']} records ({made['reads']} reads, "
          f"{made['skipped_records']} unmapped or supplementary, barcode substitutions: "
          f"{made['bc_1sub_reads']} reads one, {made['bc_2sub_reads']} two; Ns: "
          f"{made['one_n_reads']} reads one, {made['two_n_reads']} two) made in "
          f"{made['seconds']:.1f} s, {made['bytes']} B BGZF holding "
          f"{made['uncompressed_bytes']} B; -u list {made['permit_entries']} entries; the -f "
          f"BAM {made_f['records']} records in {made_f['seconds']:.1f} s, {made_f['bytes']} B",
          flush=True)
    common = ["-t", str(THREADS)]
    dev = [*common, "--device", "cuda"]
    rad, ref_rad = data / "rad", work / "bam_ref" / "rad"
    out = work / "bam_port"
    stages = {
        "gpl": ["generate-permit-list", "-i", str(rad), "-d", "fw", "-o", str(out / "gpl"),
                "-u", str(data / "permit.txt"), "-m", "10", *dev],
        "collate": ["collate", "-i", str(out / "gpl"), "-r", str(rad), *dev],
        "quant": ["quant", "-i", str(out / "gpl"), "-m", str(data / "t2g_3col.tsv"),
                  "-o", str(out / "quant"), "-r", "cr-like", *dev],
    }
    (work / "bam_cmds.json").write_text(json.dumps(
        {k: "alevin-fry-tpu " + " ".join(v) for k, v in stages.items()}))
    rad_f = work / "bam_f_port.rad"
    ref_chain = ref_chain_start([
        ["convert", str(data / "aln.bam"), str(ref_rad / "map.rad"), "--threads", str(THREADS)],
        ["run", str(data), str(work / "bam_ref_run"), str(work / "bam_cmds.json"), "--usa",
         "--threads", str(THREADS), "--rad", str(ref_rad)],
        ["convert", str(data_f / "aln.bam"), str(work / "bam_f_ref.rad"), "--filter-best",
         "--threads", str(THREADS)],
        ["view", str(work / "bam_f_ref.rad"), str(work / "bam_f_ref.txt"), "--header"],
    ], work / "bam_ref_log")
    try:
        secs = run_stages({"convert": ["convert", "-b", str(data / "aln.bam"), "-o",
                                       str(rad / "map.rad"), *common]}, "phase 11", profile)
        peaks, per_stage = {}, {}
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with Capture() as cap:
            secs_c = run_stages(stages, "phase 11", profile, peaks_after(
                peaks, lambda stage: per_stage.update({stage: launch_counts()})))
        total = launch_counts()
        if per_stage["gpl"]["K4"] < 1 or not all(total[k] > 0 for k in RNA_KERNELS):
            raise AssertionError(f"phase 11 (c): a kernel never launched: {per_stage}")
        nnz = check_outputs(out, 3 * N_GENES)
        secs_d = run_stages({"convert -f": ["convert", "-b", str(data_f / "aln.bam"), "-o",
                                            str(rad_f), "-f", *common]}, "phase 11", profile)
        with open(work / "bam_f_port.txt", "w") as fh, contextlib.redirect_stdout(fh):
            t0 = time.perf_counter()
            if port_main(["view", "-r", str(rad_f), "-H"]) != 0:
                raise RuntimeError("port view failed")
            secs_d["view -H"] = time.perf_counter() - t0
        ref_b, ref_run, ref_f, ref_view = ref_chain_wait(ref_chain)
    finally:
        ref_chain_stop(ref_chain)
    if (rad / "map.rad").read_bytes() != (ref_rad / "map.rad").read_bytes():
        raise AssertionError("phase 11 (b): the port's RAD differs from the reference's")
    print(f"phase 11 (b): convert -t {THREADS}: RAD of {(rad / 'map.rad').stat().st_size} B "
          f"byte-identical to the reference's; port {secs['convert']:.2f} s, reference "
          f"{ref_b['convert']:.2f} s (beside it) [{card}]", flush=True)
    bad = artifact_mismatches(out, work / "bam_ref_run")
    if bad:
        raise AssertionError(f"phase 11 (c): port and reference differ in {bad}")
    stage_lines("phase 11 (c): port on cuda", secs_c, peaks, card)
    print(f"phase 11 (c): launches K4 {total['K4']} (gpl), K1 {total['K1']}, K2 "
          f"{total['K2']}, K3 {total['K3']} (quant); nnz {nnz}; 8 data artifacts "
          f"byte-identical and 3 stage JSONs equal to the reference host path on its own RAD "
          f"(host CPU, beside the port: " + ", ".join(
              f"{k} {v:.2f} s" for k, v in ref_run.items()) + ")", flush=True)
    if rad_f.read_bytes() != (work / "bam_f_ref.rad").read_bytes():
        raise AssertionError("phase 11 (d): the port's convert -f RAD differs")
    port_sha, ref_sha = sha256(work / "bam_f_port.txt"), sha256(work / "bam_f_ref.txt")
    if port_sha != ref_sha:
        raise AssertionError("phase 11 (d): view -H texts differ")
    with open(work / "bam_f_port.txt", "rb") as fh:
        n_lines = sum(block.count(b"\n") for block in iter(lambda: fh.read(1 << 24), b""))
    print(f"phase 11 (d): convert -f RAD ({rad_f.stat().st_size} B) byte-identical; view -H "
          f"{n_lines} lines ({ref_view['lines']} alignments) of sha256 {port_sha[:16]}... in "
          f"both; port convert -f {secs_d['convert -f']:.2f} s, view -H "
          f"{secs_d['view -H']:.2f} s; reference (beside the port) {ref_f['convert']:.2f} s, "
          f"{ref_view['view']:.2f} s", flush=True)
    return replay(cap.inputs, RNA_KERNELS, total, "bam", "phase 11", card)


# --- phase 12 ---------------------------------------------------------------

def mh_jsons_differ(a: Path, b: Path, names) -> list:
    """The stage JSONs of ``names`` that differ between two runs, field
    for field without the fields naming a run's directories and its
    command line."""
    from reference_host_path import comparable_json

    def fields(path):
        d = comparable_json(path)
        d.pop("cmd", None)
        for key in ("gpl_options", "quant_options"):
            d.get(key, {}).pop("cmdline", None)
        return d

    return [n for n in names if fields(a / n) != fields(b / n)]


def mh_run(label: str, stages: list, logs: Path, card: str, set_=(), **env) -> tuple:
    """A run's stages as two ranks of the port on the card: one pair of
    tools/stage_worker.py processes (tests/two_process.py) runs them one
    after another, each stage joining the run at a free local port of its
    own, as the CLI does.  ``stages``: (name, argv, kernels, ranks[, moves])
    -- each kernel must launch on each of ``ranks`` in that stage.  Raises
    if a rank fails or the pair outlives MH_TIMEOUT.  Prints each stage's
    seconds, peak device memory, bytes sent through gloo and launches per
    rank; returns each stage's per-rank summaries and the ranks' logs."""
    from two_process import run_two

    summaries, errs = run_two([[name, argv, *moves] for name, argv, _k, _r, *moves in stages],
                              logs, set_, MH_TIMEOUT, **env)
    out = {}
    for name, _argv, need, ranks, *_moves in stages:
        st = out[name] = [s["stages"][name] for s in summaries]
        missing = [(r, k) for r in ranks for k in need if st[r]["launches"][k] < 1]
        if missing:
            raise AssertionError(f"phase 12 {label} {name}: (rank, kernel) never launched "
                                 f"{missing}: {[x['launches'] for x in st]}")
        print(f"phase 12 {label}: {name} " + "; ".join(
            f"rank {r} on {x['device']} {x['seconds']:.2f} s, peak {x['peak_mib']:.0f} MiB, "
            f"gloo {x['gloo_bytes']} B sent, launches "
            f"{ {k: v for k, v in x['launches'].items() if v} }" for r, x in enumerate(st))
            + f" [{card}]", flush=True)
    return out, errs


def multihost_phase(work: Path, data: Path, subset: Path, card: str) -> None:
    """Phase 12: the port's stages as two processes on the card, each
    against the one-process run of an earlier phase on the same data:
    (a) phase 3's gpl, collate and quant; (b) on (a)'s collated data,
    phase 7's quant -r cr-like-em -d and phase 9 (c)'s -b 20
    --summary-stat on its subset; (c) quant with the spill bound at
    MH_SPILL triplets and the merge round at MH_MERGE, as one process (in
    this one) and as two, against phase 3's; (d) phase 5's ATAC stages;
    (e) phase 10 (a)'s Flex stages."""
    import logging

    import torch

    from alevin_fry_tpu_torch.pipeline import quant as port_quant
    from reference_host_path import (
        ATAC_DATA_ARTIFACTS, ATAC_STAGE_JSONS, BOOT_ARTIFACTS, DATA_ARTIFACTS, DUMP_ARTIFACTS,
        FLEX_STAGE_JSONS, QUANT_ARTIFACTS, STAGE_JSONS, artifact_mismatches, flex_artifacts,
    )

    t_phase = time.perf_counter()
    out, logs = work / "p12", work / "p12_logs"
    dev = ["-t", str(THREADS), "--device", "cuda"]
    both = (0, 1)

    def check(label, got, want, names, jsons):
        bad = artifact_mismatches(got, want, names, ()) + mh_jsons_differ(got, want, jsons)
        if bad:
            raise AssertionError(f"phase 12 {label}: differs from the one-process run in {bad}")

    # (a) the main path
    a = out / "a"
    mh_run("(a)", [
        ("gpl", ["generate-permit-list", "-i", str(data / "rad"), "-d", "fw", "-o",
                 str(a / "gpl"), "-u", str(data / "permit.txt"), "-m", "10", *dev], ("K4",), both),
        ("collate", ["collate", "-i", str(a / "gpl"), "-r", str(data / "rad"), *dev], (), ()),
        ("quant", ["quant", "-i", str(a / "gpl"), "-m", str(data / "t2g_3col.tsv"), "-o",
                   str(a / "quant"), "-r", "cr-like", *dev], SCAN_KERNELS, both),
    ], logs / "a", card)
    check("(a)", a, work / "port", DATA_ARTIFACTS, STAGE_JSONS)
    print("phase 12 (a): 8 data artifacts byte-identical and 3 stage JSONs equal to phase 3's "
          "one-process run (which phase 4 holds to the reference)", flush=True)

    # (b) the EM with its dump, and the bootstraps on phase 9 (c)'s subset
    mh_run("(b)", [
        ("quant -r cr-like-em -d", [
            "quant", "-i", str(a / "gpl"), "-m", str(data / "t2g_3col.tsv"), "-o",
            str(out / "b_em" / "quant"), "-r", "cr-like-em", "-d", *dev], ("K6",), both),
        ("quant -b 20", [
            "quant", "-i", str(a / "gpl"), "-m", str(data / "t2g.tsv"), "-o",
            str(out / "b_boot" / "quant"), *BOOT_QUANTS[0][1], "--quant-subset", str(subset),
            *dev], ("K6", "K6-boot", "K8"), both),
    ], logs / "b", card)
    check("(b) -d", out / "b_em", work / "p7_port" / "em-usa", QUANT_ARTIFACTS + DUMP_ARTIFACTS,
          ("quant/quant.json",))
    check("(b) -b", out / "b_boot", work / "p9_port" / "cr-like-em",
          QUANT_ARTIFACTS + BOOT_ARTIFACTS, ("quant/quant.json",))
    print("phase 12 (b): cr-like-em -d (the dump too) equal to phase 7's run, -b 20 "
          "--summary-stat (both bootstrap matrices) to phase 9 (c)'s", flush=True)

    # (c) the spill, as one process (this one) and as two
    quant = ["quant", "-i", str(a / "gpl"), "-m", str(data / "t2g_3col.tsv"), "-r", "cr-like"]
    spill = {"QUANT_SPILL_TRIPLETS": MH_SPILL, "QUANT_MERGE_TRIPLETS": MH_MERGE}
    saved = {k: getattr(port_quant, k) for k in spill}
    said = []
    heard = logging.Handler()
    heard.emit = lambda record: said.append(record.getMessage())
    logging.getLogger("aft_torch.quant").addHandler(heard)
    peaks = {}
    try:
        for k, v in spill.items():
            setattr(port_quant, k, v)
        torch.cuda.reset_peak_memory_stats()
        one = run_stages({"quant": [*quant, "-o", str(out / "c1" / "quant"), *dev]},
                         "phase 12 (c)", after=peaks_after(peaks))
    finally:
        for k, v in saved.items():
            setattr(port_quant, k, v)
        logging.getLogger("aft_torch.quant").removeHandler(heard)
    if not any("streamed to disk" in m for m in said):
        raise AssertionError("phase 12 (c): the one-process quant did not spill")
    print(f"phase 12 (c): one process, spill bound {MH_SPILL}: quant {one['quant']:.2f} s, peak "
          f"{peaks['quant'] / 2**20:.0f} MiB [{card}]", flush=True)
    _st, errs = mh_run("(c)", [("quant spill", [*quant, "-o", str(out / "c2" / "quant"), *dev],
                                SCAN_KERNELS, both)],
                       logs / "c", card, [("alevin_fry_tpu_torch.pipeline.quant", k, v)
                                          for k, v in spill.items()])
    if not all("spilled to the rank-local binary" in e for e in errs):
        raise AssertionError("phase 12 (c): a rank did not spill")
    for run in ("c1", "c2"):
        check(f"(c) {run}", out / run, work / "port", QUANT_ARTIFACTS, ())
    print(f"phase 12 (c): both quants_mat.mtx (and the other quant artifacts) equal phase 3's; "
          f"the one process streamed its matrix past {MH_SPILL} triplets, both ranks spilled to "
          f"their binary sidecars, merged in rounds of {MH_MERGE}", flush=True)

    # (d) ATAC on phase 5's data (the rescue on K5, as in phase 5)
    adata, d = work / "atac_data", out / "d"
    gpl, m = str(d / "gpl"), ["-m", str(ATAC_MAX_RECORDS)]
    st, _errs = mh_run("(d)", [
        ("atac gpl", ["atac", "generate-permit-list", "-i", str(adata / "rad"), "-o", gpl,
                      "-u", str(adata / "wl.txt"), "-m", "10", *dev], ("K5",), both),
        ("atac sort", ["atac", "sort", "-i", gpl, "-r", str(adata / "rad"), *m, *dev],
         ("K1", "K2"), (0,), [[f"{gpl}/map.bed", str(d / "sort" / "map.bed")]]),
        ("atac collate", ["atac", "collate", "-i", gpl, "-r", str(adata / "rad"), *m, *dev],
         (), ()),
        ("atac deduplicate", ["atac", "deduplicate", "-i", gpl, *dev], ("K1", "K2"), both),
    ], logs / "d", card, AFT_RESCUE_BACKEND="pallas")
    counters = json.loads((work / "atac_counters.json").read_text())
    if any(x["dedup"] != counters for x in st["atac deduplicate"]):
        raise AssertionError(f"phase 12 (d): counters "
                             f"{[x['dedup'] for x in st['atac deduplicate']]}, phase 5's "
                             f"{counters}")
    check("(d)", d, work / "atac_port", ATAC_DATA_ARTIFACTS, ATAC_STAGE_JSONS)
    print(f"phase 12 (d): 8 ATAC data artifacts byte-identical, 3 stage JSONs and the 4 "
          f"counters {counters} equal to phase 5's", flush=True)

    # (e) Flex on phase 10's data, as phase 10 (a)
    fdata, e = work / "flex", out / "e"
    mh_run("(e)", [
        ("flex gpl", ["generate-permit-list", "-i", str(fdata / "rad"), "-d", "fw", "-o",
                      str(e / "gpl"), "-u", str(fdata / "permit.txt"), "-m", "10",
                      "--sample-bc-list", str(fdata / "samples.tsv"),
                      "--sample-correction-mode", "1-edit", *dev], ("K4",), both),
        ("flex collate", ["collate", "-i", str(e / "gpl"), "-r", str(fdata / "rad"), *dev],
         ("K4",), both),
        ("flex quant", ["quant", "-i", str(e / "gpl"), "-m", str(fdata / "t2g.tsv"), "-o",
                        str(e / "quant"), "-r", "cr-like", *dev], SCAN_KERNELS, both),
    ], logs / "e", card)
    names = flex_artifacts(work / "flex_port")
    if flex_artifacts(e) != names:
        raise AssertionError("phase 12 (e): the samples' permit files differ from phase 10's")
    check("(e)", e, work / "flex_port", names, FLEX_STAGE_JSONS)
    print(f"phase 12 (e): {len(names)} Flex data artifacts byte-identical and 4 stage JSONs "
          f"equal to phase 10 (a)'s", flush=True)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s in all [{card}]", flush=True)

# --- phase 13 ---------------------------------------------------------------

class Spy:
    """Records the arguments of the largest call (by its largest array)
    of ``alevin_fry_tpu_torch.<module>.<name>`` while entered, and counts
    the calls."""

    def __init__(self, module: str, name: str):
        import importlib

        self.mod = importlib.import_module(f"alevin_fry_tpu_torch.{module}")
        self.name = name
        self.args, self.kwargs, self.size, self.calls = None, None, -1, 0

    def __enter__(self):
        self._orig = getattr(self.mod, self.name)

        def spy(*args, **kwargs):
            self.calls += 1
            size = max((a.numel() if hasattr(a, "numel") else a.size
                        for a in args if hasattr(a, "shape")), default=0)
            if size > self.size:
                self.size = size
                self.args = args
                self.kwargs = dict(kwargs)
            return self._orig(*args, **kwargs)

        setattr(self.mod, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self._orig)


def mesh_stages(work: Path, data: Path, out: Path, dev) -> dict:
    """Phase 13's CLI runs into ``out``: phase 3's gpl -u and collate,
    phase 7's quant -r cr-like-em -d and infer --usa, phase 5's ATAC gpl
    (K5, as there), on ``dev``: name -> (argv, its run's directory, the
    one-card run's, data artifacts, stage JSONs)."""
    from reference_host_path import DUMP_ARTIFACTS, INFER_ARTIFACTS, QUANT_ARTIFACTS

    dev = ["-t", str(THREADS), "--device", dev.type]
    gpl, dump = out / "gpl", out / "em-usa" / "quant" / "alevin"
    adata = work / "atac_data"
    return {
        "gpl": (["generate-permit-list", "-i", str(data / "rad"), "-d", "fw", "-o", str(gpl),
                 "-u", str(data / "permit.txt"), "-m", "10", *dev], out, work / "port",
                ("gpl/permit_freq.bin", "gpl/permit_map.bin"),
                ("gpl/generate_permit_list.json",)),
        "collate": (["collate", "-i", str(gpl), "-r", str(data / "rad"), *dev], out,
                    work / "port", ("gpl/map.collated.rad", "gpl/unmapped_bc_count_collated.bin"),
                    ("gpl/collate.json",)),
        "quant -r cr-like-em -d": (
            ["quant", "-i", str(gpl), "-m", str(data / "t2g_3col.tsv"), "-o",
             str(out / "em-usa" / "quant"), "-r", "cr-like-em", "-d", *dev], out / "em-usa",
            work / "p7_port" / "em-usa", QUANT_ARTIFACTS + DUMP_ARTIFACTS, ("quant/quant.json",)),
        "infer --usa": (
            ["infer", "-c", str(dump / "geqc_counts.mtx"), "-e", str(dump / "gene_eqclass.txt.gz"),
             "-o", str(out / "infer-usa" / "infer"), "--usa", *dev], out / "infer-usa",
            work / "p7_port" / "infer-usa", INFER_ARTIFACTS, ()),
        "atac gpl": (
            ["atac", "generate-permit-list", "-i", str(adata / "rad"), "-o",
             str(out / "atac" / "gpl"), "-u", str(adata / "wl.txt"), "-m", "10", *dev],
            out / "atac", work / "atac_port",
            ("gpl/permit_freq.bin", "gpl/permit_map.bin", "gpl/bin_recs.bin", "gpl/bin_lens.bin"),
            ("gpl/generate_permit_list.json",)),
    }


def by_card(since: dict) -> dict:
    """Launches per card and kernel since ``since`` (a copy of BY_CARD)."""
    from alevin_fry_tpu_torch import _kernels

    return {f"cuda:{c} {k}": n - since.get((c, k), 0)
            for (c, k), n in sorted(_kernels.BY_CARD.items()) if n > since.get((c, k), 0)}


def set_env(env: dict) -> dict:
    """Set (a value) or remove (None) each variable of ``env``; returns
    what was there, for set_env to restore."""
    import os

    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return saved


def mesh_runs(work: Path, data: Path, label: str, env: dict, card: str, dev) -> tuple:
    """Phase 13's CLI runs with the mesh variables ``env``, each held to
    its one-card run byte for byte.  Returns the Spies of the mesh
    programs (each program's largest call) and the launches per card and
    kernel of the runs."""
    from alevin_fry_tpu_torch import _kernels
    from alevin_fry_tpu_torch.parallel import mesh
    from reference_host_path import artifact_mismatches

    stages = mesh_stages(work, data, work / "p13" / label.strip("()"), dev)
    spies = {"hist": Spy("pipeline.gpl", "sharded_histogram"),
             "bins": Spy("atac.gpl", "sharded_bin_histogram"),
             "em": Spy("pipeline.quant", "em_cells"), "infer": Spy("pipeline.infer", "em_cells")}
    secs, lines, start = {}, [], dict(_kernels.BY_CARD)
    saved = set_env(env)
    try:
        for spy in spies.values():
            spy.__enter__()
        for name, (argv, *_dirs) in stages.items():
            rescue = set_env({"AFT_RESCUE_BACKEND": "pallas" if name == "atac gpl" else None})
            since, bytes0 = dict(_kernels.BY_CARD), mesh.MOVED_BYTES
            try:
                secs.update(run_stages({name: argv}, f"phase 13 {label}"))
            finally:
                set_env(rescue)
            lines.append(f"phase 13 {label}: {name} {secs[name]:.2f} s, mesh bytes moved "
                         f"{mesh.MOVED_BYTES - bytes0}, launches by card {by_card(since)} "
                         f"[{card}]")
    finally:
        for spy in spies.values():
            spy.__exit__()
        set_env(saved)
    launches = by_card(start)
    bad = []
    for name, (_argv, run, one, names, jsons) in stages.items():
        bad += [f"{name}: {n}" for n in artifact_mismatches(run, one, names, ())
                + mh_jsons_differ(run, one, jsons)]
    if bad:
        raise AssertionError(f"phase 13 {label}: differs from the one-card runs in {bad}")
    print("\n".join(lines), flush=True)
    return spies, launches


def timed(fn) -> tuple:
    """(``fn()``, its host seconds, ended by a synchronize)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mesh_programs(spies: dict, card: str, cuda) -> dict:
    """Phase 13 (a): each mesh program the stages call on MESH_SHARDS
    shards of the card against its result on one shard (or without a
    mesh), on the inputs the path gave it: the barcode and bin histograms
    of (b)'s gpl runs and the EM of (b)'s quant.  Returns the launches per
    card and kernel."""
    import numpy as np

    from alevin_fry_tpu_torch import _kernels
    from alevin_fry_tpu_torch.ops import em
    from alevin_fry_tpu_torch.parallel import mesh

    two, one = mesh.make_mesh(MESH_SHARDS, cuda), mesh.make_mesh(1, cuda)
    start, lines = dict(_kernels.BY_CARD), []

    def held(name: str, shape, run, equal) -> None:
        """Run ``run(mesh_or_None, sharded)`` sharded and on one card,
        raise unless ``equal(sharded result, one-card result)``."""
        since, bytes0 = dict(_kernels.BY_CARD), mesh.MOVED_BYTES
        got, s2 = timed(lambda: run(two, True))
        moved, cards = mesh.MOVED_BYTES - bytes0, by_card(since)
        want, s1 = timed(lambda: run(one, False))
        if not equal(got, want):
            raise AssertionError(f"phase 13 (a): {name} on {MESH_SHARDS} shards differs from "
                                 f"one card")
        lines.append(f"phase 13 (a): {name} {shape}: {MESH_SHARDS} shards {s2:.3f} s, one card "
                     f"{s1:.3f} s, equal; mesh bytes moved {moved}; launches by card {cards} "
                     f"[{card}]")

    def arrays_equal(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    _, bcs, wl = spies["hist"].args
    held("sharded_histogram", [len(bcs), len(wl)],
         lambda m, _s: mesh.sharded_histogram(m, bcs, wl),
         lambda a, b: arrays_equal(a[::2], b[::2]) and a[1] == b[1])
    _, idx, n_bins = spies["bins"].args
    held("sharded_bin_histogram", [len(idx), n_bins],
         lambda m, _s: mesh.sharded_bin_histogram(m, idx, n_bins), np.array_equal)

    args, kwargs = spies["em"].args, dict(spies["em"].kwargs)
    kwargs.pop("mesh", None)

    def em_equal(a, b):
        return len(a) == len(b) and all(np.array_equal(ai, bi) and np.array_equal(
            av.view(np.int32), bv.view(np.int32)) for (ai, av), (bi, bv) in zip(a, b))

    held("em_cells", [len(args[0]) - 1, len(args[1]) - 1, len(args[2])],
         lambda m, sharded: em.em_cells(*args, **kwargs, mesh=m if sharded else None),
         em_equal)
    print("\n".join(lines), flush=True)
    return by_card(start)


def mesh_phase(work: Path, data: Path, card: str, dev) -> None:
    """Phase 13: the device mesh of one process on the card.  (b) the CLI
    with AFT_GPL_MESH and AFT_EM_MESH at MESH_SHARDS (shard s on
    cuda:{s % cards}: all on the card of a one-card machine) and collate
    (which takes no mesh), each stage against its
    one-card run of phases 3, 5 and 7 (which phases 4, 5 and 7 hold to
    the reference); (a) each mesh program on the inputs (b) gave it
    against its one-card result; (c) where there are two
    cards or more, (b) with the variables unset, which means one shard a
    card, with each card's launches."""
    import torch

    from alevin_fry_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    bytes0 = mesh.MOVED_BYTES
    n = str(MESH_SHARDS)
    spies, launches = mesh_runs(work, data, "(b)", {"AFT_GPL_MESH": n, "AFT_EM_MESH": n},
                                card, dev)
    want = [f"cuda:0 {k}" for k in ("K1", "K2", "K3", "K4", "K5", "K6")]
    if any(k not in launches for k in want) or any(
            not (s.calls and s.args) for s in spies.values()):
        raise AssertionError(f"phase 13 (b): a kernel or a mesh program never ran: {launches}, "
                             f"{ {k: s.calls for k, s in spies.items()} }")
    cards = torch.cuda.device_count()
    print(f"phase 13 (b): gpl -u, collate, quant -r cr-like-em -d, infer --usa and atac gpl "
          f"with {MESH_SHARDS} shards on {min(cards, MESH_SHARDS)} card(s) byte-identical to "
          f"phases 3, 5 and 7; "
          f"program calls { {k: s.calls for k, s in spies.items()} }; launches by card "
          f"{launches}", flush=True)
    launches = mesh_programs(spies, card, dev)
    if "cuda:0 K6" not in launches:
        raise AssertionError(f"phase 13 (a): a kernel never launched: {launches}")
    if cards < 2:
        print(f"phase 13 (c): one card ({cards}), so no mesh of several cards ran", flush=True)
    else:
        _spies, launches = mesh_runs(work, data, "(c)", {"AFT_GPL_MESH": None,
                                                         "AFT_EM_MESH": None}, card, dev)
        missing = [c for c in range(cards) if f"cuda:{c} K6" not in launches]
        if missing:
            raise AssertionError(f"phase 13 (c): K6 never launched on cards {missing}: "
                                 f"{launches}")
        print(f"phase 13 (c): the same runs with one shard on each of {cards} cards "
              f"byte-identical; launches by card {launches}", flush=True)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s in all, mesh bytes moved "
          f"{mesh.MOVED_BYTES - bytes0} [{card}]", flush=True)


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
    from alevin_fry_tpu_torch.ops import hamming
    from alevin_fry_tpu_torch.radz import _native
    from reference_host_path import artifact_mismatches

    _native.load()  # raises where the native RAD codec does not load
    print(f"phase 0: glibc malloc tuning applied: {_host_tuning._applied}", flush=True)
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
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with Capture() as cap:
        secs, cmdlines = run_port(data, work / "port", args.profile)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(launches[k] > 0 for k in RNA_KERNELS):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    # USA mode: spliced, unspliced and ambiguous columns per gene
    nnz = check_outputs(work / "port", 3 * N_GENES)
    print(f"phase 3: data {N_READS} reads / {N_CELLS} cells generated in {gen_s:.1f} s; "
          f"port on cuda: gpl {secs['gpl']:.2f} s, collate {secs['collate']:.2f} s, "
          f"quant {secs['quant']:.2f} s; nnz {nnz}; launches {launches}; "
          f"peak device memory {peak / 2**20:.0f} MiB [{card}]", flush=True)
    velo_check(work, data, cmdlines, card)

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

    # phase 9 (b) picks the subset on which the reference's runs of (c)
    # go on beside phases 5-8, as phase 7's go on beside phases 5-7
    boot, boot_launches, subset = boot_full_width(work, data, card, args.profile)
    boot_chain = boot_ref_chain(work, data, subset)
    flex_chain = bam_chain = None
    try:
        # phase 10's data and the reference's runs, and phase 11's data, go
        # on beside phases 5-9
        flex_chain = flex_ref_chain(work)
        # two threads: phases 5-9 last minutes, and leave it most cores
        bam_chain = bam_data_chain(work, threads=2)
        rows += [
            k6_replay(boot[0], boot_launches["K6-boot"], "rna-boot", "phase 9 (b)", card),
            k8_replay(boot[1], boot_launches["K8"], "rna-boot", "phase 9 (b)", card),
        ]
        del boot
        chain = em_ref_chain(work, data)
        try:
            rows += atac_phase(work, card, args.profile)
            rows += rna_sz_phase(work, data, card, args.profile)
            rows += atac_sz_phase(work, card, args.profile)
            rows += wide_wta_phase(dev, card)
            rows += em_phase(work, data, chain, card, args.profile)
        finally:
            ref_chain_stop(chain)
        rows += parsimony_phase(work, data, card, args.profile)
        boot_parity(work, data, subset, boot_chain, card, args.profile)
        rows += flex_phase(work, flex_chain, card, args.profile)
        rows += bam_phase(work, bam_chain, card, args.profile)
        multihost_phase(work, data, subset, card)
        mesh_phase(work, data, card, dev)
    finally:
        for ch in (flex_chain, bam_chain):
            if ch is not None:
                ref_chain_stop(ch)
        ref_chain_stop(boot_chain)
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
