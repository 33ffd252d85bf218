#!/usr/bin/env python3
"""Times kernels K6 (the per-cell EM) and K8 (the bootstraps' MT19937
init) of alevin_fry_tpu_torch on one GPU at seeded synthetic shapes, and
with --phase-cycles the cycles of each phase of K6's rounds on a route
(a) block and a route (b) block of the same cells.

    python3 tools/k6_k8_bench.py [--phase-cycles] [--json FILE]

Shapes: ``k6-usa-10k``, tests/em_cases.py's 10,000 random cells with USA
partners and the last round (plain K6); ``k6-boot-large``, 355 cells of
1,500-2,500 classes (past the EM's ladder: sequential denominators) x 20
replicates, the size of the largest bootstrap batch of a 20M-read run;
``k6-boot-small``, 2,000 cells of 30-600 classes x 20 replicates (on the
ladder's rungs); ``k6-weighted``, 2,000 cells of 50-100 classes with
label weights (the size of a 1M-read long-read batch); ``k8-replay``, 20
replicates x 2,396 cells of 360 ids below 20,000.  Every output is first
held to its twin (on the card), bit for bit; a time is the mean of CUDA
events over several launches after a warm-up.  The timing uses only the
package's public functions, so an older commit's package, unpacked with
``git archive`` and put first on PYTHONPATH, is timed on the same inputs
in the same call.

--phase-cycles builds an instrumented copy of csrc/em.cu (thread 0 of
each block reads clock64 at each phase's barrier) with nvcc into
build/k6_phases/, outside the package, and launches it directly on the
k6-usa-10k and k6-boot-large cells that fit route (a): once staged (route
a, one replicate a block) and once with the layout in device memory
(route b).  It prints the mean cycles a round of phases A (USA
abundances), B (denominators) and C (new values) take, and a block's
mean cycles before round 1 and in all.  The script needs a CUDA device
and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PHASE_DIR = REPO / "build" / "k6_phases"
MAX_BLOCKS = 1 << 16  # blocks the instrumented kernel records


def _event_ms(fn, reps: int) -> float:
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


def _same_bits(got, want) -> None:
    import torch

    for g, w in zip(got, want):
        g = g.view(torch.int32) if g.dtype == torch.float32 else g
        w = w.view(torch.int32) if w.dtype == torch.float32 else w
        if not torch.equal(g, w):
            raise AssertionError("a kernel differs from its twin")


def boot_batch(seed: int, n_cells: int, lo_cls: int, hi_cls: int):
    """(cell_eq_offsets, label_offsets, labels, counts, rows) of n_cells
    cells of lo_cls-hi_cls classes over a shuffled pool of about 1.15 ids
    a class (of 20,000 genes): seven in ten classes of one id, the rest of
    2-4 neighbours in the pool, counts 1-5."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ceo, lens, labels = [0], [], []
    for _ in range(n_cells):
        ne = rng.randint(lo_cls, hi_cls + 1)
        pool = rng.choice(20_000, int(ne * 1.15), replace=False)
        k = np.where(rng.rand(ne) < 0.7, 1, rng.randint(2, 5, ne))
        keep = np.arange(4) < k[:, None]
        win = pool[rng.randint(0, len(pool) - 4, ne)[:, None] + np.arange(4)]
        labels.append(np.sort(np.where(keep, win, 1 << 30), axis=1)[keep])
        lens += k.tolist()
        ceo.append(ceo[-1] + ne)
    lo = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
    return (np.asarray(ceo, np.int64), lo, np.concatenate(labels).astype(np.uint32),
            rng.randint(1, 6, len(lens)).astype(np.uint32), 20_000)


def boot_tensors(batch, n_rep: int, device):
    import numpy as np

    from alevin_fry_tpu_torch.ops import bootstrap

    ceo, lo, labels, counts, rows = batch
    cells = np.arange(len(ceo) - 1)
    return bootstrap.replicate_plan(ceo, lo, labels, rows, bootstrap.cell_widths(ceo, lo),
                                    bootstrap.resample(counts, ceo, cells, n_rep),
                                    bootstrap.init_seeds(bootstrap.SEED, cells, n_rep), device)[1]


def usa_tensors(device):
    sys.path.insert(0, str(REPO / "tests"))
    from em_cases import em_case, usa_offsets

    from alevin_fry_tpu_torch.ops import em

    batch, n_rows = em_case("10k-cells")
    return em.plan_cells(*batch, n_rows, usa_offsets(n_rows), False, True).to(device)


def weighted_tensors(device):
    import numpy as np

    from alevin_fry_tpu_torch.ops import em

    ceo, lo, labels, counts, rows = boot_batch(3, 2000, 50, 100)
    w = np.random.RandomState(4).rand(len(labels)).astype(np.float32)
    return em.plan_cells(ceo, lo, labels, counts, rows, None, False, False, w).to(device)


def k8_args(device):
    import numpy as np
    import torch

    rng = np.random.RandomState(8)
    n_rep, n_cells = 20, 2396
    ids = [np.sort(rng.choice(20_000, 360, replace=False)) for _ in range(n_cells)]
    off = torch.from_numpy(np.concatenate(([0], np.cumsum([len(i) for i in ids]))))
    seeds = torch.from_numpy(rng.randint(0, 2**32, (n_rep, n_cells), dtype=np.int64))
    ids = torch.from_numpy(np.concatenate(ids).astype(np.int32))
    return seeds.to(device), off.to(device), ids.to(device)


def time_kernels(dev) -> dict:
    """{shape: the kernel's ms}, each output first held to its twin's."""
    from alevin_fry_tpu_torch.ops import em, mtrand

    out = {}
    cases = {"k6-usa-10k": usa_tensors(dev),
             "k6-boot-large": boot_tensors(boot_batch(1, 355, 1500, 2500), 20, dev),
             "k6-boot-small": boot_tensors(boot_batch(2, 2000, 30, 600), 20, dev),
             "k6-weighted": weighted_tensors(dev)}
    for name, t in cases.items():
        _same_bits(em.em_run(t), em.em_run_twin(t))
        out[name] = _event_ms(lambda: em.em_run(t), 10)
    args = k8_args(dev)
    _same_bits([mtrand.random_init(*args)], [mtrand.random_init_twin(*args)])
    out["k8-replay"] = _event_ms(lambda: mtrand.random_init(*args), 10)
    return out


# --- --phase-cycles --------------------------------------------------------------

# (text in csrc/em.cu, what the instrumented copy puts in its place): per
# block, cycles in phases A, B and C over its rounds, its rounds, the
# cycles before round 1 and in all
PATCHES = (
    ("#include <stdint.h>\n",
     "#include <stdint.h>\n__device__ long long g_cyc[%d][6];\n" % MAX_BLOCKS),
    ("  constexpr bool usa = kUsa;\n",
     "  constexpr bool usa = kUsa;\n  const long long cyc_s = clock64();\n"),
    ("  int it = 0, my_rounds = 0;\n  while (run) {\n    __syncthreads();\n",
     "  int it = 0, my_rounds = 0;\n  long long cyc[3] = {0, 0, 0};\n"
     "  const long long cyc_init = clock64() - cyc_s;\n  while (run) {\n"
     "    __syncthreads();\n    const long long cyc_a = clock64();\n"),
    ("          ab_of(rj<kB>(js, q))[t] = v;\n        }\n      });\n      __syncthreads();\n"
     "    }\n",
     "          ab_of(rj<kB>(js, q))[t] = v;\n        }\n      });\n      __syncthreads();\n"
     "    }\n    const long long cyc_b = clock64();\n"),
    ("                                             : __fdiv_rn(cnt, den[q]);\n      }\n"
     "    });\n    __syncthreads();\n",
     "                                             : __fdiv_rn(cnt, den[q]);\n      }\n"
     "    });\n    __syncthreads();\n    const long long cyc_c = clock64();\n"),
    ("    if ((threadIdx.x & 31) == 0 && mv) atomicOr(&moved_s[it & 1], mv);\n"
     "    __syncthreads();\n",
     "    if ((threadIdx.x & 31) == 0 && mv) atomicOr(&moved_s[it & 1], mv);\n"
     "    __syncthreads();\n    cyc[0] += cyc_b - cyc_a;\n    cyc[1] += cyc_c - cyc_b;\n"
     "    cyc[2] += clock64() - cyc_c;\n"),
    ("  if (threadIdx.x < nt)\n",
     "  if (threadIdx.x == 0 && blockIdx.x + gridDim.x * blockIdx.y < %d) {\n"
     "    long long* o = g_cyc[blockIdx.x + gridDim.x * blockIdx.y];\n"
     "    o[0] = cyc[0]; o[1] = cyc[1]; o[2] = cyc[2]; o[3] = it; o[4] = cyc_init;\n"
     "    o[5] = clock64() - cyc_s;\n  }\n"
     "  if (threadIdx.x < nt)\n" % MAX_BLOCKS),
    ('extern "C" {\n',
     'extern "C" {\nint aft_phase_cycles(long long* host, long long n) {\n'
     '  return static_cast<int>(cudaMemcpyFromSymbol(host, g_cyc, n * 6 * sizeof(long long)));\n'
     '}\n'),
)


def build_phase_copy() -> ctypes.CDLL:
    """The instrumented copy of csrc/em.cu, built into build/k6_phases/."""
    from alevin_fry_tpu_torch import _kernels

    src = (REPO / "alevin_fry_tpu_torch" / "csrc" / "em.cu").read_text()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/em.cu no longer holds the line the probe patches: {old!r}")
        src = src.replace(old, new)
    PHASE_DIR.mkdir(parents=True, exist_ok=True)
    (PHASE_DIR / "em_phases.cu").write_text(src)
    lib = PHASE_DIR / "libk6phases.so"
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(lib),
                    str(PHASE_DIR / "em_phases.cu")], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    ref = _kernels.load()
    dll.aft_em_cells.argtypes = ref.aft_em_cells.argtypes
    dll.aft_em_cells.restype = ctypes.c_int
    dll.aft_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    dll.aft_phase_cycles.restype = ctypes.c_int
    return dll


def phase_cycles(dll, t, limit: int, threads: int) -> dict:
    """Mean cycles a round of phases A, B and C on the cells of ``t`` that
    fit route (a) with one replicate, run once staged (route a) and once
    from device memory (route b), one replicate a block, ``threads``
    threads a block; each run's values equal em_run's."""
    import numpy as np
    import torch

    from alevin_fry_tpu_torch import _kernels
    from alevin_fry_tpu_torch.ops import em

    boot = t.boot_counts is not None
    C, E, U = len(t.dict_off) - 1, len(t.countf), len(t.occ_off) - 1
    n_rep = t.boot_counts.shape[0] if boot else 1
    sizes = torch.stack([t.cell_cls, t.lab_off[t.cell_cls]]).cpu().numpy()
    ne, nl = np.diff(sizes[0]), np.diff(sizes[1])
    nu = np.diff(t.dict_off.cpu().numpy())
    usa = bool((t.p1 >= 0).any())
    staged, shared = em.cell_bytes(ne, nl, nu, usa, False, 1)
    cells = np.flatnonzero(staged <= limit)[: MAX_BLOCKS // n_rep]
    want = em.em_run(t)[0].reshape(n_rep, U)
    out = {}
    for route, need in (("a", staged), ("b", shared)):
        alpha = torch.zeros((n_rep, U), dtype=torch.float32, device=t.occ.device)
        rounds = torch.zeros((n_rep, C), dtype=torch.int32, device=t.occ.device)
        soff = torch.full((C,), -1, dtype=torch.int64, device=t.occ.device)
        cl = torch.from_numpy(cells.astype(np.int32)).to(t.occ.device)
        counts = t.boot_counts if boot else t.countf
        _kernels.check(dll.aft_em_cells(
            t.cell_cls.data_ptr(), t.lab_off.data_ptr(), t.lab_loc.data_ptr(),
            counts.data_ptr(), t.dict_off.data_ptr(), t.p1.data_ptr(), t.p2.data_ptr(),
            t.occ_off.data_ptr(), t.occ.data_ptr(), 0, 0, cl.data_ptr(), len(cells),
            int(route == "a"), 1, threads, soff.data_ptr(), 0, int(need[cells].max()),
            t.init_value, int(t.with_last_round), int(usa), alpha.data_ptr(),
            rounds.data_ptr(),
            *(t.cell_lp.data_ptr(), t.boot_init.data_ptr()) if boot else (0, 0),
            n_rep, E, U, C, 0, _kernels.stream_of(alpha)), "instrumented K6")
        torch.cuda.synchronize()
        ent = torch.cat([torch.arange(int(t.dict_off[c]), int(t.dict_off[c + 1]))
                         for c in cells]).to(t.occ.device)
        _same_bits([alpha[:, ent]], [want[:, ent]])
        cyc = np.zeros((MAX_BLOCKS, 6), np.int64)
        if dll.aft_phase_cycles(cyc.ctypes.data, MAX_BLOCKS):
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        cyc = cyc[: len(cells) * n_rep]
        n_rounds = int(cyc[:, 3].sum())
        out[route] = {"blocks": len(cyc), "rounds": n_rounds,
                      **{ph: float(cyc[:, i].sum()) / n_rounds for i, ph in enumerate("ABC")},
                      "init": float(cyc[:, 4].mean()), "block": float(cyc[:, 5].mean()),
                      "block_max": int(cyc[:, 5].max())}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase-cycles", action="store_true",
                    help="also the cycles of each round's phases of an instrumented K6 copy")
    ap.add_argument("--json", type=Path, help="write the results to this file too")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.append(str(REPO))  # after PYTHONPATH, which may name another commit's package
    sys.path.insert(0, str(REPO / "tests"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    import alevin_fry_tpu_torch

    res = {"package": str(Path(alevin_fry_tpu_torch.__file__).parent), "card": card,
           "ms": time_kernels(dev)}
    print(json.dumps(res), flush=True)
    if args.phase_cycles:
        from alevin_fry_tpu_torch import _kernels

        dll = build_phase_copy()
        limit = int(_kernels.load().aft_smem_limit())
        res["phase_cycles"] = {
            "k6-usa-10k": phase_cycles(dll, usa_tensors(dev), limit, 256),
            "k6-boot-large": phase_cycles(
                dll, boot_tensors(boot_batch(1, 355, 1500, 2500), 20, dev), limit, 256),
        }
        print(json.dumps(res["phase_cycles"]), flush=True)
    if args.json:
        args.json.write_text(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
