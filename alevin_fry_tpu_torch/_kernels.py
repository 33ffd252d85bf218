"""Build and bind the port's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` (one process per
source, all started together, then one link) into one shared library
with a plain C interface and loaded with :mod:`ctypes`.  They include
no PyTorch header, so a build takes seconds.  The library goes
to ``build/kernels/`` at the repository root and is rebuilt whenever the
sha256 of the sources changes (never by file mtimes, which a checkout
does not preserve).  A missing ``nvcc`` or a failed build raises: there
is no fallback.

Every C entry point works on the *current* CUDA device: it reads that
device's limits and launches there, on the stream it is given.  So each
wrapper enters :func:`on` (the tensors' device) around its planning
reads and its launches, and counts a launch with :func:`launched`, which
also keeps the launches per card (``BY_CARD``).

Nothing here runs at import; :func:`load` builds on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCES = ("segscan.cu", "hamming.cu", "em.cu", "pug_cc.cu", "mt19937.cu")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
LIB_NAME = "libaft_kernels.so"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_streams = {}  # device -> side streams (fork)
# (card index, kernel) -> launches since the process started
BY_CARD = {}


class BuildInfo:
    """What the last :func:`build` did: seconds spent in nvcc (0 when the
    cached library matched) and the ptxas report (registers, shared
    memory and spills per kernel)."""

    seconds = 0.0
    ptxas = ""
    rebuilt = False


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built"
    )


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``build/kernels/libaft_kernels.so``
    unless a library built from the same sources is already there."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        BuildInfo.rebuilt = False
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{LIB_NAME}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f".{Path(s).stem}.{os.getpid()}.o" for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    if all(p.returncode == 0 for p in procs):
        cmds.append([nvcc, *GENCODE, "-shared", "-o", str(tmp), *map(str, objs)])
        link = subprocess.run(cmds[-1], capture_output=True, text=True)
        procs.append(link)
        outs.append(link.stdout + link.stderr)
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.ptxas = "".join(outs)
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(c, p.returncode) for c, p in zip(cmds, procs) if p.returncode != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({failed[0][1]}):\n{' '.join(failed[0][0])}\n{BuildInfo.ptxas}"
        )
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    BuildInfo.rebuilt = True
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and bound once."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    P, I64, I32, F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.aft_segscan_scratch_bytes.argtypes = [I64]
    lib.aft_segscan_scratch_bytes.restype = I64
    lib.aft_segscan_tile.argtypes = [I32]
    lib.aft_segscan_fwd.argtypes = [P, P, P, P, I64, P, P]
    lib.aft_segscan_min.argtypes = [P, P, I64, I32, P, P]
    lib.aft_segscan_lex.argtypes = [P, P, I64, I32, I32, P, P]
    lib.aft_hamming1.argtypes = [P, I64, P, I64, I32, P, P, P]
    lib.aft_hamming1_min.argtypes = [P, I64, P, I64, I32, P, P, P]
    lib.aft_hamming1_plan.argtypes = [I64, P]
    lib.aft_smem_limit.argtypes = []
    lib.aft_smem_limit.restype = I64
    lib.aft_em_cells.argtypes = [P, P, P, P, P, P, P, P, P, P, P, P, I32, I32, I32, I32, P, P, I64,
                                 F32, I32, I32, P, P, P, P, I32, I64, I64, I64, I64, P]
    lib.aft_pug_cc.argtypes = [P, P, P, P, P, P, I32, I32, I32, I64, P, P, P, P]
    lib.aft_mt_init.argtypes = [P, P, P, I32, I32, I64, P, P]
    for fn in ("aft_segscan_tile", "aft_segscan_fwd", "aft_segscan_min", "aft_segscan_lex",
               "aft_hamming1", "aft_hamming1_min", "aft_hamming1_plan", "aft_em_cells",
               "aft_pug_cc", "aft_mt_init"):
        getattr(lib, fn).restype = I32
    _lib = lib
    return lib


def launch_groups(need, limit: int) -> list:
    """Cells grouped by launch, for kernels that keep one cell's state in
    dynamic shared memory (K6): (cell indices, dynamic shared bytes)
    per power-of-two bucket of ``need`` bytes, then the cells that need
    more than ``limit`` (shared bytes -1: their state goes to global
    memory), so that a few large cells do not limit how many blocks of
    small ones an SM holds."""
    import numpy as np

    big = need > limit
    bucket = np.where(big, 63, np.ceil(np.log2(np.maximum(need, 1024))).astype(np.int64))
    out = []
    for b in np.unique(bucket):
        cells = np.flatnonzero(bucket == b)
        out.append((cells, -1 if b == 63 else int(need[cells].max())))
    return out


def ranges(cum, n_parts: int) -> list:
    """Cut points (``n_parts + 1``, from 0 to the item count) that split
    items of cumulative weights ``cum`` (``n + 1`` values from 0) into
    contiguous ranges of about equal weight: the cells of a kernel's
    launches split over a mesh's shards."""
    import numpy as np

    cum = np.asarray(cum, np.int64)
    want = cum[-1] * np.arange(1, n_parts) // n_parts
    cuts = np.searchsorted(cum, want, side="left")
    return [0, *np.maximum.accumulate(cuts).tolist(), len(cum) - 1]


def on(device):
    """A context in which ``device`` is the current CUDA device (nothing
    for the CPU): the kernels' entry points read the current device's
    limits and launch on it."""
    import contextlib

    import torch

    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def launched(counts: dict, key: str, device) -> None:
    """Count one launch of kernel ``key`` in its module's ``counts`` and
    in ``BY_CARD`` under the card it ran on."""
    import torch

    counts[key] += 1
    card = (torch.device(device).index or 0, key)
    BY_CARD[card] = BY_CARD.get(card, 0) + 1


def fork(device, n: int) -> list:
    """``n`` side streams of ``device`` (made once and kept), each made
    to wait for the work enqueued so far on its current stream."""
    import torch

    pool = _streams.setdefault(torch.device(device), [])
    while len(pool) < n:
        pool.append(torch.cuda.Stream(device))
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(device))
    for s in pool[:n]:
        s.wait_event(ready)
    return pool[:n]


def join(device, streams: list) -> None:
    """Make ``device``'s current stream wait for the work enqueued on
    ``streams`` (from :func:`fork`)."""
    import torch

    cur = torch.cuda.current_stream(device)
    for s in streams:
        done = torch.cuda.Event()
        done.record(s)
        cur.wait_event(done)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_of(t) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
