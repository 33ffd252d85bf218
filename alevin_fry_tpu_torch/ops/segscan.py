"""Segmented reductions over contiguous segments, on kernels K1-K3.

After the WTA's key sort every segment (triplet, (cell, umi) group) is a
contiguous run, so a segmented sum is a forward cumsum plus two
boundary propagations, and a segmented max is a running max over
(segment ordinal, value) pairs broadcast back by a reverse running min.

The three scans are hand-written CUDA kernels (``csrc/segscan.cu``):

* K1 :func:`scan_fwd` — inclusive cumsum ``c`` of int32 ``x`` and the
  running max of ``where(start, c - x, -1)``, replacing
  ``alevin_fry_tpu/ops/pallas_segscan.py::_fwd_fn``;
* K2 :func:`scan_min` — running min of int32 values, forward or from
  the back, replacing ``_min_fn``;
* K3 :func:`scan_lex` — running max or min of int64 words, replacing
  ``_lex_fn``; the (hi, lo) int32 pairs travel packed as
  ``hi << 32 | lo + 2^31``, whose signed order is the pairs'
  lexicographic order.

Each is one launch of a single-pass scan with decoupled look-back.
Every launch takes a fresh scratch buffer, whose counter and status
words the C entry point clears before the kernel runs, and runs on its
tensors' card (``_kernels.on``).

Each kernel has a plain PyTorch twin (``*_twin``) in this module: the
cumulative formulas of ``alevin_fry_tpu/ops/crlike_device.py`` over
int64.  A wrapper takes the twin only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts the
kernel launches per kernel.

:func:`seg_sum`, :func:`seg_reduce` and :func:`last_marked` have the
contracts of their namesakes in ``pallas_segscan.py``.
"""

from __future__ import annotations

import torch

from .. import _kernels

I32_MAX = (1 << 31) - 1
_LO_BIAS = 1 << 31
_LO_MASK = (1 << 32) - 1

LAUNCHES = {"K1": 0, "K2": 0, "K3": 0}


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _launch(key: str, out: torch.Tensor, ins: tuple, fn, *args) -> None:
    """Run scan kernel ``fn(*args, scratch, stream)`` for the
    contiguous CUDA tensors ``ins`` (nothing to do when they are empty)
    and count the launch."""
    for t in ins:
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("segscan kernels take contiguous CUDA tensors")
    lib = _kernels.load()
    n = out.numel()
    if n == 0:
        return
    scratch = torch.empty(
        lib.aft_segscan_scratch_bytes(n), dtype=torch.uint8, device=out.device
    )
    with _kernels.on(out.device):
        _kernels.check(
            getattr(lib, fn)(*args, scratch.data_ptr(), _kernels.stream_of(out)),
            f"{key} {fn}",
        )
    _kernels.launched(LAUNCHES, key, out.device)


# --- K1 ----------------------------------------------------------------------

def scan_fwd_twin(x: torch.Tensor, start: torch.Tensor):
    c = torch.cumsum(x, 0, dtype=torch.int64)
    base = torch.where(start, c - x, torch.full_like(c, -1))
    b = torch.cummax(base, 0).values
    return c.to(torch.int32), b.to(torch.int32)


def scan_fwd(x: torch.Tensor, start: torch.Tensor):
    """K1: (inclusive cumsum of int32 ``x``, running max of
    ``where(start, c - x, -1)``), both int32."""
    if x.dtype != torch.int32 or start.dtype != torch.bool:
        raise TypeError("scan_fwd takes int32 values and a bool start mask")
    if x.dim() != 1 or start.shape != x.shape:
        raise ValueError("scan_fwd takes 1-D values and a start mask of the same length")
    if _on_cpu(x):
        return scan_fwd_twin(x, start)
    c = torch.empty_like(x)
    b = torch.empty_like(x)
    _launch("K1", c, (x, start), "aft_segscan_fwd", x.data_ptr(), start.data_ptr(),
            c.data_ptr(), b.data_ptr(), x.numel())
    return c, b


# --- K2 ----------------------------------------------------------------------

def scan_min_twin(e: torch.Tensor, reverse: bool = False):
    if reverse:
        return torch.flip(torch.cummin(torch.flip(e, (0,)), 0).values, (0,))
    return torch.cummin(e, 0).values


def scan_min(e: torch.Tensor, reverse: bool = False):
    """K2: running min of int32 ``e`` (from the back with ``reverse``)."""
    if e.dtype != torch.int32:
        raise TypeError("scan_min takes int32 values")
    if e.dim() != 1:
        raise ValueError("scan_min takes a 1-D tensor")
    if _on_cpu(e):
        return scan_min_twin(e, reverse)
    out = torch.empty_like(e)
    _launch("K2", out, (e,), "aft_segscan_min", e.data_ptr(), out.data_ptr(),
            e.numel(), int(reverse))
    return out


# --- K3 ----------------------------------------------------------------------

def scan_lex_twin(w: torch.Tensor, bigger: bool, reverse: bool = False):
    op = torch.cummax if bigger else torch.cummin
    if reverse:
        return torch.flip(op(torch.flip(w, (0,)), 0).values, (0,))
    return op(w, 0).values


def scan_lex(w: torch.Tensor, bigger: bool, reverse: bool = False):
    """K3: running max (``bigger``) or min of int64 words ``w``, from
    the back with ``reverse``."""
    if w.dtype != torch.int64:
        raise TypeError("scan_lex takes int64 words")
    if w.dim() != 1:
        raise ValueError("scan_lex takes a 1-D tensor")
    if _on_cpu(w):
        return scan_lex_twin(w, bigger, reverse)
    out = torch.empty_like(w)
    _launch("K3", out, (w,), "aft_segscan_lex", w.data_ptr(), out.data_ptr(),
            w.numel(), int(bigger), int(reverse))
    return out


def pack_pair(h: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """(hi, lo) int32 pairs -> int64 words ordered lexicographically."""
    return (h.to(torch.int64) << 32) | (l.to(torch.int64) + _LO_BIAS)


def unpack_pair(w: torch.Tensor):
    return (
        (w >> 32).to(torch.int32),
        ((w & _LO_MASK) - _LO_BIAS).to(torch.int32),
    )


def _run_lex(h, l, bigger, reverse=False):
    """Running lexicographic max / min of (hi, lo) int32 pairs."""
    return unpack_pair(scan_lex(pack_pair(h, l), bigger, reverse))


# --- the segment toolkit -----------------------------------------------------

def _seg_ends(start: torch.Tensor) -> torch.Tensor:
    """Bool mask of each contiguous segment's last row."""
    return torch.cat([start[1:], torch.ones(1, dtype=torch.bool, device=start.device)])


def seg_sum(x, start, with_rank=False):
    """Per-row segment totals of non-negative int32 ``x`` over the
    contiguous segments ``start`` delimits (and, with ``with_rank``, the
    inclusive running sum within the row's segment)."""
    c, b = scan_fwd(x.to(torch.int32), start)
    e = torch.where(_seg_ends(start), c, torch.full_like(c, I32_MAX))
    tot = scan_min(e, reverse=True)
    if with_rank:
        return tot - b, c - b
    return tot - b


def _marked_pairs(val, mark, grp_ord):
    h = torch.where(mark, grp_ord, torch.full_like(grp_ord, -1))
    l = torch.where(mark, val.to(torch.int32), torch.zeros_like(grp_ord))
    return h, l


def last_marked(val, mark, grp_ord, strict=False):
    """Running max of int32 ``val`` over marked rows of the row's
    segment (strictly before the row with ``strict``); -1 when none."""
    rh, rl = _run_lex(*_marked_pairs(val, mark, grp_ord), True)
    if strict:
        rh = torch.cat([rh.new_full((1,), -1), rh[:-1]])
        rl = torch.cat([rl.new_zeros(1), rl[:-1]])
    return torch.where(rh == grp_ord, rl, torch.full_like(rl, -1))


def seg_reduce(val, mark, start, grp_ord):
    """Per-row max of int32 ``val`` >= 0 over marked rows of the row's
    segment; -1 where the segment has no marked row."""
    rh, rl = _run_lex(*_marked_pairs(val, mark, grp_ord), True)
    ends = _seg_ends(start)
    eh = torch.where(ends, rh, torch.full_like(rh, I32_MAX))
    el = torch.where(ends, rl, torch.zeros_like(rl))
    bh, bl = _run_lex(eh, el, False, reverse=True)
    return torch.where(bh == grp_ord, bl, torch.full_like(bl, -1))
