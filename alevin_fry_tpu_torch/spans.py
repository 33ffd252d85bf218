"""Spans: one tree of timed phases a CLI stage, recorded where the work
happens, always on.

A span is ``(name, layer, start_ns, end_ns, parent, thread, attrs)``,
stamped with ``time.perf_counter_ns()``.  The CLI opens one ``stage``
span, the root, around each subcommand; inside it each phase of the
stage opens a span of its own (``decode``, ``histogram``, ``list_parse``,
``rescue``, ``write``, ...).  The parent of a span is the innermost span
open on its thread, or the one given explicitly: the prefetch producer
(``radz/prefetch.py``) gives the consumer's root, since its reads run
beside every phase of the main thread.

``layer`` is one of ``LAYERS``: ``stage`` (a root), ``codec`` (decoding,
reading and parsing input, encoding and writing output), ``resolution``
(the host and device work between them) and ``wait`` (the main thread
blocked on the prefetch queue).  ``add(key, n)`` adds a count to the
innermost open span of the calling thread; when a span closes its
counts are added to its parent's, so a root holds its stage's totals
(``records``, ``bytes_read``, ``bytes_written``).

Spans are coarse, one a phase or a block of millions of records, so a
stage records tens to hundreds.  Closed spans are kept in ``SPANS``, in
the order they closed, up to ``CAP``; past it they are counted in
``dropped`` and not kept.  ``summary(root)`` is the stage's log line;
readers of the whole tree (the benchmark's ``fry_bench/spans.py``) read
``SPANS`` in the same process."""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

LAYERS = ("stage", "codec", "resolution", "wait")
# the most spans kept in SPANS
CAP = 1 << 20


class Span:
    """One timed phase; ``child_ns`` is the time its children on its own
    thread took, so ``self_ns`` is its own."""

    __slots__ = ("name", "layer", "start_ns", "end_ns", "parent", "thread", "attrs",
                 "child_ns")

    def __init__(self, name: str, layer: str, parent: Optional["Span"], thread: int):
        self.name, self.layer, self.parent, self.thread = name, layer, parent, thread
        self.start_ns = self.end_ns = self.child_ns = 0
        self.attrs: Dict[str, int] = {}

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def self_ns(self) -> int:
        return self.end_ns - self.start_ns - self.child_ns

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.layer!r}, {self.seconds:.6f} s, "
                f"parent={self.parent.name if self.parent else None!r}, {self.attrs})")


SPANS: List[Span] = []
dropped = 0
_lock = threading.Lock()
_local = threading.local()


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current() -> Optional[Span]:
    """The innermost span open on this thread."""
    stack = _stack()
    return stack[-1] if stack else None


def root() -> Optional[Span]:
    """The outermost span open on this thread: the stage's root."""
    stack = _stack()
    return stack[0] if stack else None


@contextmanager
def span(name: str, layer: str, parent: Optional[Span] = None) -> Iterator[Span]:
    """Time the enclosed block as a span; ``parent`` defaults to the
    innermost span open on this thread."""
    if layer not in LAYERS:
        raise ValueError(f"unknown span layer {layer!r}")
    stack = _stack()
    sp = Span(name, layer, parent if parent is not None else (stack[-1] if stack else None),
              threading.get_ident())
    stack.append(sp)
    sp.start_ns = time.perf_counter_ns()
    try:
        yield sp
    finally:
        sp.end_ns = time.perf_counter_ns()
        stack.pop()
        _close(sp)


def _close(sp: Span) -> None:
    global dropped
    p = sp.parent
    with _lock:
        if p is not None:
            if p.thread == sp.thread:
                p.child_ns += sp.end_ns - sp.start_ns
            for k, v in sp.attrs.items():
                p.attrs[k] = p.attrs.get(k, 0) + v
        if len(SPANS) < CAP:
            SPANS.append(sp)
        else:
            dropped += 1


def add(key: str, n: int) -> None:
    """Add ``n`` to the count ``key`` of the innermost span open on this
    thread (none open: nothing is counted)."""
    sp = current()
    if sp is not None:
        with _lock:
            sp.attrs[key] = sp.attrs.get(key, 0) + int(n)


def wrote(*paths) -> None:
    """Count the sizes of the files ``paths``, once written, as
    ``bytes_written``."""
    add("bytes_written", sum(os.path.getsize(p) for p in paths))


def self_seconds(root_span: Span) -> Dict[str, float]:
    """Self seconds by span name of the spans of ``root_span``'s thread
    that closed inside it (its tree on that thread), the root's own
    under ``unspanned``."""
    out: Dict[str, float] = {}
    for sp in reversed(SPANS):
        if sp.end_ns < root_span.start_ns:
            break
        if (sp.thread == root_span.thread and sp.start_ns >= root_span.start_ns
                and sp.end_ns <= root_span.end_ns):
            name = "unspanned" if sp is root_span else sp.name
            out[name] = out.get(name, 0.0) + sp.self_ns / 1e9
    return out


def summary(root_span: Span) -> str:
    """The stage's line: records and seconds, each phase's self seconds
    on the main thread (largest first), the root's own, and the bytes
    read and written."""
    selfs = self_seconds(root_span)
    own = selfs.pop("unspanned", 0.0)
    phases = ", ".join(f"{n} {s:.2f}" for n, s in sorted(selfs.items(), key=lambda kv: -kv[1]))
    a = root_span.attrs
    return (f"{root_span.name}: {a.get('records', 0):,} records in {root_span.seconds:.2f} s; "
            f"{phases + ', ' if phases else ''}unspanned {own:.2f} s; "
            f"read {a.get('bytes_read', 0) / 1e6:.1f} MB, "
            f"wrote {a.get('bytes_written', 0) / 1e6:.1f} MB")
