"""Producer/consumer block prefetching.

The reference overlaps input with compute via a reader thread feeding
worker threads through a bounded crossbeam queue
(src/collate.rs:646-763, src/quant.rs:1527-1743).  Here the analogous
boundary is the block iterator (`iter_decoded_blocks`): decode of
block k+1 (file read + native record walk + NumPy column extraction,
all of which release the GIL) runs in a producer thread while the
consumer resolves/collates block k, double-buffered through a bounded
queue.

``AFT_PREFETCH`` env knob: ``0`` disables (synchronous iteration),
any positive integer sets the queue depth (default 2).

Each block's read is a ``read`` span (``spans.py``), on the producer
thread with the consumer's root span as its parent, or on the
consumer's thread when synchronous; the consumer's time blocked on the
queue is a ``wait`` span.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterable, Iterator, TypeVar

from .. import spans

T = TypeVar("T")

_SENTINEL = object()


def prefetch_depth() -> int:
    try:
        return int(os.environ.get("AFT_PREFETCH", "2"))
    except ValueError:
        return 2


def read_spans(it: Iterable[T], parent=None) -> Iterator[T]:
    """``it``'s items, each fetched inside a ``read`` span."""
    it = iter(it)
    while True:
        with spans.span("read", "codec", parent):
            item = next(it, _SENTINEL)
        if item is _SENTINEL:
            return
        yield item


def prefetched(it: Iterable[T], depth: int | None = None) -> Iterator[T]:
    """Run ``it`` in a producer thread, yielding items through a
    bounded queue.  Exceptions in the producer propagate to the
    consumer at the point of failure; with depth <= 0 the iterable is
    returned unchanged (synchronous)."""
    if depth is None:
        depth = prefetch_depth()
    if depth <= 0:
        yield from read_spans(it)
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: list[BaseException] = []
    stop = threading.Event()
    parent = spans.root()

    def run() -> None:
        try:
            for item in read_spans(it, parent):
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # propagate to the consumer
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=run, name="aft-prefetch", daemon=True)
    t.start()
    try:
        while True:
            with spans.span("wait", "wait"):
                item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        # the producer's last read span closes (and counts) inside the stage
        t.join()
