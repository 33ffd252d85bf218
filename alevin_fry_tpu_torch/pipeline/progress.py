"""Throttled progress reporting.

The reference surrounds every stage with an indicatif progress bar
throttled to 5 Hz (cellfilter.rs:1629-1640, collate.rs:630-643,
quant.rs:1500-1511).  Here :class:`Progress` emits in-place
``\\r``-style updates to stderr at most every 0.2 s, only when stderr
is a TTY or ``AFT_PROGRESS=1`` (``AFT_PROGRESS=0`` disables entirely —
benches and tests stay clean).  The stage's time is its spans'
(``spans.py``), which the CLI logs when the stage ends.
"""

from __future__ import annotations

import os
import sys
import time


def _progress_enabled() -> bool:
    env = os.environ.get("AFT_PROGRESS")
    if env is not None:
        return env not in ("0", "false", "off")
    return sys.stderr.isatty()


class Progress:
    """Throttled (5 Hz) in-place progress line on stderr; as a context
    manager, cleared at exit."""

    def __init__(self, label: str, unit: str = "records"):
        self.label = label
        self.unit = unit
        self.count = 0
        self.t0 = time.perf_counter()
        self._last = 0.0
        self._enabled = _progress_enabled()
        self._wrote = False

    def update(self, n: int) -> None:
        self.count += int(n)
        if not self._enabled:
            return
        now = time.perf_counter()
        if now - self._last < 0.2:
            return
        self._last = now
        rate = self.count / max(now - self.t0, 1e-9)
        sys.stderr.write(
            f"\r{self.label}: {self.count:,} {self.unit} "
            f"({rate:,.0f}/s)\x1b[K"
        )
        sys.stderr.flush()
        self._wrote = True

    def finish(self) -> None:
        if self._wrote:
            sys.stderr.write("\r\x1b[K")
            sys.stderr.flush()

    def __enter__(self) -> "Progress":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()
