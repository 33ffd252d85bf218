"""Knee finding over the barcode frequency curve (port of
``alevin_fry_tpu/ops/knee.py``, reference src/knee_finding.rs): the
UMI-tools "distance" method.

Build the cumulative curve of the descending barcode frequencies, take
the point farthest from the line through its first and last points,
then repeat on the window ``[0, 5 * knee)`` until the knee stops
moving or ``max_iterations`` passes.  Host NumPy, as in the reference.
"""

from __future__ import annotations

import numpy as np


def _max_distance_index(cfreq: np.ndarray) -> int:
    """Index of the point of the cumulative curve farthest from the line
    through its first and last points (knee_finding.rs:43-90); on a tie
    the last such index, as the reference's ``d >= max_d`` update
    gives."""
    n = len(cfreq)
    if n < 2:
        raise ValueError(
            "knee-finding requires at least 2 putative cells; check the mapping rate"
        )
    max_y = float(cfreq[-1])
    y0 = float(cfreq[0]) / max_y
    x = np.arange(n, dtype=np.float64) / float(n)
    y = cfreq.astype(np.float64) / max_y
    # the line from (0, y0) to (1, 1)
    numer = np.abs((1.0 - y0) * x - y + y0)
    denom = float(np.hypot(1.0 - y0, 1.0))
    d = numer / denom
    return int((n - 1) - np.argmax(d[::-1]))


def get_knee(freq: np.ndarray, max_iterations: int = 100) -> int:
    """Knee index over a descending frequency vector
    (knee_finding.rs:99-139).  The cumulative sum runs in float64 and is
    cast back to uint64, as the reference's is: another rounding can
    move the knee by one barcode."""
    freq = np.asarray(freq, np.uint64)
    cfreq = np.cumsum(freq.astype(np.float64)).astype(np.uint64)
    max_idx = _max_distance_index(cfreq)
    if max_idx == 0:
        raise ValueError("get_knee determined a knee index of 0")
    prev_max = 0
    iterations = 0
    while max_idx != prev_max:
        prev_max = max_idx
        iterations += 1
        if iterations > max_iterations:
            break
        last_idx = min(len(cfreq) - 1, max_idx * 5)
        max_idx = _max_distance_index(cfreq[:last_idx])
        if max_idx == 0:
            raise ValueError("get_knee determined a knee index of 0")
    return max_idx
