"""Vectorised text rows: integers in decimal, names from a table, fixed
width byte fields and literals, one row a record, as bytes."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def ndigits(v: np.ndarray) -> np.ndarray:
    """Decimal digits of non-negative integers."""
    v = np.asarray(v, np.int64)
    nd = np.ones(len(v), np.int64)
    p = 10
    top = int(v.max()) if len(v) else 0
    while p <= top:
        nd += v >= p
        p *= 10
    return nd


def table(names: Sequence[str]):
    """Names as a padded byte matrix and their lengths, for ``("pick",
    table, index)`` fields."""
    enc = [n.encode() for n in names]
    width = max((len(e) for e in enc), default=0)
    mat = np.zeros((len(enc), max(width, 1)), np.uint8)
    for i, e in enumerate(enc):
        mat[i, :len(e)] = np.frombuffer(e, np.uint8)
    return mat, np.asarray([len(e) for e in enc], np.int64)


def rows(n: int, fields: List[tuple]) -> np.ndarray:
    """``n`` rows, each the concatenation of ``fields``: ``("int", v)``,
    ``("lit", b"...")``, ``("pick", table(...), idx)`` or ``("fixed",
    (n, w) uint8)``.  Returns the bytes as uint8."""
    lens = []
    for f in fields:
        if f[0] == "int":
            lens.append(ndigits(f[1]))
        elif f[0] == "lit":
            lens.append(np.full(n, len(f[1]), np.int64))
        elif f[0] == "pick":
            lens.append(f[1][1][f[2]])
        else:
            lens.append(np.full(n, f[1].shape[1], np.int64))
    total = np.zeros(n, np.int64)
    for ln in lens:
        total += ln
    start = np.zeros(n + 1, np.int64)
    np.cumsum(total, out=start[1:])
    buf = np.empty(int(start[-1]), np.uint8)
    pos = start[:-1].copy()
    for f, ln in zip(fields, lens):
        if f[0] == "int":
            v = np.asarray(f[1], np.int64)
            for d in range(int(ln.max()) if n else 0):
                m = ln > d
                buf[pos[m] + ln[m] - 1 - d] = 48 + (v[m] // 10 ** d) % 10
        elif f[0] == "lit":
            for k, b in enumerate(f[1]):
                buf[pos + k] = b
        elif f[0] == "pick":
            (mat, _), idx = f[1], f[2]
            for k in range(mat.shape[1]):
                m = ln > k
                buf[pos[m] + k] = mat[idx[m], k]
        else:
            buf[pos[:, None] + np.arange(f[1].shape[1])] = f[1]
        pos += ln
    return buf
