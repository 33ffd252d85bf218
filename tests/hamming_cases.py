"""Inputs of the rescue-search tests: query and kept 2-bit barcodes made
from numpy seeds, for the probe twin's cases in
tests/test_torch_hamming.py (K4) and tests/test_torch_hamming_brute.py
(K5)."""

import numpy as np

PROBE_CASES = ["L2", "L10", "L16", "L24", "L32", "duplicates", "bit63", "nk1", "query_is_kept"]


def probe_case(kind):
    """(queries, kept in ascending unsigned order, bases) for the probe
    twin's cases: lengths 2 (queries over the whole code space) to 32,
    duplicated kept codes, kept codes with bit 63 set and queries one
    substitution at the top base away from them, a one-code table, and
    queries that are all kept codes in a table of mutual neighbours."""
    length = {"L2": 2, "L10": 10, "L16": 16, "L24": 24, "L32": 32, "bit63": 32}.get(kind, 16)
    rng = np.random.RandomState(sum(map(ord, kind)))
    full = np.uint64((1 << (2 * length)) - 1) if length < 32 else np.uint64(2**64 - 1)
    draw = lambda k: rng.randint(0, 1 << 63, k, dtype=np.uint64) * np.uint64(3) & full  # noqa: E731
    if kind == "L2":
        # the diagonal of the 4 x 4 code space: 0, 1 and 2 neighbours occur
        return np.arange(16, dtype=np.uint64), np.array([0, 5, 10], np.uint64), 2
    kept = np.unique(draw(1 if kind == "nk1" else 300))
    top = np.uint64(2 * (length - 1))
    if kind == "duplicates":
        kept = np.sort(np.concatenate([kept, kept[rng.randint(0, len(kept), 60)],
                                       np.repeat(kept[7], 9)]))
    elif kind == "bit63":
        kept = np.unique(np.concatenate([kept & np.uint64(2**63 - 1), kept[:60] | np.uint64(1 << 63)]))
    elif kind == "query_is_kept":
        kept = np.unique(np.concatenate([kept, kept[:100] ^ np.uint64(1), kept[:50] ^ np.uint64(8)]))
        return rng.permutation(kept), kept, length
    n = 120
    pos = rng.randint(0, length, n).astype(np.uint64)
    sub = rng.randint(1, 4, n).astype(np.uint64)
    pick = lambda: kept[rng.randint(0, len(kept), n)]  # noqa: E731
    queries = np.concatenate([
        pick(), pick() ^ (sub << (np.uint64(2) * pos)), pick() ^ (sub << top), draw(n),
        np.zeros(1, np.uint64),
    ])
    if kind == "bit63":
        assert ((kept >> np.uint64(63)) == 1).sum() >= 30 and (queries >> np.uint64(63)).any()
    return queries, kept, length
