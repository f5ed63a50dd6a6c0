"""Diet-pattern machinery.

The reference maps "diet" (sparsified) coordinates back to real sequence
coordinates with ``real = (i / ones) * W + ones_loc[i % ones] + shift``
(GDiet-ShortReads/sketch.c:20-23) and computes the sparsified length per
(len, shift) (sketch.c:1607-1614, 1942-1948).

Here the pattern is a precomputed index map: sparsification of a batch of
sequences is a single gather, one map per (pattern, shift).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=64)
def ones_locations(pattern: str) -> tuple[int, ...]:
    """Positions of '1' characters within the pattern (sketch.c:1600-1605)."""
    return tuple(i for i, c in enumerate(pattern) if c == "1")


def n_ones(pattern: str) -> int:
    return len(ones_locations(pattern))


def diet_length(length: int, pattern: str, shift: int = 0) -> int:
    """Number of kept bases of a length-`length` sequence starting at
    ``shift`` (sketch.c:1942-1948: uses ``len - shift`` full periods plus the
    pattern *prefix* for the remainder)."""
    if length <= shift:
        return 0
    w = len(pattern)
    ones = n_ones(pattern)
    eff = length - shift
    dlen = (eff // w) * ones
    dlen += sum(1 for i in range(eff % w) if pattern[i] == "1")
    return dlen


def real_location(i: int | np.ndarray, pattern: str, shift: int = 0):
    """Diet coordinate -> real coordinate (sketch.c:20-23)."""
    w = len(pattern)
    ones = n_ones(pattern)
    loc = np.asarray(ones_locations(pattern), dtype=np.int64)
    return (np.asarray(i) // ones) * w + loc[np.asarray(i) % ones] + shift


def diet_location(p_real, pattern: str, shift: int = 0):
    """Real coordinate of a KEPT base -> diet coordinate (the closed-form
    inverse of real_location: no searchsorted over a materialized map).
    rank[o] = number of ones strictly before offset o within the pattern."""
    w = len(pattern)
    ones = n_ones(pattern)
    rank = np.zeros(w, np.int64)
    c = 0
    for o, ch in enumerate(pattern):
        rank[o] = c
        if ch == "1":
            c += 1
    p = np.asarray(p_real, dtype=np.int64) - shift
    return (p // w) * ones + rank[p % w]


def diet_codes(codes: np.ndarray, pattern: str, shift: int = 0) -> np.ndarray:
    """The whole sparsified sequence as one array: codes[gather_map(...)]
    computed by periodic reshape instead of a fancy-index gather (and
    without materializing the int64 map — 8 bytes/position, 12 GB at
    GRCh38 scale)."""
    if shift:
        codes = codes[shift:]
    w = len(pattern)
    loc = list(ones_locations(pattern))
    nper = len(codes) // w
    head = codes[: nper * w].reshape(nper, w)[:, loc].reshape(-1)
    rem = codes[nper * w :]
    tail = rem[[o for o in loc if o < len(rem)]]
    return np.concatenate([head, tail]) if len(tail) else head


def gather_map(length: int, pattern: str, shift: int = 0) -> np.ndarray:
    """Index map of shape [diet_length]: kept real positions, ascending.

    ``seq[gather_map(...)]`` is the sparsified sequence the reference scans.
    """
    dlen = diet_length(length, pattern, shift)
    if dlen == 0:
        return np.zeros((0,), dtype=np.int64)
    return real_location(np.arange(dlen, dtype=np.int64), pattern, shift)


def padded_gather_map(max_len: int, pattern: str, shift: int = 0) -> np.ndarray:
    """Like gather_map but for a fixed max_len budget; callers mask positions
    >= per-sequence diet_length. Shape [diet_length(max_len)]."""
    return gather_map(max_len, pattern, shift)
