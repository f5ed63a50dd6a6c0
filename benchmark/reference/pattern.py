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


def gather_map(length: int, pattern: str, shift: int = 0) -> np.ndarray:
    """Index map of shape [diet_length]: kept real positions, ascending.

    ``seq[gather_map(...)]`` is the sparsified sequence the reference scans.
    """
    dlen = diet_length(length, pattern, shift)
    if dlen == 0:
        return np.zeros((0,), dtype=np.int64)
    return real_location(np.arange(dlen, dtype=np.int64), pattern, shift)
