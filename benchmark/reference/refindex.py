"""The reference's minimizer index, worked out again from the genome in
plain NumPy.

``sketch_sequence`` computes mm_sketch's output for one sequence with whole
array operations instead of the scalar ring-buffer scan (``sketch.py``
beside it, which the CPU tests hold it to): over the pattern-sparsified
("diet") sequence, every k-mer that is the minimum of some window of ``w``
consecutive k-mers inside one N-free run, ties included. The one edge the
scan adds: a run that ends the sequence with exactly one full window does
not write that window's minimum (mm_sketch flushes the last window only
when ``l > w + k - 1``).

``RefIndex`` holds the sorted (key, position) pairs in the CSR layout of
the program's index and answers what the scalar oracle asks of an index
(``get``, ``getseq``, ``cal_max_occ``). ``key_bits`` keeps only the low
bits of every key: the control builds its index with 32.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from benchmark.reference import pattern as pat

U64 = np.uint64
INF = np.uint64(0xFFFFFFFFFFFFFFFF)


def hash64(key: np.ndarray, mask: np.uint64) -> np.ndarray:
    """sketch.c:25-34 over a uint64 array (wraps as the C does)."""
    key = (~key + (key << U64(21))) & mask
    key = key ^ (key >> U64(24))
    key = (key + (key << U64(3)) + (key << U64(8))) & mask
    key = key ^ (key >> U64(14))
    key = (key + (key << U64(2)) + (key << U64(4))) & mask
    key = key ^ (key >> U64(28))
    key = (key + (key << U64(31))) & mask
    return key


def _shift(a: np.ndarray, s: int, fill) -> np.ndarray:
    """a[i - s], ``fill`` where i < s."""
    if s == 0:
        return a
    out = np.empty_like(a)
    out[:s] = fill
    out[s:] = a[:-s]
    return out


def _kmers(d: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward and reverse-complement 2k-bit k-mers ending at each index
    (garbage where fewer than k bases precede), by doubling."""
    f = {1: (d & 3).astype(U64)}
    r = {1: (3 - (d & 3)).astype(U64)}
    m = 1
    while 2 * m <= k:
        f[2 * m] = (_shift(f[m], m, 0) << U64(2 * m)) | f[m]
        r[2 * m] = _shift(r[m], m, 0) | (r[m] << U64(2 * m))
        m *= 2
    fw = np.zeros(len(d), U64)
    rv = np.zeros(len(d), U64)
    done = 0
    for p in sorted(f, reverse=True):
        if done + p > k:
            continue
        rem = k - done - p
        fw = (fw << U64(2 * p)) | _shift(f[p], rem, 0)
        rv = rv | (_shift(r[p], rem, 0) << U64(2 * done))
        done += p
    return fw, rv


def _sliding(a: np.ndarray, w: int, op, fill, forward: bool) -> np.ndarray:
    """op over a[i-w+1 .. i] (backward) or a[i .. i+w-1] (forward)."""
    sh = (lambda x, s: _shift(x[::-1], s, fill)[::-1]) if forward else (
        lambda x, s: _shift(x, s, fill))
    acc = {1: a}
    m = 1
    while 2 * m <= w:
        acc[2 * m] = op(acc[m], sh(acc[m], m))
        m *= 2
    return op(acc[m], sh(acc[m], w - m))


def sketch_sequence(codes: np.ndarray, w: int, k: int, rid: int,
                    pattern: str) -> tuple[np.ndarray, np.ndarray]:
    """(keys = x >> 8, ys) of mm_sketch over one sequence, in position
    order."""
    gather = pat.gather_map(len(codes), pattern, 0)
    n = len(gather)
    if n == 0:
        return np.zeros(0, U64), np.zeros(0, U64)
    d = np.asarray(codes, np.uint8)[gather]
    valid = d < 4
    idx = np.arange(n, dtype=np.int64)
    last_bad = np.maximum.accumulate(np.where(valid, -1, idx))
    run = np.where(valid, idx - last_bad, 0)  # the scan's l after base i
    mask = U64((1 << (2 * k)) - 1)
    fw, rv = _kmers(d, k)
    fw &= mask
    rv &= mask
    has = (run >= k) & (fw != rv)
    z = (rv < fw).astype(U64)
    x = np.where(has, (hash64(np.minimum(fw, rv), mask) << U64(8)) | U64(k), INF)
    win_ok = run >= w + k - 1
    wmin = _sliding(x, w, np.minimum, INF, forward=False)
    wmin = np.where(win_ok, wmin, U64(0))
    reach = _sliding(wmin, w, np.maximum, U64(0), forward=True)
    emit = has & (reach == x)
    if run[-1] == w + k - 1:  # the last window alone: its minimum unwritten
        lo = n - w
        seg = x[lo:]
        j = lo + int(np.flatnonzero(seg == seg.min())[-1])
        emit[j] = False
    sel = np.flatnonzero(emit)
    ys = (U64(rid) << U64(32)) | ((gather[sel].astype(U64) << U64(1)) & U64(0xFFFFFFFF)) | z[sel]
    return x[sel] >> U64(8), ys


class RefIndex:
    """Sorted (key, position) pairs of a genome, CSR like the program's."""

    def __init__(self, seqs, w: int, k: int, pattern: str, key_bits: int = 64,
                 workers: int = 1):
        self.w, self.k, self.pattern = w, k, pattern
        self.names = [n for n, _ in seqs]
        self.seqs = [np.asarray(c, np.uint8) for _, c in seqs]
        self.lengths = [len(c) for c in self.seqs]
        args = [(c, w, k, rid, pattern) for rid, c in enumerate(self.seqs)]
        if workers > 1 and len(args) > 1:  # one process a job, the longest first
            order = sorted(range(len(args)), key=lambda i: -len(args[i][0]))
            with ProcessPoolExecutor(min(workers, len(args)),
                                     mp_context=multiprocessing.get_context("spawn")) as ex:
                done = dict(zip(order, ex.map(sketch_sequence,
                                              *zip(*(args[i] for i in order)))))
            parts = [done[i] for i in range(len(args))]
        else:
            parts = [sketch_sequence(*a) for a in args]
        ks, ys = zip(*parts)
        keys = np.concatenate(ks)
        if key_bits < 64:
            keys = keys & U64((1 << key_bits) - 1)
        ys = np.concatenate(ys)
        # ys rise along the concatenation, so (key, y) order is key order
        # with ties kept in place: one sort of (key, index) where it fits
        # in 64 bits
        ib = max(1, (len(keys) - 1).bit_length())
        if min(2 * k, key_bits) + ib <= 64:
            packed = (keys << U64(ib)) | np.arange(len(keys), dtype=U64)
            packed.sort()
            order = (packed & U64((1 << ib) - 1)).astype(np.int64)
        else:
            order = np.lexsort((ys, keys))
        keys, self.positions = keys[order], ys[order]
        if len(keys):
            first = np.concatenate([[True], keys[1:] != keys[:-1]])
            start_idx = np.flatnonzero(first)
        else:
            start_idx = np.zeros(0, np.int64)
        self.keys = keys[start_idx]
        self.starts = np.concatenate([start_idx, [len(keys)]]).astype(np.int64)

    def get(self, minier: int) -> np.ndarray:
        i = int(np.searchsorted(self.keys, U64(minier)))
        if i < len(self.keys) and self.keys[i] == U64(minier):
            return self.positions[self.starts[i]: self.starts[i + 1]]
        return np.zeros(0, U64)

    def getseq(self, rid: int, st: int, en: int, rev: bool = False) -> np.ndarray:
        s = self.seqs[rid]
        en = min(en, len(s))
        if not rev:
            return s[st:en].copy()
        frag = s[len(s) - en: len(s) - st][::-1]
        return np.where(frag < 4, 3 - frag, frag).astype(np.uint8)

    def cal_max_occ(self, f: float) -> int:
        if f <= 0.0 or len(self.keys) == 0:
            return 2**31 - 1
        counts = (self.starts[1:] - self.starts[:-1]).astype(np.uint32)
        i = min(int((1.0 - f) * len(counts)), len(counts) - 1)
        return int(np.partition(counts, i)[i]) + 1

    def mid_occ(self, mo) -> int:
        """mm_mapopt_update (options.c:64-76)."""
        if mo.mid_occ > 0:
            return mo.mid_occ
        mid = max(self.cal_max_occ(mo.mid_occ_frac), mo.min_mid_occ)
        if mo.max_mid_occ > mo.min_mid_occ:
            mid = min(mid, mo.max_mid_occ)
        return mid


def entry_diff(a_keys, a_starts, a_pos, b_keys, b_starts, b_pos) -> int:
    """Number of (key, position) pairs in one index and not the other."""
    a_keys, b_keys = np.asarray(a_keys, U64), np.asarray(b_keys, U64)
    a_pos, b_pos = np.asarray(a_pos, U64), np.asarray(b_pos, U64)
    if (np.array_equal(a_keys, b_keys) and np.array_equal(a_starts, b_starts)
            and np.array_equal(a_pos, b_pos)):
        return 0

    def pairs(keys, starts, pos):
        full = np.repeat(keys, np.diff(np.asarray(starts, np.int64)))
        return np.stack([full, pos], 1).view([("k", U64), ("p", U64)]).ravel()

    a, b = pairs(a_keys, a_starts, a_pos), pairs(b_keys, b_starts, b_pos)
    common = len(np.intersect1d(a, b))
    return int(len(a) + len(b) - 2 * common)
