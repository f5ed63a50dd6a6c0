"""Scalar oracle of the three GDiet sketching entry points.

Semantics re-derived from GDiet-ShortReads/sketch.c:
  - ``sketch_index``  <-> mm_sketch      (sketch.c:1577-1767): reference side.
  - ``sketch_shifts`` <-> mm_sketch2     (sketch.c:2143-2225): per-shift probe
    seeds for pattern-offset inference, via mm_sketch2_sub (1769-1906).
  - ``sketch_query``  <-> mm_sketch3     (sketch.c:1908-2139): full query
    sketch at a chosen shift, capped at MAX_NB_SEEDS.

All three share one windowed-min scan over the pattern-sparsified sequence;
they differ only in caps and in the final-flush condition (mm_sketch flushes
the trailing window only when l > w+k-1, the query variants when >=).

Seeds are (x, y) with x = hash64(min(kmer_fwd, kmer_rev)) << 8 | k and
y = rid << 32 | real_location << 1 | strand, exactly as the reference packs
them. Python ints stand in for uint64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

U64 = (1 << 64) - 1
U32 = (1 << 32) - 1

# seq_nt4_table semantics (sketch.c:11-18): A/a->0 C/c->1 G/g->2 T/t->3 else 4
_NT4 = np.full(256, 4, dtype=np.uint8)
for _c, _v in zip("ACGTacgt", [0, 1, 2, 3, 0, 1, 2, 3]):
    _NT4[ord(_c)] = _v


def seq_to_code(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> 2-bit codes with 4 for ambiguous bases."""
    buf = np.frombuffer(seq.encode() if isinstance(seq, str) else bytes(seq), dtype=np.uint8)
    return _NT4[buf]


def hash64(key: int, mask: int) -> int:
    """Invertible 64-bit mix hash (sketch.c:25-34)."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


@dataclass
class _ScanParams:
    w: int
    k: int
    rid: int
    pattern: str
    shift: int


def _windowed_min_scan(
    codes: np.ndarray,
    gather: np.ndarray,
    p: _ScanParams,
    out: list[tuple[int, int]],
    *,
    final_flush_ge: bool,
    cap_count: int | None = None,
    cap_total: int | None = None,
):
    """The shared ring-buffer windowed-min scan (sketch.c:1640-1766 and the
    query variants). Appends (x, y) seeds to ``out``.

    Returns (capped, n_pushed_this_call, last_pushed_y).
    ``cap_count`` caps pushes made by this call (mm_sketch2_sub semantics);
    ``cap_total`` caps len(out) (mm_sketch3 semantics).
    """
    w, k = p.w, p.k
    assert 0 < w < 256 and 0 < k <= 28
    shift1 = 2 * (k - 1)
    mask = (1 << (2 * k)) - 1
    INF = U64
    buf = [(INF, INF)] * w
    minimum = (INF, INF)
    min_pos = 0
    buf_pos = 0
    kmer_f = kmer_r = 0
    l = 0
    pushed = 0
    last_y = 0

    def push(item: tuple[int, int]):
        nonlocal pushed, last_y
        out.append(item)
        pushed += 1
        last_y = item[1]

    def capped() -> bool:
        if cap_count is not None and pushed == cap_count:
            return True
        if cap_total is not None and len(out) == cap_total:
            return True
        return False

    diet_len = len(gather)
    for i in range(diet_len):
        real_loc = int(gather[i])
        c = int(codes[real_loc])
        info = (INF, INF)
        if c < 4:
            kmer_span = l + 1 if l + 1 < k else k
            kmer_f = ((kmer_f << 2) | c) & mask
            kmer_r = (kmer_r >> 2) | ((3 ^ c) << shift1)
            l += 1
            if kmer_f != kmer_r:  # skip symmetric k-mers (strand unknown)
                z = 0 if kmer_f < kmer_r else 1
                if l >= k and kmer_span < 256:
                    x = (hash64(kmer_f if z == 0 else kmer_r, mask) << 8) | kmer_span
                    # the reference casts real_location to uint32 before <<1,
                    # truncating at 2^31; positions beyond that are unsupported
                    y = (p.rid << 32) | (((real_loc << 1) & U32) | z)
                    info = (x, y)
        else:
            if l >= w + k - 1 and minimum[0] != INF:
                push(minimum)
                if capped():
                    return True, pushed, last_y
            l = 0
        buf[buf_pos] = info

        if info[0] <= minimum[0]:  # new minimum; write the old min
            if l >= w + k and minimum[0] != INF:
                push(minimum)
                if capped():
                    return True, pushed, last_y
            minimum, min_pos = info, buf_pos
        elif buf_pos == min_pos:  # old min moved outside the window
            if l >= w + k - 1 and minimum[0] != INF:
                push(minimum)
                if capped():
                    return True, pushed, last_y
            minimum = (INF, minimum[1])
            for j in range(buf_pos + 1, w):
                if minimum[0] >= buf[j][0]:
                    minimum, min_pos = buf[j], j
            for j in range(0, buf_pos + 1):
                if minimum[0] >= buf[j][0]:
                    minimum, min_pos = buf[j], j
            if l >= w + k - 1 and minimum[0] != INF:  # write identical k-mers
                for j in range(buf_pos + 1, w):
                    if minimum[0] == buf[j][0] and minimum[1] != buf[j][1]:
                        push(buf[j])
                        if capped():
                            return True, pushed, last_y
                for j in range(0, buf_pos + 1):
                    if minimum[0] == buf[j][0] and minimum[1] != buf[j][1]:
                        push(buf[j])
                        if capped():
                            return True, pushed, last_y

        if l == w + k - 1 and minimum[0] != INF:
            # first full window: identical k-mers not stored yet
            for j in range(buf_pos + 1, w):
                if minimum[0] == buf[j][0] and buf[j][1] != minimum[1]:
                    push(buf[j])
                    if capped():
                        return True, pushed, last_y
            for j in range(0, buf_pos):
                if minimum[0] == buf[j][0] and buf[j][1] != minimum[1]:
                    push(buf[j])
                    if capped():
                        return True, pushed, last_y
        buf_pos = 0 if buf_pos == w - 1 else buf_pos + 1

    final_ok = (l >= w + k - 1) if final_flush_ge else (l > w + k - 1)
    if final_ok and minimum[0] != INF:
        push(minimum)
        if capped():
            return True, pushed, last_y
    return False, pushed, last_y


def _gather_for(length: int, pattern: str, shift: int) -> np.ndarray:
    from benchmark.reference import pattern as pat

    if shift >= length:
        return np.zeros((0,), dtype=np.int64)
    return pat.gather_map(length, pattern, shift)


def sketch_index(codes: np.ndarray, w: int, k: int, rid: int, pattern: str) -> list[tuple[int, int]]:
    """mm_sketch (sketch.c:1577-1767): reference-side sketch, shift 0."""
    out: list[tuple[int, int]] = []
    gather = _gather_for(len(codes), pattern, 0)
    if len(gather) == 0:
        return out
    _windowed_min_scan(
        codes, gather, _ScanParams(w, k, rid, pattern, 0), out, final_flush_ge=False
    )
    return out


def sketch_shifts(
    codes: np.ndarray, w: int, k: int, pattern: str, max_seeds: float,
) -> tuple[list[tuple[int, int]], list[int]]:
    """mm_sketch2 (sketch.c:2143-2225): probe seeds for every pattern shift.

    Returns (seeds, per-shift seed counts). If max_seeds < 1 the shift-0 scan
    covers only a ``max_seeds`` fraction of the read and its seed count
    becomes the cap for the remaining shifts (which scan the full read).
    """
    length = len(codes)
    W = len(pattern)
    out: list[tuple[int, int]] = []
    counts: list[int] = []
    if max_seeds < 1:
        len_crop = int(max_seeds * length)
        cap = None
    else:
        len_crop = length
        cap = int(max_seeds)
    for shift in range(W):
        gather = _gather_for(len_crop, pattern, shift)
        _, pushed, _ = _windowed_min_scan(
            codes,
            gather,
            _ScanParams(w, k, 0, pattern, shift),
            out,
            final_flush_ge=True,
            cap_count=cap,
        )
        counts.append(pushed)
        if cap is None:  # first shift sets the cap (sketch.c:2219-2222)
            len_crop = length
            cap = pushed
    return out, counts


def sketch_query(
    codes: np.ndarray, w: int, k: int, pattern: str, shift: int, max_nb_seeds: int
) -> tuple[list[tuple[int, int]], int]:
    """mm_sketch3 (sketch.c:1908-2139): full query sketch at ``shift``.

    Returns (seeds, extracted_len) where extracted_len is the real query
    position of the last emitted seed if the cap was hit, else the read
    length (sketch.c:2010-2012, 2138).
    """
    length = len(codes)
    shift = max(shift, 0)
    out: list[tuple[int, int]] = []
    gather = _gather_for(length, pattern, shift)
    if len(gather) == 0:
        return out, length
    capped, _, last_y = _windowed_min_scan(
        codes,
        gather,
        _ScanParams(w, k, 0, pattern, shift),
        out,
        final_flush_ge=True,
        cap_total=max_nb_seeds if max_nb_seeds > 0 else None,
    )
    if capped:
        return out, (last_y >> 1) & U32
    return out, length
