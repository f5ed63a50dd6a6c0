"""SDUST low-complexity masking (host side).

Faithful re-implementation of the reference's symmetric-DUST
(GDiet-ShortReads/sdust.c:66-176) and the minimizer filter hook
(mm_dust_minier, map.c:45-70). Off by default (sdust_thres = 0,
options.c:19); when enabled, query minimizers that overlap low-complexity
regions by more than half their span are dropped before seeding.
"""

from __future__ import annotations

SD_WLEN = 3
SD_WTOT = 1 << (SD_WLEN << 1)
SD_WMSK = SD_WTOT - 1

_NT4 = {c: i for i, c in enumerate("ACGT")}


def _nt4(ch: str) -> int:
    return _NT4.get(ch.upper(), 4)


def sdust_core(seq, T: int, W: int) -> list[tuple[int, int]]:
    """Returns masked intervals [(start, end), ...] (sdust_core).

    ``seq`` is a str or an iterable of nt4 codes.
    """
    codes = [(_nt4(c) if isinstance(c, str) else int(c)) for c in seq]
    l_seq = len(codes)
    res: list[list[int]] = []
    P: list[list[int]] = []  # [start, finish, r, l], desc start / asc finish
    w: list[int] = []  # word deque
    cv = [0] * SD_WTOT
    cw = [0] * SD_WTOT
    rv = rw = L = 0

    def save_masked_regions(start: int):
        nonlocal P
        if not P or P[-1][0] >= start:
            return
        p = P[-1]
        saved = False
        if res:
            s, f = res[-1]
            if p[0] <= f:
                saved = True
                res[-1][1] = max(f, p[1])
        if not saved:
            res.append([p[0], p[1]])
        i = len(P) - 1
        while i >= 0 and P[i][0] < start:
            i -= 1
        del P[i + 1 :]

    def shift_window(t: int):
        nonlocal rw, rv, L
        if len(w) >= W - SD_WLEN + 1:
            s = w.pop(0)
            cw[s] -= 1
            rw -= cw[s]
            if L > len(w):
                L -= 1
                cv[s] -= 1
                rv -= cv[s]
        w.append(t)
        L += 1
        rw += cw[t]
        cw[t] += 1
        rv += cv[t]
        cv[t] += 1
        if cv[t] * 10 > T << 1:
            while True:
                s = w[len(w) - L]
                cv[s] -= 1
                rv -= cv[s]
                L -= 1
                if s == t:
                    break

    def find_perfect(start: int):
        c = cv.copy()
        r = rv
        max_r = max_l = 0
        for i in range(len(w) - L - 1, -1, -1):
            t = w[i]
            r += c[t]
            c[t] += 1
            new_r, new_l = r, len(w) - i - 1
            if new_r * 10 > T * new_l:
                j = 0
                while j < len(P) and P[j][0] >= i + start:
                    p = P[j]
                    if max_r == 0 or p[2] * max_l > max_r * p[3]:
                        max_r, max_l = p[2], p[3]
                    j += 1
                if max_r == 0 or new_r * max_l >= max_r * new_l:
                    max_r, max_l = new_r, new_l
                    P.insert(j, [i + start, len(w) + (SD_WLEN - 1) + start,
                                 new_r, new_l])

    l = t = 0
    for i in range(l_seq + 1):
        b = codes[i] if i < l_seq else 4
        if b < 4:
            l += 1
            t = ((t << 2) | b) & SD_WMSK
            if l >= SD_WLEN:
                start = max(l - W, 0) + (i + 1 - l)
                save_masked_regions(start)
                shift_window(t)
                if rw * 10 > L * T:
                    find_perfect(start)
        else:
            start = max(l - W + 1, 0) + (i + 1 - l)
            while P:
                save_masked_regions(start)
                start += 1
            l = t = 0
    return [(s, f) for s, f in res]


def dust_minimizers(
    seeds: list[tuple[int, int]], seq: str, sdust_thres: int
) -> list[tuple[int, int]]:
    """mm_dust_minier (map.c:45-70): drop minimizers more than half covered
    by low-complexity regions. ``seeds`` are (x, y) pairs; the span is
    x & 0xff and the position (uint32)y >> 1."""
    if sdust_thres <= 0 or not seeds:
        return seeds
    dreg = sdust_core(seq, sdust_thres, 64)
    out = []
    u = 0
    n_dreg = len(dreg)
    for x, y in seeds:
        qpos = (y & 0xFFFFFFFF) >> 1
        span = x & 0xFF
        s, e = qpos - (span - 1), qpos - (span - 1) + span
        while u < n_dreg and dreg[u][1] <= s:
            u += 1
        if u < n_dreg and dreg[u][0] < e:
            cover = 0
            v = u
            while v < n_dreg and dreg[v][0] < e:
                cover += min(e, dreg[v][1]) - max(s, dreg[v][0])
                v += 1
            if cover <= span >> 1:
                out.append((x, y))
        else:
            out.append((x, y))
    return out
