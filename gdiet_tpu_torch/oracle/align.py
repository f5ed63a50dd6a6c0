"""Alignment oracle: banded dual affine-gap global alignment with CIGAR.

Semantics re-derived from the reference's Suzuki-Kasahara difference kernel
(GDiet-ShortReads/ksw2_extd2_sse.c:34-402) and ksw2.h helpers
(ksw_backtrack ksw2.h:131-163, ksw_apply_zdrop ksw2.h:172-188), plus the
CIGAR fix-ups (mm_fix_cigar align.c:93-172, mm_update_extra align.c:259-318)
and mm_event_identity (align.c:961-966).

GDiet always calls the kernel with flag=KSW_EZ_APPROX_MAX on equal-length
query/target windows (map.c:867,923-929): no Z-drop is applied (that needs
KSW_EZ_APPROX_DROP), the reported score is the *approximate* greedy-path
terminal H, and the CIGAR is backtracked from the terminal corner with
left-aligned gaps. This oracle reproduces the difference recurrence
mechanically (16-lane block alignment included) so scores and CIGARs are
bit-identical to the C kernel; the TPU kernel is tested against it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NEG_INF = -0x40000000

KSW_EZ_SCORE_ONLY = 0x01
KSW_EZ_RIGHT = 0x02
KSW_EZ_APPROX_MAX = 0x08
KSW_EZ_APPROX_DROP = 0x10

CIGAR_MATCH, CIGAR_INS, CIGAR_DEL, CIGAR_N_SKIP = 0, 1, 2, 3


@dataclass
class ExtzResult:
    score: int = NEG_INF
    cigar: list[tuple[int, int]] = field(default_factory=list)  # (len, op)
    zdropped: bool = False
    max: int = 0
    max_q: int = -1
    max_t: int = -1
    mqe: int = NEG_INF
    mqe_t: int = -1
    mte: int = NEG_INF
    mte_q: int = -1
    reach_end: bool = False
    n_cigar: int = 0


def _push_cigar(cigar: list[tuple[int, int]], op: int, length: int):
    """ksw_push_cigar (ksw2.h:115-125): run-length merge."""
    if cigar and cigar[-1][1] == op:
        cigar[-1] = (cigar[-1][0] + length, op)
    else:
        cigar.append((length, op))


def extd2(
    query: np.ndarray,
    target: np.ndarray,
    a: int,
    b: int,
    q: int,
    e: int,
    q2: int,
    e2: int,
    w: int,
    zdrop: int,
    end_bonus: int,
    flag: int,
) -> ExtzResult:
    """Mechanical emulation of ksw_extd2_sse with int32 lanes.

    query/target are nt4 codes (4 = ambiguous). ``a`` is the match score,
    ``b`` the (positive) mismatch penalty.
    """
    ez = ExtzResult()
    qlen, tlen = len(query), len(target)
    if qlen <= 0 or tlen <= 0:
        return ez
    with_cigar = not (flag & KSW_EZ_SCORE_ONLY)
    approx_max = bool(flag & KSW_EZ_APPROX_MAX)

    if (approx_max and with_cigar
            and not (flag & (KSW_EZ_RIGHT | KSW_EZ_APPROX_DROP))):
        # GDiet's only kernel configuration (map.c:867,923-929): use the
        # bit-identical C port (native/gdiet_native.c::extd2_approx)
        from gdiet_tpu_torch import native

        if native.lib is not None:
            res = native.extd2_approx(query, target, a, b, q, e, q2, e2, w)
            if res is not None:
                ez.score, ez.cigar = res
                ez.n_cigar = len(ez.cigar)
                ez.zdropped = ez.score == NEG_INF and not ez.cigar
                return ez

    if q2 + e2 < q + e:  # ensure q+e <= q2+e2 (ksw2_extd2_sse.c:78)
        q, q2 = q2, q
        e, e2 = e2, e

    sc_mch, sc_mis = a, -abs(b)
    sc_N = -e2  # mat[24]==0 -> -e2 (ksw2_extd2_sse.c:87)

    if w < 0:
        w = max(tlen, qlen)
    wl = wr = w
    tlen_ = (tlen + 15) // 16
    n_col_ = min(qlen, tlen)
    n_col_ = (min(n_col_, w + 1) + 15) // 16 + 1
    if -sc_mis > 2 * (q + e):
        return ez  # mismatch never seen; reference bails (line 100)

    long_thres = (q2 - q) // (e - e2) - 1 if e != e2 else 0
    if q2 + e2 + long_thres * e2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * (e - e2) - (q2 - q) - e2

    npad = tlen_ * 16
    u = np.full(npad, -q - e, dtype=np.int32)
    v = np.full(npad, -q - e, dtype=np.int32)
    x = np.full(npad, -q - e, dtype=np.int32)
    y = np.full(npad, -q - e, dtype=np.int32)
    x2 = np.full(npad, -q2 - e2, dtype=np.int32)
    y2 = np.full(npad, -q2 - e2, dtype=np.int32)
    s = np.zeros(npad, dtype=np.int32)
    sf = np.zeros(npad, dtype=np.int32)
    sf[:tlen] = target
    qr = np.zeros(qlen, dtype=np.int32)
    qr[:] = query[::-1]

    H = None
    if not approx_max:
        H = np.full(npad, NEG_INF, dtype=np.int64)
    p = None
    off = np.zeros(qlen + tlen - 1, dtype=np.int64)
    off_end = np.zeros(qlen + tlen - 1, dtype=np.int64)
    if with_cigar:
        p = np.zeros((qlen + tlen - 1, n_col_ * 16), dtype=np.uint8)

    H0 = 0
    last_H0_t = 0
    last_st = last_en = -1
    for r in range(qlen + tlen - 1):
        st, en = 0, tlen - 1
        if st < r - qlen + 1:
            st = r - qlen + 1
        if en > r:
            en = r
        if st < (r - wr + 1) >> 1:
            st = (r - wr + 1) >> 1
        if en > (r + wl) >> 1:
            en = (r + wl) >> 1
        if st > en:
            ez.zdropped = True
            break
        st0, en0 = st, en
        st = st // 16 * 16
        en = (en + 16) // 16 * 16 - 1
        # boundary conditions (ksw2_extd2_sse.c:149-163)
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1, x21, v1 = int(x[st - 1]), int(x2[st - 1]), int(v[st - 1])
            else:
                x1, x21, v1 = -q - e, -q2 - e2, -q - e
        else:
            x1, x21 = -q - e, -q2 - e2
            v1 = (
                -q - e
                if r == 0
                else (-e if r < long_thres else (long_diff if r == long_thres else -e2))
            )
        if en >= r:
            y[r] = -q - e
            y2[r] = -q2 - e2
            u[r] = (
                -q - e
                if r == 0
                else (-e if r < long_thres else (long_diff if r == long_thres else -e2))
            )
        # score lanes: only [st0, en0] overwritten, 16 at a time (unaligned
        # stores reaching en0+15; lanes beyond stay stale, like the C code)
        t0 = st0
        while t0 <= en0:
            hi = min(t0 + 16, npad)
            tt = np.arange(t0, hi)
            qv = np.zeros(hi - t0, dtype=np.int32)
            src = (qlen - 1 - r) + tt  # qrr[t] = qr[qlen-1-r+t] = query[r-t]
            ok = (src >= 0) & (src < qlen)
            qv[ok] = qr[src[ok]]
            sq = sf[t0:hi]
            mask_n = (sq == 4) | (qv == 4)
            val = np.where(sq == qv, sc_mch, sc_mis)
            val = np.where(mask_n, sc_N, val)
            s[t0:hi] = val
            t0 += 16

        # core diff recurrence over the aligned block [st, en]
        sl = slice(st, en + 1)
        zv = s[sl].copy()
        x_prev = np.concatenate(([x1], x[st : en]))
        v_prev = np.concatenate(([v1], v[st : en]))
        x2_prev = np.concatenate(([x21], x2[st : en]))
        a_ = x_prev + v_prev
        b_ = y[sl] + u[sl]
        a2_ = x2_prev + v_prev
        b2_ = y2[sl] + u[sl]
        if with_cigar and not (flag & KSW_EZ_RIGHT):
            d = np.where(a_ > zv, 1, 0).astype(np.uint8)
            zv = np.maximum(zv, a_)
            d = np.where(b_ > zv, 2, d).astype(np.uint8)
            zv = np.maximum(zv, b_)
            d = np.where(a2_ > zv, 3, d).astype(np.uint8)
            zv = np.maximum(zv, a2_)
            d = np.where(b2_ > zv, 4, d).astype(np.uint8)
            zv = np.maximum(zv, b2_)
            zv = np.minimum(zv, sc_mch)
        else:
            d = None
            zv = np.maximum.reduce([zv, a_, b_, a2_, b2_])
            zv = np.minimum(zv, sc_mch)
        u_new = zv - v_prev
        v_new = zv - u[sl]
        a_ -= zv - q
        b_ -= zv - q
        a2_ -= zv - q2
        b2_ -= zv - q2
        u[sl] = u_new
        v[sl] = v_new
        x[sl] = np.maximum(a_, 0) - (q + e)
        y[sl] = np.maximum(b_, 0) - (q + e)
        x2[sl] = np.maximum(a2_, 0) - (q2 + e2)
        y2[sl] = np.maximum(b2_, 0) - (q2 + e2)
        if d is not None:
            d = d | np.where(a_ > 0, 0x08, 0).astype(np.uint8)
            d = d | np.where(b_ > 0, 0x10, 0).astype(np.uint8)
            d = d | np.where(a2_ > 0, 0x20, 0).astype(np.uint8)
            d = d | np.where(b2_ > 0, 0x40, 0).astype(np.uint8)
            off[r], off_end[r] = st, en
            p[r, : en - st + 1] = d

        if not approx_max:  # exact H tracking (ksw2_extd2_sse.c:323-366)
            if r > 0:
                H[en0] = (H[en0 - 1] + u[en0]) if en0 > 0 else (H[en0] + v[en0])
                max_H, max_t = int(H[en0]), en0
                if en0 > st0:
                    tt = np.arange(st0, en0)
                    H[st0:en0] += v[st0:en0]
                    loc = int(np.argmax(H[st0:en0]))
                    if int(H[st0 + loc]) > max_H:
                        max_H, max_t = int(H[st0 + loc]), st0 + loc
            else:
                H[0] = v[0] - (q + e)
                max_H, max_t = int(H[0]), 0
            if en0 == tlen - 1 and H[en0] > ez.mte:
                ez.mte, ez.mte_q = int(H[en0]), r - en
            if r - st0 == qlen - 1 and H[st0] > ez.mqe:
                ez.mqe, ez.mqe_t = int(H[st0]), st0
            if _apply_zdrop(ez, max_H, r, max_t, zdrop, e2):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = int(H[tlen - 1])
        else:  # approximate greedy H0 tracking (ksw2_extd2_sse.c:367-383)
            if r > 0:
                if st0 <= last_H0_t <= en0 and st0 <= last_H0_t + 1 <= en0:
                    d0 = int(v[last_H0_t])
                    d1 = int(u[last_H0_t + 1])
                    if d0 > d1:
                        H0 += d0
                    else:
                        H0 += d1
                        last_H0_t += 1
                elif st0 <= last_H0_t <= en0:
                    H0 += int(v[last_H0_t])
                else:
                    last_H0_t += 1
                    H0 += int(u[last_H0_t])
            else:
                H0 = int(v[0]) - (q + e)
                last_H0_t = 0
            if (flag & KSW_EZ_APPROX_DROP) and _apply_zdrop(ez, H0, r, last_H0_t, zdrop, e2):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = H0
        last_st, last_en = st, en

    if with_cigar:
        if not ez.zdropped:
            ez.cigar = _backtrack(p, off, off_end, tlen - 1, qlen - 1)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = _backtrack(p, off, off_end, ez.max_t, ez.max_q)
        ez.n_cigar = len(ez.cigar)
    return ez


def _apply_zdrop(ez: ExtzResult, H: int, r: int, t: int, zdrop: int, e: int) -> bool:
    """ksw_apply_zdrop (ksw2.h:172-188), is_rot=1."""
    if H > ez.max:
        ez.max, ez.max_t, ez.max_q = H, t, r - t
    elif t >= ez.max_t and r - t >= ez.max_q:
        tl = t - ez.max_t
        ql = (r - t) - ez.max_q
        l = abs(tl - ql)
        if zdrop >= 0 and ez.max - H > zdrop + l * e:
            ez.zdropped = True
            return True
    return False


def _backtrack(p, off, off_end, i0: int, j0: int) -> list[tuple[int, int]]:
    """ksw_backtrack (ksw2.h:131-163), is_rot=1, is_rev=0, min_intron=0."""
    cigar: list[tuple[int, int]] = []
    i, j, state = i0, j0, 0
    while i >= 0 and j >= 0:
        r = i + j
        force_state = -1
        if i < off[r]:
            force_state = 2
        if i > off_end[r]:
            force_state = 1
        tmp = int(p[r, i - off[r]]) if force_state < 0 else 0
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2)) & 1:
            state = 0
        if state == 0:
            state = tmp & 7
        if force_state >= 0:
            state = force_state
        if state == 0:
            _push_cigar(cigar, CIGAR_MATCH, 1)
            i -= 1
            j -= 1
        elif state in (1, 3):
            _push_cigar(cigar, CIGAR_DEL, 1)
            i -= 1
        else:
            _push_cigar(cigar, CIGAR_INS, 1)
            j -= 1
    if i >= 0:
        _push_cigar(cigar, CIGAR_DEL, i + 1)
    if j >= 0:
        _push_cigar(cigar, CIGAR_INS, j + 1)
    cigar.reverse()
    return cigar


# ---------------------------------------------------------------------------
# Post-alignment record fix-ups
# ---------------------------------------------------------------------------


@dataclass
class Reg:
    """mm_reg1_t + mm_extra_t analog (minimap.h:104-132)."""

    rid: int = 0
    score: int = 0  # ez.score (s1 tag)
    qs: int = 0
    qe: int = 0
    rs: int = 0
    re: int = 0
    rev: int = 0
    cigar: list[tuple[int, int]] = field(default_factory=list)
    dp_score: int = 0
    dp_max: int = 0
    dp_max2: int = 0
    blen: int = 0
    mlen: int = 0
    n_ambi: int = 0
    mapq: int = 0
    id: int = 0
    parent: int = 0
    sam_pri: int = 0
    cnt: int = 0
    subsc: int = 0
    score0: int = 0
    split: int = 0
    inv: int = 0
    proper_frag: int = 0
    seg_id: int = 0
    n_sub: int = 0
    hash: int = 0
    is_alt: int = 0
    pe_thru: int = 0
    has_p: bool = True  # mm_extra_t attached (always true for GDiet regs)


def fix_cigar(r: Reg, qseq: np.ndarray, tseq: np.ndarray) -> tuple[int, int]:
    """mm_fix_cigar (align.c:93-172). Returns (qshift, tshift)."""
    cig = [list(c) for c in r.cigar]  # [len, op] mutable
    qshift = tshift = 0
    if len(cig) <= 1:
        r.cigar = [tuple(c) for c in cig]
        return 0, 0
    toff = qoff = 0
    to_shrink = False
    for k in range(len(cig)):
        length, op = cig[k]
        if length == 0:
            to_shrink = True
        if op == CIGAR_MATCH:
            toff += length
            qoff += length
        elif op in (CIGAR_INS, CIGAR_DEL):
            if 0 < k < len(cig) - 1 and cig[k - 1][1] == 0 and cig[k + 1][1] == 0:
                prev_len = cig[k - 1][0]
                l = 0
                if op == CIGAR_INS:
                    while l < prev_len and qseq[qoff - 1 - l] == qseq[qoff + length - 1 - l]:
                        l += 1
                else:
                    while l < prev_len and tseq[toff - 1 - l] == tseq[toff + length - 1 - l]:
                        l += 1
                if l > 0:
                    cig[k - 1][0] -= l
                    cig[k + 1][0] += l
                    qoff -= l
                    toff -= l
                if l == prev_len:
                    to_shrink = True
            if op == CIGAR_INS:
                qoff += length
            else:
                toff += length
        elif op == CIGAR_N_SKIP:
            toff += length
    assert qoff == r.qe - r.qs and toff == r.re - r.rs
    # fix CIGAR like 5I6D7I (align.c:127-146)
    k = 0
    while k + 2 < len(cig):
        if cig[k][1] > 0 and cig[k][1] + cig[k + 1][1] == 3:
            s3 = [0, 0, 0]
            l = k
            while l < len(cig):
                op = cig[l][1]
                if op in (CIGAR_INS, CIGAR_DEL) or cig[l][0] == 0:
                    s3[op] += cig[l][0]
                    l += 1
                else:
                    break
            if s3[1] > 0 and s3[2] > 0 and l - k > 2:
                cig[k] = [s3[1], CIGAR_INS]
                cig[k + 1] = [s3[2], CIGAR_DEL]
                for kk in range(k + 2, l):
                    cig[kk][0] = 0
                to_shrink = True
            k = l + 1
        else:
            k += 1
    if to_shrink:
        cig = [c for c in cig if c[0] != 0]
        merged: list[list[int]] = []
        for c in cig:
            if merged and merged[-1][1] == c[1]:
                merged[-1][0] += c[0]
            else:
                merged.append(c)
        cig = merged
    if cig and cig[0][1] in (CIGAR_INS, CIGAR_DEL):  # drop leading I/D
        l = cig[0][0]
        if cig[0][1] == CIGAR_INS:
            if r.rev:
                r.qe -= l
            else:
                r.qs += l
            qshift = l
        else:
            r.rs += l
            tshift = l
        cig = cig[1:]
    r.cigar = [tuple(c) for c in cig]
    return qshift, tshift


def mg_log2(x: float) -> float:
    """Bit-trick approximate log2 (mmpriv.h:146-157), float32 semantics."""
    z = np.float32(x).view(np.uint32)
    log_2 = np.float32(int((z >> np.uint32(23)) & np.uint32(255)) - 128)
    z = (z & ~np.uint32(255 << 23)) + np.uint32(127 << 23)
    f = z.view(np.float32)
    return float(
        log_2 + (np.float32(-0.34484843) * f + np.float32(2.02466578)) * f
        - np.float32(0.67487759)
    )


def _apply_scan(r: Reg, res) -> None:
    blen, mlen, n_ambi, dp_max, qoff, toff = (int(x) for x in res)
    r.blen, r.mlen = blen, mlen
    r.n_ambi += n_ambi
    r.dp_max = dp_max
    assert qoff == r.qe - r.qs and toff == r.re - r.rs


def update_extra_many(
    jobs: list, a: int, b: int, q: int, e: int, log_gap: bool = False,
) -> None:
    """Batched mm_update_extra (fix_cigar + rescoring scan) over
    (Reg, qwin, twin) jobs with UNSHIFTED windows — one native call for
    the whole batch; falls back to per-record update_extra without the C
    library."""
    from gdiet_tpu_torch import native

    res = native.update_extra_full_batch(
        [(qw, tw, r.cigar) for r, qw, tw in jobs], a, b, q, e, log_gap
    ) if native.lib is not None else None
    if res is None:
        for r, qw, tw in jobs:
            update_extra(r, qw, tw, a, b, q, e, log_gap)
        return
    out, cigars = res
    for (r, _, _), row, cig in zip(jobs, out, cigars):
        r.cigar = cig
        lead_op, lead_len = int(row[6]), int(row[7])
        if lead_op == CIGAR_INS:  # drop leading I/D (align.c:160-171)
            if r.rev:
                r.qe -= lead_len
            else:
                r.qs += lead_len
        elif lead_op == CIGAR_DEL:
            r.rs += lead_len
        r.blen = r.mlen = 0
        _apply_scan(r, row[:6])


def update_extra(
    r: Reg, qseq: np.ndarray, tseq: np.ndarray, a: int, b: int, q: int, e: int,
    log_gap: bool = False,
) -> None:
    """mm_update_extra (align.c:259-318); log_gap is the long-read path."""
    qshift, tshift = fix_cigar(r, qseq, tseq)
    qseq = qseq[qshift:]
    tseq = tseq[tshift:]
    r.blen = r.mlen = 0
    from gdiet_tpu_torch import native

    if native.lib is not None and r.cigar:
        res = native.update_extra_scan(qseq, tseq, r.cigar, a, b, q, e,
                                       log_gap)
        if res is not None:
            _apply_scan(r, res)
            return
    _apply_scan(r, _ue_scan_py(qseq, tseq, r.cigar, a, b, q, e, log_gap))


def _ue_scan_py(
    qseq: np.ndarray, tseq: np.ndarray, cigar: list,
    a: int, b: int, q: int, e: int, log_gap: bool,
):
    """The rescoring walk (align.c:259-318) in numpy; returns
    (blen, mlen, n_ambi, dp_max, qoff, toff)."""
    s = 0.0
    mx = 0.0
    blen = mlen = n_ambi_tot = 0
    toff = qoff = 0
    for length, op in cigar:
        if op == CIGAR_MATCH:
            qs_ = qseq[qoff : qoff + length]
            ts_ = tseq[toff : toff + length]
            ambi = (qs_ > 3) | (ts_ > 3)
            n_ambi = int(ambi.sum())
            n_diff = int(((qs_ != ts_) & ~ambi).sum())
            # running local-max rescoring (align.c:273-284), vectorized.
            # Bit-exactness: prepending s to the cumsum replicates the
            # loop's sequential float adds until the first clamp-to-0; after
            # a clamp all values are small integers (a / -|b| sums), where
            # the clamped-walk closed form s_k = P_k - min(0, min_{j<=k} P_j)
            # is exact.
            contrib = np.where(ambi, 0, np.where(qs_ == ts_, a, -abs(b))).astype(np.float64)
            if length:
                pref = np.cumsum(np.concatenate(([s], contrib)))[1:]
                neg = np.flatnonzero(pref < 0)
                if neg.size == 0:
                    mx = max(mx, float(pref.max()))
                    s = float(pref[-1])
                else:
                    r_ = int(neg[0])
                    if r_ > 0:
                        mx = max(mx, float(pref[:r_].max()))
                    rest = contrib[r_ + 1:]
                    if rest.size == 0:
                        s = 0.0
                    else:
                        p2 = np.cumsum(rest)
                        floor = np.minimum.accumulate(np.minimum(p2, 0.0))
                        vals = p2 - floor
                        mx = max(mx, float(vals.max()))
                        s = float(vals[-1])
            blen += length - n_ambi
            mlen += length - (n_ambi + n_diff)
            n_ambi_tot += n_ambi
            toff += length
            qoff += length
        elif op == CIGAR_INS:
            n_ambi = int((qseq[qoff : qoff + length] > 3).sum())
            blen += length - n_ambi
            n_ambi_tot += n_ambi
            s -= q + (float(e) * mg_log2(1.0 + length) if log_gap else e)
            if s < 0:
                s = 0.0
            qoff += length
        elif op == CIGAR_DEL:
            n_ambi = int((tseq[toff : toff + length] > 3).sum())
            blen += length - n_ambi
            n_ambi_tot += n_ambi
            s -= q + (float(e) * mg_log2(1.0 + length) if log_gap else e)
            if s < 0:
                s = 0.0
            toff += length
        elif op == CIGAR_N_SKIP:
            toff += length
    return blen, mlen, n_ambi_tot, int(mx + 0.499), qoff, toff


def event_identity(r: Reg) -> float:
    """mm_event_identity (align.c:961-966)."""
    n_gap = n_gapo = 0
    for length, op in r.cigar:
        if op in (CIGAR_INS, CIGAR_DEL):
            n_gapo += 1
            n_gap += length
    denom = r.blen + r.n_ambi - n_gap + n_gapo
    return r.mlen / denom if denom else 0.0
