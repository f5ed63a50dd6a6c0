/* Frozen copy of the reference's native host routines, for the benchmark's
 * plain reference: the banded dual affine-gap DP (extd2_approx) and the
 * CIGAR fix-up and rescoring scans that the scalar oracle calls. Copied
 * from the port's gdiet_native.c; the rest of that file (the batched
 * finishes, the radix sort, the cuckoo build) is the program's and is left
 * out.
 *
 * One addition: ref_set_saturation(m) clamps the DP's lane state and its
 * running score H0 to [-m-1, m] (m = 127: int8). The benchmark's control
 * runs the reference with it set; 0 (the default) leaves the DP exact.
 *
 * Build: cc -O3 -shared -fPIC gdiet_native.c -o ref_native.so
 */

#include <stdint.h>
#include <string.h>

static int32_t ref_sat = 0;

void ref_set_saturation(int32_t m) { ref_sat = m; }

static inline int32_t ref_clamp(int32_t v) {
    if (!ref_sat) return v;
    return v > ref_sat ? ref_sat : (v < -ref_sat - 1 ? -ref_sat - 1 : v);
}

/* float32 bit-trick approximate log2 (reference mmpriv.h:146-157) */
static float mg_log2f(float x) {
    union { float f; uint32_t i; } z;
    z.f = x;
    float log_2 = (float)((int)((z.i >> 23) & 255) - 128);
    z.i = (z.i & ~(255u << 23)) + (127u << 23);
    float f = z.f;
    return log_2 + (-0.34484843f * f + 2.02466578f) * f - 0.67487759f;
}

/* mm_update_extra's rescoring scan (reference align.c:259-318): walk the
 * CIGAR over the aligned query/target windows accumulating blen/mlen/
 * n_ambi and the clamped running local max of the rescented alignment
 * score. cigar ops are packed len<<4|op (0=M 1=I 2=D 3=N). Returns
 * blen, mlen, n_ambi, dp_max, qoff, toff in out[0..5]. */
void update_extra_scan(const uint8_t *qseq, const uint8_t *tseq,
                       const uint32_t *cigar, int64_t n_cigar,
                       int64_t a, int64_t b, int64_t q, int64_t e,
                       int log_gap, int64_t *out) {
    double s = 0.0, mx = 0.0;
    int64_t blen = 0, mlen = 0, n_ambi_tot = 0, qoff = 0, toff = 0;
    double babs = b < 0 ? (double)(-b) : (double)b;
    for (int64_t ci = 0; ci < n_cigar; ci++) {
        int64_t len = (int64_t)(cigar[ci] >> 4);
        int op = (int)(cigar[ci] & 0xf);
        if (op == 0) {
            int64_t n_ambi = 0, n_diff = 0;
            for (int64_t j = 0; j < len; j++) {
                uint8_t cq = qseq[qoff + j], ct = tseq[toff + j];
                double c;
                if (cq > 3 || ct > 3) {
                    n_ambi++;
                    c = 0.0;
                } else {
                    if (cq != ct) n_diff++;
                    c = cq == ct ? (double)a : -babs;
                }
                s += c;
                if (s < 0) s = 0.0;
                else if (s > mx) mx = s;
            }
            blen += len - n_ambi;
            mlen += len - (n_ambi + n_diff);
            n_ambi_tot += n_ambi;
            qoff += len;
            toff += len;
        } else if (op == 1) {
            int64_t n_ambi = 0;
            for (int64_t j = 0; j < len; j++)
                if (qseq[qoff + j] > 3) n_ambi++;
            blen += len - n_ambi;
            n_ambi_tot += n_ambi;
            s -= (double)q + (log_gap
                ? (double)e * (double)mg_log2f((float)(1.0 + (double)len))
                : (double)e);
            if (s < 0) s = 0.0;
            qoff += len;
        } else if (op == 2) {
            int64_t n_ambi = 0;
            for (int64_t j = 0; j < len; j++)
                if (tseq[toff + j] > 3) n_ambi++;
            blen += len - n_ambi;
            n_ambi_tot += n_ambi;
            s -= (double)q + (log_gap
                ? (double)e * (double)mg_log2f((float)(1.0 + (double)len))
                : (double)e);
            if (s < 0) s = 0.0;
            toff += len;
        } else if (op == 3) {
            toff += len;
        }
    }
    out[0] = blen;
    out[1] = mlen;
    out[2] = n_ambi_tot;
    out[3] = (int64_t)(mx + 0.499);
    out[4] = qoff;
    out[5] = toff;
}

/* batched update_extra_scan over flat buffers: record i reads
 * qbuf[qoffs[i]..], tbuf[toffs[i]..], cigbuf[cigoffs[i] .. +cign[i]] and
 * writes out[i*6 .. i*6+5]. One library call per mapped batch. */
void update_extra_batch(const uint8_t *qbuf, const int64_t *qoffs,
                        const uint8_t *tbuf, const int64_t *toffs,
                        const uint32_t *cigbuf, const int64_t *cigoffs,
                        const int64_t *cign, int64_t n,
                        int64_t a, int64_t b, int64_t q, int64_t e,
                        int log_gap, int64_t *out) {
    for (int64_t i = 0; i < n; i++)
        update_extra_scan(qbuf + qoffs[i], tbuf + toffs[i],
                          cigbuf + cigoffs[i], cign[i],
                          a, b, q, e, log_gap, out + i * 6);
}

/* mm_fix_cigar (reference align.c:93-172): left-shift gaps whose preceding
 * match tail equals the gap tail, squash I/D alternations, drop zero-length
 * runs, merge equal neighbours, and strip one leading I/D. cig is packed
 * len<<4|op, modified in place; returns the new op count and reports the
 * stripped leading op/len via lead_op/lead_len (0 = none). */
static int64_t fix_cigar_c(uint32_t *cig, int64_t n,
                           const uint8_t *qseq, const uint8_t *tseq,
                           int64_t *lead_op, int64_t *lead_len) {
    *lead_op = 0;
    *lead_len = 0;
    if (n <= 1) return n;
    int64_t toff = 0, qoff = 0;
    int to_shrink = 0;
    for (int64_t k = 0; k < n; k++) {
        int64_t len = cig[k] >> 4;
        int op = cig[k] & 0xf;
        if (len == 0) to_shrink = 1;
        if (op == 0) {
            toff += len;
            qoff += len;
        } else if (op == 1 || op == 2) {
            if (k > 0 && k < n - 1 && (cig[k - 1] & 0xf) == 0
                    && (cig[k + 1] & 0xf) == 0) {
                int64_t prev_len = cig[k - 1] >> 4;
                int64_t l = 0;
                if (op == 1) {
                    while (l < prev_len &&
                           qseq[qoff - 1 - l] == qseq[qoff + len - 1 - l]) l++;
                } else {
                    while (l < prev_len &&
                           tseq[toff - 1 - l] == tseq[toff + len - 1 - l]) l++;
                }
                if (l > 0) {
                    cig[k - 1] -= (uint32_t)(l << 4);
                    cig[k + 1] += (uint32_t)(l << 4);
                    qoff -= l;
                    toff -= l;
                }
                if (l == prev_len) to_shrink = 1;
            }
            if (op == 1) qoff += len; else toff += len;
        } else if (op == 3) {
            toff += len;
        }
    }
    /* squash I/D alternations like 5I6D7I (align.c:127-146) */
    int64_t k = 0;
    while (k + 2 < n) {
        int opk = cig[k] & 0xf, opk1 = cig[k + 1] & 0xf;
        if (opk > 0 && opk + opk1 == 3) {
            int64_t s1 = 0, s2 = 0, l = k;
            while (l < n) {
                int op = cig[l] & 0xf;
                int64_t ln = cig[l] >> 4;
                if (op == 1 || op == 2 || ln == 0) {
                    if (op == 1) s1 += ln;
                    else if (op == 2) s2 += ln;
                    l++;
                } else break;
            }
            if (s1 > 0 && s2 > 0 && l - k > 2) {
                cig[k] = ((uint32_t)s1 << 4) | 1u;
                cig[k + 1] = ((uint32_t)s2 << 4) | 2u;
                for (int64_t kk = k + 2; kk < l; kk++) cig[kk] &= 0xfu;
                to_shrink = 1;
            }
            k = l + 1;
        } else {
            k++;
        }
    }
    if (to_shrink) {
        int64_t m = 0;
        for (int64_t i = 0; i < n; i++) {
            if ((cig[i] >> 4) == 0) continue;
            if (m > 0 && (cig[m - 1] & 0xf) == (cig[i] & 0xf))
                cig[m - 1] += (cig[i] >> 4) << 4;
            else
                cig[m++] = cig[i];
        }
        n = m;
    }
    if (n > 0 && ((cig[0] & 0xf) == 1 || (cig[0] & 0xf) == 2)) {
        *lead_op = cig[0] & 0xf;
        *lead_len = cig[0] >> 4;
        for (int64_t i = 1; i < n; i++) cig[i - 1] = cig[i];
        n--;
    }
    return n;
}

/* fused mm_fix_cigar + rescoring scan over a whole batch. cigbuf and cign
 * are modified in place; out has 8 slots per record:
 * blen mlen n_ambi dp_max qoff toff lead_op lead_len. */
void update_extra_full_batch(const uint8_t *qbuf, const int64_t *qoffs,
                             const uint8_t *tbuf, const int64_t *toffs,
                             uint32_t *cigbuf, const int64_t *cigoffs,
                             int64_t *cign, int64_t nrec,
                             int64_t a, int64_t b, int64_t q, int64_t e,
                             int log_gap, int64_t *out) {
    for (int64_t i = 0; i < nrec; i++) {
        int64_t lead_op, lead_len;
        int64_t n2 = fix_cigar_c(cigbuf + cigoffs[i], cign[i],
                                 qbuf + qoffs[i], tbuf + toffs[i],
                                 &lead_op, &lead_len);
        cign[i] = n2;
        int64_t qs = lead_op == 1 ? lead_len : 0;
        int64_t ts = lead_op == 2 ? lead_len : 0;
        update_extra_scan(qbuf + qoffs[i] + qs, tbuf + toffs[i] + ts,
                          cigbuf + cigoffs[i], n2, a, b, q, e, log_gap,
                          out + i * 8);
        out[i * 8 + 6] = lead_op;
        out[i * 8 + 7] = lead_len;
    }
}



/* ------------------------------------------------------------------ *
 * Scalar banded dual affine-gap extension DP — C port of the Python
 * oracle kernel (gdiet_tpu/oracle/align.py::extd2, itself a mechanical
 * int32 emulation of ksw_extd2_sse, ksw2_extd2_sse.c:34-402) for the
 * APPROX_MAX + left-aligned + with-CIGAR configuration GDiet uses
 * everywhere (map.c:867,923-929). Bit-identical results; the oracle
 * fallback path calls this instead of the numpy loop.
 * ------------------------------------------------------------------ */

#include <stdlib.h>

#define EXTD2_NEG_INF (-0x40000000)

static void extd2_backtrack(const uint8_t *p, const int64_t *off,
                            const int64_t *off_end, int64_t n_col16,
                            int64_t i0, int64_t j0,
                            uint32_t *cig, int64_t max_cig, int64_t *n_cig) {
    int64_t i = i0, j = j0, m = 0;
    int state = 0;
    /* back-to-front with run merging, then reverse */
    while (i >= 0 && j >= 0) {
        int64_t r = i + j;
        int force_state = -1;
        if (i < off[r]) force_state = 2;
        if (i > off_end[r]) force_state = 1;
        int tmp = force_state < 0 ? p[r * n_col16 + (i - off[r])] : 0;
        if (state == 0) state = tmp & 7;
        else if (!((tmp >> (state + 2)) & 1)) state = 0;
        if (state == 0) state = tmp & 7;
        if (force_state >= 0) state = force_state;
        int op, di, dj;
        if (state == 0) { op = 0; di = dj = 1; }
        else if (state == 1 || state == 3) { op = 2; di = 1; dj = 0; }
        else { op = 1; di = 0; dj = 1; }
        if (m > 0 && (int)(cig[m - 1] & 0xf) == op) cig[m - 1] += 1u << 4;
        else if (m < max_cig) cig[m++] = (1u << 4) | (uint32_t)op;
        else { *n_cig = -1; return; }
        i -= di; j -= dj;
    }
    if (i >= 0) {
        if (m > 0 && (cig[m - 1] & 0xf) == 2) cig[m - 1] += (uint32_t)(i + 1) << 4;
        else if (m < max_cig) cig[m++] = ((uint32_t)(i + 1) << 4) | 2;
        else { *n_cig = -1; return; }
    }
    if (j >= 0) {
        if (m > 0 && (cig[m - 1] & 0xf) == 1) cig[m - 1] += (uint32_t)(j + 1) << 4;
        else if (m < max_cig) cig[m++] = ((uint32_t)(j + 1) << 4) | 1;
        else { *n_cig = -1; return; }
    }
    for (int64_t x2 = 0, y2 = m - 1; x2 < y2; x2++, y2--) {
        uint32_t t = cig[x2]; cig[x2] = cig[y2]; cig[y2] = t;
    }
    *n_cig = m;
}

int64_t extd2_approx(const uint8_t *query, int64_t qlen,
                     const uint8_t *target, int64_t tlen,
                     int64_t a_sc, int64_t b_sc, int64_t q_, int64_t e_,
                     int64_t q2_, int64_t e2_, int64_t w,
                     uint32_t *cig, int64_t max_cig, int64_t *n_cig) {
    *n_cig = 0;
    if (qlen <= 0 || tlen <= 0) return EXTD2_NEG_INF;
    int32_t q = (int32_t)q_, e = (int32_t)e_, q2 = (int32_t)q2_, e2 = (int32_t)e2_;
    if (q2 + e2 < q + e) { int32_t t = q; q = q2; q2 = t; t = e; e = e2; e2 = t; }
    int32_t sc_mch = (int32_t)a_sc;
    int32_t sc_mis = b_sc < 0 ? (int32_t)b_sc : (int32_t)-b_sc;
    int32_t sc_N = -e2;
    if (w < 0) w = qlen > tlen ? qlen : tlen;
    int64_t tlen16 = (tlen + 15) / 16;
    int64_t n_col = qlen < tlen ? qlen : tlen;
    n_col = ((n_col < w + 1 ? n_col : w + 1) + 15) / 16 + 1;
    int64_t n_col16 = n_col * 16;
    if (-sc_mis > 2 * (q + e)) return EXTD2_NEG_INF; /* sse.c:100 bail */

    int32_t long_thres = e != e2 ? (q2 - q) / (e - e2) - 1 : 0;
    if (q2 + e2 + long_thres * e2 > q + e + long_thres * e) long_thres++;
    int32_t long_diff = long_thres * (e - e2) - (q2 - q) - e2;

    int64_t npad = tlen16 * 16;
    int64_t R = qlen + tlen - 1;
    int32_t *u = malloc(sizeof(int32_t) * npad * 7);
    int64_t *off = malloc(sizeof(int64_t) * R * 2);
    uint8_t *p = malloc((size_t)R * n_col16);
    if (!u || !off || !p) { free(u); free(off); free(p); return EXTD2_NEG_INF; }
    int32_t *v = u + npad, *x = v + npad, *y = x + npad;
    int32_t *x2 = y + npad, *y2 = x2 + npad, *s = y2 + npad;
    int64_t *off_end = off + R;
    for (int64_t i = 0; i < npad; i++) {
        u[i] = v[i] = x[i] = y[i] = -q - e;
        x2[i] = y2[i] = -q2 - e2;
        s[i] = 0;
    }
    int32_t H0 = 0, last_H0_t = 0, score = EXTD2_NEG_INF;
    int64_t last_st = -1, last_en = -1;
    int zdropped = 0;

    for (int64_t r = 0; r < R; r++) {
        int64_t st = 0, en = tlen - 1;
        if (st < r - qlen + 1) st = r - qlen + 1;
        if (en > r) en = r;
        if (st < ((r - w + 1) >> 1)) st = (r - w + 1) >> 1;
        if (en > ((r + w) >> 1)) en = (r + w) >> 1;
        if (st > en) { zdropped = 1; break; }
        int64_t st0 = st, en0 = en;
        st = st / 16 * 16;
        en = (en + 16) / 16 * 16 - 1;
        int32_t x1, x21, v1;
        int32_t bu = r == 0 ? -q - e
                   : (r < long_thres ? -e : (r == long_thres ? long_diff : -e2));
        if (st > 0) {
            if (last_st <= st - 1 && st - 1 <= last_en) {
                x1 = x[st - 1]; x21 = x2[st - 1]; v1 = v[st - 1];
            } else { x1 = -q - e; x21 = -q2 - e2; v1 = -q - e; }
        } else { x1 = -q - e; x21 = -q2 - e2; v1 = bu; }
        if (en >= r) { y[r] = -q - e; y2[r] = -q2 - e2; u[r] = bu; }
        /* substitution lanes, 16-wide unaligned blocks from st0 */
        for (int64_t t0 = st0; t0 <= en0; t0 += 16) {
            int64_t hi = t0 + 16 < npad ? t0 + 16 : npad;
            for (int64_t t = t0; t < hi; t++) {
                int64_t src = qlen - 1 - r + t;
                int32_t qv = (src >= 0 && src < qlen)
                    ? (int32_t)query[qlen - 1 - src] : 0;
                int32_t sq = t < tlen ? (int32_t)target[t] : 0;
                s[t] = (sq == 4 || qv == 4) ? sc_N : (sq == qv ? sc_mch : sc_mis);
            }
        }
        /* core diff recurrence, left-to-right with carried prevs */
        uint8_t *pr = p + r * n_col16;
        int32_t xp = x1, vp = v1, x2p = x21;
        for (int64_t t = st; t <= en; t++) {
            int32_t z = s[t];
            int32_t a_ = xp + vp;
            int32_t b_ = y[t] + u[t];
            int32_t a2_ = x2p + vp;
            int32_t b2_ = y2[t] + u[t];
            uint8_t d = 0;
            if (a_ > z) { d = 1; z = a_; }
            if (b_ > z) { d = 2; z = b_; }
            if (a2_ > z) { d = 3; z = a2_; }
            if (b2_ > z) { d = 4; z = b2_; }
            if (z > sc_mch) z = sc_mch;
            int32_t u_new = z - vp;
            int32_t v_new = z - u[t];
            a_ -= z - q; b_ -= z - q; a2_ -= z - q2; b2_ -= z - q2;
            xp = x[t]; vp = v[t]; x2p = x2[t];  /* save pre-update values */
            u[t] = ref_clamp(u_new); v[t] = ref_clamp(v_new);
            x[t] = ref_clamp((a_ > 0 ? a_ : 0) - (q + e));
            y[t] = ref_clamp((b_ > 0 ? b_ : 0) - (q + e));
            x2[t] = ref_clamp((a2_ > 0 ? a2_ : 0) - (q2 + e2));
            y2[t] = ref_clamp((b2_ > 0 ? b2_ : 0) - (q2 + e2));
            if (a_ > 0) d |= 0x08;
            if (b_ > 0) d |= 0x10;
            if (a2_ > 0) d |= 0x20;
            if (b2_ > 0) d |= 0x40;
            pr[t - st] = d;
        }
        off[r] = st; off_end[r] = en;
        /* approximate greedy H0 (sse.c:367-383) */
        if (r > 0) {
            if (st0 <= last_H0_t && last_H0_t <= en0
                    && st0 <= last_H0_t + 1 && last_H0_t + 1 <= en0) {
                int32_t d0 = v[last_H0_t], d1 = u[last_H0_t + 1];
                if (d0 > d1) H0 += d0;
                else { H0 += d1; last_H0_t++; }
            } else if (st0 <= last_H0_t && last_H0_t <= en0) {
                H0 += v[last_H0_t];
            } else { last_H0_t++; H0 += u[last_H0_t]; }
        } else { H0 = v[0] - (q + e); last_H0_t = 0; }
        H0 = ref_clamp(H0);
        if (r == R - 1 && en0 == tlen - 1) score = H0;
        last_st = st; last_en = en;
    }
    if (!zdropped)
        extd2_backtrack(p, off, off_end, n_col16, tlen - 1, qlen - 1,
                        cig, max_cig, n_cig);
    else { score = EXTD2_NEG_INF; *n_cig = 0; }
    free(u); free(off); free(p);
    return score;
}
