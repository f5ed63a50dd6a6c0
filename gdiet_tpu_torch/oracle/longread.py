"""Long-read mapping oracle (HiFi/ONT/CLR pipeline).

Semantics re-derived from GDiet-LongReads/map.c: two-round location voting
with coverage gating (vote map.c:1052-1180, vote_2 map.c:1182-1271), density
and relative filters (map.c:1355-1400), segment concatenation graph
(map.c:1467-1590) and CIGAR concatenation with optimal-junction search
(concatenate_cigars map.c:41-640), per-segment exact-match / banded DP
alignment (map.c:1654-1855), and the shared SAM-param assignment.

Two reference quirks are replicated deliberately for byte parity:
  * the density-filter compaction (map.c:1358-1363) copies *earlier* slots
    over passing ones, which reduces to keeping the first `#passing` entries;
  * the junction search (map.c:264-271, 500-507) maximises
    al_start[j] + al_start[j] rather than al_start[j] + al_end[j].
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gdiet_tpu_torch.config import MM_F_FRAG_MODE, MM_F_NO_PRINT_2ND, MM_F_SR, MapOptions
from gdiet_tpu_torch.oracle import align as oal
from gdiet_tpu_torch.oracle import seed as osd
from gdiet_tpu_torch.oracle import sketch as osk
from gdiet_tpu_torch.oracle.pipeline import set_sam_params

U32 = (1 << 32) - 1
U64 = (1 << 64) - 1
F32 = np.float32


@dataclass
class VtSeq:
    """vt_t (GDiet-LongReads/map.c:1033-1045)."""

    chrom_id: int = 0
    first_target_loc: int = 0  # int32 semantics
    last_target_loc: int = 0
    first_query_loc: int = 0  # uint32 semantics
    last_query_loc: int = 0
    score: int = 0
    str: int = 0
    next: "VtSeq | None" = None
    concat: int = 0
    valid: int = 0
    r: oal.Reg | None = field(default=None, repr=False)


def _i32(v: int) -> int:
    v &= U32
    return v - (1 << 32) if v >= (1 << 31) else v


def _emit(seqs: list[VtSeq], vt_max: int, cand: VtSeq) -> bool:
    """Score-sorted bounded insertion (map.c:1117-1131). Returns False if a
    full list rejected the candidate."""
    if len(seqs) == vt_max:
        if seqs[-1].score >= cand.score:
            return False
        seqs[-1] = cand
    else:
        seqs.append(cand)
    k = len(seqs) - 1
    while k > 0 and seqs[k].score > seqs[k - 1].score:
        seqs[k], seqs[k - 1] = seqs[k - 1], seqs[k]
        k -= 1
    return True


def vote_lr(
    targets: np.ndarray,  # u64 (chrom<<32 | projected target), sorted
    queries: np.ndarray,  # u32 query positions
    strand: int,
    seqs: list[VtSeq],
    vt_distance: int,
    extracted_len: int,
    vt_max: int,
    coverage_threshold: int,
) -> None:
    """Round-1 vote (map.c:1052-1180): run-scan with coverage gating; tracks
    raw target span via the inverse diagonal projection."""
    n = len(targets)
    if n == 0:
        return

    def raw(t: int, q: int) -> int:
        return (t - q if strand else t - (extracted_len - q)) & U64

    first_t = last_t = raw(int(targets[0]), int(queries[0]))
    first_q = last_q = int(queries[0])
    ref_loc = int(targets[0])
    counter = 1

    def flush(cur_i: int | None) -> bool:
        """Coverage check + emit; returns False when a full list rejected
        (the caller then just resets, map.c:1098-1108)."""
        if (last_q - first_q) & U32 > coverage_threshold:
            cand = VtSeq(
                chrom_id=first_t >> 32,
                first_target_loc=first_t & U32,
                last_target_loc=last_t & U32,
                first_query_loc=first_q & U32,
                last_query_loc=last_q & U32,
                str=strand,
                score=counter,
            )
            return _emit(seqs, vt_max, cand)
        return True

    for i in range(1, n):
        t, q = int(targets[i]), int(queries[i])
        if (t - ref_loc) & U64 <= vt_distance:
            counter += 1
            if q < first_q:
                first_q = q
                ref_loc = t
            if q > last_q:
                last_q = q
            loc = raw(t, q)
            if loc > last_t:
                last_t = loc
            if loc < first_t:
                first_t = loc
        else:
            flush(i)
            first_t = last_t = raw(t, q)
            first_q = last_q = q
            ref_loc = t
            counter = 1
    flush(None)


def vote_2(
    targets: np.ndarray,
    queries: np.ndarray,
    strand: int,
    best: VtSeq,
    vt_distance: int,
    extracted_len: int,
    lo: int,
    hi: int,
) -> VtSeq:
    """Round-2 vote constrained to query window (lo, hi) (map.c:1182-1271).
    Returns the updated best candidate (scores compared against ``best``)."""
    n = len(targets)
    if n == 0:
        return best

    def raw(t: int, q: int) -> int:
        return (t - q if strand else t - (extracted_len - q)) & U64

    first_t = last_t = raw(int(targets[0]), int(queries[0]))
    first_q = last_q = int(queries[0])
    ref_loc = int(targets[0])
    counter = 1

    def consider():
        nonlocal best
        if counter > best.score and last_q < hi and first_q > lo:
            best = VtSeq(
                chrom_id=first_t >> 32,
                first_target_loc=first_t & U32,
                last_target_loc=last_t & U32,
                first_query_loc=first_q & U32,
                last_query_loc=last_q & U32,
                str=strand,
                score=counter,
            )

    for i in range(1, n):
        t, q = int(targets[i]), int(queries[i])
        if (t - ref_loc) & U64 <= vt_distance:
            if lo < q < hi:
                counter += 1
                if q < first_q:
                    first_q = q
                    ref_loc = t
                if q > last_q:
                    last_q = q
                loc = raw(t, q)
                if loc > last_t:
                    last_t = loc
                if loc < first_t:
                    first_t = loc
        else:
            consider()
            first_t = last_t = raw(t, q)
            first_q = last_q = q
            ref_loc = t
            counter = 1
    consider()
    return best


def _gap_cost(length: int, q: int, e: int, q2: int, e2: int) -> int:
    p1 = q + length * e
    p2 = q2 + length * e2
    return p1 if p1 < p2 else p2


def _gap_oe(length: int, q: int, e: int, q2: int, e2: int) -> tuple[int, int]:
    p1 = q + length * e
    p2 = q2 + length * e2
    return (q, e) if p1 < p2 else (q2, e2)


def concatenate_cigars(
    rstart: oal.Reg,
    rend: oal.Reg,
    qseq: np.ndarray,  # full strand sequence (reverse-complement when str)
    strand: int,
    read_len: int,
    mi,
    a: int, b: int, q: int, e: int, q2: int, e2: int,
) -> int:
    """concatenate_cigars (GDiet-LongReads/map.c:41-640). Mutates rstart on
    success (returns 0); returns 1 when the pair cannot be concatenated."""
    tstart = rstart.rs
    tend = rend.re
    tstart_junc = rend.rs
    tend_junc = rstart.re
    qstart = (read_len - rstart.qe) if strand else rstart.qs
    qend = (read_len - rend.qs) if strand else rend.qe
    qstart_junc = (read_len - rend.qe) if strand else rend.qs
    qend_junc = (read_len - rstart.qs) if strand else rstart.qe

    if tend_junc <= tstart_junc and qend_junc <= qstart_junc:
        return 1
    if tend_junc >= tend or tstart >= tstart_junc:
        return 1
    if qend_junc >= qend or qstart >= qstart_junc:
        return 1

    M, I, D, N = oal.CIGAR_MATCH, oal.CIGAR_INS, oal.CIGAR_DEL, 3

    if qend_junc > qstart_junc:
        tseq = mi.getseq(rstart.rid, tstart, tend_junc)
        juncture_len = qend_junc - qstart_junc
        al_start = [0] * juncture_len
        al_end = [0] * juncture_len

        al_score = 0
        toff = 0
        qoff = qstart
        for length, op in rstart.cigar:
            if op == M:
                for j in range(length):
                    if qoff + j >= qstart_junc:
                        al_start[qoff + j - qstart_junc] = al_score
                    if qseq[qoff + j] == tseq[toff + j]:
                        al_score += a
                    else:
                        al_score -= b
                qoff += length
                toff += length
            elif op == I:
                if qoff + length <= qstart_junc:
                    al_score -= _gap_cost(length, q, e, q2, e2)
                elif qoff < qstart_junc:
                    o, ee = _gap_oe(length, q, e, q2, e2)
                    al_score -= o + ee * (qstart_junc - qoff)
                    for j in range(qoff + length - qstart_junc):
                        al_start[j] = al_score
                        al_score -= ee
                else:
                    o, ee = _gap_oe(length, q, e, q2, e2)
                    al_start[qoff - qstart_junc] = al_score
                    al_score -= o + ee
                    for j in range(1, length):
                        al_start[qoff + j - qstart_junc] = al_score
                        al_score -= ee
                qoff += length
            elif op == D:
                al_score -= _gap_cost(length, q, e, q2, e2)
                toff += length
            elif op == N:
                toff += length

        tseq = mi.getseq(rend.rid, tstart_junc, tend)
        toff = 0
        qoff = qstart_junc
        al_score = rend.score
        for length, op in rend.cigar:
            if qoff > qend_junc:
                break
            if op == M:
                for j in range(length):
                    if qoff + j < qend_junc:
                        if qseq[qoff + j] == tseq[toff + j]:
                            al_score -= a
                        else:
                            al_score += b
                        al_end[qoff + j - qstart_junc] = al_score
                    else:
                        break
                qoff += length
                toff += length
            elif op == I:
                o, ee = _gap_oe(length, q, e, q2, e2)
                al_score += o
                for j in range(length):
                    if qoff + j < qend_junc:
                        al_score += ee
                        al_end[qoff + j - qstart_junc] = al_score
                    else:
                        break
                qoff += length
            elif op == D:
                al_score += _gap_cost(length, q, e, q2, e2)
                toff += length
            elif op == N:
                toff += length

        # junction maximisation — replicates al_start[j]+al_start[j]
        # (map.c:264-271)
        max_score = al_start[0] + al_end[0]
        juncq = 0
        for start in range(1, juncture_len):
            total = al_start[start] + al_start[start]
            if total > max_score:
                max_score = total
                juncq = start
        score = max_score
        juncq += qstart_junc

        qoff = qstart
        toffs = rstart.rs
        new_cigar: list[tuple[int, int]] = []
        i = 0
        for i, (length, op) in enumerate(rstart.cigar):
            if op == M:
                if qoff + length >= juncq:
                    new_len = juncq - qoff
                    new_cigar.append((new_len, M))
                    qoff += new_len
                    toffs += new_len
                    i += 1
                    break
                new_cigar.append((length, op))
                qoff += length
                toffs += length
            elif op == I:
                if qoff + length >= juncq:
                    juncq = qoff
                    break
                new_cigar.append((length, op))
                qoff += length
            elif op == D:
                new_cigar.append((length, op))
                toffs += length
            elif op == N:
                new_cigar.append((length, op))
                toffs += length
        junct = toffs
    else:
        juncture_len = tend_junc - tstart_junc
        al_start = [0] * juncture_len
        al_end = [0] * juncture_len
        tseq = mi.getseq(rstart.rid, tstart, tend_junc)

        toff = 0
        qoff = qstart
        al_score = 0
        sofft_s = tstart_junc - tstart
        for length, op in rstart.cigar:
            if op == M:
                for j in range(length):
                    if toff + j >= sofft_s:
                        al_start[toff + j - sofft_s] = al_score
                    if qseq[qoff + j] == tseq[toff + j]:
                        al_score += a
                    else:
                        al_score -= b
                qoff += length
                toff += length
            elif op == D:
                if toff + length <= sofft_s:
                    al_score -= _gap_cost(length, q, e, q2, e2)
                elif toff < sofft_s:
                    o, ee = _gap_oe(length, q, e, q2, e2)
                    al_score -= o + ee * (sofft_s - toff)
                    for j in range(toff + length - sofft_s):
                        al_start[j] = al_score
                        al_score -= ee
                else:
                    o, ee = _gap_oe(length, q, e, q2, e2)
                    al_start[toff - sofft_s] = al_score
                    al_score -= o + ee
                    for j in range(1, length):
                        al_start[toff + j - sofft_s] = al_score
                        al_score -= ee
                toff += length
            elif op == I:
                al_score -= _gap_cost(length, q, e, q2, e2)
                qoff += length
            elif op == N:
                toff += length

        tseq = mi.getseq(rend.rid, rend.rs, rend.re)
        toff = 0
        qoff = qstart_junc
        al_score = 0
        eofft_s = tend_junc - tstart_junc
        for length, op in rend.cigar:
            if toff > eofft_s:
                break
            if op == M:
                for j in range(length):
                    if toff + j < eofft_s:
                        if qseq[qoff + j] == tseq[toff + j]:
                            al_score -= a
                        else:
                            al_score += b
                        al_end[toff + j] = al_score
                    else:
                        break
                qoff += length
                toff += length
            elif op == D:
                o, ee = _gap_oe(length, q, e, q2, e2)
                al_score += o
                for j in range(length):
                    if toff + j < eofft_s:
                        al_score += ee
                        al_end[toff + j] = al_score
                    else:
                        break
                toff += length
            elif op == I:
                al_score += _gap_cost(length, q, e, q2, e2)
                qoff += length
            elif op == N:
                toff += length

        max_score = al_start[0] + al_end[0]
        junct = 0
        for start in range(1, juncture_len):
            total = al_start[start] + al_start[start]
            if total > max_score:
                max_score = total
                junct = start
        score = max_score
        junct += tstart_junc

        qoff = qstart
        toffs = rstart.rs
        new_cigar = []
        i = 0
        for i, (length, op) in enumerate(rstart.cigar):
            if op == M:
                if toffs + length >= junct:
                    new_len = junct - toffs
                    new_cigar.append((new_len, M))
                    qoff += new_len
                    toffs += new_len
                    i += 1
                    break
                new_cigar.append((length, op))
                qoff += length
                toffs += length
            elif op == D:
                if toffs + length >= junct:
                    junct = toffs
                    break
                new_cigar.append((length, op))
                toffs += length
            elif op == I:
                new_cigar.append((length, op))
                qoff += length
            elif op == N:
                new_cigar.append((length, op))
                toffs += length
        juncq = qoff

    # append rend's CIGAR past the junction, inserting the gap as I/D
    # (map.c:556-616)
    toffe = rend.rs
    qoffend = qstart_junc
    crossed = False
    for length, op in rend.cigar:
        if crossed:
            new_cigar.append((length, op))
        if op == M:
            qoffend += length
            toffe += length
        elif op == I:
            qoffend += length
        elif op in (D, N):
            toffe += length
        if not crossed and qoffend >= juncq and toffe >= junct:
            tar_len = toffe - junct
            que_len = qoffend - juncq
            if que_len > tar_len:
                length_g = que_len - tar_len
                score -= _gap_cost(length_g, q, e, q2, e2)
                new_cigar.append((length_g, I))
                if tar_len != 0:
                    new_cigar.append((tar_len, M))
            elif que_len < tar_len:
                length_g = tar_len - que_len
                score -= _gap_cost(length_g, q, e, q2, e2)
                new_cigar.append((length_g, D))
                if que_len != 0:
                    new_cigar.append((que_len, M))
            else:
                new_cigar.append((tar_len, M))
            crossed = True

    rstart.cigar = new_cigar
    rstart.dp_score = score
    rstart.score = score
    if strand:
        rstart.qs = rend.qs
    else:
        rstart.qe = rend.qe
    rstart.re = rend.re
    return 0


def map_read_lr(
    mi,
    seq: str,
    mo: MapOptions,
    mid_occ: int,
    qname: str | None = None,
) -> list[oal.Reg]:
    """mm_map_frag for a single long read (GDiet-LongReads/map.c:1273-1940)."""
    qlen_sum = len(seq)
    if qlen_sum == 0:
        return []
    if mo.max_qlen > 0 and qlen_sum > mo.max_qlen:
        return []
    codes = osk.seq_to_code(seq)

    # ---- shift inference (identical to SR) ----
    seeds2, counts = osk.sketch_shifts(codes, mi.w, mi.k, mo.pattern, mo.max_seeds)
    shift = osd.get_shift(mi, seeds2, counts)

    max_nb_seeds = (
        (800 if mo.max_frag_len == 0 else mo.max_frag_len)
        if (mo.flag & MM_F_FRAG_MODE)
        else U32
    )
    mv, extracted = osk.sketch_query(
        codes, mi.w, mi.k, mo.pattern, shift, max_nb_seeds
    )
    if mo.sdust_thres > 0:  # mask low-complexity minimizers (map.c:90-91)
        from gdiet_tpu_torch.ops.sdust import dust_minimizers

        mv = dust_minimizers(mv, seq, mo.sdust_thres)
    if mo.q_occ_frac > 0.0:
        mv = osd.seed_mz_flt(mv, mid_occ, mo.q_occ_frac)
    m = osd.collect_matches(mi, mv, qlen_sum, mid_occ, mo.max_max_occ, mo.occ_dist)
    tf, qf, tr, qr = osd.collect_seed_hits(m, extracted)

    # ---- round-1 voting ----
    coverage_threshold = int(F32(qlen_sum) * F32(mo.vt_cov))
    seqs: list[VtSeq] = []
    vote_lr(tf, qf, 0, seqs, mo.vt_dis, extracted, mo.vt_nb_loc, coverage_threshold)
    vote_lr(tr, qr, 1, seqs, mo.vt_dis, extracted, mo.vt_nb_loc, coverage_threshold)
    if not seqs:
        return []

    seqs, qrstart, qrend = apply_filters(seqs, mo, mi.k, qlen_sum)
    if not seqs:
        return []

    # ---- round-2 voting on uncovered prefix/suffix ----
    def round2(lo: int, hi: int):
        vt2 = VtSeq(score=0)
        vt2 = vote_2(tf, qf, 0, vt2, mo.vt_dis, extracted, lo, hi)
        vt2 = vote_2(tr, qr, 1, vt2, mo.vt_dis, extracted, lo, hi)
        accept_round2(vt2, mo, mi.k, seqs)

    if qrstart > coverage_threshold:
        round2(0, qrstart)
    if qlen_sum - qrend > coverage_threshold:
        round2(qrend, qlen_sum)

    build_concat_graph(seqs, mo)

    # ---- per-segment alignment (map.c:1654-1855) ----
    qs_for = codes.astype(np.uint8)
    qs_rev = (codes[::-1] ^ 0x3).astype(np.uint8)

    jobs = prepare_segments(mi, mo, qs_for, qs_rev, qlen_sum, seqs)
    ezs = []
    for (s, qwin, twin, exact, qlen) in jobs:
        if exact:
            ez = oal.ExtzResult()
            ez.score = qlen_sum * mo.a
            ez.cigar = [(int(qlen), oal.CIGAR_MATCH)]
            ez.n_cigar = 1
        else:
            ez = oal.extd2(
                qwin, twin, mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2,
                mo.bw, mo.zdrop, mo.end_bonus, oal.KSW_EZ_APPROX_MAX,
            )
        ezs.append((ez.score, list(ez.cigar)))
    return finalize_read(mi, mo, qs_for, qs_rev, qlen_sum, seqs, jobs, ezs)


def apply_filters(seqs: list[VtSeq], mo: MapOptions, k: int, qlen_sum: int):
    """Density filter 1 + relative filter + boundary adjustment + coverage
    bookkeeping (map.c:1355-1400). Returns (seqs, qrstart, qrend).

    The density-filter compaction keeps the first #passing entries
    (map.c:1358-1363, see module docstring)."""
    nb_df = sum(
        1 for s in seqs
        if F32(s.score) > F32(mo.vt_df1) * F32(_i32(s.last_target_loc) - _i32(s.first_target_loc))
    )
    seqs = seqs[:nb_df]
    if not seqs:
        return [], qlen_sum, 0

    bw = mo.bw
    qrstart = qlen_sum
    qrend = 0
    filtering_threshold = int(F32(seqs[0].score) * F32(mo.vt_f))
    kept: list[VtSeq] = []
    for s in seqs:
        if s.score < filtering_threshold:
            break
        s.first_query_loc = (s.first_query_loc - (k - 1)) & U32
        s.first_target_loc = _i32(s.first_target_loc - (k - 1))
        s.next = None
        s.concat = 0
        dq = (s.last_query_loc - s.first_query_loc) & U32
        if dq + 0.5 * bw < _i32(s.last_target_loc) - s.first_target_loc:
            s.last_target_loc = _i32(int(s.first_target_loc + dq + 0.5 * bw))
        if s.first_query_loc < qrstart:
            qrstart = s.first_query_loc
        if s.last_query_loc > qrend:
            qrend = s.last_query_loc
        kept.append(s)
    return kept, qrstart, qrend


def accept_round2(vt2: VtSeq, mo: MapOptions, k: int, seqs: list[VtSeq]) -> None:
    """Round-2 candidate adjustment + density filter 2 (map.c:1402-1445)."""
    bw = mo.bw
    vt2.first_query_loc = (vt2.first_query_loc - (k - 1)) & U32
    vt2.first_target_loc = _i32(vt2.first_target_loc - (k - 1))
    span = _i32(vt2.last_target_loc) - vt2.first_target_loc
    if F32(vt2.score) > F32(mo.vt_df2) * F32(span):
        dq = (vt2.last_query_loc - vt2.first_query_loc) & U32
        if dq + 0.5 * bw < span:
            vt2.last_target_loc = _i32(int(vt2.first_target_loc + dq + 0.5 * bw))
        seqs.append(vt2)


def prepare_segments(mi, mo, qs_for, qs_rev, qlen_sum, seqs):
    """Window geometry per voted segment (map.c:1654-1714). Marks every seq
    valid and returns [(seq, qwin, twin, exact, qlen)] alignment jobs; the
    window fields are stashed on the VtSeq for finalize_read."""
    jobs = []
    for s in seqs:
        s.valid = 1
        target_id = s.chrom_id
        target_start = s.first_target_loc & U32
        target_end = s.last_target_loc & U32
        if s.str:
            query_end = (qlen_sum - 1 - s.first_query_loc) & U32
            query_start = (qlen_sum - 1 - s.last_query_loc) & U32
        else:
            query_start = s.first_query_loc
            query_end = s.last_query_loc
        if qlen_sum <= 300:
            chrom_len = mi.lengths[target_id]
            if target_start < query_start:
                query_start -= target_start
                target_start = 0
            else:
                target_start -= query_start
                query_start = 0
            if chrom_len + query_end < qlen_sum + target_end:
                query_end += chrom_len - target_end - 1
                target_end = chrom_len - 1
            else:
                target_end += qlen_sum - query_end - 1
                query_end = qlen_sum - 1
        qptr = query_start  # pointer into the strand sequence (pre-swap)
        qlen = (query_end - query_start + 1) & U32
        tlen = (target_end - target_start + 1) & U32
        if s.str:
            tmp = qlen_sum - 1 - query_start
            query_start = qlen_sum - 1 - query_end
            query_end = tmp
        strand_seq = qs_rev if s.str else qs_for
        qwin = strand_seq[qptr : qptr + qlen]
        twin = mi.getseq(target_id, target_start, target_end + 1)
        exact = (
            qlen_sum < 300 and qlen == tlen and len(qwin) == len(twin)
            and bool(np.all(qwin == twin))
        )
        s.win = (query_start, query_end, target_start, target_end)
        jobs.append((s, qwin, twin, exact, qlen))
    return jobs


def finalize_read(mi, mo, qs_for, qs_rev, qlen_sum, seqs, jobs, ezs):
    """Reg construction, CIGAR fix-ups, concatenation and output ordering
    (map.c:1808-1912)."""
    for (s, qwin, twin, exact, qlen), (score, cigar) in zip(jobs, ezs):
        query_start, query_end, target_start, target_end = s.win
        if score == oal.NEG_INF:
            s.valid = 0
            continue
        r = oal.Reg(
            rid=s.chrom_id, score=score, qs=query_start, qe=query_end + 1,
            rs=target_start, re=target_end + 1, rev=s.str,
            cigar=list(cigar), dp_score=score,
        )
        oal.update_extra(
            r, qwin, twin, mo.a, mo.b, mo.q, mo.e,
            log_gap=not (mo.flag & MM_F_SR),
        )
        clip0 = qlen_sum - r.qe if r.rev else r.qs
        clip1 = r.qs if r.rev else qlen_sum - r.qe
        if not (clip0 < qlen_sum and clip1 < qlen_sum):
            s.valid = 0
            continue
        s.r = r

    # ---- concatenate the records (map.c:1857-1874) ----
    for s in seqs:
        while s.valid and s.next is not None and s.next.valid:
            if concatenate_cigars(
                s.r, s.next.r, qs_rev if s.str else qs_for, s.str, qlen_sum,
                mi, mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2,
            ) == 0:
                s.next.valid = 0
                s.next = s.next.next
            else:
                s.next = None

    # ---- score filter + output ordering (map.c:1876-1912) ----
    out: list[oal.Reg] = []
    for s in seqs:
        if s.valid:
            if s.r.dp_score < mo.min_dp_max:
                s.valid = 0
            else:
                out.append(s.r)
                kk = len(out) - 1
                while kk > 0 and out[kk].score > out[kk - 1].score:
                    out[kk], out[kk - 1] = out[kk - 1], out[kk]
                    kk -= 1
    if out:
        max_nb_sec = 0 if (mo.flag & MM_F_NO_PRINT_2ND) else mo.best_n
        set_sam_params(out, qlen_sum, mo.a, max_nb_sec)
    return out


def build_concat_graph(seqs: list[VtSeq], mo: MapOptions) -> None:
    # ---- concatenation candidate graph (map.c:1467-1590) ----
    for s1 in seqs:
        for s2 in seqs:
            if s2 is s1 or s2.concat != 0 or s1.str != s2.str or s1.chrom_id != s2.chrom_id:
                continue
            if s1.str:
                if (s2.last_query_loc < s1.first_query_loc
                        and s1.last_target_loc > s2.first_target_loc
                        and s1.first_target_loc < s2.first_target_loc):
                    if s2.last_query_loc + mo.max_max_gap > s1.first_query_loc:
                        if s1.next is None or s2.last_query_loc > s1.next.last_query_loc:
                            s1.next = s2
                elif (s2.last_query_loc < s1.first_query_loc
                        and s1.last_target_loc < s2.first_target_loc):
                    if ((s2.last_query_loc + mo.max_min_gap > s1.first_query_loc
                            or s1.last_target_loc + mo.max_min_gap > s2.first_target_loc)
                            and s2.last_query_loc + mo.max_max_gap > s1.first_query_loc
                            and s1.last_target_loc + mo.max_max_gap > s2.first_target_loc):
                        if s1.next is None or s2.last_query_loc > s1.next.last_query_loc:
                            s1.next = s2
                elif (s2.last_query_loc > s1.first_query_loc
                        and s1.last_target_loc < s2.first_target_loc
                        and s2.last_query_loc < s1.last_query_loc
                        and s2.first_query_loc < s1.first_query_loc):
                    if s1.last_target_loc + mo.max_max_gap > s2.first_target_loc:
                        if s1.next is None or s2.last_query_loc < s1.next.last_query_loc:
                            s1.next = s2
            else:
                if (s1.last_query_loc < s2.first_query_loc
                        and s1.last_target_loc > s2.first_target_loc
                        and s1.first_target_loc < s2.first_target_loc):
                    if s1.last_query_loc + mo.max_max_gap > s2.first_query_loc:
                        if s1.next is None or s2.first_query_loc < s1.next.first_query_loc:
                            s1.next = s2
                elif (s1.last_query_loc < s2.first_query_loc
                        and s1.last_target_loc < s2.first_target_loc):
                    if ((s1.last_query_loc + mo.max_min_gap > s2.first_query_loc
                            or s1.last_target_loc + mo.max_min_gap > s2.first_target_loc)
                            and s1.last_target_loc + mo.max_max_gap > s2.first_target_loc
                            and s1.last_query_loc + mo.max_max_gap > s2.first_query_loc):
                        if s1.next is None or s2.first_query_loc < s1.next.first_query_loc:
                            s1.next = s2
                elif (s1.last_query_loc > s2.first_query_loc
                        and s1.last_target_loc < s2.first_target_loc
                        and s1.first_query_loc < s2.first_query_loc
                        and s1.last_query_loc < s2.last_query_loc):
                    if s1.last_target_loc + mo.max_max_gap > s2.first_target_loc:
                        if s1.next is None or s2.first_query_loc < s1.next.first_query_loc:
                            s1.next = s2
        # boundary adjustment (map.c:1560-1590)
        if s1.next is not None:
            s2 = s1.next
            s2.concat = 1
            if s1.str:
                if (s2.last_query_loc < s1.first_query_loc
                        and s1.last_target_loc < s2.first_target_loc):
                    diffq = s1.first_query_loc - s2.last_query_loc
                    difft = s2.first_target_loc - s1.last_target_loc
                    mn = diffq if difft > diffq else difft
                    s2.last_query_loc += mn
                    s1.last_target_loc += mn
                    s1.first_query_loc -= mn
                    s2.first_target_loc -= mn
            else:
                if (s1.last_query_loc < s2.first_query_loc
                        and s1.last_target_loc < s2.first_target_loc):
                    diffq = s2.first_query_loc - s1.last_query_loc
                    difft = s2.first_target_loc - s1.last_target_loc
                    mn = diffq if difft > diffq else difft
                    s1.last_query_loc += mn
                    s1.last_target_loc += mn
                    s2.first_query_loc -= mn
                    s2.first_target_loc -= mn
            if s2.last_target_loc < s1.last_target_loc:
                s1.last_target_loc = s2.last_target_loc - 1

