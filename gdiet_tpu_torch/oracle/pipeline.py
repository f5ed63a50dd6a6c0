"""End-to-end per-read mapping oracle for the short-read pipeline.

Semantics re-derived from GDiet-ShortReads/map.c:586-1010 (mm_map_frag) and
hit.c:494-557 (mm_set_sam_params).
"""

from __future__ import annotations

import numpy as np

from gdiet_tpu_torch.config import (
    MM_F_FRAG_MODE,
    MM_F_NO_PRINT_2ND,
    MapOptions,
)
from gdiet_tpu_torch.oracle import align as oal
from gdiet_tpu_torch.oracle import seed as osd
from gdiet_tpu_torch.oracle import sketch as osk
from gdiet_tpu_torch.oracle import vote as ovt
from gdiet_tpu_torch.oracle.index import OracleIndex

U32 = (1 << 32) - 1


def _i32(v: int) -> int:
    v &= U32
    return v - (1 << 32) if v >= (1 << 31) else v


def map_read(
    mi: OracleIndex,
    seq: str,
    mo: MapOptions,
    mid_occ: int,
    qname: str | None = None,
) -> list[oal.Reg]:
    """mm_map_frag for a single unpaired read (n_segs=1)."""
    import time as _time

    from gdiet_tpu_torch.utils.profile import PROFILE, Stage

    qlen = len(seq)
    if qlen == 0 or (mo.max_qlen > 0 and qlen > mo.max_qlen):
        return []
    codes = osk.seq_to_code(seq)
    _t = _time.perf_counter_ns()

    # ---- phase 1: pattern alignment (shift inference), map.c:607-616 ----
    seeds2, counts = osk.sketch_shifts(
        codes, mi.w, mi.k, mo.pattern, mo.max_seeds, seq=seq
    )
    shift = osd.get_shift(mi, seeds2, counts)
    _t2 = _time.perf_counter_ns()
    PROFILE.add(Stage.PATTERN_ALIGNMENT, _t2 - _t)
    _t = _t2

    # ---- phase 2: seeding, map.c:620-662 ----
    max_nb_seeds = (
        (800 if mo.max_frag_len == 0 else mo.max_frag_len)
        if (mo.flag & MM_F_FRAG_MODE)
        else U32
    )
    bw = int(qlen * mo.bw_frac)
    if mo.bw_min > bw:
        bw = mo.bw_min
    elif mo.bw_max < bw:
        bw = mo.bw_max

    mv, tmp_extracted_len = osk.sketch_query(
        codes, mi.w, mi.k, mo.pattern, shift, max_nb_seeds
    )
    if mo.sdust_thres > 0:  # mask low-complexity minimizers (map.c:90-91)
        from gdiet_tpu_torch.ops.sdust import dust_minimizers

        mv = dust_minimizers(mv, seq, mo.sdust_thres)
    if mo.q_occ_frac > 0.0:
        mv = osd.seed_mz_flt(mv, mid_occ, mo.q_occ_frac)
    n_mv = len(mv)
    m = osd.collect_matches(mi, mv, qlen, mid_occ, mo.max_max_occ, mo.occ_dist)
    from gdiet_tpu_torch.config import MM_F_HEAP_SORT

    tf, qf, tr, qr = osd.collect_seed_hits(
        m, tmp_extracted_len, heap_sort=bool(mo.flag & MM_F_HEAP_SORT)
    )
    from gdiet_tpu_torch import debug

    if debug.enabled():  # map.c:651-661
        debug.trace(f"RS n_a_for: {len(tf)}, n_a_rev: {len(tr)}\n")
        for t, q in zip(tf, qf):
            debug.trace(
                "SD\t{}\t{}\t+\t{}\n".format(
                    mi.names[int(t) >> 32],
                    _i32(int(t) & U32) + 1 - tmp_extracted_len, int(q))
            )
        for t, q in zip(tr, qr):
            debug.trace(
                "SD\t{}\t{}\t-\t{}\n".format(
                    mi.names[int(t) >> 32], _i32((int(t) & U32) + 1), int(q))
            )

    _t2 = _time.perf_counter_ns()
    PROFILE.add(Stage.SEEDING, _t2 - _t)
    _t = _t2

    # ---- phase 3: voting, map.c:663-699 ----
    capped = (mo.flag & MM_F_FRAG_MODE) and tmp_extracted_len < qlen
    vt_threshold = int(max_nb_seeds * mo.min_cnt) if capped else int(n_mv * mo.min_cnt)
    vt_rec_threshold = (
        int(max_nb_seeds * mo.rec_threshold_frac)
        if capped
        else int(n_mv * mo.rec_threshold_frac)
    )
    if vt_threshold == 0:
        vt_threshold = 1
    potentials: list[ovt.Candidate] = []
    recovery: list[ovt.Candidate] = []
    ovt.vote(tf, qf, 0, potentials, bw, 0, tmp_extracted_len, recovery,
             vt_threshold, mo.AF_max_loc, vt_rec_threshold)
    ovt.vote(tr, qr, 1, potentials, bw, 0, tmp_extracted_len, recovery,
             vt_threshold, mo.AF_max_loc, vt_rec_threshold)
    if debug.enabled():  # map.c:705-719
        debug.trace(f"VT n: {len(potentials)}, len: {qlen}\n")
        for cand in potentials:
            pos = cand.target_loc + 1
            if cand.strand:
                pos -= qlen - 1
            debug.trace(
                "VT\t{} (len: {})\t{}\t{}\t[{}, {}]\t{}\n".format(
                    mi.names[cand.chrom_id], mi.lengths[cand.chrom_id], pos,
                    "+-"[cand.strand], cand.first_query_loc,
                    cand.last_query_loc, cand.score)
            )
    _t2 = _time.perf_counter_ns()
    PROFILE.add(Stage.VOTING, _t2 - _t)
    _t = _t2
    if not potentials:
        if not recovery:
            return []
        potentials = [recovery[0]]

    # ---- phase 4: alignment, map.c:720-979 ----
    qs_for = codes.astype(np.uint8)
    # reference computes qs_rev as nt4^3 unconditionally (map.c:748): N (4)
    # becomes 7; replicate exactly
    qs_rev = (codes[::-1] ^ 0x3).astype(np.uint8)

    regs: list[oal.Reg] = []
    for cand in potentials:
        strand = cand.strand
        target_id = cand.chrom_id
        tlen = mi.lengths[target_id]
        if strand:
            cand.target_loc -= mi.k - 1
        target_start = target_end = cand.target_loc

        if qlen > 300:  # map.c:777-804
            if cand.first_query_loc == cand.last_query_loc:
                if debug.enabled():
                    debug.trace("SKIPPED")  # map.c:780 (no newline)
                continue
            start_offset = cand.first_query_loc - (mi.k - 1)
            end_offset = cand.last_query_loc
            if strand:
                target_end -= start_offset
                target_start -= end_offset
                if target_start < 0:
                    end_offset += target_start
                    target_start = 0
                qs = qs_rev[qlen - 1 - end_offset :]
            else:
                target_start += start_offset
                target_end += end_offset
                if target_end + 1 > tlen:
                    end_offset = tlen - 1 - target_start + start_offset
                    target_end = tlen - 1
                qs = qs_for[start_offset:]
        else:  # map.c:805-838
            if strand:
                if target_end > tlen - 1:
                    start_offset = target_end - (tlen - 1)
                    target_end = tlen - 1
                else:
                    start_offset = 0
                if target_end < qlen - start_offset - 1:
                    end_offset = start_offset + target_end
                    target_start = 0
                else:
                    end_offset = qlen - 1
                    target_start = target_end - (end_offset - start_offset)
                qs = qs_rev[qlen - 1 - end_offset :]
            else:
                if target_start < 0:
                    start_offset = -target_start
                    target_start = 0
                else:
                    start_offset = 0
                if tlen - target_start < qlen - start_offset:
                    end_offset = tlen - 1 - target_start + start_offset
                    target_end = tlen - 1
                else:
                    end_offset = qlen - 1
                    target_end = target_start + (end_offset - start_offset)
                qs = qs_for[start_offset:]
        length = end_offset - start_offset + 1
        if length <= 0 or target_start > target_end:
            continue
        qs = qs[:length]
        ts = mi.getseq(target_id, target_start, target_end + 1)
        if debug.enabled():  # map.c:842-857
            if strand:
                debug.trace("Read: str: -, [{}, {}]\n".format(
                    qlen - 1 - end_offset, qlen - 1 - start_offset))
            else:
                debug.trace("Read: str: +, [{}, {}]\n".format(
                    start_offset, end_offset))
            debug.trace("".join("ACGTN"[min(int(b), 4)] for b in qs))
            debug.trace("\nRef: {} [{}, {}]\n".format(
                mi.names[target_id], target_start, target_end))
            debug.trace("".join("ACGTN"[min(int(b), 4)] for b in ts))
            debug.trace("\n")

        # exact-match pre-filter (map.c:869-915; exact_match_sse.c:23-92)
        exact = qlen < 300 and len(qs) == len(ts) and bool(np.all(qs == ts))
        if exact:
            if debug.enabled():  # map.c:887-912
                debug.trace("Query: "
                            + "".join("ACGTN"[min(int(b), 4)] for b in qs))
                debug.trace("\nTarget: "
                            + "".join("ACGTN"[min(int(b), 4)] for b in ts))
            ez = oal.ExtzResult()
            ez.score = qlen * mo.a
            ez.cigar = [(length, oal.CIGAR_MATCH)]
            ez.n_cigar = 1
            if debug.enabled():
                debug.trace("\nCigar: {}{}\n".format(length, "M"))
        else:
            ez = oal.extd2(
                qs, ts, mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2,
                bw, mo.zdrop, mo.end_bonus, oal.KSW_EZ_APPROX_MAX,
            )

        r = oal.Reg(
            rid=target_id,
            score=ez.score,
            qs=start_offset,
            qe=end_offset + 1,
            rs=target_start,
            re=target_end + 1,
            rev=strand,
            cigar=list(ez.cigar),
            dp_score=ez.score,
        )
        oal.update_extra(r, qs, ts, mo.a, mo.b, mo.q, mo.e)

        clip0 = qlen - r.qe if r.rev else r.qs
        clip1 = r.qs if r.rev else qlen - r.qe
        # clip/min-score filters (map.c:956-964); dp_score is ez.score
        if not (clip0 < qlen and clip1 < qlen) or r.dp_score < mo.min_dp_max:
            continue

        regs.append(r)
        k = len(regs) - 1
        while k > 0 and regs[k].score > regs[k - 1].score:
            regs[k], regs[k - 1] = regs[k - 1], regs[k]
            k -= 1

    max_nb_sec = 0 if (mo.flag & MM_F_NO_PRINT_2ND) else mo.best_n
    if regs:
        set_sam_params(regs, qlen, mo.a, max_nb_sec)
    PROFILE.add(Stage.SEQUENCE_ALIGNMENT, _time.perf_counter_ns() - _t)
    return regs


def set_sam_params(regs: list[oal.Reg], qlen: int, match_score: int, max_nb_sec: int):
    """mm_set_sam_params (hit.c:494-557)."""
    for i, r in enumerate(regs):
        r.id = i
    supp_threshold = int(0.8 * (regs[0].qe - regs[0].qs))
    nb_sec = 0
    dp_max2 = 0
    regs[0].sam_pri = 1
    regs[0].parent = regs[0].id
    for i in range(1, len(regs)):
        regs[i].sam_pri = 0
        if regs[i].qe - regs[i].qs > supp_threshold:
            nb_sec += 1
            regs[i].mapq = 0
            regs[i].parent = regs[i].id + 1  # != id -> secondary (flag 0x100)
            dp_max2 = regs[i].score
        else:
            regs[i].mapq = 60
            regs[i].parent = regs[i].id  # supplementary (flag 0x800)

    # sort secondaries after supplementaries (hit.c:515-532)
    n = len(regs)
    for i in range(1, n - 1):
        if regs[i].parent != regs[i].id:
            for j in range(i + 1, n):
                if regs[j].parent == regs[j].id:
                    regs[i], regs[j] = regs[j], regs[i]
                    break
                elif regs[i].score < regs[j].score:
                    regs[i], regs[j] = regs[j], regs[i]

    if max_nb_sec < nb_sec:
        nb_sec = max_nb_sec
    r0 = regs[0]
    if nb_sec > 9:
        r0.mapq = 0
    elif nb_sec > 6:
        r0.mapq = 1
    elif nb_sec > 4:
        r0.mapq = 2
    elif nb_sec == 3:
        r0.mapq = 3
    elif nb_sec == 2:
        r0.mapq = 5
    elif nb_sec == 1:
        # hit.c:551-553 computes the chain in FLOAT (identity is float);
        # replicate float32 rounding so truncation matches at boundaries.
        # denom==0 would be float div-by-zero UB in the reference; mapq 60
        # is our documented deviation (same as native srf_set_sam_params).
        import numpy as _np

        dp_max = r0.score
        identity = (
            _np.float32(r0.mlen) / _np.float32(r0.blen) if r0.blen else
            _np.float32(0.0)
        )
        denom = qlen * match_score - dp_max2
        r0.mapq = (
            int(_np.float32(54) * identity * _np.float32(dp_max - dp_max2)
                / _np.float32(denom) + _np.float32(5))
            if denom else 60
        )
    else:
        r0.mapq = 60
