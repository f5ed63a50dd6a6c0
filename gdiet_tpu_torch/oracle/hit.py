"""Legacy minimap2 hit post-processing used by the split-index merge path.

Semantics re-derived from GDiet-ShortReads/hit.c (mm_hit_sort:196,
mm_set_parent:122, mm_select_sub:266, mm_set_sam_pri:229, mm_sync_regs:241,
mm_set_mapq:443), align.c (mm_update_dp_max:984, mm_recal_max_dp:968) and
pe.c (mm_pair:76, mm_set_pe_thru:45). These run ONLY in the --split-prefix
merge (map.c:1094-1163); the normal GDiet path uses mm_set_sam_params.

GDiet-produced regs have score0 = cnt = hash = 0, so several minimap2 mapq
formulas degenerate (0-division -> inf/nan); the x86 float->int conversion
of NaN/overflow yields INT_MIN, replicated by ``_c_int``.
"""

from __future__ import annotations

import math

import numpy as np

from gdiet_tpu_torch.oracle.align import Reg, event_identity, mg_log2

F32 = np.float32
MM_PARENT_UNSET = -1
MM_PARENT_TMP_PRI = -2
INT_MIN = -(1 << 31)


def _c_int(x: float) -> int:
    """x86 cvttss2si semantics: NaN / out-of-range -> INT_MIN."""
    if math.isnan(x) or x >= 2**31 or x < -(2**31):
        return INT_MIN
    return int(x)


def hit_sort(regs: list[Reg]) -> list[Reg]:
    """mm_hit_sort (hit.c:196-227): descending (dp_max|score, hash), stable
    within equal keys in *reverse* original order (radix sort + reversal)."""
    if len(regs) <= 1:
        return regs
    # NB: the reference keeps only regs with inv or cnt > 0 — but GDiet's
    # vote path never sets cnt, so its merge ABORTS (assert hit.c:219)
    # whenever a read has hits in more than one index part (verified against
    # the built binary). We keep regs that carry a CIGAR — the obvious
    # intent — which is byte-identical in every case the reference survives.
    keep = [r for r in regs if r.inv or r.cnt > 0 or r.has_p]
    aux = []
    for i, r in enumerate(keep):
        score = r.dp_max if r.has_p else r.score
        aux.append(((score << 32) | (r.hash & 0xFFFFFFFF), i))
    aux.sort(key=lambda t: t[0])  # stable ascending
    return [keep[i] for _, i in reversed(aux)]


def set_parent(regs: list[Reg], mask_level: float, mask_len: int,
               sub_diff: int, hard_mask_level: bool = False) -> None:
    """mm_set_parent (hit.c:122-193)."""
    n = len(regs)
    if n <= 0:
        return
    for i, r in enumerate(regs):
        r.id = i
    w = [0]
    regs[0].parent = 0
    regs[0].n_sub = 0
    for i in range(1, n):
        ri = regs[i]
        si, ei = ri.qs, ri.qe
        uncov_len = 0
        if not hard_mask_level:
            cov = []
            for j in w:
                rp = regs[j]
                sj, ej = rp.qs, rp.qe
                if ej <= si or sj >= ei:
                    continue
                cov.append((max(sj, si), min(ej, ei)))
            if cov:
                cov.sort()
                x = si
                for sj, ej in cov:
                    if sj > x:
                        uncov_len += sj - x
                    x = max(x, ej)
                if ei > x:
                    uncov_len += ei - x
        placed = False
        for j in w:
            rp = regs[j]
            sj, ej = rp.qs, rp.qe
            if ej <= si or sj >= ei:
                continue
            mn = min(ej - sj, ei - si)
            mx = max(ej - sj, ei - si)
            if si < sj:
                ol = 0 if ei < sj else (ei - sj if ei < ej else ej - sj)
            else:
                ol = 0 if ej < si else (ej - si if ej < ei else ei - si)
            if (float(F32(ol) / F32(mn)) - float(F32(uncov_len) / F32(mx))
                    > mask_level and uncov_len <= mask_len):
                cnt_sub = 0
                sci = ri.score
                ri.parent = rp.parent
                rp.subsc = max(rp.subsc, sci)
                if ri.cnt >= rp.cnt:
                    cnt_sub = 1
                if rp.has_p and ri.has_p and (
                    rp.rid != ri.rid or rp.rs != ri.rs or rp.re != ri.re
                    or ol != mn
                ):
                    sci = ri.dp_max
                    rp.dp_max2 = max(rp.dp_max2, sci)
                    if rp.dp_max - ri.dp_max <= sub_diff:
                        cnt_sub = 1
                if cnt_sub:
                    rp.n_sub += 1
                placed = True
                break
        if not placed:
            w.append(i)
            ri.parent = i
            ri.n_sub = 0


def set_sam_pri(regs: list[Reg]) -> int:
    """mm_set_sam_pri (hit.c:229-239)."""
    n_pri = 0
    for r in regs:
        if r.id == r.parent:
            n_pri += 1
            r.sam_pri = 1 if n_pri == 1 else 0
        else:
            r.sam_pri = 0
    return n_pri


def sync_regs(regs: list[Reg]) -> None:
    """mm_sync_regs (hit.c:241-264)."""
    if not regs:
        return
    idx = {r.id: i for i, r in enumerate(regs) if r.id >= 0}
    for i, r in enumerate(regs):
        old_parent = r.parent
        r.id = i
        if old_parent == MM_PARENT_TMP_PRI:
            r.parent = i
        elif old_parent >= 0 and old_parent in idx:
            r.parent = idx[old_parent]
        else:
            r.parent = MM_PARENT_UNSET
    set_sam_pri(regs)


def select_sub(regs: list[Reg], pri_ratio: float, min_diff: int,
               best_n: int) -> list[Reg]:
    """mm_select_sub (hit.c:266-292), check_strand unused in the merge."""
    if pri_ratio <= 0.0 or not regs:
        return regs
    out = []
    n_2nd = 0
    for i, r in enumerate(regs):
        p = r.parent
        if p == i or r.inv:
            out.append(r)
        elif ((r.score >= regs[p].score * pri_ratio
               or r.score + min_diff >= regs[p].score) and n_2nd < best_n):
            rp = regs[p]
            if not (r.qs == rp.qs and r.qe == rp.qe and r.rid == rp.rid
                    and r.rs == rp.rs and r.re == rp.re):
                out.append(r)
                n_2nd += 1
    if len(out) != len(regs):
        sync_regs(out)
    return out


def recal_max_dp(r: Reg, b2: float, match_sc: int) -> int:
    """mm_recal_max_dp (align.c:968-982)."""
    n_gap = n_gapo = 0
    gap_cost = 0.0
    for length, op in r.cigar:
        if op in (1, 2):
            gap_cost += b2 + float(mg_log2(1.0 + length))
            n_gapo += 1
            n_gap += length
    n_mis = r.blen + r.n_ambi - r.mlen - n_gap
    return int(match_sc * (r.mlen - b2 * n_mis - gap_cost) + 0.499)


def update_dp_max(qlen: int, regs: list[Reg], frac: float, a: int, b: int) -> None:
    """mm_update_dp_max (align.c:984-1009)."""
    if len(regs) < 2:
        return
    mx = mx2 = -1
    max_i = -1
    for i, r in enumerate(regs):
        if r.dp_max > mx:
            mx2, mx, max_i = mx, r.dp_max, i
        elif r.dp_max > mx2:
            mx2 = r.dp_max
    if max_i < 0 or mx < 0 or mx2 < 0:
        return
    if regs[max_i].qe - regs[max_i].qs < qlen * frac:
        return
    if mx2 < mx * frac:
        return
    div = 1.0 - event_identity(regs[max_i])
    div = max(div, 0.02)
    b2 = 0.5 / div
    if b2 * a < b:
        b2 = a / b
    for r in regs:
        r.dp_max = max(recal_max_dp(r, b2, a), 0)


def set_mapq(regs: list[Reg], min_chain_sc: int, match_sc: int, rep_len: int,
             is_sr: bool) -> None:
    """mm_set_mapq (hit.c:443-492) with exact float32 degeneracies."""
    if not regs:
        return
    q_coef = F32(40.0)
    sum_sc = sum(r.score for r in regs if r.parent == r.id)
    with np.errstate(divide="ignore", invalid="ignore"):
        uniq_ratio = F32(sum_sc) / F32(sum_sc + rep_len)
        for r in regs:
            if r.inv:
                r.mapq = 0
                continue
            if r.parent != r.id:
                r.mapq = 0
                continue
            pen_s1 = (F32(1.0) if r.score > 100 else F32(0.01) * F32(r.score)) * uniq_ratio
            pen_cm = F32(1.0) if r.cnt > 10 else F32(0.1) * F32(r.cnt)
            pen_cm = pen_s1 if pen_s1 < pen_cm else pen_cm
            subsc = r.subsc if r.subsc > min_chain_sc else min_chain_sc
            if r.has_p and r.dp_max2 > 0 and r.dp_max > 0:
                identity = F32(r.mlen) / F32(r.blen) if r.blen else F32(np.nan)
                x = F32(r.dp_max2) * F32(subsc) / F32(r.dp_max) / F32(r.score0)
                mapq = _c_int(
                    identity * pen_cm * q_coef * (F32(1.0) - x * x)
                    * F32(np.log(F32(r.dp_max) / F32(match_sc)))
                )
                if not is_sr:
                    mapq_alt = _c_int(
                        F32(6.02) * identity * identity
                        * F32(r.dp_max - r.dp_max2) / F32(match_sc) + F32(0.499)
                    )
                    mapq = min(mapq, mapq_alt)
            else:
                x = F32(subsc) / F32(r.score0)
                if r.has_p:
                    identity = F32(r.mlen) / F32(r.blen) if r.blen else F32(np.nan)
                    mapq = _c_int(
                        identity * pen_cm * q_coef * (F32(1.0) - x)
                        * F32(np.log(F32(r.dp_max) / F32(match_sc)))
                    )
                else:
                    mapq = _c_int(pen_cm * q_coef * (F32(1.0) - x)
                                  * F32(np.log(F32(r.score))))
            mapq -= _c_int(F32(4.343) * F32(np.log(F32(r.n_sub + 1))) + F32(0.499))
            mapq = max(mapq, 0)
            r.mapq = min(mapq, 60)
            if r.has_p and r.dp_max > r.dp_max2 and r.mapq == 0:
                r.mapq = 1
    # mm_set_inv_mapq: inversion hits never occur in the GDiet path


def set_pe_thru(qlens: list[int], regs_pair: list[list[Reg]]) -> None:
    """mm_set_pe_thru (pe.c:45-63)."""
    n_pri = [0, 0]
    pri = [-1, -1]
    for s in range(2):
        for i, r in enumerate(regs_pair[s]):
            if r.id == r.parent:
                n_pri[s] += 1
                pri[s] = i
    if n_pri[0] == 1 and n_pri[1] == 1:
        p = regs_pair[0][pri[0]]
        q = regs_pair[1][pri[1]]
        if (p.rid == q.rid and p.rev == q.rev and abs(p.rs - q.rs) < 3
                and abs(p.re - q.re) < 3
                and ((p.qs == 0 and qlens[1] - q.qe == 0)
                     or (q.qs == 0 and qlens[0] - p.qe == 0))):
            p.pe_thru = q.pe_thru = 1


def pair(max_gap_ref: int, pe_bonus: int, sub_diff: int, match_sc: int,
         qlens: list[int], regs_pair: list[list[Reg]]) -> None:
    """mm_pair (pe.c:76-177): proper-pair selection + PE mapq blend."""
    a = []
    dp_thres = 0
    segs = 0
    for s in range(2):
        mx = 0
        for r in regs_pair[s]:
            key = (r.rid << 33) | (r.rs << 1) | (s ^ r.rev)
            a.append([s, r.rev, key, r])
            mx = max(mx, r.dp_max)
            segs |= 1 << s
        dp_thres += mx
    if segs != 3:
        return
    dp_thres = max(dp_thres - pe_bonus, 0)
    a.sort(key=lambda t: t[2])

    mx = -1
    max_idx = [-1, -1]
    last = [-1, -1]
    sc: list[int] = []
    for i, (s_i, rev_i, key_i, r_i) in enumerate(a):
        if key_i & 1:
            if last[rev_i] < 0:
                continue
            r = r_i
            q = a[last[rev_i]][3]
            if r.rid != q.rid or r.rs - q.re > max_gap_ref:
                continue
            for j in range(last[rev_i], -1, -1):
                if a[j][1] != rev_i or a[j][0] == s_i:
                    continue
                q = a[j][3]
                if r.rid != q.rid or r.rs - q.re > max_gap_ref:
                    break
                if r.dp_max + q.dp_max < dp_thres:
                    continue
                score = ((r.dp_max + q.dp_max) << 32) | ((r.hash + q.hash) & 0xFFFFFFFF)
                if score > mx:
                    mx = score
                    max_idx[a[j][0]] = j
                    max_idx[s_i] = i
                sc.append(score)
        else:
            last[rev_i] = i
    sc.sort()

    if sc and mx > 0:
        r = [a[max_idx[0]][3], a[max_idx[1]][3]]
        r[0].proper_frag = r[1].proper_frag = 1
        for s in range(2):
            if r[s].id != r[s].parent:
                p = regs_pair[s][r[s].parent]
                for rr in regs_pair[s]:
                    if rr.parent == p.id:
                        rr.parent = r[s].id
                p.mapq = 0
            if not r[s].sam_pri:
                for rr in regs_pair[s]:
                    rr.sam_pri = 0
                r[s].sam_pri = 1
        mapq_pe = max(r[0].mapq, r[1].mapq)
        n_sub = sum(1 for v in sc if (v >> 32) + sub_diff >= (mx >> 32))
        if len(sc) > 1:
            mapq_pe_alt = _c_int(
                F32(6.02) * F32((mx >> 32) - (sc[-2] >> 32)) / F32(match_sc)
                - F32(4.343) * F32(np.log(F32(n_sub)))
            )
            mapq_pe = min(mapq_pe, mapq_pe_alt)
        for s in range(2):
            if r[s].mapq < mapq_pe:
                r[s].mapq = _c_int(F32(0.2) * F32(r[s].mapq)
                                   + F32(0.8) * F32(mapq_pe) + F32(0.499))
        if len(sc) == 1:
            for s in range(2):
                r[s].mapq = max(r[s].mapq, 2)
        elif (mx >> 32) > (sc[-2] >> 32):
            for s in range(2):
                r[s].mapq = max(r[s].mapq, 1)

    set_pe_thru(qlens, regs_pair)
