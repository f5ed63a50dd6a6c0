"""Time-folded banded DP: its geometry and the plain torch version.

Port of the folded mode of ``gdiet_tpu/ops/dp_pallas.py``
(``_dp_kernel_fold_body`` :428-740, driven by ``_extd2_fold`` :884-991).
The recurrence is ``ops/dp.py``'s, but each kernel row runs a pipeline of
candidates, two resident at a time: candidate A = (k, p) in wavefronts
[0, H) at lanes from 0 up, and the previous candidate B = (k, p-1) in its
wavefronts [H, 2H) at lanes shifted up by ``FOLD_GAP``. One set of lane
state serves both halves; candidate n lives at row k = n % Nrows of pass
c = n // Nrows, and a drain pass C finishes the last candidates.

``extd2_fold`` carries the fold body's semantics over one wavefront at a
time, vectorised over [Nrows, T]: the pass transition (state rolled up by
GAP, lanes < GAP reset, A's scalars become B's with +GAP on the lane
coordinates), both halves' edge-lane init, the frontier reset of lane r+16
with the mixed target vector, the lane-0 and lane-T-1 wrap of the TPU lane
rotate, the one-gather-per-half H0 walk and ``hit_end`` per half. Band
clamps use the nominal width ``Tn = round128(Lt)`` as the Pallas kernel
does; the stale lanes between Lt and Tn depend on it. The row/pass split is
``_extd2_fold``'s, so the raw folded dirs compare byte for byte.

It is the reference for ``csrc/extd2_fold.cu`` (and, with
``state_dtype="int16"``, ``csrc/extd2_fold_i16.cu``) and what
``ops/extd2.py`` runs for CPU tensors with ``fold=True``. ``calls`` counts
its invocations. ``state_dtype`` is ``ops/dp.py``'s; it also sets the row
block of the split, as the lane state's bytes set ``_extd2_fold``'s.
"""

from __future__ import annotations

import torch

from gdiet_tpu_torch.ops import LaunchCount
from gdiet_tpu_torch.ops import dp
from gdiet_tpu_torch.ops.dp import boundary_u, round_up
from gdiet_tpu_torch.ops.dp_band import DP_UNROLL, FOLD_GAP, window_geometry

FOLD_PASSES = 16  # target candidates per kernel row

calls = LaunchCount()


def fold_geometry(Lmax: int, Lt: int | None = None, unroll: int = DP_UNROLL):
    """(H, T, Tn): wavefronts per pass, folded lane width, nominal lane
    width (dp_pallas.py:108-118). 2H covers Lmax+Lt-1 wavefronts and
    H >= Lmax keeps the two halves' lanes disjoint."""
    if Lt is None:
        Lt = Lmax
    Tn = round_up(Lt, 128)
    T = round_up(Lt + FOLD_GAP + 16, 128)
    H = round_up(max(Lmax, (Lmax + Lt) // 2), max(unroll, 8))
    return H, T, Tn


def fold_split(N: int, T: int, state_dtype: str = "int32") -> tuple[int, int, int]:
    """(NB, Nrows, C): ``_extd2_fold``'s row block from its VMEM budget
    (7 lane-state arrays of 4 or 2 bytes a lane), kernel rows and candidate
    passes (dp_pallas.py:893-904); C passes of Nrows rows hold the N
    candidates, a drain pass follows."""
    isz = 2 if state_dtype == "int16" else 4
    NB = max(8, min(192, (10 << 19) // ((7 * isz + 8) * T) // 16 * 16))
    Nrows = round_up(max(1, -(-N // FOLD_PASSES)), NB)
    C = max(1, -(-N // Nrows))
    return NB, Nrows, C


def extd2_fold(query, target, lens, band, params, Lmax: int, tlens=None,
               Lt: int | None = None, state_dtype: str = "int32"):
    """Folded DP of N (query, target) windows.

    query [N, Lmax] u8, target [N, Lt] u8, lens/band/tlens [N] int. Returns
    (score [N] i32, dirs [(C+1)*H, Nrows, T] u8 in the raw folded layout,
    offs [N, 2H], off_ends [N, 2H] i32): wavefront r of candidate n = c*Nrows
    + k is dirs[c*H + r, k, lane + (FOLD_GAP if r >= H else 0)].
    ``state_dtype``: the lane state's type (ops/dp.py)."""
    sdt = dp.state_dtype_of(params, state_dtype)
    calls.n += 1
    N = query.shape[0]
    dev = query.device
    if Lt is None:
        Lt = Lmax
    H, T, Tn = fold_geometry(Lmax, Lt)
    _, Nrows, C = fold_split(N, T, state_dtype)
    P = C + 1
    GAP = FOLD_GAP
    a, b, q, e, q2, e2, long_thres, long_diff = dp.derive_scoring(params)
    qe, qe2 = q + e, q2 + e2
    i32 = torch.int32

    def per_pass(x, width=None):
        """[N, ...] -> [P, Nrows, ...] int32, zero rows past N (the padding
        rows and the drain pass are dead: qlen 0)."""
        shape = (P * Nrows,) + ((width,) if width is not None else tuple(x.shape[1:]))
        out = torch.zeros(shape, dtype=i32, device=dev)
        if width is None:
            out[:N] = x.to(i32)
        else:
            out[:N, : x.shape[1]] = x.to(i32)
        return out.view((P, Nrows) + shape[1:])

    qry = per_pass(query)
    tgt = per_pass(target, T)
    qlp = per_pass(lens)
    wbp = per_pass(band)
    tlp = qlp if tlens is None else per_pass(tlens)

    lanes = torch.arange(T, dtype=i32, device=dev)[None, :]
    col = lambda t: t[:, None]  # noqa: E731  per-row scalar -> column

    def full(val):
        return torch.full((Nrows, T), val, dtype=sdt, device=dev)

    u, v, x, y = full(-qe), full(-qe), full(-qe), full(-qe)
    x2, y2, s = full(-qe2), full(-qe2), full(0)
    tmix = tgt[0].clone()
    zero = torch.zeros((Nrows,), dtype=i32, device=dev)
    neg = torch.full((Nrows,), dp.NEG_INF, dtype=i32, device=dev)
    # second-half (B) scalars start dead: qlen 0
    H0b, ltb, lstb, lenb, scob = zero, zero, zero - 1, zero - 1, neg
    qlb = wbb = tlb = zero
    H0a, lta, lsta, lena, scoa = zero, zero, zero - 1, zero - 1, neg
    qla = wba = tla = zero
    qa = qb = torch.zeros((Nrows, Lmax), dtype=i32, device=dev)
    score = torch.empty((P, Nrows), dtype=i32, device=dev)
    dirs = torch.empty((P * H, Nrows, T), dtype=torch.uint8, device=dev)

    def shift_up(arr, low):
        """Roll lanes up by GAP; lanes < GAP take ``low`` (a value or an
        [Nrows, GAP] tensor)."""
        if not torch.is_tensor(low):
            low = torch.full((Nrows, GAP), low, dtype=arr.dtype, device=dev)
        return torch.cat([low, arr[:, :-GAP]], dim=1)

    for p in range(P):
        t_new = tgt[p]
        if p > 0:  # pass transition (dp_pallas.py:506-527)
            u, v, x, y = (shift_up(t, -qe) for t in (u, v, x, y))
            x2, y2 = shift_up(x2, -qe2), shift_up(y2, -qe2)
            s = shift_up(s, 0)
            tmix = shift_up(tmix, t_new[:, :GAP])
            H0b, ltb, lstb, lenb, scob = H0a, lta + GAP, lsta + GAP, lena + GAP, scoa
            qlb, wbb, tlb = qla, wba, tla
            qb = qa
        H0a, lta, lsta, lena, scoa = zero, zero, zero - 1, zero - 1, neg
        qla, wba, tla, qa = qlp[p], wbp[p], tlp[p], qry[p]

        for r in range(H):
            rB = r + H
            # first half (A): local == global lanes
            st0a = torch.maximum(torch.clamp(r - qla + 1, min=0), (r - wba + 1) >> 1)
            en0a = torch.minimum(torch.clamp(tla - 1, max=r), (r + wba) >> 1)
            livea = (st0a <= en0a) & (r < qla + tla - 1) & (qla > 0)
            sta = st0a // 16 * 16
            ena = torch.clamp((en0a + 16) // 16 * 16 - 1, max=Tn - 1)
            # second half (B): global = local + GAP
            st0b = torch.maximum(torch.clamp(rB - qlb + 1, min=0), (rB - wbb + 1) >> 1)
            en0b = torch.minimum(torch.clamp(tlb - 1, max=rB), (rB + wbb) >> 1)
            liveb = (st0b <= en0b) & (rB < qlb + tlb - 1) & (qlb > 0)
            stb = st0b // 16 * 16 + GAP
            enb = torch.clamp((en0b + 16) // 16 * 16 - 1, max=Tn - 1) + GAP
            st0bg, en0bg = st0b + GAP, en0b + GAP
            prev_oka = (sta > 0) & (sta - 1 >= lsta) & (sta - 1 <= lena)
            prev_okb = (stb - 1 >= lstb) & (stb - 1 <= lenb)
            bu = boundary_u(r, qe, e, e2, long_thres, long_diff)
            bub = boundary_u(rB, qe, e, e2, long_thres, long_diff)  # rB >= H > 0

            # edge-lane init at t == r for both halves
            at_edge = (lanes == r) & col((ena >= r) & livea)
            y = torch.where(at_edge, -qe, y)
            y2 = torch.where(at_edge, -qe2, y2)
            u = torch.where(at_edge, bu, u)
            at_edgeb = (lanes == rB + GAP) & col((enb >= rB + GAP) & liveb)
            y = torch.where(at_edgeb, -qe, y)
            y2 = torch.where(at_edgeb, -qe2, y2)
            u = torch.where(at_edgeb, bub, u)

            # frontier reset: lane r+16 back to init, target flips to A's
            rst = lanes == r + 16
            u, v = torch.where(rst, -qe, u), torch.where(rst, -qe, v)
            x, y = torch.where(rst, -qe, x), torch.where(rst, -qe, y)
            x2, y2 = torch.where(rst, -qe2, x2), torch.where(rst, -qe2, y2)
            s = torch.where(rst, 0, s)
            tmix = torch.where(rst, t_new, tmix)

            # substitution scores for both halves' 16-blocks; A reads
            # query[r - lane], B reads query[rB + GAP - lane]
            span16a = (en0a - st0a) // 16 * 16 + 16
            in_s = (lanes >= col(st0a)) & (lanes < col(st0a + span16a)) & col(livea)
            span16b = (en0b - st0b) // 16 * 16 + 16
            in_s = in_s | ((lanes >= col(st0bg)) & (lanes < col(st0bg + span16b))
                           & col(liveb))
            ia = r - lanes
            ib = (rB + GAP) - lanes
            qi_oka = (ia >= 0) & (ia < col(qla))
            qi_okb = (ib >= 0) & (ib < col(qlb))
            qv_a = qa[:, torch.clamp(ia[0], 0, Lmax - 1).long()]
            qv_b = qb[:, torch.clamp(ib[0], 0, Lmax - 1).long()]
            qv = torch.where(qi_oka, qv_a, torch.where(qi_okb, qv_b, 0))
            nmask = (tmix == 4) | (qv == 4)
            sval = torch.where(tmix == qv, a, -b).to(sdt)
            sval = torch.where(nmask, -e2, sval)
            s = torch.where(in_s, sval, s)

            in_al = (((lanes >= col(sta)) & (lanes <= col(ena)) & col(livea))
                     | ((lanes >= col(stb)) & (lanes <= col(enb)) & col(liveb)))
            # lane t-1 neighbours; lane 0 wraps to lane T-1 as the TPU
            # lane rotate does
            x_prev = torch.roll(x, 1, 1)
            v_prev = torch.roll(v, 1, 1)
            x2_prev = torch.roll(x2, 1, 1)
            at_sta = lanes == col(sta)
            at_stb = lanes == col(stb)
            bad = (at_sta & col(~prev_oka)) | (at_stb & col(~prev_okb))
            x_prev = torch.where(bad, -qe, x_prev)
            x2_prev = torch.where(bad, -qe2, x2_prev)
            v_bnda = torch.where(col(sta > 0),
                                 torch.where(col(prev_oka), v_prev, -qe), bu)
            v_prev = torch.where(at_sta, v_bnda, v_prev)
            v_prev = torch.where(at_stb & col(~prev_okb), -qe, v_prev)

            zv = s
            a_ = x_prev + v_prev
            b_ = y + u
            a2_ = x2_prev + v_prev
            b2_ = y2 + u
            d = (a_ > zv).to(i32)
            zv = torch.maximum(zv, a_)
            d = torch.where(b_ > zv, 2, d)
            zv = torch.maximum(zv, b_)
            d = torch.where(a2_ > zv, 3, d)
            zv = torch.maximum(zv, a2_)
            d = torch.where(b2_ > zv, 4, d)
            zv = torch.maximum(zv, b2_)
            zv = torch.clamp(zv, max=a)
            u_new = zv - v_prev
            v_new = zv - u
            a_p = a_ - (zv - q)
            b_p = b_ - (zv - q)
            a2_p = a2_ - (zv - q2)
            b2_p = b2_ - (zv - q2)
            d = (d | ((a_p > 0).to(i32) << 3) | ((b_p > 0).to(i32) << 4)
                 | ((a2_p > 0).to(i32) << 5) | ((b2_p > 0).to(i32) << 6))
            u = torch.where(in_al, u_new, u)
            v = torch.where(in_al, v_new, v)
            x = torch.where(in_al, torch.clamp(a_p, min=0) - qe, x)
            y = torch.where(in_al, torch.clamp(b_p, min=0) - qe, y)
            x2 = torch.where(in_al, torch.clamp(a2_p, min=0) - qe2, x2)
            y2 = torch.where(in_al, torch.clamp(b2_p, min=0) - qe2, y2)
            dirs[p * H + r] = torch.where(in_al, d, 0).to(torch.uint8)

            # approximate H0 walk, one gather per half (dp_pallas.py:681-713):
            # the value added is max(v[lt], u[lt+1]) when both are in band,
            # else the in-band one; u[lt+1] clamps at lane T-1
            u_next = torch.cat([u[:, 1:], u[:, -1:]], dim=1)
            walks = []
            for lt, st0h, en0h in ((lta, st0a, en0a), (ltb, st0bg, en0bg)):
                li = torch.clamp(lt, 0, T - 1).long()[:, None]
                v_l = torch.gather(v, 1, li)[:, 0]
                u_l = torch.gather(u_next, 1, li)[:, 0]
                lt_in = (lt >= st0h) & (lt <= en0h)
                lt1_in = (lt + 1 >= st0h) & (lt + 1 <= en0h)
                both = lt_in & lt1_in
                inc = torch.where(both, torch.maximum(v_l, u_l),
                                  torch.where(lt_in, v_l, u_l))
                stay = torch.where(both, v_l > u_l, lt_in)
                walks.append((inc, torch.where(stay, lt, lt + 1)))
            (inc_a, lt_new_a), (inc_b, lt_new_b) = walks
            if r == 0:
                H0a = torch.where(livea, v[:, 0].to(i32) - qe, H0a)
                lta = torch.where(livea, 0, lta)
            else:
                H0a = torch.where(livea, H0a + inc_a, H0a)
                lta = torch.where(livea, lt_new_a, lta)
            H0b = torch.where(liveb, H0b + inc_b, H0b)
            ltb = torch.where(liveb, lt_new_b, ltb)

            scoa = torch.where(livea & (r == qla + tla - 2) & (en0a == tla - 1), H0a, scoa)
            scob = torch.where(liveb & (rB == qlb + tlb - 2) & (en0b == tlb - 1), H0b, scob)
            lsta = torch.where(livea, sta, lsta)
            lena = torch.where(livea, ena, lena)
            lstb = torch.where(liveb, stb, lstb)
            lenb = torch.where(liveb, enb, lenb)
        # the pass's second-half candidate (k, p-1) just completed
        score[p] = scob

    offs, off_ends = dp.band_geometry(lens, tlens, band, 2 * H, Tn)
    return score.reshape(-1)[Nrows:][:N].clone(), dirs, offs, off_ends
