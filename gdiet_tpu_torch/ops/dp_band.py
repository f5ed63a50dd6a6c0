"""Banded lane window of the DP: its geometry and the plain torch version.

Port of the windowed mode of ``gdiet_tpu/ops/dp_pallas.py::_dp_kernel_body``
(``band_budget`` set and ``window_geometry`` narrower than the lane range,
``:228-243``, ``:384-390``; its wrapper ``extd2_batch_pallas``
``:802-824``), the mode every long-read DP bucket runs. The recurrence is ``ops/dp.py``'s; the
kernel computes and stores only a 128-aligned window of WB lanes, whose
base ``lo_al`` moves right (never left) once per grid step of ``unroll``
wavefronts.

``extd2_band`` replays the kernel one grid step at a time, vectorised over
[N, WB], with its semantics and not ``ops/dp.py``'s:

- lanes that enter the window on the right hold the ``r0 == 0`` init
  values (the kernel's full-width scratch was never written there);
- the lane t-1 neighbour comes from a rotate over the window's WB lanes, so
  window lane 0 reads window lane WB-1;
- the H0 taps ``_row_gather(v2, lt, lo_al)`` / ``(u2, lt + 1, lo_al)``
  clip their lane into the window;
- band clamps use T = round128(Lt).

It is the reference for ``csrc/extd2_band.cu`` and what ``ops/extd2.py``
runs for CPU tensors when the window engages. ``calls`` counts its
invocations.
"""

from __future__ import annotations

import torch

from gdiet_tpu_torch.ops import LaunchCount
from gdiet_tpu_torch.ops.dp import (NEG_INF, band_geometry, boundary_u,
                                    derive_scoring, round_up)

DP_UNROLL = 4  # wavefronts per Pallas grid step (the short-read default)
LR_UNROLL = 8  # the long-read buckets' unroll (pipeline/longread.py:569)

calls = LaunchCount()


def window_geometry(band_budget: int, T: int, unroll: int = DP_UNROLL):
    """Banded-window width WB for a max bandwidth, None when it would not
    be narrower than T (dp_pallas.py:121-130): lanes touched at wavefronts
    [r0, r0+U) lie within ((r0-w+1)>>1) - 16 .. ((r0+U-1+w)>>1) + 15, and
    the 128-aligned base costs <= 127 more."""
    WB = round_up(band_budget + 176 + unroll, 128)
    return WB if WB < T else None


def band_shape(Lmax: int, Lt: int, band_budget: int, unroll: int):
    """(T, R, WB) of the windowed kernel: lane range, wavefronts (Lmax+Lt-1
    rounded up to 8, then to unroll*8, dp_pallas.py:788 and :835) and
    window width (None when the window does not engage)."""
    T = round_up(Lt, 128)
    R = round_up(round_up(Lmax + Lt - 1, 8), unroll * 8)
    return T, R, window_geometry(band_budget, T, unroll)


def window_base(r0: int, band_budget: int, T: int, WB: int) -> int:
    """The window's first lane for the grid step starting at wavefront r0
    (dp_pallas.py:234-235): 128-aligned, clipped into [0, T - WB]."""
    lo_raw = ((r0 - band_budget + 1) >> 1) - 16
    return min(max(lo_raw, 0), T - WB) // 128 * 128


def extd2_band(query, target, lens, band, params, Lmax: int, tlens, Lt: int,
               band_budget: int, unroll: int = LR_UNROLL):
    """Windowed DP of N (query, target) windows, as
    ``extd2_batch_pallas(..., band_budget=band_budget, unroll=unroll)``.

    query [N, Lmax] u8, target [N, Lt] u8, lens/band/tlens [N] int. Returns
    (score [N] i32, dirs [N, R, WB] u8, offs [N, R] i32, off_ends [N, R]
    i32); dirs column j of wavefront r is lane ``window_base(r // unroll *
    unroll) + j``. Rows with qlen 0 are never live (score NEG_INF, dirs 0),
    nor is any row past its last wavefront qlen+tlen-2, so the replay runs
    over the live rows up to the last live wavefront only."""
    calls.n += 1
    T, R, WB = band_shape(Lmax, Lt, band_budget, unroll)
    if WB is None:
        raise ValueError(f"extd2_band: the window of band {band_budget} is "
                         f"not narrower than the {T} lanes")
    N = query.shape[0]
    dev = query.device
    score = torch.full((N,), NEG_INF, dtype=torch.int32, device=dev)
    dirs = torch.zeros((N, R, WB), dtype=torch.uint8, device=dev)
    rows = torch.nonzero(lens > 0)[:, 0]
    if len(rows):
        sub = (query[rows], target[rows], lens[rows].to(torch.int32),
               tlens[rows].to(torch.int32), band[rows].to(torch.int32))
        score[rows], dirs[rows] = _replay(*sub, params, Lmax, T, R, WB,
                                          band_budget, unroll)
    offs, off_ends = band_geometry(lens, tlens, band, R, T)
    return score, dirs, offs, off_ends


def _replay(query, target, qlen, tlen, w, params, Lmax: int, T: int, R: int,
            WB: int, band_budget: int, unroll: int):
    """The windowed kernel's grid steps over rows that are all live at some
    wavefront; returns (score [n], dirs [n, R, WB])."""
    N = query.shape[0]
    dev = query.device
    a, b, q, e, q2, e2, long_thres, long_diff = derive_scoring(params)
    i32 = torch.int32
    qe, qe2 = q + e, q2 + e2
    win = torch.arange(WB, dtype=i32, device=dev)[None, :]

    def full(v):
        return torch.full((N, T), v, dtype=i32, device=dev)

    # the kernel's full-width lane scratch; the window is read from it and
    # written back once per grid step
    U_s, V_s, X_s, Y_s = full(-qe), full(-qe), full(-qe), full(-qe)
    X2_s, Y2_s, S_s = full(-qe2), full(-qe2), full(0)
    tpad = full(0)
    tpad[:, : target.shape[1]] = target.to(i32)
    qry = query.to(i32)

    H0 = torch.zeros((N,), dtype=i32, device=dev)
    lt = torch.zeros((N,), dtype=i32, device=dev)
    last_st = torch.full((N,), -1, dtype=i32, device=dev)
    last_en = torch.full((N,), -1, dtype=i32, device=dev)
    score = torch.full((N,), NEG_INF, dtype=i32, device=dev)
    dirs = torch.zeros((N, R, WB), dtype=torch.uint8, device=dev)
    r_end = int((qlen + tlen - 1).max())  # no row is live from here on

    def take(arr, idx):
        return torch.gather(arr, 1, idx[:, None].to(torch.int64))[:, 0]

    for r0 in range(0, min(R, r_end), unroll):
        lo = window_base(r0, band_budget, T, WB)
        sl = slice(lo, lo + WB)
        u, v, x, y = U_s[:, sl], V_s[:, sl], X_s[:, sl], Y_s[:, sl]
        x2, y2, s = X2_s[:, sl], Y2_s[:, sl], S_s[:, sl]
        sf = tpad[:, sl]
        lanes = lo + win
        for r in range(r0, r0 + unroll):
            # query[r - t] per lane, 0 outside the read (the reversed
            # extended buffer of dp_pallas.py:258-266, then qi_ok)
            qi = r - lanes
            qi_ok = (qi >= 0) & (qi < qlen[:, None])
            qv = torch.where(qi_ok, torch.gather(
                qry, 1, torch.clamp(qi, 0, Lmax - 1).to(torch.int64).expand(N, WB)), 0)

            st0 = torch.maximum(torch.clamp(r - qlen + 1, min=0), (r - w + 1) >> 1)
            en0 = torch.minimum(torch.clamp(tlen - 1, max=r), (r + w) >> 1)
            live = (st0 <= en0) & (r < qlen + tlen - 1) & (qlen > 0)
            st = st0 // 16 * 16
            en = torch.clamp((en0 + 16) // 16 * 16 - 1, max=T - 1)
            prev_ok = (st > 0) & (st - 1 >= last_st) & (st - 1 <= last_en)
            bu = boundary_u(r, qe, e, e2, long_thres, long_diff)

            at_edge = (lanes == r) & (en[:, None] >= r) & live[:, None]
            y = torch.where(at_edge, -qe, y)
            y2 = torch.where(at_edge, -qe2, y2)
            u = torch.where(at_edge, bu, u)

            span16 = (en0 - st0) // 16 * 16 + 16
            in_s = ((lanes >= st0[:, None]) & (lanes < (st0 + span16)[:, None])
                    & live[:, None])
            sval = torch.where(sf == qv, a, -b).to(i32)
            sval = torch.where((sf == 4) | (qv == 4), -e2, sval)
            s = torch.where(in_s, sval, s)

            in_al = (lanes >= st[:, None]) & (lanes <= en[:, None]) & live[:, None]
            x_prev = torch.roll(x, 1, 1)  # rotate over the window's lanes
            v_prev = torch.roll(v, 1, 1)
            x2_prev = torch.roll(x2, 1, 1)
            at_st = lanes == st[:, None]
            reset = at_st & ~prev_ok[:, None]
            x_prev = torch.where(reset, -qe, x_prev)
            x2_prev = torch.where(reset, -qe2, x2_prev)
            v_bnd = torch.where((st > 0)[:, None],
                                torch.where(prev_ok[:, None], v_prev, -qe), bu)
            v_prev = torch.where(at_st, v_bnd, v_prev)

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
            dirs[:, r, :] = torch.where(in_al, d, 0).to(torch.uint8)

            # approximate H0 walk; both taps clip into the window
            lt_in = (lt >= st0) & (lt <= en0)
            lt1_in = (lt + 1 >= st0) & (lt + 1 <= en0)
            v_lt = take(v, torch.clamp(lt - lo, 0, WB - 1))
            u_lt1 = take(u, torch.clamp(lt + 1 - lo, 0, WB - 1))
            both = lt_in & lt1_in
            d0gt = v_lt > u_lt1
            H0_new = torch.where(both, torch.where(d0gt, H0 + v_lt, H0 + u_lt1),
                                 torch.where(lt_in, H0 + v_lt, H0 + u_lt1))
            lt_new = torch.where(both, torch.where(d0gt, lt, lt + 1),
                                 torch.where(lt_in, lt, lt + 1))
            if r == 0:  # lo == 0 here: window lane 0 is lane 0
                H0_new = v[:, 0] - qe
                lt_new = torch.zeros_like(lt)
            H0 = torch.where(live, H0_new, H0)
            lt = torch.where(live, lt_new, lt)
            hit_end = live & (r == qlen + tlen - 2) & (en0 == tlen - 1)
            score = torch.where(hit_end, H0, score)
            last_st = torch.where(live, st, last_st)
            last_en = torch.where(live, en, last_en)
        U_s[:, sl], V_s[:, sl], X_s[:, sl], Y_s[:, sl] = u, v, x, y
        X2_s[:, sl], Y2_s[:, sl], S_s[:, sl] = x2, y2, s
    return score, dirs
